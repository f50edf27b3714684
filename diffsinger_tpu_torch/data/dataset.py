"""Training data over the binarized store (counterpart of
diffsinger_tpu/data/dataset.py).

The collaters pad a batch to bucket lengths (multiples of ``frame_bucket``
frames and ``token_bucket`` tokens or notes), as the JAX ones do, so both
packages see batches of the same shapes; on the card the buckets bound the
shapes the allocator meets. ``pad_to`` raises an axis to a length of the
caller's.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from diffsinger_tpu_torch.data.indexed_datasets import IndexedDataset

VARIANCES = ("energy", "breathiness", "voicing", "tension")


def bucket(n: int, step: int) -> int:
    """n rounded up to a multiple of step (at least step)."""
    return max(step, -(-n // step) * step)


def collate_nd(items: Sequence[np.ndarray], pad_value, length: int) -> np.ndarray:
    """Pad arrays of equal rank along their first axis to ``length`` and stack."""
    items = [np.asarray(x) for x in items]
    out = np.full((len(items), length, *items[0].shape[1:]), pad_value, dtype=items[0].dtype)
    for i, x in enumerate(items):
        out[i, :x.shape[0]] = x
    return out


class BaseDataset:
    """Items of ``{data_dir}/{prefix}.data`` with the sizes and lengths of
    ``{prefix}.meta``."""

    def __init__(self, data_dir, hp: dict, prefix: str, preload: bool = False,
                 frame_bucket: int = 128, token_bucket: int = 16):
        self.hp = hp
        self.prefix = prefix
        self.data_dir = Path(data_dir)
        with open(self.data_dir / f"{prefix}.meta", "rb") as f:
            self.metadata = pickle.load(f)
        self.sizes = self.metadata[hp.get("dataset_size_key", "lengths")]
        store = IndexedDataset(self.data_dir, prefix)
        self.items = [store[i] for i in range(len(store))] if preload else store
        self.frame_bucket = frame_bucket
        self.token_bucket = token_bucket

    def __getitem__(self, index: int) -> Dict:
        return {"_idx": index, **self.items[index]}

    def __len__(self) -> int:
        return len(self.sizes)

    @staticmethod
    def collate_base(samples: List[Dict]) -> Dict:
        return {"size": len(samples),
                "indices": np.asarray([s["_idx"] for s in samples], np.int64)}



class AcousticDataset(BaseDataset):
    """``collater`` makes the acoustic batch."""

    def __init__(self, data_dir, hp: dict, prefix: str, **kwargs):
        super().__init__(data_dir, hp, prefix, **kwargs)
        self.required_variances = [v for v in VARIANCES if hp.get(f"use_{v}_embed", False)]

    def collater(self, samples: List[Dict]) -> Dict:
        """numpy batch: size, indices, tokens [B, T_txt], mel2ph, mel [B, T_mel, M],
        f0, and the enabled conditioning (variances, key_shift, speed, spk_ids,
        languages)."""
        hp = self.hp
        batch = self.collate_base(samples)
        if not samples:
            return batch
        t_mel = bucket(max(len(s["mel2ph"]) for s in samples), self.frame_bucket)
        t_txt = bucket(max(len(s["tokens"]) for s in samples), self.token_bucket)
        batch.update(
            tokens=collate_nd([s["tokens"] for s in samples], 0, t_txt).astype(np.int32),
            mel2ph=collate_nd([s["mel2ph"] for s in samples], 0, t_mel).astype(np.int32),
            mel=collate_nd([s["mel"] for s in samples], 0.0, t_mel).astype(np.float32),
            f0=collate_nd([s["f0"] for s in samples], 0.0, t_mel).astype(np.float32),
        )
        for v in self.required_variances:
            batch[v] = collate_nd([s[v] for s in samples], 0.0, t_mel).astype(np.float32)
        if hp.get("use_key_shift_embed", False):
            batch["key_shift"] = np.asarray([[s["key_shift"]] for s in samples], np.float32)
        if hp.get("use_speed_embed", False):
            batch["speed"] = np.asarray([[s["speed"]] for s in samples], np.float32)
        if hp.get("use_spk_id", False):
            batch["spk_ids"] = np.asarray([s["spk_id"] for s in samples], np.int32)
        if hp.get("use_lang_id", False):
            batch["languages"] = collate_nd([s["languages"] for s in samples], 0,
                                            t_txt).astype(np.int32)
        return batch


class VarianceDataset(BaseDataset):
    """``collater`` makes the variance batch."""

    def __init__(self, data_dir, hp: dict, prefix: str, **kwargs):
        super().__init__(data_dir, hp, prefix, **kwargs)
        self.var_list = [v for v in VARIANCES if hp.get(f"predict_{v}", False)]

    def collater(self, samples: List[Dict], pad_to: Optional[Dict[str, int]] = None) -> Dict:
        """numpy batch: size, indices, tokens and ph_dur [B, T_txt], spk_ids and
        languages where enabled; ph2word and midi under ``predict_dur``; the
        notes (note_midi padded with -1, note_rest with True) [B, T_note],
        mel2note and base_pitch [B, T_mel] under ``predict_pitch``; mel2ph,
        pitch and uv (padded with True) where a frame branch is on; the
        predicted curves. ``pad_to``: {"t_mel", "t_txt", "t_note"}."""
        hp = self.hp
        batch = self.collate_base(samples)
        if not samples:
            return batch
        pad_to = pad_to or {}

        def length(key, step, axis):  # bucketed, or pad_to's if longer
            return max(bucket(max(len(s[key]) for s in samples), step), pad_to.get(axis, 0))

        t_txt = length("tokens", self.token_bucket, "t_txt")
        batch.update(
            tokens=collate_nd([s["tokens"] for s in samples], 0, t_txt).astype(np.int32),
            ph_dur=collate_nd([s["ph_dur"] for s in samples], 0, t_txt).astype(np.int32),
        )
        if hp.get("use_spk_id", False):
            batch["spk_ids"] = np.asarray([s["spk_id"] for s in samples], np.int32)
        if hp.get("use_lang_id", False):
            batch["languages"] = collate_nd([s["languages"] for s in samples], 0,
                                            t_txt).astype(np.int32)
        if hp["predict_dur"]:
            for k in ("ph2word", "midi"):
                batch[k] = collate_nd([s[k] for s in samples], 0, t_txt).astype(np.int32)
        if not (hp["predict_pitch"] or self.var_list):
            return batch
        t_mel = length("mel2ph", self.frame_bucket, "t_mel")

        def frames(key, pad, dtype=None):
            out = collate_nd([s[key] for s in samples], pad, t_mel)
            return out if dtype is None else out.astype(dtype)

        if hp["predict_pitch"]:
            t_note = length("note_midi", self.token_bucket, "t_note")

            def notes(key, pad, dtype=None):
                out = collate_nd([s[key] for s in samples], pad, t_note)
                return out if dtype is None else out.astype(dtype)

            batch.update(note_midi=notes("note_midi", -1.0, np.float32),
                         note_rest=notes("note_rest", True),
                         note_dur=notes("note_dur", 0, np.int32))
            if hp.get("use_glide_embed", False):
                batch["note_glide"] = notes("note_glide", 0, np.int32)
            batch.update(mel2note=frames("mel2note", 0, np.int32),
                         base_pitch=frames("base_pitch", 0.0, np.float32))
        batch.update(mel2ph=frames("mel2ph", 0, np.int32), pitch=frames("pitch", 0.0, np.float32),
                     uv=frames("uv", True))
        for v in self.var_list:
            batch[v] = frames(v, 0.0, np.float32)
        return batch
