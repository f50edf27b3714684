"""Acoustic training data over the binarized store
(counterpart of diffsinger_tpu/data/dataset.py, the acoustic half).

The collater pads a batch to bucket lengths (multiples of ``frame_bucket``
frames and ``token_bucket`` tokens), as the JAX one does, so both packages
see batches of the same shapes; on the card the buckets bound the shapes
the allocator meets. The variance dataset comes with the variance model's
training.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Dict, List, Sequence

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


class AcousticDataset:
    """Items of ``{data_dir}/{prefix}.data`` with the sizes and lengths of
    ``{prefix}.meta``; ``collater`` makes the acoustic batch."""

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
        self.required_variances = [v for v in VARIANCES if hp.get(f"use_{v}_embed", False)]

    def __getitem__(self, index: int) -> Dict:
        return {"_idx": index, **self.items[index]}

    def __len__(self) -> int:
        return len(self.sizes)

    def collater(self, samples: List[Dict]) -> Dict:
        """numpy batch: size, indices, tokens [B, T_txt], mel2ph, mel [B, T_mel, M],
        f0, and the enabled conditioning (variances, key_shift, speed, spk_ids,
        languages)."""
        hp = self.hp
        batch = {"size": len(samples),
                 "indices": np.asarray([s["_idx"] for s in samples], np.int64)}
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
