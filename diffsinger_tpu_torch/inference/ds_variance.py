"""Variance inference runtime: a score's .ds segments -> predicted phoneme
durations, pitch curve and variance curves, written back into a new .ds
(counterpart of diffsinger_tpu/inference/ds_variance.py).

Preprocessing is host-side numpy, the JAX package's arithmetic, so both
packages feed their models bit-equal arrays; the model runs on the card unless
the caller asks for the CPU. Each segment's predictor flags come from the
auto-completion cascade (:meth:`segment_flags`), and the arrays are padded to
the JAX package's buckets (16 tokens, words and notes; 128 frames).

Noise. A segment's draws come from a ``torch.Generator`` seeded by its
``seed`` field, else by ``seed``, else by a hash of title, run and segment
index (the JAX package's seed rules): the same output for the same
``--seed``, but not the JAX package's samples. Every method that draws also
takes the first draws of the pitch and the variance sampler as arguments
(``noise_pitch=``, ``noise_variances=``, or the ``noise_fn`` of
:meth:`run_inference`), through which a test feeds both packages the same
numbers.
"""

from __future__ import annotations

import copy
import json
import pathlib
import warnings
from collections import OrderedDict
from typing import Callable, Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from diffsinger_tpu_torch.dsp.common import interp_f0, sinusoidal_smooth_np
from diffsinger_tpu_torch.inference.base_svs_infer import BaseSVSInfer, bucket_length
from diffsinger_tpu_torch.models.toplevel import VARIANCE_CHECKLIST, DiffSingerVariance
from diffsinger_tpu_torch.utils import pad_to, resolve_device, resolve_precision
from diffsinger_tpu_torch.utils.ckpt import load_state_dict_for_inference
from diffsinger_tpu_torch.utils.infer_utils import (
    hz_to_midi, midi_to_hz, note_to_midi, resample_align_curve)
from diffsinger_tpu_torch.utils.prefetch import upload
from diffsinger_tpu_torch.utils.seq import rhythm_regulator
from diffsinger_tpu_torch.utils.text import load_phoneme_dictionary

# (segment or chunk index, 'noise_pitch' or 'noise_variances', shape
# [B, T, F*R]) -> that sampler's first draw
NoiseFn = Callable[[int, str, tuple], torch.Tensor]


def note_to_midi_float(note: str) -> float:
    """librosa.note_to_midi(round_midi=False) for plain note names with
    optional cents ('C4', 'A#3', 'C4-25')."""
    cents = 0.0
    for sep in ("+", "-"):
        idx = note.find(sep, 1)
        if idx > 0 and note[idx + 1:].isdigit():
            cents = float(note[idx:])
            note = note[:idx]
            break
    return note_to_midi(note) + cents / 100.0


def _nearest_interp_rests(note_midi: np.ndarray, note_rest: np.ndarray) -> np.ndarray:
    """Fill rest positions with the nearest non-rest midi (ties take the left)."""
    if note_rest.all():
        return np.full_like(note_midi, 60.0)
    idx_known = np.where(~note_rest)[0]
    idx_rest = np.where(note_rest)[0]
    pos = np.searchsorted(idx_known, idx_rest)
    pos = np.clip(pos, 1, len(idx_known) - 1) if len(idx_known) > 1 else np.zeros_like(pos)
    if len(idx_known) == 1:
        note_midi[idx_rest] = note_midi[idx_known[0]]
        return note_midi
    left = idx_known[pos - 1]
    right = idx_known[pos]
    nearest = np.where(idx_rest - left <= right - idx_rest, left, right)
    note_midi[idx_rest] = note_midi[nearest]
    return note_midi


def _expand(dur: np.ndarray) -> np.ndarray:
    """Host-side length regulator: [T] int -> 1-based frame map [sum(dur)]."""
    return np.repeat(np.arange(1, len(dur) + 1), dur).astype(np.int32)


class DiffSingerVarianceInfer(BaseSVSInfer):
    def __init__(self, hparams: dict, ckpt_steps: Optional[int] = None,
                 predictions: Set[str] = frozenset(), device=None):
        super().__init__(hparams)
        self.device = resolve_device(device)
        self.phoneme_dictionary = load_phoneme_dictionary(hparams)
        self.load_maps()
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)  # the weights a missing checkpoint leaves in place
            self.model = DiffSingerVariance(
                hparams, vocab_size=len(self.phoneme_dictionary),
                dtype=resolve_precision(hparams.get("infer_precision")), device=self.device)
        try:
            load_state_dict_for_inference(self.model.module, hparams["work_dir"],
                                          category="variance", ckpt_steps=ckpt_steps,
                                          hp=hparams)
        except FileNotFoundError:
            warnings.warn(f"No checkpoint in '{hparams['work_dir']}'; using RANDOM weights.")

        self.smooth_kernel_size = max(1, round(hparams["midi_smooth_width"] / self.timestep))
        glide_types = hparams.get("glide_types", [])
        assert "none" not in glide_types, (
            "Type name 'none' is reserved and should not appear in glide_types."
        )
        self.glide_map = {"none": 0, **{t: i + 1 for i, t in enumerate(glide_types)}}

        predictions = set(predictions)
        self.auto_completion_mode = len(predictions) == 0
        self.global_predict_dur = "dur" in predictions and hparams["predict_dur"]
        self.global_predict_pitch = "pitch" in predictions and hparams["predict_pitch"]
        self.variance_prediction_set = predictions.intersection(VARIANCE_CHECKLIST)
        self.global_predict_variances = len(self.variance_prediction_set) > 0

    # ------------------------------------------------------------------
    def preprocess_input(self, param: dict, idx: int = 0, load_dur: bool = False,
                         load_pitch: bool = False) -> Dict[str, np.ndarray]:
        """One .ds segment -> model inputs as numpy arrays with a leading batch
        axis of 1 (the JAX package's arithmetic, line for line)."""
        hp = self.hparams
        batch: Dict[str, np.ndarray] = {}
        summary = OrderedDict()

        lang = param.get("lang")
        if lang is None:
            assert len(self.lang_map) <= 1, (
                "This is a multilingual model. Please specify a language by --lang option."
            )
        elif self.lang_map:
            assert lang in self.lang_map, f"Unrecognized language name: '{lang}'."
        if hp.get("use_lang_id", False):
            batch["languages"] = self.encode_languages(
                param["ph_seq"], lang, self.phoneme_dictionary)[None]
        tokens = np.asarray(
            self.phoneme_dictionary.encode(param["ph_seq"], lang=lang), np.int32)[None]
        batch["tokens"] = tokens
        t_ph = tokens.shape[1]

        ph_num = np.asarray(param["ph_num"].split(), np.int64)
        ph2word = _expand(ph_num)[None]  # [1, T_ph]
        assert ph2word.shape[1] == t_ph, "ph_num does not sum to token count"
        t_w = int(ph2word.max())
        batch["ph2word"] = ph2word.astype(np.int32)

        note_midi = np.asarray(
            [note_to_midi_float(n) if n != "rest" else -1 for n in param["note_seq"].split()],
            np.float32)
        note_rest = note_midi < 0
        note_midi = _nearest_interp_rests(note_midi, note_rest)
        t_n = len(note_midi)

        note_dur_sec = np.asarray(param["note_dur"].split(), np.float32)
        note_acc = np.round(np.cumsum(note_dur_sec) / self.timestep + 0.5).astype(np.int64)
        note_dur = np.diff(note_acc, prepend=0)
        mel2note = _expand(note_dur)[None]
        t_s = mel2note.shape[1]

        summary.update(words=t_w, notes=t_n, tokens=t_ph, frames=t_s,
                       seconds="%.2f" % (t_s * self.timestep))

        if hp.get("use_spk_id", False):
            ph_id, ph_val = self.load_speaker_mix(param, summary, "token", t_ph)
            fr_id, fr_val = self.load_speaker_mix(param, summary, "frame", t_s)
            batch.update(ph_spk_mix_id=ph_id, ph_spk_mix_value=ph_val,
                         spk_mix_id=fr_id, spk_mix_value=fr_val)

        if load_dur:
            ph_dur_sec = np.asarray(param["ph_dur"].split(), np.float32)
            ph_acc = np.round(np.cumsum(ph_dur_sec) / self.timestep + 0.5).astype(np.int64)
            ph_dur = np.diff(ph_acc, prepend=0)
            mel2ph = _expand(ph_dur)[None]
            if mel2ph.shape[1] != t_s:  # align phones with notes
                if mel2ph.shape[1] < t_s:
                    mel2ph = np.pad(mel2ph, ((0, 0), (0, t_s - mel2ph.shape[1])),
                                    constant_values=mel2ph[0, -1])
                else:
                    mel2ph = mel2ph[:, :t_s]
                ph_dur = np.bincount(mel2ph[0], minlength=t_ph + 1)[1: t_ph + 1]
            word_dur = np.zeros(t_w + 1, np.int64)
            np.add.at(word_dur, ph2word[0], ph_dur[: t_ph])
            word_dur = word_dur[1:][None]
            batch["ph_dur"] = np.asarray(ph_dur, np.int32)[None]
            batch["mel2ph"] = mel2ph.astype(np.int32)
        else:
            is_slur = np.asarray([int(s) for s in param["note_slur"].split()], bool)
            note2word = np.cumsum(~is_slur)
            word_dur = np.zeros(t_w + 1, np.int64)
            np.add.at(word_dur, note2word, note_dur)
            word_dur = word_dur[1:][None]

        mel2word = _expand(word_dur[0])[None]
        if mel2word.shape[1] != t_s:
            if mel2word.shape[1] < t_s:
                mel2word = np.pad(mel2word, ((0, 0), (0, t_s - mel2word.shape[1])),
                                  constant_values=mel2word[0, -1])
            else:
                mel2word = mel2word[:, :t_s]
            word_dur = np.bincount(mel2word[0], minlength=t_w + 1)[1: t_w + 1][None]
        batch["word_dur"] = np.asarray(word_dur, np.int32)

        batch["note_midi"] = note_midi[None]
        batch["note_dur"] = np.asarray(note_dur, np.int32)[None]
        batch["note_rest"] = note_rest[None]
        if hp.get("use_glide_embed", False) and param.get("note_glide") is not None:
            batch["note_glide"] = np.asarray(
                [[self.glide_map.get(x, 0) for x in param["note_glide"].split()]], np.int32)
        else:
            batch["note_glide"] = np.zeros((1, t_n), np.int32)
        batch["mel2note"] = mel2note.astype(np.int32)

        # frame-level MIDI (a step function) -> smoothed base pitch
        frame_midi = np.pad(note_midi, (1, 0))[mel2note[0]][None]
        batch["base_pitch"] = sinusoidal_smooth_np(frame_midi, self.smooth_kernel_size)

        # phoneme-level MIDI
        if load_dur:
            mel2pdur = np.pad(batch["ph_dur"][0], (1, 0), constant_values=1)[batch["mel2ph"][0]]
            ph_midi = np.zeros(t_ph + 1, np.float64)
            np.add.at(ph_midi, batch["mel2ph"][0], frame_midi[0] / np.maximum(mel2pdur, 1))
            ph_midi = ph_midi[1:]
        else:
            mel2wdur = np.pad(word_dur[0], (1, 0), constant_values=1)[mel2word[0]]
            w_midi = np.zeros(t_w + 1, np.float64)
            np.add.at(w_midi, mel2word[0], frame_midi[0] / np.maximum(mel2wdur, 1))
            w_midi = np.pad(w_midi[1:], (1, 0))
            ph_midi = w_midi[ph2word[0]]
        batch["midi"] = np.clip(np.round(ph_midi), 0, 127).astype(np.int32)[None]

        if load_pitch:
            f0 = resample_align_curve(
                np.asarray(param["f0_seq"].split(), np.float32),
                original_timestep=float(param["f0_timestep"]),
                target_timestep=self.timestep,
                align_length=t_s)
            batch["pitch"] = hz_to_midi(interp_f0(f0)[0]).astype(np.float32)[None]

        if self.model.predict_dur:
            summary["ph_dur"] = ("manual" if load_dur else
                                 "auto" if self.auto_completion_mode or self.global_predict_dur
                                 else "ignored")
        if self.model.predict_pitch:
            if load_pitch:
                summary["pitch"] = "manual"
            elif self.auto_completion_mode or self.global_predict_pitch:
                summary["pitch"] = "auto"
                expr = param.get("expr", 1.0)
                if isinstance(expr, (int, float, bool)):
                    summary["expr"] = f"static({float(expr):.3f})"
                    batch["expr"] = np.full((1, t_s), float(expr), np.float32)
                else:
                    summary["expr"] = "dynamic"
                    batch["expr"] = resample_align_curve(
                        np.asarray(expr.split(), np.float32),
                        original_timestep=float(param["expr_timestep"]),
                        target_timestep=self.timestep,
                        align_length=t_s).astype(np.float32)[None]
            else:
                summary["pitch"] = "ignored"
        for v_name in self.model.var_list:
            auto = (self.auto_completion_mode and param.get(v_name) is None) or (
                v_name in self.variance_prediction_set)
            summary[v_name] = "auto" if auto else "ignored"

        print(f"[{idx}]\t" + ", ".join(f"{k}: {v}" for k, v in summary.items()))
        return batch

    # ------------------------------------------------------------------
    def bucket_shapes(self, batch: Dict[str, np.ndarray]) -> Tuple[int, int, int, int]:
        """(t_ph, t_w, t_n, t_s) bucket-padded lengths of one segment."""
        return (
            bucket_length(batch["tokens"].shape[1], step=16, minimum=16),
            bucket_length(batch["word_dur"].shape[1], step=16, minimum=16),
            bucket_length(batch["note_midi"].shape[1], step=16, minimum=16),
            bucket_length(batch["base_pitch"].shape[1]),
        )

    def padded_arrays(self, batch: Dict[str, np.ndarray], buckets: Tuple[int, int, int, int]):
        """Pad one segment's arrays to the given bucket lengths. Returns
        (tokens, midi, ph2word, base_pitch, array_kwargs, spk_mix): single
        [1, T] rows, stackable along axis 0 within a group."""
        t_ph_pad, t_w_pad, t_n_pad, t_s_pad = buckets

        def pad(key, length, value=0):
            if key in batch and batch[key] is not None:
                return pad_to(batch[key], length, pad_value=value, axis=1)
            return None

        kwargs = dict(
            ph_dur=pad("ph_dur", t_ph_pad),
            word_dur=pad("word_dur", t_w_pad),
            mel2ph=pad("mel2ph", t_s_pad),
            pitch=pad("pitch", t_s_pad),
            pitch_expr=pad("expr", t_s_pad),
            note_midi=pad("note_midi", t_n_pad),
            note_rest=pad_to(batch["note_rest"], t_n_pad, pad_value=True, axis=1),
            note_dur=pad("note_dur", t_n_pad),
            note_glide=pad("note_glide", t_n_pad),
            mel2note=pad("mel2note", t_s_pad),
            languages=pad("languages", t_ph_pad),
        )
        spk_mix = None
        if "ph_spk_mix_id" in batch:
            ph_val = batch["ph_spk_mix_value"]
            if ph_val.shape[1] > 1:
                ph_val = pad_to(ph_val, t_ph_pad, axis=1)
            fr_val = batch["spk_mix_value"]
            if fr_val.shape[1] > 1:
                fr_val = pad_to(fr_val, t_s_pad, axis=1)
            spk_mix = {"ph_id": batch["ph_spk_mix_id"], "ph_value": ph_val,
                       "frame_id": batch["spk_mix_id"], "frame_value": fr_val}

        tokens = pad_to(batch["tokens"], t_ph_pad, axis=1)
        midi = pad_to(batch["midi"], t_ph_pad, axis=1)
        ph2word = pad_to(batch["ph2word"], t_ph_pad, axis=1)
        base_pitch = pad_to(batch["base_pitch"], t_s_pad, axis=1)
        array_kwargs = {k: v for k, v in kwargs.items() if v is not None}
        return tokens, midi, ph2word, base_pitch, array_kwargs, spk_mix

    def _to_device(self, x: np.ndarray) -> torch.Tensor:
        return upload(x, self.device)

    def _spk_mix_embed(self, ids: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
        """Mix speaker embeddings: ids [B, 1, N], values [B, T|1, N] -> [B, T|1, H]."""
        table = self.model.module.spk_embed.weight
        return torch.sum(table[ids.long()] * values.to(table.dtype)[..., None], dim=2)

    def _generator(self, seed: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(seed & 0xFFFF_FFFF)

    def _run_padded(self, tokens, midi, ph2word, base_pitch, array_kwargs, spk_mix, flags,
                    generator, steps, noise_pitch=None, noise_variances=None):
        """One forward on padded (or stacked) arrays [B, ...] -> (dur_pred
        frames [B, T_ph] int32 | None, pitch_pred midi [B, T_s] | None,
        {variance: [B, T_s]}), on the device. The rhythm regulator and the base
        pitch are applied here, as the JAX runtime applies them in its program."""
        predict_dur, predict_pitch, predict_variances = flags
        kw = {k: self._to_device(v) for k, v in array_kwargs.items()}
        if spk_mix is not None:
            mix = {k: self._to_device(v) for k, v in spk_mix.items()}
            kw["ph_spk_mix_embed"] = self._spk_mix_embed(mix["ph_id"], mix["ph_value"])
            kw["spk_mix_embed"] = self._spk_mix_embed(mix["frame_id"], mix["frame_value"])
        ph2word = self._to_device(ph2word)
        base_pitch = self._to_device(base_pitch)

        def on_device(x):
            return None if x is None else torch.as_tensor(x, dtype=torch.float32).to(self.device)

        dur_pred, pitch_pred, variance_pred = self.model.forward_infer(
            self._to_device(tokens), self._to_device(midi), ph2word, base_pitch,
            predict_pitch=predict_pitch, predict_variances=predict_variances, steps=steps,
            generator=generator, noise_pitch=on_device(noise_pitch),
            noise_variances=on_device(noise_variances), **kw)
        if dur_pred is not None and predict_dur:
            dur_pred = rhythm_regulator(dur_pred, ph2word, kw["word_dur"])
        if pitch_pred is not None:
            pitch_pred = base_pitch + pitch_pred
        return dur_pred, pitch_pred, variance_pred

    def noise_shapes(self, b: int, t_s: int) -> Dict[str, tuple]:
        """The shapes of the pitch and the variance sampler's first draws, by
        the name of the argument that takes them."""
        shapes = {}
        if self.model.predict_pitch:
            shapes["noise_pitch"] = (b, t_s, self.model.pitch_transform.repeat_bins)
        if self.model.var_list:
            shapes["noise_variances"] = (b, t_s, len(self.model.var_list)
                                         * self.model.variance_transform.repeat_bins)
        return shapes

    def injected_noise(self, noise_fn: Optional[NoiseFn], index: int, b: int, t_s: int) -> dict:
        """The keyword arguments that carry ``noise_fn``'s draws (none without it)."""
        if noise_fn is None:
            return {}
        return {k: noise_fn(index, k, s) for k, s in self.noise_shapes(b, t_s).items()}

    def forward_model(self, batch: Dict[str, np.ndarray], flags: Tuple[bool, bool, bool],
                      generator: Optional[torch.Generator] = None,
                      steps: Optional[int] = None, *, noise_pitch=None, noise_variances=None):
        """One segment, padded to its buckets -> (dur_pred frames | None,
        pitch_pred midi | None, {variance: curve}) as numpy, cut to the
        segment's length. ``noise_pitch`` / ``noise_variances`` [1, T_s bucket,
        F*R] replace the first draws from ``generator``."""
        t_s = batch["base_pitch"].shape[1]
        tokens, midi, ph2word, base_pitch, array_kwargs, spk_mix = (
            self.padded_arrays(batch, self.bucket_shapes(batch)))
        dur_pred, pitch_pred, variance_pred = self._run_padded(
            tokens, midi, ph2word, base_pitch, array_kwargs, spk_mix, flags, generator, steps,
            noise_pitch, noise_variances)
        t_ph = batch["tokens"].shape[1]
        out_dur = None
        if dur_pred is not None and flags[0]:
            out_dur = dur_pred[0, :t_ph].cpu().numpy()
        out_pitch = None if pitch_pred is None else pitch_pred[0, :t_s].float().cpu().numpy()
        out_vars = {k: v[0, :t_s].float().cpu().numpy() for k, v in variance_pred.items()}
        return out_dur, out_pitch, out_vars

    # ------------------------------------------------------------------
    def segment_flags(self, param: dict) -> Tuple[bool, bool, bool]:
        """(predict_dur, predict_pitch, predict_variances) of one segment:
        the auto-completion cascade."""
        if self.auto_completion_mode:
            return (
                self.model.predict_dur and param.get("ph_dur") is None,
                self.model.predict_pitch and param.get("f0_seq") is None,
                bool(self.model.var_list) and any(
                    param.get(v) is None for v in self.model.var_list),
            )
        predict_variances = bool(self.model.var_list) and self.global_predict_variances
        predict_pitch = self.model.predict_pitch and (
            self.global_predict_pitch or (param.get("f0_seq") is None and predict_variances))
        predict_dur = self.model.predict_dur and (
            self.global_predict_dur or (
                param.get("ph_dur") is None and (predict_pitch or predict_variances)))
        return predict_dur, predict_pitch, predict_variances

    def _apply_predictions(self, param: dict, dur_pred, pitch_pred, variance_pred) -> dict:
        """Write one segment's predictions back into a copy of its .ds params."""
        param_copy = copy.deepcopy(param)
        if dur_pred is not None and (self.auto_completion_mode or self.global_predict_dur):
            param_copy["ph_dur"] = " ".join(
                str(round(float(d) * self.timestep, 6)) for d in dur_pred)
        if pitch_pred is not None and (self.auto_completion_mode or self.global_predict_pitch):
            f0_pred = midi_to_hz(pitch_pred)
            param_copy["f0_seq"] = " ".join(str(round(float(f), 1)) for f in f0_pred)
            param_copy["f0_timestep"] = str(self.timestep)
        variance_pred = {
            k: v for k, v in (variance_pred or {}).items()
            if (self.auto_completion_mode and param.get(k) is None)
            or k in self.variance_prediction_set
        }
        for v_name, v_pred in variance_pred.items():
            param_copy[v_name] = " ".join(str(round(float(v), 4)) for v in v_pred)
            param_copy[f"{v_name}_timestep"] = str(self.timestep)

        # restore the original speaker mixes
        if "ph_spk_mix" in param_copy and "spk_mix" in param_copy:
            for key in ("ph_spk_mix", "spk_mix"):
                if f"{key}_backup" in param_copy:
                    backup = param_copy.pop(f"{key}_backup")
                    if backup is None:
                        param_copy.pop(key, None)
                    else:
                        param_copy[key] = backup
        return param_copy

    def _preprocess_all(self, params: List[dict]):
        flags_list = [self.segment_flags(p) for p in params]
        batches = [
            self.preprocess_input(p, idx=i, load_dur=not f[0] and (f[1] or f[2]),
                                  load_pitch=not f[1] and f[2])
            for i, (p, f) in enumerate(zip(params, flags_list))
        ]
        return flags_list, batches

    @staticmethod
    def _save(results: List[dict], out_dir: pathlib.Path, title: str, run: int, num_runs: int):
        filename = f"{title}-{str(run).zfill(3)}.ds" if num_runs > 1 else f"{title}.ds"
        save_path = out_dir / filename
        with open(save_path, "w", encoding="utf8") as f:
            print(f"| save params: {save_path}")
            json.dump(results, f, ensure_ascii=False, indent=2)

    def run_inference(self, params: List[dict], out_dir: pathlib.Path = None,
                      title: str = None, num_runs: int = 1, seed: int = -1,
                      steps: Optional[int] = None, *, noise_fn: Optional[NoiseFn] = None):
        """Predict every segment one by one and write ``<title>.ds``.
        ``noise_fn`` is called with the segment's index and supplies the
        samplers' first draws instead of the generator."""
        flags_list, batches = self._preprocess_all(params)
        out_dir = pathlib.Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        for run in range(num_runs):
            results = []
            for i, (param, flags, batch) in enumerate(zip(params, flags_list, batches)):
                if "seed" in param:
                    generator = self._generator(param["seed"])
                elif seed >= 0:
                    generator = self._generator(seed)
                else:
                    generator = self._generator(hash((title, run, i)))
                noise = self.injected_noise(
                    noise_fn, i, 1, bucket_length(batch["base_pitch"].shape[1]))
                results.append(self._apply_predictions(
                    param, *self.forward_model(batch, flags, generator, steps=steps, **noise)))
            self._save(results, out_dir, title, run, num_runs)
