"""Plain reference of the servers' host side: ``.ds`` segments to padded
arrays, and the packing of a request's segments into chunks.

Frozen copies of the arithmetic of the port's
``inference/ds_acoustic.py::preprocess_input`` and ``_pad_batch``,
``inference/ds_variance.py::preprocess_input`` (score-only segments: word
durations from the notes), ``bucket_shapes`` and ``padded_arrays``,
``inference/serving.py``'s sort-and-pack of both servers, and
``utils/text.py``'s phoneme ids for one dictionary. numpy only.
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np


def bucket(n: int, step: int = 128, minimum: int = 128) -> int:
    return max(minimum, ((n + step - 1) // step) * step)


def phoneme_ids(dictionary_path) -> Dict[str, int]:
    """One dictionary's phonemes plus AP and SP, numbered from 1 in sorted order."""
    phones = {"AP", "SP"}
    with open(dictionary_path, encoding="utf8") as f:
        for line in f:
            if line.strip():
                phones.update(line.strip().split("\t")[1].split())
    return {p: i + 1 for i, p in enumerate(sorted(phones))}


def interp_curve(points: np.ndarray, step_in: float, step_out: float, length: int) -> np.ndarray:
    """Linear resampling of a curve onto the frame grid, cut or extended to ``length``."""
    t_max = (len(points) - 1) * step_in
    out = np.interp(np.arange(0, t_max, step_out), step_in * np.arange(len(points)),
                    points).astype(points.dtype)
    if len(out) >= length:
        return out[:length]
    return np.concatenate([out, np.full(length - len(out), out[-1], dtype=out.dtype)])


def expand(dur: np.ndarray) -> np.ndarray:
    return np.repeat(np.arange(1, len(dur) + 1), dur).astype(np.int64)


def frames_of(seconds: np.ndarray, timestep: float) -> np.ndarray:
    """Durations in seconds -> integer frames that keep the cumulative sum."""
    acc = np.round(np.cumsum(seconds) / timestep + 0.5).astype(np.int64)
    return np.diff(acc, prepend=0)


# ---------------------------------------------------------------- acoustic

def acoustic_arrays(seg: dict, ids: Dict[str, int], timestep: float) -> Dict[str, np.ndarray]:
    """tokens [T_ph], mel2ph [T] (1-based), f0 [T] Hz of one segment."""
    tokens = np.asarray([ids[p] for p in seg["ph_seq"].split()], np.int64)
    mel2ph = expand(frames_of(np.asarray(seg["ph_dur"].split(), np.float32), timestep))
    f0 = interp_curve(np.asarray(seg["f0_seq"].split(), np.float32), float(seg["f0_timestep"]),
                      timestep, len(mel2ph))
    return {"tokens": tokens, "mel2ph": mel2ph, "f0": f0}


def acoustic_chunks(arrays: Sequence[dict], max_batch: int) -> List[Tuple[List[int], int, int]]:
    """(segment indices, T_txt bucket, T_mel bucket) of each chunk in dispatch
    order: sorted by (frame bucket, token bucket), cut into ``max_batch``."""
    keys = [(bucket(len(a["tokens"]), 16, 16), bucket(len(a["mel2ph"]))) for a in arrays]
    order = sorted(range(len(arrays)), key=lambda i: (keys[i][1], keys[i][0]))
    out = []
    for s in range(0, len(order), max_batch):
        chunk = order[s:s + max_batch]
        out.append((chunk, max(keys[i][0] for i in chunk), max(keys[i][1] for i in chunk)))
    return out


def pad(x: np.ndarray, length: int, value=0) -> np.ndarray:
    return np.pad(x, (0, length - len(x)), constant_values=value)


# ---------------------------------------------------------------- variance

NOTE_STEPS = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}


def note_midi(name: str) -> float:
    """'C4', 'D#4', 'Eb3' -> MIDI number (C4 = 60)."""
    m = re.fullmatch(r"([A-G])([#b]?)(-?\d+)", name)
    if m is None:
        raise ValueError(f"unsupported note {name!r}")
    shift = {"": 0, "#": 1, "b": -1}[m.group(2)]
    return float(12 * (int(m.group(3)) + 1) + NOTE_STEPS[m.group(1)] + shift)


def smoothing_kernel(size: int) -> np.ndarray:
    if size <= 1:
        return np.ones(1, np.float32)
    k = np.sin(np.linspace(0, 1, size, dtype=np.float32) * np.pi)  # a half-sine window
    return k / k.sum()


def smooth(curve: np.ndarray, size: int) -> np.ndarray:
    """'same' convolution with a sine window, edges repeated."""
    left = (size - 1) // 2
    x = np.pad(curve.astype(np.float32), (left, size - 1 - left), mode="edge")
    return np.convolve(x, smoothing_kernel(size)[::-1], mode="valid").astype(np.float32)


def variance_arrays(seg: dict, ids: Dict[str, int], timestep: float,
                    smooth_frames: int) -> Dict[str, np.ndarray]:
    """The arrays of a score-only segment: tokens, midi, ph2word [T_ph];
    word_dur [T_w]; base_pitch, expr [T]."""
    tokens = np.asarray([ids[p] for p in seg["ph_seq"].split()], np.int64)
    ph2word = expand(np.asarray(seg["ph_num"].split(), np.int64))
    names = seg["note_seq"].split()
    midi = np.asarray([note_midi(n) if n != "rest" else -1 for n in names], np.float32)
    rest = midi < 0
    known = np.where(~rest)[0]
    if len(known) == 0:
        midi[:] = 60.0
    else:  # a rest takes the nearest note's pitch, the left one on a tie
        for i in np.where(rest)[0]:
            dist = np.abs(known - i)
            midi[i] = midi[known[np.argmin(dist)]]
    note_dur = frames_of(np.asarray(seg["note_dur"].split(), np.float32), timestep)
    mel2note = expand(note_dur)
    t = len(mel2note)
    slur = np.asarray([int(s) for s in seg["note_slur"].split()], bool)
    note2word = np.cumsum(~slur)
    t_w = int(ph2word.max())
    word_dur = np.zeros(t_w + 1, np.int64)
    np.add.at(word_dur, note2word, note_dur)
    word_dur = word_dur[1:]
    mel2word = expand(word_dur)
    if len(mel2word) != t:
        raise ValueError("word durations do not cover the notes")
    frame_midi = np.pad(midi, (1, 0))[mel2note]
    base_pitch = smooth(frame_midi, smooth_frames)
    wdur = np.pad(word_dur, (1, 0), constant_values=1)[mel2word]
    w_midi = np.zeros(t_w + 1, np.float64)
    np.add.at(w_midi, mel2word, frame_midi / np.maximum(wdur, 1))
    ph_midi = np.pad(w_midi[1:], (1, 0))[ph2word]
    return {"tokens": tokens, "midi": np.clip(np.round(ph_midi), 0, 127).astype(np.int64),
            "ph2word": ph2word, "word_dur": word_dur, "base_pitch": base_pitch,
            "expr": np.full(t, float(seg.get("expr", 1.0)), np.float32),
            "notes": len(midi)}


def variance_chunks(arrays: Sequence[dict], max_batch: int) -> List[Tuple[List[int], tuple]]:
    """(segment indices, (T_ph, T_w, T_note, T) buckets) of each chunk in
    dispatch order: sorted by the buckets from the frame axis back, cut into
    ``max_batch``."""
    shapes = [(bucket(len(a["tokens"]), 16, 16), bucket(len(a["word_dur"]), 16, 16),
               bucket(a["notes"], 16, 16), bucket(len(a["base_pitch"]))) for a in arrays]
    order = sorted(range(len(arrays)), key=lambda i: shapes[i][::-1])
    out = []
    for s in range(0, len(order), max_batch):
        chunk = order[s:s + max_batch]
        out.append((chunk, tuple(max(shapes[i][d] for i in chunk) for d in range(4))))
    return out
