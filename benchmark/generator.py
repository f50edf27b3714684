"""The traffic generator: songs of ``.ds`` phrases, as an editor exports them.

A traffic mix is a JSON file under ``benchmark/traffic/`` that this module
reads (:func:`load_mix`). Its keys:

- ``kind``: ``"render"`` (phrases with phonemes, their durations and an f0
  curve, for the acoustic model) or ``"score"`` (score-only phrases: words,
  notes and slurs, for the variance model);
- ``driver``: the module under ``benchmark/drivers/`` that serves the mix;
- ``plan_seed``, ``songs_in_plan``, ``phrases_per_song`` [lo, hi] (uniform),
  ``phrase_seconds`` [lo, hi] (log-uniform), ``phonemes_per_second`` [lo, hi]
  (uniform): the sizes. They come from ``plan_seed`` alone, so every run's
  seed gets the same songs of the same sizes (:func:`plan`);
- ``midi_range``, ``vibrato_hz``, ``vibrato_semitones``, ``slur_share``,
  ``f0_timestep``: the content, drawn from the run's seed (:func:`songs`);
- ``max_batch_size``, ``reference_phrases``: the server's batch and how many
  phrases a run's check compares with the reference.

A ``"train"`` mix sizes a binarized store instead (:func:`store_items`):
``items`` phrases of ``phrase_seconds`` and ``phonemes_per_second`` from
``plan_seed``, each with its phonemes, durations and f0 as a render phrase
has them and a seeded mel spectrogram around ``mel_mean`` (``mel_std``,
smoothed over ``mel_smooth_frames``).

Durations are whole frames: each boundary lies a quarter frame before its
frame, so the servers' rounding gives back the planned frame counts.
"""

from __future__ import annotations

import json
import math
from pathlib import Path
from typing import Dict, List

import numpy as np

HERE = Path(__file__).resolve().parent
DICTIONARY = HERE / "data" / "opencpop-extension.txt"
NOTE_NAMES = ("C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B")


def load_mix(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json", encoding="utf-8") as f:
        return json.load(f)


def seed_key(seed: int) -> int:
    """Any whole number (negative or past 64 bits too) as a SeedSequence entropy word."""
    return seed % (1 << 64)


def plan(mix: dict, timestep: float) -> List[List[dict]]:
    """The sizes: for each song of the plan, its phrases' frames and phoneme counts."""
    rng = np.random.default_rng(mix["plan_seed"])
    lo_s, hi_s = mix["phrase_seconds"]
    out = []
    for _ in range(mix["songs_in_plan"]):
        n = int(rng.integers(mix["phrases_per_song"][0], mix["phrases_per_song"][1] + 1))
        seconds = np.exp(rng.uniform(math.log(lo_s), math.log(hi_s), n))
        rate = rng.uniform(*mix["phonemes_per_second"], n)
        out.append([{"frames": int(round(s / timestep)), "phonemes": max(3, int(round(s * r)))}
                    for s, r in zip(seconds, rate)])
    return out


def syllables() -> List[List[str]]:
    with open(DICTIONARY, encoding="utf8") as f:
        return [line.strip().split("\t")[1].split() for line in f if line.strip()]


def split_frames(rng, total: int, parts: int, least: int) -> np.ndarray:
    """``parts`` positive integer frame counts of sum ``total``, each >= ``least``."""
    least = min(least, total // parts)
    spare = total - least * parts
    cuts = np.sort(rng.integers(0, spare + 1, parts - 1))
    return np.diff(np.concatenate([[0], cuts, [spare]])) + least


def seconds_text(frames: np.ndarray, timestep: float) -> str:
    """Frame counts as seconds whose cumulative boundaries lie a quarter frame early."""
    bounds = (np.cumsum(frames) - 0.25) * timestep
    return " ".join(f"{d:.6f}" for d in np.diff(np.concatenate([[0.0], bounds])))


def note_name(midi: int) -> str:
    return f"{NOTE_NAMES[midi % 12]}{midi // 12 - 1}"


def _words(rng, sylls, n_ph: int):
    """A phrase's words as phoneme lists: a breath, syllables, a pause."""
    words, count = [["AP"]], 2
    while count < n_ph:
        s = sylls[int(rng.integers(len(sylls)))]
        words.append(s)
        count += len(s)
    words.append(["SP"])
    return words


def _f0(rng, mix, midis: np.ndarray, note_frames: np.ndarray, timestep: float) -> np.ndarray:
    """An f0 curve at ``f0_timestep``: the notes' pitches joined by 60 ms glides,
    with vibrato on notes longer than 0.3 s."""
    step = mix["f0_timestep"]
    total = note_frames.sum() * timestep
    t = np.arange(int(math.ceil(total / step)) + 1) * step
    ends = np.cumsum(note_frames) * timestep
    idx = np.minimum(np.searchsorted(ends, t, side="right"), len(midis) - 1)
    pitch = midis[idx].astype(np.float64)
    pitch = np.convolve(np.pad(pitch, 6, mode="edge"), np.ones(13) / 13, mode="valid")
    starts = np.concatenate([[0.0], ends[:-1]])
    since = t - starts[idx]
    rate = rng.uniform(*mix["vibrato_hz"], len(midis))[idx]
    depth = rng.uniform(*mix["vibrato_semitones"], len(midis))[idx]
    pitch += depth * np.clip(since - 0.3, 0, 0.2) / 0.2 * np.sin(2 * np.pi * rate * since)
    return 440.0 * 2.0 ** ((pitch - 69.0) / 12.0)


def _phrase(rng, mix, sylls, size: dict, timestep: float) -> dict:
    words = _words(rng, sylls, size["phonemes"])
    lo, hi = mix["midi_range"]
    notes, slurs, note_words = [], [], []
    for w, phones in enumerate(words):
        rest = phones[0] in ("AP", "SP")
        extra = (not rest) and rng.random() < mix["slur_share"]
        for k in range(1 + extra):
            notes.append(-1 if rest else int(rng.integers(lo, hi + 1)))
            slurs.append(int(k > 0))
            note_words.append(w)
    note_frames = split_frames(rng, size["frames"], len(notes), 3)
    seg = {
        "offset": 0.0,
        "text": " ".join(p[0] if len(p) == 1 else "".join(p) for p in words),
        "ph_seq": " ".join(p for phones in words for p in phones),
        "ph_num": " ".join(str(len(phones)) for phones in words),
        "note_seq": " ".join("rest" if m < 0 else note_name(m) for m in notes),
        "note_dur": seconds_text(note_frames, timestep),
        "note_slur": " ".join(map(str, slurs)),
    }
    if mix["kind"] == "render":
        # the phonemes share their word's frames; each gets at least 2
        word_frames = np.zeros(len(words), np.int64)
        np.add.at(word_frames, note_words, note_frames)
        ph_frames = np.concatenate([split_frames(rng, int(f), len(p), 2)
                                    for f, p in zip(word_frames, words)])
        midis = np.asarray(notes, np.float64)  # a rest sings at its neighbour's pitch
        known = np.flatnonzero(midis >= 0)
        if len(known) == 0:
            midis[:] = 60.0
        else:
            nearest = known[np.abs(np.arange(len(midis))[:, None] - known[None, :]).argmin(1)]
            midis = midis[nearest]
        seg["ph_dur"] = seconds_text(ph_frames, timestep)
        seg["f0_seq"] = " ".join(f"{v:.1f}" for v in _f0(rng, mix, midis, note_frames, timestep))
        seg["f0_timestep"] = str(mix["f0_timestep"])
    return seg


def songs(mix: dict, seed: int, timestep: float) -> List[List[Dict]]:
    """The plan's songs with content drawn from ``seed``: phrases in a
    seed-shuffled order, phonemes, notes, slurs and (render) durations and f0."""
    sylls = syllables()
    out = []
    for k, sizes in enumerate(plan(mix, timestep)):
        rng = np.random.default_rng([seed_key(seed), k])
        order = rng.permutation(len(sizes))
        out.append([_phrase(rng, mix, sylls, sizes[i], timestep) for i in order])
    return out


def frames(seg: dict, timestep: float) -> int:
    """A phrase's frame count, as the servers round its note durations."""
    secs = np.asarray(seg["note_dur"].split(), np.float32)
    return int(np.round(np.sum(secs, dtype=np.float32) / np.float32(timestep) + 0.5))


def store_sizes(mix: dict, timestep: float) -> List[dict]:
    """A training store's item sizes, from ``plan_seed`` alone."""
    rng = np.random.default_rng(mix["plan_seed"])
    lo_s, hi_s = mix["phrase_seconds"]
    seconds = np.exp(rng.uniform(math.log(lo_s), math.log(hi_s), mix["items"]))
    rate = rng.uniform(*mix["phonemes_per_second"], mix["items"])
    return [{"frames": int(round(s / timestep)), "phonemes": max(3, int(round(s * r)))}
            for s, r in zip(seconds, rate)]


def store_items(mix: dict, seed: int, timestep: float, n_mels: int) -> List[dict]:
    """The store's items with content from ``seed``: each a render phrase
    (``.ds`` fields) and its mel [frames, n_mels] float32."""
    sylls = syllables()
    rng = np.random.default_rng([seed_key(seed), 1 << 20])
    kind = dict(mix, kind="render")
    width = mix["mel_smooth_frames"]
    out = []
    for size in store_sizes(mix, timestep):
        seg = _phrase(rng, kind, sylls, size, timestep)
        raw = rng.standard_normal((size["frames"] + width - 1, n_mels), np.float32)
        smooth = np.cumsum(raw, axis=0, dtype=np.float32)
        smooth = (smooth[width - 1:] - np.concatenate([np.zeros((1, n_mels), np.float32),
                                                       smooth[:-width]])) / math.sqrt(width)
        out.append({"seg": seg, "mel": mix["mel_mean"] + mix["mel_std"] * smooth})
    return out
