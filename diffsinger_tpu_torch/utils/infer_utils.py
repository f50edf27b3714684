"""Host-side helpers (numpy): note and pitch conversions, curve resampling,
cross-fade, wav input and output, speaker-mix parsing, key transposition.

Own copy of the helpers of diffsinger_tpu/utils/infer_utils.py that the
inference runtime uses; the arithmetic is the same line for line, so both
packages preprocess a score into bit-equal arrays.
"""

from __future__ import annotations

import re

import numpy as np

_NOTE_NAMES = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]
_NOTE_OFFSETS = {"C": 0, "D": 2, "E": 4, "F": 5, "G": 7, "A": 9, "B": 11}


def note_to_midi(note: str) -> int:
    """'C4' -> 60, supporting # / b / unicode accidentals (librosa convention)."""
    m = re.fullmatch(r"([A-Ga-g])([#♯b!♭𝄪𝄫]*)(-?\d+)", note.strip())
    if m is None:
        raise ValueError(f"Invalid note name: {note}")
    letter, accidentals, octave = m.groups()
    acc = 0
    for ch in accidentals:
        if ch in "#♯":
            acc += 1
        elif ch in "b!♭":
            acc -= 1
        elif ch == "𝄪":
            acc += 2
        elif ch == "𝄫":
            acc -= 2
    return 12 * (int(octave) + 1) + _NOTE_OFFSETS[letter.upper()] + acc


def midi_to_note(midi: int) -> str:
    return f"{_NOTE_NAMES[midi % 12]}{midi // 12 - 1}"


def midi_to_hz(midi) -> np.ndarray:
    return 440.0 * (2.0 ** ((np.asarray(midi, dtype=np.float64) - 69.0) / 12.0))


def hz_to_midi(hz) -> np.ndarray:
    return 12.0 * (np.log2(np.asarray(hz, dtype=np.float64)) - np.log2(440.0)) + 69.0


def trans_f0_seq(feature_pit, transform):
    return round(feature_pit * 2 ** (transform / 12), 1)


def trans_key(raw_data, key):
    """Transpose note_seq and f0_seq of parsed .ds segments by ``key`` semitones
    (reference utils/infer_utils.py:13-38)."""
    warn = False
    for seg in raw_data:
        notes = seg["note_seq"].split(" ")
        seg["note_seq"] = " ".join(
            n if n == "rest" else midi_to_note(note_to_midi(n) + key) for n in notes
        )
        if seg.get("f0_seq"):
            f0s = [float(x) for x in seg["f0_seq"].split(" ")]
            seg["f0_seq"] = " ".join(str(trans_f0_seq(f, key)) for f in f0s)
        else:
            warn = True
    if warn:
        print("Warning: parts of f0_seq do not exist, please freeze the pitch line in the editor.")
    return raw_data


def resample_align_curve(
    points: np.ndarray, original_timestep: float, target_timestep: float, align_length: int
) -> np.ndarray:
    """Linear-resample a control curve to the frame grid and clip/extend to
    ``align_length`` (reference utils/infer_utils.py:41-53)."""
    points = np.asarray(points)
    t_max = (len(points) - 1) * original_timestep
    curve = np.interp(
        np.arange(0, t_max, target_timestep),
        original_timestep * np.arange(len(points)),
        points,
    ).astype(points.dtype)
    delta = align_length - len(curve)
    if delta < 0:
        curve = curve[:align_length]
    elif delta > 0:
        curve = np.concatenate([curve, np.full(delta, curve[-1], dtype=curve.dtype)])
    return curve


def parse_commandline_spk_mix(mix: str) -> dict:
    """Parse 'name', 'a|b', or 'a:0.5|b:0.5' into normalized proportions
    (reference utils/infer_utils.py:56-86)."""
    name_pattern = r"[0-9A-Za-z_-]+"
    proportion_pattern = r"\d+(\.\d+)?"
    single = rf"{name_pattern}(:{proportion_pattern})?"
    assert re.fullmatch(rf"{single}(\|{single})*", mix) is not None, f"Invalid mix pattern: {mix}"
    unspecified = set()
    proportions: dict = {}
    for component in mix.split("|"):
        parts = component.split(":")
        assert parts[0] not in unspecified and parts[0] not in proportions, (
            f"Duplicate speaker name: {parts[0]}"
        )
        if len(parts) == 2:
            proportions[parts[0]] = float(parts[1])
        else:
            unspecified.add(parts[0])
    given = sum(proportions.values())
    assert given < 1 or not unspecified, (
        "Proportions must all be specified when given proportions sum to >= 1."
    )
    for name in unspecified:
        proportions[name] = (1 - given) / len(unspecified)
    total = sum(proportions.values())
    assert total > 0, "Sum of all proportions should be positive."
    return {k: v / total for k, v in proportions.items()}


def cross_fade(a: np.ndarray, b: np.ndarray, idx: int) -> np.ndarray:
    """Overlap-add ``b`` onto ``a`` starting at sample ``idx`` with a linear fade
    (reference utils/infer_utils.py:89-96)."""
    result = np.zeros(idx + b.shape[0])
    fade_len = a.shape[0] - idx
    result[:idx] = a[:idx]
    k = np.linspace(0, 1.0, num=fade_len, endpoint=True)
    result[idx : a.shape[0]] = (1 - k) * a[idx:] + k * b[:fade_len]
    result[a.shape[0] :] = b[fade_len:]
    return result


def save_wav(wav: np.ndarray, path, sr: int, norm: bool = False) -> None:
    import wave

    if norm:
        wav = wav / np.abs(wav).max()
    data = np.clip(wav * 32767, -32768, 32767).astype(np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sr)
        f.writeframes(data.tobytes())


def load_wav(path, target_sr: int | None = None) -> tuple[np.ndarray, int]:
    """Read a 16- or 32-bit PCM WAV as float32 in [-1, 1] (channels averaged),
    resampled on the host to ``target_sr`` where its rate differs."""
    import wave

    with wave.open(str(path), "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        width = f.getsampwidth()
        channels = f.getnchannels()
        raw = f.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"Unsupported WAV sample width: {width}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    if target_sr is not None and target_sr != sr:
        from diffsinger_tpu_torch.dsp.resample import resample_poly_np

        data = resample_poly_np(data, sr, target_sr)
        sr = target_sr
    return data, sr
