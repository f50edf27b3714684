"""Deterministic conformance-signal bank for the WORLD-family extractors.

(Own copy of diffsinger_tpu/dsp/golden_signals.py: numpy only, unchanged;
its signals hash to ``tests/goldens/bank_hashes.json`` like the original's.)

The reference binarizes real corpora through pyworld's C++ Harvest/D4C
(reference utils/decomposed_waveform.py:129, modules/pe/pw.py:7). pyworld is
not a dependency, so cross-implementation parity is
quantified through golden fixtures instead:

- ``tools/capture_world_goldens.py`` runs on any pyworld-equipped machine,
  regenerates exactly these signals (verified by SHA256), records pyworld's
  harvest/d4c output to ``tests/goldens/world_goldens.npz``.
- ``tests/test_world_goldens.py`` compares the native implementations against
  that file at documented tolerances whenever it is present, and always
  asserts the signal bank itself is byte-stable.

Every signal is float64 in [-1, 1], 44.1 kHz, seeded — no clock, no
platform-dependent RNG. Changing anything here invalidates captured goldens,
so bump ``BANK_VERSION`` on any edit.
"""

from __future__ import annotations

import hashlib

import numpy as np

BANK_VERSION = 1
FS = 44100
HOP = 512
FFT_SIZE = 2048
F0_FLOOR = 65.0
F0_CEIL = 1100.0
FRAME_PERIOD_MS = 1000.0 * HOP / FS


def _t(seconds: float) -> np.ndarray:
    return np.arange(int(FS * seconds), dtype=np.float64) / FS


def _norm(y: np.ndarray) -> np.ndarray:
    return y / np.abs(y).max()


def _harmonic(f0: float, seconds: float, n_harm: int = 10, decay: float = 0.6) -> np.ndarray:
    t = _t(seconds)
    y = sum((decay ** k) * np.sin(2 * np.pi * f0 * (k + 1) * t) for k in range(n_harm))
    return _norm(y)


def _pulse_train(f0_curve: np.ndarray) -> np.ndarray:
    """Impulse train with instantaneous frequency ``f0_curve`` (per-sample)."""
    phase = np.cumsum(f0_curve) / FS
    y = np.zeros_like(phase)
    y[np.diff(np.floor(phase), prepend=0.0) > 0] = 1.0
    return y


def _formant_filter(x: np.ndarray, formants, bandwidths) -> np.ndarray:
    """Cascade of 2nd-order resonators — a crude /a/-like vocal tract."""
    from scipy.signal import lfilter

    y = x.astype(np.float64)
    for fc, bw in zip(formants, bandwidths):
        r = np.exp(-np.pi * bw / FS)
        theta = 2 * np.pi * fc / FS
        y = lfilter([1.0], [1.0, -2 * r * np.cos(theta), r * r], y)
    return _norm(y)


def vowel_pulse_train(f0: float = 135.0, seconds: float = 1.2) -> np.ndarray:
    """Speech-shaped: glottal-like pulse train through /a/ formants
    (F1=800, F2=1200, F3=2600 Hz)."""
    src = _pulse_train(np.full(int(FS * seconds), f0))
    return _formant_filter(src, (800.0, 1200.0, 2600.0), (80.0, 100.0, 160.0))


def breathy_vowel(f0: float = 200.0, seconds: float = 1.2, noise_db: float = -12.0) -> np.ndarray:
    """Harmonic vowel + high-passed noise 'breath' at ``noise_db`` relative level."""
    y = _harmonic(f0, seconds)
    from scipy.signal import lfilter

    rng = np.random.default_rng(1234)
    noise = rng.standard_normal(len(y))
    # one-pole high-pass around 3 kHz to mimic aspiration's spectral tilt
    alpha = np.exp(-2 * np.pi * 3000.0 / FS)
    hp = lfilter([alpha, -alpha], [1.0, -alpha], noise)
    hp /= np.sqrt((hp ** 2).mean())
    gain = 10 ** (noise_db / 20.0) * np.sqrt((y ** 2).mean())
    return _norm(y + gain * hp)


def octave_jump(seconds: float = 1.6) -> np.ndarray:
    """f0 jumps 110 -> 220 Hz mid-signal: contour-fixing stressor."""
    n = int(FS * seconds)
    f0 = np.full(n, 110.0)
    f0[n // 2:] = 220.0
    phase = np.cumsum(f0) / FS
    y = sum((0.6 ** k) * np.sin(2 * np.pi * (k + 1) * phase) for k in range(8))
    return _norm(y)


def octave_trap(f0: float = 110.0, seconds: float = 1.2) -> np.ndarray:
    """Weak fundamental, dominant 2nd harmonic — the classic octave-error bait."""
    t = _t(seconds)
    y = (0.15 * np.sin(2 * np.pi * f0 * t)
         + 1.00 * np.sin(2 * np.pi * 2 * f0 * t)
         + 0.50 * np.sin(2 * np.pi * 3 * f0 * t)
         + 0.30 * np.sin(2 * np.pi * 4 * f0 * t))
    return _norm(y)


def vibrato(f0: float = 220.0, seconds: float = 2.0, depth_semitones: float = 0.5,
            rate_hz: float = 5.5) -> np.ndarray:
    t = _t(seconds)
    inst = f0 * 2 ** (depth_semitones / 12 * np.sin(2 * np.pi * rate_hz * t))
    phase = np.cumsum(inst) / FS
    y = sum((0.6 ** k) * np.sin(2 * np.pi * (k + 1) * phase) for k in range(8))
    return _norm(y)


def vibrato_true_f0(pos_sec: np.ndarray, f0: float = 220.0, depth_semitones: float = 0.5,
                    rate_hz: float = 5.5) -> np.ndarray:
    return f0 * 2 ** (depth_semitones / 12 * np.sin(2 * np.pi * rate_hz * pos_sec))


def noise_burst(seconds: float = 1.0) -> np.ndarray:
    rng = np.random.default_rng(77)
    return _norm(rng.standard_normal(int(FS * seconds)))


def tone_to_silence(f0: float = 220.0, seconds: float = 1.6) -> np.ndarray:
    y = _harmonic(f0, seconds)
    y[len(y) // 2:] = 0.0
    return y


def signal_bank() -> dict:
    """name -> (waveform float64, nominal_f0 or 0 for unvoiced/none)."""
    return {
        "steady_low": (_harmonic(82.4, 1.2), 82.4),
        "steady_mid": (_harmonic(220.0, 1.2), 220.0),
        "steady_high": (_harmonic(660.0, 1.2), 660.0),
        "vowel_pulse": (vowel_pulse_train(), 135.0),
        "breathy": (breathy_vowel(), 200.0),
        "octave_jump": (octave_jump(), 0.0),
        "octave_trap": (octave_trap(), 110.0),
        "vibrato": (vibrato(), 220.0),
        "noise": (noise_burst(), 0.0),
        "tone_silence": (tone_to_silence(), 0.0),
    }


def bank_hashes() -> dict:
    """SHA256 of each signal's raw float64 little-endian bytes — the capture
    machine asserts these before recording goldens."""
    return {
        name: hashlib.sha256(np.ascontiguousarray(w, np.float64).tobytes()).hexdigest()
        for name, (w, _) in signal_bank().items()
    }
