"""D4C band-aperiodicity estimator (Morise 2016), native replacement for
``pyworld.d4c`` (reference utils/decomposed_waveform.py:129 calls
``pw.d4c(x, f0, t, samplerate, fft_size=fft_size)``).

(Own copy of diffsinger_tpu/dsp/d4c.py: numpy only, unchanged.)

Faithful to the published algorithm and the WORLD C++ structure:

1. **D4C LoveTrain** — a per-frame voicing confidence: the ratio of cumulative
   band power P(100..4000 Hz) / P(100..7900 Hz) of a Blackman-windowed (3
   periods) frame. Frames with ratio <= ``threshold`` (0.85) are declared
   fully aperiodic.
2. **D4C general body** per voiced frame:
   - *static centroid*: Re{F[n·x] · conj(F[x])} of normalized Blackman-windowed
     (4 periods) frames at position ± T0/4, summed, DC-corrected;
   - *smoothed power spectrum*: Hanning-windowed (4 periods) power spectrum,
     DC-corrected, linearly smoothed over an f0-wide box;
   - *static group delay*: centroid / power, box-smoothed at f0/2 width, minus
     its f0-width-smoothed trend;
   - *coarse aperiodicity* per 3 kHz band: a Nuttall-windowed segment of the
     group delay around the band center is Fourier-analyzed; the fraction of
     spectral energy outside the largest ``boundary`` sorted components gives
     the band aperiodicity in dB, shifted by (f0-100)/50 dB and clamped at 0.
3. **Spectral expansion**: linear interpolation of [-60 dB, bands..., -1e-12]
   over [0, 3k, 6k, ..., fs/2] onto the output FFT frequency axis, then
   10^(dB/20).

Everything is vectorized over frames in float64 numpy (WORLD is double
precision); this is a host-side binarization component, the same place the
reference runs the pyworld C++ code.
"""

from __future__ import annotations

import numpy as np

# Bumped whenever estimator behavior changes (recorded into binarized .meta
# provenance so dataset feature compatibility is machine-checkable).
ALGO_VERSION = 1

K_FREQUENCY_INTERVAL = 3000.0
K_UPPER_LIMIT = 15000.0
K_THRESHOLD = 0.85
K_FLOOR_F0_D4C = 47.0
K_LOVE_TRAIN_LOWEST_F0 = 40.0
K_SAFE_GUARD_MIN = 1e-12


def _matlab_round(x):
    return np.floor(x + 0.5).astype(np.int64)


def _fft_size_for(fs: float, periods: float, floor_f0: float) -> int:
    return int(2 ** (1 + int(np.log2(periods * fs / floor_f0 + 1))))


def _windowed_frames(
    x: np.ndarray, fs: int, f0: np.ndarray, positions: np.ndarray,
    window_type: str, ratio: float, max_half: int, rng: np.random.Generator,
) -> np.ndarray:
    """WORLD GetWindowedWaveform, vectorized: [F, 2*max_half+1] frames.

    Per-frame window half-length is round(ratio*fs/f0/2); samples beyond it
    are masked to zero (static shape across the batch). The windowed frame is
    mean-removed with window weighting, exactly like the C++.
    """
    n_frames = len(f0)
    half = _matlab_round(ratio * fs / f0 / 2.0)  # [F]
    base = np.arange(-max_half, max_half + 1)[None, :]  # [1, W]
    active = np.abs(base) <= half[:, None]
    origin = _matlab_round(positions * fs + 0.001)[:, None]
    safe = np.clip(origin + base, 0, len(x) - 1)
    seg = x[safe]  # [F, W]

    pos_t = (2.0 * base / ratio) / fs  # [F?, W] broadcast
    arg = np.pi * pos_t * f0[:, None]
    if window_type == "blackman":
        win = 0.42 + 0.5 * np.cos(arg) + 0.08 * np.cos(2 * arg)
    elif window_type == "hanning":
        win = 0.5 + 0.5 * np.cos(arg)
    elif window_type == "nuttall":
        win = (0.355768 + 0.487396 * np.cos(arg) + 0.144232 * np.cos(2 * arg)
               + 0.012604 * np.cos(3 * arg))
    else:  # pragma: no cover
        raise ValueError(window_type)
    win = np.where(active, win, 0.0)

    wave = seg * win + rng.standard_normal((n_frames, base.shape[1])) * K_SAFE_GUARD_MIN
    wave = np.where(active, wave, 0.0)
    weight = wave.sum(axis=1) / np.maximum(win.sum(axis=1), 1e-300)
    return wave - win * weight[:, None]


def _dc_correction(spec: np.ndarray, f0: np.ndarray, fs: int, fft_size: int) -> np.ndarray:
    """WORLD DCCorrection: mirror the spectrum below f0 back onto the low bins
    (output[i] += input(f0 - freq_i) for freq_i < f0), vectorized per frame."""
    n_bins = fft_size // 2 + 1
    bin_hz = fs / fft_size
    freqs = np.arange(n_bins) * bin_hz  # [B]
    mirror_f = f0[:, None] - freqs[None, :]  # [F, B]
    # linear interp of spec at mirror_f (only where mirror_f > 0)
    q = mirror_f / bin_hz
    qf = np.clip(np.floor(q).astype(np.int64), 0, n_bins - 2)
    frac = q - qf
    rows = np.arange(spec.shape[0])[:, None]
    interp = spec[rows, qf] * (1 - frac) + spec[rows, qf + 1] * frac
    add = np.where(mirror_f > 0, interp, 0.0)
    # WORLD applies the replica only below f0 (upper_limit_replica bins)
    low = freqs[None, :] < f0[:, None]
    return spec + np.where(low, add, 0.0)


def _linear_smoothing(spec: np.ndarray, width: np.ndarray, fs: int, fft_size: int) -> np.ndarray:
    """WORLD LinearSmoothing: box smoothing of width `width` Hz via an
    interpolated cumulative integral over a boundary-mirrored spectrum."""
    n_bins = fft_size // 2 + 1
    bin_hz = fs / fft_size
    boundary = int(np.max(width) / bin_hz) + 1
    # mirror at both ends: indices boundary..0 reversed, 0..n-1, n-1..  (C++)
    left = spec[:, boundary:0:-1]
    right = spec[:, n_bins - 2:n_bins - 2 - boundary:-1]
    mirrored = np.concatenate([left, spec, right], axis=1)  # [F, n+2b]
    seg = np.cumsum(mirrored * bin_hz, axis=1)
    # cumulative integral sampled at f ± width/2; origin of the mirrored axis
    origin = -(boundary - 0.5) * bin_hz
    freqs = np.arange(n_bins) * bin_hz

    def interp_at(f):
        q = (f - origin) / bin_hz
        qf = np.clip(np.floor(q).astype(np.int64), 0, seg.shape[1] - 2)
        frac = q - qf
        rows = np.arange(seg.shape[0])[:, None]
        return seg[rows, qf] * (1 - frac) + seg[rows, qf + 1] * frac

    lo = interp_at(freqs[None, :] - width[:, None] / 2)
    hi = interp_at(freqs[None, :] + width[:, None] / 2)
    return (hi - lo) / width[:, None]


def _love_train(x: np.ndarray, fs: int, f0: np.ndarray, positions: np.ndarray,
                rng: np.random.Generator) -> np.ndarray:
    """Voicing confidence P(100..4000)/P(100..7900) per frame."""
    fft_size = _fft_size_for(fs, 3.0, K_LOVE_TRAIN_LOWEST_F0)
    b0 = int(np.ceil(100.0 * fft_size / fs))
    b1 = int(np.ceil(4000.0 * fft_size / fs))
    b2 = int(np.ceil(7900.0 * fft_size / fs))
    f0_eff = np.maximum(f0, K_LOVE_TRAIN_LOWEST_F0)
    max_half = int(_matlab_round(3.0 * fs / K_LOVE_TRAIN_LOWEST_F0 / 2.0))
    frames = _windowed_frames(x, fs, f0_eff, positions, "blackman", 3.0, max_half, rng)
    spec = np.fft.rfft(frames, n=fft_size, axis=1)
    power = spec.real ** 2 + spec.imag ** 2
    power[:, : b0 + 1] = 0.0
    csum = np.cumsum(power[:, : b2 + 1], axis=1)
    return csum[:, b1] / np.maximum(csum[:, b2], 1e-300)


def _get_centroid(x, fs, f0, positions, fft_size, max_half, rng):
    wave = _windowed_frames(x, fs, f0, positions, "blackman", 4.0, max_half, rng)
    power = np.sum(wave * wave, axis=1, keepdims=True)
    wave = wave / np.sqrt(np.maximum(power, 1e-300))
    s1 = np.fft.rfft(wave, n=fft_size, axis=1)
    # time index counts from the per-frame *window start* (C++ places the
    # window at the buffer head; ours is centered at max_half)
    half = _matlab_round(4.0 * fs / f0 / 2.0)[:, None]
    idx = np.arange(wave.shape[1], dtype=np.float64)[None, :] - max_half + half
    s2 = np.fft.rfft(wave * idx, n=fft_size, axis=1)
    return s2.real * s1.real + s2.imag * s1.imag


def _general_body(x, fs, f0, positions, fft_size, n_bands, rng):
    """Coarse aperiodicity [F, n_bands] (dB, <= 0) for voiced frames."""
    max_half = int(_matlab_round(4.0 * fs / K_FLOOR_F0_D4C / 2.0))
    t0_quarter = 0.25 / f0

    c1 = _get_centroid(x, fs, f0, positions - t0_quarter, fft_size, max_half, rng)
    c2 = _get_centroid(x, fs, f0, positions + t0_quarter, fft_size, max_half, rng)
    static_centroid = _dc_correction(c1 + c2, f0, fs, fft_size)

    wave = _windowed_frames(x, fs, f0, positions, "hanning", 4.0, max_half, rng)
    spec = np.fft.rfft(wave, n=fft_size, axis=1)
    power = spec.real ** 2 + spec.imag ** 2
    power = _dc_correction(power, f0, fs, fft_size)
    smoothed_power = _linear_smoothing(power, f0, fs, fft_size)

    # relative floor: in spectral regions holding no signal energy the box
    # integral cancels to ~0 in double precision (the WORLD NaN edge case the
    # reference works around by injecting 1e-5 noise, decomposed_waveform.py:96)
    floor = np.max(smoothed_power, axis=1, keepdims=True) * 1e-30 + 1e-300
    gd = static_centroid / np.maximum(smoothed_power, floor)
    gd = _linear_smoothing(gd, f0 / 2.0, fs, fft_size)
    gd = gd - _linear_smoothing(gd, f0, fs, fft_size)

    # coarse aperiodicity per 3 kHz band from the group-delay deviation
    window_length = int(K_FREQUENCY_INTERVAL * fft_size / fs) * 2 + 1
    half = window_length // 2
    n_wl = np.arange(window_length, dtype=np.float64)
    tmp = (n_wl + 1 - (window_length + 1) / 2.0) / (window_length + 1)
    nuttall = (0.355768 + 0.487396 * np.cos(2 * np.pi * tmp)
               + 0.144232 * np.cos(4 * np.pi * tmp)
               + 0.012604 * np.cos(6 * np.pi * tmp))
    boundary = int(_matlab_round(fft_size * 8.0 / window_length))

    n_bins = fft_size // 2 + 1
    coarse = np.empty((gd.shape[0], n_bands))
    for i in range(n_bands):
        center = int(K_FREQUENCY_INTERVAL * (i + 1) * fft_size / fs)
        seg = gd[:, center - half: center - half + window_length] * nuttall[None, :]
        s = np.fft.rfft(seg, n=fft_size, axis=1)
        p = s.real ** 2 + s.imag ** 2
        p_sorted = np.sort(p, axis=1)
        csum = np.cumsum(p_sorted, axis=1)
        coarse[:, i] = 10 * np.log10(
            np.maximum(csum[:, n_bins - boundary - 2], 1e-300)
            / np.maximum(csum[:, n_bins - 1], 1e-300)
        )
    # revision by f0 (higher pitch -> less reliable high-band estimate)
    coarse = np.minimum(0.0, coarse + (f0[:, None] - 100.0) / 50.0)
    return coarse


def d4c(
    x: np.ndarray,
    f0: np.ndarray,
    temporal_positions: np.ndarray,
    fs: int,
    fft_size: int,
    *,
    threshold: float = K_THRESHOLD,
    seed: int = 1,
) -> np.ndarray:
    """Band aperiodicity [F, fft_size//2+1] in (0, 1], pyworld.d4c contract.

    :param x: [L] float waveform
    :param f0: [F] per-frame f0 (0 = unvoiced)
    :param temporal_positions: [F] frame centers in seconds
    :param fs: sample rate
    :param fft_size: output spectral resolution (the CheapTrick fft_size)
    """
    x = np.asarray(x, np.float64)
    f0 = np.asarray(f0, np.float64)
    positions = np.asarray(temporal_positions, np.float64)
    rng = np.random.default_rng(seed)
    n_frames = len(f0)
    n_out = fft_size // 2 + 1

    n_bands = int(min(K_UPPER_LIMIT, fs / 2.0 - K_FREQUENCY_INTERVAL) / K_FREQUENCY_INTERVAL)
    fft_size_d4c = _fft_size_for(fs, 4.0, K_FLOOR_F0_D4C)

    ap0 = _love_train(x, fs, f0, positions, rng)
    voiced = (f0 > 0) & (ap0 > threshold)

    out = np.full((n_frames, n_out), 1.0 - K_SAFE_GUARD_MIN)
    if voiced.any():
        f0_v = np.maximum(f0[voiced], K_FLOOR_F0_D4C)
        coarse = _general_body(x, fs, f0_v, positions[voiced], fft_size_d4c, n_bands, rng)
        # expand [-60, coarse..., -1e-12] over [0, 3k.., fs/2] to the out axis
        cf = np.concatenate([[0.0], (np.arange(n_bands) + 1) * K_FREQUENCY_INTERVAL, [fs / 2.0]])
        cv = np.concatenate(
            [np.full((coarse.shape[0], 1), -60.0), coarse,
             np.full((coarse.shape[0], 1), -K_SAFE_GUARD_MIN)], axis=1)
        freqs = np.arange(n_out) * fs / fft_size
        db = np.empty((coarse.shape[0], n_out))
        for r in range(coarse.shape[0]):  # np.interp is 1-D; rows are few enough
            db[r] = np.interp(freqs, cf, cv[r])
        out[voiced] = 10.0 ** (db / 20.0)
    return out
