"""WORLD decomposition on the card (counterpart of diffsinger_tpu/dsp/world_device.py).

The float64 numpy D4C (:mod:`diffsinger_tpu_torch.dsp.d4c`) and synthesis
(:func:`diffsinger_tpu_torch.dsp.world.synthesize_world`) are the goldens; this
module is their float32 twin on a tensor's device, frame- and pulse-parallel:

* :func:`d4c_device`: D4C's band aperiodicity (LoveTrain, the general body,
  the band expansion) for all frames at once; the voicing decision masks the
  result at the end. The box smoothings are local multiply-adds, as in the
  JAX twin (a cumulative-sum difference cancels in float32).
* :func:`synthesis_responses_device`: WORLD synthesis' per-pulse work
  (minimum-phase spectra, fractional time shifts, DC removal, the noise
  excitation) and the placement of every response at its pulse, a sum in a
  fixed order on either device (:func:`segment_sum`), so a run gives the same
  waveform every time.
* :func:`extract_pulses`: the time base and pulse positions, in float64
  numpy on the host (the phase accumulator outgrows float32 over a minute of
  audio, and the pulse count depends on the data).
* :func:`world_harmonic_aperiodic_device`: the split (CheapTrick, D4C, two
  syntheses), frame counts padded to multiples of 64 and pulse counts to
  multiples of 512, so that cuFFT's plans repeat across items.

The waveform and both parts stay float32 on the device. The JAX twin carries
them as int16 with a scale (peak / 32000) over the TPU's host link; the
port has no such link, so its results differ from the JAX twin's by up to
half that step of each part's peak besides float32 rounding, which the
tests' tolerance for the whole split covers.

Noise: the 1e-5 input dither and each synthesis' excitation are drawn from a
``torch.Generator`` on the CPU (seeded 0 unless the caller passes one) as
sample streams of the waveform's length, and each pulse takes its samples
from its own position in the stream, so the card and the CPU draw the same
noise. Callers may inject the draws instead (``noise``), in the JAX twin's
layout: the tests inject the JAX program's own.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from diffsinger_tpu_torch.dsp.common import as_signal
from diffsinger_tpu_torch.dsp.d4c import (K_FLOOR_F0_D4C, K_FREQUENCY_INTERVAL,
                                          K_LOVE_TRAIN_LOWEST_F0, K_SAFE_GUARD_MIN,
                                          K_THRESHOLD, K_UPPER_LIMIT, _fft_size_for)
from diffsinger_tpu_torch.dsp.world import (DEFAULT_F0, box_smooth, cheaptrick,
                                            frames_by_blocks, trapezoid_weights)
from diffsinger_tpu_torch.utils import no_tf32

# Bound on per-frame f0 for the smoothing windows' extents (Harvest's f0_ceil
# is 1000 Hz, CheapTrick clips at 800). Sizes buffers only: values are clipped.
F0_CEIL_BOUND = 1100.0
FRAME_QUANTUM = 64
PULSE_QUANTUM = 512


def _matlab_round(x: torch.Tensor) -> torch.Tensor:
    return torch.floor(x + 0.5).long()


# ---------------------------------------------------------------------------
# D4C
# ---------------------------------------------------------------------------


def _windowed_frames(x, fs, f0, window_type, ratio, max_half, hop):
    """[F, 2*max_half+1] windowed, weighted-mean-removed frames centred at
    f * hop (d4c._windowed_frames without its 1e-12 dither, which guards only
    float64 cancellation on exactly zero frames)."""
    half = _matlab_round(ratio * fs / f0 / 2.0)  # [F]
    base = torch.arange(-max_half, max_half + 1, device=x.device)[None, :]
    active = base.abs() <= half[:, None]
    seg = frames_by_blocks(x, f0.shape[0], hop, -max_half, 2 * max_half + 1, pad_mode="edge")
    arg = np.pi * (2.0 * base / ratio) / fs * f0[:, None]
    if window_type == "blackman":
        win = 0.42 + 0.5 * torch.cos(arg) + 0.08 * torch.cos(2 * arg)
    elif window_type == "hanning":
        win = 0.5 + 0.5 * torch.cos(arg)
    else:  # pragma: no cover
        raise ValueError(window_type)
    win = torch.where(active, win, 0.0)
    wave = torch.where(active, seg * win, 0.0)
    weight = wave.sum(dim=1, keepdim=True) / torch.clamp(win.sum(dim=1, keepdim=True), min=1e-30)
    return wave - win * weight


def _dc_correction(spec, f0, fs, fft_size):
    """d4c._dc_correction: mirror the spectrum below f0 onto the sub-f0 bins
    (confined to the first F0_CEIL_BOUND / bin_hz columns)."""
    n_bins = fft_size // 2 + 1
    bin_hz = fs / fft_size
    head = min(n_bins - 1, int(F0_CEIL_BOUND / bin_hz) + 2)
    freqs = torch.arange(head, device=spec.device) * bin_hz
    mirror_f = f0[:, None] - freqs[None, :]
    q = mirror_f / bin_hz
    qf = torch.clamp(torch.floor(q).long(), 0, head - 1)
    frac = q - qf
    sp_h = spec[:, : head + 1]
    interp = torch.gather(sp_h, 1, qf) * (1 - frac) + torch.gather(sp_h, 1, qf + 1) * frac
    add = torch.where((mirror_f > 0) & (freqs[None, :] < f0[:, None]), interp, 0.0)
    return torch.cat([spec[:, :head] + add, spec[:, head:]], dim=1)


def _linear_smoothing(spec, width, fs, fft_size):
    """d4c._linear_smoothing with a static mirror boundary (the worst case,
    F0_CEIL_BOUND, in place of the data's largest width: the same values for
    every query) and the box integral as a local sum of the in-window bins
    with trapezoid end weights (the JAX twin's form)."""
    n_bins = fft_size // 2 + 1
    bin_hz = fs / fft_size
    boundary = int(F0_CEIL_BOUND / bin_hz) + 1
    assert boundary <= n_bins - 2
    left = spec[:, 1:boundary + 1].flip(1)
    right = spec[:, n_bins - 1 - boundary:n_bins - 1].flip(1)
    mirrored = torch.cat([left, spec, right], dim=1)
    width = torch.clamp(width, 1e-3, F0_CEIL_BOUND)
    wbins = width / bin_hz

    t = boundary - 0.5 - wbins / 2.0
    shift = torch.floor(t).long()
    frac = t - torch.floor(t)
    k_max = int(F0_CEIL_BOUND / bin_hz) + 3
    o_min = int(np.floor(boundary - 0.5 - F0_CEIL_BOUND / bin_hz / 2.0)) + 1
    o_max = (boundary - 1) + k_max
    ext = F.pad(mirrored, (0, max(0, o_max + n_bins - mirrored.shape[1])))
    acc = box_smooth(ext, trapezoid_weights(shift, frac, wbins, o_min, o_max), o_min, n_bins)
    return acc * bin_hz / width[:, None]


def _get_centroid_wide(x, fs, f0, d, fft_size, max_half, hop, d_bound):
    """d4c._get_centroid for frames centred at i*hop + d[i], |d| <= d_bound:
    the frame taken wide by 2*d_bound and the Blackman window evaluated at
    the shifted positions (the centroid Re(s2 conj(s1)) is invariant to a
    common circular shift, so neither shift needs undoing)."""
    n_frames = f0.shape[0]
    wd = 2 * max_half + 1 + 2 * d_bound
    seg = frames_by_blocks(x, n_frames, hop, -(max_half + d_bound), wd, pad_mode="edge")
    b = torch.arange(wd, device=x.device)[None, :] - (max_half + d_bound) - d[:, None]
    half = _matlab_round(4.0 * fs / f0 / 2.0)
    active = b.abs() <= half[:, None]
    arg = np.pi * (2.0 * b / 4.0) / fs * f0[:, None]
    win = torch.where(active, 0.42 + 0.5 * torch.cos(arg) + 0.08 * torch.cos(2 * arg), 0.0)
    wave = torch.where(active, seg * win, 0.0)
    weight = wave.sum(dim=1, keepdim=True) / torch.clamp(win.sum(dim=1, keepdim=True), min=1e-30)
    wave = wave - win * weight
    power = (wave * wave).sum(dim=1, keepdim=True)
    wave = wave / torch.sqrt(torch.clamp(power, min=1e-30))

    def fold(w):
        if wd <= fft_size:
            return w
        tail = w[:, fft_size:]
        return w[:, :fft_size] + F.pad(tail, (0, fft_size - tail.shape[1]))

    idx = b.float() + half[:, None].float()
    s1 = torch.fft.rfft(fold(wave), n=fft_size, dim=1)
    s2 = torch.fft.rfft(fold(wave * idx), n=fft_size, dim=1)
    return s2.real * s1.real + s2.imag * s1.imag


def _band_expansion_weights(n_bands: int, fs: int, fft_size: int) -> np.ndarray:
    """Static piecewise-linear interpolation matrix [n_bands+2, n_out] taking
    [-60, coarse_1..n, ~0] control values onto the output frequency axis
    (d4c.d4c's per-row np.interp as one product)."""
    n_out = fft_size // 2 + 1
    cf = np.concatenate([[0.0], (np.arange(n_bands) + 1) * K_FREQUENCY_INTERVAL, [fs / 2.0]])
    freqs = np.arange(n_out) * fs / fft_size
    w = np.zeros((len(cf), n_out), np.float32)
    seg_idx = np.clip(np.searchsorted(cf, freqs, side="right") - 1, 0, len(cf) - 2)
    t = np.clip((freqs - cf[seg_idx]) / (cf[seg_idx + 1] - cf[seg_idx]), 0.0, 1.0)
    w[seg_idx, np.arange(n_out)] = 1.0 - t
    w[seg_idx + 1, np.arange(n_out)] += t
    return w


@no_tf32()
def d4c_device(x: torch.Tensor, f0: torch.Tensor, *, fs: int, fft_size: int,
               hop: int) -> torch.Tensor:
    """Band aperiodicity [F, fft_size//2+1] in (0, 1] of frames centred at
    i*hop (twin of :func:`diffsinger_tpu_torch.dsp.d4c.d4c`). Every frame runs
    the general body (f0 floored at 47 Hz); the LoveTrain voicing decision
    picks between its bands and the all-aperiodic default at the end."""
    x = x.float()
    f0 = f0.float()
    dev = x.device
    n_frames = f0.shape[0]
    n_bands = int(min(K_UPPER_LIMIT, fs / 2.0 - K_FREQUENCY_INTERVAL) / K_FREQUENCY_INTERVAL)
    fft_d4c = _fft_size_for(fs, 4.0, K_FLOOR_F0_D4C)

    # --- LoveTrain voicing confidence ---
    fft_lt = _fft_size_for(fs, 3.0, K_LOVE_TRAIN_LOWEST_F0)
    b0 = int(np.ceil(100.0 * fft_lt / fs))
    b1 = int(np.ceil(4000.0 * fft_lt / fs))
    b2 = int(np.ceil(7900.0 * fft_lt / fs))
    max_half_lt = int(round(3.0 * fs / K_LOVE_TRAIN_LOWEST_F0 / 2.0))
    frames_lt = _windowed_frames(x, fs, torch.clamp(f0, min=K_LOVE_TRAIN_LOWEST_F0),
                                 "blackman", 3.0, max_half_lt, hop)
    s = torch.fft.rfft(frames_lt, n=fft_lt, dim=1)
    power = s.real ** 2 + s.imag ** 2
    power[:, : b0 + 1] = 0.0
    csum = torch.cumsum(power[:, : b2 + 1], dim=1)
    ap0 = csum[:, b1] / torch.clamp(csum[:, b2], min=1e-30)
    voiced = (f0 > 0) & (ap0 > K_THRESHOLD)

    # --- general body (all frames; unvoiced masked at the end) ---
    # the F0_CEIL_BOUND cap keeps the static extents valid
    f0_v = torch.clamp(f0, K_FLOOR_F0_D4C, F0_CEIL_BOUND)
    max_half = int(round(4.0 * fs / K_FLOOR_F0_D4C / 2.0))
    # the host rounds (position +- T0/4) * fs + 0.001 jointly; positions are
    # multiples of hop here, so the joint round is the offset's
    d_bound = int(0.25 * fs / K_FLOOR_F0_D4C) + 2
    d_m = _matlab_round(-0.25 / f0_v * fs + 0.001)
    d_p = _matlab_round(0.25 / f0_v * fs + 0.001)
    c1 = _get_centroid_wide(x, fs, f0_v, d_m, fft_d4c, max_half, hop, d_bound)
    c2 = _get_centroid_wide(x, fs, f0_v, d_p, fft_d4c, max_half, hop, d_bound)
    static_centroid = _dc_correction(c1 + c2, f0_v, fs, fft_d4c)

    wave = _windowed_frames(x, fs, f0_v, "hanning", 4.0, max_half, hop)
    sw = torch.fft.rfft(wave, n=fft_d4c, dim=1)
    pw = _dc_correction(sw.real ** 2 + sw.imag ** 2, f0_v, fs, fft_d4c)
    smoothed_power = _linear_smoothing(pw, f0_v, fs, fft_d4c)

    floor = smoothed_power.amax(dim=1, keepdim=True) * 1e-12 + 1e-30
    gd = static_centroid / torch.maximum(smoothed_power, floor)
    gd = _linear_smoothing(gd, f0_v / 2.0, fs, fft_d4c)
    gd = gd - _linear_smoothing(gd, f0_v, fs, fft_d4c)

    window_length = int(K_FREQUENCY_INTERVAL * fft_d4c / fs) * 2 + 1
    half_w = window_length // 2
    tmp = (np.arange(window_length, dtype=np.float64) + 1 - (window_length + 1) / 2.0) \
        / (window_length + 1)
    nuttall = torch.from_numpy((0.355768 + 0.487396 * np.cos(2 * np.pi * tmp)
                                + 0.144232 * np.cos(4 * np.pi * tmp)
                                + 0.012604 * np.cos(6 * np.pi * tmp)).astype(np.float32)).to(dev)
    boundary = int(round(fft_d4c * 8.0 / window_length))

    # all bands as one batched FFT; the host's sorted-cumsum ratio is
    # (total - the sum of the boundary+1 largest) / total
    segs = torch.stack([
        gd[:, c - half_w: c - half_w + window_length]
        for c in (int(K_FREQUENCY_INTERVAL * (i + 1) * fft_d4c / fs) for i in range(n_bands))
    ], dim=1)  # [F, n_bands, wl]
    sb = torch.fft.rfft(segs * nuttall, n=fft_d4c, dim=2)
    p = sb.real ** 2 + sb.imag ** 2
    total = p.sum(dim=2)
    top = torch.topk(p, boundary + 1, dim=2).values.sum(dim=2)
    coarse = 10.0 * torch.log10(torch.clamp(total - top, min=1e-30) / torch.clamp(total, min=1e-30))
    coarse = torch.clamp(coarse + (f0_v[:, None] - 100.0) / 50.0, max=0.0)

    w_exp = torch.from_numpy(_band_expansion_weights(n_bands, fs, fft_size)).to(dev)
    cv = torch.cat([torch.full((n_frames, 1), -60.0, device=dev), coarse,
                    torch.full((n_frames, 1), -float(np.float32(K_SAFE_GUARD_MIN)), device=dev)],
                   dim=1)
    ap = 10.0 ** ((cv @ w_exp) / 20.0)
    return torch.where(voiced[:, None], ap, 1.0 - K_SAFE_GUARD_MIN)


# ---------------------------------------------------------------------------
# WORLD synthesis: pulses on the host, responses on the device
# ---------------------------------------------------------------------------


def extract_pulses(f0: np.ndarray, fs: int, hop: int):
    """WORLD's time base and pulse extraction in float64 on the host
    (synthesize_world's GetTimeBase + GetPulseLocations). Returns
    (pulse_idx [P], time_shift [P] seconds, noise_size [P], frame_pos [P]
    fractional frames, vuv [P]) as numpy arrays."""
    f0 = np.asarray(f0, np.float64)
    n_frames = f0.shape[0]
    frame_period = hop / fs
    y_length = n_frames * hop
    coarse_t = np.arange(n_frames + 1) * frame_period
    coarse_f0 = f0.copy()
    coarse_vuv = (coarse_f0 != 0.0).astype(np.float64)
    coarse_f0 = np.append(coarse_f0, 2 * coarse_f0[-1] - coarse_f0[-2])
    coarse_vuv = np.append(coarse_vuv, 2 * coarse_vuv[-1] - coarse_vuv[-2])
    time_axis = np.arange(y_length) / fs
    interp_f0 = np.interp(time_axis, coarse_t, coarse_f0)
    interp_vuv = (np.interp(time_axis, coarse_t, coarse_vuv) > 0.5)
    interp_f0 = np.where(~interp_vuv, DEFAULT_F0, interp_f0)

    total_phase = np.cumsum(2.0 * np.pi * interp_f0 / fs)
    wrap_phase = np.fmod(total_phase, 2.0 * np.pi)
    wrap_diff = np.abs(np.diff(wrap_phase))
    pulse_idx = np.nonzero(wrap_diff > np.pi)[0]
    if pulse_idx.size == 0:
        z = np.zeros(0)
        return pulse_idx, z, z.astype(np.int64), z, z
    y1 = wrap_phase[pulse_idx] - 2.0 * np.pi
    y2 = wrap_phase[pulse_idx + 1]
    time_shift = (-y1 / (y2 - y1)) / fs
    noise_size = np.diff(pulse_idx, append=pulse_idx[-1])
    frame_pos = (pulse_idx / fs) / frame_period
    vuv = interp_vuv[pulse_idx].astype(np.float64)
    return pulse_idx, time_shift, noise_size, frame_pos, vuv


def _min_phase(log_amp: torch.Tensor, fft_size: int) -> torch.Tensor:
    """Minimum-phase spectrum from half log-amplitudes (irfft, causal fold, rfft, exp)."""
    cep = torch.fft.irfft(log_amp, n=fft_size, dim=1)
    scale = torch.ones(fft_size, device=log_amp.device)
    scale[1: fft_size // 2] = 2.0
    scale[fft_size // 2 + 1:] = 0.0
    return torch.exp(torch.fft.rfft(cep * scale, dim=1))


@no_tf32()
def synthesis_responses_device(sp: torch.Tensor, ap: torch.Tensor, pulse_idx: torch.Tensor,
                               time_shift: torch.Tensor, noise_size: torch.Tensor,
                               frame_pos: torch.Tensor, vuv: torch.Tensor, valid: torch.Tensor,
                               noise: torch.Tensor, *, fft_size: int, fs: int,
                               y_pad_length: int) -> torch.Tensor:
    """Per-pulse WORLD responses placed at their pulses (the response loop of
    synthesize_world). Pulse arrays are padded to a bucket, ``valid`` masks
    the padding; ``noise`` [P, fft_size] is the excitation (samples past a
    pulse's noise_size are ignored). Returns [y_pad_length] = y_length +
    2*fft_size, the signal starting at fft_size (the caller trims)."""
    n_bins = fft_size // 2 + 1
    dev = sp.device
    sp, ap = sp.float(), ap.float()

    # per-pulse envelope and aperiodic ratio (linear interpolation between frames)
    n = sp.shape[0]
    lo = torch.clamp(torch.floor(frame_pos).long(), max=n - 1)
    hi = torch.clamp(torch.ceil(frame_pos).long(), max=n - 1)
    frac = (frame_pos - lo.float())[:, None]
    env = torch.abs(sp[lo] * (1.0 - frac) + sp[hi] * frac)
    safe_ap = torch.clamp(ap, 0.001, 1.0 - 1e-12)
    ratio = (safe_ap[lo] * (1.0 - frac) + safe_ap[hi] * frac) ** 2

    # --- periodic response ---
    per_on = (vuv > 0.5) & (ratio[:, 0] <= 0.999) & valid
    spec = _min_phase(torch.log(env * (1.0 - ratio) + 1e-12) / 2.0, fft_size)
    coeff = 2.0 * np.pi * time_shift * fs / fft_size
    arg = coeff[:, None] * torch.arange(n_bins, device=dev)[None, :]
    re2, im2 = torch.cos(arg), torch.abs(torch.sin(arg))
    shifted = torch.complex(spec.real * re2 + spec.imag * im2, spec.imag * re2 - spec.real * im2)
    resp = torch.fft.fftshift(torch.fft.irfft(shifted, n=fft_size, dim=1), dim=1)
    dc = resp[:, fft_size // 2:].sum(dim=1, keepdim=True)
    i_half = np.arange(fft_size // 2)
    dc_half = 0.5 - 0.5 * np.cos(2.0 * np.pi * (i_half + 1.0) / (1.0 + fft_size))
    dc_rem = np.concatenate([dc_half, dc_half[::-1]])
    dc_rem = torch.from_numpy((dc_rem / dc_rem.sum()).astype(np.float32)).to(dev)[None, :]
    resp[:, : fft_size // 2] = 0.0
    resp = resp - dc * dc_rem
    periodic = torch.where(per_on[:, None], resp, 0.0)

    # --- aperiodic response ---
    offsets = torch.arange(fft_size, device=dev)[None, :]
    active = offsets < noise_size[:, None]
    noise = noise.float() * active
    mean = noise.sum(dim=1, keepdim=True) / torch.clamp(noise_size[:, None].float(), min=1.0)
    noise = (noise - mean) * active
    log_amp_a = torch.where(vuv[:, None] > 0.5, torch.log(env * ratio + 1e-30) / 2.0,
                            torch.log(env + 1e-30) / 2.0)
    spec_a = _min_phase(log_amp_a, fft_size)
    aperiodic = torch.fft.fftshift(
        torch.fft.irfft(spec_a * torch.fft.rfft(noise, dim=1), n=fft_size, dim=1), dim=1)

    response = periodic * torch.sqrt(noise_size.float())[:, None] + aperiodic
    response = torch.where(valid[:, None], response, 0.0)

    # --- placement at the pulses ---
    start = pulse_idx - fft_size // 2 + 1 + fft_size
    return segment_sum((start[:, None] + offsets).reshape(-1), response.reshape(-1), y_pad_length)


def segment_sum(index: torch.Tensor, values: torch.Tensor, length: int) -> torch.Tensor:
    """y[i] = the sum of ``values`` at ``index`` == i, [length], in the same
    order on every run: on CUDA ``index_put_`` with ``accumulate=True``
    (it sorts the indices, then sums each run of equal ones), on the CPU
    ``bincount``'s sequential loop (the CPU's ``index_put_`` and CUDA's
    ``bincount`` add with threads or atomics in varying order)."""
    if index.is_cuda:
        y = torch.zeros(length, dtype=values.dtype, device=values.device)
        return y.index_put_((index,), values, accumulate=True)
    return torch.bincount(index, weights=values, minlength=length)


def _bucket(n: int, quantum: int) -> int:
    """n rounded up to a multiple of ``quantum``, at least one quantum."""
    return max(quantum, -(-n // quantum) * quantum)


def _pulse_tensors(pulses, pb: int, dev):
    """The pulse arrays padded to ``pb`` on ``dev``, and the validity mask."""
    pulse_idx, time_shift, noise_size, frame_pos, vuv = pulses
    p = pulse_idx.size

    def pad(a, dtype):
        out = np.zeros(pb, dtype)
        out[:p] = a
        return torch.from_numpy(out).to(dev)

    valid = np.zeros(pb, bool)
    valid[:p] = True
    return (pad(pulse_idx, np.int64), pad(time_shift, np.float32), pad(noise_size, np.int64),
            pad(frame_pos, np.float32), pad(vuv, np.float32), torch.from_numpy(valid).to(dev))


def _pulse_noise(stream: torch.Tensor, pulse_idx: torch.Tensor, fft_size: int) -> torch.Tensor:
    """[P, fft_size] excitation: each pulse's samples from its own position
    in the stream (only the first noise_size of a row are used)."""
    idx = torch.clamp(pulse_idx[:, None] + torch.arange(fft_size, device=stream.device),
                      max=stream.shape[0] - 1)
    return stream[idx]


def _noise_stream(n: int, generator: torch.Generator, dev) -> torch.Tensor:
    return torch.randn(n, generator=generator).to(dev)


def synthesize_world_device(f0: np.ndarray, spectrogram, aperiodicity, fs: int, hop: int, *,
                            seed: int = 0, device=None,
                            noise: torch.Tensor | None = None) -> torch.Tensor:
    """Twin of :func:`diffsinger_tpu_torch.dsp.world.synthesize_world`: the
    host extracts the pulses (float64), pads them to a multiple of
    ``PULSE_QUANTUM``, and the device computes every response and places it.
    ``spectrogram`` and ``aperiodicity`` are tensors (the synthesis runs on
    their device) or arrays (sent to ``device``). ``noise`` [P padded,
    fft_size] is the excitation; else a stream of standard normals from a CPU
    generator seeded ``seed``. Returns [F*hop] float32 on that device."""
    f0 = np.asarray(f0, np.float64)
    sp = as_signal(spectrogram, device)
    ap = as_signal(aperiodicity, sp.device)
    n_frames, n_bins = sp.shape
    fft_size = 2 * (n_bins - 1)
    y_length = n_frames * hop
    lowest_f0 = fs / fft_size + 1.0
    pulses = extract_pulses(np.where(f0 < lowest_f0, 0.0, f0), fs, hop)
    if pulses[0].size == 0:
        return torch.zeros(y_length, device=sp.device)
    pb = _bucket(pulses[0].size, PULSE_QUANTUM)
    tensors = _pulse_tensors(pulses, pb, sp.device)
    if noise is None:
        stream = _noise_stream(y_length + fft_size, torch.Generator().manual_seed(seed), sp.device)
        noise = _pulse_noise(stream, tensors[0], fft_size)
    y = synthesis_responses_device(sp, ap, *tensors, noise.to(sp.device), fft_size=fft_size,
                                   fs=fs, y_pad_length=y_length + 2 * fft_size)
    return y[fft_size: fft_size + y_length]


# ---------------------------------------------------------------------------
# the whole split
# ---------------------------------------------------------------------------


@no_tf32()
def _decompose_program(x, f0, pulses, x_noise, noise_h, noise_a, *, fs, fft_size, hop):
    """CheapTrick, D4C and both ap-weighted syntheses on the device, over
    the padded waveform with the reference's 1e-5 anti-NaN dither
    (decomposed_waveform.py:92-99). Both syntheses share the pulse train (it
    depends on f0 only)."""
    x = x + x_noise * 1e-5
    env = cheaptrick(x, f0, fs=fs, fft_size=fft_size, hop=hop)
    ap = d4c_device(x, f0, fs=fs, fft_size=fft_size, hop=hop)
    y_pad_length = f0.shape[0] * hop + 2 * fft_size
    harmonic = synthesis_responses_device(
        torch.clamp(env * (1.0 - ap ** 2), min=1e-16), torch.zeros_like(ap), *pulses, noise_h,
        fft_size=fft_size, fs=fs, y_pad_length=y_pad_length)
    aperiodic = synthesis_responses_device(
        env * ap ** 2, torch.ones_like(ap), *pulses, noise_a,
        fft_size=fft_size, fs=fs, y_pad_length=y_pad_length)
    return harmonic, aperiodic


def world_harmonic_aperiodic_device(waveform, f0: np.ndarray, *, fs: int, fft_size: int,
                                    hop: int, device=None,
                                    generator: torch.Generator | None = None, noise=None):
    """Twin of :func:`diffsinger_tpu_torch.dsp.world.world_harmonic_aperiodic`:
    CheapTrick + D4C and the two ap-weighted syntheses (reference
    utils/decomposed_waveform.py:195-230) on the waveform's device, frame
    and pulse counts padded to buckets. The host's work is the float64 pulse
    extraction.

    ``waveform``: a tensor or an array (sent to ``device``); ``f0``
    [frames] on the host. ``noise``: (dither [frames padded * hop +
    fft_size], harmonic excitation [P padded, fft_size], aperiodic excitation
    [P padded, fft_size]), else drawn from ``generator`` (a CPU generator,
    seeded 0 unless given) as three streams. Returns (harmonic, aperiodic),
    float32 [L] on the waveform's device."""
    x = as_signal(waveform, device)
    dev = x.device
    length = x.shape[0]
    n_frames = int(np.ceil((length + 1) / hop))
    f0 = np.asarray(f0, np.float32)
    if len(f0) < n_frames:
        f0 = np.pad(f0, (0, n_frames - len(f0)), mode="edge")
    f0 = f0[:n_frames]
    fb = _bucket(n_frames, FRAME_QUANTUM)
    f0_b = np.zeros(fb, np.float32)
    f0_b[:n_frames] = f0

    x_pad = F.pad(x.float(), (0, fb * hop + fft_size - length))

    lowest_f0 = fs / fft_size + 1.0
    pulses = extract_pulses(np.where(f0 < lowest_f0, 0.0, f0.astype(np.float64)), fs, hop)
    if pulses[0].size == 0:
        return torch.zeros(length, device=dev), torch.zeros(length, device=dev)
    pb = _bucket(pulses[0].size, PULSE_QUANTUM)
    tensors = _pulse_tensors(pulses, pb, dev)
    if noise is None:
        g = generator if generator is not None else torch.Generator().manual_seed(0)
        n_stream = fb * hop + fft_size
        x_noise = _noise_stream(n_stream, g, dev)
        noise = (x_noise, *(_pulse_noise(_noise_stream(n_stream, g, dev), tensors[0], fft_size)
                            for _ in range(2)))
    x_noise, noise_h, noise_a = (n.to(dev) for n in noise)
    parts = _decompose_program(x_pad, torch.from_numpy(f0_b).to(dev), tensors, x_noise, noise_h,
                               noise_a, fs=fs, fft_size=fft_size, hop=hop)

    def fit(w):
        w = w[fft_size: fft_size + length]
        return F.pad(w, (0, length - w.shape[0]))

    return tuple(fit(w) for w in parts)
