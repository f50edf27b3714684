"""WORLD-family analysis and synthesis (counterpart of diffsinger_tpu/dsp/world.py),
the native replacement for pyworld in the reference's ``world`` harmonic split
(utils/decomposed_waveform.py:107-230).

* :func:`cheaptrick`: the CheapTrick spectral envelope (Morise 2015) on a
  tensor's device in float32: pitch-adaptive Hanning windows of three
  periods, DC correction, a box smoothing of width 2/3 f0 over the power
  spectrum, and cepstral liftering (the sinc smoothing lifter and the q1
  recovery lifter).
* :func:`synthesize_world`: WORLD's exact pulse-synchronous synthesis
  (synthesis.cpp) in float64 numpy on the host, with :func:`_minimum_phase_spectrum`,
  :func:`_dc_remover` and :func:`_interp_frames`: the goldens, copied as they
  are, with the aperiodicity of :mod:`diffsinger_tpu_torch.dsp.d4c`.
* :func:`world_harmonic_aperiodic`: the split. ``host`` runs the goldens
  (CheapTrick in float32 on the CPU, D4C and both syntheses in float64);
  ``device`` runs the float32 twin of :mod:`diffsinger_tpu_torch.dsp.world_device`
  on the waveform's device.

* :func:`estimate_aperiodicity` (a spectral-floor aperiodicity) and
  :func:`synthesize` (an overlap-add synthesis): the JAX module's fast
  alternatives, in float32 on the tensors' device. No code of either
  package calls them.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.nn.functional as F

from diffsinger_tpu_torch.dsp.common import as_signal
from diffsinger_tpu_torch.utils import no_tf32

DEFAULT_F0 = 500.0  # unvoiced frames analyze with this f0 (pyworld convention)

# Bumped whenever analysis/synthesis behavior changes (recorded into binarized
# .meta provenance); the JAX package's value, so both write the same string.
ALGO_VERSION = 2


def frames_by_blocks(x: torch.Tensor, n_frames: int, hop: int, start: int, width: int,
                     pad_mode: str = "constant") -> torch.Tensor:
    """``frames[f] = x[f*hop + start : f*hop + start + width]`` [n_frames,
    width], samples outside x per ``pad_mode``: zeros ("constant") or the edge
    sample ("edge", pyworld's clamped indexing). A strided view of the padded
    signal (the JAX package assembles it from hop blocks to avoid TPU gathers)."""
    pad_left = max(0, -start)
    pad_right = max(0, (n_frames - 1) * hop + start + width - x.shape[0])
    if pad_mode == "edge":
        xp = F.pad(x[None, None], (pad_left, pad_right), mode="replicate")[0, 0]
    elif pad_mode == "constant":
        xp = F.pad(x, (pad_left, pad_right))
    else:
        raise ValueError(f"unknown pad_mode {pad_mode!r}")
    return xp[start + pad_left:].unfold(0, width, hop)[:n_frames]


def box_smooth(ext: torch.Tensor, weights: torch.Tensor, o_min: int, n_out: int) -> torch.Tensor:
    """sum_k weights[:, k] * ext[:, o_min + k : o_min + k + n_out]: a
    per-frame correlation, one multiply-add a tap, in the JAX package's order.
    The sum stays local (no cumulative sum), so float32 rounding stays
    relative to the local magnitude of a spectrum spanning many decades."""
    acc = torch.zeros(ext.shape[0], n_out, dtype=ext.dtype, device=ext.device)
    for k in range(weights.shape[1]):
        acc.addcmul_(weights[:, k:k + 1], ext[:, o_min + k:o_min + k + n_out])
    return acc


def trapezoid_weights(shift: torch.Tensor, frac: torch.Tensor, wbins: torch.Tensor,
                      o_min: int, o_max: int) -> torch.Tensor:
    """The box integral's cell weights [F, o_max - o_min + 1] at absolute
    offsets o: w = clip(lo_r + wbins, 0, 1) - clip(lo_r, 0, 1) with
    lo_r = frac - (o - shift) + 1; zero outside each frame's window."""
    o = torch.arange(o_min, o_max + 1, device=shift.device)
    j = (o[None, :] - shift[:, None]).to(frac.dtype)
    lo_r = frac[:, None] - j + 1.0
    return torch.clamp(lo_r + wbins[:, None], 0.0, 1.0) - torch.clamp(lo_r, 0.0, 1.0)


@no_tf32()
def cheaptrick(x: torch.Tensor, f0: torch.Tensor, *, fs: int, fft_size: int,
               hop: int) -> torch.Tensor:
    """Spectral envelope per frame.

    :param x: [L] float32 waveform
    :param f0: [F] per-frame f0 (0 = unvoiced -> DEFAULT_F0), on x's device
    :return: [F, fft_size//2+1] power spectral envelope
    """
    n_frames = f0.shape[0]
    n_bins = fft_size // 2 + 1
    dev = x.device
    f0 = torch.where(f0 <= 0, DEFAULT_F0, f0)
    f0 = torch.clamp(f0, fs * 3.0 / (fft_size - 3.0), 800.0)

    # 1. pitch-adaptive windowing: a Hanning window spanning 3 periods (1.5
    #    each side), masked over a fixed fft_size-long slice
    offsets = torch.arange(fft_size, device=dev) - fft_size // 2
    frames = frames_by_blocks(x, n_frames, hop, -(fft_size // 2), fft_size)
    half_win = 1.5 * fs / f0  # in samples
    t = offsets[None, :] / half_win[:, None]
    window = torch.where(t.abs() < 1.0, 0.5 + 0.5 * torch.cos(np.pi * t), 0.0)
    frames = frames * window
    # weighted-mean removal (WORLD GetWindowedWaveform)
    weight = frames.sum(dim=1, keepdim=True) / (window.sum(dim=1, keepdim=True) + 1e-12)
    frames = frames - window * weight
    frames = frames / torch.sqrt((window * window).sum(dim=1, keepdim=True) + 1e-12)

    power = torch.fft.rfft(frames, n=fft_size, dim=1).abs() ** 2  # [F, bins]
    # DC correction (WORLD DCCorrection): mirror the spectrum below f0 onto
    # the sub-f0 bins; f0 <= 800 keeps both within the first columns
    bin_hz = fs / fft_size
    head = min(n_bins - 1, int(800.0 / bin_hz) + 2)
    freqs_h = torch.arange(head, device=dev) * bin_hz
    mirror_f = f0[:, None] - freqs_h[None, :]
    q = mirror_f / bin_hz
    qf = torch.clamp(torch.floor(q).long(), 0, head - 1)
    qfrac = q - qf
    p_head = power[:, : head + 1]
    mirrored = torch.gather(p_head, 1, qf) * (1 - qfrac) + torch.gather(p_head, 1, qf + 1) * qfrac
    add = torch.where((mirror_f > 0) & (freqs_h[None, :] < f0[:, None]), mirrored, 0.0)
    power = torch.cat([power[:, :head] + add, power[:, head:]], dim=1)

    # 2. frequency-domain smoothing by a rectangular window of width 2/3 f0:
    # the box integral as a local sum of cells with trapezoid end weights
    width_bins = (2.0 / 3.0) * f0 / bin_hz  # [F]
    w_max = (2.0 / 3.0) * 800.0 / bin_hz
    ext_l = int(np.ceil(w_max / 2.0)) + 2
    k_max = int(np.ceil(w_max)) + 2
    ext = F.pad(power, (ext_l, k_max + 2))
    t = ext_l - width_bins / 2.0
    shift = torch.floor(t).long()
    tfrac = t - torch.floor(t)
    o_min = int(np.floor(ext_l - w_max / 2.0)) + 1
    o_max = ext_l - 1 + k_max
    acc = box_smooth(ext, trapezoid_weights(shift, tfrac, width_bins, o_min, o_max), o_min, n_bins)
    pos = torch.arange(n_bins, dtype=torch.float32, device=dev)[None, :]
    den = torch.clamp(pos + width_bins[:, None] / 2, 1, n_bins) - \
        torch.clamp(pos - width_bins[:, None] / 2, 0, n_bins - 1)
    smoothed = acc / torch.clamp(den, min=1e-6)
    # relative floor (-80 dB under the frame's peak) against Gibbs in the liftering
    smoothed = torch.maximum(smoothed, smoothed.amax(dim=1, keepdim=True) * 1e-8 + 1e-20)

    # 3. cepstral liftering: sinc(f0 tau) smoothing and the recovery lifter
    #    (1 + 2 q1) - 2 q1 cos(2 pi tau f0), q1 = -0.15. The log spectrum is
    #    real and even, so its cepstrum is irfft's and back is rfft's.
    q1 = -0.15
    ceps = torch.fft.irfft(torch.log(smoothed), n=fft_size, dim=1)
    tau_idx = torch.arange(fft_size, device=dev)
    tau_idx = torch.minimum(tau_idx, fft_size - tau_idx)
    tau = tau_idx.float()[None, :] / fs
    arg = np.pi * f0[:, None] * tau
    smoothing_lifter = torch.where(arg < 1e-6, 1.0, torch.sin(arg) / torch.clamp(arg, min=1e-6))
    recovery_lifter = (1.0 + 2.0 * q1) - 2.0 * q1 * torch.cos(2.0 * arg)
    log_env = torch.fft.rfft(ceps * smoothing_lifter * recovery_lifter, dim=1).real
    return torch.exp(log_env)


@no_tf32()
def estimate_aperiodicity(x: torch.Tensor, f0: torch.Tensor, *, fs: int, fft_size: int,
                          hop: int) -> torch.Tensor:
    """Per-frame, per-bin aperiodicity in [0, 1]: the square root of the
    ratio of the inter-harmonic floor to the harmonic peaks of a Blackman-
    windowed power spectrum, each a masked mean over a band of about 2 f0.
    x [L], f0 [F] (0 = unvoiced, whose frames get 1) -> [F, fft_size//2+1],
    on x's device in float32. A fast heuristic beside D4C; no path calls it."""
    n_frames = f0.shape[0]
    n_bins = fft_size // 2 + 1
    dev = x.device
    voiced = f0 > 0
    f0_eff = torch.where(voiced, f0, torch.full_like(f0, DEFAULT_F0))
    # frames centred on f * hop, zeros beyond the signal (indices clamped to
    # the padded signal, as a JAX gather clamps them)
    xp = F.pad(x, (fft_size, fft_size))
    idx = (torch.arange(n_frames, device=dev)[:, None] * hop
           + torch.arange(fft_size, device=dev)[None, :] - fft_size // 2 + fft_size)
    frames = xp[idx.clamp(0, xp.shape[0] - 1)]
    window = torch.from_numpy(np.blackman(fft_size).astype(np.float32)).to(dev)
    power = torch.fft.rfft(frames * window, dim=1).abs() ** 2 + 1e-12

    bin_hz = fs / fft_size
    # distance of each bin from the nearest harmonic in units of f0
    ratio = (torch.arange(n_bins, device=dev)[None, :] * bin_hz) / f0_eff[:, None]
    frac = torch.abs(ratio - torch.round(ratio))  # 0 at harmonics, 0.5 between
    width = torch.clamp((2.0 * f0_eff / bin_hz).to(torch.int32), min=4).long()[:, None]
    pos = torch.arange(n_bins, device=dev)[None, :]
    lo = torch.clamp(pos - width, 0, n_bins)
    hi = torch.clamp(pos + width, 0, n_bins)

    def band_stat(mask):  # the masked mean of the power over [pos - width, pos + width)
        w = mask.to(power.dtype)
        csum_p = torch.cumsum(F.pad(power * w, (1, 0)), dim=1)
        csum_w = torch.cumsum(F.pad(w, (1, 0)), dim=1)
        num = csum_p.gather(1, hi) - csum_p.gather(1, lo)
        den = csum_w.gather(1, hi) - csum_w.gather(1, lo)
        return num / torch.clamp(den, min=1.0)

    peak_env = band_stat(frac < 0.15)
    floor_env = band_stat(frac > 0.35)
    ap = torch.sqrt(torch.clamp(floor_env / torch.clamp(peak_env, min=1e-12), 0.0, 1.0))
    return torch.where(voiced[:, None], ap, torch.ones_like(ap))


def pulse_excitation(f0: torch.Tensor, *, fs: int, hop: int) -> torch.Tensor:
    """The periodic excitation of :func:`synthesize`, f0 [F] -> [F * hop]: a
    pulse where the phase (a cumulative sum of f0 / fs) passes an integer,
    scaled to about unit power a period, silent in unvoiced frames. The JAX
    package sums in float32; where the phase lands within rounding of an
    integer, the order of such a sum decides the sample, so the port sums in
    float64 and its pulses fall where the exact phase puts them."""
    voiced = f0 > 0
    f0_up = torch.repeat_interleave(torch.where(voiced, f0, torch.full_like(f0, DEFAULT_F0)), hop)
    phase = torch.cumsum(f0_up.double() / fs, dim=0)
    previous = torch.cat([torch.zeros(1, dtype=phase.dtype, device=f0.device), phase[:-1]])
    pulse = (torch.floor(phase) - torch.floor(previous)) > 0
    return (pulse.float() * torch.sqrt(torch.clamp(fs / f0_up, min=1.0))
            * torch.repeat_interleave(voiced, hop))


@no_tf32()
def synthesize(f0: torch.Tensor, envelope: torch.Tensor, aperiodicity: torch.Tensor, *,
               fs: int, fft_size: int, hop: int, noise: torch.Tensor | None = None,
               generator: torch.Generator | None = None) -> torch.Tensor:
    """Overlap-add synthesis from (f0 [F], envelope [F, bins], aperiodicity
    [F, bins]) -> [F * hop], on f0's device in float32: the pulse train of
    :func:`pulse_excitation` and normal noise (``noise`` [F * hop], else
    drawn from ``generator``), each filtered in the STFT domain by the
    envelope's square root and weighted per bin by sqrt(1 - ap^2) (pulses)
    and ap (noise), then overlap-added. An approximation of WORLD's synthesis
    (``synthesize_world`` is the exact one); no path calls it."""
    from diffsinger_tpu_torch.dsp.stft import istft, stft_complex

    periodic = pulse_excitation(f0, fs=fs, hop=hop)
    if noise is None:
        noise = torch.randn(periodic.shape, generator=generator, device=f0.device)
    window = torch.from_numpy(np.hanning(fft_size + 1)[:-1].astype(np.float32)).to(f0.device)
    stft = dict(n_fft=fft_size, hop=hop, win_size=fft_size, window=window, center=True)
    amp = torch.sqrt(envelope)
    per_w = torch.sqrt(torch.clamp(1.0 - aperiodicity ** 2, 0.0, 1.0))
    spec_p = stft_complex(periodic[None], **stft)
    spec_n = stft_complex(noise[None], **stft)
    fcount = spec_p.shape[1]

    def fit(a):  # rows cut or zero-padded to the STFT's frames
        a = a[:fcount]
        return F.pad(a, (0, 0, 0, fcount - a.shape[0]))

    spec = (spec_p * (fit(amp) * fit(per_w))[None]
            + spec_n * (fit(amp) * fit(aperiodicity))[None])
    return istft(spec, length=periodic.shape[0], **stft)[0]


# ---------------------------------------------------------------------------
# WORLD-exact synthesis (pyworld.synthesize replacement; synthesis.cpp),
# float64 numpy: copied from the JAX package as it is
# ---------------------------------------------------------------------------

_SAFE_GUARD = 1e-12


def _minimum_phase_spectrum(log_amp_half: np.ndarray, fft_size: int) -> np.ndarray:
    """Minimum-phase complex spectrum from half log-amplitudes [P, bins].

    WORLD GetMinimumPhaseSpectrum (common.cpp): mirror the log spectrum,
    cepstrum via inverse FFT, causal fold (double positive quefrencies, zero
    negatives, keep bins 0 and N/2), exponentiate the forward FFT.
    """
    # the mirrored log spectrum is real-even, so its cepstrum is real: use the
    # half-spectrum real FFTs (irfft/rfft), identical output
    cep = np.fft.irfft(log_amp_half, n=fft_size, axis=1)
    cep[:, 1: fft_size // 2] *= 2.0
    cep[:, fft_size // 2 + 1:] = 0.0
    return np.exp(np.fft.rfft(cep, axis=1))


def _dc_remover(fft_size: int) -> np.ndarray:
    """WORLD GetDCRemover: unit-sum symmetric raised-cosine window."""
    i = np.arange(fft_size // 2)
    half = 0.5 - 0.5 * np.cos(2.0 * np.pi * (i + 1.0) / (1.0 + fft_size))
    w = np.concatenate([half, half[::-1]])
    return w / w.sum()


def _interp_frames(values: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """Per-pulse linear interpolation between frames (GetSpectralEnvelope):
    values [F, bins] sampled at fractional frame positions pos [P]."""
    n = values.shape[0]
    lo = np.minimum(np.floor(pos).astype(np.int64), n - 1)
    hi = np.minimum(np.ceil(pos).astype(np.int64), n - 1)
    frac = (pos - lo)[:, None]
    return values[lo] * (1.0 - frac) + values[hi] * frac


def synthesize_world(
    f0: np.ndarray,
    spectrogram: np.ndarray,
    aperiodicity: np.ndarray,
    fs: int,
    hop: int,
    *,
    seed: int = 0,
) -> np.ndarray:
    """WORLD Synthesis (synthesis.cpp), the pyworld.synthesize contract.

    :param f0: [F] per-frame f0 in Hz (0 = unvoiced)
    :param spectrogram: [F, fft_size//2+1] power spectral envelope
    :param aperiodicity: [F, fft_size//2+1] band aperiodicity in (0, 1]
    :param hop: frame period in samples (frame_period = hop/fs seconds)
    :return: [F*hop] float64 waveform

    Gaussian noise comes from numpy's generator rather than WORLD's xorshift
    randn, so noise realizations differ bit-for-bit; everything else follows
    the C++ structure (time base, pulse extraction, per-pulse responses).
    """
    f0 = np.asarray(f0, np.float64)
    sp = np.asarray(spectrogram, np.float64)
    ap = np.asarray(aperiodicity, np.float64)
    n_frames, n_bins = sp.shape
    fft_size = 2 * (n_bins - 1)
    frame_period = hop / fs
    y_length = n_frames * hop
    rng = np.random.default_rng(seed)

    # --- time base (GetTemporalParametersForTimeBase + GetTimeBase) ---
    lowest_f0 = fs / fft_size + 1.0
    coarse_t = np.arange(n_frames + 1) * frame_period
    coarse_f0 = np.where(f0 < lowest_f0, 0.0, f0)
    coarse_vuv = (coarse_f0 != 0.0).astype(np.float64)
    coarse_f0 = np.append(coarse_f0, 2 * coarse_f0[-1] - coarse_f0[-2])
    coarse_vuv = np.append(coarse_vuv, 2 * coarse_vuv[-1] - coarse_vuv[-2])
    time_axis = np.arange(y_length) / fs
    interp_f0 = np.interp(time_axis, coarse_t, coarse_f0)
    interp_vuv = (np.interp(time_axis, coarse_t, coarse_vuv) > 0.5).astype(np.float64)
    interp_f0 = np.where(interp_vuv == 0.0, DEFAULT_F0, interp_f0)

    # --- pulse locations from phase wrapping (GetPulseLocationsForTimeBase) ---
    total_phase = np.cumsum(2.0 * np.pi * interp_f0 / fs)
    wrap_phase = np.fmod(total_phase, 2.0 * np.pi)
    wrap_diff = np.abs(np.diff(wrap_phase))
    pulse_idx = np.nonzero(wrap_diff > np.pi)[0]  # pulse at sample i
    if pulse_idx.size == 0:
        return np.zeros(y_length)
    y1 = wrap_phase[pulse_idx] - 2.0 * np.pi
    y2 = wrap_phase[pulse_idx + 1]
    time_shift = (-y1 / (y2 - y1)) / fs  # seconds, in [0, 1/fs)
    n_pulses = pulse_idx.size
    # inter-pulse distance; the last pulse gets 0 and contributes nothing
    noise_size = np.diff(pulse_idx, append=pulse_idx[-1])

    # --- per-pulse envelope / aperiodicity (GetSpectralEnvelope/AperiodicRatio)
    frame_pos = (pulse_idx / fs) / frame_period
    env = np.abs(_interp_frames(sp, frame_pos))
    safe_ap = np.clip(ap, 0.001, 0.999999999999)
    ratio = _interp_frames(safe_ap, frame_pos) ** 2
    vuv = interp_vuv[pulse_idx]

    # --- periodic response (GetPeriodicResponse) ---
    periodic = np.zeros((n_pulses, fft_size))
    per_on = (vuv > 0.5) & (ratio[:, 0] <= 0.999)
    if per_on.any():
        log_amp = np.log(env[per_on] * (1.0 - ratio[per_on]) + _SAFE_GUARD) / 2.0
        spec = _minimum_phase_spectrum(log_amp, fft_size)
        # fractional time delay as linear phase; WORLD uses |sin| for the
        # imaginary part (GetSpectrumWithFractionalTimeShift's sqrt(1-cos^2))
        coeff = 2.0 * np.pi * time_shift[per_on] * fs / fft_size
        arg = coeff[:, None] * np.arange(n_bins)[None, :]
        re2, im2 = np.cos(arg), np.abs(np.sin(arg))
        shifted = (spec.real * re2 + spec.imag * im2) + 1j * (
            spec.imag * re2 - spec.real * im2)
        resp = np.fft.fftshift(np.fft.irfft(shifted, n=fft_size, axis=1), axes=1)
        # RemoveDCComponent: the first (acausal-wrap) half is replaced by the
        # DC-removal window, the second half has it subtracted
        dc = resp[:, fft_size // 2:].sum(axis=1, keepdims=True)
        rem = _dc_remover(fft_size)[None, :]
        resp[:, : fft_size // 2] = 0.0
        resp -= dc * rem
        periodic[per_on] = resp

    # --- aperiodic response (GetAperiodicResponse) ---
    offsets = np.arange(fft_size)[None, :]
    active = offsets < noise_size[:, None]
    noise = rng.standard_normal((n_pulses, fft_size)) * active
    mean = noise.sum(axis=1, keepdims=True) / np.maximum(noise_size[:, None], 1)
    noise = (noise - mean) * active
    log_amp_ap = np.where(vuv[:, None] != 0.0,
                          np.log(env * ratio) / 2.0, np.log(env) / 2.0)
    spec_ap = _minimum_phase_spectrum(log_amp_ap, fft_size)
    aperiodic = np.fft.fftshift(
        np.fft.irfft(spec_ap * np.fft.rfft(noise, axis=1), n=fft_size, axis=1),
        axes=1)

    response = periodic * np.sqrt(noise_size)[:, None] + aperiodic

    # --- scatter-add at pulse positions (Synthesis main loop) ---
    # np.bincount is ~20x faster than np.add.at for this dense scatter
    pad_len = y_length + 2 * fft_size
    offset = pulse_idx - fft_size // 2 + 1 + fft_size
    flat_idx = (offset[:, None] + offsets).ravel()
    y = np.bincount(flat_idx, weights=response.ravel(), minlength=pad_len)
    return y[fft_size: fft_size + y_length]


def resolve_world_backend(device, backend: str = "auto") -> str:
    """'auto' -> 'device' when ``device`` is a CUDA card, else 'host';
    DS_WORLD_BACKEND=host|device overrides. Binarizer workers resolve it the
    same way (they run on the card too), and binarizers record the resolved
    value."""
    if backend == "auto":
        backend = os.environ.get("DS_WORLD_BACKEND") or (
            "device" if torch.device(device).type == "cuda" else "host")
    if backend not in ("host", "device"):
        raise ValueError(f"unknown WORLD backend {backend!r}")
    return backend


def world_harmonic_aperiodic(waveform, f0: np.ndarray, *, fs: int, fft_size: int, hop: int,
                             backend: str = "auto", device=None,
                             generator: torch.Generator | None = None):
    """The reference's ``world`` split (decomposed_waveform.py:195-230):
    analyze (CheapTrick + D4C aperiodicity) and re-synthesize the harmonic
    part (envelope x (1 - ap^2), ap 0) and the aperiodic part (envelope x
    ap^2, ap 1) with WORLD's synthesis.

    ``waveform``: a tensor (the split runs for its device) or an array (sent
    to ``device``); ``f0`` [frames] on the host. ``backend``: 'host' = the
    float64 goldens (D4C, synthesis; CheapTrick in float32 on the CPU),
    'device' = the float32 twin on the waveform's device (``generator``: its
    noise, see :func:`world_harmonic_aperiodic_device`), 'auto' = see
    :func:`resolve_world_backend`. Returns (harmonic, aperiodic), float32
    tensors [L] on the waveform's device.
    """
    waveform = as_signal(waveform, device)
    backend = resolve_world_backend(waveform.device, backend)
    if backend == "device":
        from diffsinger_tpu_torch.dsp.world_device import world_harmonic_aperiodic_device

        return world_harmonic_aperiodic_device(waveform, f0, fs=fs, fft_size=fft_size, hop=hop,
                                               generator=generator)
    from diffsinger_tpu_torch.dsp.d4c import d4c

    length = waveform.shape[0]
    # the reference injects 1e-5 noise before WORLD analysis to dodge D4C's
    # band-limited-signal NaN edge case (decomposed_waveform.py:92-99)
    noise = np.random.default_rng(0).standard_normal(length) * 1e-5
    x64 = waveform.cpu().numpy().astype(np.float64) + noise
    n_frames = int(np.ceil((length + 1) / hop))
    f0 = np.asarray(f0, np.float32)
    if len(f0) < n_frames:
        f0 = np.pad(f0, (0, n_frames - len(f0)), mode="edge")
    f0 = f0[:n_frames]
    env = cheaptrick(torch.from_numpy(x64.astype(np.float32)), torch.from_numpy(f0),
                     fs=fs, fft_size=fft_size, hop=hop).numpy().astype(np.float64)
    positions = np.arange(n_frames) * (hop / fs)
    # D4C's float64 result through float32, as the JAX package carries it
    ap = d4c(x64, f0.astype(np.float64), positions, fs, fft_size).astype(np.float32).astype(np.float64)
    f0_np = f0.astype(np.float64)

    def fit(w):
        w = np.asarray(w[:length])
        if len(w) < length:
            w = np.pad(w, (0, length - len(w)))
        return torch.from_numpy(w.astype(np.float32)).to(waveform.device)

    # both parts are *synthesized*, mirroring the reference's two
    # pyworld.synthesize calls (subtraction would be phase-incoherent)
    harmonic = fit(synthesize_world(f0_np, np.clip(env * (1.0 - ap ** 2), 1e-16, None),
                                    np.zeros_like(ap), fs, hop, seed=0))
    aperiodic = fit(synthesize_world(f0_np, env * ap ** 2, np.ones_like(ap), fs, hop, seed=1))
    return harmonic, aperiodic
