"""Pitch extractors (counterpart of diffsinger_tpu/dsp/pe.py).

``parselmouth`` maps to the JAX package's own autocorrelation extractor
(Boersma 1993, Praat's 'ac' method): a window-corrected normalised
autocorrelation, parabolic (or, ``very_accurate``, windowed-sinc) peak
interpolation, the top 14 voiced candidates of each frame with Praat's octave
cost, an unvoiced candidate from the silence threshold, and a Viterbi path
with octave-jump and voiced/unvoiced costs.

The candidates and the transition costs are computed for all frames at once on
the signal's device; the path finder's forward pass, a max-plus recursion of
15 states per frame, runs on the host over those arrays, fetched once (a loop
of torch operations on the card would cost about eight launches a frame).

``harvest`` is the JAX package's native Harvest (float64 numpy on the host,
:mod:`diffsinger_tpu_torch.dsp.harvest`); ``rmvpe`` the neural extractor of
:mod:`diffsinger_tpu_torch.models.rmvpe`, on the binarizer's device.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.nn.functional as F

from diffsinger_tpu_torch.dsp.common import as_signal, interp_f0
from diffsinger_tpu_torch.dsp.stft import frame_signal
from diffsinger_tpu_torch.utils import no_tf32


class BasePE:
    def get_pitch(self, waveform, samplerate, length, *, hop_size, f0_min=65, f0_max=1100,
                  speed=1, interp_uv=False, device=None):
        raise NotImplementedError()

    def provenance(self) -> str:
        """The extractor's name, recorded in the binarized ``.meta``."""
        return type(self).__name__


NEG = -1e9  # "no candidate" (keeps inf - inf out of the recursion)


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


@no_tf32()
def acf_candidates(
    y: torch.Tensor, sr: float, *, win_size: int, hop: int, lag_min: int, lag_max: int,
    n_cands: int = 14, very_accurate: bool = False,
    voicing_threshold=0.45, silence_threshold=0.03, octave_cost=0.01,
):
    """The candidates of every frame of the padded signal y [L].

    ``very_accurate`` is Praat's accurate variant: a Gaussian window
    (exp(-12 (t/T - 1/2)^2), shifted to reach 0 at the edges; the caller
    doubles its length) and a windowed-sinc interpolation of the ACF around
    each peak in place of the parabola.

    Returns (strength, f0, voiced), each [F, S] with S = n_cands + 1; state
    S - 1 is the unvoiced candidate (f0 0). Scalars are float32, as in the
    JAX package's program.
    """
    dev = y.device
    sr_t, vt = _f32(sr, dev), _f32(voicing_threshold, dev)
    frames = frame_signal(y, win_size, hop)            # [F, W]
    local_peak = frames.abs().amax(dim=1)              # before the mean is removed, as Praat
    global_peak = torch.clamp(y.abs().max(), min=1e-9)
    frames = frames - frames.mean(dim=1, keepdim=True)
    t = np.arange(win_size) / max(win_size - 1, 1)
    if very_accurate:
        edge = np.exp(-12.0)
        window = (np.exp(-12.0 * (t - 0.5) ** 2) - edge) / (1.0 - edge)
    else:
        window = 0.5 - 0.5 * np.cos(2 * np.pi * t)
    window = torch.from_numpy(window.astype(np.float32)).to(dev)
    fw = frames * window

    n_fft = int(2 ** np.ceil(np.log2(2 * win_size)))
    spec = torch.fft.rfft(fw, n=n_fft, dim=1)
    acf = torch.fft.irfft(spec * spec.conj(), n=n_fft, dim=1)[:, : lag_max + 2]
    r = acf / torch.clamp(acf[:, :1], min=1e-12)
    wspec = torch.fft.rfft(window, n=n_fft)
    wacf = torch.fft.irfft(wspec * wspec.conj(), n=n_fft)[: lag_max + 2]
    wacf = wacf / torch.clamp(wacf[0], min=1e-12)
    r = r / torch.clamp(wacf[None, :], min=1e-3)        # Boersma's window correction

    lags = torch.arange(lag_max + 2, device=dev)
    valid = (lags >= lag_min) & (lags <= lag_max)
    # voiced candidates are local maxima of the corrected ACF
    is_peak = torch.zeros_like(r, dtype=torch.bool)
    is_peak[:, 1:-1] = (r[:, 1:-1] > r[:, :-2]) & (r[:, 1:-1] >= r[:, 2:])
    r_peaks = torch.where(valid[None, :] & is_peak, r, NEG)
    vals, idx = torch.topk(r_peaks, n_cands, dim=1)    # [F, K]
    has_cand = vals > NEG / 2

    # parabolic interpolation of the lag and the peak around each candidate
    rm1 = torch.gather(r, 1, torch.clamp(idx - 1, min=0))
    rp1 = torch.gather(r, 1, torch.clamp(idx + 1, max=lag_max + 1))
    rb = torch.gather(r, 1, idx)
    denom = rm1 - 2 * rb + rp1
    delta = torch.where(denom.abs() > 1e-9, 0.5 * (rm1 - rp1) / denom, 0.0)
    delta = torch.clamp(delta, -0.5, 0.5)
    lag_est = idx.float() + delta
    r_int = torch.clamp(rb + 0.5 * (rp1 - rm1) * delta + 0.5 * denom * delta * delta, -1.0, 1.5)

    if very_accurate:
        # windowed-sinc interpolation (Praat's sinc70 depth) on a fine lag
        # grid, then a parabola through the grid's best point
        depth = 35
        taps = torch.arange(-depth, depth + 1, device=dev)                       # [T]
        gi = torch.clamp(idx[:, :, None] + taps, 0, lag_max + 1)                  # [F, K, T]
        r_win = torch.gather(r, 1, gi.reshape(gi.shape[0], -1)).reshape(gi.shape)
        grid = torch.linspace(-0.7, 0.7, 29, device=dev)                          # [G]
        xg = grid[:, None] - taps[None, :].float()                                # [G, T]
        ws = torch.sinc(xg) * (0.5 + 0.5 * torch.cos(np.pi * xg / (depth + 1)))
        r_g = torch.einsum("fkt,gt->fkg", r_win, ws)                              # [F, K, G]
        bc = torch.clamp(r_g.argmax(dim=-1), 1, grid.shape[0] - 2)
        rbm = torch.gather(r_g, -1, (bc - 1)[..., None])[..., 0]
        rbb = torch.gather(r_g, -1, bc[..., None])[..., 0]
        rbp = torch.gather(r_g, -1, (bc + 1)[..., None])[..., 0]
        den2 = rbm - 2 * rbb + rbp
        sub = torch.where(den2.abs() > 1e-12, 0.5 * (rbm - rbp) / den2, 0.0)
        sub = torch.clamp(sub, -1.0, 1.0)
        lag_est = idx.float() + grid[bc] + sub * (grid[1] - grid[0])
        r_int = torch.clamp(rbb + 0.5 * (rbp - rbm) * sub + 0.5 * den2 * sub * sub, -1.0, 1.5)

    f0_v = sr_t / torch.clamp(lag_est, min=1e-6)
    # local strength R = r - OctaveCost * log2(MinimumPitch * tau)  (Boersma eq. 26)
    f0_min_hz = sr_t / lag_max
    strength_v = r_int - octave_cost * torch.log2(f0_min_hz * lag_est / sr_t)
    strength_v = torch.where(has_cand, strength_v, NEG)

    # unvoiced candidate: R = VT + max(0, 2 - intensity / (ST / (1 + VT)))
    intensity = local_peak / global_peak
    strength_uv = vt + torch.clamp(2.0 - intensity / (_f32(silence_threshold, dev) / (1.0 + vt)),
                                   min=0.0)
    strength = torch.cat([strength_v, strength_uv[:, None]], dim=1)
    f0 = torch.cat([torch.where(has_cand, f0_v, 1.0), torch.zeros_like(strength_uv)[:, None]], dim=1)
    voiced = torch.cat([has_cand, torch.zeros_like(has_cand[:, :1])], dim=1)
    return strength, f0, voiced


def transition_costs(f0: torch.Tensor, voiced: torch.Tensor, *, hop: int, sr: float,
                     octave_jump_cost=0.35, voiced_unvoiced_cost=0.14) -> torch.Tensor:
    """Cost of each move from frame t's state i to frame t+1's state j,
    [F - 1, S, S]: the octave-jump cost between two voiced states, the
    voiced/unvoiced cost between a voiced and an unvoiced one, 0 between two
    unvoiced ones. Praat calibrates both for a 10 ms step."""
    dev = f0.device
    step_corr = 0.01 / (hop / _f32(sr, dev))
    ojc = octave_jump_cost * step_corr
    vuc = voiced_unvoiced_cost * step_corr
    f = torch.where(voiced, f0, 1.0)
    both = voiced[:-1, :, None] & voiced[1:, None, :]
    either = voiced[:-1, :, None] ^ voiced[1:, None, :]
    jump = torch.abs(torch.log2(f[:-1, :, None] / f[1:, None, :]))
    zero = torch.zeros((), device=dev)
    return torch.where(both, ojc * jump, torch.where(either, vuc, zero))


def viterbi_path(strength: np.ndarray, cost: np.ndarray) -> np.ndarray:
    """The best path through [F, S] state strengths with [F - 1, S, S]
    transition costs, in float32: the forward pass keeps each frame's best
    predecessor, then the trace back. Ties go to the lower state, as in the
    JAX package's ``argmax``."""
    n_frames, n_states = strength.shape
    cols = np.arange(n_states)
    backptr = np.empty((max(n_frames - 1, 0), n_states), np.int64)
    delta = strength[0]
    for t in range(1, n_frames):
        total = delta[:, None] - cost[t - 1]
        best = total.argmax(axis=0)
        backptr[t - 1] = best
        delta = strength[t] + total[best, cols]
    path = np.empty(n_frames, np.int64)
    path[-1] = int(delta.argmax())
    for t in range(n_frames - 2, -1, -1):
        path[t] = backptr[t, path[t + 1]]
    return path


class AcfPE(BasePE):
    """Native autocorrelation pitch extractor (Praat-ac family).

    ``very_accurate``: Praat's accurate variant, a Gaussian window of twice
    the length and sinc interpolation of the ACF's peaks. ``seconds`` sums
    the time spent in the candidates (device work up to the fetch) and in the
    path (host).
    """

    def __init__(self, voicing_threshold: float = 0.45, very_accurate: bool = False):
        self.voicing_threshold = voicing_threshold
        self.very_accurate = very_accurate
        self.seconds = {"candidates": 0.0, "path": 0.0}

    def provenance(self) -> str:
        return f"native-acf-viterbi(very_accurate={self.very_accurate})"

    def get_pitch(self, waveform, samplerate, length, *, hop_size, f0_min=65, f0_max=1100,
                  speed=1, interp_uv=False, device=None):
        """f0 and uv, [length] each, of a waveform (a tensor, computed on its
        device, or an array sent to ``device``)."""
        t0 = time.perf_counter()
        hop = int(np.round(hop_size * speed))
        # a window of at least 2 periods of f0_min (4 for the Gaussian), a power of two
        periods = 4 if self.very_accurate else 2
        win = int(2 ** np.ceil(np.log2(periods * samplerate / f0_min)))
        pad = win // 2
        y = F.pad(as_signal(waveform, device), (pad, pad + hop))
        lag_min = max(2, int(samplerate / f0_max))
        lag_max = int(np.ceil(samplerate / f0_min))

        strength, f0_cand, voiced = acf_candidates(
            y, float(samplerate), win_size=win, hop=hop, lag_min=lag_min, lag_max=lag_max,
            very_accurate=self.very_accurate, voicing_threshold=self.voicing_threshold,
        )
        cost = transition_costs(f0_cand, voiced, hop=hop, sr=float(samplerate))
        strength, f0_cand, cost = (x.cpu().numpy() for x in (strength, f0_cand, cost))
        t1 = time.perf_counter()
        path = viterbi_path(strength, cost)
        self.seconds["candidates"] += t1 - t0
        self.seconds["path"] += time.perf_counter() - t1

        f0 = f0_cand[np.arange(len(path)), path].astype(np.float32)
        f0 = np.where((f0 >= f0_min) & (f0 <= f0_max), f0, 0.0)
        if len(f0) < length:
            f0 = np.pad(f0, (0, length - len(f0)))
        f0 = f0[:length]
        uv = f0 == 0
        if interp_uv:
            f0, uv = interp_f0(f0, uv)
        return f0, uv


class HarvestPE(BasePE):
    """Native Harvest (reference modules/pe/pw.py:7-29 contract: pw.harvest
    at frame_period = 1000*hop/sr, padded or cut to ``length``), in float64
    numpy on the host whatever the waveform's device."""

    def provenance(self) -> str:
        from diffsinger_tpu_torch.dsp.harvest import ALGO_VERSION

        return f"native-harvest-v{ALGO_VERSION}"

    def get_pitch(self, waveform, samplerate, length, *, hop_size, f0_min=65, f0_max=1100,
                  speed=1, interp_uv=False, device=None):
        from diffsinger_tpu_torch.dsp.harvest import harvest

        if isinstance(waveform, torch.Tensor):
            waveform = waveform.cpu().numpy()
        hop = int(np.round(hop_size * speed))
        f0, _ = harvest(np.asarray(waveform, np.float64), samplerate, f0_floor=f0_min,
                        f0_ceil=f0_max, frame_period=1000 * hop / samplerate)
        f0 = f0.astype(np.float32)
        if f0.size < length:
            f0 = np.pad(f0, (0, length - f0.size))
        f0 = f0[:length]
        uv = f0 == 0
        if interp_uv:
            f0, uv = interp_f0(f0, uv)
        return f0, uv


def initialize_pe(hparams: dict, device=None) -> BasePE:
    """The config's ``pe`` (reference modules/pe/__init__.py:8-18):
    'parselmouth' (the native ACF extractor), 'harvest', or 'rmvpe' (the
    checkpoint ``pe_ckpt`` on ``device``, the card unless the caller names
    another)."""
    name = hparams.get("pe", "parselmouth")
    if name == "parselmouth":
        return AcfPE(very_accurate=bool(hparams.get("pe_very_accurate", False)))
    if name == "harvest":
        return HarvestPE()
    if name == "rmvpe":
        from diffsinger_tpu_torch.models.rmvpe import RMVPE

        return RMVPE(hparams["pe_ckpt"], device=device)
    raise ValueError(f" [x] Unknown pitch extractor: {name}")
