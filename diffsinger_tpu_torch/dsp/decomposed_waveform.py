"""Harmonic / aperiodic decomposition of a waveform (counterpart of
diffsinger_tpu/dsp/decomposed_waveform.py).

``comb``: the harmonic part keeps the complex STFT's bins within
``base_harmonic_radius`` bins of any multiple of the frame's f0 (the
reference's Nuttall-window band masking of one harmonic, applied at every
multiple at once), resynthesised by the iSTFT; the aperiodic part is the
waveform minus the harmonic part. The kth harmonic alone masks the harmonic
part around (k + 1) f0. Everything runs on the waveform's device.

``world``: WORLD's analysis (CheapTrick, D4C) and two re-syntheses
(:mod:`diffsinger_tpu_torch.dsp.world`): the float32 twin on the card when
the waveform is on one, the float64 host goldens on the CPU or when
DS_WORLD_BACKEND=host asks for them. ``vr``: the vocal-remover CascadedNet
(:mod:`diffsinger_tpu_torch.models.hnsep`) from ``hnsep_ckpt`` on the
waveform's device, the aperiodic part the waveform less the harmonic one;
without a checkpoint it falls back to ``comb`` with the JAX package's warning.
"""

from __future__ import annotations

import pathlib
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from diffsinger_tpu_torch.dsp.common import as_signal, interp_f0
from diffsinger_tpu_torch.dsp.stft import istft, nuttall_window, stft_complex


def _masked_resynth(waveform: torch.Tensor, f0_frames: torch.Tensor, mask_fn, *,
                    hop_size: int, win_size: int) -> torch.Tensor:
    """STFT of [L] (Nuttall window, center), bins kept where
    ``mask_fn(f0 [F, 1], bin index [1, K])`` holds, iSTFT back to [L].
    ``f0_frames`` may be longer or shorter than the STFT's frame count."""
    window = torch.from_numpy(nuttall_window(win_size)).to(waveform.device)
    spec = stft_complex(waveform[None], n_fft=win_size, hop=hop_size, win_size=win_size,
                        window=window, center=True)                     # [1, F, K]
    n_frames, n_specs = spec.shape[1], spec.shape[2]
    f0 = f0_frames[:n_frames]
    f0 = torch.nn.functional.pad(f0, (0, n_frames - f0.shape[0]))
    idx = torch.arange(n_specs, dtype=torch.float32, device=waveform.device)[None, :]
    spec = spec * mask_fn(f0[:, None], idx)[None]
    return istft(spec, n_fft=win_size, hop=hop_size, win_size=win_size, window=window,
                 center=True, length=waveform.shape[0])[0]


def _masked_band_resynth(waveform: torch.Tensor, f0_frames: torch.Tensor, *, hop_size: int,
                         win_size: int, samplerate: int,
                         half_width: float = 3.5) -> torch.Tensor:
    """Keep the bins within ``half_width`` bins of each frame's centre
    frequency ``f0_frames`` (Hz); frames whose centre is under one bin keep
    nothing."""
    def mask(f0, idx):
        center = f0 * win_size / samplerate
        start = torch.clamp(center - half_width, min=0)
        end = torch.clamp(center + half_width, max=idx.shape[1])
        return (center >= 1) & (idx >= start) & (idx < end)

    return _masked_resynth(waveform, f0_frames, mask, hop_size=hop_size, win_size=win_size)


def _comb_harmonic_resynth(waveform: torch.Tensor, f0_frames: torch.Tensor, *, hop_size: int,
                           win_size: int, samplerate: int, half_width: float = 3.5,
                           max_harmonics: int = 256) -> torch.Tensor:
    """The comb: keep the bins within ``half_width`` of any harmonic k f0
    (1 <= k <= ``max_harmonics``) of voiced frames.

    The distance to the harmonic is taken in float64, where k f0 is exact: a
    bin near the radius is then kept or dropped whether or not a compiler
    fuses the multiply and the subtraction (XLA does, eager torch does not)."""
    def mask(f0, idx):
        f0_bins = torch.clamp(f0 * (win_size / samplerate), min=1e-3)
        nearest_k = torch.clamp(torch.round(idx / f0_bins), 1, max_harmonics)
        dist = torch.abs(idx.double() - nearest_k.double() * f0_bins.double())
        return (f0 > 0) & (f0_bins >= 1) & (dist < half_width)

    return _masked_resynth(waveform, f0_frames, mask, hop_size=hop_size, win_size=win_size)


class DecomposedWaveform:
    """Decomposes a waveform into its harmonic and aperiodic parts and single
    harmonics on first use, and keeps them (the reference's interface). The
    parts are float32 tensors on the device of ``waveform`` (a tensor) or on
    ``device`` (an array: the card unless the caller names another)."""

    def __init__(
        self, waveform, samplerate: int, f0: np.ndarray,
        *, hop_size: int, fft_size: Optional[int] = None, win_size: Optional[int] = None,
        algorithm: str = "comb", base_harmonic_radius: float = 3.5,
        hnsep_ckpt: Optional[str] = None, device=None,
    ):
        if algorithm == "vr" and not (hnsep_ckpt is not None and pathlib.Path(hnsep_ckpt).exists()):
            warnings.warn(
                f"hnsep algorithm '{algorithm}' unavailable (missing checkpoint); "
                f"falling back to 'comb'."
            )
            algorithm = "comb"
        if algorithm not in ("comb", "world", "vr"):
            raise ValueError(f"unknown hnsep algorithm '{algorithm}'")
        self.algorithm = algorithm
        self._hnsep_ckpt = hnsep_ckpt
        self._waveform = as_signal(waveform, device)
        self._samplerate = samplerate
        self._f0 = np.asarray(f0, np.float32)
        self._hop_size = hop_size
        self._win_size = win_size if win_size is not None else fft_size
        self._fft_size = fft_size if fft_size is not None else win_size
        self._half_width = base_harmonic_radius
        self._harmonic_part: Optional[torch.Tensor] = None
        self._aperiodic_part: Optional[torch.Tensor] = None
        self._harmonics: Dict[int, torch.Tensor] = {}

    @property
    def samplerate(self):
        return self._samplerate

    @property
    def hop_size(self):
        return self._hop_size

    @property
    def fft_size(self):
        return self._fft_size

    @property
    def win_size(self):
        return self._win_size

    def _aligned_f0(self, multiplier: float = 1.0) -> torch.Tensor:
        """f0 times ``multiplier``, edge-padded to one frame a hop of the
        waveform and interpolated through unvoiced frames (host), on the
        waveform's device."""
        f0 = self._f0 * multiplier
        pad_size = int(len(self._waveform) // self._hop_size) - len(f0) + 1
        if pad_size > 0:
            f0 = np.pad(f0, (0, pad_size), mode="edge")
        f0, _ = interp_f0(f0, uv=f0 == 0)
        return torch.from_numpy(f0.astype(np.float32)).to(self._waveform.device)

    def _kth_harmonic(self, k: int) -> torch.Tensor:
        if k not in self._harmonics:
            self._harmonics[k] = _masked_band_resynth(
                self.harmonic(), self._aligned_f0(k + 1), hop_size=self._hop_size,
                win_size=self._win_size, samplerate=self._samplerate,
                half_width=self._half_width)
        return self._harmonics[k]

    def _decompose(self):
        n = len(self._waveform)
        if self.algorithm == "world":
            from diffsinger_tpu_torch.dsp.world import world_harmonic_aperiodic

            # zeros (unvoiced) kept, the frame axis padded with zeros
            n_frames = int(np.ceil((n + 1) / self._hop_size))
            f0 = np.zeros(n_frames, np.float32)
            f0[: min(n_frames, len(self._f0))] = self._f0[:n_frames]
            self._harmonic_part, self._aperiodic_part = world_harmonic_aperiodic(
                self._waveform, f0, fs=self._samplerate, fft_size=self._fft_size,
                hop=self._hop_size)
            return
        if self.algorithm == "vr":
            from diffsinger_tpu_torch.models.hnsep import predict_harmonic

            self._harmonic_part = predict_harmonic(self._hnsep_ckpt, self._waveform)
        else:
            voiced = np.repeat(self._f0 > 0, self._hop_size)[:n]
            voiced = np.pad(voiced, (0, n - len(voiced)), constant_values=False)
            harm = _comb_harmonic_resynth(
                self._waveform, self._aligned_f0(), hop_size=self._hop_size,
                win_size=self._win_size, samplerate=self._samplerate,
                half_width=self._half_width)
            self._harmonic_part = harm * torch.from_numpy(voiced).to(harm.device)
        self._aperiodic_part = self._waveform - self._harmonic_part

    def harmonic(self, k: Optional[int] = None) -> torch.Tensor:
        """The harmonic part, or with ``k`` its kth harmonic alone (0: the base)."""
        if k is not None:
            return self._kth_harmonic(k)
        if self._harmonic_part is None:
            self._decompose()
        return self._harmonic_part

    def aperiodic(self) -> torch.Tensor:
        if self._aperiodic_part is None:
            self._decompose()
        return self._aperiodic_part
