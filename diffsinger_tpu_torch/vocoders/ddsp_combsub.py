"""pc-ddsp CombSub vocoder (counterpart of diffsinger_tpu/vocoders/ddsp_combsub.py).

mel [B, T, M] (log10) + f0 [B, T] -> wav [B, T * block_size]:

* ``Mel2Control``: Conv1d -> GroupNorm -> LeakyReLU -> Conv1d -> BiLSTM(128)
  -> LayerNorm -> Linear, split into harmonic magnitude, harmonic phase and
  noise magnitude control frames. The modules carry pc-ddsp's parameter
  names (``stack.0``, ``stack.1``, ``stack.3``, ``decoder``, ``norm``,
  ``dense_out``), so a bundle's state dict loads once its weight norm is
  folded (``vocoders/ddsp_convert.py``);
* the combtooth source ``sinc(sr * wrap(cumsum(f0 / sr)) / f0)`` on the f0
  upsampled with aligned corners, its phase summed in float64 and wrapped
  before it is rounded to float32, as the reference's pc-ddsp does;
* the STFT of the combtooth times the complex filter ``exp(mag + i pi
  phase)`` plus the STFT of uniform noise times ``exp(noise_mag) / 128``,
  then the iSTFT (``dsp/stft.py``).

Stock PyTorch ops on the mel's device; the JAX package has no kernel here.
The noise comes from an explicit ``torch.Generator`` or is injected.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsinger_tpu_torch.dsp.stft import istft, stft_complex


def upsample_align_corners(frames: torch.Tensor, factor: int) -> torch.Tensor:
    """pc-ddsp's frame -> sample upsampling: append the last frame, linearly
    interpolate to ``T * factor + 1`` samples with aligned corners, drop the
    final sample. frames [B, T] -> [B, T * factor]."""
    t = frames.shape[1]
    ext = torch.cat([frames, frames[:, -1:]], dim=1)  # [B, T+1]
    # aligned corners: output i samples input coordinate i * T / (T * factor)
    pos = torch.arange(t * factor + 1, dtype=torch.float32, device=frames.device) * (t / (t * factor))
    i0 = torch.clamp(torch.floor(pos).long(), 0, t - 1)
    w = pos - i0.float()
    out = ext[:, i0] * (1.0 - w) + ext[:, i0 + 1] * w
    return out[:, :-1]


def combtooth(f0_up: torch.Tensor, sr: int) -> torch.Tensor:
    """Combtooth excitation from per-sample f0 [B, L]: a sinc pulse train of
    period sr / f0. Its phase is a cumulative sum in float64, wrapped to
    [-0.5, 0.5], then cast to f0's dtype, as the reference's pc-ddsp computes
    it. The JAX package sums in float32 (a TPU has no float64): such a sum
    strays from the exact phase by an amount that grows with the length and
    depends on the order of the sum, so that two devices' pulses part by
    fractions of a sample over a phrase (``chip_smoke.py``'s ``[vocoders]``
    prints the drift on the card and on the CPU)."""
    phase = torch.cumsum(f0_up.double() / sr, dim=1)
    phase = (phase - torch.round(phase)).to(f0_up.dtype)
    return torch.sinc(sr * phase / (f0_up + 1e-3))


def to_bins(mags: torch.Tensor, n_bins: int) -> torch.Tensor:
    """Control bands [B, T, N] -> [B, T, n_bins] by linear interpolation with
    half-pixel centers on the last axis (``jax.image.resize``'s 'linear' when
    it upsamples); unchanged when N is already n_bins."""
    if mags.shape[-1] == n_bins:
        return mags
    b, t, n = mags.shape
    return F.interpolate(mags.reshape(b * t, 1, n), size=n_bins, mode="linear",
                         align_corners=False).reshape(b, t, n_bins)


def hanning(n: int) -> np.ndarray:
    """``np.hanning(n + 1)[:-1]``: the periodic window pc-ddsp's STFTs use."""
    return np.hanning(n + 1)[:-1].astype(np.float32)


class Mel2Control(nn.Module):
    """mel [B, T, M] -> dict of control frames (pc-ddsp's Mel2Control layout)."""

    def __init__(self, n_mels: int, n_mag_harmonic: int, n_mag_noise: int,
                 hidden: int = 64, lstm_hidden: int = 128):
        super().__init__()
        self.n_mag_harmonic = n_mag_harmonic
        self.stack = nn.Sequential(
            nn.Conv1d(n_mels, hidden, 3, padding=1),
            nn.GroupNorm(4, hidden, eps=1e-5),
            nn.LeakyReLU(0.01),
            nn.Conv1d(hidden, hidden, 3, padding=1),
        )
        self.decoder = nn.LSTM(hidden, lstm_hidden, batch_first=True, bidirectional=True)
        self.norm = nn.LayerNorm(2 * lstm_hidden, eps=1e-5)
        self.dense_out = nn.Linear(2 * lstm_hidden, 2 * n_mag_harmonic + n_mag_noise)

    def forward(self, mel: torch.Tensor) -> dict:
        x = self.stack(mel.transpose(1, 2)).transpose(1, 2)
        x, _ = self.decoder(x)
        e = self.dense_out(self.norm(x))
        n = self.n_mag_harmonic
        return {"harmonic_magnitude": e[..., :n], "harmonic_phase": e[..., n:2 * n],
                "noise_magnitude": e[..., 2 * n:]}


class CombSub(nn.Module):
    """pc-ddsp CombSub synthesis. mel [B, T, M] (log10), f0 [B, T] -> wav."""

    def __init__(self, sampling_rate: int, block_size: int, win_length: int,
                 n_mag_harmonic: int, n_mag_noise: int, n_mels: int):
        super().__init__()
        self.sampling_rate = sampling_rate
        self.block_size = block_size
        self.win_length = win_length
        self.mel2ctrl = Mel2Control(n_mels, n_mag_harmonic, n_mag_noise)
        self.register_buffer("window", torch.from_numpy(hanning(win_length)), persistent=False)

    def forward(self, mel: torch.Tensor, f0: torch.Tensor, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``noise`` [B, T * hop] uniform in [-1, 1] replaces the draw from
        ``generator``."""
        t = mel.shape[1]
        hop, win = self.block_size, self.win_length
        bins = win // 2 + 1
        src = combtooth(upsample_align_corners(f0, hop), self.sampling_rate)
        ctrls = self.mel2ctrl(mel)

        # the STFT (center=True) of T * hop samples has T + 1 frames: the
        # last control frame is repeated (pc-ddsp's convention)
        def frames(x):
            return to_bins(torch.cat([x, x[:, -1:, :]], dim=1), bins)

        src_filter = torch.exp(torch.complex(frames(ctrls["harmonic_magnitude"]),
                                             np.pi * frames(ctrls["harmonic_phase"])))
        noise_filter = torch.exp(frames(ctrls["noise_magnitude"])) / 128.0
        stft = dict(n_fft=win, hop=hop, win_size=win, window=self.window, center=True)
        src_stft = stft_complex(src, **stft)
        if noise is None:
            noise = torch.rand(src.shape, generator=generator, device=src.device) * 2 - 1
        noise_stft = stft_complex(noise, **stft)
        n_frames = src_stft.shape[1]
        sig_stft = (src_stft * src_filter[:, :n_frames]
                    + noise_stft * noise_filter[:, :n_frames])
        return istft(sig_stft, length=t * hop, **stft)
