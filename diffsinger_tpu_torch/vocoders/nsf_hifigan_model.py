"""NSF-HiFiGAN generator, full-NSF and mini-NSF source, canonical layout
(counterpart of diffsinger_tpu/vocoders/nsf_hifigan_model.py with fold_lanes=0).

The public layout is the JAX package's: mel [B, T, M] (natural-log mel),
f0 [B, T] Hz -> wav [B, T * hop]. Inside, the convolutions run in torch's
[B, C, L] layout with stock ops. Attribute names follow the reference
generator's ``state_dict`` with weight norm already fused (``conv_pre``,
``ups.{i}``, ``noise_convs.{i}`` and ``m_source.l_linear`` or ``source_conv``,
``resblocks.{j}.convs1.{m}``, ``conv_post``). Both sine sources keep their
phase in float32 with the remainder rebasing.

The full-NSF source and ``noise_sigma`` draw random numbers. Every draw comes
from a ``torch.Generator`` the caller passes, or is replaced by a tensor the
caller injects (:class:`VocoderNoise`), so that two implementations can be fed
the same numbers. The TPU lane-folded layout (``vocoders/folding.py`` and the
``dense`` source forms) has no use on the GPU and is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsinger_tpu_torch.utils import no_tf32, resolve_device

LRELU_SLOPE = 0.1


@dataclasses.dataclass(frozen=True)
class NsfHifiGanConfig:
    """The part of the vocoder's config.json the generator needs."""

    num_mels: int = 128
    sampling_rate: int = 44100
    upsample_rates: Sequence[int] = (8, 8, 2, 2, 2)
    upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4, 4)
    upsample_initial_channel: int = 512
    resblock: str = "1"
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5), (1, 3, 5), (1, 3, 5))
    mini_nsf: bool = False
    noise_sigma: float = 0.0

    @classmethod
    def from_json(cls, d: dict) -> "NsfHifiGanConfig":
        """From a parsed config.json: unknown keys are dropped, lists become tuples."""
        fields = {f.name for f in dataclasses.fields(cls)}
        d = {k: (tuple(map(tuple, v)) if k == "resblock_dilation_sizes" else
                 tuple(v) if isinstance(v, list) else v)
             for k, v in d.items() if k in fields}
        return cls(**d)

    @property
    def hop_size(self) -> int:
        return int(np.prod(self.upsample_rates))


@dataclasses.dataclass
class VocoderNoise:
    """Tensors that replace the generator's draws, in the JAX package's layouts.

    ``rand_ini`` [1, 1, 9] uniform initial phases (the fundamental's entry is
    zeroed by the source), ``source`` [B, T * hop, 9] standard normal, both for
    the full-NSF source; ``sigma`` [B, T, C] standard normal added after
    ``conv_pre`` when ``noise_sigma`` > 0.
    """

    rand_ini: Optional[torch.Tensor] = None
    source: Optional[torch.Tensor] = None
    sigma: Optional[torch.Tensor] = None


def sine_source_full(f0: torch.Tensor, upp: int, sampling_rate: int, harmonic_num: int = 8, *,
                     generator: Optional[torch.Generator] = None,
                     rand_ini: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None, sine_amp: float = 0.1,
                     noise_std: float = 0.003, voiced_threshold: float = 0.0) -> torch.Tensor:
    """Full-NSF source: a bank of ``harmonic_num + 1`` sines with per-frame phase
    continuation, voiced/unvoiced gating and noise.

    f0 [B, F] at frame rate -> [B, F * upp, dim] float32. ``rand_ini``
    [1, 1, dim] and ``noise`` [B, F * upp, dim] replace the draws from
    ``generator`` (uniform, then standard normal, in that order). The phase
    increments are rebased into [-0.5, 0.5) and the running phase into [0, 1).
    """
    b, frames = f0.shape
    dim = harmonic_num + 1
    dev = f0.device
    f0 = f0.float()[:, :, None]  # [B, F, 1]
    n = torch.arange(1, upp + 1, dtype=torch.float32, device=dev)
    rad = f0 / sampling_rate * n  # [B, F, upp]
    rad2 = torch.remainder(rad[..., -1:] + 0.5, 1.0) - 0.5
    rad_acc = torch.remainder(torch.cumsum(rad2, dim=1), 1.0)
    rad = rad + F.pad(rad_acc[:, :-1, :], (0, 0, 1, 0))
    if rand_ini is None:
        rand_ini = torch.rand((1, 1, dim), generator=generator, dtype=torch.float32, device=dev)
    rand_ini = rand_ini.to(device=dev, dtype=torch.float32).clone()
    rand_ini[..., 0] = 0.0
    harmonics = torch.arange(1, dim + 1, dtype=torch.float32, device=dev)
    rad = rad.reshape(b, -1, 1) * harmonics + rand_ini  # [B, L, dim]
    sines = torch.sin(2 * np.pi * rad) * sine_amp
    uv = (f0 > voiced_threshold).float().repeat_interleave(upp, dim=1)  # [B, L, 1]
    if noise is None:
        noise = torch.randn(sines.shape, generator=generator, dtype=torch.float32, device=dev)
    noise_amp = uv * noise_std + (1 - uv) * sine_amp / 3
    return sines * uv + noise_amp * noise.to(device=dev, dtype=torch.float32)


def fast_sine_gen(f0: torch.Tensor, upp: int, source_sr: float) -> torch.Tensor:
    """mini-NSF single-sine source with quadratic phase interpolation.

    f0 [B, F] at frame rate -> [B, F * upp] float32. The per-frame phase
    increments are rebased into [-0.5, 0.5) and the running phase into [0, 1)
    before the sine, so float32 keeps its precision over long phrases.
    """
    s0 = f0.float()[:, :, None] / source_sr  # [B, F, 1]
    ds0 = F.pad(s0[:, 1:, :] - s0[:, :-1, :], (0, 0, 0, 1))
    n = torch.arange(1, upp + 1, dtype=torch.float32, device=f0.device)
    rad = s0 * n + 0.5 * ds0 * n * (n - 1) / upp
    rad2 = torch.remainder(rad[..., -1:] + 0.5, 1.0) - 0.5
    rad_acc = torch.remainder(torch.cumsum(rad2, dim=1), 1.0)
    rad = rad + F.pad(rad_acc[:, :-1, :], (0, 0, 1, 0))
    return torch.sin(2 * np.pi * rad).reshape(f0.shape[0], -1)


class ResBlock1(nn.Module):
    """3x (leaky relu -> dilated conv -> leaky relu -> conv) + residual."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: Sequence[int] = (1, 3, 5)):
        super().__init__()
        self.convs1 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=(kernel_size - 1) * d // 2) for d in dilation
        ])
        self.convs2 = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, padding=(kernel_size - 1) // 2)
            for _ in dilation
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, L]
        for c1, c2 in zip(self.convs1, self.convs2):
            xt = c2(F.leaky_relu(c1(F.leaky_relu(x, LRELU_SLOPE)), LRELU_SLOPE))
            x = xt + x
        return x


class ResBlock2(nn.Module):
    """2x (leaky relu -> dilated conv) + residual."""

    def __init__(self, channels: int, kernel_size: int = 3, dilation: Sequence[int] = (1, 3)):
        super().__init__()
        self.convs = nn.ModuleList([
            nn.Conv1d(channels, channels, kernel_size, dilation=d,
                      padding=(kernel_size - 1) * d // 2) for d in dilation
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [B, C, L]
        for c in self.convs:
            x = c(F.leaky_relu(x, LRELU_SLOPE)) + x
        return x


class SourceModule(nn.Module):
    """Merges the harmonics of the full-NSF source into one excitation signal
    (``m_source`` in the reference generator): Linear(dim -> 1), tanh. Kept in
    float32 whatever the generator's dtype, like the source itself."""

    def __init__(self, harmonic_num: int = 8):
        super().__init__()
        self.l_linear = nn.Linear(harmonic_num + 1, 1)

    def forward(self, sine_wavs: torch.Tensor) -> torch.Tensor:  # [B, L, dim] -> [B, L, 1]
        return torch.tanh(self.l_linear(sine_wavs))


class Generator(nn.Module):
    """NSF-HiFiGAN generator: mel [B, T, M], f0 [B, T] -> wav [B, T * hop].

    Built in ``dtype`` (float32 or bfloat16) on ``device``: the card unless
    the caller asks for another, and an error if there is no card.
    """

    def __init__(self, config: NsfHifiGanConfig, dtype=None, device=None):
        super().__init__()
        device = resolve_device(device)
        h = config
        self.config = h
        self.num_kernels = len(h.resblock_kernel_sizes)
        n_ups = len(h.upsample_rates)
        if h.mini_nsf:
            self.upp = int(np.prod(h.upsample_rates[:2]))
            self.source_sr = h.sampling_rate / int(np.prod(h.upsample_rates[2:]))
        else:
            self.upp = h.hop_size
            self.m_source = SourceModule(harmonic_num=8)
            self.noise_convs = nn.ModuleList()
        self.conv_pre = nn.Conv1d(h.num_mels, h.upsample_initial_channel, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        resblock_cls = ResBlock1 if h.resblock == "1" else ResBlock2
        ch = h.upsample_initial_channel
        for i, (u, k) in enumerate(zip(h.upsample_rates, h.upsample_kernel_sizes)):
            ch //= 2
            self.ups.append(nn.ConvTranspose1d(ch * 2, ch, k, stride=u, padding=(k - u) // 2))
            if h.mini_nsf:
                if i == 1:
                    self.source_conv = nn.Conv1d(1, ch, 1)
            elif i + 1 < n_ups:
                stride_f0 = int(np.prod(h.upsample_rates[i + 1:]))
                self.noise_convs.append(nn.Conv1d(1, ch, stride_f0 * 2, stride=stride_f0,
                                                  padding=stride_f0 // 2))
            else:
                self.noise_convs.append(nn.Conv1d(1, ch, 1))
            for rk, rd in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes):
                self.resblocks.append(resblock_cls(ch, rk, tuple(rd)))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)
        self.to(device=device, dtype=dtype or torch.float32)
        if not h.mini_nsf:
            self.m_source.float()

    @no_tf32()
    def forward(self, mel: torch.Tensor, f0: torch.Tensor, *,
                generator: Optional[torch.Generator] = None,
                noise: Optional[VocoderNoise] = None) -> torch.Tensor:
        """``generator`` feeds the draws of the full-NSF source and of
        ``noise_sigma``; the tensors of ``noise`` replace them one by one. A
        draw that has neither raises."""
        h = self.config
        dtype = self.conv_pre.weight.dtype
        noise = noise or VocoderNoise()
        if h.mini_nsf:
            source = fast_sine_gen(f0, self.upp, self.source_sr)[:, None, :]  # [B, 1, T * upp]
        else:
            if generator is None and (noise.rand_ini is None or noise.source is None):
                raise ValueError("the full-NSF source draws random numbers: pass a "
                                 "torch.Generator or inject rand_ini and source noise")
            sine_wavs = sine_source_full(f0, self.upp, h.sampling_rate, harmonic_num=8,
                                         generator=generator, rand_ini=noise.rand_ini,
                                         noise=noise.source)
            source = self.m_source(sine_wavs).transpose(1, 2)  # [B, 1, T * hop]
        source = source.to(dtype)
        x = self.conv_pre(mel.to(dtype).transpose(1, 2))  # [B, C, T]
        if h.noise_sigma:
            eps = noise.sigma  # [B, T, C], the public layout
            if eps is None:
                if generator is None:
                    raise ValueError("noise_sigma > 0 draws random numbers: pass a "
                                     "torch.Generator or inject the sigma noise")
                eps = torch.randn((x.shape[0], x.shape[2], x.shape[1]), generator=generator,
                                  dtype=torch.float32, device=x.device)
            x = x + h.noise_sigma * eps.to(device=x.device, dtype=dtype).transpose(1, 2)
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            if not h.mini_nsf:
                x = x + self.noise_convs[i](source)[:, :, :x.shape[-1]]
            elif i == 1:
                x = x + self.source_conv(source)[:, :, :x.shape[-1]]
            blocks = self.resblocks[i * self.num_kernels:(i + 1) * self.num_kernels]
            xs = None
            for block in blocks:
                y = block(x)
                xs = y if xs is None else xs + y
            x = xs / self.num_kernels
        x = self.conv_post(F.leaky_relu(x, 0.01))  # final slope: torch's default
        return torch.tanh(x)[:, 0, :]
