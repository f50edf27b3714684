"""NSF-HiFiGAN generator, mini-NSF source, canonical layout
(counterpart of diffsinger_tpu/vocoders/nsf_hifigan_model.py with fold_lanes=0).

The public layout is the JAX package's: mel [B, T, M] (natural-log mel),
f0 [B, T] Hz -> wav [B, T * hop]. Inside, the convolutions run in torch's
[B, C, L] layout with stock ops. Attribute names follow the reference
generator's ``state_dict`` with weight norm already fused (``conv_pre``,
``ups.{i}``, ``source_conv``, ``resblocks.{j}.convs1.{m}``, ``conv_post``).
The mini-NSF sine source keeps its phase in float32 with the fmod rebasing.

Not ported yet: the full NSF source (``sine_source_full``), whose noise is
drawn inside the JAX function, and the TPU lane-folded layout
(``vocoders/folding.py``), which has no use on the GPU.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsinger_tpu_torch.utils import resolve_device

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

    @property
    def hop_size(self) -> int:
        return int(np.prod(self.upsample_rates))


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


class Generator(nn.Module):
    """NSF-HiFiGAN generator (mini-NSF source): mel [B, T, M], f0 [B, T] -> wav [B, T * hop].

    Built in ``dtype`` (float32 or bfloat16) on ``device``: the card unless
    the caller asks for another, and an error if there is no card.
    """

    def __init__(self, config: NsfHifiGanConfig, dtype=None, device=None):
        super().__init__()
        device = resolve_device(device)
        h = config
        if not h.mini_nsf:
            raise NotImplementedError("the full NSF source is not ported yet; use mini_nsf")
        self.config = h
        self.num_kernels = len(h.resblock_kernel_sizes)
        self.upp = int(np.prod(h.upsample_rates[:2]))
        self.source_sr = h.sampling_rate / int(np.prod(h.upsample_rates[2:]))
        self.conv_pre = nn.Conv1d(h.num_mels, h.upsample_initial_channel, 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        resblock_cls = ResBlock1 if h.resblock == "1" else ResBlock2
        ch = h.upsample_initial_channel
        for i, (u, k) in enumerate(zip(h.upsample_rates, h.upsample_kernel_sizes)):
            ch //= 2
            self.ups.append(nn.ConvTranspose1d(ch * 2, ch, k, stride=u, padding=(k - u) // 2))
            if i == 1:
                self.source_conv = nn.Conv1d(1, ch, 1)
            for rk, rd in zip(h.resblock_kernel_sizes, h.resblock_dilation_sizes):
                self.resblocks.append(resblock_cls(ch, rk, tuple(rd)))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)
        self.to(device=device, dtype=dtype or torch.float32)

    def forward(self, mel: torch.Tensor, f0: torch.Tensor) -> torch.Tensor:
        dtype = self.conv_pre.weight.dtype
        source = fast_sine_gen(f0, self.upp, self.source_sr)[:, None, :]  # [B, 1, T * upp]
        x = self.conv_pre(mel.to(dtype).transpose(1, 2))  # [B, C, T]
        for i, up in enumerate(self.ups):
            x = up(F.leaky_relu(x, LRELU_SLOPE))
            if i == 1:
                x = x + self.source_conv(source.to(dtype))[:, :, :x.shape[-1]]
            blocks = self.resblocks[i * self.num_kernels:(i + 1) * self.num_kernels]
            xs = None
            for block in blocks:
                y = block(x)
                xs = y if xs is None else xs + y
            x = xs / self.num_kernels
        x = self.conv_post(F.leaky_relu(x, 0.01))  # final slope: torch's default
        return torch.tanh(x)[:, 0, :]

