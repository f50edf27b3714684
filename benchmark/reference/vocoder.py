"""Plain reference of the full-NSF NSF-HiFiGAN generator: float32 PyTorch.

A frozen copy of the math of the port's ``vocoders/nsf_hifigan_model.py``
(``sine_source_full``, ``SourceModule``, ``Generator`` with ``ResBlock1``)
for the released 44.1 kHz layout: mel [B, T, M] (natural log), f0 [B, T] Hz
-> wav [B, T * hop]. The draws of the source (``rand_ini`` [1, 1, 9] and
``noise`` [B, T * hop, 9]) are arguments.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .common import Ops

SLOPE = 0.1


def sine_source(f0: torch.Tensor, upp: int, sr: int, rand_ini: torch.Tensor,
                noise: torch.Tensor) -> torch.Tensor:
    """Nine harmonics with per-frame phase continuation, voiced gating and noise."""
    b = f0.shape[0]
    dim = rand_ini.shape[-1]
    f0 = f0.float()[:, :, None]
    n = torch.arange(1, upp + 1, dtype=torch.float32, device=f0.device)
    rad = f0 / sr * n
    wrapped = torch.remainder(rad[..., -1:] + 0.5, 1.0) - 0.5
    acc = torch.remainder(torch.cumsum(wrapped, dim=1), 1.0)
    rad = rad + F.pad(acc[:, :-1, :], (0, 0, 1, 0))
    ini = rand_ini.float().clone()
    ini[..., 0] = 0.0
    rad = rad.reshape(b, -1, 1) * torch.arange(1, dim + 1, dtype=torch.float32,
                                                device=f0.device) + ini
    sines = torch.sin(2 * np.pi * rad) * 0.1
    uv = (f0 > 0).float().repeat_interleave(upp, dim=1)
    return sines * uv + (uv * 0.003 + (1 - uv) * 0.1 / 3) * noise.float()


class ResBlock(nn.Module):
    def __init__(self, ch: int, k: int, dilations):
        super().__init__()
        self.convs1 = nn.ModuleList([nn.Conv1d(ch, ch, k, dilation=d, padding=(k - 1) * d // 2)
                                     for d in dilations])
        self.convs2 = nn.ModuleList([nn.Conv1d(ch, ch, k, padding=(k - 1) // 2)
                                     for _ in dilations])

    def forward(self, ops: Ops, x):
        for c1, c2 in zip(self.convs1, self.convs2):
            y = ops.conv1d(F.leaky_relu(x, SLOPE), c1.weight, c1.bias, padding=c1.padding,
                           dilation=c1.dilation)
            x = x + ops.conv1d(F.leaky_relu(y, SLOPE), c2.weight, c2.bias, padding=c2.padding)
        return x


class Source(nn.Module):
    def __init__(self, harmonics: int):
        super().__init__()
        self.l_linear = nn.Linear(harmonics, 1)


class VocoderReference(nn.Module):
    """``forward(mel, f0, rand_ini, noise)`` -> wav [B, T * hop] in [-1, 1]."""

    def __init__(self, cfg: dict, lowp=None):
        super().__init__()
        if cfg.get("mini_nsf") or cfg.get("noise_sigma") or cfg.get("resblock", "1") != "1":
            raise ValueError("the reference covers the full-NSF ResBlock1 vocoder only")
        self.ops = Ops(lowp)
        self.cfg = cfg
        rates, kernels = cfg["upsample_rates"], cfg["upsample_kernel_sizes"]
        self.upp = math.prod(rates)
        self.m_source = Source(9)
        self.noise_convs = nn.ModuleList()
        self.conv_pre = nn.Conv1d(cfg["num_mels"], cfg["upsample_initial_channel"], 7, padding=3)
        self.ups = nn.ModuleList()
        self.resblocks = nn.ModuleList()
        ch = cfg["upsample_initial_channel"]
        for i, (u, k) in enumerate(zip(rates, kernels)):
            ch //= 2
            self.ups.append(nn.ConvTranspose1d(ch * 2, ch, k, stride=u, padding=(k - u) // 2))
            if i + 1 < len(rates):
                s = math.prod(rates[i + 1:])
                self.noise_convs.append(nn.Conv1d(1, ch, 2 * s, stride=s, padding=s // 2))
            else:
                self.noise_convs.append(nn.Conv1d(1, ch, 1))
            for rk, rd in zip(cfg["resblock_kernel_sizes"], cfg["resblock_dilation_sizes"]):
                self.resblocks.append(ResBlock(ch, rk, rd))
        self.conv_post = nn.Conv1d(ch, 1, 7, padding=3)

    @torch.no_grad()
    def forward(self, mel, f0, rand_ini, noise):
        with self.ops.backend():
            return self._forward(mel, f0, rand_ini, noise)

    def _forward(self, mel, f0, rand_ini, noise):
        ops = self.ops
        sines = sine_source(f0, self.upp, self.cfg["sampling_rate"], rand_ini, noise)
        lin = self.m_source.l_linear
        source = torch.tanh(F.linear(sines, lin.weight, lin.bias)).transpose(1, 2)
        x = ops.conv1d(mel.float().transpose(1, 2), self.conv_pre.weight, self.conv_pre.bias,
                       padding=3)
        n_k = len(self.cfg["resblock_kernel_sizes"])
        for i, up in enumerate(self.ups):
            x = ops.conv_transpose1d(F.leaky_relu(x, SLOPE), up.weight, up.bias,
                                     stride=up.stride, padding=up.padding)
            nc = self.noise_convs[i]
            x = x + ops.conv1d(source, nc.weight, nc.bias, stride=nc.stride,
                               padding=nc.padding)[:, :, :x.shape[-1]]
            x = sum(block(ops, x) for block in self.resblocks[i * n_k:(i + 1) * n_k]) / n_k
        x = ops.conv1d(F.leaky_relu(x, 0.01), self.conv_post.weight, self.conv_post.bias, padding=3)
        return torch.tanh(x)[:, 0, :]
