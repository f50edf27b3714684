"""ConvNeXt auxiliary decoder for shallow diffusion
(counterpart of diffsinger_tpu/models/aux_decoder.py).

Channel-last [B, T, C] at every forward; the convolutions transpose to torch's
[B, C, T] around ``F.conv1d``.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsinger_tpu_torch.utils import filter_kwargs


def _conv_tc(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """Apply a Conv1d to channel-last x [B, T, C]."""
    return conv(x.transpose(1, 2)).transpose(1, 2)


class ConvNeXtBlock(nn.Module):
    """Depthwise k=7 conv -> LN (eps 1e-6) -> Linear -> exact GELU -> Linear
    -> layer scale gamma (cast to the activation dtype) -> dropout (training
    mode) -> residual."""

    def __init__(self, dim: int, intermediate_dim: int, layer_scale_init_value: float = 1e-6,
                 dropout: float = 0.0):
        super().__init__()
        self.dwconv = nn.Conv1d(dim, dim, kernel_size=7, padding=3, groups=dim)
        self.norm = nn.LayerNorm(dim, eps=1e-6)
        self.pwconv1 = nn.Linear(dim, intermediate_dim)
        self.pwconv2 = nn.Linear(intermediate_dim, dim)
        self.gamma = (nn.Parameter(torch.full((dim,), layer_scale_init_value))
                      if layer_scale_init_value > 0 else None)
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        x = self.norm(_conv_tc(self.dwconv, x))
        x = self.pwconv2(F.gelu(self.pwconv1(x)))
        if self.gamma is not None:
            x = self.gamma.to(x.dtype) * x
        return residual + self.dropout(x)


class ConvNeXtDecoder(nn.Module):
    """[B, T, in_dims] -> [B, T, out_dims]."""

    def __init__(self, in_dims: int, out_dims: int, num_channels: int = 512,
                 num_layers: int = 6, kernel_size: int = 7, dropout_rate: float = 0.1):
        super().__init__()
        pad = (kernel_size - 1) // 2
        self.inconv = nn.Conv1d(in_dims, num_channels, kernel_size, padding=pad)
        self.conv = nn.ModuleList([
            ConvNeXtBlock(num_channels, num_channels * 4, dropout=dropout_rate)
            for _ in range(num_layers)
        ])
        self.outconv = nn.Conv1d(num_channels, out_dims, kernel_size, padding=pad)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = _conv_tc(self.inconv, x)
        for block in self.conv:
            x = block(x)
        return _conv_tc(self.outconv, x)


AUX_DECODERS = {"convnext": ConvNeXtDecoder}


class AuxDecoderAdaptor(nn.Module):
    """Spec-normalisation wrapper around the aux decoder: the decoder emits a
    normalised spec [B, T, M], which inference denormalises. The
    multi-feature layout of the variance family waits for that slice."""

    def __init__(self, in_dims: int, out_dims: int,
                 spec_min: Sequence[float], spec_max: Sequence[float],
                 aux_decoder_arch: str = "convnext", aux_decoder_args: dict = None):
        super().__init__()
        cls = AUX_DECODERS[aux_decoder_arch]
        kwargs = filter_kwargs(dict(aux_decoder_args or {}), cls)
        self.decoder = cls(in_dims=in_dims, out_dims=out_dims, **kwargs)
        smin = np.asarray(spec_min, dtype=np.float32).reshape(-1)[:out_dims]
        smax = np.asarray(spec_max, dtype=np.float32).reshape(-1)[:out_dims]
        # plain attributes, not buffers: they are not in the reference state_dict
        self._k = torch.from_numpy((smax - smin) / 2.0)
        self._b = torch.from_numpy((smax + smin) / 2.0)

    def denorm_spec(self, x: torch.Tensor) -> torch.Tensor:
        return x * self._k.to(x.device) + self._b.to(x.device)

    def forward(self, condition: torch.Tensor, infer: bool = False) -> torch.Tensor:
        x = self.decoder(condition)
        return self.denorm_spec(x) if infer else x
