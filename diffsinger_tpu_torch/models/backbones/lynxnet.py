"""LYNXNet denoiser backbone (counterpart of diffsinger_tpu/models/backbones/lynxnet.py).

Conformer-style residual layers: LayerNorm -> 1x1 conv to 2*inner -> SwiGLU
-> depthwise conv (k=31) -> PReLU (or SiLU, ReLU) -> 1x1 conv back, with the
condition and the diffusion step injected per layer. Channel-last throughout.
The conv module is K2 (``ops.lynx_fused``) with the activation in its
depthwise stage's epilogue, whichever the config names: its kernels on CUDA,
its plain version on the CPU; where gradients are wanted, K2's forward under
its autograd Function, whose backward runs stock ops. While
``torch.export`` traces it, the conv module is the custom op
``ds::fused_conv_module`` instead, so that the exported program launches K2.
With ``remat`` (``recompute_grads``) each residual layer is recomputed on the
backward pass where gradients are wanted (``models.commons.run_layer``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsinger_tpu_torch.models.commons import resolve_remat_policy, run_layer, sinusoidal_pos_emb
from diffsinger_tpu_torch.ops.lynx_fused import (
    PARAM_NAMES, conv_module_params_from_module, fused_conv_module, fused_conv_module_op,
    fused_conv_module_train)


def pointwise_conv(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 Conv1d on channel-last x [B, T, C_in] -> [B, T, C_out]."""
    return F.linear(x, conv.weight[:, :, 0], conv.bias)


class PReLU(nn.Module):
    """Per-channel PReLU (torch nn.PReLU(num_parameters=C), init 0.25); the
    slope is cast to the activation dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((features,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class LYNXConvModule(nn.Module):
    """``net`` indices follow the reference: 0 LayerNorm, 1 transpose, 2 pw conv
    C -> 2I, 3 SwiGLU, 4 depthwise conv, 5 the activation (``PReLU(I)``, or
    the parameter-free ``nn.SiLU()`` / ``nn.ReLU()``), 6 pw conv I -> C. The
    parameter-free slots are placeholders so the ``state_dict`` names match.
    The forward is one K2 call with the activation, then dropout (training
    mode)."""

    def __init__(self, dim: int, expansion_factor: int, kernel_size: int = 31,
                 activation: str = "PReLU", dropout: float = 0.0):
        super().__init__()
        inner = dim * expansion_factor
        acts = {"PReLU": lambda: PReLU(inner), "SiLU": nn.SiLU, "ReLU": nn.ReLU}
        if activation not in acts:
            raise ValueError(f"{activation} is not a valid activation")
        self.activation = activation
        self.net = nn.ModuleList([
            nn.LayerNorm(dim, eps=1e-5),
            nn.Identity(),
            nn.Conv1d(dim, inner * 2, 1),
            nn.Identity(),
            nn.Conv1d(inner, inner, kernel_size, groups=inner),
            acts[activation](),
            nn.Conv1d(inner, dim, 1),
        ])
        self.dropout = nn.Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        params = conv_module_params_from_module(self)
        act = self.activation
        if torch.compiler.is_exporting():  # one graph node, launched as K2 by the program
            return self.dropout(fused_conv_module_op(x, *(params[n] for n in PARAM_NAMES),
                                                     activation=act))
        if torch.is_grad_enabled() and (x.requires_grad
                                        or any(p.requires_grad for p in self.parameters())):
            return self.dropout(fused_conv_module_train(x, act, **params))
        return self.dropout(fused_conv_module(x, **params, activation=act))


class LYNXNetResidualLayer(nn.Module):
    def __init__(self, dim_cond: int, dim: int, expansion_factor: int, kernel_size: int = 31,
                 activation: str = "PReLU", dropout: float = 0.0,
                 front_cond_inject: bool = False):
        super().__init__()
        self.front_cond_inject = front_cond_inject
        self.diffusion_projection = nn.Conv1d(dim, dim, 1)
        self.conditioner_projection = nn.Conv1d(dim_cond, dim, 1)
        self.convmodule = LYNXConvModule(dim, expansion_factor, kernel_size, activation, dropout)

    def forward(self, x: torch.Tensor, conditioner: torch.Tensor, diffusion_step: torch.Tensor,
                cond_proj: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [B, T, C]; conditioner [B, T, H]; diffusion_step [B, C]; cond_proj,
        the hoisted conditioner projection [B, T, C], replaces the projection."""
        cond = cond_proj if cond_proj is not None else pointwise_conv(self.conditioner_projection, conditioner)
        if self.front_cond_inject:
            x = x + cond
            res_x = x
        else:
            res_x = x
            x = x + cond
        x = x + pointwise_conv(self.diffusion_projection, diffusion_step)[:, None, :]
        return self.convmodule(x) + res_x


class LYNXNet(nn.Module):
    """Denoiser: spec [B, T, F*M] + step [B] + cond [B, T, H] -> [B, T, F*M]."""

    def __init__(self, in_dims: int, n_feats: int, cond_dims: int, num_layers: int = 6,
                 num_channels: int = 512, expansion_factor: int = 2, kernel_size: int = 31,
                 activation: str = "PReLU", dropout_rate: float = 0.0,
                 strong_cond: bool = False, remat=False):
        super().__init__()
        c = num_channels
        self.num_channels = c
        self.strong_cond = strong_cond
        self.remat = resolve_remat_policy(remat)
        self.input_projection = nn.Conv1d(in_dims * n_feats, c, 1)
        nn.init.kaiming_normal_(self.input_projection.weight)
        # slots 0 and 2 of the reference's Sequential are the sinusoidal
        # embedding and the GELU: parameter-free placeholders here
        self.diffusion_embedding = nn.ModuleList([
            nn.Identity(), nn.Linear(c, c * 4), nn.Identity(), nn.Linear(c * 4, c),
        ])
        self.residual_layers = nn.ModuleList([
            LYNXNetResidualLayer(cond_dims, c, expansion_factor, kernel_size, activation,
                                 dropout_rate, front_cond_inject=strong_cond)
            for _ in range(num_layers)
        ])
        self.norm = nn.LayerNorm(c, eps=1e-5)
        self.output_projection = nn.Conv1d(c, in_dims * n_feats, 1)
        nn.init.zeros_(self.output_projection.weight)

    def forward(self, spec: torch.Tensor, diffusion_step: torch.Tensor, cond: torch.Tensor,
                cond_proj: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``cond_proj`` [L, B, T, C] holds the hoisted per-layer conditioner
        projections (see ``backbones.precompute_cond_projections``)."""
        dtype = self.input_projection.weight.dtype
        cond = cond.to(dtype)
        x = pointwise_conv(self.input_projection, spec.to(dtype))
        if not self.strong_cond:
            x = F.gelu(x)
        step = sinusoidal_pos_emb(diffusion_step, self.num_channels).to(dtype)
        emb = self.diffusion_embedding
        step = emb[3](F.gelu(emb[1](step)))
        for i, layer in enumerate(self.residual_layers):
            x = run_layer(layer, self.remat, x, cond, step,
                          None if cond_proj is None else cond_proj[i])
        return pointwise_conv(self.output_projection, self.norm(x))
