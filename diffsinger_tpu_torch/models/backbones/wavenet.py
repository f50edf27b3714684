"""WaveNet denoiser backbone (counterpart of diffsinger_tpu/models/backbones/wavenet.py).

Residual blocks of a dilated gated conv (k=3, dilation 2^(i mod cycle)) with
the diffusion step and the condition added per block, and a skip sum.
Activations are channel-last [B, T, C]; the parameters carry the reference
torch names (``input_projection``, ``mlp.0``/``mlp.2``,
``residual_layers.{i}.{dilated_conv,diffusion_projection,
conditioner_projection,output_projection}``, ``skip_projection``,
``output_projection``). The JAX package computes the dilated conv outside any
Pallas kernel, so it is a stock ``F.conv1d`` here, except on the card
without autograd: there the residual blocks run on K4
(``ops/wavenet_block.py``), two kernels a block and the blocks' step
projections one product a step, and ``torch.export`` records them as the
operator ``ds::wavenet_stack``, so an exported program launches K4 too.
Training (a gradient wanted), ``torch.compile``, the CPU and other devices
take the stock ops. K4 picks its kernels by the dtype of x: a bfloat16
model's blocks run on the tensor cores, a float32 model's on the CUDA cores.
The counters ``wavenet.fused_blocks`` and ``wavenet.stock_blocks`` count the
blocks each way takes, ``wavenet.tc_blocks`` those of K4's blocks that take
the tensor cores, and ``wavenet.stack_frames`` the frames (B x T) of every
call on either; the span
``ds.wavenet.stack`` holds the residual blocks on either route
(``utils/tracing.py``). With ``remat``
(``recompute_grads``) each block is recomputed on the backward pass where
gradients are wanted (``models.commons.run_layer``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from diffsinger_tpu_torch.models.backbones.lynxnet import pointwise_conv
from diffsinger_tpu_torch.models.commons import resolve_remat_policy, run_layer, sinusoidal_pos_emb
from diffsinger_tpu_torch.ops import wavenet_block
from diffsinger_tpu_torch.utils import tracing


def mish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.tanh(F.softplus(x))


class ResidualBlock(nn.Module):
    def __init__(self, cond_dims: int, residual_channels: int, dilation: int):
        super().__init__()
        c = residual_channels
        self.dilation = dilation
        self.dilated_conv = nn.Conv1d(c, 2 * c, 3, padding=dilation, dilation=dilation)
        self.diffusion_projection = nn.Linear(c, c)
        self.conditioner_projection = nn.Conv1d(cond_dims, 2 * c, 1)
        self.output_projection = nn.Conv1d(c, 2 * c, 1)

    def forward(self, x: torch.Tensor, conditioner: torch.Tensor, diffusion_step: torch.Tensor,
                cond_proj: Optional[torch.Tensor] = None):
        """x [B, T, C]; conditioner [B, T, H]; diffusion_step [B, C]; cond_proj,
        the hoisted conditioner projection [B, T, 2C], replaces the projection.
        Returns (residual output [B, T, C], skip [B, T, C])."""
        if cond_proj is None:
            cond_proj = pointwise_conv(self.conditioner_projection, conditioner)
        return wavenet_block.wavenet_block_plain(
            x, self.diffusion_projection(diffusion_step), cond_proj, self.dilated_conv.weight,
            self.dilated_conv.bias, self.output_projection.weight, self.output_projection.bias,
            self.dilation)


class WaveNet(nn.Module):
    """Denoiser: spec [B, T, F*M] + step [B] + cond [B, T, H] -> [B, T, F*M]."""

    def __init__(self, in_dims: int, n_feats: int, cond_dims: int, num_layers: int = 20,
                 num_channels: int = 256, dilation_cycle_length: int = 4, remat=False):
        super().__init__()
        c = num_channels
        self.num_channels = c
        self.remat = resolve_remat_policy(remat)
        self.input_projection = nn.Conv1d(in_dims * n_feats, c, 1)
        nn.init.kaiming_normal_(self.input_projection.weight)
        # slot 1 of the reference's Sequential is the Mish: a placeholder here
        self.mlp = nn.ModuleList([nn.Linear(c, c * 4), nn.Identity(), nn.Linear(c * 4, c)])
        self.residual_layers = nn.ModuleList([
            ResidualBlock(cond_dims, c, 2 ** (i % dilation_cycle_length))
            for i in range(num_layers)
        ])
        self.skip_projection = nn.Conv1d(c, c, 1)
        nn.init.kaiming_normal_(self.skip_projection.weight)
        self.output_projection = nn.Conv1d(c, in_dims * n_feats, 1)
        nn.init.zeros_(self.output_projection.weight)

    def on_k4(self, x: torch.Tensor) -> bool:
        """Whether the residual blocks run on K4 for input x: while
        ``torch.export`` traces, or on the card where no gradient is wanted
        and ``torch.compile`` is not tracing. K4's wrapper raises on what its
        kernels do not take."""
        if torch.compiler.is_exporting():
            return True
        grad = torch.is_grad_enabled() and (x.requires_grad
                                            or any(p.requires_grad for p in self.parameters()))
        return x.is_cuda and not grad and not torch.compiler.is_compiling()

    def forward(self, spec: torch.Tensor, diffusion_step: torch.Tensor, cond: torch.Tensor,
                cond_proj: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``diffusion_step`` [B], int (DDPM) or float (reflow, fast solvers);
        ``cond_proj`` [L, B, T, 2C] holds the hoisted per-layer conditioner
        projections (see ``backbones.precompute_cond_projections``)."""
        dtype = self.input_projection.weight.dtype
        cond = cond.to(dtype)
        x = F.relu(pointwise_conv(self.input_projection, spec.to(dtype)))
        step = sinusoidal_pos_emb(diffusion_step, self.num_channels).to(dtype)
        step = self.mlp[2](mish(self.mlp[0](step)))
        layers = self.residual_layers
        if tracing.enabled() and not (torch.compiler.is_compiling()
                                      or torch.compiler.is_exporting()):
            tracing.add("wavenet.stack_frames", x.shape[0] * x.shape[1])
        with tracing.span("ds.wavenet.stack"):
            if self.on_k4(x):
                tracing.add("wavenet.fused_blocks", len(layers))
                if wavenet_block.on_tensor_cores(x):
                    tracing.add("wavenet.tc_blocks", len(layers))
                if cond_proj is None:
                    cond_proj = torch.stack([pointwise_conv(layer.conditioner_projection, cond)
                                             for layer in layers])
                stack = (wavenet_block.residual_stack_op if torch.compiler.is_exporting()
                         else wavenet_block.residual_stack)
                skip_sum = stack(
                    x, step, cond_proj, [layer.diffusion_projection.weight for layer in layers],
                    [layer.diffusion_projection.bias for layer in layers],
                    [layer.dilated_conv.weight for layer in layers],
                    [layer.dilated_conv.bias for layer in layers],
                    [layer.output_projection.weight for layer in layers],
                    [layer.output_projection.bias for layer in layers],
                    [layer.dilation for layer in layers])
            else:
                tracing.add("wavenet.stock_blocks", len(layers))
                skip_sum = torch.zeros_like(x)
                for i, layer in enumerate(layers):
                    x, skip = run_layer(layer, self.remat, x, cond, step,
                                        None if cond_proj is None else cond_proj[i])
                    skip_sum = skip_sum + skip
        x = skip_sum / math.sqrt(len(self.residual_layers))
        x = F.relu(pointwise_conv(self.skip_projection, x))
        return pointwise_conv(self.output_projection, x)
