"""Denoiser backbone registry (counterpart of diffsinger_tpu/models/backbones/__init__.py)."""

from __future__ import annotations

import torch
import torch.nn as nn

from diffsinger_tpu_torch.utils import filter_kwargs

from .lynxnet import LYNXNet, pointwise_conv
from .wavenet import WaveNet

BACKBONES = {"wavenet": WaveNet, "lynxnet": LYNXNet}


def build_backbone(out_dims: int, num_feats: int, backbone_type: str, backbone_args: dict, *,
                   cond_dims: int, remat=False):
    """``remat`` is ``recompute_grads``: see ``models.commons.resolve_remat_policy``."""
    cls = BACKBONES[backbone_type]
    kwargs = filter_kwargs(dict(backbone_args or {}), cls)
    kwargs.setdefault("remat", remat)
    return cls(in_dims=out_dims, n_feats=num_feats, cond_dims=cond_dims, **kwargs)


def precompute_cond_projections(denoiser: nn.Module, cond: torch.Tensor) -> torch.Tensor:
    """Hoist the per-layer conditioner projections out of the sampler loop.

    The condition is the same at every sampler step, so the L projections are
    computed once here and fed back through ``cond_proj`` instead of L times
    per step. cond [B, T, H] -> [L, B, T, C_out] (LYNXNet: C; WaveNet: 2C).
    Inference only: the forward_infers call it under ``torch.no_grad``; the
    training forward projects the condition in each layer, under autograd.
    """
    cond = cond.to(denoiser.input_projection.weight.dtype)
    return torch.stack([pointwise_conv(layer.conditioner_projection, cond)
                        for layer in denoiser.residual_layers])


__all__ = ["BACKBONES", "build_backbone", "precompute_cond_projections", "LYNXNet", "WaveNet"]
