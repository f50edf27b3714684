"""Training losses (counterpart of diffsinger_tpu/models/losses.py) over flat
[B, T, D] tensors. Every input is taken to float32 first, so a bf16 forward
reduces its losses in float32. ``dur_loss`` comes with the variance model's
training.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


def _masked_mean(err: torch.Tensor, nonpadding: Optional[torch.Tensor]) -> torch.Tensor:
    """Mean over non-padded positions; ``nonpadding`` [B, T] float or None."""
    if nonpadding is None:
        return err.mean()
    mask = nonpadding[:, :, None].float()
    return (err * mask).sum() / torch.clamp(mask.sum() * err.shape[-1], min=1.0)


def _err(a: torch.Tensor, b: torch.Tensor, loss_type: str) -> torch.Tensor:
    if loss_type == "l1":
        return (a.float() - b.float()).abs()
    if loss_type == "l2":
        return (a.float() - b.float()).square()
    raise NotImplementedError(loss_type)


def diffusion_loss(x_recon: torch.Tensor, noise: torch.Tensor,
                   nonpadding: Optional[torch.Tensor] = None,
                   loss_type: str = "l2") -> torch.Tensor:
    """Epsilon-prediction loss."""
    return _masked_mean(_err(x_recon, noise, loss_type), nonpadding)


def reflow_loss(v_pred: torch.Tensor, v_gt: torch.Tensor, t: torch.Tensor,
                nonpadding: Optional[torch.Tensor] = None, loss_type: str = "l2",
                log_norm: bool = False) -> torch.Tensor:
    """Velocity-prediction loss, with the logit-normal time weights
    w(t) = exp(-logit(t)^2 / 2) / (eps + sqrt(2 pi) t (1 - t)), normalised to
    a batch mean of 1, under ``log_norm``."""
    err = _err(v_pred, v_gt, loss_type)
    if log_norm:
        eps = 1e-7
        t = torch.clamp(t.float(), eps, 1 - eps)
        w = 1.0 / (eps + math.sqrt(2 * math.pi) * t * (1 - t)) * torch.exp(
            -0.5 * torch.log(t / (1 - t)).square())
        err = err * (w / w.mean())[:, None, None]
    return _masked_mean(err, nonpadding)


def aux_mel_loss(aux_out: torch.Tensor, norm_gt_mel: torch.Tensor,
                 nonpadding: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L1 between the aux decoder's normalised output and the normalised mel."""
    return _masked_mean(_err(aux_out, norm_gt_mel, "l1"), nonpadding)
