"""Training losses (counterpart of diffsinger_tpu/models/losses.py) over flat
[B, T, D] tensors. Every input is taken to float32 first, so a bf16 forward
reduces its losses in float32.
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


def _weighted(err: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (err * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def dur_loss(dur_pred_log: torch.Tensor, dur_gt: torch.Tensor, ph2word: torch.Tensor,
             nonpadding: torch.Tensor, *, offset: float = 1.0, loss_type: str = "mse",
             lambda_pdur: float = 0.3, lambda_wdur: float = 1.0,
             lambda_sdur: float = 3.0) -> torch.Tensor:
    """Log-domain duration loss on the phoneme, word and sentence levels.

    dur_pred_log [B, T_ph] the predictor's raw (log-domain) output; dur_gt
    [B, T_ph] target durations in frames; ph2word [B, T_ph] 1-based word ids
    (0 = padding); nonpadding [B, T_ph] float mask. The word and sentence
    terms compare log(duration + offset) of sums of linear durations, the
    predictions clamped at 0 first (a sum below -offset would have no log).
    The sentence term averages over the rows with a valid token, so rows of
    zero weight added to fill a batch do not dilute it.
    """
    if loss_type == "mse":
        def err_fn(a, b):
            return (a - b).square()
    elif loss_type == "huber":
        def err_fn(a, b):
            d = (a - b).abs()
            return torch.where(d < 1.0, 0.5 * d.square(), d - 0.5)
    else:
        raise NotImplementedError(loss_type)
    dur_pred_log = dur_pred_log.float()
    nonpadding = nonpadding.float()
    dur_gt = dur_gt.float() * nonpadding
    pdur = _weighted(err_fn(dur_pred_log, torch.log(dur_gt + offset)), nonpadding)

    dur_pred = torch.clamp(torch.exp(dur_pred_log) - offset, min=0.0) * nonpadding
    b, t_ph = ph2word.shape  # the word count is at most the phoneme count
    idx = ph2word.long()
    zeros = torch.zeros((b, t_ph + 1), dtype=torch.float32, device=dur_pred.device)
    wdur_pred = zeros.scatter_add(1, idx, dur_pred)[:, 1:]
    wdur_gt = zeros.scatter_add(1, idx, dur_gt)[:, 1:]
    wdur = _weighted(err_fn(torch.log(wdur_pred + offset), torch.log(wdur_gt + offset)),
                     (wdur_gt > 0).float())

    row_valid = (nonpadding.sum(dim=1) > 0).float()
    sdur_err = err_fn(torch.log(dur_pred.sum(dim=1) + offset), torch.log(dur_gt.sum(dim=1) + offset))
    sdur = (sdur_err * row_valid).sum() / torch.clamp(row_valid.sum(), min=1.0)
    return lambda_pdur * pdur + lambda_wdur * wdur + lambda_sdur * sdur


def aux_mel_loss(aux_out: torch.Tensor, norm_gt_mel: torch.Tensor,
                 nonpadding: Optional[torch.Tensor] = None) -> torch.Tensor:
    """L1 between the aux decoder's normalised output and the normalised mel."""
    return _masked_mean(_err(aux_out, norm_gt_mel, "l1"), nonpadding)
