"""Normalisation and repeat-bin transforms for the generative cores
(counterpart of diffsinger_tpu/core/spec_transform.py).

``SpecTransform``: (min, max) -> [-1, 1] per bin on [B, T, M] (one feature)
or [B, F, T, M]. ``RepetitiveTransform``: a scalar curve [B, T] (or F curves
[B, F, T]) is repeated over R bins and normalised; denormalising averages the
bins. ``PitchTransform`` clips the pitch delta, ``MultiVarianceTransform``
stacks the variance curves with a clamp each. The samplers see flat
[B, T, F*R] tensors (``flatten`` / ``unflatten``).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch


class SpecTransform:
    def __init__(self, spec_min: Sequence[float], spec_max: Sequence[float], out_dims: int,
                 num_feats: int = 1):
        smin = np.asarray(spec_min, dtype=np.float32)
        smax = np.asarray(spec_max, dtype=np.float32)
        if num_feats == 1:
            # a single value broadcasts over the bins, as in the shipped configs
            smin = smin.reshape(-1)[:out_dims][None, None, :]  # [1, 1, M]
            smax = smax.reshape(-1)[:out_dims][None, None, :]
        else:
            smin = smin.reshape(num_feats, -1)[:, :out_dims][None, :, None, :]  # [1, F, 1, M]
            smax = smax.reshape(num_feats, -1)[:, :out_dims][None, :, None, :]
        self.spec_min = torch.from_numpy(smin)
        self.spec_max = torch.from_numpy(smax)
        self.out_dims = out_dims
        self.num_feats = num_feats

    def norm(self, x: torch.Tensor) -> torch.Tensor:
        smin, smax = self.spec_min.to(x.device), self.spec_max.to(x.device)
        return (x - smin) / (smax - smin) * 2 - 1

    def denorm(self, x: torch.Tensor) -> torch.Tensor:
        smin, smax = self.spec_min.to(x.device), self.spec_max.to(x.device)
        return (x + 1) / 2 * (smax - smin) + smin

    def flatten(self, x: torch.Tensor) -> torch.Tensor:
        """[B, F, T, M] -> [B, T, F*M] (no-op for one feature)."""
        if self.num_feats == 1:
            return x
        b, f, t, m = x.shape
        return x.permute(0, 2, 1, 3).reshape(b, t, f * m)

    def unflatten(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, F*M] -> [B, F, T, M] (no-op for one feature)."""
        if self.num_feats == 1:
            return x
        b, t, _ = x.shape
        return x.reshape(b, t, self.num_feats, self.out_dims).permute(0, 2, 1, 3)


class RepetitiveTransform(SpecTransform):
    """Scalar curve(s) <-> repeat-bin spec."""

    def __init__(self, vmin, vmax, repeat_bins: int):
        num_feats = 1 if isinstance(vmin, (int, float)) else len(vmin)
        smin = [vmin] if num_feats == 1 else [[v] for v in vmin]
        smax = [vmax] if num_feats == 1 else [[v] for v in vmax]
        super().__init__(smin, smax, out_dims=repeat_bins, num_feats=num_feats)
        self.repeat_bins = repeat_bins

    def norm(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T] or [B, F, T] -> [B, T, R] or [B, F, T, R]."""
        x = x[..., None].expand(*x.shape, self.repeat_bins)
        return super().norm(x)

    def denorm(self, x: torch.Tensor) -> torch.Tensor:
        """[B, T, R] or [B, F, T, R] -> [B, T] or [B, F, T]."""
        return super().denorm(x).mean(dim=-1)


class PitchTransform(RepetitiveTransform):
    """Pitch-delta transform with clipping."""

    def __init__(self, vmin: float, vmax: float, cmin: float, cmax: float, repeat_bins: int):
        super().__init__(vmin, vmax, repeat_bins)
        self.cmin = cmin
        self.cmax = cmax

    def norm(self, x: torch.Tensor) -> torch.Tensor:
        return super().norm(torch.clamp(x, self.cmin, self.cmax))

    def denorm(self, x: torch.Tensor) -> torch.Tensor:
        return torch.clamp(super().denorm(x), self.cmin, self.cmax)


class MultiVarianceTransform(RepetitiveTransform):
    """Stacked variance curves with a clamp each.

    norm: a sequence of [B, T] -> [B, T, R] (one curve) or [B, F, T, R];
    denorm: back to a list of [B, T].
    """

    def __init__(self, ranges: List[Tuple[float, float]],
                 clamps: List[Optional[Tuple[Optional[float], Optional[float]]]],
                 repeat_bins: int):
        assert len(ranges) == len(clamps)
        self.clamps = clamps
        vmin = [r[0] for r in ranges]
        vmax = [r[1] for r in ranges]
        if len(vmin) == 1:
            vmin, vmax = vmin[0], vmax[0]
        super().__init__(vmin, vmax, repeat_bins)

    def clamp(self, xs) -> list:
        return [x if c is None else torch.clamp(x, c[0], c[1]) for x, c in zip(xs, self.clamps)]

    def norm(self, xs) -> torch.Tensor:
        assert len(xs) == self.num_feats
        stacked = torch.stack(self.clamp(xs), dim=1)  # [B, F, T]
        if self.num_feats == 1:
            stacked = stacked[:, 0]
        return super().norm(stacked)

    def denorm(self, x: torch.Tensor) -> list:
        out = super().denorm(x)
        xs = [out] if self.num_feats == 1 else [out[:, i] for i in range(self.num_feats)]
        return self.clamp(xs)
