"""Mel normalisation for the generative core
(counterpart of diffsinger_tpu/core/spec_transform.py, ``SpecTransform`` only).

(min, max) -> [-1, 1] per mel bin on [B, T, M]. The multi-feature and
repeat-bin transforms of the variance family wait for that slice.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch


class SpecTransform:
    def __init__(self, spec_min: Sequence[float], spec_max: Sequence[float], out_dims: int):
        # a single value broadcasts over the bins, as in the shipped configs
        smin = np.asarray(spec_min, dtype=np.float32).reshape(-1)[:out_dims]
        smax = np.asarray(spec_max, dtype=np.float32).reshape(-1)[:out_dims]
        self.spec_min = torch.from_numpy(smin)
        self.spec_max = torch.from_numpy(smax)

    def norm(self, x: torch.Tensor) -> torch.Tensor:
        smin, smax = self.spec_min.to(x.device), self.spec_max.to(x.device)
        return (x - smin) / (smax - smin) * 2 - 1

    def denorm(self, x: torch.Tensor) -> torch.Tensor:
        smin, smax = self.spec_min.to(x.device), self.spec_max.to(x.device)
        return (x + 1) / 2 * (smax - smin) + smin
