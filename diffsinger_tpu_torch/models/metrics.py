"""Validation metrics of the variance model (counterpart of
diffsinger_tpu/models/metrics.py).

Each metric is an accumulator whose ``update`` returns a new state. The sums
stay tensors on the device of the inputs, so a validation run reads each
metric once, through ``value()``, when it is logged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from diffsinger_tpu_torch.utils.seq import rhythm_regulator

Sum = Union[float, torch.Tensor]


def _word_sum(values: torch.Tensor, ph2word: torch.Tensor) -> torch.Tensor:
    """Phoneme values summed per word: [B, T_ph] -> [B, T_ph] (an upper
    bound on the word count; index 0 of ``ph2word`` is the padding slot)."""
    b, t = ph2word.shape
    out = torch.zeros((b, t + 1), dtype=values.dtype, device=values.device)
    return out.scatter_add(1, ph2word.long(), values)[:, 1:]


@dataclasses.dataclass
class MetricState:
    """A numerator and a denominator."""

    num: Sum = 0.0
    den: Sum = 0.0

    def value(self) -> float:
        return float(self.num) / max(float(self.den), 1e-9)


class RhythmCorrectness:
    """The share of words whose predicted duration is within ``tolerance``
    of the target's."""

    def __init__(self, tolerance: float = 0.05):
        if not 0.0 < tolerance < 1.0:
            raise ValueError(f"tolerance {tolerance} is not in (0, 1)")
        self.tolerance = tolerance

    def update(self, state: MetricState, pdur_pred, pdur_target, ph2word,
               mask: Optional[torch.Tensor] = None) -> MetricState:
        wdur_pred = _word_sum(pdur_pred.float(), ph2word)
        wdur_target = _word_sum(pdur_target.float(), ph2word)
        weight = torch.ones_like(pdur_pred, dtype=torch.float32) if mask is None else mask.float()
        wdur_mask = _word_sum(weight, ph2word) > 0
        correct = ((wdur_pred - wdur_target).abs() <= wdur_target * self.tolerance) & wdur_mask
        return MetricState(state.num + correct.sum(), state.den + wdur_mask.sum())


class PhonemeDurationAccuracy:
    """The share of phonemes within ``tolerance`` of their target after the
    prediction is rescaled to the target's word durations."""

    def __init__(self, tolerance: float = 0.2):
        self.tolerance = tolerance

    def update(self, state: MetricState, pdur_pred, pdur_target, ph2word,
               mask: Optional[torch.Tensor] = None) -> MetricState:
        target = pdur_target.float()
        aligned = rhythm_regulator(pdur_pred, ph2word, _word_sum(target, ph2word)).float()
        accurate = (aligned - target).abs() <= target * self.tolerance
        if mask is None:
            return MetricState(state.num + accurate.sum(), state.den + pdur_pred.numel())
        return MetricState(state.num + (accurate & mask).sum(), state.den + mask.sum())


class RawCurveAccuracy:
    """The share of frames within ``tolerance`` of the target curve."""

    def __init__(self, tolerance: float = 0.5):
        self.tolerance = tolerance

    def update(self, state: MetricState, pred, target,
               mask: Optional[torch.Tensor] = None) -> MetricState:
        close = (pred - target).abs() <= self.tolerance
        if mask is None:
            return MetricState(state.num + close.sum(), state.den + pred.numel())
        return MetricState(state.num + (close & mask).sum(), state.den + mask.sum())


@dataclasses.dataclass
class R2State:
    sum_squared_error: Sum = 0.0
    sum_error: Sum = 0.0
    residual: Sum = 0.0
    total: Sum = 0.0

    def value(self) -> float:
        total = max(float(self.total), 1e-9)
        denom = float(self.sum_squared_error) - float(self.sum_error) ** 2 / total
        return 1.0 - float(self.residual) / max(denom, 1e-9)


class RawCurveR2Score:
    """Streaming R^2 of a curve over the masked frames. The sums are float64:
    R^2 subtracts two sums of squares that agree in their leading digits."""

    def update(self, state: R2State, pred, target,
               mask: Optional[torch.Tensor] = None) -> R2State:
        pred = pred.reshape(-1).double()
        target = target.reshape(-1).double()
        if mask is None:
            total = target.numel()
        else:
            m = mask.reshape(-1).double()
            pred, target, total = pred * m, target * m, m.sum()
        residual = target - pred
        return R2State(state.sum_squared_error + (target * target).sum(),
                       state.sum_error + target.sum(),
                       state.residual + (residual * residual).sum(),
                       state.total + total)
