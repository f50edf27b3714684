"""LR schedulers from the reference's ``lr_scheduler_args``
(counterpart of diffsinger_tpu/training/schedules.py).

Every class the configs can name that torch has (StepLR, ExponentialLR,
ConstantLR, LinearLR, MultiStepLR, CosineAnnealingLR, SequentialLR,
ChainedScheduler, nested as the config nests them) is torch's own
``lr_scheduler`` class; the reference's two schedules torch lacks
(RSQRTSchedule, WarmupCosineSchedule) are a ``LambdaLR`` over a copy of the
JAX package's step function. The scheduler steps once per optimizer update,
so the LR of update k is the JAX ``build_lr_schedule``'s value at k.
"""

from __future__ import annotations

import math

import torch
from torch.optim import lr_scheduler

from diffsinger_tpu_torch.utils import filter_kwargs

TORCH_SCHEDULERS = ("StepLR", "ExponentialLR", "ConstantLR", "LinearLR", "MultiStepLR",
                    "CosineAnnealingLR")


def rsqrt_schedule(lr: float, warmup_updates: int, hidden_size: int, **_):
    """Reference RSQRTSchedule: step -> LR."""

    def fn(step):
        warmup = min(step / warmup_updates, 1.0)
        rsqrt_decay = max(warmup_updates, step) ** -0.5
        return max(lr * warmup * rsqrt_decay * hidden_size ** -0.5, 1e-7)

    return fn


def warmup_cosine_schedule(lr: float, warmup_steps: int, t_total: int, eta_min: float = 0.0,
                           cycles: float = 0.5, **_):
    """Reference WarmupCosineSchedule: step -> LR."""

    def fn(step):
        if step < warmup_steps:
            return lr * step / max(1.0, warmup_steps)
        progress = (step - warmup_steps) / max(1, t_total - warmup_steps)
        return lr * max(eta_min, 0.5 * (1.0 + math.cos(math.pi * cycles * 2.0 * progress)))

    return fn


LAMBDA_SCHEDULES = {"RSQRTSchedule": rsqrt_schedule,
                    "WarmupCosineSchedule": warmup_cosine_schedule}


def build_lr_scheduler(optimizer: torch.optim.Optimizer, scheduler_args: dict, *,
                       hidden_size: int = 256):
    """The scheduler that ``scheduler_args`` names over ``optimizer``, whose
    param groups carry the base LR. A bare ``{step_size, gamma}`` is StepLR,
    as in configs/base.yaml."""

    def helper(args: dict):
        name = (args.get("scheduler_cls") or args.get("cls") or "StepLR").rsplit(".", 1)[-1]
        kwargs = {k: v for k, v in args.items() if k not in ("scheduler_cls", "cls")}
        if name == "SequentialLR":
            return lr_scheduler.SequentialLR(
                optimizer, [helper(s) for s in args["schedulers"]], milestones=args["milestones"])
        if name == "ChainedScheduler":
            return lr_scheduler.ChainedScheduler([helper(s) for s in args["schedulers"]])
        if name in LAMBDA_SCHEDULES:
            group = optimizer.param_groups[0]
            base = group.get("initial_lr", group["lr"])
            fn = LAMBDA_SCHEDULES[name](**dict({"hidden_size": hidden_size, "lr": base}, **kwargs))
            return lr_scheduler.LambdaLR(optimizer, lambda step: fn(step) / base)
        if name not in TORCH_SCHEDULERS:
            raise NotImplementedError(f"Unsupported scheduler: {name}")
        cls = getattr(lr_scheduler, name)
        return cls(optimizer, **filter_kwargs(kwargs, cls))

    return helper(dict(scheduler_args))
