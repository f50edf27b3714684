"""Small helpers shared across the port."""

from __future__ import annotations

import inspect

import torch


def filter_kwargs(dict_to_filter: dict, kwarg_obj) -> dict:
    """Keep only the kwargs that ``kwarg_obj``'s signature accepts."""
    sig = inspect.signature(kwarg_obj)
    if any(p.kind == inspect.Parameter.VAR_KEYWORD for p in sig.parameters.values()):
        return dict(dict_to_filter)
    keys = [
        name
        for name, p in sig.parameters.items()
        if p.kind in (inspect.Parameter.POSITIONAL_OR_KEYWORD, inspect.Parameter.KEYWORD_ONLY)
    ]
    return {k: v for k, v in dict_to_filter.items() if k in keys}


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller names another.

    Raises when CUDA is asked for (explicitly or by default) and there is no
    card, so an entry point never carries on silently on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
