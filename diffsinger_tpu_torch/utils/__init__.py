"""Small helpers shared across the port."""

from __future__ import annotations

import contextlib
import inspect

import numpy as np
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


def pad_to(x: np.ndarray, length: int, pad_value=0, axis: int = 0) -> np.ndarray:
    """Pad one array along ``axis`` to a static length."""
    if x.shape[axis] == length:
        return x
    assert x.shape[axis] < length, f"array dim {x.shape[axis]} exceeds target {length}"
    widths = [(0, 0)] * x.ndim
    widths[axis] = (0, length - x.shape[axis])
    return np.pad(x, widths, constant_values=pad_value)


def resolve_precision(precision) -> torch.dtype:
    """``infer_precision`` -> the dtype a model is built in: any 16-bit
    spelling ('bf16', '16-mixed', 'bf16-mixed', 16) gives bfloat16, anything
    else (None, '32', '32-true') float32."""
    return torch.bfloat16 if "16" in str(precision) else torch.float32


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


@contextlib.contextmanager
def no_tf32():
    """Run float32 products in full float32 (also usable as a decorator).

    PyTorch lets cuDNN round float32 convolution inputs to TF32 by default;
    the port's float32 models and plain versions are float32 throughout, so
    their entry points switch TF32 off for cuDNN and cuBLAS for the call and
    restore the caller's settings after it.
    """
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
