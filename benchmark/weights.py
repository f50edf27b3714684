"""Seeded weights, made on the device in one draw.

``make(shapes, seed, device, dtype)`` draws one standard-normal vector for
all the leaves from a ``torch.Generator`` on ``device`` seeded with ``seed``,
cuts it into the leaves in the sorted order of their names and scales each
leaf by its kind, so that every activation of a network at its published
widths stays of order one: matrices and kernels get a Xavier-normal scale,
LayerNorm gains 1 + 0.1 z, biases 0.02 z, ConvNeXt's layer scales 0.1 + 0.05
z, PReLU slopes 0.25 + 0.05 z. The values are rounded to ``dtype`` (the
precision they are served in) and handed out as float32, so the program and
the reference, each filling its own modules of the same names, hold the same
numbers.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch


def scale_shift(name: str, shape: Tuple[int, ...]) -> Tuple[float, float]:
    if name.endswith(".gamma"):
        return 0.05, 0.1
    if name.endswith("convmodule.net.5.weight"):  # PReLU slopes
        return 0.05, 0.25
    if name.endswith(".bias"):
        return 0.02, 0.0
    if len(shape) == 1:  # LayerNorm gains
        return 0.1, 1.0
    receptive = math.prod(shape[2:])
    return math.sqrt(2.0 / ((shape[0] + shape[1]) * receptive)), 0.0


def make(shapes: Sequence[Tuple[str, Tuple[int, ...]]], seed: int, device,
         dtype=torch.float32) -> Dict[str, torch.Tensor]:
    shapes = sorted((name, tuple(shape)) for name, shape in shapes)
    total = sum(math.prod(shape) for _, shape in shapes)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    out, offset = {}, 0
    for name, shape in shapes:
        n = math.prod(shape)
        scale, shift = scale_shift(name, shape)
        out[name] = (flat[offset:offset + n].view(shape) * scale + shift).to(dtype).float()
        offset += n
    return out


def shapes_of(module: torch.nn.Module):
    return [(name, tuple(p.shape)) for name, p in module.named_parameters()]


@torch.no_grad()
def fill(module: torch.nn.Module, values: Dict[str, torch.Tensor]) -> None:
    """Copy ``values`` into the module's parameters of the same names; the
    names and shapes must match exactly."""
    params = dict(module.named_parameters())
    if sorted(params) != sorted(values):
        missing = sorted(set(params) ^ set(values))
        raise ValueError(f"parameter names differ: {missing[:8]}")
    for name, p in params.items():
        if tuple(p.shape) != tuple(values[name].shape):
            raise ValueError(f"{name}: shape {tuple(p.shape)} != {tuple(values[name].shape)}")
        p.copy_(values[name])
