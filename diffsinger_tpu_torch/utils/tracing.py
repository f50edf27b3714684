"""Named spans and counters inside the program, off unless asked for.

``enable(True)`` turns them on for the whole process. ``span(name)`` then
opens ``torch.profiler.record_function(name)``: under ``torch.profiler`` each
span is a host event on the profiler's clock, the clock of the kernels,
copies and sets it records on the device, so a device gap can be charged to
the span that was open when it began. ``add(name, value)`` sums a number
into :func:`counters`. Off, ``span`` returns one shared no-op context and
``add`` does nothing, so a span costs one branch.

Spans are left out while ``torch.export`` or ``torch.compile`` trace, so an
exported program is the same with tracing on or off.

Every span name is in :data:`NAMES`, innermost first: where spans of two
names are open at once, the earlier name is the inner one. Spans of one
name never nest in each other. A counter is bumped by one thread.
"""

from __future__ import annotations

import contextlib
from typing import Dict

import torch

NAMES = (
    "ds.lynx.bwd",  # FusedConvModuleFn.backward: the recompute and its gradient (autograd's thread)
    "ds.sampler.step",  # one step of a sampler's loop (one denoiser call of the fast solvers)
    "ds.model.condition",  # encoder, aux draft, durations and regulator
    "ds.model.sample",  # the sampler call
    "ds.vocoder",  # a vocoder's spec2wav_torch
    "ds.server.preprocess",  # a request's .ds segments to host arrays
    "ds.server.stack",  # a chunk's pad and stack, and its noise
    "ds.server.enqueue",  # a chunk's model (and vocoder) call on its replica
    "ds.server.fetch",  # a chunk's copy back to the host
    "ds.train.forward",  # the loss of a micro-batch
    "ds.train.backward",
    "ds.train.clip",
    "ds.train.optimizer",  # the optimizer's and the scheduler's step, the gradients cleared
)

_on = False
_OFF = contextlib.nullcontext()
_counters: Dict[str, float] = {}


def enable(on: bool = True) -> None:
    global _on
    _on = bool(on)


def enabled() -> bool:
    return _on


def span(name: str):
    """A context that opens the span ``name`` (one of :data:`NAMES`) while
    tracing is on."""
    if not _on or torch.compiler.is_compiling():
        return _OFF
    return torch.profiler.record_function(name)


def add(name: str, value: float) -> None:
    """Add ``value`` to the counter ``name`` while tracing is on."""
    if _on:
        _counters[name] = _counters.get(name, 0.0) + value


def counters() -> Dict[str, float]:
    """The counters by name: the live dict, which a caller may clear."""
    return _counters
