"""Calls from a roomy frame on CPython's frame stack.

The entry points whose request runs a Python loop of many small calls (the
samplers' steps, a loaded program's op loop, the vocoder's layers) run it
through :func:`with_room`: the eager models' ``forward_infer`` and
``forward_infer_dynamic``, the variance model's deployed views, the
vocoder's ``spec2wav_torch`` and the artifact runtimes' programs.
"""

from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def _roomy():
    """``roomy(fn, *args, **kwargs)`` calls ``fn(*args, **kwargs)`` from a
    frame of about 128 KiB.

    CPython keeps a thread's Python frames in chunks (16 KiB by default) and
    gives a chunk back as soon as the frame at its start returns, so a loop
    whose calls land across a chunk boundary takes and gives back a chunk on
    every call: up to 0.17 ms a call on an H100 machine's host, which made a
    loaded program's request 2-7x slower at the stack depths that put its op
    loop there (``tools/probe_pt2_host.py``). A frame this large starts a
    chunk of its own with about as much room after it, so no call of a
    request crosses a boundary, whatever the caller's depth."""
    names = " = ".join(f"_r{i}" for i in range(1 << 14))
    scope: dict = {}
    exec(compile(f"def with_room(fn, *args, **kwargs):\n    if False:\n        {names} = None\n"
                 "    return fn(*args, **kwargs)\n", "<with_room>", "exec"), scope)
    return scope["with_room"]


def with_room(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` called from the roomy frame of :func:`_roomy`."""
    return _roomy()(fn, *args, **kwargs)


def runs_with_room(fn):
    """Decorator: the function's body runs from the roomy frame, except
    while ``torch.export`` or ``torch.compile`` traces it (a graph has no
    frames to place)."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if torch.compiler.is_compiling():
            return fn(*args, **kwargs)
        return with_room(fn, *args, **kwargs)
    return wrapper
