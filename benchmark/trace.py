"""The device trace of a window, reduced to what the per-layer metrics read.

The benchmark opens host ranges itself (``torch.profiler.record_function``
around the servers' methods and, through module hooks, around the network's
layers). The profiler records them, every operator, and every kernel, copy
and set on the device. :func:`reduce` then gives:

- ``busy_s``: the union of the device's activities in the window (kernels,
  copies, sets; the profiler's own ranges on the device's timeline are left
  out), so overlapping kernels of several streams count once;
- ``device_s[range]``: the device time of the kernels that an operator
  launched while a host range of that name was open;
- ``idle_gaps``: the device's gaps, each named by the innermost benchmark
  range open on the host when it began;
- ``device_ops``: device time by kernel name.

The union and the range arithmetic are the method of ``chip_smoke.py``'s
``union_us`` / ``device_activities``, on the profiler's raw events.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

WINDOW = "bench.window"


def union(intervals: Sequence[Tuple[float, float]]) -> List[Tuple[float, float]]:
    """The union of (start, end) intervals as sorted disjoint intervals."""
    out: List[Tuple[float, float]] = []
    for start, end in sorted(intervals):
        if out and start <= out[-1][1]:
            if end > out[-1][1]:
                out[-1] = (out[-1][0], end)
        else:
            out.append((start, end))
    return out


class Tracer:
    """Profiles a window when ``on``; ``span(name)`` opens a host range (a
    no-op when off, so the untraced run pays nothing)."""

    def __init__(self, on: bool):
        self.on = on
        self.prof = None

    def span(self, name: str):
        if not self.on:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def start(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.__enter__()

    def stop(self):
        if self.prof is not None:
            self.prof.__exit__(None, None, None)

    def events(self):
        return self.prof.profiler.kineto_results.events() if self.prof is not None else []


def reduce(events, ranges: Sequence[str]) -> Dict:
    """Reduce the raw events (see the module's note). ``ranges`` names the
    benchmark's host ranges, innermost first (that order names the gaps)."""
    ops = {}
    runtime = {}
    spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    device = []
    names = set(ranges) | {WINDOW}
    cuda = torch.autograd.DeviceType.CUDA
    for e in events:
        name = e.name()
        if e.device_type() == cuda:
            if name in names:  # a host range drawn on the device's timeline, not work
                continue
            kind = "kernel"
            if name.startswith("Memcpy") or name.startswith("Memset"):
                kind = "copy"
            device.append((e.start_ns(), e.start_ns() + e.duration_ns(), name, kind,
                           e.linked_correlation_id(), e.correlation_id()))
        elif name in names:
            spans[name].append((e.start_ns(), e.start_ns() + e.duration_ns()))
        elif name.startswith("cuda") or name.startswith("cu"):  # the runtime's and driver's calls
            runtime[e.correlation_id()] = e.start_ns()
        else:
            ops[e.correlation_id()] = e.start_ns()
    if not spans.get(WINDOW):
        return {}
    w0, w1 = spans[WINDOW][0]
    device = [d for d in device if d[1] > w0 and d[0] < w1]
    if not device:
        return {}
    busy = union([(max(s, w0), min(e, w1)) for s, e, *_ in device])
    busy_ns = sum(e - s for s, e in busy)

    by_name: Dict[str, float] = defaultdict(float)
    for s, e, name, _kind, *_ in device:
        by_name[name] += (e - s) / 1e9

    # each kernel's launch on the host: its operator's start, else its runtime call's
    kernels = [d for d in device if d[3] == "kernel"]
    launch = np.array([ops.get(link, runtime.get(corr, -1)) for *_, link, corr in kernels],
                      dtype=np.int64)
    links = {"kernels": len(kernels), "by_operator": sum(k[4] in ops for k in kernels),
             "by_runtime": sum(k[4] not in ops and k[5] in runtime for k in kernels)}
    dur = np.array([(e - s) / 1e9 for s, e, *_ in kernels])
    device_s = {}
    open_at = {}
    for name in ranges:
        iv = sorted(spans.get(name, []))
        starts = np.array([s for s, _ in iv], dtype=np.int64)
        ends = np.array([e for _, e in iv], dtype=np.int64)

        def inside(times, starts=starts, ends=ends):
            if len(starts) == 0:
                return np.zeros(len(times), bool)
            idx = np.searchsorted(starts, times, side="right") - 1
            return (idx >= 0) & (times < ends[np.maximum(idx, 0)]) & (times >= 0)

        device_s[name] = float(dur[inside(launch)].sum()) if len(kernels) else 0.0
        open_at[name] = inside

    gaps = []
    edge = w0
    for s, e in busy:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if edge < w1:
        gaps.append((edge, w1))
    gap_starts = np.array([g[0] for g in gaps], dtype=np.int64)
    named = np.full(len(gaps), "no benchmark range", dtype=object)
    for name in reversed(ranges):  # inner ranges overwrite outer ones
        if len(gaps):
            named[open_at[name](gap_starts)] = name
    idle: Dict[str, float] = defaultdict(float)
    for (s, e), name in zip(gaps, named):
        idle[name] += (e - s) / 1e9
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy_ns / 1e9, "device_s": device_s,
            "device_ops": top(by_name), "idle_gaps": top(idle), "links": links}
