"""Run cells of the benchmark with the program's spans on, and charge the
window's kernels and idle gaps to them.

    python3 tools/trace_cell.py --workload <cell> --seeds <n> [<n> ...]
        [--seconds 30] [--trace 0|1] [--program 0|1 ...] [--out <file.jsonl>]

Each (seed, program) pair is one run of ``benchmark/run.py``'s ``execute``
in this process, in the order given (``--program 0 1`` runs each seed with
the spans off, then on). ``--program 1`` turns the program's tracing
(``diffsinger_tpu_torch/utils/tracing.py``) on for the window only, as the
profiler is; ``--trace 1`` runs the window under ``torch.profiler`` as the
benchmark's traced run does. The spans' own echoes on the device's timeline
(the profiler draws each host range there too) are taken out of the events
before the benchmark's reduction reads them, so its per-layer metrics read
what they read with the spans off. A second pass (:func:`program_pass`, the
benchmark's reduction over ``tracing.NAMES``) gives for each name: host
seconds and count of its spans in the window, the kernels launched inside
them and their device seconds, and the idle seconds of the device's gaps that
began with it the innermost span open. :func:`span_metrics` reads six
per-layer numbers from it.

A stopgap: it wraps ``benchmark.trace.Tracer`` and ``reduce`` at run time,
and refuses a run in which the benchmark went round the wrappers. Once the
benchmark reads the spans itself, this tool and its test go.

One JSON line a run goes to standard output, and is appended to ``--out``
when given. Needs a CUDA device, as the benchmark does.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path
from typing import Dict, Sequence

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


class _OneNanosecond:
    """A profiler event whose device activity lasts 1 ns: the reduction's
    device seconds of such events count their kernels, in nanoseconds."""

    def __init__(self, event, cuda):
        self.event, self.on_device = event, event.device_type() == cuda

    def duration_ns(self):
        return 1 if self.on_device else self.event.duration_ns()

    def __getattr__(self, name):
        return getattr(self.event, name)


def program_pass(events, echoes: Sequence[str]) -> Dict:
    """The window's kernels and idle gaps by ``tracing.NAMES``, through the
    benchmark's own reduction with those names as its ranges. ``echoes``
    names the host ranges whose copies on the device's timeline are no work
    (the benchmark's own); the spans' copies are left out by the reduction."""
    import torch

    from benchmark import trace as bench_trace
    from diffsinger_tpu_torch.utils.tracing import NAMES

    reduce = getattr(bench_trace.reduce, "__wrapped__", bench_trace.reduce)

    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in events if not (e.device_type() == cuda and e.name() in echoes)]
    window = next((e for e in events if e.name() == bench_trace.WINDOW
                   and e.device_type() != cuda), None)
    if window is None:
        return {}
    w0, w1 = window.start_ns(), window.start_ns() + window.duration_ns()
    host = defaultdict(list)  # the host durations of each name's spans that begin in the window
    for e in events:
        if e.device_type() != cuda and e.name() in NAMES and w0 <= e.start_ns() < w1:
            host[e.name()].append(e.duration_ns())
    red = reduce(events, NAMES)  # empty where the device did nothing in the window
    kernels = reduce([_OneNanosecond(e, cuda) for e in events], NAMES)["device_s"] if red else {}
    idle = dict(red.get("idle_gaps", []))
    spans = {name: {"host_s": sum(d) / 1e9, "count": len(d),
                    "kernels": round(kernels.get(name, 0.0) * 1e9),
                    "device_s": red.get("device_s", {}).get(name, 0.0),
                    "idle_s": idle.get(name, 0.0)}
             for name, d in host.items()}
    window_s = (w1 - w0) / 1e9
    return {"window_s": window_s, "busy_s": red.get("busy_s", 0.0),
            "idle_s": window_s - red.get("busy_s", 0.0),
            "idle_in_no_span_s": idle.get("no benchmark range", 0.0), "spans": spans}


def span_metrics(program: Dict, counters: Dict[str, float], layer: Dict, e2e: Dict) -> Dict:
    """The six per-layer numbers the spans and counters give, each left out
    where its spans or counters are missing."""
    sp = program.get("spans", {})

    def get(name, key):
        return sp.get(name, {}).get(key, 0)

    out = {}
    if get("ds.sampler.step", "count"):
        n = get("ds.sampler.step", "count")
        out["sampler_host_ms_per_step.infer"] = 1e3 * get("ds.sampler.step", "host_s") / n
        out["sampler_kernels_per_step.infer"] = get("ds.sampler.step", "kernels") / n
    if get("ds.server.enqueue", "count"):
        out["server_host_ms_per_chunk.infer"] = 1e3 * (
            get("ds.server.stack", "host_s") + get("ds.server.fetch", "host_s")) / get(
            "ds.server.enqueue", "count")
    if get("ds.train.forward", "count"):
        out["forward_host_ms_per_step.train"] = 1e3 * get("ds.train.forward", "host_s") / get(
            "ds.train.forward", "count")
    cpu = [v for k, v in counters.items() if k.startswith("pipeline.")]
    if cpu and layer.get("window_s"):
        out["pipeline_cpu_share.train"] = 100.0 * sum(cpu) / layer["window_s"]
    frames = e2e.get("train_frames_per_s", 0) * layer.get("window_s", 0)
    if get("ds.lynx.bwd", "count") and frames:
        out["lynxnet_bwd_ms_per_kframe.train"] = get("ds.lynx.bwd", "device_s") / frames * 1e6
    return out


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


STATE: Dict = {}  # the current run's: "program" in; "counters", "echoes", "program_pass" out


def patch_benchmark() -> None:
    """Wrap the benchmark's tracer and reduction, once: the program's spans
    and counters follow the tracer's window when ``STATE["program"]``; the
    spans' echoes leave the events; the program pass goes to ``STATE``."""
    import torch

    from benchmark import trace as bench_trace
    from diffsinger_tpu_torch.utils import tracing

    reduce = bench_trace.reduce
    if hasattr(reduce, "__wrapped__"):
        return

    class Tracer(bench_trace.Tracer):
        def start(self):
            tracing.counters().clear()
            tracing.enable(STATE["program"])
            super().start()

        def stop(self):
            super().stop()
            tracing.enable(False)
            STATE["counters"] = dict(tracing.counters())

    def reduce_without_echoes(events, ranges):
        cuda = torch.autograd.DeviceType.CUDA
        kept = [e for e in events if not (e.device_type() == cuda and e.name() in tracing.NAMES)]
        STATE["echoes"] = len(events) - len(kept)
        STATE["program_pass"] = program_pass(kept, ranges)
        return reduce(kept, ranges)

    reduce_without_echoes.__wrapped__ = reduce
    bench_trace.Tracer = Tracer
    bench_trace.reduce = reduce_without_echoes


def run_once(workload: str, seed: int, seconds: float, trace: bool, program: bool, device,
             **execute_kwargs) -> Dict:
    """One run of the cell (the benchmark patched by :func:`patch_benchmark`):
    its result line with the program pass, the counters and the six numbers."""
    import torch

    from benchmark import harness, run as bench_run

    patch_benchmark()
    STATE.clear()
    STATE["program"] = program
    t0 = time.perf_counter()
    run = bench_run.execute(workload, seed, seconds, trace, device, **execute_kwargs)
    if "counters" not in STATE or (trace and "program_pass" not in STATE):
        raise RuntimeError("benchmark/run.py no longer reaches benchmark.trace's Tracer and "
                           "reduce through the module: the wrappers saw nothing")
    name = torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu"
    line = bench_run.result_line(run, harness.benchmark(), name, 1)
    prog = STATE.get("program_pass", {})
    counters = STATE.get("counters", {})
    line.update(workload=workload, seed=seed, program=int(program), trace=int(trace),
                echoes=STATE.get("echoes", 0), e2e=run.e2e, card=card(),
                run_s=time.perf_counter() - t0, counters=counters, program_pass=prog,
                span_metrics=span_metrics(prog, counters, run.layer, run.e2e))
    red = run.layer.get("trace") or {}
    if prog and red:  # the spans' idle and the rest, over the benchmark's own idle time
        line["idle_accounted"] = (
            sum(s["idle_s"] for s in prog["spans"].values()) + prog["idle_in_no_span_s"]
        ) / (red["window_s"] - red["busy_s"])
    return line


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--seconds", type=float, default=30.0)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=1)
    parser.add_argument("--program", type=int, choices=(0, 1), nargs="+", default=[1])
    parser.add_argument("--out", help="a file to append each run's line to")
    args = parser.parse_args(argv)

    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        for program in args.program:
            line = run_once(args.workload, seed, args.seconds, bool(args.trace), bool(program),
                            torch.device("cuda", 0))
            text = json.dumps(line)
            print(text, flush=True)
            if args.out:
                Path(args.out).parent.mkdir(parents=True, exist_ok=True)
                with open(args.out, "a", encoding="utf-8") as f:
                    f.write(text + "\n")
    found = harness.forbidden_modules()
    if found:
        print(f"JAX or the JAX package is loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    return 0


if __name__ == "__main__":
    sys.exit(main())
