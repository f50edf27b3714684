"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell comes from ``BENCHMARK.json`` beside this folder; its configuration,
traffic mix, driver and per-layer metric readers from the files of this
folder named after them. The run makes its inputs and weights from
``--seed``, sets up and warms up, measures for ``--seconds`` (under the
profiler with ``--trace 1``), checks the answers against the plain
reference, and prints the numbers compared beside their limits as the last
lines of standard error, and one JSON object as the last line of standard
output. It exits non-zero, printing no result, without enough CUDA devices,
or when JAX or the JAX package is loaded once the window has closed.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# the program's build and kernel caches: fixed folders inside the checkout
CACHE = ROOT / ".bench_cache"
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CACHE / "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", str(CACHE / "triton"))
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_TF", "0")


def execute(workload: str, seed: int, seconds: float, trace: bool, device, *,
            config: dict = None, mix: dict = None, lowp: str = None, scratch: Path = None):
    """Run the cell and return its :class:`benchmark.harness.Run`, filled.
    ``config`` and ``mix`` replace the cell's files (tests run tiny ones on
    the CPU); ``lowp`` puts the control in the program's place."""
    from benchmark import harness, trace as tracing

    bench = harness.benchmark()
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    if config is None:
        config = harness.load_json(harness.HERE / "configs" / f"{cell['config']}.json")
    if mix is None:
        mix = harness.load_json(harness.HERE / "traffic" / f"{cell['traffic']}.json")
    driver = harness.load_module(harness.HERE / "drivers" / f"{mix['driver']}.py",
                                 f"bench_driver_{mix['driver']}")
    own_scratch = scratch is None
    scratch = Path(tempfile.mkdtemp(prefix="ds_bench_")) if own_scratch else scratch
    run = harness.Run(cell=cell, config=config, mix=mix, seed=seed, seconds=seconds, trace=trace,
                      device=device, scratch=scratch, lowp=lowp, tracer=tracing.Tracer(trace))
    try:
        driver.run(run)
    finally:
        if own_scratch:
            shutil.rmtree(scratch, ignore_errors=True)
    if trace:
        run.layer["trace"] = tracing.reduce(run.tracer.events(), driver.RANGES)
    run.tracer = None
    return run


def result_line(run, bench: dict, device_name: str, count: int) -> dict:
    from benchmark import harness

    name = run.cell["name"]

    def mine(metric):
        return "workloads" not in metric or name in metric["workloads"]

    if run.trace:
        metrics = harness.read_metrics([m["name"] for m in bench["per_layer"] if mine(m)],
                                       run.layer)
    else:
        metrics = {}
        for m in bench["end_to_end"]:
            if mine(m) and m["name"] in run.e2e:
                metrics[m["name"]] = {"value": run.e2e[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_name, "count": count,
              "memory_peak_bytes": run.memory_peak_bytes}
    out = {"correct": all(c.ok for c in run.checks) and bool(run.checks) and run.failed == 0,
           "attempted": run.attempted, "failed": run.failed, "metrics": metrics, "device": device}
    red = run.layer.get("trace") or {}
    if run.trace:
        device["busy_s"] = red.get("busy_s", 0.0)
        device["window_s"] = red.get("window_s", run.layer.get("window_s", 0.0))
        if red:
            out["breakdown"] = {"device_ops": red["device_ops"], "idle_gaps": red["idle_gaps"]}
    out["compared"] = {c.name: {"value": c.value, "limit": c.limit} for c in run.checks}
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    from benchmark import harness

    bench = harness.benchmark()
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 3
    try:
        import diffsinger_tpu_torch  # noqa: F401
    except ImportError as err:
        print(f"the program under test is missing: {err}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    run = execute(args.workload, args.seed, args.seconds, bool(args.trace), device)
    setup_s = run.window_start - PROCESS_START
    run.e2e["setup_s"] = setup_s
    found = harness.forbidden_modules()
    if found:
        print(f"JAX or the JAX package is loaded: {', '.join(found)}", file=sys.stderr)
        return 4
    out = result_line(run, bench, torch.cuda.get_device_name(0), cell["chips"])
    m = run.layer["setup_marks"]  # each phase of the set-up starts at its mark
    edges = [("imports", PROCESS_START), ("traffic", m["traffic"]), ("server", m["server"]),
             ("warm-up", m["warm-up"]), ("window", run.window_start)]
    print("set-up s: " + ", ".join(f"{name} {end - start:.3f}" for (name, start), (_, end)
                                   in zip(edges, edges[1:])), file=sys.stderr)
    if run.trace:
        red = run.layer.get("trace", {})
        print(f"trace: kernels {json.dumps(red.get('links'))}, device s by range "
              f"{json.dumps(red.get('device_s'))}", file=sys.stderr)
    for c in run.checks:
        print(f"{c.name} {c.value!r} limit {c.limit!r} {'ok' if c.ok else 'FAILED'}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
