"""Where the host time of a deployed ``.pt2`` acoustic request goes in a long
process, against a fresh one.

In ``chip_smoke.py``'s long process the ``.pt2`` request ran at 2-7x eager
while a fresh process ran it as eager, until the artifact runtimes called
their programs from a frame with room (``utils.frames.with_room``): the
cause is CPython's frame stack. The eager entry points run their request
loops from the same frame. This script runs ``chip_smoke.main`` up
to ``[export]`` in its own process and looks at the host at each phase
boundary:

* what the process holds (threads, Python's collector, profile and trace
  hooks, ``sys.monitoring`` tools, torch's mode stacks and dispatch key
  sets, dynamo's frame callback);
* micro timings of a Python kernel behind the dispatcher: 2,000 calls of a
  ``torch.library`` operator whose CUDA kernel is a Python function that
  reads the current stream through ``torch.cuda.current_stream``, that reads
  it raw, or that calls a small Python function; beside the direct calls.

At ``[export]`` it exports the full-width acoustic model to ``.pt2`` at
(64, 512) and times the request in turns against eager in variants: as
the package stands, with the kernels' wrappers reading the stream raw, under
a no-op profile hook, on a new thread, with Python's collector off, called
under 1 to 8 more frames of 2 KiB each, then called directly and under the
same frames with the programs called without room, and as it stands again,
with the minor page faults of a request in each; then profiles one of each
with cProfile. A spawned process does the same from nothing, then after
one ``torch.profiler`` session.
Everything lands in ``chiprun_out/probe_pt2_host.json`` and
``chiprun_out/probe_pt2_cprofile_*.txt``.

    python3 tools/probe_pt2_host.py   # on a machine with a CUDA card

``--frame-stack`` runs, on the CPU alone, the pattern found: a loop of
calls to an empty function under each depth of frames from 0 to 600.

    python3 tools/probe_pt2_host.py --frame-stack
"""

from __future__ import annotations

import contextlib
import cProfile
import gc
import io
import json
import multiprocessing
import pstats
import resource
import shutil
import sys
import tempfile
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

OUT = ROOT / "chiprun_out"
MICRO_CALLS = 2000
HAS_RAW = None  # torch._C._cuda_getCurrentRawStream, where this torch has it
_LIB = None
REPORT = {"checkpoints": [], "export": {}}


class Done(Exception):
    """Raised after [export] to end ``chip_smoke.main`` early."""


def _small(x):
    return x


def _op_stream(x):
    torch = sys.modules["torch"]
    torch.cuda.current_stream(x.device).cuda_stream
    return x.new_empty(0)


def _op_raw(x):
    torch = sys.modules["torch"]
    torch._C._cuda_getCurrentRawStream(x.device.index)
    return x.new_empty(0)


def _op_python(x):
    _small(x), _small(x), _small(x)
    return x.new_empty(0)


def probe_ops():
    """The ``dsprobe`` operators, defined once a process."""
    global _LIB, HAS_RAW
    import torch

    if _LIB is None:
        HAS_RAW = hasattr(torch._C, "_cuda_getCurrentRawStream")
        _LIB = torch.library.Library("dsprobe", "DEF")
        for name, fn in (("stream", _op_stream), ("raw", _op_raw), ("python", _op_python)):
            _LIB.define(f"{name}(Tensor x) -> Tensor")
            _LIB.impl(name, fn, "CUDA")
    return torch.ops.dsprobe


def per_call_us(fn, n: int = MICRO_CALLS) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def micro() -> dict:
    """Microseconds a call, on the host."""
    import torch

    ops = probe_ops()
    x = torch.zeros(4, device="cuda")
    out = {
        "python function": per_call_us(lambda: _small(x)),
        "torch.cuda.current_stream direct": per_call_us(
            lambda: torch.cuda.current_stream(x.device).cuda_stream),
        "aten empty_like via OpOverload": per_call_us(
            lambda: torch.ops.aten.empty_like.default(x)),
        "op: current_stream": per_call_us(lambda: ops.stream.default(x)),
        "op: three python calls": per_call_us(lambda: ops.python.default(x)),
        "op: raw stream": float("nan"),
    }
    if HAS_RAW:
        out["raw stream direct"] = per_call_us(
            lambda: torch._C._cuda_getCurrentRawStream(x.device.index))
        out["op: raw stream"] = per_call_us(lambda: ops.raw.default(x))
    prof = cProfile.Profile()
    prof.enable()
    for _ in range(300):
        ops.stream.default(x)
    prof.disable()
    out["cprofile op: current_stream (300 calls), top by own time"] = top_functions(prof, 6)
    return out


def top_functions(prof, n: int) -> list:
    stats = pstats.Stats(prof)
    rows = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:n]
    return [{"function": f"{Path(k[0]).name}:{k[1]}({k[2]})", "calls": v[1],
             "own_ms": v[2] * 1e3, "cum_ms": v[3] * 1e3} for k, v in rows]


def state() -> dict:
    """What the process holds that could tax Python code on the host."""
    import torch

    def get(fn, *args):
        try:
            return fn(*args)
        except Exception as e:  # an API this torch does not have
            return f"n/a ({type(e).__name__})"

    status = {}
    for line in Path("/proc/self/status").read_text().splitlines():
        key, _, value = line.partition(":")
        if key in ("Threads", "VmRSS", "voluntary_ctxt_switches", "nonvoluntary_ctxt_switches"):
            status[key] = value.strip()
    ef = torch._C._dynamo.eval_frame
    return {
        "python_threads": [(t.name, t.daemon) for t in threading.enumerate()],
        "proc_status": status,
        "gc": {"enabled": gc.isenabled(), "count": gc.get_count(),
               "threshold": gc.get_threshold(), "tracked_objects": len(gc.get_objects()),
               "frozen": gc.get_freeze_count(),
               "collections": [g["collections"] for g in gc.get_stats()],
               "callbacks": len(gc.callbacks)},
        "switch_interval": sys.getswitchinterval(),
        "profile_hook": repr(sys.getprofile()), "trace_hook": repr(sys.gettrace()),
        "monitoring_tools": [sys.monitoring.get_tool(i) for i in range(6)],
        "torch_function_stack": get(torch._C._len_torch_function_stack),
        "torch_dispatch_stack": get(torch._C._len_torch_dispatch_stack),
        "tls_include": str(get(torch._C._dispatch_tls_local_include_set)),
        "tls_exclude": str(get(torch._C._dispatch_tls_local_exclude_set)),
        "grad_enabled": torch.is_grad_enabled(),
        "autograd_profiler_enabled": get(torch._C._autograd._profiler_enabled),
        "dynamo_callback": repr(get(ef.get_eval_frame_callback)),
    }


def checkpoint(name: str) -> None:
    entry = {"at": name, "t_s": time.perf_counter(), "micro_us": micro(), "state": state()}
    REPORT["checkpoints"].append(entry)
    m = entry["micro_us"]
    print(f"[probe] {name}: op with current_stream {m['op: current_stream']:.1f} us, with the "
          f"raw stream {m['op: raw stream']:.1f} us, with three Python calls "
          f"{m['op: three python calls']:.1f} us; current_stream direct "
          f"{m['torch.cuda.current_stream direct']:.1f} us; threads "
          f"{len(entry['state']['python_threads'])} Python / "
          f"{entry['state']['proc_status'].get('Threads')} OS", flush=True)


def after(fn, name: str):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        checkpoint(name)
        return out
    return wrapped


def request_setup(bundle, ckpt_root, exp_name):
    """(run_pt2, run_eager) on [export]'s request, its runtime and a float32
    eager model from the same experiment folder."""
    import torch

    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.deployment.runtime import AcousticArtifactRuntime
    from diffsinger_tpu_torch.inference.ds_acoustic import DiffSingerAcousticInfer

    hp = dict(load_config(exp_name=exp_name, infer=True, ckpt_root=ckpt_root),
              infer_precision=None)
    model = chip_smoke.quiet(DiffSingerAcousticInfer, hp, load_vocoder=False,
                             device="cuda").model
    runtime = AcousticArtifactRuntime(bundle, device="cuda")
    tokens, mel2ph, f0 = chip_smoke.export_inputs(*chip_smoke.EXPORT_BUCKETS[0], seed=21)
    noise = torch.randn((1, chip_smoke.EXPORT_BUCKETS[0][1], hp["audio_num_mel_bins"]),
                        generator=torch.Generator(device="cuda").manual_seed(3), device="cuda")
    depth, steps = float(runtime.manifest["max_depth"]), int(runtime.manifest["sampling_steps"])
    run_pt2 = lambda: runtime.synthesize_mel(tokens, mel2ph, f0, noise=noise)
    run_eager = lambda: chip_smoke.eager_dynamic(model, tokens, mel2ph, f0, noise, steps,
                                                 depth).cpu()
    run_pt2(), run_eager()
    return run_pt2, run_eager


def ratio(turns: dict) -> float:
    return turns["mean"]["pt2"] / turns["mean"]["eager"]


def profiled(fn, tag: str) -> list:
    prof = cProfile.Profile()
    prof.enable()
    fn()
    prof.disable()
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("tottime").print_stats(30)
    (OUT / f"probe_pt2_cprofile_{tag}.txt").write_text(text.getvalue())
    return top_functions(prof, 8)


def raw_stream_ptr(t) -> int:
    """The stream handle read from the C++ side in one call, in place of the
    wrappers' ``torch.cuda.current_stream(...).cuda_stream``."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)


@contextlib.contextmanager
def stream_read_raw():
    from diffsinger_tpu_torch.ops import native

    saved = native.stream_ptr
    native.stream_ptr = raw_stream_ptr
    try:
        yield
    finally:
        native.stream_ptr = saved


@contextlib.contextmanager
def collector_off():
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


@contextlib.contextmanager
def noop_profile_hook():
    sys.setprofile(lambda *args: None)
    try:
        yield
    finally:
        sys.setprofile(None)


# a function whose frame holds 256 locals (about 2 KiB of CPython's
# per-thread frame stack, which it takes in chunks)
_PAD_LOCALS = 256
exec("def _pad(n, fn):\n    " + " = ".join(f"v{i}" for i in range(_PAD_LOCALS))
     + " = None\n    return fn() if n == 0 else _pad(n - 1, fn)\n")


def under_pad_frames(k):
    """``fn`` called under ``k`` more frames of :func:`_pad`: the same call
    at another place on the thread's frame stack."""
    def wrap(fn):
        return lambda: _pad(k - 1, fn)
    return wrap


def in_a_new_thread(fn):
    """``fn`` run on a thread of its own (fresh thread-local state)."""
    def run():
        out = []
        t = threading.Thread(target=lambda: out.append(fn()))
        t.start()
        t.join()
        return out[0]
    return run


def same(fn):
    return fn


@contextlib.contextmanager
def without_room():
    """The runtimes' programs and the eager entry points' request loops are
    called directly, not from a frame with room (``utils.frames.with_room``)."""
    from diffsinger_tpu_torch.utils import frames

    saved = frames._roomy
    frames._roomy = lambda: (lambda fn, *args, **kwargs: fn(*args, **kwargs))
    try:
        yield
    finally:
        frames._roomy = saved


# each variant: (context, how the request is called)
VARIANTS = {
    "as is": (contextlib.nullcontext, same),
    "raw stream": (stream_read_raw, same),
    "no-op profile hook": (noop_profile_hook, same),
    "in a new thread": (contextlib.nullcontext, in_a_new_thread),
    "collector off": (collector_off, same),
    **{f"under {k} pad frames": (contextlib.nullcontext, under_pad_frames(k))
       for k in range(1, 9)},
    "without room": (without_room, same),
    **{f"without room, under {k} pad frames": (without_room, under_pad_frames(k))
       for k in range(1, 9)},
    "as is, again": (contextlib.nullcontext, same),
}


def minor_faults() -> int:
    return resource.getrusage(resource.RUSAGE_SELF).ru_minflt


def variants(run_pt2, run_eager, tag: str) -> dict:
    """Turns in each of :data:`VARIANTS`, in that order, with the process's
    minor page faults over one more ``.pt2`` request; cProfile of one
    request each way as the package stands."""
    out = {}
    for name, (context, wrap) in VARIANTS.items():
        if name == "raw stream" and not HAS_RAW:
            continue
        with context():
            out[name] = chip_smoke.export_turns(wrap(run_eager), wrap(run_pt2))
            f0 = minor_faults()
            wrap(run_pt2)()
            out[name]["pt2_minor_faults"] = minor_faults() - f0
        print(f"[probe] {tag}, {name}: .pt2 {out[name]['mean']['pt2'] * 1e3:.1f} ms, eager "
              f"{out[name]['mean']['eager'] * 1e3:.1f} ms, ratio {ratio(out[name]):.3f}; "
              f"{out[name]['pt2_minor_faults']} minor page faults a .pt2 request", flush=True)
    out["cprofile pt2"] = profiled(run_pt2, f"{tag}_pt2")
    out["cprofile eager"] = profiled(run_eager, f"{tag}_eager")
    return out


def fresh_process(bundle, ckpt_root, exp_name, result) -> None:
    """The same from nothing, then after one torch.profiler session."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {"micro_start_us": micro(), "state_start": state()}
    run_pt2, run_eager = request_setup(bundle, ckpt_root, exp_name)
    out["micro_loaded_us"] = micro()
    out["variants"] = variants(run_pt2, run_eager, "fresh")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        run_eager()
        torch.cuda.synchronize()
    out["micro_after_profiler_us"] = micro()
    out["state_after_profiler"] = state()
    out["after_profiler"] = chip_smoke.export_turns(run_eager, run_pt2)
    print(f"[probe] fresh process after one torch.profiler session: ratio "
          f"{ratio(out['after_profiler']):.3f}", flush=True)
    Path(result).write_text(json.dumps(out, default=str))


def probe_export(card, reset_counts, read_counts):
    """In place of [export]: the probe in the state [export] meets."""
    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.deployment.exporters import DiffSingerAcousticExporter

    checkpoint("before [export]")
    root = Path(tempfile.mkdtemp(prefix="probe_export_"))
    hp0 = load_config(ROOT / "configs" / "acoustic.yaml")
    name, _, _ = chip_smoke.write_experiment(root, hp0)
    hp = load_config(exp_name=name, infer=True, ckpt_root=root / "checkpoints")
    exporter = DiffSingerAcousticExporter(hp, root / "acoustic",
                                          buckets=chip_smoke.EXPORT_BUCKETS[:1], fmt="pt2",
                                          device="cuda")
    chip_smoke.quiet(exporter.export)
    del exporter
    run_pt2, run_eager = request_setup(root / "acoustic", root / "checkpoints", name)
    REPORT["export"]["this process"] = variants(run_pt2, run_eager, "long")
    checkpoint("after the variants")
    result = root / "fresh.json"
    child = multiprocessing.get_context("spawn").Process(
        target=fresh_process, args=(str(root / "acoustic"), str(root / "checkpoints"), name,
                                    str(result)))
    child.start()
    child.join(600)
    if child.exitcode != 0:
        child.kill()
    REPORT["export"]["a fresh process"] = (json.loads(result.read_text()) if result.exists()
                                           else f"exit code {child.exitcode}")
    shutil.rmtree(root, ignore_errors=True)
    raise Done


def write() -> None:
    OUT.mkdir(exist_ok=True)
    (OUT / "probe_pt2_host.json").write_text(json.dumps(REPORT, indent=1, default=str))


def frame_stack_demo(depths: int = 600, calls: int = 5000) -> list:
    """CPython's frame stack alone, on the CPU: ``calls`` calls of an empty
    function from a loop run under 0..``depths`` frames of a one-local
    function. Returns (depth, ns a call, minor page faults) for the depth
    with the fewest ns and for every depth with a fault for every other
    call or more, or 10x the fewest ns: where the loop's calls take and
    give back a chunk of their own."""
    def empty():
        return None

    def loop():
        for _ in range(calls):
            empty()

    def pad(n, fn):
        return fn() if n == 0 else pad(n - 1, fn)

    rows = []
    for k in range(depths):
        f0 = minor_faults()
        t0 = time.perf_counter()
        pad(k, loop)
        rows.append((k, (time.perf_counter() - t0) / calls * 1e9, minor_faults() - f0))
    best = min(rows, key=lambda r: r[1])
    return [best] + [r for r in rows if r[2] >= calls // 2 or r[1] >= 10 * best[1]]


def main() -> None:
    if sys.argv[1:] == ["--frame-stack"]:
        for k, ns, faults in frame_stack_demo():
            print(f"[probe] frame stack: under {k} frames, {ns:.0f} ns a call, "
                  f"{faults} minor page faults over the loop")
        return
    import torch

    if not torch.cuda.is_available():
        chip_smoke.fail("CUDA is not available")
    OUT.mkdir(exist_ok=True)
    checkpoint("start")
    chip_smoke.profile_request = after(chip_smoke.profile_request, "after a profile_request")
    for phase in ("serve_phase", "variance_phase", "ddpm_phase"):
        setattr(chip_smoke, phase, after(getattr(chip_smoke, phase), f"after {phase}"))
    chip_smoke.export_phase = probe_export
    try:
        chip_smoke.main()
    except Done:
        pass
    write()
    print(json.dumps({"ok": True}))


if __name__ == "__main__":
    main()
