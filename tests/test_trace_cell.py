"""``tools/trace_cell.py`` on made-up profiles: the program's span echoes on
the device's timeline leave the benchmark's reduction as it is, the program
pass charges kernels and idle gaps to the innermost open span, the six
numbers read from it are left out where their spans are missing, and a run
that goes round the tool's wrappers is refused."""

import sys
from pathlib import Path

import pytest
import torch

from benchmark import trace as bench_trace

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "tools"))
import trace_cell  # noqa: E402

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU
RANGES = ("vocoder", "server.enqueue", "server.request")


class Event:
    """The accessors of a kineto event that the reductions read."""

    def __init__(self, name, device, start, end, corr=0, link=0):
        self._v = (name, device, start, end, corr, link)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3] - self._v[2]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]


def profile():
    """A window of 1000 ns: a request, a chunk's enqueue with its model, two
    sampler steps and the vocoder, kernels on two streams, a copy back."""
    return [
        Event(bench_trace.WINDOW, CPU, 0, 1000),
        Event("server.request", CPU, 0, 1000),
        Event("server.enqueue", CPU, 100, 300),
        Event("ds.server.enqueue", CPU, 100, 300),
        Event("ds.model.sample", CPU, 105, 150),
        Event("ds.sampler.step", CPU, 105, 125),
        Event("ds.sampler.step", CPU, 125, 150),
        Event("vocoder", CPU, 150, 300),
        Event("ds.vocoder", CPU, 150, 300),
        Event("ds.server.fetch", CPU, 550, 960),
        Event("aten::mm", CPU, 110, 120, corr=1),
        Event("aten::add", CPU, 130, 140, corr=3),
        Event("aten::conv1d", CPU, 160, 170, corr=2),
        Event("cudaLaunchKernel", CPU, 180, 185, corr=77),
        Event("gemm", CUDA, 200, 400, corr=11, link=1),
        Event("conv", CUDA, 350, 500, corr=12, link=2),
        Event("add", CUDA, 520, 540, corr=13, link=3),
        Event("elementwise", CUDA, 600, 650, corr=77, link=999),
        Event("Memcpy DtoH (Device -> Pinned)", CUDA, 900, 950),
        Event("vocoder", CUDA, 200, 500),  # the benchmark's range drawn on the device
    ]


ECHOES = [  # the program's spans drawn on the device: no work
    Event("ds.server.enqueue", CUDA, 200, 700),
    Event("ds.sampler.step", CUDA, 500, 560),
    Event("ds.vocoder", CUDA, 350, 660),
]


ORIGINAL_REDUCE = bench_trace.reduce


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The narrow run takes one intra-op thread: beside other test processes
    more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def patched(monkeypatch):
    """The tool's wrappers of the benchmark, undone after the test."""
    monkeypatch.setattr(bench_trace, "reduce", ORIGINAL_REDUCE)
    monkeypatch.setattr(bench_trace, "Tracer", bench_trace.Tracer)
    monkeypatch.setattr(trace_cell, "STATE", {"program": False})
    trace_cell.patch_benchmark()
    trace_cell.patch_benchmark()  # once only: a second call wraps nothing again
    return trace_cell.STATE


def test_the_spans_echoes_leave_the_benchmarks_reduction_as_it_is(patched):
    want = ORIGINAL_REDUCE(profile(), RANGES)
    got = bench_trace.reduce(profile() + ECHOES, RANGES)
    for key in ("window_s", "busy_s", "device_s", "device_ops", "idle_gaps", "links"):
        assert got[key] == want[key], key
    assert patched["echoes"] == len(ECHOES)
    # read as work, the echoes would fill the device's gaps
    assert ORIGINAL_REDUCE(profile() + ECHOES, RANGES)["busy_s"] > want["busy_s"]


def test_the_program_pass_charges_kernels_and_gaps_to_the_innermost_span():
    """Busy 200-500, 520-540, 600-650, 900-950 of a 1000 ns window. The gaps
    at 0, 500 and 540 open in no span, those at 650 and 950 in the fetch.
    gemm and add launch in the two sampler steps, conv and the runtime's
    elementwise in the vocoder; all four in the enqueue."""
    got = trace_cell.program_pass(profile() + ECHOES, RANGES)
    ns = pytest.approx
    assert got["window_s"] == ns(1000e-9) and got["busy_s"] == ns(420e-9)
    assert got["idle_s"] == ns(580e-9) and got["idle_in_no_span_s"] == ns(280e-9)
    sp = got["spans"]
    assert set(sp) == {"ds.sampler.step", "ds.model.sample", "ds.vocoder", "ds.server.enqueue",
                       "ds.server.fetch"}
    assert sp["ds.sampler.step"] == {"host_s": ns(45e-9), "count": 2, "kernels": 2,
                                     "device_s": ns(220e-9), "idle_s": 0.0}
    assert sp["ds.model.sample"]["kernels"] == 2 and sp["ds.vocoder"]["kernels"] == 2
    assert sp["ds.vocoder"]["device_s"] == ns(200e-9)
    assert sp["ds.server.enqueue"]["kernels"] == 4
    assert sp["ds.server.enqueue"]["device_s"] == ns(420e-9)
    assert sp["ds.server.fetch"] == {"host_s": ns(410e-9), "count": 1, "kernels": 0,
                                     "device_s": 0.0, "idle_s": ns(300e-9)}
    assert sum(s["idle_s"] for s in sp.values()) + got["idle_in_no_span_s"] == ns(got["idle_s"])
    assert trace_cell.program_pass([Event("aten::mm", CPU, 0, 1)], RANGES) == {}


def test_the_six_numbers_and_none_without_their_spans():
    serving = trace_cell.span_metrics(trace_cell.program_pass(profile(), RANGES), {}, {}, {})
    assert serving == pytest.approx({"sampler_host_ms_per_step.infer": 45e-9 / 2 * 1e3,
                                     "sampler_kernels_per_step.infer": 1.0,
                                     "server_host_ms_per_chunk.infer": 410e-9 * 1e3})
    span = {"host_s": 0.5, "count": 10, "kernels": 40, "device_s": 0.2, "idle_s": 0.1}
    program = {"spans": {"ds.train.forward": span, "ds.lynx.bwd": span}}
    counters = {"pipeline.ds-collate.cpu_s": 3.0, "pipeline.ds-upload.cpu_s": 1.5}
    training = trace_cell.span_metrics(program, counters, {"window_s": 30.0},
                                       {"train_frames_per_s": 1e5})
    assert training == pytest.approx({"forward_host_ms_per_step.train": 50.0,
                                      "pipeline_cpu_share.train": 15.0,
                                      "lynxnet_bwd_ms_per_kframe.train": 0.2 / 3e6 * 1e6})
    assert trace_cell.span_metrics({}, {}, {}, {}) == {}
    assert trace_cell.span_metrics({"spans": {}}, {}, {"window_s": 30.0},
                                   {"train_frames_per_s": 1e5}) == {}


def test_runs_in_one_process_follow_their_own_switch(monkeypatch):
    """Two narrow runs of the render cell on the CPU, the spans off then on:
    only the second reads spans; the benchmark's numbers come in both."""
    from benchmark import generator
    from benchmark.tests import tiny

    monkeypatch.setattr(bench_trace, "reduce", ORIGINAL_REDUCE)
    monkeypatch.setattr(bench_trace, "Tracer", bench_trace.Tracer)
    mix = dict(generator.load_mix("render_songs"), phrases_per_song=[2, 2],
               phrase_seconds=[2.0, 3.0], songs_in_plan=1, reference_phrases=2)
    lines = [trace_cell.run_once("acoustic.render", 2**31 + 5, 0.1, True, program,
                                 torch.device("cpu"), config=tiny.config("acoustic"), mix=mix)
             for program in (False, True)]
    for line in lines:
        assert line["correct"] and "padded_share.infer" in line["metrics"]
    assert lines[0]["program_pass"]["spans"] == {} and lines[0]["span_metrics"] == {}
    assert lines[1]["program_pass"]["spans"]["ds.sampler.step"]["count"] > 0
    assert set(lines[1]["span_metrics"]) == {"sampler_host_ms_per_step.infer",
                                            "sampler_kernels_per_step.infer",
                                            "server_host_ms_per_chunk.infer"}


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_that_goes_round_the_wrappers_is_refused(patched, monkeypatch, trace):
    """A benchmark that binds its tracer or reduction at import would leave
    the wrappers unread: the run stops instead of reporting no spans."""
    from benchmark import run as bench_run

    def execute(workload, seed, seconds, trace, device, **kwargs):
        if trace:  # the tracer went through the wrapper, the reduction did not
            patched["counters"] = {}
        return None

    monkeypatch.setattr(bench_run, "execute", execute)
    with pytest.raises(RuntimeError, match="wrappers saw nothing"):
        trace_cell.run_once("acoustic.render", 1, 0.1, trace, True, torch.device("cpu"))
