"""The four-rank training cell on the CPU at narrow widths, over gloo: a
whole run through ``BaseTask.start`` on four processes agrees with the
reference over the global batch to float32 rounding, a fault comes out not
correct, and the exposed NCCL time and its reader count what they should."""

import os
import types

import pytest
import torch

from benchmark import faults, generator, harness
from benchmark.drivers import train_acoustic_ddp
from benchmark.run import execute
from benchmark.tests.test_bench_faults import patcher
from benchmark.tests.test_bench_train import tiny_train

CELL = "acoustic.train_ddp4"
SEED = 2**31 + 41
TINY_STORE = {"items": 48, "phrase_seconds": [2.0, 4.0]}

needs_four = pytest.mark.skipif((os.cpu_count() or 1) < 4,
                                reason="four ranks need four CPU cores")


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def ddp_run(lowp=None):
    mix = dict(generator.load_mix("train_store_ddp4"), **TINY_STORE)
    return execute(CELL, SEED, 0.1, False, torch.device("cpu"), config=tiny_train(), mix=mix,
                   lowp=lowp)


@needs_four
def test_four_ranks_through_the_timed_path():
    run = ddp_run()
    assert run.layer["ranks"] == 4
    assert run.attempted >= 1 and run.e2e["train_frames_per_s"] > 0
    assert [c.name for c in run.checks] == ["loss_gap", "grad_gap", "change_gap"]
    for c in run.checks:
        assert c.value <= 1e-4, c
    assert run.layer["leaves_left_out"] == 0
    for k in ("DS_COORDINATOR_ADDRESS", "DS_NUM_PROCESSES", "DS_PROCESS_ID"):
        assert k not in os.environ
    assert not torch.distributed.is_initialized()


@needs_four
def test_a_fault_on_rank_zero_is_not_correct(monkeypatch):
    """The fault is planted in this process before the ranks start; the
    spawned ranks import the port anew, so only rank 0 carries it: its
    optimizer never steps, and the weights it reports never move."""
    faults.plant("update_skipped", patcher(monkeypatch))
    run = ddp_run()
    assert run.checks and not all(c.ok for c in run.checks)


class Event:
    def __init__(self, name, start, end, device=True, annotation=False):
        self._name, self._start, self._end = name, start, end
        self._annotation = annotation
        self._type = (torch.autograd.DeviceType.CUDA if device
                      else torch.autograd.DeviceType.CPU)

    def name(self):
        return self._name

    def is_user_annotation(self):
        return self._annotation

    def device_type(self):
        return self._type

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start


def test_exposed_nccl_time_is_what_no_other_kernel_covers():
    events = [Event("bench.window", 100, 1100, device=False),
              # host ranges drawn on the device's timeline: not kernels
              Event("bench.window", 100, 1100, annotation=True),
              Event("DistributedDataParallel.forward", 100, 1100, annotation=True),
              Event("nccl:all_reduce", 600, 900, annotation=True),
              Event("gemm", 50, 300), Event("ncclDevKernel_AllReduce", 200, 500),
              Event("elementwise", 400, 450), Event("Memcpy HtoD", 450, 700),
              Event("ncclDevKernel_AllReduce", 900, 1200), Event("gemm", 1000, 1050)]
    seconds, kernels = train_acoustic_ddp.nccl_exposed(events)
    # NCCL 200-500 and 900-1100 in the window; others 100-300, 400-450, 1000-1050
    assert kernels == 2
    assert seconds == pytest.approx((300 - 100 - 50 + 200 - 50) / 1e9)


@pytest.mark.parametrize("layer,want", [
    ({"trace": {"window_s": 30.0}, "nccl_exposed_s": 1.5, "nccl_kernels": 10}, 5.0),
    ({"trace": {"window_s": 30.0}, "nccl_exposed_s": 0.0, "nccl_kernels": 0}, None),
    ({"trace": {}, "nccl_exposed_s": 1.5, "nccl_kernels": 10}, None),
    ({}, None),
])
def test_reader(layer, want):
    got = harness.read_metrics(["nccl_exposed_share.train"], layer)
    assert got.get("nccl_exposed_share.train", {}).get("value") == want


@pytest.mark.parametrize("rank", [0, 1])
def test_every_rank_reads_rank_zeros_verdict_two_updates_late(monkeypatch, rank):
    """Rank 0 says the window is full at the third update; every rank reads
    that at the fifth, and waits then for every verdict still on its way.
    A rank past the time on its own clock offers no verdict of its own."""
    import collections

    import torch.distributed as tdist

    sent, waited = [], []

    class Work:
        def __init__(self, n):
            self.n = n

        def wait(self):
            waited.append(self.n)

    def all_reduce(flag, op=None, group=None, async_op=False):
        assert async_op
        sent.append(float(flag))
        flag.fill_(float(len(sent) >= 3))  # rank 0's verdict from the third update on
        return Work(len(sent))
    monkeypatch.setattr(tdist, "all_reduce", all_reduce)
    monkeypatch.setattr(tdist, "get_rank", lambda: rank)
    loop = types.SimpleNamespace(window_start=0.0, run=types.SimpleNamespace(seconds=0.0),
                                 flags=None, verdicts=collections.deque())
    full = [train_acoustic_ddp.RankLoop.window_full(loop) for _ in range(5)]
    assert full == [False, False, False, False, True]
    assert sent == [float(rank == 0)] * 5
    assert waited == [1, 2, 3, 4, 5] and not loop.verdicts
