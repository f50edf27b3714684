"""The port's training input pipeline on the CPU: ``PrefetchIterator``
against the JAX package's, and the trainer (``cli.train`` on a tiny acoustic
store written by the JAX package's writer) at prefetch depths 0, 1 and 2: the
same batches in the same order and bit-identical parameters, the
``DS_PREFETCH_DEPTH`` override, a collate error raised on the collate thread
reaching the caller with no thread left behind, an exact resume, and the
float16 wire format against float32 (within 5e-3, the JAX package's bound in
``tests/test_precision_and_multihost.py``).
"""

import itertools
import threading
import time

import numpy as np
import pytest
import torch
import yaml

from diffsinger_tpu.utils.prefetch import PrefetchIterator as JaxPrefetchIterator
from diffsinger_tpu_torch.cli import train as cli_train
from diffsinger_tpu_torch.data.dataset import AcousticDataset
from diffsinger_tpu_torch.training import base_task
from diffsinger_tpu_torch.training.base_task import BaseTask
from diffsinger_tpu_torch.utils.prefetch import PrefetchIterator
from tests.test_torch_train_loop import TINY, make_binary
from tests.torch_parity import DICT, REPO

PIPELINE_THREADS = ("ds-collate", "ds-upload")


def pipeline_threads():
    return [t.name for t in threading.enumerate() if t.name in PIPELINE_THREADS and t.is_alive()]


# ------------------------------------------------------------------ PrefetchIterator

@pytest.mark.parametrize("depth", [1, 3])
def test_order_and_chained_stages_match_jax(depth):
    """FIFO order, alone and as two chained stages (the second maps the
    first), as the JAX package's iterator gives them."""
    got, want = [], []
    for cls, out in ((PrefetchIterator, got), (JaxPrefetchIterator, want)):
        out.append(list(cls(range(50), depth)))
        first = cls((i * i for i in range(40)), depth)
        out.append(list(cls(map(lambda v: v + 1, first), depth)))
    assert got == want
    assert got[0] == list(range(50)) and got[1] == [i * i + 1 for i in range(40)]


def test_a_producers_error_is_raised_at_the_consumer():
    """The items before the error arrive, then the producer's exception
    itself, through a chained stage too; the iterator stays ended."""
    def items():
        yield from range(3)
        raise KeyError("item 3")

    for cls in (PrefetchIterator, JaxPrefetchIterator):
        it = cls(map(lambda v: v, cls(items(), 2)), 2)
        seen = []
        with pytest.raises(KeyError, match="item 3"):
            for v in it:
                seen.append(v)
        assert seen == [0, 1, 2]
        with pytest.raises(StopIteration):
            next(it)


def test_close_ends_an_endless_chained_producer():
    """close() of the upstream stage, then the downstream one, ends both
    threads of an endless producer within 5 s, as the trainer closes them."""
    first = PrefetchIterator(itertools.count(), 2, name="ds-collate")
    second = PrefetchIterator(map(lambda v: v, first), 2, name="ds-upload")
    assert [next(second) for _ in range(5)] == list(range(5))
    t0 = time.perf_counter()
    first.close()
    second.close()
    assert time.perf_counter() - t0 < 5.0
    assert not first.is_alive() and not second.is_alive()
    assert list(second) == []


# ------------------------------------------------------------------ the trainer

@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The tiny models train on one intra-op thread: beside other test
    processes, more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("prefetch")
    make_binary(tmp / "binary", n_train=10, seed=3)
    return tmp


def train(store, name, max_steps, **over):
    """``cli.train`` on the CPU with the tiny config (no permanent
    checkpoints, validation only at the end, no figures); returns the task."""
    cfg = dict(TINY, base_config=[str(REPO / "configs" / "acoustic.yaml")],
               binary_data_dir=str(store / "binary"), dictionary=str(DICT),
               val_check_interval=1000, permanent_ckpt_interval=-1, num_valid_plots=0)
    cfg.update(over)
    path = store / f"{name}.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return cli_train.main(["--config", str(path), "--exp_name", name, "--ckpt_root",
                           str(store / "ckpt"), "--device", "cpu", "--max_steps", str(max_steps)])


STEPS = 11  # two epochs and a part of a third


@pytest.fixture(scope="module")
def runs(store):
    """Each depth's batches, readers and final parameters, from one run each."""
    out = {}
    mp = pytest.MonkeyPatch()
    try:
        for depth in (0, 1, 2):
            batches, readers = [], []
            mp.setattr(BaseTask, "next_batch", _recording(BaseTask.next_batch, batches))
            mp.setattr(BaseTask, "epoch_batches", _reading(BaseTask.epoch_batches, readers))
            task = train(store, f"depth{depth}", STEPS, train_prefetch_depth=depth)
            mp.undo()
            out[depth] = dict(batches=batches, readers=readers, epoch=task.epoch,
                              state={k: v.clone() for k, v in task.module.state_dict().items()},
                              threads=pipeline_threads())
    finally:
        mp.undo()
    return out


def _recording(next_batch, out):
    def recording(self, it):
        batch, n_rows, row0 = next_batch(self, it)
        out.append(({k: v.clone() for k, v in batch.items()}, n_rows, row0,
                    self.epoch, self.epoch_position))
        return batch, n_rows, row0
    return recording


def _reading(epoch_batches, out):
    def reading(self, *args, **kwargs):
        for item in epoch_batches(self, *args, **kwargs):
            out.append(threading.current_thread().name)
            yield item
    return reading


def _same_batches(a, b):
    assert len(a) == len(b)
    for (ba, *ra), (bb, *rb) in zip(a, b):
        assert ra == rb and ba.keys() == bb.keys()
        assert all(torch.equal(ba[k], bb[k]) for k in ba)


def _same_state(a, b):
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_every_depth_trains_on_the_same_batches_to_the_same_parameters(runs):
    """Depths 0, 1 and 2 over more than two epochs: the same batches with the
    same place in the stream, bit-identical parameters; at depth 0 the
    items are read on the training thread, else on the collate thread, and
    no pipeline thread outlives the run."""
    _same_batches(runs[1]["batches"], runs[0]["batches"])
    _same_batches(runs[2]["batches"], runs[0]["batches"])
    for depth in (1, 2):
        _same_state(runs[depth]["state"], runs[0]["state"])
    batches = runs[0]["batches"]
    assert len(batches) == STEPS and batches[-1][3] >= 2  # into a third epoch
    assert set(runs[0]["readers"]) == {threading.current_thread().name}
    assert set(runs[1]["readers"]) == set(runs[2]["readers"]) == {"ds-collate"}
    assert all(not r["threads"] for r in runs.values())


def test_the_environment_overrides_the_configs_depth(store, monkeypatch):
    depths = []

    class Spy(PrefetchIterator):
        def __init__(self, it, depth=2, name="ds-prefetch"):
            depths.append((name, depth))
            super().__init__(it, depth, name)

    monkeypatch.setattr(base_task, "PrefetchIterator", Spy)
    assert base_task.prefetch_depth({}) == 1 and base_task.prefetch_depth(
        {"train_prefetch_depth": 3}) == 3
    monkeypatch.setenv("DS_PREFETCH_DEPTH", "2")
    assert base_task.prefetch_depth({"train_prefetch_depth": 3}) == 2
    train(store, "env2", 1, train_prefetch_depth=0)
    assert depths == [("ds-collate", 2), ("ds-upload", 2)]
    monkeypatch.setenv("DS_PREFETCH_DEPTH", "0")
    train(store, "env0", 1, train_prefetch_depth=2)
    assert len(depths) == 2  # inline: no stage


@pytest.mark.parametrize("depth", [0, 1, 2])
def test_a_collate_error_reaches_start_and_no_thread_is_left(store, monkeypatch, depth):
    """The third batch's collation raises (on the collate thread when the
    depth is above 0): start() raises that error, and no pipeline thread is
    alive after it."""
    calls = []
    collater = AcousticDataset.collater

    def failing(self, items, pad_to=None):
        calls.append(threading.current_thread().name)
        if len(calls) == 3:
            raise ValueError("a broken item")
        return collater(self, items, pad_to=pad_to)

    monkeypatch.setattr(AcousticDataset, "collater", failing)
    with pytest.raises(ValueError, match="a broken item"):
        train(store, f"broken{depth}", 6, train_prefetch_depth=depth, num_sanity_val_steps=0)
    assert (calls[2] == "ds-collate") == (depth > 0)
    assert not pipeline_threads()


def test_a_resumed_run_ends_with_the_uninterrupted_runs_parameters(store, runs):
    """Stopped at step 3 (inside the second epoch) and resumed to the end at
    depth 1: the checkpoint holds the place after the last batch trained on,
    and the parameters equal the uninterrupted run's bit for bit."""
    from diffsinger_tpu_torch.utils.ckpt import load_checkpoint

    train(store, "resumed", 3, train_prefetch_depth=1)
    blob = load_checkpoint(store / "ckpt" / "resumed" / "model_ckpt_steps_3.ckpt",
                           category="acoustic")
    place = runs[1]["batches"][2][3:]
    assert (blob["epoch"], blob["epoch_position"]) == place and place[1] > 0
    task = train(store, "resumed", STEPS, train_prefetch_depth=1)
    assert task.global_step == STEPS and task.epoch == runs[1]["epoch"]
    _same_state(task.module.state_dict(), runs[1]["state"])


def test_float16_wire_tracks_float32(store, runs):
    """train_wire_dtype float16: the float32 arrays cross as float16 and come
    back as float32 on the device; the parameters track the float32 run's
    within 5e-3, and differ from them (the wire format was used)."""
    sent = []
    stream = BaseTask.batch_stream

    def recording(self, *args):
        for item in stream(self, *args):
            sent.append({k: v.dtype for k, v in item[0].items() if isinstance(v, np.ndarray)})
            yield item

    mp = pytest.MonkeyPatch()
    mp.setattr(BaseTask, "batch_stream", recording)
    try:
        task = train(store, "wire16", STEPS, train_prefetch_depth=1, train_wire_dtype="float16")
    finally:
        mp.undo()
    assert sent and all(d["mel"] == np.float16 and d["f0"] == np.float16
                        and d["tokens"] == np.int32 for d in sent)
    want = runs[1]["state"]
    got = task.module.state_dict()
    assert max((got[k].float() - want[k].float()).abs().max().item() for k in want) <= 5e-3
    assert any(not torch.equal(got[k], want[k]) for k in want)
