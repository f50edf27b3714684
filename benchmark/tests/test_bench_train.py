"""The training cell on the CPU at narrow widths: the store is the
binarizer's layout, a whole run through ``BaseTask.start`` agrees with the
reference to float32 rounding, and every fault a training cell can have,
and the control, come out not correct against the cell's own limits."""

import pickle

import pytest
import torch

from benchmark import faults, generator, harness
from benchmark.drivers import train_acoustic
from benchmark.run import execute
from benchmark.tests import tiny
from benchmark.tests.test_bench_faults import patcher

SEED = 2**31 + 23
TINY_STORE = {"items": 24, "phrase_seconds": [2.0, 4.0]}


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def tiny_train(precision: str = "32-true") -> dict:
    cfg = tiny.config("acoustic")
    cfg["hparams"].update(pl_trainer_precision=precision, max_batch_frames=3000)
    return cfg


def train_run(lowp=None, precision="32-true", seconds=0.1):
    """A whole run at narrow widths, in float32: the CPU's bf16 autocast
    reduces LayerNorm's weight gradients in bf16, which the card does not."""
    mix = dict(generator.load_mix("train_store"), **TINY_STORE)
    return execute("acoustic.train", SEED, seconds, False, torch.device("cpu"),
                   config=tiny_train(precision), mix=mix, lowp=lowp)


def test_store_has_the_binarizers_layout(tmp_path):
    from diffsinger_tpu_torch.data.dataset import AcousticDataset

    mix = dict(generator.load_mix("train_store"), **TINY_STORE)
    cfg = tiny_train()
    run = harness.Run(cell={}, config=cfg, mix=mix, seed=5, seconds=0.1, trace=False,
                      device=torch.device("cpu"), scratch=tmp_path)
    store = train_acoustic.write_store(run)
    ds = AcousticDataset(store, cfg["hparams"], "train")
    assert len(ds) == 24 and len(AcousticDataset(store, cfg["hparams"], "valid")) == 0
    with open(tmp_path / "binary" / "train.meta", "rb") as f:
        meta = pickle.load(f)
    sizes = generator.store_sizes(mix, 512 / 44100)
    assert meta["lengths"] == [s["frames"] for s in sizes]
    batch = ds.collater([ds[i] for i in range(4)])
    assert batch["mel"].shape[-1] == 128 and batch["mel2ph"].shape == batch["f0"].shape
    for i in range(4):
        n = meta["lengths"][i]
        assert (batch["mel2ph"][i, :n] > 0).all() and (batch["mel2ph"][i, n:] == 0).all()
        assert batch["mel2ph"][i, :n].max() == meta["tokens"][i]


def test_a_training_run_through_the_timed_path():
    run = train_run()
    assert run.attempted >= 1 and run.e2e["train_frames_per_s"] > 0
    assert run.layer["true_flops"] > 0 and run.layer["wait_s"] >= 0
    assert [c.name for c in run.checks] == ["loss_gap", "grad_gap", "change_gap"]
    for c in run.checks:
        assert c.value <= 1e-4, c
    assert run.layer["leaves_left_out"] == 0  # every leaf of the model trains


@pytest.mark.parametrize("fault", sorted(faults.TRAINING))
def test_training_fault_is_not_correct(fault, monkeypatch):
    faults.plant(fault, patcher(monkeypatch))
    run = train_run()
    assert run.checks and not all(c.ok for c in run.checks)


def test_training_control_fp8_is_not_correct():
    run = train_run(lowp="fp8")
    assert run.checks and not all(c.ok for c in run.checks)
