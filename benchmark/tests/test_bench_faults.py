"""Whole runs on the CPU at narrow widths with the timed path broken
underneath, each against the cell's own limits: every fault a serving cell
can have, and the control (the reference one precision down in the
program's place), has to come out not correct, and the sound run correct.
One chip: no exchange between chips to leave out."""

import pytest
import torch

from benchmark import faults, generator
from benchmark.run import execute
from benchmark.tests import tiny
from benchmark.tests.test_bench_reference import TINY_MIX

SEED = 2**31 + 11
CELLS = {"acoustic.render": ("acoustic", "render_songs"),
         "variance.predict": ("variance", "score_songs")}


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def correct(cell: str, lowp=None, device="cpu") -> bool:
    """A run with short songs; on the CPU at narrow widths, on the card at
    the cell's own; either way against the cell's own limits."""
    config_name, mix_name = CELLS[cell]
    mix = dict(generator.load_mix(mix_name), **TINY_MIX)
    config = tiny.config(config_name) if device == "cpu" else None
    run = execute(cell, SEED, 0.1, False, torch.device(device), config=config, mix=mix, lowp=lowp)
    return bool(run.checks) and all(c.ok for c in run.checks)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct(cell):
    assert correct(cell)


def patcher(monkeypatch):
    def set_(target, name, value):
        if isinstance(target, dict):
            monkeypatch.setitem(target, name, value)
        else:
            monkeypatch.setattr(target, name, value)
    return set_


@pytest.mark.parametrize("fault", sorted(faults.SERVING))
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    faults.plant(fault, patcher(monkeypatch))
    assert not correct(cell)


def test_patches_undo_in_reverse():
    box = {"a": 1}

    class Obj:
        b = 2
    p = faults.Patches()
    p.set(box, "a", 10)
    p.set(Obj, "b", 20)
    p.set(box, "a", 100)
    assert box["a"] == 100 and Obj.b == 20
    p.undo()
    assert box == {"a": 1} and Obj.b == 2


def test_control_fp8_is_not_correct():
    """The acoustic cell's control: the reference in fp8 products in place of the program."""
    assert not correct("acoustic.render", lowp="fp8")


@pytest.mark.cuda
@pytest.mark.parametrize("cell,lowp", [("acoustic.render", "fp8"), ("variance.predict", "tf32")])
def test_control_on_the_card_is_not_correct(cell, lowp):
    """Each cell's control at its own widths on the card (TF32 exists only there)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    assert not correct(cell, lowp=lowp, device="cuda")
    assert correct(cell, device="cuda")
