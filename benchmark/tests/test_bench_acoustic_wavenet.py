"""The WaveNet-DDPM render cell on the CPU at narrow widths: a whole run
through the timed path agrees with the reference to float32 rounding, a
traced run counts the stacks' frames and works out their least time, the
serving faults that reach its sampler and the control come out not
correct, and the two readers it adds read what they should."""

import copy
import json

import pytest
import torch

from benchmark import faults, generator, harness, work, work_wavenet
from benchmark.run import execute
from benchmark.tests.test_bench_faults import patcher
from benchmark.tests.test_bench_reference import TINY_MIX

CELL = "acoustic_wavenet.render"
SEED = 2**31 + 29


@pytest.fixture(autouse=True)
def one_thread():
    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)


def tiny_config() -> dict:
    """The configuration at hidden 32, a WaveNet 4 x 64, float32; K_step 400
    and speedup 10 as published (40 DDIM calls from a start that is mostly
    noise, so a sampler that does nothing shows)."""
    with open(harness.HERE / "configs" / "acoustic_wavenet.json", encoding="utf-8") as f:
        cfg = copy.deepcopy(json.load(f))
    hp = cfg["hparams"]
    hp.update(hidden_size=32, enc_layers=2, infer_precision=None)
    hp["backbone_args"] = dict(hp["backbone_args"], num_channels=64, num_layers=4)
    hp["shallow_diffusion_args"] = dict(
        hp["shallow_diffusion_args"],
        aux_decoder_args=dict(num_channels=32, num_layers=2, kernel_size=7, dropout_rate=0.1))
    cfg["vocoder"] = dict(cfg["vocoder"], upsample_initial_channel=32)
    cfg["precision"] = "float32"
    return cfg


def wavenet_run(trace=False, lowp=None):
    mix = dict(generator.load_mix("render_songs_wavenet"), **TINY_MIX)
    return execute(CELL, SEED, 0.1, trace, torch.device("cpu"), config=tiny_config(), mix=mix,
                   lowp=lowp)


def correct(run) -> bool:
    return bool(run.checks) and all(c.ok for c in run.checks)


def test_a_run_through_the_timed_path():
    run = wavenet_run()
    assert run.attempted >= 1 and run.e2e["song_s_per_s"] > 0
    assert [c.name for c in run.checks] == ["wav_rel_rms"]
    for c in run.checks:
        assert c.value <= 1e-4, c
    assert run.layer["true_flops"] > 0


def test_a_traced_run_counts_the_stacks():
    """Tracing is on for the window only; every frame of every chunk goes
    through the stack 40 times (40 DDIM calls), on the CPU's stock
    route; the least time comes from those counts."""
    from diffsinger_tpu_torch.utils import tracing

    run = wavenet_run(trace=True)
    assert not tracing.enabled()
    counts = run.layer["counts"]
    program = counts["program"]
    assert program["wavenet.stack_frames"] == 40 * counts["padded_frames"] > 0
    assert program["wavenet.stock_blocks"] > 0 and "wavenet.fused_blocks" not in program
    calls = program["wavenet.stock_blocks"] / 4
    assert run.layer["wavenet_least_s"] == work_wavenet.stack_least_seconds(
        program["wavenet.stack_frames"], calls, 64, 4)
    assert correct(run)


@pytest.mark.parametrize("fault", ["half_the_batch", "answer_altered"])
def test_fault_is_not_correct(fault, monkeypatch):
    faults.plant(fault, patcher(monkeypatch))
    assert not correct(wavenet_run())


def test_a_stuck_ddim_sampler_is_not_correct(monkeypatch):
    """``faults.step_unchanged`` patches the euler step, which this cell
    does not take: the DDIM sampler returning its start stands for it."""
    from diffsinger_tpu_torch.core import ddpm

    monkeypatch.setattr(ddpm, "sample_ddim", lambda fn, sched, x, t_max, interval: x)
    assert not correct(wavenet_run())


def test_control_fp8_is_not_correct():
    assert not correct(wavenet_run(lowp="fp8"))


def test_work_of_the_published_widths():
    """40 calls; a block's products 2 x 3 x 512 x 1024 + 2 x 512 x 1024 a
    frame; the stack's bound is its FLOPs at 989 TFLOP/s (the bytes take
    about a seventh of that time)."""
    with open(harness.HERE / "configs" / "acoustic_wavenet.json", encoding="utf-8") as f:
        hp = json.load(f)["hparams"]
    assert work_wavenet.ddim_calls(hp) == 40
    assert work_wavenet.stack_tc_flops(1, 512, 20) == 20 * (3145728 + 1048576)
    least = work_wavenet.stack_least_seconds(1e6, 100, 512, 20)
    assert least == work_wavenet.stack_tc_flops(1e6, 512, 20) / work.PEAKS["bf16"]
    assert work_wavenet.stack_bytes(1e6, 100, 512, 20) / work.HBM_BYTES_PER_S < least / 5
    one = work_wavenet.acoustic(1, 40, 1000, hp)
    assert one > 40 * work.wavenet_call(1, 1000, 128, hp["backbone_args"])


@pytest.mark.parametrize("name,layer,want", [
    ("wavenet_roofline.infer", {"trace": {"device_s": {"ds.wavenet.stack": 2.0}},
                                "wavenet_least_s": 0.5}, 25.0),
    ("wavenet_roofline.infer", {"trace": {"device_s": {}}, "wavenet_least_s": 0.5}, None),
    ("wavenet_roofline.infer", {"trace": {"device_s": {"ds.wavenet.stack": 2.0}},
                                "wavenet_least_s": 0.0}, None),
    ("wavenet_roofline.infer", {}, None),
    ("sampler_ms_per_song_s.infer", {"trace": {"device_s": {"ds.model.sample": 3.0}},
                                     "song_s": 1500.0}, 2.0),
    ("sampler_ms_per_song_s.infer", {"trace": {"device_s": {}}, "song_s": 1500.0}, None),
    ("sampler_ms_per_song_s.infer", {}, None),
])
def test_readers(name, layer, want):
    """Each reads its span's device time; where the program has no such span
    or counter (a checkout before them) it reads nothing and does not raise."""
    got = harness.read_metrics([name], layer)
    assert (got[name]["value"] if name in got else None) == want
