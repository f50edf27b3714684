"""The WaveNet-DDPM acoustic model (``backbone_type: wavenet``, shallow DDPM,
DDIM) on the CPU at a tiny size, against the benchmark's plain reference
(``benchmark/reference/acoustic_wavenet.py``) on the same seeded weights and
noise: the shallow start and each DDIM step, then the whole
``forward_infer``; and the WaveNet's stack span and frame counter on the
stock route."""

import json
import pathlib

import numpy as np
import pytest
import torch

from benchmark import weights
from benchmark.reference import acoustic_wavenet as ref_mod
from benchmark.reference.common import Ops, pointwise
from diffsinger_tpu_torch.core import ddpm
from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic
from diffsinger_tpu_torch.utils import tracing

REPO = pathlib.Path(__file__).resolve().parents[1]
VOCAB = 50
M = 128
B, T_TXT, T = 2, 16, 96


@pytest.fixture(autouse=True)
def tracing_off():
    tracing.enable(False)
    tracing.counters().clear()
    yield
    tracing.enable(False)
    tracing.counters().clear()


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def tiny_hp() -> dict:
    """The benchmark's configuration at hidden 32, WaveNet 4 x 64, K_step 40,
    speedup 10 (four DDIM steps)."""
    with open(REPO / "benchmark" / "configs" / "acoustic_wavenet.json", encoding="utf-8") as f:
        hp = json.load(f)["hparams"]
    hp.update(hidden_size=32, enc_layers=2, K_step=40, K_step_infer=40, diff_speedup=10,
              infer_precision=None)
    hp["backbone_args"] = dict(num_channels=64, num_layers=4, dilation_cycle_length=4)
    hp["shallow_diffusion_args"] = dict(
        hp["shallow_diffusion_args"],
        aux_decoder_args=dict(num_channels=32, num_layers=2, kernel_size=7, dropout_rate=0.1))
    return hp


@pytest.fixture(scope="module")
def models():
    hp = tiny_hp()
    prog = DiffSingerAcoustic(hp, vocab_size=VOCAB, out_dims=M, device="cpu")
    ref = ref_mod.AcousticWaveNetReference(hp, VOCAB)
    assert sorted(weights.shapes_of(prog.module)) == sorted(weights.shapes_of(ref))
    values = weights.make(weights.shapes_of(ref), 11, "cpu", torch.bfloat16)
    weights.fill(prog.module, values)
    weights.fill(ref, values)
    g = torch.Generator().manual_seed(0)
    tokens = torch.randint(1, VOCAB, (B, T_TXT), generator=g)
    tokens[1, 12:] = 0
    mel2ph = torch.sort(torch.randint(1, 13, (B, T), generator=g), dim=1).values
    mel2ph[1, 80:] = 0
    f0 = 200 + 50 * torch.rand(B, T, generator=g)
    noise = torch.randn(B, T, M, generator=g)
    return hp, prog, ref, (tokens, mel2ph, f0), noise


def test_the_schedule_and_the_shallow_start_are_the_ports(models):
    """The reference's cumulative products are the port's table; its noised
    draft is ``ddpm.q_sample`` at t = K - 1, bit for bit (the same float32
    coefficients)."""
    hp, prog, ref, _, noise = models
    np.testing.assert_array_equal(ref.acp.astype(np.float32), prog.schedule.alphas_cumprod)
    x0 = torch.randn(B, T, M, generator=torch.Generator().manual_seed(3))
    t = torch.full((B,), ref.k_step - 1, dtype=torch.int32)
    assert torch.equal(ref_mod.q_sample(ref.acp, x0, ref.k_step - 1, noise),
                       ddpm.q_sample(prog.schedule, x0, t, noise))


def test_every_ddim_step_follows_the_port(models):
    """The two samplers on one denoiser from the same state: the same steps
    (K - 1) // s * s .. 0, and each state within 1e-6 of the port's (float32
    products and sums: the reference's denoiser is written apart from the
    port's, so the last bits may differ)."""
    hp, prog, ref, (tokens, mel2ph, f0), noise = models
    with torch.no_grad():
        cond = prog.module.encode(tokens, mel2ph, f0)
    net = ref.diffusion.denoise_fn
    ops = Ops()
    projs = [pointwise(ops, layer.conditioner_projection, cond) for layer in net.residual_layers]
    seen = {"ref": [], "prog": []}

    def ref_eps(x, t):
        seen["ref"].append((int(t[0]), x.clone()))
        return net(ops, x, t, projs)

    def prog_eps(x, t):
        seen["prog"].append((int(t[0]), x.clone()))
        return prog.module.denoise(x, t, cond)

    with torch.no_grad():
        got = ddpm.sample_ddim(prog_eps, prog.schedule, noise, ref.k_step, hp["diff_speedup"])
        want = ref_mod.ddim(ref_eps, ref.acp, noise, ref.k_step, hp["diff_speedup"])
    assert [t for t, _ in seen["ref"]] == [30, 20, 10, 0]
    assert [t for t, _ in seen["prog"]] == [30, 20, 10, 0]
    for (_, a), (_, b) in zip(seen["prog"], seen["ref"]):
        assert (a - b).abs().max() <= 1e-6 * max(1.0, b.abs().max())
    assert (got - want).abs().max() <= 1e-6 * max(1.0, want.abs().max())


def test_forward_infer_matches_the_reference(models):
    """The whole inference, float32 on both sides: the encoder, the draft,
    the shallow start, four DDIM steps and the denormalisation. Within 1e-5
    of the mel's largest value: the same bound as the LYNXNet reference's
    test, float32 rounding through two separately written networks."""
    hp, prog, ref, args, noise = models
    want = ref(*args, noise)
    got = prog.forward_infer(*args, noise=noise).diff_out
    assert got.shape == want.shape == (B, T, M)
    assert torch.equal(got[1, 80:], torch.zeros_like(got[1, 80:]))
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


def test_the_stack_span_and_frame_counter_fire_on_the_stock_route(models):
    """On the CPU every WaveNet call takes the stock blocks: each of the four
    DDIM calls adds B x T frames and opens one ``ds.wavenet.stack`` span,
    inside its ``ds.sampler.step``."""
    hp, prog, ref, args, noise = models
    want = prog.forward_infer(*args, noise=noise).diff_out
    tracing.enable(True)
    with torch.profiler.profile() as prof:
        got = prog.forward_infer(*args, noise=noise).diff_out
    tracing.enable(False)
    assert torch.equal(got, want)
    assert tracing.counters() == {"wavenet.stock_blocks": 4 * 4,
                                  "wavenet.stack_frames": 4 * B * T}
    spans = {}
    for e in prof.events():
        if e.name in ("ds.wavenet.stack", "ds.sampler.step"):
            spans.setdefault(e.name, []).append((e.time_range.start, e.time_range.end))
    assert len(spans["ds.wavenet.stack"]) == len(spans["ds.sampler.step"]) == 4
    for s, e in spans["ds.wavenet.stack"]:
        assert any(s0 <= s and e <= e0 for s0, e0 in spans["ds.sampler.step"])
    assert tracing.NAMES[0] == "ds.wavenet.stack"
