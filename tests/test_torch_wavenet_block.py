"""K4, the fused WaveNet residual block: its plain version against the stock
block on the CPU, the route between them, its counters, and on the card the
kernels against the stock ops (``python -m pytest
tests/test_torch_wavenet_block.py -q -m cuda --noconftest`` there)."""

import math
import pathlib
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffsinger_tpu_torch.models.backbones import precompute_cond_projections
from diffsinger_tpu_torch.models.backbones.lynxnet import pointwise_conv
from diffsinger_tpu_torch.models.backbones.wavenet import ResidualBlock, WaveNet
from diffsinger_tpu_torch.models.commons import resolve_remat_policy
from diffsinger_tpu_torch.ops import wavenet_block
from diffsinger_tpu_torch.utils import no_tf32, tracing

REPO = pathlib.Path(__file__).resolve().parents[1]


def stock_forward(block, x, conditioner, diffusion_step, cond_proj=None):
    """``ResidualBlock.forward`` as the stock ops wrote it before K4."""
    y = x + block.diffusion_projection(diffusion_step)[:, None, :]
    y = F.conv1d(y.transpose(1, 2), block.dilated_conv.weight, block.dilated_conv.bias,
                 padding=block.dilation, dilation=block.dilation).transpose(1, 2)
    if cond_proj is None:
        cond_proj = pointwise_conv(block.conditioner_projection, conditioner)
    gate, filt = (y + cond_proj).chunk(2, dim=-1)
    y = pointwise_conv(block.output_projection, torch.sigmoid(gate) * torch.tanh(filt))
    residual, skip = y.chunk(2, dim=-1)
    return (x + residual) / math.sqrt(2.0), skip


def _block_inputs(c, dilation, t, b=2, cond_dims=24, seed=0, device="cpu"):
    torch.manual_seed(seed)
    block = ResidualBlock(cond_dims, c, dilation).to(device)
    with torch.no_grad():
        for p in block.parameters():
            p.add_(0.05 * torch.randn_like(p))
    g = torch.Generator(device=device).manual_seed(seed + 1)
    x = torch.randn(b, t, c, generator=g, device=device)
    cond = torch.randn(b, t, cond_dims, generator=g, device=device)
    step = torch.randn(b, c, generator=g, device=device)
    return block, x, cond, step


def _weights(block):
    return (block.dilated_conv.weight, block.dilated_conv.bias, block.output_projection.weight,
            block.output_projection.bias, block.dilation)


def _stack_weights(block):
    """A block's weights as the stack takes them, for a stack of one."""
    return ([block.diffusion_projection.weight], [block.diffusion_projection.bias],
            *([w] for w in _weights(block)))


@pytest.fixture
def counting():
    tracing.enable(True)
    tracing.counters().clear()
    yield tracing.counters()
    tracing.enable(False)
    tracing.counters().clear()


# ------------------------------------------------------------------ the CPU


@pytest.mark.parametrize("t", [3, 37, 300])
@pytest.mark.parametrize("dilation", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("c", [16, 192, 256])
def test_plain_block_equals_the_stock_block_bitwise(c, dilation, t):
    block, x, cond, step = _block_inputs(c, dilation, t)
    with torch.no_grad():
        cond_proj = pointwise_conv(block.conditioner_projection, cond)
        want_x, want_skip = stock_forward(block, x, cond, step, cond_proj)
        d = block.diffusion_projection(step)
        got_x, got_skip = wavenet_block.wavenet_block_plain(x, d, cond_proj, *_weights(block))
        assert torch.equal(got_x, want_x) and torch.equal(got_skip, want_skip)
        # the module takes the stock ops, with and without the hoisting
        for cp in (cond_proj, None):
            got_x, got_skip = block(x, cond, step, cp)
            assert torch.equal(got_x, want_x) and torch.equal(got_skip, want_skip)
        # the stack of one block on the CPU is the plain version
        got_sum = wavenet_block.residual_stack(x, step, cond_proj[None], *_stack_weights(block))
        assert torch.equal(got_sum, torch.zeros_like(x) + want_skip)


@pytest.mark.parametrize("case", ["cpu", "grad", "grad_input", "compiling"])
def test_route_takes_the_stock_ops(case, monkeypatch):
    """Training (a gradient wanted of the weights or the input),
    ``torch.compile`` and the CPU take the stock blocks."""
    net = _small_wavenet()[0]
    x = types.SimpleNamespace(is_cuda=True, requires_grad=False)
    net.requires_grad_(case == "grad")
    with torch.no_grad():
        assert net.on_k4(x)  # a card's tensor at inference
    if case == "cpu":
        x = torch.zeros(2, 50, 64)
    elif case == "grad_input":
        x.requires_grad = True
    elif case == "compiling":
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with torch.enable_grad() if case.startswith("grad") else torch.no_grad():
        assert not net.on_k4(x)


@pytest.mark.parametrize("case", ["card", "card_grad_off", "exporting"])
def test_route_takes_k4(case, monkeypatch):
    """A card's tensor where no gradient is wanted takes K4, whatever its
    dtype and width (the wrapper raises on what the kernels do not take);
    ``torch.export`` records K4's operator, on any device."""
    net = _small_wavenet()[0]
    x = types.SimpleNamespace(is_cuda=True, requires_grad=False)
    if case == "exporting":
        x = torch.zeros(2, 50, 64, requires_grad=True)
        monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    if case == "card":
        with torch.no_grad():
            assert net.on_k4(x)
    else:
        net.requires_grad_(False)
        with torch.enable_grad():
            assert net.on_k4(x)


def _small_wavenet(seed=0, layers=4, c=64):
    torch.manual_seed(seed)
    net = WaveNet(in_dims=8, n_feats=1, cond_dims=32, num_layers=layers, num_channels=c,
                  dilation_cycle_length=3)
    with torch.no_grad():
        for p in net.parameters():
            p.add_(0.05 * torch.randn_like(p))
    g = torch.Generator().manual_seed(seed + 1)
    spec = torch.randn(2, 50, 8, generator=g)
    cond = torch.randn(2, 50, 32, generator=g)
    t = torch.tensor([0.3, 0.7])
    return net, spec, t, cond


@pytest.mark.parametrize("route", ["stock", "fused"])
def test_counters_count_the_block_calls(route, counting, monkeypatch):
    """Each WaveNet call counts its blocks once, on its route. On the CPU the
    fused route (forced here) runs the plain stack, which is the stock
    route's arithmetic: the same numbers, bit for bit."""
    net, spec, t, cond = _small_wavenet()
    with torch.no_grad():
        proj = precompute_cond_projections(net, cond)
        want = net(spec, t, cond, cond_proj=proj)
        assert counting == {"wavenet.stock_blocks": 4, "wavenet.stack_frames": 2 * 50}
        counting.clear()
        if route == "fused":
            monkeypatch.setattr(WaveNet, "on_k4", lambda self, x: True)
        got = net(spec, t, cond, cond_proj=proj)
        unhoisted = net(spec, t, cond)  # without the hoisting: the route projects the condition
    blocks = "wavenet.stock_blocks" if route == "stock" else "wavenet.fused_blocks"
    assert counting == {blocks: 8, "wavenet.stack_frames": 2 * 2 * 50}
    assert torch.equal(got, want) and torch.equal(unhoisted, want)


def test_remat_counts_a_training_call_once(counting):
    """Under ``remat`` a block is computed again on the backward pass; the
    stock count is of the WaveNet's calls, so it does not move with it."""
    net, spec, t, cond = _small_wavenet()
    net.remat = resolve_remat_policy(True)
    net(spec, t, cond).square().sum().backward()
    assert counting == {"wavenet.stock_blocks": 4, "wavenet.stack_frames": 2 * 50}


def test_counters_stay_off_while_tracing_is_off():
    tracing.counters().clear()
    net, spec, t, cond = _small_wavenet()
    with torch.no_grad():
        net(spec, t, cond)
    assert tracing.counters() == {}


def test_step_projections_are_made_again_after_an_in_place_write():
    net, _, _, _ = _small_wavenet()
    layers = net.residual_layers
    w = [layer.diffusion_projection.weight for layer in layers]
    b = [layer.diffusion_projection.bias for layer in layers]
    step = torch.randn(2, 64)
    with torch.no_grad():
        want = torch.stack([layer.diffusion_projection(step) for layer in layers], dim=1)
        torch.testing.assert_close(wavenet_block.step_projections(step, w, b), want)
        w[2].mul_(2.0)
        want = torch.stack([layer.diffusion_projection(step) for layer in layers], dim=1)
        torch.testing.assert_close(wavenet_block.step_projections(step, w, b), want)


# ------------------------------------------------------------------ the card


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _stack(c, t, b, dilations, device, seed=0):
    """Blocks of one WaveNet's dilations, their weights by kind, and inputs."""
    blocks = [_block_inputs(c, dil, t, b=b, device=device, seed=seed + i)[0]
              for i, dil in enumerate(dilations)]
    _, x, cond, step = _block_inputs(c, 1, t, b=b, device=device, seed=seed)
    with torch.no_grad():
        cond_proj = torch.stack([pointwise_conv(k.conditioner_projection, cond) for k in blocks])
    # by kind: diffusion weights and biases, conv's, output's, the dilations
    weights = [[w for one in kind for w in one] for kind in zip(*map(_stack_weights, blocks))]
    return x, step, cond_proj, weights


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["float16", "width", "strided"])
def test_wrapper_raises_on_what_the_kernels_do_not_take(dev, case):
    c = 96 if case == "width" else 64
    x, step, cond_proj, weights = _stack(c, 40, 2, (1, 2), dev)
    if case == "float16":
        x, step, cond_proj = x.half(), step.half(), cond_proj.half()
        weights = [[w.half() for w in ws] for ws in weights[:6]] + weights[6:]
    elif case == "strided":
        x = x.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises((TypeError, ValueError)):
        wavenet_block.residual_stack(x, step, cond_proj, *weights)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c", [(16, 37, 256), (16, 512, 256), (16, 861, 256),
                                   (16, 1024, 256), (16, 861, 192), (3, 100, 512)])
def test_fused_blocks_against_the_stock_blocks(dev, b, t, c):
    """A block of each dilation of the pitch WaveNet's cycle, one after
    another, and one block alone: the skip sums within 1e-4 (float32 sums in
    another order)."""
    for dilations in ((1, 2, 4, 8, 16), (16,)):
        x, step, cond_proj, weights = _stack(c, t, b, dilations, dev)
        x[0, -1] = 100.0  # must reach no frame of row 1
        with torch.no_grad(), no_tf32():
            want = wavenet_block.residual_stack_plain(x, step, cond_proj, *weights)
            n = wavenet_block.launches
            got = wavenet_block.residual_stack(x, step, cond_proj, *weights)
            torch.cuda.synchronize()
        assert wavenet_block.launches == n + 2 * len(dilations)
        err = (got - want).abs().max().item()
        assert err <= 1e-4, (dilations, err)


@pytest.mark.cuda
@pytest.mark.parametrize("dilations", [(1, 2, 4, 8), (1, 2, 4, 8) * 5],
                         ids=["cycle", "published_stack"])
def test_the_acoustic_wavenet_width_from_bfloat16_values(dev, dilations):
    """The WaveNet acoustic model's blocks (512 channels, dilation cycle 4) at
    [16, 861, 512], one cycle and the whole published stack of 20: inputs and
    weights rounded to bfloat16, as a bf16 model holds them. The bfloat16
    call is the float32 call on the same values, rounded (K4 computes a bf16
    stack in float32), and the float32 call is within 1e-4 of the stock ops
    (float32 sums in another order)."""
    x, step, cond_proj, weights = _stack(512, 861, 16, dilations, dev)
    bf = torch.bfloat16
    x, step, cond_proj = x.to(bf), step.to(bf), cond_proj.to(bf)
    weights = [[w.to(bf) for w in ws] for ws in weights[:6]] + weights[6:]
    as_f32 = [[w.float() for w in ws] for ws in weights[:6]] + weights[6:]
    with torch.no_grad(), no_tf32():
        want = wavenet_block.residual_stack_plain(x.float(), step.float(), cond_proj.float(),
                                                  *as_f32)
        n = wavenet_block.launches
        got32 = wavenet_block.residual_stack(x.float(), step.float(), cond_proj.float(),
                                             *as_f32)
        got = wavenet_block.residual_stack(x, step, cond_proj, *weights)
        torch.cuda.synchronize()
    assert wavenet_block.launches == n + 2 * 2 * len(dilations)
    assert got.dtype == bf and torch.equal(got, got32.to(bf))
    err = (got32 - want).abs().max().item()
    assert err <= 1e-4, err


@pytest.mark.cuda
def test_a_bfloat16_stack_is_computed_in_float32(dev):
    """bfloat16 inputs and weights: the kernels in float32 from them, the
    skip sum rounded to bfloat16, within one bfloat16 step of the float32
    plain stack's largest output."""
    x, step, cond_proj, weights = _stack(256, 861, 16, (1, 2, 4, 8, 16), dev)
    bf = torch.bfloat16
    x, step, cond_proj = x.to(bf), step.to(bf), cond_proj.to(bf)
    weights = [[w.to(bf) for w in ws] for ws in weights[:6]] + weights[6:]
    with torch.no_grad(), no_tf32():
        want = wavenet_block.residual_stack_plain(
            x.float(), step.float(), cond_proj.float(),
            *([w.float() for w in ws] for ws in weights[:6]), *weights[6:])
        got = wavenet_block.residual_stack(x, step, cond_proj, *weights)
        again = wavenet_block.residual_stack(x, step, cond_proj, *weights)  # the kept copy
    assert got.dtype == bf and torch.equal(got, again)
    assert (got.float() - want).abs().max().item() <= 2 ** -7 * want.abs().max().item()


@pytest.mark.cuda
def test_pitch_sampling_on_the_fused_blocks_against_the_stock_ops(dev, monkeypatch, counting):
    """The published variance model (pitch WaveNet 20 x 256) predicts the pitch
    of 16 phrases of 861 frames in 20 euler steps: on the fused blocks and on
    the stock ops, the same weights and noise, |pitch gap| <= 1e-5 semitones."""
    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.models.toplevel import DiffSingerVariance

    hp = load_config(REPO / "configs" / "variance.yaml")
    assert hp["sampling_steps"] == 20
    torch.manual_seed(0)
    model = DiffSingerVariance(hp, vocab_size=60, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():  # the zero-initialised output projections would mute the sampler
        for name, p in model.module.named_parameters():
            if name.endswith("output_projection.weight") or name.endswith(".bias"):
                p.add_(0.05 * torch.randn(p.shape, generator=g, device=dev))
    rng = np.random.default_rng(2)
    b, t_ph, t_s = 16, 96, 861
    tokens = torch.from_numpy(rng.integers(1, 60, (b, t_ph))).to(dev)
    ph2word = torch.arange(1, t_ph + 1, device=dev).div(2, rounding_mode="floor").add(1)
    ph2word = ph2word[None].repeat(b, 1)
    args = (tokens, torch.full((b, t_ph), 60, device=dev), ph2word,
            60 + torch.randn(b, 1, device=dev).repeat(1, t_s))
    kw = dict(word_dur=torch.full((b, t_ph), t_s // t_ph, device=dev),
              pitch_expr=torch.rand(b, t_s, device=dev),
              noise_pitch=torch.randn(b, t_s, 64, device=dev))
    n = wavenet_block.launches
    _, fused, _ = model.forward_infer(*args, **kw)
    torch.cuda.synchronize()
    assert wavenet_block.launches == n + 2 * 20 * 20
    assert counting.get("wavenet.stock_blocks", 0) == 0
    monkeypatch.setattr(WaveNet, "on_k4", lambda self, x: False)
    _, stock, _ = model.forward_infer(*args, **kw)
    assert counting["wavenet.stock_blocks"] == 400 and counting["wavenet.fused_blocks"] == 400
    assert torch.isfinite(fused).all()
    gap = (fused.double() - stock.double()).abs().max().item()
    assert gap <= 1e-5, gap


def _perturb_output_projections(module, dev):
    """The zero-initialised output projections would mute the samplers."""
    g = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():
        for name, p in module.named_parameters():
            if name.endswith("output_projection.weight") or name.endswith(".bias"):
                p.add_(0.05 * torch.randn(p.shape, generator=g, device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("family,core,algorithm", [
    ("variance", "reflow", "euler"), ("variance", "reflow", "rk2"), ("variance", "reflow", "rk4"),
    ("variance", "reflow", "rk5"), ("variance", "ddpm", "ddpm"), ("variance", "ddpm", "ddim"),
    ("variance", "ddpm", "pndm"), ("variance", "ddpm", "dpm-solver"),
    ("variance", "ddpm", "unipc"), ("acoustic", "reflow", "euler"), ("acoustic", "ddpm", "ddim"),
])
def test_every_sampler_runs_the_wavenets_on_k4(dev, monkeypatch, counting, family, core,
                                               algorithm):
    """Reduced float32 models on the card, each WaveNet 64 wide: the variance
    model's pitch and multi-variance WaveNets, or an acoustic model with
    ``backbone_type: wavenet``, under each sampler. Every block runs on K4,
    and the outputs agree with the stock ops' on the same weights and draws
    within 1e-3."""
    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic, DiffSingerVariance

    wavenet = dict(num_channels=64, dilation_cycle_length=2)
    if family == "variance":
        hp = load_config(REPO / "configs" / "variance.yaml")
        hp.update(hidden_size=64, enc_layers=2, sampling_steps=4, predict_energy=True,
                  predict_breathiness=True)
        for key, layers in (("pitch_prediction_args", 4), ("variances_prediction_args", 2)):
            hp[key] = dict(hp[key], backbone_args=dict(hp[key]["backbone_args"],
                                                       num_layers=layers, **wavenet))
    else:
        hp = load_config(REPO / "configs" / "acoustic.yaml")
        hp.update(hidden_size=64, enc_layers=2, sampling_steps=4, backbone_type="wavenet",
                  backbone_args=dict(num_layers=4, **wavenet))
    if core == "ddpm":
        hp.update(diffusion_type="ddpm", timesteps=100, K_step=100, K_step_infer=100,
                  diff_accelerator=algorithm, diff_speedup=1 if algorithm == "ddpm" else 10)
    else:
        hp.update(sampling_algorithm=algorithm)
    torch.manual_seed(0)
    rng = np.random.default_rng(2)
    b, t_ph, t_s = 2, 16, 96
    tokens = torch.from_numpy(rng.integers(1, 40, (b, t_ph))).to(dev)
    if family == "variance":
        model = DiffSingerVariance(hp, vocab_size=40, device=dev)
        ph2word = torch.arange(1, t_ph + 1, device=dev).div(2, rounding_mode="floor").add(1)
        args = (tokens, torch.full((b, t_ph), 60, device=dev), ph2word[None].repeat(b, 1),
                60 + torch.randn(b, 1, device=dev).repeat(1, t_s))
        kw = dict(word_dur=torch.full((b, t_ph), 2 * t_s // t_ph, device=dev),
                  pitch_expr=torch.rand(b, t_s, device=dev),
                  noise_pitch=torch.randn(b, t_s, 64, device=dev),
                  noise_variances=torch.randn(b, t_s, 48, device=dev))
    else:
        model = DiffSingerAcoustic(hp, vocab_size=40, out_dims=hp["audio_num_mel_bins"],
                                   dtype=torch.float32, device=dev)
        mel2ph = torch.arange(t_s, device=dev).div(t_s // t_ph, rounding_mode="floor").add(1)
        args = (tokens, mel2ph[None].repeat(b, 1), 200 + 20 * torch.rand(b, t_s, device=dev))
        kw = dict(noise=torch.randn(b, t_s, hp["audio_num_mel_bins"], device=dev))
    _perturb_output_projections(model.module, dev)

    def run():
        out = model.forward_infer(*args, generator=torch.Generator(device=dev).manual_seed(5),
                                  **kw)
        if family == "acoustic":
            return [out.diff_out]
        _, pitch, curves = out
        return [pitch, *curves.values()]

    n = wavenet_block.launches
    fused = run()
    torch.cuda.synchronize()
    assert counting.get("wavenet.stock_blocks", 0) == 0
    assert counting["wavenet.fused_blocks"] > 0
    assert wavenet_block.launches > n
    monkeypatch.setattr(WaveNet, "on_k4", lambda self, x: False)
    stock = run()
    assert counting["wavenet.stock_blocks"] == counting["wavenet.fused_blocks"]
    for got, want in zip(fused, stock):
        assert torch.isfinite(got).all()
        assert (got - want).abs().max().item() <= 1e-3
