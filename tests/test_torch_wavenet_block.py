"""K4, the fused WaveNet residual block: its plain versions against the stock
block on the CPU, the routes between them, its counters, and on the card the
kernels against the plain versions and the stock ops (``python -m pytest
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
from diffsinger_tpu_torch.ops import native, wavenet_block
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", ["stock", "fused"])
def test_counters_count_the_block_calls(route, dtype, counting, monkeypatch):
    """Each WaveNet call counts its blocks once, on its route; a bfloat16
    model's fused blocks are tensor-core blocks too. On the CPU the fused
    route (forced here) runs the plain stack, which is the stock route's
    arithmetic: the same numbers, bit for bit."""
    net, spec, t, cond = _small_wavenet()
    net.to(dtype)
    with torch.no_grad():
        proj = precompute_cond_projections(net, cond.to(dtype))
        want = net(spec, t, cond, cond_proj=proj)
        assert counting == {"wavenet.stock_blocks": 4, "wavenet.stack_frames": 2 * 50}
        counting.clear()
        if route == "fused":
            monkeypatch.setattr(WaveNet, "on_k4", lambda self, x: True)
        got = net(spec, t, cond, cond_proj=proj)
        unhoisted = net(spec, t, cond)  # without the hoisting: the route projects the condition
    blocks = {"wavenet.stock_blocks": 8} if route == "stock" else {"wavenet.fused_blocks": 8}
    if route == "fused" and dtype == torch.bfloat16:
        blocks["wavenet.tc_blocks"] = 8
    assert counting == {**blocks, "wavenet.stack_frames": 2 * 2 * 50}
    assert torch.equal(got, want) and torch.equal(unhoisted, want)


def test_remat_counts_a_training_call_once(counting):
    """Under ``remat`` a block is computed again on the backward pass; the
    stock count is of the WaveNet's calls, so it does not move with it."""
    net, spec, t, cond = _small_wavenet()
    net.remat = resolve_remat_policy(True)
    net(spec, t, cond).square().sum().backward()
    assert counting == {"wavenet.stock_blocks": 4, "wavenet.stack_frames": 2 * 50}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("route", ["stock", "fused"])
def test_counters_stay_off_while_tracing_is_off(route, dtype, monkeypatch):
    tracing.counters().clear()
    net, spec, t, cond = _small_wavenet()
    net.to(dtype)
    if route == "fused":
        monkeypatch.setattr(WaveNet, "on_k4", lambda self, x: True)
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


def _rounded_stack(c, t, b, dilations, seed=0, device="cpu"):
    """A stack's inputs and weights rounded to bfloat16, as a bf16 model holds
    them, and the same values in float32."""
    x, step, cond_proj, weights = _stack(c, t, b, dilations, device, seed=seed)
    bf = torch.bfloat16
    x, step, cond_proj = x.to(bf), step.to(bf), cond_proj.to(bf)
    weights = [[w.to(bf) for w in ws] for ws in weights[:6]] + weights[6:]
    as_f32 = ([x.float(), step.float(), cond_proj.float()]
              + [[w.float() for w in ws] for ws in weights[:6]] + weights[6:])
    return [x, step, cond_proj, *weights], as_f32


# The bfloat16 route rounds x + d and z to bfloat16 (a relative step of 2^-8)
# at every block and its result once; the float32 stack rounds nothing. Those
# roundings, carried through 20 blocks' products, leave the skip sums within
# two bfloat16 steps of the float32 stack's largest entry.
BF16_ROUTE_TOL = 2 ** -7


@pytest.mark.parametrize("c,t,dilations", [
    (64, 37, (1, 2, 4, 8)), (192, 50, (1, 2, 4, 8) * 5), (256, 20, (16, 1))])
def test_bf16_plain_stack_against_the_float32_stack(c, t, dilations):
    args, as_f32 = _rounded_stack(c, t, 2, dilations)
    with torch.no_grad():
        want = wavenet_block.residual_stack_plain(*as_f32)
        got = wavenet_block.residual_stack_bf16_plain(*args)
    assert got.dtype == torch.bfloat16
    err = (got.float() - want).abs().max().item()
    assert 0 < err <= BF16_ROUTE_TOL * want.abs().max().item(), err


class FakeLibrary:
    """K4's C functions, recording their calls instead of launching."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("ds_wavenet_"):
            raise AttributeError(name)
        return lambda *args: self.calls.append((name, args)) or 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_kernels_are_picked_by_dtype(dtype, monkeypatch):
    """bfloat16 x launches the tensor-core kernels, float32 x the float32
    ones, two a block, after the same checks; the bfloat16 route updates x
    in place and writes each next x + d over the last."""
    lib = FakeLibrary()
    monkeypatch.setattr(native, "load", lambda name: lib)
    monkeypatch.setattr(native, "stream_ptr", lambda t: 0)
    dilations = (1, 2, 4)
    x, step, cond_proj, weights = _stack(64, 30, 2, dilations, "cpu")
    x, step, cond_proj = x.to(dtype), step.to(dtype), cond_proj.to(dtype)
    weights = [[w.to(dtype) for w in ws] for ws in weights[:6]] + weights[6:]
    n = wavenet_block.launches
    got = wavenet_block._launch_stack(x, step, cond_proj, *weights)
    assert got.dtype == dtype and got.shape == x.shape
    assert wavenet_block.launches == n + 2 * len(dilations)
    suffix = "_bf16" if dtype == torch.bfloat16 else ""
    names = [name for name, _ in lib.calls]
    assert names == [f"ds_wavenet_{k}{suffix}" for k in ("conv_gate", "out_skip")] * 3
    assert [args[8] for name, args in lib.calls if "conv_gate" in name] == list(dilations)
    out_skip = [args for name, args in lib.calls if "out_skip" in name]
    assert [args[6] for args in out_skip] == [1, 0, 0]  # the first block writes the skip sum
    assert out_skip[-1][8] is None and out_skip[-1][9] is None  # no next block
    if dtype == torch.bfloat16:
        conv_gate = [args for name, args in lib.calls if "conv_gate" in name]
        assert all(args[3] == args[4] for args in out_skip)  # x in place
        assert {args[9] for args in out_skip[:-1]} == {conv_gate[0][0]}  # one x + d buffer
    else:
        assert len({args[4] for args in out_skip}) == 2  # x', in turns


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_the_kernels_weights_layouts(dtype):
    """float32: k-major [3C, 2C] (row tap * C + ci) and [C, 2C]; bfloat16:
    [2C, 3C] and [2C, C] with k contiguous and float32 biases."""
    c = 64
    x, _, _, weights = _stack(c, 10, 1, (1, 2), "cpu")
    conv_ws, conv_bs, out_ws, out_bs = ([w.to(dtype) for w in ws] for ws in weights[2:6])
    if dtype == torch.bfloat16:
        w_conv, w_out, b_conv, b_out = wavenet_block._tc_weights(
            x.to(dtype), conv_ws, conv_bs, out_ws, out_bs)
        assert w_conv[1].shape == (2 * c, 3 * c) and w_conv[1].dtype == dtype
        for tap in range(3):
            assert torch.equal(w_conv[1][:, tap * c:(tap + 1) * c], conv_ws[1][:, :, tap])
        assert torch.equal(w_out[1], out_ws[1][:, :, 0])
        assert b_conv[1].dtype == torch.float32 and torch.equal(b_out[1], out_bs[1].float())
    else:
        w_conv, w_out, b_conv, b_out = wavenet_block._kernel_weights(
            x, conv_ws, conv_bs, out_ws, out_bs)
        for tap in range(3):
            assert torch.equal(w_conv[1][tap * c:(tap + 1) * c], conv_ws[1][:, :, tap].t())
        assert torch.equal(w_out[1], out_ws[1][:, :, 0].t())
        assert torch.equal(b_conv[1], conv_bs[1])
    assert all(w.is_contiguous() for w in (*w_conv, *w_out))


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
@pytest.mark.parametrize("case", ["float16", "width", "width_bf16", "strided"])
def test_wrapper_raises_on_what_the_kernels_do_not_take(dev, case):
    c = 96 if case.startswith("width") else 64
    x, step, cond_proj, weights = _stack(c, 40, 2, (1, 2), dev)
    if case == "width_bf16":
        x, step, cond_proj = (v.bfloat16() for v in (x, step, cond_proj))
        weights = [[w.bfloat16() for w in ws] for ws in weights[:6]] + weights[6:]
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


# The kernels and their plain counterpart round the same values to bfloat16 at
# the same places, from float32 sums taken in another order: a value that lies
# within that difference of a rounding boundary is rounded a step apart, the
# step moves later values across other boundaries, and after a few blocks the
# two carry unrelated rounding errors of the same size. Each is within
# BF16_ROUTE_TOL of the float32 stack, so the two are within twice that.
BF16_KERNEL_TOL = 2 * BF16_ROUTE_TOL


def _check_bf16_route(got, plain, stock, want):
    """The tensor-core stack ``got`` against its plain counterpart, within the
    plain route's tolerance of the float32 stack ``want``, and no further from
    it than the stock bfloat16 blocks."""
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    scale = want.abs().max().item()
    err_plain = (got.float() - plain.float()).abs().max().item()
    assert err_plain <= BF16_KERNEL_TOL * scale, err_plain
    err, err_stock = ((y.float() - want).abs().max().item() for y in (got, stock))
    assert err <= BF16_ROUTE_TOL * scale and err <= err_stock, (err, err_stock)


def _bf16_route(args, as_f32):
    """The tensor-core stack, its plain counterpart, the stock bfloat16 blocks
    and the float32 stack on the same values (TF32 off)."""
    with torch.no_grad(), no_tf32():
        n = wavenet_block.launches
        got = wavenet_block.residual_stack(*args)
        torch.cuda.synchronize()
        assert wavenet_block.launches == n + 2 * len(args[-1])
        return (got, wavenet_block.residual_stack_bf16_plain(*args),
                wavenet_block.residual_stack_plain(*args),
                wavenet_block.residual_stack_plain(*as_f32))


@pytest.mark.cuda
@pytest.mark.parametrize("dilations", [(1, 2, 4, 8), (1, 2, 4, 8) * 5],
                         ids=["cycle", "published_stack"])
def test_the_acoustic_wavenet_width_from_bfloat16_values(dev, dilations):
    """The WaveNet acoustic model's blocks (512 channels, dilation cycle 4) at
    [16, 861, 512], one cycle and the whole published stack of 20: inputs and
    weights rounded to bfloat16, as a bf16 model holds them. The bfloat16
    call runs on the tensor cores (``_check_bf16_route``); the float32 call
    on the same values is within 1e-4 of the stock ops (float32 sums in
    another order)."""
    args, as_f32 = _rounded_stack(512, 861, 16, dilations, device=dev)
    got, plain, stock, want = _bf16_route(args, as_f32)
    _check_bf16_route(got, plain, stock, want)
    with torch.no_grad(), no_tf32():
        got32 = wavenet_block.residual_stack(*as_f32)
    err = (got32 - want).abs().max().item()
    assert err <= 1e-4, err


@pytest.mark.cuda
def test_a_bfloat16_stack_at_the_pitch_width_on_the_tensor_cores(dev):
    """bfloat16 inputs and weights at the pitch WaveNet's width: products from
    bfloat16 operands summed in float32, x and the skip sum carried in
    float32 (``_check_bf16_route``); a second call on the kept weights gives
    the same bits."""
    args, as_f32 = _rounded_stack(256, 861, 16, (1, 2, 4, 8, 16), device=dev)
    got, plain, stock, want = _bf16_route(args, as_f32)
    _check_bf16_route(got, plain, stock, want)
    with torch.no_grad():
        again = wavenet_block.residual_stack(*args)  # the kept copy
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,c,dilations", [
    (1, 173, 512, (1, 2, 4, 8)),  # a ragged T, B = 1
    (3, 300, 192, (1, 2, 4, 8, 16)),  # widths that are not a multiple of 128
    (2, 120, 64, (1, 2)),
    (2, 300, 256, (1, 130, 2)),  # a dilation longer than the frame tiles
])
def test_the_tensor_core_kernels_at_other_shapes(dev, b, t, c, dilations):
    """Ragged frame counts, narrow widths and long dilations; a large value
    in row 0's last frame changes no other row."""
    args, as_f32 = _rounded_stack(c, t, b, dilations, device=dev)
    got, plain, stock, want = _bf16_route(args, as_f32)
    _check_bf16_route(got, plain, stock, want)
    if b > 1:  # the kernels read no other row: the rows after the first, bit for bit
        args[0][0, -1] = 100.0
        with torch.no_grad():
            assert torch.equal(wavenet_block.residual_stack(*args)[1:], got[1:])


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
    assert "wavenet.tc_blocks" not in counting  # float32: the CUDA cores' kernels
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
