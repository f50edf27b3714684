"""The port's CUDA kernels against their plain versions, on the card.

These need an NVIDIA card with ``nvcc`` (sm_90a) and skip elsewhere. On a
machine without JAX, skip tests/conftest.py (it sets JAX up):
``python -m pytest tests/test_torch_cuda.py -q -m cuda --noconftest``. Each
wrapper must launch its kernel (its launch counter moves) and agree with the
plain version: float32 within 1e-4 (summation order), bf16 within one or two
bf16 ulps of the largest output.
"""

import pytest
import torch

from diffsinger_tpu_torch.ops import depthwise_conv, flash_attention, lynx_fused, wavenet_block

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _max_err(a, b):
    return (a.float() - b.float()).abs().max().item()


@pytest.mark.parametrize("dtype,b,t,c,k,with_bias", [
    (torch.float32, 2, 100, 96, 31, True),
    (torch.bfloat16, 2, 64, 96, 7, True),
    (torch.bfloat16, 3, 333, 2048, 31, True),   # T ragged against every tile
    (torch.bfloat16, 5, 77, 160, 7, True),      # C a multiple of 32 and of nothing larger
    (torch.bfloat16, 1, 17, 64, 31, True),      # T shorter than the halo
    (torch.float32, 2, 100, 100, 4, False),     # even k: pads 2 left, 1 right; C % 8 != 0
    (torch.bfloat16, 2, 50, 64, 61, True),      # the largest k: the generic kernel
    (torch.bfloat16, 2, 50, 64, 1, True),       # a single tap
    (torch.float32, 2, 300, 2048, 31, True),    # the float32 slice's width, two tiles and a rest
])
def test_k1_kernel(dev, dtype, b, t, c, k, with_bias):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn(b, t, c, generator=g, device=dev).to(dtype)
    x[0, -1] = 100.0  # must not leak into the first rows of sequence 1
    w = (0.2 * torch.randn(c, k, generator=g, device=dev)).to(dtype)
    alpha = torch.full((c,), 0.25, device=dev, dtype=dtype)
    bias = (0.1 * torch.randn(c, generator=g, device=dev)).to(dtype) if with_bias else None
    n = depthwise_conv.launches
    got = depthwise_conv.depthwise_conv1d_prelu(x, w, alpha, bias)
    torch.cuda.synchronize()
    assert depthwise_conv.launches == n + 1
    want = depthwise_conv.depthwise_conv1d_prelu_plain(x, w, alpha, bias)

    def tol(ref):
        return 1e-4 if dtype == torch.float32 else 2 ** -7 * ref.float().abs().max().item()

    assert _max_err(got, want) <= tol(want)
    if b > 1:  # the later sequences against a tolerance of their own
        assert _max_err(got[1:], want[1:]) <= tol(want[1:])


def test_k1_every_tile_choice_agrees(dev):
    """The C function at each tile length and several spans, not only the
    wrapper's choice: T = 333 leaves a ragged last tile and a ragged last span."""
    from diffsinger_tpu_torch.ops import native

    g = torch.Generator(device=dev).manual_seed(4)
    b, t, c, k = 2, 333, 160, 31
    x = torch.randn(b, t, c, generator=g, device=dev).bfloat16()
    x[0, -1] = 100.0
    w = (0.2 * torch.randn(c, k, generator=g, device=dev)).bfloat16()
    alpha = torch.full((c,), 0.25, device=dev).bfloat16()
    want = depthwise_conv.depthwise_conv1d_prelu_plain(x, w, alpha)
    lib = native.load("depthwise_conv")
    for rows in (0, *depthwise_conv.TILE_ROWS):
        for span in (1, 2, 100):
            out = torch.full_like(x, float("nan"))
            native.check(lib.ds_dwconv_prelu(
                x.data_ptr(), w.data_ptr(), None, alpha.data_ptr(), out.data_ptr(), b, t, c, k,
                1, rows, span, 0, native.stream_ptr(x)), "depthwise_conv1d_prelu")
            torch.cuda.synchronize()
            assert _max_err(out, want) <= 2 ** -7 * want[1:].float().abs().max().item(), (rows, span)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_kernel(dev, dtype):
    from diffsinger_tpu_torch.models.backbones.lynxnet import LYNXConvModule

    torch.manual_seed(0)
    mod = LYNXConvModule(64, 2, 31).to(dev, dtype)
    with torch.no_grad():
        for p in mod.parameters():
            p.add_(0.1 * torch.randn_like(p))
    x = torch.randn(3, 77, 64, device=dev).to(dtype)
    args = lynx_fused.conv_module_params_from_module(mod)
    n = lynx_fused.launches
    got = lynx_fused.fused_conv_module(x, **args)
    assert lynx_fused.launches == n + 1
    want = lynx_fused.fused_conv_module_plain(x, **args)
    tol = 1e-4 if dtype == torch.float32 else 2 ** -6 * want.float().abs().max().item()
    assert _max_err(got, want) <= tol


def _k2_case(dev, b, t, c, inner, k, dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)

    def rnd(*shape, scale=1.0, shift=0.0):
        return (shift + scale * torch.randn(shape, generator=g, device=dev)).to(dtype)

    args = dict(ln_scale=rnd(c, scale=0.2, shift=1.0), ln_bias=rnd(c, scale=0.1),
                w1=rnd(2 * inner, c, scale=c ** -0.5), b1=rnd(2 * inner, scale=0.1),
                dw_w=rnd(inner, k, scale=0.2), dw_b=rnd(inner, scale=0.1),
                alpha=rnd(inner, scale=0.1, shift=0.25),
                w2=rnd(c, inner, scale=inner ** -0.5), b2=rnd(c, scale=0.1))
    return rnd(b, t, c), args


@pytest.mark.parametrize("b,t,c,inner,k", [
    (3, 333, 1024, 2048, 31),  # rows not a multiple of the 128-row tile
    (5, 77, 96, 160, 7),       # widths that are multiples of 32 and of nothing larger
    (1, 1, 32, 32, 3),         # a single row, a single k step
])
def test_k2_kernel_bf16_ragged(dev, b, t, c, inner, k):
    x, args = _k2_case(dev, b, t, c, inner, k, torch.bfloat16)
    n = lynx_fused.launches
    got = lynx_fused.fused_conv_module(x, **args)
    torch.cuda.synchronize()
    assert lynx_fused.launches == n + 1
    want = lynx_fused.fused_conv_module_plain(x, **args)
    assert _max_err(got, want) <= 2 ** -6 * want.float().abs().max().item()


def test_k2_bf16_raises_on_a_width_that_is_not_a_multiple_of_32(dev):
    for c, inner in ((48, 96), (64, 80)):
        x, args = _k2_case(dev, 1, 8, c, inner, 3, torch.bfloat16)
        with pytest.raises(ValueError):
            lynx_fused.fused_conv_module(x, **args)


@pytest.mark.parametrize("b,length,d", [(4, 200, 128), (2, 513, 64), (40, 130, 32)])
def test_k3_kernel_ragged_length_without_a_mask(dev, b, length, d):
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn(b, 2, length, d, generator=g, device=dev) for _ in range(3))
    n = flash_attention.launches
    got = flash_attention.flash_attention(q, k, v)
    assert flash_attention.launches == n + 1
    assert _max_err(got, flash_attention.flash_attention_plain(q, k, v)) <= 1e-4


def test_k3_kernel_row_that_sees_nothing_in_its_first_key_tiles(dev):
    # only the last rows are padded: a padded query sees no key of the first
    # tiles, so its running max stays -inf until the last one
    g = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(2, 2, 300, 128, generator=g, device=dev) for _ in range(3))
    pad = torch.zeros(2, 300, dtype=torch.bool, device=dev)
    pad[0, 290:] = True
    pad[1, 299:] = True
    got = flash_attention.flash_attention(q, k, v, pad)
    assert torch.isfinite(got).all()
    assert _max_err(got, flash_attention.flash_attention_plain(q, k, v, pad)) <= 1e-4


@pytest.mark.parametrize("d,length", [(128, 128), (64, 70)])
def test_k3_kernel(dev, d, length):
    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = (torch.randn(2, 2, length, d, generator=g, device=dev) for _ in range(3))
    pad = torch.zeros(2, length, dtype=torch.bool, device=dev)
    pad[1, length // 2:] = True
    n = flash_attention.launches
    got = flash_attention.flash_attention(q, k, v, pad)
    assert flash_attention.launches == n + 1
    assert _max_err(got, flash_attention.flash_attention_plain(q, k, v, pad)) <= 1e-4


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = torch.randn(1, 8, 48, device=dev)  # C = 48 is not a multiple of 32
    mod_args = dict(ln_scale=torch.ones(48, device=dev), ln_bias=torch.zeros(48, device=dev),
                    w1=torch.zeros(192, 48, device=dev), b1=torch.zeros(192, device=dev),
                    dw_w=torch.zeros(96, 3, device=dev), dw_b=torch.zeros(96, device=dev),
                    alpha=torch.zeros(96, device=dev), w2=torch.zeros(48, 96, device=dev),
                    b2=torch.zeros(48, device=dev))
    with pytest.raises(ValueError):
        lynx_fused.fused_conv_module(x, **mod_args)
    with pytest.raises(TypeError):
        depthwise_conv.depthwise_conv1d_prelu(x.double(), torch.zeros(48, 3, device=dev).double(),
                                              torch.zeros(48, device=dev).double())
    q = torch.randn(1, 1, 8, 48, device=dev)
    with pytest.raises(ValueError):
        flash_attention.flash_attention(q, q, q)


# ---------------------------------------------------------------- LYNXNet's other activations
# K1's epilogue is built once for each activation; K2 passes it on. SiLU and
# ReLU take no slopes (alpha None). Tolerances as above: float32 1e-3 (the
# kernel's __expf against torch's exp), bf16 one ulp of the largest output
# for K1, two for K2.

@pytest.mark.parametrize("activation", ["SiLU", "ReLU"])
@pytest.mark.parametrize("dtype,b,t,c,k", [
    (torch.float32, 2, 100, 96, 31),
    (torch.bfloat16, 16, 1024, 2048, 31),  # the main path's shape
    (torch.bfloat16, 3, 333, 2048, 31),    # T ragged against every tile
    (torch.bfloat16, 2, 64, 96, 7),
    (torch.bfloat16, 1, 17, 64, 31),       # T shorter than the halo
    (torch.float32, 2, 100, 100, 4),       # even k, C % 8 != 0: the generic kernel
    (torch.bfloat16, 2, 50, 64, 61),       # the largest k: the generic kernel
])
def test_k1_kernel_activations(dev, activation, dtype, b, t, c, k):
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(b, t, c, generator=g, device=dev).to(dtype)
    x[0, -1] = 100.0  # must not leak into the first rows of sequence 1
    w = (0.2 * torch.randn(c, k, generator=g, device=dev)).to(dtype)
    bias = (0.1 * torch.randn(c, generator=g, device=dev)).to(dtype)
    n = depthwise_conv.launches
    got = depthwise_conv.depthwise_conv1d_prelu(x, w, None, bias, activation)
    torch.cuda.synchronize()
    assert depthwise_conv.launches == n + 1
    want = depthwise_conv.depthwise_conv1d_prelu_plain(x, w, None, bias, activation)
    assert (want < 0).any() == (activation == "SiLU")

    def tol(ref):
        return 1e-3 if dtype == torch.float32 else 2 ** -7 * ref.float().abs().max().item()

    assert _max_err(got, want) <= tol(want)
    if b > 1:
        assert _max_err(got[1:], want[1:]) <= tol(want[1:])


@pytest.mark.parametrize("activation", ["SiLU", "ReLU"])
@pytest.mark.parametrize("dtype,b,t,c,inner,k", [
    (torch.float32, 2, 100, 64, 128, 31),
    (torch.bfloat16, 16, 1024, 1024, 2048, 31),  # the main path's shape
    (torch.bfloat16, 3, 333, 1024, 2048, 31),
    (torch.bfloat16, 5, 77, 96, 160, 7),
])
def test_k2_kernel_activations(dev, activation, dtype, b, t, c, inner, k):
    x, args = _k2_case(dev, b, t, c, inner, k, dtype, seed=2)
    args["alpha"] = None
    n = lynx_fused.launches
    got = lynx_fused.fused_conv_module(x, **args, activation=activation)
    torch.cuda.synchronize()
    assert lynx_fused.launches == n + 1
    want = lynx_fused.fused_conv_module_plain(x, **args, activation=activation)
    tol = 1e-3 if dtype == torch.float32 else 2 ** -6 * want.float().abs().max().item()
    assert _max_err(got, want) <= tol


@pytest.mark.parametrize("activation", ["SiLU", "ReLU"])
def test_k2_function_gradients_with_activation(dev, activation):
    """K2 under autograd with SiLU or ReLU in float32: its counter moves and
    every gradient is autograd's of the plain version within 1e-4 of the
    largest entry; the module has no slope parameter."""
    from diffsinger_tpu_torch.models.backbones.lynxnet import LYNXConvModule

    torch.manual_seed(0)
    m = LYNXConvModule(256, 2, 31, activation=activation).to(dev)
    assert "net.5.weight" not in m.state_dict()
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.05 * torch.randn_like(p))
    x = torch.randn(2, 300, 256, device=dev, requires_grad=True)
    n = lynx_fused.launches
    y = m(x)
    assert lynx_fused.launches == n + 1
    dy = torch.randn_like(y)
    got = torch.autograd.grad(y, [x, *m.parameters()], dy)
    ref = lynx_fused.fused_conv_module_plain(
        x, **lynx_fused.conv_module_params_from_module(m), activation=activation)
    want = torch.autograd.grad(ref, [x, *m.parameters()], dy)
    for a, w in zip(got, want):
        assert _max_err(a, w) <= 1e-4 * w.abs().max().item()


# ---------------------------------------------------------------- the shapes serving sends
# The server pads tokens to multiples of 16 and frames to multiples of 128 and
# packs 1-16 segments into a chunk, so K3 sees lengths 16, 32, 48 and K1/K2
# see B * T_mel rows for any such pair; B=1, T_txt=16, T_mel=128 is the smallest.

@pytest.mark.parametrize("b,length", [(1, 16), (1, 32), (16, 16), (5, 48), (16, 32)])
def test_k3_at_served_token_buckets(dev, b, length):
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = (torch.randn(b, 2, length, 128, generator=g, device=dev) for _ in range(3))
    pad = torch.zeros(b, length, dtype=torch.bool, device=dev)
    pad[0, length - 5:] = True  # the bucket's padding
    pad[-1, length // 2:] = True
    n = flash_attention.launches
    got = flash_attention.flash_attention(q, k, v, pad)
    assert flash_attention.launches == n + 1
    assert _max_err(got, flash_attention.flash_attention_plain(q, k, v, pad)) <= 1e-4


@pytest.mark.parametrize("b,t", [(1, 128), (1, 896), (2, 384), (3, 640), (7, 768), (16, 768),
                                 (13, 256), (16, 128)])
def test_k1_and_k2_at_served_chunk_shapes(dev, b, t):
    x, args = _k2_case(dev, b, t, 1024, 2048, 31, torch.bfloat16, seed=b * 1000 + t)
    n1, n2 = depthwise_conv.launches, lynx_fused.launches
    got = lynx_fused.fused_conv_module(x, **args)
    torch.cuda.synchronize()
    assert (depthwise_conv.launches, lynx_fused.launches) == (n1 + 1, n2 + 1)
    want = lynx_fused.fused_conv_module_plain(x, **args)
    assert _max_err(got, want) <= 2 ** -6 * want.float().abs().max().item()
    s = torch.randn(b, t, 2048, device=dev).bfloat16()
    got1 = depthwise_conv.depthwise_conv1d_prelu(s, args["dw_w"], args["alpha"], args["dw_b"])
    want1 = depthwise_conv.depthwise_conv1d_prelu_plain(s, args["dw_w"], args["alpha"], args["dw_b"])
    assert _max_err(got1, want1) <= 2 ** -7 * want1.float().abs().max().item()


def test_server_kernels_against_plain_float32(dev, tmp_path, monkeypatch):
    """Three segments of a shipped score through ``AcousticServer`` in float32, at
    widths the kernels take (multiples of 32): the run on the kernels against the
    same run on every kernel's plain version, same seed, max |wav diff| <= 1e-3."""
    import json
    import pathlib
    import shutil

    import numpy as np
    import yaml

    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.inference.serving import AcousticServer
    from diffsinger_tpu_torch.models import commons
    from diffsinger_tpu_torch.models.backbones import lynxnet

    repo = pathlib.Path(__file__).resolve().parents[1]
    work_dir = tmp_path / "checkpoints" / "card"
    work_dir.mkdir(parents=True)
    hp = load_config(repo / "configs" / "acoustic.yaml", "sampling_steps=4")
    hp.pop("dictionaries", None)
    hp.update(hidden_size=64, enc_layers=2, infer_precision="32",
              dictionary=str(repo / "dictionaries" / "opencpop-extension.txt"),
              vocoder_ckpt=str(tmp_path / "vocoder" / "model.ckpt"),
              backbone_args=dict(num_channels=64, num_layers=2, kernel_size=31,
                                 dropout_rate=0.0, strong_cond=True))
    with open(work_dir / "config.yaml", "w") as f:
        yaml.safe_dump(hp, f)
    shutil.copy(repo / "dictionaries" / "opencpop-extension.txt", work_dir / "dictionary.txt")
    (tmp_path / "vocoder").mkdir()
    (tmp_path / "vocoder" / "config.json").write_text(json.dumps(
        dict(num_mels=128, upsample_initial_channel=64, mini_nsf=False)))
    with pytest.warns(UserWarning):  # no checkpoint files: seeded random weights
        server = AcousticServer(load_config(exp_name="card", infer=True,
                                            ckpt_root=tmp_path / "checkpoints"), max_batch_size=2)
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():  # the zero-initialised output projection would mute the sampler
        for name, p in server.model.module.named_parameters():
            if name.endswith("output_projection.weight") or name.endswith(".bias"):
                p.add_(0.05 * torch.randn(p.shape, generator=g, device=dev))
    with open(repo / "samples" / "08_qiu_yu.ds", encoding="utf-8") as f:
        segments = json.load(f)[:3]
    counts = lambda: (depthwise_conv.launches, lynx_fused.launches, flash_attention.launches)
    before = counts()
    wav_k = server.synthesize_batch(segments, seed=3)
    after = counts()
    # two chunks (B=2 and B=1): 2 layers x 4 steps and 2 encoder layers each
    assert tuple(a - b for a, b in zip(after, before)) == (16, 16, 4)
    monkeypatch.setattr(lynxnet, "fused_conv_module", lynx_fused.fused_conv_module_plain)
    monkeypatch.setattr(commons, "flash_attention", flash_attention.flash_attention_plain)
    wav_p = server.synthesize_batch(segments, seed=3)
    assert counts() == after
    for a, b in zip(wav_k, wav_p):
        assert np.isfinite(a).all() and np.abs(a).max() > 1e-3
        assert np.abs(a - b).max() <= 1e-3



# The variance encoder is 2 heads of 128 (hidden 256) over token buckets of 16
# to 48 with B 1-16; the melody encoder 2 heads of 64 (hidden 128) over note
# buckets.
@pytest.mark.parametrize("b,length,d", [(16, 32, 128), (1, 16, 128), (7, 48, 128), (16, 64, 128),
                                        (16, 32, 64), (1, 16, 64), (3, 48, 64)])
def test_k3_at_variance_encoder_shapes(dev, b, length, d):
    g = torch.Generator(device=dev).manual_seed(b * 100 + length + d)
    q, k, v = (torch.randn(b, 2, length, d, generator=g, device=dev) for _ in range(3))
    pad = torch.zeros(b, length, dtype=torch.bool, device=dev)
    for i in range(b):  # every row's tail padded, by another amount
        pad[i, length - (3 + 5 * i) % 16:] = True
    n = flash_attention.launches
    got = flash_attention.flash_attention(q, k, v, pad)
    assert flash_attention.launches == n + 1
    assert _max_err(got, flash_attention.flash_attention_plain(q, k, v, pad)) <= 1e-4


def test_variance_model_kernels_against_plain_float32(dev, monkeypatch):
    """The variance model (melody encoder and all four variances on, reduced
    widths that K3 takes) in float32 on the card: its forward on the kernels
    against the same forward on the plain versions, same noise; durations,
    pitch and variances max |diff| <= 1e-3."""
    import pathlib

    import numpy as np

    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.models import commons
    from diffsinger_tpu_torch.models.toplevel import DiffSingerVariance

    # PyTorch's default lets cuDNN round float32 to TF32: the model itself
    # must switch that off, or the duration predictor's convs flip with the
    # attention's last bits
    assert torch.backends.cudnn.allow_tf32
    repo = pathlib.Path(__file__).resolve().parents[1]
    hp = load_config(repo / "configs" / "variance.yaml")
    hp.update(hidden_size=64, enc_layers=2, use_melody_encoder=True, use_glide_embed=True,
              melody_encoder_args=dict(hidden_size=64, enc_layers=2), sampling_steps=4,
              **{f"predict_{v}": True for v in ("energy", "breathiness", "voicing", "tension")})
    torch.manual_seed(0)
    model = DiffSingerVariance(hp, vocab_size=40, device=dev)
    g = torch.Generator(device=dev).manual_seed(1)
    with torch.no_grad():  # the zero-initialised output projections would mute the samplers
        for name, p in model.module.named_parameters():
            if name.endswith("output_projection.weight") or name.endswith(".bias"):
                p.add_(0.05 * torch.randn(p.shape, generator=g, device=dev))
    rng = np.random.default_rng(2)
    b, t_ph, t_n, t_s = 3, 32, 16, 256
    tokens = torch.from_numpy(rng.integers(1, 40, (b, t_ph))).to(dev)
    tokens[1, 20:] = 0
    ph2word = torch.arange(1, t_ph + 1, device=dev).div(2, rounding_mode="floor").add(1)
    ph2word = ph2word[None].repeat(b, 1) * (tokens > 0)
    word_dur = torch.full((b, t_ph), 14, device=dev)
    note_dur = torch.full((b, t_n), t_s // t_n, device=dev)
    mel2note = torch.arange(t_s, device=dev).div(t_s // t_n, rounding_mode="floor").add(1)[None]
    kw = dict(word_dur=word_dur, note_midi=60 + 5 * torch.rand(b, t_n, device=dev),
              note_rest=torch.zeros(b, t_n, dtype=torch.bool, device=dev), note_dur=note_dur,
              note_glide=torch.randint(0, 3, (b, t_n), device=dev),
              mel2note=mel2note.repeat(b, 1), pitch_expr=torch.rand(b, t_s, device=dev),
              noise_pitch=torch.randn(b, t_s, 64, device=dev),
              noise_variances=torch.randn(b, t_s, 48, device=dev))
    args = (tokens, torch.full((b, t_ph), 60, device=dev), ph2word,
            60 + torch.randn(b, 1, device=dev).repeat(1, t_s))
    n = flash_attention.launches
    dur_k, pitch_k, var_k = model.forward_infer(*args, **kw)
    assert flash_attention.launches == n + 4  # two encoders of two layers
    monkeypatch.setattr(commons, "flash_attention", flash_attention.flash_attention_plain)
    dur_p, pitch_p, var_p = model.forward_infer(*args, **kw)
    assert flash_attention.launches == n + 4
    assert _max_err(dur_k, dur_p) <= 1e-3 and _max_err(pitch_k, pitch_p) <= 1e-3
    assert sorted(var_k) == ["breathiness", "energy", "tension", "voicing"]
    for v in var_k:
        assert torch.isfinite(var_k[v]).all() and _max_err(var_k[v], var_p[v]) <= 1e-3


# ------------------------------------------------------------------ training

def _k3_bwd_case(dev, b, length, d, mask="tail", seed=0):
    """q, k, v, key padding and dout for K3's backward. mask: "none"; "tail"
    (row i's last (7 i) % (L / 2) positions padded); "tiles" (whole 64-row
    query and key tiles padded: a row padded from 64 on, a row with its first
    128 positions padded, a row with every other 64-row tile padded, a row
    without padding); "random" (each position padded with probability 0.3:
    no contiguous tail)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, dout = (torch.randn(b, 2, length, d, generator=g, device=dev) for _ in range(4))
    if mask == "none":
        return q, k, v, None, dout
    pad = torch.zeros(b, length, dtype=torch.bool, device=dev)
    pos = torch.arange(length, device=dev)
    for i in range(b):
        if mask == "tail":
            pad[i, length - (7 * i) % (length // 2):] = True
        elif mask == "tiles":
            pad[i] = (pos >= 64, pos < 128, (pos // 64) % 2 == 1, pos < 0)[i % 4]
        else:
            pad[i] = torch.rand(length, generator=g, device=dev) < 0.3
    return q, k, v, pad, dout


@pytest.mark.parametrize("b,length,d,mask", [
    (48, 128, 128, "tail"),    # the training batch's encoder
    (16, 512, 128, "tail"),    # the long shape
    (4, 200, 128, "none"),     # ragged against every tile, no mask
    (3, 77, 64, "tail"), (2, 50, 32, "tail"), (16, 32, 128, "tail"),
    (4, 512, 128, "tiles"),    # whole query and key tiles skipped, both ways
    (4, 300, 64, "tiles"),     # the same with a ragged last tile
    (3, 256, 128, "random"),   # pad that is not a contiguous tail
    (2, 513, 128, "tail"), (2, 1024, 128, "tail"), (2, 1024, 128, "random"),
    (4, 384, 32, "tail"), (4, 640, 64, "random"),
])
def test_k3_backward_kernel(dev, b, length, d, mask):
    """K3's backward kernels against the plain backward on the forward
    kernel's output and log-sum-exp: dq, dk, dv within 1e-4 of the largest
    reference entry (float32 accuracy: 3xTF32, summation order)."""
    q, k, v, pad, dout = _k3_bwd_case(dev, b, length, d, mask)
    scale = d ** -0.5
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    n_fwd, n_bwd = flash_attention.launches, flash_attention.bwd_launches
    out = flash_attention.flash_attention(qr, kr, vr, pad, sm_scale=scale)
    got = torch.autograd.grad(out, (qr, kr, vr), dout)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.bwd_launches) == (n_fwd + 1, n_bwd + 1)
    lse = flash_attention.attention_lse_plain(q, k, pad, sm_scale=scale)
    want = flash_attention.flash_attention_bwd_plain(
        q, k, v, pad, flash_attention.flash_attention_plain(q, k, v, pad, sm_scale=scale), lse,
        dout, sm_scale=scale)
    for a, w in zip(got, want):
        assert torch.isfinite(a).all()
        assert _max_err(a, w) <= 1e-4 * w.abs().max().item()


@pytest.mark.parametrize("b,length,mask", [(48, 128, "tail"), (3, 256, "random")])
def test_k3_backward_is_deterministic(dev, b, length, mask):
    """Every output of the backward has one owner block and no atomics: two
    calls on the same inputs give bitwise-equal dq, dk and dv."""
    q, k, v, pad, dout = _k3_bwd_case(dev, b, length, 128, mask, seed=1)
    scale = 128 ** -0.5
    lse = torch.empty(b, 2, length, device=dev)
    out = flash_attention._launch_fwd(q, k, v, pad, scale, lse)
    first = flash_attention.flash_attention_bwd(q, k, v, pad, out, lse, dout, sm_scale=scale)
    second = flash_attention.flash_attention_bwd(q, k, v, pad, out, lse, dout, sm_scale=scale)
    torch.cuda.synchronize()
    for a, w in zip(first, second):
        assert torch.equal(a, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_function_gradients(dev, dtype):
    """LYNXNet's conv module where gradients are wanted: K2's forward (its
    counter moves) and the stock backward, against autograd of K2's plain
    version on the same card tensors. float32 within 1e-4 of the largest
    entry. bf16 (under autocast, as training runs it) rounds at other points
    than the plain version, so both are held to the float32 gradients: the
    Function's mean absolute error within 1.5x that of autograd of the plain
    version in bf16."""
    from diffsinger_tpu_torch.models.backbones.lynxnet import LYNXConvModule

    torch.manual_seed(0)
    m = LYNXConvModule(256, 2, 31).to(dev)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.05 * torch.randn_like(p))
    x = torch.randn(2, 300, 256, device=dev, requires_grad=True)
    n = lynx_fused.launches
    with torch.autocast("cuda", dtype=torch.bfloat16, enabled=dtype == torch.bfloat16):
        y = m(x)
    assert lynx_fused.launches == n + 1 and y.dtype == dtype
    dy = torch.randn_like(y)
    got = torch.autograd.grad(y, [x, *m.parameters()], dy)
    params = lynx_fused.conv_module_params_from_module(m)

    def plain_grads(dt):
        ref = lynx_fused.fused_conv_module_plain(x.to(dt), **{k: p.to(dt) for k, p in params.items()})
        return torch.autograd.grad(ref, [x, *m.parameters()], dy.to(dt))

    want = plain_grads(torch.float32)
    if dtype == torch.float32:
        for a, w in zip(got, want):
            assert _max_err(a, w) <= 1e-4 * w.abs().max().item()
        return
    for a, p16, w in zip(got, plain_grads(torch.bfloat16), want):
        assert a.dtype == torch.float32
        assert (a - w).abs().mean() <= 1.5 * (p16 - w).abs().mean()


def _small_task(device, work_dir, **over):
    """An AcousticTask at narrow widths in float32, dropout off (``over``:
    more config keys)."""
    from pathlib import Path

    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.training.acoustic_task import AcousticTask

    root = Path(__file__).resolve().parents[1]
    hp = load_config(root / "configs" / "acoustic.yaml")
    hp.update(work_dir=str(work_dir), dictionary=str(root / "dictionaries" / "opencpop-extension.txt"),
              hidden_size=64, enc_layers=2, dropout=0.0, pl_trainer_precision="32-true",
              backbone_args=dict(num_channels=128, num_layers=2, kernel_size=31,
                                 dropout_rate=0.0, strong_cond=True))
    hp["shallow_diffusion_args"] = dict(hp["shallow_diffusion_args"], aux_decoder_args=dict(
        num_channels=64, num_layers=2, kernel_size=7, dropout_rate=0.0))
    hp.update(over)
    torch.manual_seed(0)
    task = AcousticTask(hp, device=device)
    task.configure_optimizer()
    return task


def test_train_step_on_the_card_matches_the_cpu(dev, tmp_path):
    """One float32 optimizer step of a narrow acoustic model: the kernels on
    the card against the plain versions on the CPU, same weights, batch, t and
    noise. Gradients within 1e-3 of each one's largest entry; parameters after
    AdamW's step within 2 lr (its first step moves an element by lr g / (|g| +
    eps), so a gradient near 0 may land on either side), and all but 1 % of
    the elements within 1e-6."""
    import numpy as np

    card, cpu = _small_task(dev, tmp_path / "card"), _small_task("cpu", tmp_path / "cpu")
    cpu.module.load_state_dict(card.module.state_dict())
    rng = np.random.default_rng(0)
    b, t_txt, t_mel = 4, 32, 256
    tokens = rng.integers(1, 50, (b, t_txt)).astype(np.int32)
    mel2ph = np.repeat(np.arange(1, t_txt + 1), t_mel // t_txt)[None].repeat(b, 0).astype(np.int32)
    tokens[1, 20:] = 0
    mel2ph[1][mel2ph[1] > 20] = 0
    batch = dict(tokens=tokens, mel2ph=mel2ph,
                 f0=rng.uniform(150, 400, (b, t_mel)).astype(np.float32),
                 mel=rng.uniform(-11, -1, (b, t_mel, 128)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(0.4, 1, b).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal((b, t_mel, 128)).astype(np.float32))
    grads, launched = [], []
    for task in (card, cpu):
        n = flash_attention.bwd_launches
        task.train_step(task.to_device(batch), t=t.to(task.device), noise=noise.to(task.device))
        launched.append(flash_attention.bwd_launches - n)
        # a copy: apply_update clips the gradients in place (.cpu() of a CPU tensor is itself)
        grads.append({k: p.grad.detach().cpu().clone() for k, p in task.module.named_parameters()})
        task.apply_update()
    assert launched == [2, 0]  # K3's backward once per encoder layer, on the card only
    lr = card.hp["optimizer_args"]["lr"]
    for name, w in grads[1].items():
        assert _max_err(grads[0][name], w) <= 1e-3 * max(w.abs().max().item(), 1e-8), name
    for (name, a), w in zip(card.module.state_dict().items(), cpu.module.state_dict().values()):
        d = (a.cpu() - w).abs()
        assert d.max().item() <= 2 * lr and (d > 1e-6).float().mean().item() <= 0.01, name


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_recompute_and_the_upload_stage_on_the_card(dev, tmp_path, remat):
    """A narrow float32 step with recompute_grads (dropout 0.1 in LYNXNet's
    conv modules) against the step without, on a batch that went through the
    trainer's upload stage as float16 wire arrays: the same loss and
    gradients (the masks replayed from the card's generator; 1e-6 of each
    gradient's largest entry), K2 and K1 twice a layer, and the staged batch
    equal to ``to_device`` of the float16 arrays made float32."""
    import numpy as np

    from diffsinger_tpu_torch.training.base_task import to_wire

    backbone = dict(num_channels=128, num_layers=2, kernel_size=31, dropout_rate=0.1,
                    strong_cond=True)
    rng = np.random.default_rng(1)
    b, t_txt, t_mel = 4, 32, 256
    batch = dict(tokens=rng.integers(1, 50, (b, t_txt)).astype(np.int32),
                 mel2ph=np.repeat(np.arange(1, t_txt + 1), t_mel // t_txt)[None].repeat(b, 0)
                 .astype(np.int32),
                 f0=rng.uniform(150, 400, (b, t_mel)).astype(np.float32),
                 mel=rng.uniform(-11, -1, (b, t_mel, 128)).astype(np.float32))
    wire = to_wire(batch)
    t = torch.from_numpy(rng.uniform(0.4, 1, b).astype(np.float32)).to(dev)
    noise = torch.from_numpy(rng.standard_normal((b, t_mel, 128)).astype(np.float32)).to(dev)
    out = []
    for value in (False, remat):
        task = _small_task(dev, tmp_path / str(value), recompute_grads=value,
                           backbone_args=backbone)
        staged, _, _ = task.next_batch(iter([task.upload_batch((wire, b, 0, (0, 1)))]))
        direct = {k: v.float() for k, v in task.to_device(wire).items()}
        assert staged.keys() == direct.keys()
        assert all(torch.equal(staged[k], direct[k]) for k in staged)
        assert staged["mel"].dtype == torch.float32 and staged["tokens"].dtype == torch.int32
        k1, k2 = depthwise_conv.launches, lynx_fused.launches
        torch.manual_seed(7)
        total = task.train_step(staged, t=t, noise=noise)["total_loss"]
        torch.cuda.synchronize()
        out.append((float(total), {k: p.grad.detach().clone()
                                   for k, p in task.module.named_parameters()},
                    depthwise_conv.launches - k1, lynx_fused.launches - k2))
    (loss0, grads0, k1_0, k2_0), (loss1, grads1, k1_1, k2_1) = out
    assert (k1_0, k2_0, k1_1, k2_1) == (2, 2, 4, 4)
    assert loss1 == loss0
    for name, w in grads0.items():
        assert _max_err(grads1[name], w) <= 1e-6 * max(w.abs().max().item(), 1e-8), name


# ------------------------------------------------------------------ variance training

@pytest.mark.parametrize("b,length,d", [(48, 176, 128), (48, 96, 64), (16, 160, 128),
                                        (7, 200, 64)])
def test_k3_and_its_backward_at_variance_training_shapes(dev, b, length, d):
    """The variance encoder's attention (two heads of 128) over token buckets
    near 176 and the melody encoder's (two heads of 64) over note buckets,
    every row's tail padded: the forward within 1e-4, dq, dk, dv within 1e-4
    of the largest reference entry."""
    q, k, v, pad, dout = _k3_bwd_case(dev, b, length, d, seed=length + d)
    scale = d ** -0.5
    qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))
    n_fwd, n_bwd = flash_attention.launches, flash_attention.bwd_launches
    out = flash_attention.flash_attention(qr, kr, vr, pad, sm_scale=scale)
    got = torch.autograd.grad(out, (qr, kr, vr), dout)
    torch.cuda.synchronize()
    assert (flash_attention.launches, flash_attention.bwd_launches) == (n_fwd + 1, n_bwd + 1)
    want_out = flash_attention.flash_attention_plain(q, k, v, pad, sm_scale=scale)
    assert _max_err(out, want_out) <= 1e-4
    lse = flash_attention.attention_lse_plain(q, k, pad, sm_scale=scale)
    want = flash_attention.flash_attention_bwd_plain(q, k, v, pad, want_out, lse, dout,
                                                     sm_scale=scale)
    for a, w in zip(got, want):
        assert torch.isfinite(a).all()
        assert _max_err(a, w) <= 1e-4 * w.abs().max().item()


def test_variance_train_step_on_the_card_matches_the_cpu(dev, tmp_path):
    """One float32 optimizer step of a narrow variance model with the melody
    encoder and glides: the kernels on the card against the plain versions on
    the CPU, same weights, batch, t, noise and retake masks. Gradients within
    1e-3 of each one's largest entry; parameters after AdamW within 2 lr, all
    but 1 % of the elements within 1e-6 (as the acoustic step above). The
    step is chip_smoke.py's ``[train_variance]`` one, which fails the run on
    a larger error or on other launch counts than 4 K3 and 4 K3-bwd on the
    card and none on the CPU."""
    import chip_smoke

    report = chip_smoke.narrow_variance_step(tmp_path)
    assert report["k3_launches"] == (4, 4)  # two encoder and two melody encoder layers
    assert report["grad_rel_err"] <= 1e-3
    assert report["param_err"] <= 2 * report["lr"] and report["param_share_off"] <= 0.01


def test_two_gloo_ranks_on_the_card_update_as_one_process(dev, tmp_path):
    """chip_smoke.py's ``[train_dist]`` (a): two gloo ranks on the card train
    the narrow float32 variance model with the melody encoder (4 + 4 rows,
    accumulation 2, 3 updates) through ``BaseTask.start``; their parameters
    are equal, within 2 lr of one process on the stitched rows and within
    1e-4 of its largest update but for at most a 1e-4 share of the elements;
    rank 0 alone writes the checkpoint, both ranks launch K3's backward
    alike, and rank 0 more K3 forwards (it alone runs the validation's
    ``forward_infer``)."""
    import chip_smoke

    report = chip_smoke.two_rank_variance_check(tmp_path)
    assert report["rank_err"] == 0.0
    assert report["err"] <= 2 * report["lr"] and report["share_over"] <= 1e-4
    assert report["saves"] == [[f"model_ckpt_steps_{chip_smoke.DIST_STEPS}.ckpt"], []]
    (fwd0, bwd0), (fwd1, bwd1) = report["k3"]
    assert bwd0 == bwd1 > 0 and fwd0 > fwd1 > 0


def test_binarization_on_the_card_matches_the_cpu(dev, tmp_path):
    """Two items of a synthetic sung corpus through both binarizers' items on
    the card and on the CPU (float32), with a pitch-shifted and time-stretched
    copy of each acoustic item: every attribute within the CPU parity tests'
    tolerances (chip_smoke.py's ``[binarize]`` check, on five items there)."""
    import chip_smoke

    chip_smoke.synth_corpus(tmp_path, 2, 7, 2.0, 4.0,
                            chip_smoke.ROOT / "dictionaries" / "opencpop-extension.txt")
    report = chip_smoke.binarize_card_vs_cpu(tmp_path / "raw", tmp_path, 2)
    assert not report["failures"], report["failures"]
    assert report["worst"]["acoustic.mel"] <= 5e-3 and report["worst"]["variance.tension"] <= 1e-4


def test_world_twin_on_the_card_within_the_host_bounds(dev):
    """The WORLD twin on CUDA tensors within tests/test_world_device.py's
    bounds of the float64 goldens (chip_smoke.py's ``[binarize_ext]`` check)."""
    import chip_smoke

    report = chip_smoke.world_twin_checks(dev)
    assert not report["failures"], report


def test_world_twin_is_the_same_on_every_run_and_close_to_the_cpu(dev):
    """The placement of the pulses' responses sums in a fixed order on the
    card (two runs equal), and the card's split is the CPU's (same noise)
    within 1e-3 of each part's peak (float32 rounding of cuFFT and D4C)."""
    import numpy as np

    from diffsinger_tpu_torch.dsp import golden_signals as gs
    from diffsinger_tpu_torch.dsp.world_device import world_harmonic_aperiodic_device

    wave, f0_true = gs.signal_bank()["breathy"]
    f0 = np.full(int(np.ceil((len(wave) + 1) / 512)), f0_true, np.float32)
    kw = dict(fs=gs.FS, fft_size=2048, hop=512)
    a = world_harmonic_aperiodic_device(wave, f0, device=dev, **kw)
    b = world_harmonic_aperiodic_device(wave, f0, device=dev, **kw)
    c = world_harmonic_aperiodic_device(wave, f0, device="cpu", **kw)
    for x, y, z in zip(a, b, c):
        assert x.is_cuda and torch.equal(x, y)
        assert _max_err(x.cpu(), z) <= 1e-3 * z.abs().max().item()


def test_rmvpe_and_the_vocal_remover_on_the_card_match_the_cpu(dev, tmp_path):
    """RMVPE's activations (full width, seeded) and the vocal remover's
    harmonic part (published widths, n_fft 2048) on the card against the
    same checkpoints on the CPU, float32 with TF32 off: within 1e-4 and 1e-4
    of the peak."""
    import numpy as np

    import chip_smoke
    from diffsinger_tpu_torch.models.hnsep import predict_harmonic
    from diffsinger_tpu_torch.models.rmvpe import RMVPE

    ckpts = chip_smoke.ext_checkpoints(tmp_path)
    t = np.arange(2 * 44100) / 44100
    y = (0.3 * np.sin(2 * np.pi * 220 * t) + 0.01 * np.random.default_rng(0).standard_normal(len(t)))
    y = y.astype(np.float32)
    got = RMVPE(ckpts["pe_ckpt"], device=dev).activations(y, 44100)
    want = RMVPE(ckpts["pe_ckpt"], device="cpu").activations(y, 44100)
    assert got.is_cuda and _max_err(got.cpu(), want) <= 1e-4
    got = predict_harmonic(ckpts["hnsep_ckpt"], y, device=dev)
    want = predict_harmonic(ckpts["hnsep_ckpt"], y, device="cpu")
    assert got.is_cuda and _max_err(got.cpu(), want) <= 1e-4 * want.abs().max().item()


def test_binarization_with_rmvpe_vr_harvest_and_world_on_the_card_matches_the_cpu(dev, tmp_path):
    """One item of a synthetic sung corpus through each ``[binarize_ext]``
    run's binarizer on the card and on the CPU: every attribute within
    chip_smoke.py's ``EXT_CARD_TOL`` (three items there)."""
    import chip_smoke

    chip_smoke.synth_corpus(tmp_path, 1, 7, 2.0, 3.0,
                            chip_smoke.ROOT / "dictionaries" / "opencpop-extension.txt")
    ckpts = chip_smoke.ext_checkpoints(tmp_path / "ckpt")
    report = chip_smoke.binarize_ext_card_vs_cpu(tmp_path / "raw", tmp_path, ckpts, 1)
    assert not report["failures"], report["failures"]


def test_binarizer_workers_run_the_world_twin_on_the_card(dev, tmp_path):
    """``hnsep: world`` with ``num_workers`` > 0 on the card: a spawned
    worker runs the twin on the card as the main process does (the items are
    equal), and the provenance records ``device``."""
    import chip_smoke
    from diffsinger_tpu_torch.cli.binarize import binarizer_class
    from diffsinger_tpu_torch.utils.multiprocess_utils import chunked_multiprocess_run

    chip_smoke.synth_corpus(tmp_path, 2, 7, 2.0, 3.0,
                            chip_smoke.ROOT / "dictionaries" / "opencpop-extension.txt")
    raw = tmp_path / "raw"
    hp = chip_smoke.binarize_ext_hp("variance", "harvest", "world", raw, tmp_path / "out",
                                    {"pe_ckpt": "", "hnsep_ckpt": ""})
    hp["binarization_args"] = dict(hp["binarization_args"], num_workers=1)
    b = chip_smoke.quiet(binarizer_class(hp["binarizer_cls"]), hp, device=dev)
    assert b.feature_provenance()["hnsep"] == "native-world-v2(d4c-v1,device)"
    meta = b.load_meta_data(raw, 0, "synth", "zh")
    args = [(n, meta[n], b.binarization_args) for n in sorted(meta)]
    in_worker = list(chunked_multiprocess_run(b.process_item, args, 1, device=dev))
    for got, arg in zip(in_worker, args):
        _, failures = chip_smoke.binarized_item_errors(got, b.process_item(*arg))
        assert not failures, failures


# (config overrides, depth, denoiser calls at 3 steps): DDPM's depth is a
# fraction of its 1000 steps; shallow from 300 at speedup 100, 3 calls; without
# a source 1000 // 3 snaps to the divisor 250, from 750 down to 0, 4 calls
EXPORTED_SAMPLERS = {
    "reflow": ({}, 0.6, 3),
    "ddpm-shallow": (dict(diffusion_type="ddpm"), 0.3, 3),
    "ddpm": (dict(diffusion_type="ddpm", use_shallow_diffusion=False), 0.3, 4),
}


@pytest.mark.parametrize("sampler", list(EXPORTED_SAMPLERS))
def test_exported_acoustic_program_launches_k2_and_k3_on_the_card(dev, tmp_path, sampler):
    """Eager ``forward_infer_dynamic`` on the card, and a ``.pt2`` of it
    exported on the card, saved and loaded: each request launches K2 (and K1
    inside it) once a layer and denoiser call and K3 once an encoder layer,
    and the program equals the eager model (float32, 1e-4)."""
    from pathlib import Path

    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.deployment.exporters import AcousticProgram
    from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic
    from diffsinger_tpu_torch.utils import no_tf32

    over, depth, calls = EXPORTED_SAMPLERS[sampler]
    hp = load_config(Path(__file__).resolve().parents[1] / "configs" / "acoustic.yaml")
    hp.update(hidden_size=128, enc_layers=2,
              backbone_args=dict(hp["backbone_args"], num_channels=64, num_layers=2), **over)
    torch.manual_seed(0)
    model = DiffSingerAcoustic(hp, vocab_size=40, out_dims=hp["audio_num_mel_bins"], device=dev)
    model.module.requires_grad_(False)
    with torch.no_grad():
        model.module.denoiser.output_projection.weight.normal_(0.0, 0.05)
    g = torch.Generator(device=dev).manual_seed(1)
    tokens = torch.randint(1, 40, (1, 16), generator=g, device=dev, dtype=torch.int32)
    mel2ph = torch.arange(1, 17, device=dev, dtype=torch.int32).repeat_interleave(4)[None]
    f0 = torch.full((1, 64), 220.0, device=dev)
    noise = torch.randn((1, 64, hp["audio_num_mel_bins"]), generator=g, device=dev)

    def args(steps):  # depth and steps stay on the host
        return (tokens, mel2ph, f0, torch.tensor(depth), torch.tensor(steps, dtype=torch.int32),
                noise)

    def launches(fn):
        before = (depthwise_conv.launches, lynx_fused.launches, flash_attention.launches)
        with torch.no_grad(), no_tf32():
            out = fn()
        torch.cuda.synchronize()
        after = (depthwise_conv.launches, lynx_fused.launches, flash_attention.launches)
        return out, tuple(a - b for a, b in zip(after, before))

    want, eager_launches = launches(lambda: model.forward_infer_dynamic(
        *args(3)[:3], depth=torch.tensor(depth), steps=torch.tensor(3), noise=noise).diff_out)
    assert eager_launches == (2 * calls, 2 * calls, 2)
    with torch.no_grad():
        ep = torch.export.export(AcousticProgram(model, "acoustic", [], {}, None, None),
                                 args(2))
    torch.export.save(ep, str(tmp_path / "acoustic.pt2"))
    program = torch.export.load(str(tmp_path / "acoustic.pt2")).module()
    got, program_launches = launches(lambda: program(*args(3)))
    assert program_launches == (2 * calls, 2 * calls, 2)
    assert _max_err(got, want) <= 1e-4


@pytest.mark.parametrize("core", ["reflow", "ddpm"])
def test_exported_variance_views_launch_k3_on_the_card(dev, tmp_path, core):
    """The variance model's three views (melody encoder on) exported on the
    card, saved and loaded: the linguistic program launches K3 once an
    encoder layer, the pitch program once a melody-encoder layer, the
    variance program none, no view K1, K2 or K3's backward, and each equals
    the eager view on the same inputs and noise (float32, 1e-6); the pitch
    and variance programs launch K4 for their WaveNets, as eager does."""
    from pathlib import Path

    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.deployment.exporters import VarianceProgram
    from diffsinger_tpu_torch.models.toplevel import DiffSingerVariance
    from diffsinger_tpu_torch.utils import no_tf32

    hp = load_config(Path(__file__).resolve().parents[1] / "configs" / "variance.yaml")
    hp.update(hidden_size=128, enc_layers=3, predict_energy=True, predict_tension=True,
              use_melody_encoder=True, melody_encoder_args=dict(hidden_size=64, enc_layers=2),
              pitch_prediction_args=dict(hp["pitch_prediction_args"], backbone_args=dict(
                  hp["pitch_prediction_args"]["backbone_args"], num_layers=4, num_channels=64)),
              variances_prediction_args=dict(hp["variances_prediction_args"], backbone_args=dict(
                  hp["variances_prediction_args"]["backbone_args"], num_layers=2,
                  num_channels=64)))
    if core == "ddpm":
        hp.update(diffusion_type="ddpm", timesteps=100, K_step=100)
    torch.manual_seed(0)
    model = DiffSingerVariance(hp, vocab_size=40, device=dev)
    model.module.requires_grad_(False)
    g = torch.Generator(device=dev).manual_seed(1)
    i32 = torch.int32
    rb = hp["pitch_prediction_args"]["repeat_bins"]
    trb = hp["variances_prediction_args"]["total_repeat_bins"]
    ling = dict(tokens=torch.randint(1, 40, (1, 16), generator=g, device=dev, dtype=i32),
                midi=torch.full((1, 16), 60, device=dev, dtype=i32),
                ph2word=torch.arange(1, 17, device=dev, dtype=i32)[None] // 2 + 1,
                word_dur=torch.full((1, 16), 8.0, device=dev))
    ph_dur = torch.full((1, 16), 4, device=dev, dtype=i32)
    pitch_in = dict(encoder_out=None, ph_dur=ph_dur,
                    note_midi=60 + 5 * torch.rand((1, 16), generator=g, device=dev),
                    note_rest=torch.zeros((1, 16), device=dev, dtype=torch.bool), note_dur=ph_dur,
                    pitch=torch.full((1, 64), 62.0, device=dev),
                    expr=torch.ones((1, 64), device=dev),
                    retake=torch.ones((1, 64), device=dev, dtype=torch.bool),
                    steps=torch.tensor(3, dtype=i32),
                    noise=torch.randn((1, 64, rb), generator=g, device=dev))
    var_in = dict(encoder_out=None, ph_dur=ph_dur, pitch=pitch_in["pitch"],
                  **{v: torch.zeros((1, 64), device=dev) for v in model.var_list},
                  retake=torch.ones((1, 64, len(model.var_list)), device=dev, dtype=torch.bool),
                  steps=torch.tensor(3, dtype=i32),
                  noise=torch.randn((1, 64, trb), generator=g, device=dev))

    def launches(fn):
        before = (depthwise_conv.launches, lynx_fused.launches, flash_attention.launches,
                  flash_attention.bwd_launches)
        with torch.no_grad(), no_tf32():
            out = fn()
        torch.cuda.synchronize()
        after = (depthwise_conv.launches, lynx_fused.launches, flash_attention.launches,
                 flash_attention.bwd_launches)
        return out, tuple(a - b for a, b in zip(after, before))

    def loaded(view, inputs):
        program = VarianceProgram(model, view, list(inputs))
        with torch.no_grad():
            ep = torch.export.export(program, tuple(inputs.values()))
        torch.export.save(ep, str(tmp_path / f"{view}.pt2"))
        return program, torch.export.load(str(tmp_path / f"{view}.pt2")).module()

    eager, program = loaded("linguistic", ling)
    (enc, dur), n = launches(lambda: program(*ling.values()))
    assert n == (0, 0, hp["enc_layers"], 0)
    want, _ = launches(lambda: eager(*ling.values()))
    assert _max_err(enc, want[0]) <= 1e-6 and _max_err(dur, want[1]) <= 1e-6
    # denoiser calls: 3 euler steps; DDIM at a speedup of 25 visits 75, 50, 25, 0
    calls = 3 if core == "reflow" else 4
    for view, inputs, k3, blocks in (("pitch", pitch_in, 2, 4), ("variance", var_in, 0, 2)):
        inputs["encoder_out"] = enc
        eager, program = loaded(view, inputs)
        k4 = wavenet_block.launches
        got, n = launches(lambda: program(*inputs.values()))
        assert n == (0, 0, k3, 0) and wavenet_block.launches == k4 + 2 * calls * blocks, view
        want, n_eager = launches(lambda: eager(*inputs.values()))
        assert n_eager == n and wavenet_block.launches == k4 + 4 * calls * blocks, view
        for a, b in zip(got if view == "variance" else [got], want if view == "variance"
                        else [want]):
            assert _max_err(a, b) <= 1e-6, view


@pytest.mark.parametrize("rel_pos", [True, False])
def test_k3_in_the_encoder_without_rope_matches_its_plain_version(dev, rel_pos):
    """A FastSpeech2 encoder without RoPE on the card launches K3 once a layer
    and matches the same encoder on the CPU, where the attention is K3's
    plain version (float32, 1e-4)."""
    from diffsinger_tpu_torch.models.commons import FastSpeech2Encoder, SelfAttentionAbs

    torch.manual_seed(0)
    enc = FastSpeech2Encoder(256, 4, ffn_kernel_size=9, num_heads=2, use_rope=False,
                             use_pos_embed=True, rel_pos=rel_pos).eval()
    assert isinstance(enc.layers[0].op.self_attn, SelfAttentionAbs)
    g = torch.Generator().manual_seed(1)
    x = torch.randn((3, 176, 256), generator=g)
    extra = 0.1 * torch.randn((3, 176, 256), generator=g)
    pad = torch.zeros((3, 176), dtype=torch.bool)
    pad[1, 150:] = True
    pad[2, 40:] = True
    with torch.no_grad():
        want = enc(x, extra, pad)
        enc.to(dev)
        n = flash_attention.launches
        got = enc(x.to(dev), extra.to(dev), pad.to(dev))
        torch.cuda.synchronize()
    assert flash_attention.launches == n + 4
    assert _max_err(got.cpu(), want) <= 1e-4
