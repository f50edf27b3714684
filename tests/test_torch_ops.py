"""The port's kernels' plain versions (diffsinger_tpu_torch/ops) against the JAX
package's TPU kernels, run on the CPU as the JAX tests run them: K1 and K2 with
``interpret=True``, K3 (the library flash attention) under
``force_tpu_interpret_mode``. Float32 tolerance 1e-5: both sides compute in
float32 and differ only in summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from diffsinger_tpu.models.backbones.lynxnet import LYNXConvModule as JaxConvModule
from diffsinger_tpu.ops.depthwise_conv import depthwise_conv1d_prelu as jax_dwconv
from diffsinger_tpu.ops.depthwise_conv import depthwise_conv1d_prelu_xla as jax_dwconv_xla
from diffsinger_tpu.ops.lynx_fused import conv_module_params_from_flax, fused_conv_module
from diffsinger_tpu_torch.ops import depthwise_conv, flash_attention, lynx_fused
from tests.torch_parity import assert_close


@pytest.mark.parametrize("k,t_blk", [(31, 32), (7, 32)])
def test_k1_plain_matches_pallas_kernel(k, t_blk):
    rng = np.random.default_rng(k)
    b, t, c = 2, 96, 64
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    w = (rng.standard_normal((k, c)) * 0.2).astype(np.float32)
    alpha = rng.uniform(0.1, 0.4, (c,)).astype(np.float32)
    want = jax_dwconv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha), kernel_size=k,
                      t_blk=t_blk, interpret=True)
    got = depthwise_conv.depthwise_conv1d_prelu(
        torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(alpha))
    assert got.shape == (b, t, c)
    assert_close(got, want)


@pytest.mark.parametrize("b,t,c,k", [
    (2, 100, 100, 4),   # even k: pads 2 left and 1 right; C not a multiple of 8
    (2, 50, 64, 1),     # a single tap
    (1, 17, 64, 31),    # T shorter than the halo
    (3, 77, 100, 7),
    (2, 50, 24, 61),    # the largest k the kernels take
    (2, 40, 16, 30),
])
def test_k1_plain_matches_jax_reference_at_the_shapes_that_break_tiles(b, t, c, k):
    """The plain version against the JAX package's own reference (no bias),
    where the Pallas kernel's interpret mode cannot go (it needs T % t_blk == 0)."""
    rng = np.random.default_rng(1000 * k + t)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    x[0, -1] = 100.0  # sequence 0's last row must not reach sequence 1
    w = (rng.standard_normal((k, c)) * 0.2).astype(np.float32)
    alpha = rng.uniform(0.1, 0.4, (c,)).astype(np.float32)
    want = jax_dwconv_xla(jnp.asarray(x), jnp.asarray(w), jnp.asarray(alpha), kernel_size=k)
    got = depthwise_conv.depthwise_conv1d_prelu_plain(
        torch.from_numpy(x), torch.from_numpy(w.T.copy()), torch.from_numpy(alpha))
    assert got.shape == (b, t, c)
    assert_close(got, want)


@pytest.mark.parametrize("b,t,c,k,rows,span", [
    (16, 1024, 2048, 31, 128, 4),  # K2's middle stage: 1024 blocks, two to a slot
    (1, 4096, 2048, 31, 128, 2),   # one long phrase: 512 blocks
    (16, 1024, 512, 7, 128, 2),    # the ConvNeXt width
    (2, 512, 2048, 31, 128, 1),    # the float32 slice: too few tiles to share out
    (3, 333, 2048, 31, 128, 1),
    (64, 1024, 2048, 31, 128, 8),  # every column fills a slot by itself
    (1, 17, 64, 31, 64, 1),        # shorter than the small tile
    (1, 64, 2048, 31, 64, 1),
    (2, 100, 100, 4, 0, 1),        # C % 8 != 0 and k not built: the generic kernel
    (2, 100, 96, 5, 0, 1),
    (2, 100, 100, 31, 0, 1),
])
def test_k1_tile_choice(b, t, c, k, rows, span):
    assert depthwise_conv.choose_tile(b, t, c, k) == (rows, span)
    if rows:
        assert rows in depthwise_conv.TILE_ROWS and k in depthwise_conv.TILE_K and c % 8 == 0
        tiles = -(-t // rows)
        columns = -(-c // depthwise_conv.TILE_CHANNELS) * b
        blocks = columns * -(-tiles // span)
        # spans round up, so the grid may fall short of a block a slot, by less than half
        assert 1 <= span <= tiles
        assert span == 1 or 2 * blocks >= depthwise_conv.MIN_BLOCKS
        # a grid with blocks to spare is cut no finer than a block a slot
        assert span == tiles or blocks < 2 * depthwise_conv.MIN_BLOCKS or span == 1


def test_k1_bias_added_before_prelu():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 20, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((8, 5)).astype(np.float32))
    alpha = torch.full((8,), 0.25)
    bias = torch.from_numpy(rng.standard_normal(8).astype(np.float32))
    y = torch.nn.functional.conv1d(x.transpose(1, 2), w[:, None, :], bias, padding=2, groups=8)
    want = torch.where(y >= 0, y, 0.25 * y).transpose(1, 2)
    assert_close(depthwise_conv.depthwise_conv1d_prelu(x, w, alpha, bias), want.numpy())


def _conv_module_case(c, k, b, t, seed):
    """Flax LYNXConvModule with random biases and slopes, its output, and the
    port's K2 arguments for the same weights."""
    mod = JaxConvModule(dim=c, expansion_factor=2, kernel_size=k, activation="PReLU")
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    params = jax.tree.map(np.asarray, mod.init(jax.random.PRNGKey(seed), jnp.asarray(x)))
    p = params["params"]
    p["act"]["alpha"] = rng.uniform(0.1, 0.5, p["act"]["alpha"].shape).astype(np.float32)
    for name in ("pw_conv1", "dw_conv", "pw_conv2", "norm"):
        p[name]["bias"] = (0.3 * rng.standard_normal(p[name]["bias"].shape)).astype(np.float32)
    p["norm"]["scale"] = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    jp = conv_module_params_from_flax(p)
    port_args = {
        "ln_scale": jp["ln_scale"], "ln_bias": jp["ln_bias"],
        "w1": jp["w1"].T, "b1": jp["b1"], "dw_w": jp["dw_w"].T, "dw_b": jp["dw_b"],
        "alpha": jp["alpha"], "w2": jp["w2"].T, "b2": jp["b2"],
    }
    port_args = {n: torch.from_numpy(np.ascontiguousarray(a)) for n, a in port_args.items()}
    return mod, params, x, jp, port_args


@pytest.mark.parametrize("k,tile,t", [(7, 8, 45), (31, 32, 70), (31, 16, 64)])
def test_k2_plain_matches_pallas_kernel_and_flax_f32(k, tile, t):
    mod, params, x, jp, args = _conv_module_case(c=16, k=k, b=2, t=t, seed=k + t)
    fused = fused_conv_module(jnp.asarray(x), **jp, kernel_size=k, tile=tile,
                              compute_dtype=jnp.float32, interpret=True)
    flax_out = mod.apply(params, jnp.asarray(x))
    got = lynx_fused.fused_conv_module(torch.from_numpy(x), **args)
    assert_close(got, fused)
    assert_close(got, flax_out)


def test_k2_plain_bf16_loose():
    """bf16: the port rounds its parameters to bf16 too, the TPU kernel only the
    products' operands, so the bound is loose (mean error < 2 % of mean |y|)."""
    mod, params, x, jp, args = _conv_module_case(c=32, k=31, b=1, t=64, seed=5)
    want = np.asarray(fused_conv_module(jnp.asarray(x), **jp, kernel_size=31, tile=32,
                                        compute_dtype=jnp.bfloat16, interpret=True))
    got = lynx_fused.fused_conv_module(
        torch.from_numpy(x).bfloat16(), **{n: a.bfloat16() for n, a in args.items()})
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).mean() / np.abs(want).mean()
    assert err < 0.02, err


def test_k2_plain_batch_rows_independent():
    _, _, x, _, args = _conv_module_case(c=16, k=31, b=3, t=40, seed=7)
    xt = torch.from_numpy(x)
    out = lynx_fused.fused_conv_module(xt, **args)
    out_perm = lynx_fused.fused_conv_module(xt.flip(0), **args)
    assert_close(out_perm, out.flip(0).numpy(), atol=1e-6, rtol=0)


def test_k2_plain_edge_only_energy():
    """Energy only in the first row: the conv's zero padding, not wrapped or
    masked rows, shapes the output near the edges."""
    mod, params, x, jp, args = _conv_module_case(c=16, k=31, b=1, t=48, seed=11)
    x[:, 1:] = 0.0
    want = mod.apply(params, jnp.asarray(x))
    assert_close(lynx_fused.fused_conv_module(torch.from_numpy(x), **args), want)


def test_k2_params_from_module_layout():
    from diffsinger_tpu_torch.models.backbones.lynxnet import LYNXConvModule

    m = LYNXConvModule(dim=16, expansion_factor=2, kernel_size=7)
    p = lynx_fused.conv_module_params_from_module(m)
    assert p["w1"].shape == (64, 16) and p["dw_w"].shape == (32, 7) and p["w2"].shape == (16, 32)
    assert p["w1"].data_ptr() == m.net[2].weight.data_ptr()  # views, no copies


@pytest.mark.parametrize("L", [128, 256])
def test_k3_plain_matches_library_flash_attention(L):
    from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds
    from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention as jax_flash

    rng = np.random.default_rng(L)
    b, h, d = 2, 2, 128
    q, k, v = (rng.standard_normal((b, h, L, d)).astype(np.float32) for _ in range(3))
    pad = np.zeros((b, L), bool)
    pad[1, L - 37:] = True  # row 1 is padded at its end
    seg = jnp.asarray((~pad).astype(np.int32))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    segment_ids=SegmentIds(q=seg, kv=seg),
                                    sm_scale=1.0 / np.sqrt(d)))
    got = flash_attention.flash_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(pad), sm_scale=1.0 / np.sqrt(d)).numpy()
    valid = ~pad
    for i in range(b):
        np.testing.assert_allclose(got[i][:, valid[i]], want[i][:, valid[i]], atol=1e-5, rtol=1e-5)
    # both follow the segment rule on padded rows too
    np.testing.assert_allclose(got[1][:, pad[1]], want[1][:, pad[1]], atol=1e-5, rtol=1e-5)


def _c_exports():
    """{name: number of arguments} of every ``extern "C" int ds_*`` function in
    ops/csrc/*.cu, read from the sources as text."""
    import re

    from diffsinger_tpu_torch.ops import native

    found = {}
    for src in sorted(native.CSRC.glob("*.cu")):
        for name, args in re.findall(r'extern "C" int (ds_\w+)\(([^)]*)\)', src.read_text()):
            found[(src.stem, name)] = len([a for a in args.split(",") if a.strip()])
    return found


def test_every_exported_c_function_has_its_signature_and_the_other_way_round():
    from diffsinger_tpu_torch.ops import native

    found = _c_exports()
    assert found, "no exported function found"
    assert set(found) == set(native.SIGNATURES)
    for key, n_args in found.items():
        assert len(native.SIGNATURES[key]) == n_args, key
    assert {lib for lib, _ in found} == set(native.KERNEL_SOURCES)


@pytest.mark.parametrize("length,batch_heads,bq", [
    (128, 32, 32),    # the encoder at B=16: 64 rows would leave half the SMs idle
    (512, 32, 128),   # long phrases in a batch: 128 blocks of 128 rows
    (512, 2, 16),     # one long phrase: no tile fills the card
    (200, 8, 16),
    (4096, 32, 128),
    (1, 1, 16),
])
def test_k3_tile_choice(length, batch_heads, bq):
    assert flash_attention.choose_bq(length, batch_heads) == bq
    blocks = -(-length // bq) * batch_heads
    assert bq == 16 or blocks >= flash_attention.MIN_BLOCKS
    # no larger tile would still fill the card
    for bigger in (b for b in flash_attention.BQ_CHOICES if b > bq):
        assert -(-length // bigger) * batch_heads < flash_attention.MIN_BLOCKS


def test_wrappers_raise_on_a_device_without_a_kernel():
    x = torch.zeros(1, 8, 32, device="meta")
    with pytest.raises(ValueError):
        depthwise_conv.depthwise_conv1d_prelu(x, torch.zeros(32, 3, device="meta"),
                                              torch.zeros(32, device="meta"))
