"""LYNXNet with ``activation: SiLU`` or ``ReLU`` in the PyTorch port against the
JAX package, on the CPU in float32: K1's plain version with the activation in
its epilogue, K2's plain version against the JAX ``LYNXConvModule``, a narrow
acoustic model's ``forward_infer`` and every gradient of ``forward_train``
against ``jax.grad``, and a SiLU model exported as ``.pt2`` and ONNX. The
PReLU cases run beside them unchanged.

Tolerances: K1 and K2 1e-5 (sums in another order); ``forward_infer`` max
|diff| <= 1e-4; each gradient within 1e-4 of its largest entry, losses 1e-5
relative; the ``.pt2`` program 1e-6 against eager; the ONNX graph through the
numpy interpreter 2e-4 / 1e-4 (``tests/test_torch_onnx.py``'s).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.models.backbones.lynxnet import LYNXConvModule as JaxConvModule
from diffsinger_tpu.models.toplevel import DiffSingerAcoustic as JaxAcoustic
from diffsinger_tpu.ops.depthwise_conv import depthwise_conv1d_prelu_xla as jax_dwconv_xla
from diffsinger_tpu.training.acoustic_task import make_acoustic_loss_fn as jax_loss_fn
from diffsinger_tpu_torch.models.backbones.lynxnet import LYNXConvModule
from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic
from diffsinger_tpu_torch.ops import depthwise_conv, lynx_fused
from diffsinger_tpu_torch.training.acoustic_task import make_acoustic_loss_fn
from diffsinger_tpu_torch.utils.convert import acoustic_state_dict_from_flax
from tests.torch_parity import (HP, MELS, VOCAB, acoustic_inputs, assert_close, jax_kwargs,
                                make_exp, port_kwargs, randomize, to_numpy)

ACTIVATIONS = ["PReLU", "SiLU", "ReLU"]


def jax_activation(y, alpha, activation):
    if activation == "PReLU":
        return jnp.where(y >= 0, y, alpha * y)
    return {"SiLU": jax.nn.silu, "ReLU": jax.nn.relu}[activation](y)


def with_activation(hp: dict, activation: str, **backbone) -> dict:
    return dict(hp, backbone_args=dict(hp["backbone_args"], activation=activation, **backbone))


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("b,t,c,k", [(2, 96, 64, 31), (3, 77, 100, 7), (2, 100, 100, 4)])
def test_k1_plain_is_the_jax_conv_then_the_activation(activation, b, t, c, k):
    """K1's plain version (taps, bias, activation) against the JAX package's
    reference conv (its PReLU at slope 1 leaves y alone), the bias, then the
    JAX activation; the wrapper on CPU tensors is the plain version."""
    rng = np.random.default_rng(100 * k + t)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    x[0, -1] = 100.0  # sequence 0's last row must not reach sequence 1
    w = (rng.standard_normal((k, c)) * 0.2).astype(np.float32)
    bias = (0.3 * rng.standard_normal(c)).astype(np.float32)
    alpha = rng.uniform(0.1, 0.4, (c,)).astype(np.float32)
    y = jax_dwconv_xla(jnp.asarray(x), jnp.asarray(w), jnp.ones(c), kernel_size=k) + bias
    want = jax_activation(y, jnp.asarray(alpha), activation)
    args = (torch.from_numpy(x), torch.from_numpy(w.T.copy()),
            torch.from_numpy(alpha) if activation == "PReLU" else None, torch.from_numpy(bias))
    got = depthwise_conv.depthwise_conv1d_prelu_plain(*args, activation)
    assert_close(got, want)
    assert torch.equal(depthwise_conv.depthwise_conv1d_prelu(*args, activation=activation), got)
    if activation != "PReLU":
        assert (got < 0).any() == (activation == "SiLU")


def test_k1_and_k2_refuse_an_unknown_activation():
    x = torch.zeros(1, 8, 16)
    with pytest.raises(ValueError, match="GELU"):
        depthwise_conv.depthwise_conv1d_prelu(x, torch.zeros(16, 3), None, None, "GELU")
    with pytest.raises(ValueError, match="GELU"):
        LYNXConvModule(16, 2, 3, activation="GELU")


def _conv_module_case(activation, c, k, b, t, seed):
    """The JAX ``LYNXConvModule`` with random biases (and slopes), its
    output, and the port's module with the same weights."""
    mod = JaxConvModule(dim=c, expansion_factor=2, kernel_size=k, activation=activation)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    p = jax.tree.map(np.asarray, mod.init(jax.random.PRNGKey(seed), jnp.asarray(x)))["params"]
    for name in ("pw_conv1", "dw_conv", "pw_conv2", "norm"):
        p[name]["bias"] = (0.3 * rng.standard_normal(p[name]["bias"].shape)).astype(np.float32)
    p["norm"]["scale"] = (1 + 0.2 * rng.standard_normal(c)).astype(np.float32)
    assert ("act" in p) == (activation == "PReLU")
    if activation == "PReLU":
        p["act"]["alpha"] = rng.uniform(0.1, 0.5, p["act"]["alpha"].shape).astype(np.float32)
    want = mod.apply({"params": p}, jnp.asarray(x))
    port = LYNXConvModule(c, 2, k, activation=activation)
    t_ = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    state = {"net.0.weight": t_(p["norm"]["scale"]), "net.0.bias": t_(p["norm"]["bias"]),
             "net.2.weight": t_(p["pw_conv1"]["kernel"].transpose(2, 1, 0)),
             "net.2.bias": t_(p["pw_conv1"]["bias"]),
             "net.4.weight": t_(p["dw_conv"]["kernel"].transpose(2, 1, 0)),
             "net.4.bias": t_(p["dw_conv"]["bias"]),
             "net.6.weight": t_(p["pw_conv2"]["kernel"].transpose(2, 1, 0)),
             "net.6.bias": t_(p["pw_conv2"]["bias"])}
    if activation == "PReLU":
        state["net.5.weight"] = t_(p["act"]["alpha"])
    port.load_state_dict(state, strict=True)
    return port, x, want


@pytest.mark.parametrize("activation", ACTIVATIONS)
@pytest.mark.parametrize("k,t", [(31, 70), (7, 45)])
def test_k2_plain_matches_the_jax_conv_module(activation, k, t):
    port, x, want = _conv_module_case(activation, c=16, k=k, b=2, t=t, seed=k + t)
    assert isinstance(port.net[5], {"PReLU": torch.nn.Module, "SiLU": torch.nn.SiLU,
                                    "ReLU": torch.nn.ReLU}[activation])
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert_close(got, want)
    params = lynx_fused.conv_module_params_from_module(port)
    assert (params["alpha"] is None) == (activation != "PReLU")
    plain = lynx_fused.fused_conv_module_plain(torch.from_numpy(x), **params, activation=activation)
    assert torch.equal(got, plain)


@pytest.mark.parametrize("activation", ["SiLU", "ReLU"])
def test_k2_function_backward_matches_autograd_of_the_plain_version(activation):
    torch.manual_seed(0)
    m = LYNXConvModule(32, 2, 31, activation=activation)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.1 * torch.randn_like(p))
    x = torch.randn(2, 40, 32, requires_grad=True)
    y = m(x)
    dy = torch.randn_like(y)
    got = torch.autograd.grad(y, [x, *m.parameters()], dy)
    ref = lynx_fused.fused_conv_module_plain(
        x, **lynx_fused.conv_module_params_from_module(m), activation=activation)
    want = torch.autograd.grad(ref, [x, *m.parameters()], dy)
    assert torch.equal(y, ref)
    for a, w in zip(got, want):
        assert (a - w).abs().max() <= 1e-5 * w.abs().max()


# ------------------------------------------------------------------ the model

HP_NO_DROP = dict(HP, dropout=0.0, shallow_diffusion_args=dict(
    HP["shallow_diffusion_args"], aux_decoder_args=dict(
        HP["shallow_diffusion_args"]["aux_decoder_args"], dropout_rate=0.0)))


@pytest.fixture(scope="module", params=["SiLU", "ReLU"])
def act_pair(request):
    """(activation, hp, JAX model, its params, port model) sharing weights;
    the JAX init runs jitted."""
    hp = with_activation(HP_NO_DROP, request.param)
    jm = JaxAcoustic(hp, vocab_size=VOCAB, out_dims=MELS)
    params = randomize(jax.jit(jm.init)(jax.random.PRNGKey(3)), 103)
    assert "act" not in params["params"]["denoiser"]["residual_layers_0"]["convmodule"]
    port = DiffSingerAcoustic(hp, vocab_size=VOCAB, out_dims=MELS, device="cpu")
    port.module.load_state_dict(acoustic_state_dict_from_flax(to_numpy(params), hp), strict=True)
    return request.param, hp, jm, params, port


def test_forward_infer_matches_jax(act_pair):
    activation, _, jm, params, port = act_pair
    inp = acoustic_inputs(seed=6, t_mel=40)
    noise = np.random.default_rng(7).standard_normal((2, 40, MELS)).astype(np.float32)
    jout = jm.forward_infer(
        params, jax.random.PRNGKey(0), jnp.asarray(inp["tokens"]), jnp.asarray(inp["mel2ph"]),
        jnp.asarray(inp["f0"]), steps=3, noise=jnp.asarray(noise), **jax_kwargs(inp))
    pout = port.forward_infer(
        torch.from_numpy(inp["tokens"]), torch.from_numpy(inp["mel2ph"]),
        torch.from_numpy(inp["f0"]), steps=3, noise=torch.from_numpy(noise), **port_kwargs(inp))
    jmel = np.asarray(jout.diff_out)
    assert np.abs(jmel - np.asarray(jout.aux_out)).mean() > 1e-2  # the sampler moved the draft
    assert np.abs(pout.diff_out.numpy() - jmel).max() <= 1e-4
    assert np.abs(pout.aux_out.numpy() - np.asarray(jout.aux_out)).max() <= 1e-4


def test_forward_train_losses_and_every_gradient_match_jax_grad(act_pair):
    """The losses and every parameter's gradient against ``jax.grad`` of the
    JAX loss function, the JAX draws (t, noise) injected."""
    _, hp, jm, params, port = act_pair
    inp = acoustic_inputs(seed=12, t_mel=40)
    b = inp["tokens"].shape[0]
    mel = np.random.default_rng(13).uniform(-11, -1, (b, 40, MELS)).astype(np.float32)
    batch = dict(tokens=inp["tokens"], mel2ph=inp["mel2ph"], f0=inp["f0"], mel=mel,
                 energy=inp["energy"], key_shift=inp["key_shift"])
    rng = jax.random.PRNGKey(14)
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(jax_loss_fn(jm), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    _, rng_t, rng_noise = jax.random.split(rng, 3)
    t = jm.t_start + (1.0 - jm.t_start) * jax.random.uniform(rng_t, (b,))
    noise = jax.random.normal(rng_noise, mel.shape, jnp.float32)

    t_ = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    port.module.train()
    port.module.zero_grad()
    try:
        total, plosses = make_acoustic_loss_fn(port)(
            {k: t_(v) for k, v in batch.items()}, t=t_(t), noise=t_(noise))
        total.backward()
    finally:
        port.module.eval()
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-5)
    for k in ("aux_mel_loss", "mel_loss"):
        np.testing.assert_allclose(float(plosses[k].detach()), float(jmetrics[k]), rtol=1e-5)
    want = acoustic_state_dict_from_flax(to_numpy(jgrads), hp)
    named = dict(port.module.named_parameters())
    assert set(want) == set(named)
    for name, w in want.items():
        got = named[name].grad
        assert got is not None, name
        w = w.numpy()
        assert np.abs(got.numpy() - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-6), name


# ------------------------------------------------------------------ export

def test_silu_model_exports_as_pt2_and_onnx(tmp_path):
    """A SiLU experiment exported on the CPU in both formats: the ``.pt2``
    program keeps K2 as one node with the activation and equals eager
    ``forward_infer_dynamic``; the ONNX graph passes both packages' checkers
    and, through the interpreter, equals eager on the interpreter's draw."""
    from diffsinger_tpu.deployment.onnx.checker import check_model as jax_check_model
    from diffsinger_tpu.deployment.onnx.lowering import EMITTED_OPS as JAX_EMITTED_OPS
    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.deployment.exporters import DiffSingerAcousticExporter
    from diffsinger_tpu_torch.deployment.onnx import run_model
    from diffsinger_tpu_torch.deployment.onnx.checker import check_model
    from diffsinger_tpu_torch.deployment.runtime import AcousticArtifactRuntime

    over = with_activation(dict(backbone_args=dict(num_channels=32, num_layers=1, kernel_size=31,
                                                   dropout_rate=0.0, strong_cond=True)), "SiLU")
    ckpt_root = make_exp(tmp_path, "silu", over, vocoder=None)
    hp = load_config(exp_name="silu", infer=True, ckpt_root=ckpt_root)
    exporter = DiffSingerAcousticExporter(hp, tmp_path / "bundle", buckets=[(16, 64)],
                                          fmt="both", device="cpu")
    exporter.export()
    model = exporter.model
    assert isinstance(model.module.denoiser.residual_layers[0].convmodule.net[5],
                      torch.nn.SiLU)

    tokens = np.zeros((1, 16), np.int32)
    tokens[0, :4] = np.arange(1, 5)
    mel2ph = np.zeros((1, 64), np.int32)
    mel2ph[0, :40] = np.repeat(np.arange(1, 5), 10)
    f0 = np.full((1, 64), 220.0, np.float32)
    noise = np.random.default_rng(0).standard_normal((1, 64, MELS)).astype(np.float32)
    want = model.forward_infer_dynamic(
        torch.from_numpy(tokens), torch.from_numpy(mel2ph), torch.from_numpy(f0),
        depth=torch.tensor(0.6), steps=torch.tensor(2), noise=torch.from_numpy(noise)).diff_out

    runtime = AcousticArtifactRuntime(tmp_path / "bundle", device="cpu")
    got = runtime.synthesize_mel(tokens, mel2ph, f0, depth=0.6, steps=2,
                                 noise=torch.from_numpy(noise))
    assert np.abs(got - want.numpy()).max() <= 1e-6
    program = torch.export.load(str(tmp_path / "bundle" / exporter.bucket_files["16x64"]["acoustic"]))
    k2 = [n for gm in program.graph_module.modules() if isinstance(gm, torch.fx.GraphModule)
          for n in gm.graph.nodes if n.target is torch.ops.ds.fused_conv_module.default]
    assert k2 and all(n.kwargs.get("activation", n.args[-1]) == "SiLU" for n in k2)

    data = (tmp_path / "bundle" / exporter.bucket_files["16x64"]["acoustic_onnx"]).read_bytes()
    jax_check_model(data, known_ops=JAX_EMITTED_OPS)
    check_model(data)
    (out,) = run_model(data, {"tokens": tokens, "mel2ph": mel2ph, "f0": f0,
                              "depth": np.float32(0.6), "steps": np.int32(2)}, rng_seed=0)
    np.testing.assert_allclose(out, want.numpy(), atol=2e-4, rtol=1e-4)
