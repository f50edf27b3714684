"""The acoustic model's training path in the PyTorch port against the JAX
package, on the CPU at narrow widths: bf16 inference after the F1 repair (the
curve embeds in float32), the training draws, the losses, K3's and K2's
backward, and ``forward_train``'s losses and every parameter gradient against
``jax.grad`` of ``make_acoustic_loss_fn`` (dropout off, the JAX draws
injected). Float32 throughout except the bf16 cases; each tolerance is stated
where it is held.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.core import ddpm as jddpm
from diffsinger_tpu.core import reflow as jreflow
from diffsinger_tpu.core.schedule import DiffusionSchedule as JaxSchedule
from diffsinger_tpu.models import commons as jcommons
from diffsinger_tpu.models import losses as jlosses
from diffsinger_tpu.models.toplevel import DiffSingerAcoustic as JaxAcoustic
from diffsinger_tpu.models.toplevel import DiffSingerVariance as JaxVariance
from diffsinger_tpu.training.acoustic_task import make_acoustic_loss_fn as jax_loss_fn
from diffsinger_tpu_torch.core import ddpm, reflow
from diffsinger_tpu_torch.core.schedule import DiffusionSchedule
from diffsinger_tpu_torch.models import commons, losses
from diffsinger_tpu_torch.models.backbones.lynxnet import LYNXConvModule
from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic, DiffSingerVariance
from diffsinger_tpu_torch.ops import flash_attention as fa
from diffsinger_tpu_torch.ops import lynx_fused
from diffsinger_tpu_torch.training.acoustic_task import make_acoustic_loss_fn
from diffsinger_tpu_torch.utils.convert import (
    acoustic_state_dict_from_flax, variance_state_dict_from_flax)
from tests.test_torch_variance import variance_inputs
from tests.torch_parity import (
    HP, MELS, VAR_HP, VOCAB, acoustic_inputs, jax_kwargs, port_kwargs, randomize, to_numpy,
)

# dropout off on both sides: two random generators cannot share masks
HP_NO_DROP = dict(HP, dropout=0.0, shallow_diffusion_args=dict(
    HP["shallow_diffusion_args"], aux_decoder_args=dict(
        HP["shallow_diffusion_args"]["aux_decoder_args"], dropout_rate=0.0)))


def _t(x):
    return torch.from_numpy(np.array(x))


# The JAX side runs jitted: one compile of each program instead of one per op.
@pytest.fixture(scope="module")
def acoustic_params():
    """Seeded parameters of the acoustic model of HP_NO_DROP (every case
    below shares its parameter tree)."""
    jm = JaxAcoustic(HP_NO_DROP, vocab_size=VOCAB, out_dims=MELS)
    return randomize(jax.jit(jm.init)(jax.random.PRNGKey(3)), 103)


def port_acoustic(hp, params, dtype=torch.float32):
    model = DiffSingerAcoustic(hp, vocab_size=VOCAB, out_dims=MELS, dtype=dtype, device="cpu")
    model.module.load_state_dict(acoustic_state_dict_from_flax(to_numpy(params), hp))
    return model


# ------------------------------------------------------------------ F1 (bf16)

# The port casts its whole model to bf16, the JAX package only computes in it
# (float32 parameters and a float32 residual stream in places), so their bf16
# errors differ; the port's must stay within this factor of the JAX one's.
# Through a few sampler steps at these widths the error of one output moves
# by a factor of 3 either way between seeds; the mean over the outputs does not.
BF16_FACTOR = 1.5


def test_f1_acoustic_bf16_error_within_the_jax_packages(acoustic_params):
    """bf16 forward_infer of both packages on shared weights and noise, each
    against its own float32 output (f0 over the whole sung range)."""
    params = acoustic_params
    inp = acoustic_inputs(seed=4, t_mel=48)
    inp["f0"] = np.random.default_rng(1).uniform(80, 1100, inp["f0"].shape).astype(np.float32)
    noise = np.random.default_rng(5).standard_normal((2, 48, MELS)).astype(np.float32)
    keys = ("tokens", "mel2ph", "f0")

    def jrun(dtype):
        model = JaxAcoustic(HP_NO_DROP, vocab_size=VOCAB, out_dims=MELS, dtype=dtype)
        run = jax.jit(lambda p, args, n, kw: model.forward_infer(
            p, jax.random.PRNGKey(0), *args, steps=4, noise=n, **kw).diff_out)
        return np.asarray(run(params, [jnp.asarray(inp[k]) for k in keys], jnp.asarray(noise),
                              jax_kwargs(inp)), np.float32)

    def prun(dtype):
        return port_acoustic(HP_NO_DROP, params, dtype).forward_infer(
            *(_t(inp[k]) for k in keys), steps=4, noise=_t(noise),
            **port_kwargs(inp)).diff_out.float().numpy()

    jax_err = np.abs(jrun(jnp.bfloat16) - jrun(None)).mean()
    port_err = np.abs(prun(torch.bfloat16) - prun(torch.float32)).mean()
    assert 0 < port_err <= BF16_FACTOR * jax_err, (port_err, jax_err)


def test_f1_variance_bf16_error_within_the_jax_packages():
    """The same for durations, pitch and three curves; the error is the sum of
    their mean absolute errors (in frames, semitones and the curves' units)."""
    params = randomize(jax.jit(JaxVariance(VAR_HP, vocab_size=VOCAB).init)(
        jax.random.PRNGKey(6)), 106)
    inp = variance_inputs(7)
    args = ("tokens", "midi", "ph2word", "base_pitch")
    rng = np.random.default_rng(8)
    b, t_s = inp["base_pitch"].shape
    noise_p = rng.standard_normal((b, t_s, 8)).astype(np.float32)
    noise_v = rng.standard_normal((b, t_s, 12)).astype(np.float32)

    def jrun(dtype):
        model = JaxVariance(VAR_HP, vocab_size=VOCAB, dtype=dtype)
        run = jax.jit(lambda p, a, wd, n_p, n_v: model.forward_infer(
            p, jax.random.PRNGKey(8), *a, word_dur=wd, noise_pitch=n_p, noise_variances=n_v))
        dur, pitch, var = run(params, [jnp.asarray(inp[k]) for k in args],
                              jnp.asarray(inp["word_dur"]), jnp.asarray(noise_p),
                              jnp.asarray(noise_v))
        return [np.asarray(x, np.float32) for x in (dur, pitch, *var.values())]

    def prun(dtype):
        model = DiffSingerVariance(VAR_HP, vocab_size=VOCAB, dtype=dtype, device="cpu")
        model.module.load_state_dict(variance_state_dict_from_flax(to_numpy(params), VAR_HP))
        dur, pitch, var = model.forward_infer(
            *(_t(inp[k]) for k in args), word_dur=_t(inp["word_dur"]),
            noise_pitch=_t(noise_p), noise_variances=_t(noise_v))
        return [x.float().numpy() for x in (dur, pitch, *var.values())]

    want32, want16 = jrun(None), jrun(jnp.bfloat16)
    got32, got16 = prun(torch.float32), prun(torch.bfloat16)
    jax_err = sum(np.abs(a - b).mean() for a, b in zip(want16, want32))
    port_err = sum(np.abs(a - b).mean() for a, b in zip(got16, got32))
    assert 0 < port_err <= BF16_FACTOR * jax_err, (port_err, jax_err)


def test_f1_curve_embeds_stay_float32_in_a_bf16_model(acoustic_params):
    """The Linear(1, H) embeds keep float32 parameters through the cast and
    the load, and give the float32 model's values to the last bit."""
    port = port_acoustic(HP_NO_DROP, acoustic_params)
    bf = port_acoustic(HP_NO_DROP, acoustic_params, torch.bfloat16)
    embeds = [(n, m) for n, m in bf.module.named_modules() if isinstance(m, commons.CurveEmbed)]
    assert sorted(n for n, _ in embeds) == ["fs2.dur_embed", "fs2.key_shift_embed",
                                           "fs2.pitch_embed", "fs2.variance_embeds.energy"]
    f0 = torch.from_numpy(np.linspace(80, 1100, 40, dtype=np.float32))[None]
    for name, m in embeds:
        assert m.weight.dtype == m.bias.dtype == torch.float32, name
        ref = port.module.get_submodule(name)
        assert torch.equal(m.weight, ref.weight) and torch.equal(m(f0), ref(f0)), name
    assert bf.module.fs2.encoder.layers[0].op.ffn.ffn_2.weight.dtype == torch.bfloat16
    var = DiffSingerVariance(VAR_HP, vocab_size=VOCAB, dtype=torch.bfloat16, device="cpu")
    assert {n for n, m in var.module.named_modules() if isinstance(m, commons.CurveEmbed)
            and m.weight.dtype == torch.float32} >= {"fs2.word_dur_embed", "base_pitch_embed",
                                                     "pitch_embed"}


# ------------------------------------------------------------------ draws and losses

def test_reflow_p_losses_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 20, 8)).astype(np.float32)
    t = rng.uniform(0.4, 1.0, 2).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jx, jv = jreflow.p_losses_inputs(jnp.asarray(x), jnp.asarray(t), key)
    noise = np.asarray(jax.random.normal(key, x.shape, jnp.float32))
    px, pv = reflow.p_losses_inputs(_t(x), _t(t), noise=_t(noise))
    np.testing.assert_allclose(px.numpy(), jx, atol=1e-6)
    np.testing.assert_allclose(pv.numpy(), jv, atol=1e-6)
    g = torch.Generator().manual_seed(1)
    a = reflow.p_losses_inputs(_t(x), _t(t), generator=g)
    assert a[0].shape == x.shape and not torch.equal(a[0], px)


def test_ddpm_p_losses_inputs():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((3, 20, 8)).astype(np.float32)
    t = np.array([0, 57, 399], np.int32)
    key = jax.random.PRNGKey(4)
    jx, jn = jddpm.p_losses_inputs(JaxSchedule.create("linear", 1000), jnp.asarray(x),
                                   jnp.asarray(t), key)
    px, pn = ddpm.p_losses_inputs(DiffusionSchedule.create("linear", 1000), _t(x), _t(t),
                                  noise=_t(np.asarray(jn)))
    np.testing.assert_allclose(px.numpy(), jx, atol=1e-6)
    assert torch.equal(pn, _t(np.asarray(jn)))


@pytest.mark.parametrize("loss_type", ["l1", "l2"])
@pytest.mark.parametrize("log_norm", [False, True])
def test_losses(loss_type, log_norm):
    """diffusion, reflow (logit-normal weights) and aux losses, masked, in
    float32 from bf16 inputs; 1e-6 relative."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 16, 8)).astype(np.float32)
    b = rng.standard_normal((3, 16, 8)).astype(np.float32)
    t = np.array([0.0, 0.41, 0.999], np.float32)
    nonpadding = (rng.random((3, 16)) < 0.8).astype(np.float32)
    a16 = torch.from_numpy(a).bfloat16()
    j16 = jnp.asarray(a16.float().numpy()).astype(jnp.bfloat16)
    pairs = [
        (losses.reflow_loss(a16, _t(b), _t(t), _t(nonpadding), loss_type=loss_type,
                            log_norm=log_norm),
         jlosses.reflow_loss(j16, jnp.asarray(b), jnp.asarray(t), jnp.asarray(nonpadding),
                             loss_type=loss_type, log_norm=log_norm)),
        (losses.diffusion_loss(a16, _t(b), _t(nonpadding), loss_type=loss_type),
         jlosses.diffusion_loss(j16, jnp.asarray(b), jnp.asarray(nonpadding),
                                loss_type=loss_type)),
        (losses.aux_mel_loss(a16, _t(b), _t(nonpadding)),
         jlosses.aux_mel_loss(j16, jnp.asarray(b), jnp.asarray(nonpadding))),
        (losses.diffusion_loss(_t(a), _t(b), None, loss_type=loss_type),
         jlosses.diffusion_loss(jnp.asarray(a), jnp.asarray(b), None, loss_type=loss_type)),
    ]
    for got, want in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ------------------------------------------------------------------ K3 and K2 backward

def test_k3_plain_backward_matches_jax_grad_of_self_attention():
    """Gradients of RoPE self-attention with padded rows, through
    FlashAttentionFn on the CPU (K3's plain backward), against jax.grad of the
    JAX module's einsum path (keys masked only). The encoder zeroes pad rows,
    so their output gradient is zero; 1e-5 relative to each gradient's max."""
    rng = np.random.default_rng(2)
    b, length, c, h = 3, 20, 32, 2
    x = rng.standard_normal((b, length, c)).astype(np.float32)
    pad = np.zeros((b, length), bool)
    pad[1, 15:] = True
    pad[2, 6:] = True
    g = rng.standard_normal((b, length, c)).astype(np.float32) * (~pad)[:, :, None]
    jattn = jcommons.SelfAttentionRoPE(c, h, use_flash=False)
    p = jattn.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(pad))["params"]

    def jloss(p, x):
        return jnp.sum(jattn.apply({"params": p}, x, jnp.asarray(pad)) * g)

    jgp, jgx = jax.grad(jloss, argnums=(0, 1))(p, jnp.asarray(x))
    attn = commons.SelfAttentionRoPE(c, h)
    with torch.no_grad():
        attn.in_proj.weight.copy_(_t(np.asarray(p["in_proj"]["kernel"]).T))
        attn.out_proj.weight.copy_(_t(np.asarray(p["out_proj"]["kernel"]).T))
    xt = _t(x).requires_grad_()
    (attn(xt, _t(pad)) * _t(g)).sum().backward()
    for got, want in ((xt.grad, jgx), (attn.in_proj.weight.grad, np.asarray(jgp["in_proj"]["kernel"]).T),
                      (attn.out_proj.weight.grad, np.asarray(jgp["out_proj"]["kernel"]).T)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-5 * np.abs(want).max()


def test_k3_plain_backward_is_the_gradient_of_segment_attention():
    """Where pad rows get a gradient too, the plain backward is autograd of
    the segment-masked softmax (pad rows see pad keys), in float64."""
    rng = np.random.default_rng(3)
    q, k, v, dout = (rng.standard_normal((2, 2, 24, 32)) for _ in range(4))
    pad = np.zeros((2, 24), bool)
    pad[1, 10:] = True
    scale = 32 ** -0.5
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    vis = ~(_t(pad)[:, None, :, None] ^ _t(pad)[:, None, None, :])
    out = torch.softmax((qt @ kt.transpose(-1, -2) * scale).masked_fill(~vis, -np.inf), -1) @ vt
    want = torch.autograd.grad(out, (qt, kt, vt), _t(dout))
    f = [_t(a).float() for a in (q, k, v)]
    lse = fa.attention_lse_plain(f[0], f[1], _t(pad), sm_scale=scale)
    got = fa.flash_attention_bwd_plain(*f, _t(pad), out.detach().float(), lse, _t(dout).float(),
                                       sm_scale=scale)
    for a, w in zip(got, want):
        assert (a.double() - w).abs().max() <= 1e-5 * w.abs().max()


def test_k2_function_backward_matches_autograd_of_the_plain_version():
    torch.manual_seed(0)
    m = LYNXConvModule(32, 2, 31)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.1 * torch.randn_like(p))
    x = torch.randn(2, 40, 32, requires_grad=True)
    y = m(x)
    dy = torch.randn_like(y)
    got = torch.autograd.grad(y, [x, *m.parameters()], dy)
    ref = lynx_fused.fused_conv_module_plain(x, **lynx_fused.conv_module_params_from_module(m))
    want = torch.autograd.grad(ref, [x, *m.parameters()], dy)
    assert torch.equal(y, ref)
    for a, w in zip(got, want):
        assert (a - w).abs().max() <= 1e-5 * w.abs().max()


# ------------------------------------------------------------------ forward_train

TRAIN_CASES = {
    "reflow": dict(HP_NO_DROP),
    "reflow_l1_log_norm": dict(HP_NO_DROP, main_loss_type="l1", main_loss_log_norm=True),
    "ddpm": dict(HP_NO_DROP, diffusion_type="ddpm", K_step=400),
}


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_forward_train_losses_and_every_gradient_match_jax_grad(case, acoustic_params):
    """The losses and the gradient of every parameter (mapped through
    acoustic_state_dict_from_flax) against jax.grad of the JAX loss function,
    the aux_decoder_grad mix included; the JAX draws (t, noise) injected.
    Losses 1e-5 relative; each gradient within 1e-4 of its largest entry."""
    hp = TRAIN_CASES[case]
    params = acoustic_params
    jm = JaxAcoustic(hp, vocab_size=VOCAB, out_dims=MELS)
    port = port_acoustic(hp, params)
    inp = acoustic_inputs(seed=12, t_mel=40)
    b = inp["tokens"].shape[0]
    mel = np.random.default_rng(13).uniform(-11, -1, (b, 40, MELS)).astype(np.float32)
    batch = dict(tokens=inp["tokens"], mel2ph=inp["mel2ph"], f0=inp["f0"], mel=mel,
                 energy=inp["energy"], key_shift=inp["key_shift"])
    rng = jax.random.PRNGKey(14)
    (jtotal, jmetrics), jgrads = jax.jit(jax.value_and_grad(jax_loss_fn(jm), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    _, rng_t, rng_noise = jax.random.split(rng, 3)
    if hp["diffusion_type"] == "ddpm":
        t = jax.random.randint(rng_t, (b,), 0, jm.k_step)
    else:
        t = jm.t_start + (1.0 - jm.t_start) * jax.random.uniform(rng_t, (b,))
    noise = jax.random.normal(rng_noise, mel.shape, jnp.float32)

    port.module.train()
    total, plosses = make_acoustic_loss_fn(port)(
        {k: _t(v) for k, v in batch.items()}, t=_t(t), noise=_t(noise))
    total.backward()
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
