"""``recompute_grads`` in the PyTorch port against the JAX package, on the CPU
in float32 at narrow widths: every accepted value (True, 'full', 'dots',
'dots_no_batch') recomputes the denoiser's layers (LYNXNet, WaveNet) on the
backward pass without changing the loss or any gradient. Held against the
port without recomputation at 1e-6 (the JAX package's own bound for its
remat, ``tests/test_training.py``), and against ``jax.grad`` of the JAX model
with the same value, the same weights and the same draws at 1e-4 of each
gradient's largest entry (``PERF.md`` section 2). The JAX side runs as one
jitted program a family, which holds the gradient of each policy that JAX
resolves differently; its weights come from the port's init through the JAX
package's converter (cheaper than the JAX init).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.models import commons as jcommons
from diffsinger_tpu.models.toplevel import DiffSingerAcoustic as JaxAcoustic
from diffsinger_tpu.models.toplevel import DiffSingerVariance as JaxVariance
from diffsinger_tpu.training.acoustic_task import make_acoustic_loss_fn as jax_acoustic_loss
from diffsinger_tpu.training.variance_task import make_variance_loss_fn as jax_variance_loss
from diffsinger_tpu.utils.torch_model_convert import convert_acoustic
from diffsinger_tpu_torch.models import commons
from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic
from diffsinger_tpu_torch.ops import lynx_fused
from diffsinger_tpu_torch.training.acoustic_task import make_acoustic_loss_fn
from diffsinger_tpu_torch.training.variance_task import make_variance_loss_fn
from diffsinger_tpu_torch.utils.convert import (
    acoustic_state_dict_from_flax, variance_state_dict_from_flax)
from tests.test_torch_train import HP_NO_DROP
from tests.test_torch_train_variance import VAR_HP_NO_DROP, _batch, _jax_draws, seeded_pair
from tests.torch_parity import (
    MELS, VOCAB, acoustic_inputs, port_kwargs, randomize, to_numpy)

REMATS = (True, "full", "dots", "dots_no_batch")
aten = torch.ops.aten


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_key(remat):
    """JAX's own resolution of a value: one gradient for each."""
    return jcommons.resolve_remat_policy(remat)


def _jax_grads(model_of, loss_of, params, batch, rng, extra=None):
    """(loss, gradients) of the JAX loss under each policy that JAX resolves
    differently, keyed by its resolution, from one jitted program; with
    ``extra(model, rng)`` its value too (the draws)."""
    keys = list(dict.fromkeys(_jax_key(r) for r in REMATS))
    models = [model_of(next(r for r in REMATS if _jax_key(r) == k)) for k in keys]

    def run(params, batch, rng):
        out = [jax.value_and_grad(loss_of(m), has_aux=True)(params, batch, rng) for m in models]
        return out, (extra(models[0], rng) if extra else None)

    out, more = jax.jit(run)(params, batch, rng)
    return {k: (float(total), grads) for k, ((total, _), grads) in zip(keys, out)}, more


def _grads(module):
    return {n: p.grad.detach().clone() for n, p in module.named_parameters()}


def _assert_equal_grads(got, want, atol=1e-6):
    assert set(got) == set(want)
    for name, w in want.items():
        assert (got[name] - w).abs().max().item() <= atol, name


def _assert_jax_grads(got, want):
    assert set(got) == set(want)
    for name, w in want.items():
        w = w.numpy()
        assert np.abs(got[name].numpy() - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-6), name


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The narrow models run on one intra-op thread: beside other test
    processes, more threads only wait on each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ the policies

def test_policies_save_the_products_that_jax_saves():
    """'dots' keeps the outputs of mm, addmm, bmm and baddbmm (jax's
    dots_saveable: every dot_general), not a convolution's; 'dots_no_batch'
    keeps no batched product; K2's operator is recomputed under both."""
    from torch.utils.checkpoint import CheckpointPolicy

    def saved(remat):
        _, context_fn = commons.resolve_remat_policy(remat)
        policy = context_fn.args[0]
        ops = (aten.mm.default, aten.addmm.default, aten.bmm.default, aten.baddbmm.default,
               aten.convolution.default, aten.sigmoid.default, aten.native_layer_norm.default,
               torch.ops.ds.fused_conv_module.default)
        return {op.overloadpacket for op in ops
                if policy(None, op) == CheckpointPolicy.MUST_SAVE}

    assert saved("dots") == {aten.mm, aten.addmm, aten.bmm, aten.baddbmm}
    assert saved("dots_no_batch") == {aten.mm, aten.addmm}
    for remat in (True, "full", 1):
        assert commons.resolve_remat_policy(remat) == (True, None)
    for remat in (False, None, 0, ""):
        assert commons.resolve_remat_policy(remat) == (False, None)


@pytest.mark.parametrize("bad", ["dot", "everything", "Full"])
def test_an_unknown_value_raises(bad):
    """As the JAX function raises, naming the accepted values; at build time."""
    with pytest.raises(ValueError) as want:
        jcommons.resolve_remat_policy(bad)
    with pytest.raises(ValueError) as got:
        commons.resolve_remat_policy(bad)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="expected bool, 'full', 'dots', or 'dots_no_batch'"):
        DiffSingerAcoustic(dict(HP_NO_DROP, recompute_grads=bad), vocab_size=VOCAB,
                           out_dims=MELS, device="cpu")


# ------------------------------------------------------------------ LYNXNet

@pytest.fixture(scope="module")
def acoustic_case():
    """Seeded weights of the narrow acoustic model, a batch, the JAX draws
    (t, noise) and jax.grad of the JAX loss under each JAX policy."""
    hp = HP_NO_DROP
    torch.manual_seed(3)
    port = DiffSingerAcoustic(hp, vocab_size=VOCAB, out_dims=MELS, device="cpu")
    params = randomize(convert_acoustic(port.module.state_dict(), hp), 103)
    inp = acoustic_inputs(seed=12, t_mel=40)
    b = inp["tokens"].shape[0]
    mel = np.random.default_rng(13).uniform(-11, -1, (b, 40, MELS)).astype(np.float32)
    batch = dict(tokens=inp["tokens"], mel2ph=inp["mel2ph"], f0=inp["f0"], mel=mel,
                 energy=inp["energy"], key_shift=inp["key_shift"])

    def draws(jm, rng):
        _, rng_t, rng_noise = jax.random.split(rng, 3)
        return dict(t=jm.t_start + (1.0 - jm.t_start) * jax.random.uniform(rng_t, (b,)),
                    noise=jax.random.normal(rng_noise, mel.shape, jnp.float32))

    jax_grads, jdraws = _jax_grads(
        lambda r: JaxAcoustic(dict(hp, recompute_grads=r), vocab_size=VOCAB, out_dims=MELS),
        jax_acoustic_loss, params, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(14), draws)
    jax_grads = {k: (total, acoustic_state_dict_from_flax(to_numpy(g), hp))
                 for k, (total, g) in jax_grads.items()}
    return dict(hp=hp, params=params, batch={k: _t(v) for k, v in batch.items()},
                draws=jax.tree.map(_t, jdraws), jax_grads=jax_grads)


def _acoustic_run(case, remat, dropout=0.0):
    """The port's loss and gradients with ``recompute_grads=remat``; with
    ``dropout`` in LYNXNet's conv modules, drawn from torch's generator
    seeded 5 before the forward."""
    hp = dict(case["hp"], recompute_grads=remat)
    hp["backbone_args"] = dict(hp["backbone_args"], dropout_rate=dropout)
    port = DiffSingerAcoustic(hp, vocab_size=VOCAB, out_dims=MELS, device="cpu")
    port.module.load_state_dict(acoustic_state_dict_from_flax(to_numpy(case["params"]), hp))
    port.module.train()
    torch.manual_seed(5)
    total, _ = make_acoustic_loss_fn(port)(case["batch"], **case["draws"])
    total.backward()
    return float(total.detach()), _grads(port.module)


@pytest.fixture(scope="module")
def acoustic_plain(acoustic_case):
    return {dropout: _acoustic_run(acoustic_case, False, dropout) for dropout in (0.0, 0.1)}


@pytest.mark.parametrize("remat", REMATS)
def test_lynxnet_gradients_equal_without_recompute_and_jax(remat, acoustic_case, acoustic_plain):
    total, grads = _acoustic_run(acoustic_case, remat)
    total0, grads0 = acoustic_plain[0.0]
    assert total == total0
    _assert_equal_grads(grads, grads0)
    jtotal, jgrads = acoustic_case["jax_grads"][_jax_key(remat)]
    np.testing.assert_allclose(total, jtotal, rtol=1e-5)
    _assert_jax_grads(grads, jgrads)


@pytest.mark.parametrize("remat", REMATS)
def test_lynxnet_dropout_masks_are_replayed(remat, acoustic_case, acoustic_plain):
    """Dropout 0.1 in every conv module: the recomputation draws the masks
    of the forward again (the generators' states replayed), so the gradients
    equal those without recomputation."""
    total, grads = _acoustic_run(acoustic_case, remat, dropout=0.1)
    total0, grads0 = acoustic_plain[0.1]
    assert total == total0 and total0 != acoustic_plain[0.0][0]
    _assert_equal_grads(grads, grads0)


def test_k2_is_recomputed_in_each_layer(monkeypatch):
    """Under every policy K2's forward runs again in the backward of each
    LYNXNet layer (it is one operator, which no policy saves): two forward
    calls a layer a step, counted at the operator."""
    layers = HP_NO_DROP["backbone_args"]["num_layers"]
    inp = acoustic_inputs(seed=2, t_mel=40)
    mel = np.random.default_rng(3).uniform(-11, -1, (2, 40, MELS)).astype(np.float32)
    batch = {k: _t(v) for k, v in dict(tokens=inp["tokens"], mel2ph=inp["mel2ph"], f0=inp["f0"],
                                        mel=mel, energy=inp["energy"],
                                        key_shift=inp["key_shift"]).items()}
    calls = []
    op = lynx_fused.fused_conv_module_op

    def counted(*args, **kwargs):
        calls.append(1)
        return op(*args, **kwargs)

    monkeypatch.setattr(lynx_fused, "fused_conv_module_op", counted)
    for remat in (False, *REMATS):
        torch.manual_seed(0)
        port = DiffSingerAcoustic(dict(HP_NO_DROP, recompute_grads=remat), vocab_size=VOCAB,
                                  out_dims=MELS, device="cpu")
        port.module.train()
        calls.clear()
        total, _ = make_acoustic_loss_fn(port)(batch, t=torch.full((2,), 0.7),
                                               noise=torch.randn(2, 40, MELS))
        assert len(calls) == layers, remat
        total.backward()
        assert len(calls) == (layers if remat is False else 2 * layers), remat


def test_inference_is_unchanged(acoustic_case):
    """forward_infer with recompute_grads set gives the output without it, bit for bit."""
    inp = acoustic_inputs(seed=4, t_mel=48)
    out = {}
    for remat in (False, "full", "dots"):
        hp = dict(acoustic_case["hp"], recompute_grads=remat)
        port = DiffSingerAcoustic(hp, vocab_size=VOCAB, out_dims=MELS, device="cpu")
        port.module.load_state_dict(acoustic_state_dict_from_flax(
            to_numpy(acoustic_case["params"]), hp))
        noise = torch.randn(2, 48, MELS, generator=torch.Generator().manual_seed(6))
        with torch.no_grad():
            out[remat] = port.forward_infer(_t(inp["tokens"]), _t(inp["mel2ph"]), _t(inp["f0"]),
                                            steps=4, noise=noise, **port_kwargs(inp)).diff_out
    assert torch.equal(out["full"], out[False]) and torch.equal(out["dots"], out[False])


# ------------------------------------------------------------------ WaveNet

@pytest.fixture(scope="module")
def variance_case():
    hp = dict(VAR_HP_NO_DROP, main_loss_log_norm=True)
    params, port = seeded_pair(hp, 41)
    batch, var_list = _batch(hp, seed=42)
    b, t = batch["mel2ph"].shape
    jax_grads, jdraws = _jax_grads(
        lambda r: JaxVariance(dict(hp, recompute_grads=r), vocab_size=VOCAB),
        jax_variance_loss, params, {k: jnp.asarray(v) for k, v in batch.items()},
        jax.random.PRNGKey(43), lambda jm, rng: _jax_draws(jm, hp, var_list, rng, b, t))
    jax_grads = {k: (total, variance_state_dict_from_flax(to_numpy(g), hp))
                 for k, (total, g) in jax_grads.items()}
    draws = jax.tree.map(_t, jdraws)
    plain = _variance_run(hp, port.module.state_dict(), batch, draws, False)
    return dict(hp=hp, state=port.module.state_dict(), batch=batch, draws=draws,
                jax_grads=jax_grads, plain=plain)


def _variance_run(hp, state, batch, draws, remat):
    from diffsinger_tpu_torch.models.toplevel import DiffSingerVariance

    port = DiffSingerVariance(dict(hp, recompute_grads=remat), vocab_size=VOCAB, device="cpu")
    port.module.load_state_dict(state)
    port.module.train()
    total, _ = make_variance_loss_fn(port)({k: _t(v) for k, v in batch.items()}, **draws)
    total.backward()
    return float(total.detach()), _grads(port.module)


@pytest.mark.parametrize("remat", REMATS)
def test_wavenet_gradients_equal_without_recompute_and_jax(remat, variance_case):
    c = variance_case
    total, grads = _variance_run(c["hp"], c["state"], c["batch"], c["draws"], remat)
    total0, grads0 = c["plain"]
    assert total == total0
    _assert_equal_grads(grads, grads0)
    jtotal, jgrads = c["jax_grads"][_jax_key(remat)]
    np.testing.assert_allclose(total, jtotal, rtol=1e-5)
    _assert_jax_grads(grads, jgrads)
