"""The variance model's training path in the PyTorch port against the JAX
package, on the CPU in float32 at narrow widths: the duration loss, the
validation metrics, the retake masks, the dropout settings of the encoders
(F2) and the duration predictor's training output (F3), and
``forward_train``'s losses and every parameter gradient against ``jax.grad``
of ``make_variance_loss_fn`` (dropout off, the JAX draws injected). Each
tolerance is stated where it is held.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.models import losses as jlosses
from diffsinger_tpu.models import metrics as jmetrics
from diffsinger_tpu.models.toplevel import DiffSingerVariance as JaxVariance
from diffsinger_tpu.training.variance_task import make_variance_loss_fn as jax_loss_fn
from diffsinger_tpu.training.variance_task import random_retake_masks as jax_retake_masks
from diffsinger_tpu.utils.torch_model_convert import convert_variance
from diffsinger_tpu_torch.models import losses, metrics
from diffsinger_tpu_torch.models.toplevel import DiffSingerVariance
from diffsinger_tpu_torch.models.variance_encoder import FastSpeech2Variance, MelodyEncoder
from diffsinger_tpu_torch.training.base_task import pad_batch_rows
from diffsinger_tpu_torch.training.variance_task import make_variance_loss_fn, random_retake_masks
from diffsinger_tpu_torch.utils.convert import variance_state_dict_from_flax
from tests.test_torch_variance import variance_inputs
from tests.torch_parity import VAR_HP, VOCAB, randomize, to_numpy

# dropout off on both sides: two random generators cannot share masks
VAR_HP_NO_DROP = dict(VAR_HP, dropout=0.0, dur_prediction_args=dict(
    VAR_HP["dur_prediction_args"], dropout=0.0, loss_type="mse", lambda_pdur_loss=0.3,
    lambda_wdur_loss=1.0, lambda_sdur_loss=3.0), lambda_dur_loss=1.0, lambda_pitch_loss=1.0,
    lambda_var_loss=1.0, main_loss_type="l2", main_loss_log_norm=False)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------------------------------ dur_loss

def _dur_inputs(seed):
    """Three rows of durations, the last with no valid token (a row that
    pad_batch_rows adds), ragged words."""
    rng = np.random.default_rng(seed)
    b, t = 3, 14
    ph2word = np.zeros((b, t), np.int32)
    ph2word[0, :14] = np.cumsum(np.r_[1, rng.random(13) < 0.5])
    ph2word[1, :9] = np.cumsum(np.r_[1, rng.random(8) < 0.4])
    nonpadding = (ph2word > 0).astype(np.float32)
    dur_gt = rng.integers(1, 30, (b, t)).astype(np.int32) * (ph2word > 0)
    dur_gt[2] = rng.integers(1, 30, t)  # payload in the empty row must not count
    pred_log = rng.normal(2.0, 1.5, (b, t)).astype(np.float32)
    pred_log[0, :3] = -4.0  # clamped at 0 before the word and sentence logs
    return pred_log, dur_gt, ph2word, nonpadding


@pytest.mark.parametrize("loss_type", ["mse", "huber"])
def test_dur_loss_matches_jax(loss_type):
    """Phoneme, word and sentence terms with padded positions and a row of
    zero weight; 1e-6 relative, also from bf16 predictions."""
    pred_log, dur_gt, ph2word, nonpadding = _dur_inputs(1)
    kw = dict(offset=1.0, loss_type=loss_type, lambda_pdur=0.3, lambda_wdur=1.0, lambda_sdur=3.0)
    want = jlosses.dur_loss(jnp.asarray(pred_log), jnp.asarray(dur_gt), jnp.asarray(ph2word),
                            jnp.asarray(nonpadding), **kw)
    got = losses.dur_loss(_t(pred_log), _t(dur_gt), _t(ph2word), _t(nonpadding), **kw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    p16 = _t(pred_log).bfloat16()
    want16 = jlosses.dur_loss(jnp.asarray(p16.float().numpy()).astype(jnp.bfloat16),
                              jnp.asarray(dur_gt), jnp.asarray(ph2word), jnp.asarray(nonpadding),
                              **kw)
    got16 = losses.dur_loss(p16, _t(dur_gt), _t(ph2word), _t(nonpadding), **kw)
    assert got16.dtype == torch.float32
    np.testing.assert_allclose(float(got16), float(want16), rtol=1e-6)
    # the empty row's payload does not reach the loss
    garbled = dur_gt.copy()
    garbled[2] = 99
    again = losses.dur_loss(_t(pred_log), _t(garbled), _t(ph2word), _t(nonpadding), **kw)
    assert float(again) == float(got)


# ------------------------------------------------------------------ metrics

def _metric_inputs(seed):
    rng = np.random.default_rng(seed)
    pred_log, dur_gt, ph2word, nonpadding = _dur_inputs(seed)
    dur_pred = np.round(dur_gt * rng.uniform(0.8, 1.2, dur_gt.shape)).astype(np.float32)
    target = rng.normal(60, 4, (3, 40)).astype(np.float32)
    pred = (target + rng.normal(0, 0.6, target.shape)).astype(np.float32)
    mask = rng.random((3, 40)) < 0.7
    return dur_pred, dur_gt.astype(np.float32), ph2word, nonpadding > 0, pred, target, mask


def test_metrics_match_jax():
    """The four metrics, streamed over two batches, with and without masks:
    the port's values equal the JAX ones within 1e-6, and the port keeps its
    sums as tensors until value() is read."""
    for use_mask in (True, False):
        jstates = [jmetrics.MetricState(), jmetrics.MetricState(), jmetrics.MetricState(),
                   jmetrics.R2State()]
        pstates = [metrics.MetricState(), metrics.MetricState(), metrics.MetricState(),
                   metrics.R2State()]
        for seed in (2, 3):
            dp, dg, p2w, nonpad, pred, target, mask = _metric_inputs(seed)
            m_ph = nonpad if use_mask else None
            m_fr = mask if use_mask else None
            j = [jnp.asarray(a) for a in (dp, dg, p2w, pred, target)]
            jm_ph = None if m_ph is None else jnp.asarray(m_ph)
            jm_fr = None if m_fr is None else jnp.asarray(m_fr)
            jstates = [
                jmetrics.RhythmCorrectness(0.05).update(jstates[0], j[0], j[1], j[2], jm_ph),
                jmetrics.PhonemeDurationAccuracy(0.2).update(jstates[1], j[0], j[1], j[2], jm_ph),
                jmetrics.RawCurveAccuracy(0.5).update(jstates[2], j[3], j[4], jm_fr),
                jmetrics.RawCurveR2Score().update(jstates[3], j[3], j[4], jm_fr),
            ]
            t = [_t(a) for a in (dp, dg, p2w, pred, target)]
            tm_ph = None if m_ph is None else _t(m_ph)
            tm_fr = None if m_fr is None else _t(m_fr)
            pstates = [
                metrics.RhythmCorrectness(0.05).update(pstates[0], t[0], t[1], t[2], tm_ph),
                metrics.PhonemeDurationAccuracy(0.2).update(pstates[1], t[0], t[1], t[2], tm_ph),
                metrics.RawCurveAccuracy(0.5).update(pstates[2], t[3], t[4], tm_fr),
                metrics.RawCurveR2Score().update(pstates[3], t[3], t[4], tm_fr),
            ]
        assert all(isinstance(s.num, torch.Tensor) for s in pstates[:3])
        for p, j in zip(pstates, jstates):
            assert 0 < p.value() <= 1
            np.testing.assert_allclose(p.value(), j.value(), rtol=1e-6)


# ------------------------------------------------------------------ retake masks

def test_random_retake_masks_equal_the_jax_ones_given_its_draws():
    b, t = 64, 50
    for seed in range(3):
        rng = jax.random.PRNGKey(seed)
        want = np.asarray(jax_retake_masks(rng, b, t))
        rng_b, rng_lo, rng_hi = jax.random.split(rng, 3)
        draws = [_t(jax.random.randint(rng_b, (b, 1), 0, 4)),
                 _t(jax.random.randint(rng_lo, (b,), 0, t + 1)),
                 _t(jax.random.randint(rng_hi, (b,), 0, t + 1))]
        got = random_retake_masks(b, t, draws=draws)
        assert got.dtype == torch.bool and np.array_equal(got.numpy(), want)
    masks = random_retake_masks(1000, 50, generator=torch.Generator().manual_seed(0))
    assert 0.35 < masks.float().mean().item() < 0.65  # about half the frames


# ------------------------------------------------------------------ F2, F3

def test_f2_encoders_take_the_configs_dropout():
    """The variance encoder and the duration predictor carry the config's
    rates, the melody encoder its own or else the config's; with the rates at
    0, training mode gives the eval-mode output (it did not before F2: the
    encoders kept a rate of 0.1)."""
    hp = dict(VAR_HP, dropout=0.3, dur_prediction_args=dict(VAR_HP["dur_prediction_args"],
                                                            dropout=0.2))
    fs2 = FastSpeech2Variance.from_hparams(hp, VOCAB)
    rates = {m.p for n, m in fs2.named_modules() if isinstance(m, torch.nn.Dropout)
             and not n.startswith("dur_predictor")}
    assert rates == {0.3}
    assert [block[4].p for block in fs2.dur_predictor.conv] == [0.2] * 2
    assert {m.p for m in MelodyEncoder.from_hparams(hp).modules()
            if isinstance(m, torch.nn.Dropout)} == {0.3}
    own = dict(hp, melody_encoder_args=dict(hp["melody_encoder_args"], dropout=0.05))
    assert {m.p for m in MelodyEncoder.from_hparams(own).modules()
            if isinstance(m, torch.nn.Dropout)} == {0.05}

    inp = variance_inputs(4)
    torch.manual_seed(0)
    fs2 = FastSpeech2Variance.from_hparams(VAR_HP_NO_DROP, VOCAB)
    mel = MelodyEncoder.from_hparams(dict(VAR_HP_NO_DROP, use_glide_embed=True))
    args = [_t(inp[k]) for k in ("tokens", "midi", "ph2word")]
    notes = [_t(inp[k]) for k in ("note_midi", "note_rest", "note_dur")]
    outs = []
    with torch.no_grad():
        for mode in (False, True):
            fs2.train(mode)
            mel.train(mode)
            outs.append((fs2(*args, ph_dur=_t(inp["ph_dur"]), infer=False),
                         mel(*notes, glide=_t(inp["note_glide"]))))
    (enc_e, dur_e), mel_e = outs[0]
    (enc_t, dur_t), mel_t = outs[1]
    assert torch.equal(enc_e, enc_t) and torch.equal(dur_e, dur_t) and torch.equal(mel_e, mel_t)


def test_f3_duration_predictor_training_output():
    """infer=False gives the log-domain output whose exp - offset, clamped,
    is the inference output; the encoder then sums word durations from
    ph_dur even where word_dur is given."""
    inp = variance_inputs(5)
    torch.manual_seed(1)
    fs2 = FastSpeech2Variance.from_hparams(VAR_HP_NO_DROP, VOCAB).eval()
    args = [_t(inp[k]) for k in ("tokens", "midi", "ph2word")]
    with torch.no_grad():
        enc_i, dur_i = fs2(*args, ph_dur=_t(inp["ph_dur"]))
        enc_l, dur_log = fs2(*args, ph_dur=_t(inp["ph_dur"]), word_dur=_t(inp["word_dur"] + 7),
                             infer=False)
        _, dur_given = fs2(*args, ph_dur=_t(inp["ph_dur"]), word_dur=_t(inp["word_dur"] + 7))
    assert torch.equal(enc_i, enc_l)
    assert torch.equal(torch.clamp(torch.exp(dur_log) - 1.0, min=0.0), dur_i)
    assert (dur_log < 0).any()  # log domain: not clamped
    assert not torch.equal(dur_given, dur_i)  # at inference the given word_dur counts


# ------------------------------------------------------------------ forward_train

TRAIN_CASES = {
    "reflow_log_norm": dict(main_loss_log_norm=True),
    "ddpm": dict(diffusion_type="ddpm", K_step=1000, main_loss_type="l1"),
    "melody_glide": dict(use_melody_encoder=True, use_glide_embed=True, predict_voicing=True,
                         melody_encoder_args=dict(hidden_size=16, enc_layers=2),
                         variances_prediction_args=dict(
                             VAR_HP["variances_prediction_args"], total_repeat_bins=16)),
    "phoneme_mode": dict(predict_dur=False, main_loss_log_norm=True),
    "spk_lang": dict(use_spk_id=True, num_spk=3, use_lang_id=True, num_lang=2,
                     dur_prediction_args=dict(VAR_HP_NO_DROP["dur_prediction_args"],
                                              loss_type="huber")),
}


def _batch(hp, seed):
    """A variance batch of three rows: two rows of a score and a row that
    pad_batch_rows adds (no valid token or frame)."""
    inp = variance_inputs(seed)
    rng = np.random.default_rng(seed)
    var_list = [v for v in ("energy", "breathiness", "voicing", "tension")
                if hp.get(f"predict_{v}")]
    b, t = inp["mel2ph"].shape
    batch = dict(tokens=inp["tokens"], ph_dur=inp["ph_dur"], mel2ph=inp["mel2ph"],
                 base_pitch=inp["base_pitch"], pitch=inp["pitch"],
                 uv=rng.random((b, t)) < 0.1,
                 note_midi=inp["note_midi"], note_rest=inp["note_rest"],
                 note_dur=inp["note_dur"], mel2note=inp["mel2note"])
    for v in var_list:
        batch[v] = inp["variances"].get(v, rng.uniform(-70, -20, (b, t)).astype(np.float32))
    if hp["predict_dur"]:
        batch.update(midi=inp["midi"], ph2word=inp["ph2word"])
    if hp.get("use_glide_embed"):
        batch["note_glide"] = inp["note_glide"]
    if hp.get("use_spk_id"):
        batch["spk_ids"] = np.array([2, 1], np.int32)
    if hp.get("use_lang_id"):
        batch["languages"] = rng.integers(1, 3, inp["tokens"].shape).astype(np.int32) * (
            inp["tokens"] > 0)
    return pad_batch_rows(batch, b, b + 1), var_list


def _jax_draws(jm, hp, var_list, rng, b, t):
    """The retake masks, times and noises that the JAX loss function draws from ``rng``."""
    rng_model, rng_p, rng_v = jax.random.split(rng, 3)
    _, rng_tp, rng_np, rng_tv, rng_nv = jax.random.split(rng_model, 5)
    draws = {}
    if hp["predict_pitch"]:
        draws["pitch_retake"] = jax_retake_masks(rng_p, b, t)
    if var_list:
        draws["variance_retake"] = {v: jax_retake_masks(jax.random.fold_in(rng_v, i), b, t)
                                    for i, v in enumerate(var_list)}
    widths = {"pitch": hp["pitch_prediction_args"]["repeat_bins"],
              "var": hp["variances_prediction_args"]["total_repeat_bins"]}
    for name, rng_t, rng_n in (("pitch", rng_tp, rng_np), ("var", rng_tv, rng_nv)):
        if hp["diffusion_type"] == "ddpm":
            draws[f"t_{name}"] = jax.random.randint(rng_t, (b,), 0, jm.k_step)
        else:
            draws[f"t_{name}"] = jax.random.uniform(rng_t, (b,))
        draws[f"noise_{name}"] = jax.random.normal(rng_n, (b, t, widths[name]), jnp.float32)
    return draws


def seeded_pair(hp, seed):
    """The port's model at seeded weights (its zero- or constant-initialised
    leaves randomized) and the same weights as JAX parameters, through the
    JAX package's own converter (cheaper than the JAX init)."""
    torch.manual_seed(seed)
    port = DiffSingerVariance(hp, vocab_size=VOCAB, device="cpu")
    params = randomize(convert_variance(port.module.state_dict(), hp), seed + 100)
    port.module.load_state_dict(variance_state_dict_from_flax(to_numpy(params), hp))
    return params, port


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_forward_train_losses_and_every_gradient_match_jax_grad(case):
    """The losses and the gradient of every parameter (mapped through
    variance_state_dict_from_flax) against jax.grad of the JAX loss function,
    on a batch with a padded row; the JAX draws (retake masks, t, noise)
    injected. Losses 1e-5 relative; each gradient within 1e-4 of its largest
    entry."""
    hp = dict(VAR_HP_NO_DROP, **TRAIN_CASES[case])
    jm = JaxVariance(hp, vocab_size=VOCAB)
    params, port = seeded_pair(hp, 21)
    batch, var_list = _batch(hp, seed=22)
    b, t = batch["mel2ph"].shape

    # the JAX side in one program: the loss, its gradient and the draws it made
    def run(params, batch, rng):
        return (jax.value_and_grad(jax_loss_fn(jm), has_aux=True)(params, batch, rng),
                _jax_draws(jm, hp, var_list, rng, b, t))

    ((jtotal, jlosses_), jgrads), draws = jax.jit(run)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(23))
    draws = jax.tree.map(_t, draws)

    port.module.train()
    total, plosses = make_variance_loss_fn(port)({k: _t(v) for k, v in batch.items()}, **draws)
    total.backward()
    want_names = {"pitch_loss", "var_loss"} | ({"dur_loss"} if hp["predict_dur"] else set())
    assert set(plosses) == set(jlosses_) == want_names
    np.testing.assert_allclose(float(total.detach()), float(jtotal), rtol=1e-5)
    for k in want_names:
        np.testing.assert_allclose(float(plosses[k].detach()), float(jlosses_[k]), rtol=1e-5)
    want = variance_state_dict_from_flax(to_numpy(jgrads), hp)
    named = dict(port.module.named_parameters())
    assert set(want) == set(named)
    for name, w in want.items():
        got = named[name].grad
        assert got is not None, name
        w = w.numpy()
        assert np.abs(got.numpy() - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-6), name


def test_padded_rows_do_not_reach_the_loss():
    """A padded row's payload (pitch, curves, durations) leaves the loss as it
    was: every term is masked by tokens > 0 or mel2ph > 0."""
    hp = VAR_HP_NO_DROP
    torch.manual_seed(3)
    port = DiffSingerVariance(hp, vocab_size=VOCAB, device="cpu")
    batch, var_list = _batch(hp, seed=24)
    b, t = batch["mel2ph"].shape
    g = torch.Generator().manual_seed(5)
    draws = dict(t_pitch=torch.rand(b, generator=g), t_var=torch.rand(b, generator=g),
                 noise_pitch=torch.randn(b, t, 8, generator=g),
                 noise_var=torch.randn(b, t, 12, generator=g),
                 pitch_retake=random_retake_masks(b, t, generator=g),
                 variance_retake={v: random_retake_masks(b, t, generator=g) for v in var_list})
    loss_fn = make_variance_loss_fn(port)
    with torch.no_grad():
        first, _ = loss_fn({k: _t(v) for k, v in batch.items()}, **draws)
        garbled = {k: v.copy() for k, v in batch.items()}
        garbled["pitch"][-1] = 90.0
        garbled["energy"][-1] = -5.0
        garbled["ph_dur"][-1] = 2
        second, _ = loss_fn({k: _t(v) for k, v in garbled.items()}, **draws)
    assert torch.isfinite(first) and float(first) == float(second)
