"""The port's variance model against the JAX package's, on the CPU in float32:
the repeat-bin transforms, the rhythm and length regulators, the variance
encoder in word and phoneme mode, the melody encoder with glide, and
``DiffSingerVariance.forward_infer`` for the flag sets the runtime uses
(durations only; pitch with retake and expression; variances with retake)
under rectified flow and DDPM, with the JAX draws injected. Also the weight
round trip through the JAX package's ``convert_variance`` and the curve
helpers of ``dsp/common.py``.

Tolerances: transforms and regulators exact or 1e-6; encoders 1e-5; float
durations, pitch (semitones) and variance curves (dB) max |diff| <= 1e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.core import spec_transform as jst
from diffsinger_tpu.dsp import common as jdsp
from diffsinger_tpu.utils import infer_utils as jiu
from diffsinger_tpu.utils import seq as jseq
from diffsinger_tpu.utils.torch_model_convert import convert_variance
from diffsinger_tpu_torch.core import spec_transform as st
from diffsinger_tpu_torch.dsp import common as dsp
from diffsinger_tpu_torch.utils import infer_utils as iu
from diffsinger_tpu_torch.utils import seq
from tests.torch_parity import (VAR_HP, VOCAB, assert_close, jax_ddpm_step_noises,
                                variance_pair)

TOL = 1e-4
VARS = ["energy", "breathiness", "tension"]


# ---------------------------------------------------------------- transforms

def _curves(seed, shape=(2, 20)):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-110, 15, shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("n_feats", [1, 3])
def test_multi_variance_transform(n_feats):
    ranges = [(-96.0, -12.0), (-96.0, -20.0), (-10.0, 10.0)][:n_feats]
    clamps = [(-96.0, 0.0), (-96.0, 0.0), (-10.0, 10.0)][:n_feats]
    jt = jst.MultiVarianceTransform(ranges=ranges, clamps=clamps, repeat_bins=4)
    pt = st.MultiVarianceTransform(ranges=ranges, clamps=clamps, repeat_bins=4)
    xs = _curves(1)[:n_feats]
    jn = jt.flatten(jt.norm([jnp.asarray(x) for x in xs]))
    pn = pt.flatten(pt.norm([torch.from_numpy(x) for x in xs]))
    assert tuple(pn.shape) == (2, 20, 4 * n_feats)
    assert_close(pn, jn, atol=1e-6)
    y = np.random.default_rng(2).uniform(-1.5, 1.5, pn.shape).astype(np.float32)
    jd = jt.denorm(jt.unflatten(jnp.asarray(y)))
    pd = pt.denorm(pt.unflatten(torch.from_numpy(y)))
    for a, b in zip(pd, jd):
        assert_close(a, b, atol=1e-5)


def test_pitch_transform_clips():
    jt = jst.PitchTransform(vmin=-8.0, vmax=8.0, cmin=-12.0, cmax=12.0, repeat_bins=6)
    pt = st.PitchTransform(vmin=-8.0, vmax=8.0, cmin=-12.0, cmax=12.0, repeat_bins=6)
    x = np.random.default_rng(3).uniform(-20, 20, (2, 30)).astype(np.float32)
    assert_close(pt.norm(torch.from_numpy(x)), jt.norm(jnp.asarray(x)), atol=1e-6)
    y = np.random.default_rng(4).uniform(-3, 3, (2, 30, 6)).astype(np.float32)
    assert_close(pt.denorm(torch.from_numpy(y)), jt.denorm(jnp.asarray(y)), atol=1e-5)
    assert float(pt.denorm(torch.from_numpy(y)).abs().max()) <= 12.0


def test_repetitive_transform_one_curve():
    jt, pt = jst.RepetitiveTransform(-5.0, 5.0, 3), st.RepetitiveTransform(-5.0, 5.0, 3)
    x = np.random.default_rng(5).uniform(-6, 6, (1, 9)).astype(np.float32)
    assert_close(pt.norm(torch.from_numpy(x)), jt.norm(jnp.asarray(x)), atol=1e-6)


# ---------------------------------------------------------------- regulators, helpers

def test_length_and_rhythm_regulators():
    rng = np.random.default_rng(6)
    ph2word = np.array([[1, 1, 2, 3, 3, 3, 4, 0, 0], [1, 2, 2, 3, 0, 0, 0, 0, 0]], np.int32)
    ph_dur = rng.uniform(0.5, 9.0, ph2word.shape).astype(np.float32)
    word_dur = np.array([[10, 3, 17, 6], [4, 12, 9, 0]], np.int32)
    want = jseq.rhythm_regulator(jnp.asarray(ph_dur), jnp.asarray(ph2word), jnp.asarray(word_dur))
    got = seq.rhythm_regulator(torch.from_numpy(ph_dur), torch.from_numpy(ph2word),
                               torch.from_numpy(word_dur))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), np.asarray(want))
    for length in (30, 40, 50):
        assert np.array_equal(seq.length_regulator(got, length).numpy(),
                              np.asarray(jseq.length_regulator(want, length)))


def test_curve_helpers():
    rng = np.random.default_rng(7)
    curve = rng.uniform(50, 70, (2, 57)).astype(np.float32)
    for k in (1, 5, 6):
        want = jdsp.sinusoidal_smooth_np(curve, k)
        assert np.array_equal(dsp.sinusoidal_smooth_np(curve, k), want)
        assert_close(dsp.sinusoidal_smooth(torch.from_numpy(curve), k), want, atol=1e-5)
    f0 = rng.uniform(100, 400, 40)
    f0[[0, 1, 7, 8, 9, 39]] = 0
    for a, b in zip(dsp.interp_f0(f0.copy()), jdsp.interp_f0(f0.copy())):
        assert np.array_equal(a, b)
    assert np.array_equal(iu.hz_to_midi(f0[2:7]), jiu.hz_to_midi(f0[2:7]))
    assert np.array_equal(iu.midi_to_hz(curve), jiu.midi_to_hz(curve))


# ---------------------------------------------------------------- the model

def variance_inputs(seed=0, b=2, t_ph=12, t_s=48, t_n=8):
    """Two rows of a score, the second padded: tokens, ph2word, word and
    phoneme durations that fill the frames, notes, curves and retake masks."""
    rng = np.random.default_rng(seed)
    tokens = np.zeros((b, t_ph), np.int32)
    ph2word = np.zeros((b, t_ph), np.int32)
    ph_dur = np.zeros((b, t_ph), np.int32)
    word_dur = np.zeros((b, t_ph), np.int32)
    mel2ph = np.zeros((b, t_s), np.int32)
    for i in range(b):
        n = t_ph - 3 * i
        tokens[i, :n] = rng.integers(1, VOCAB, n)
        words = np.cumsum(np.r_[1, rng.random(n - 1) < 0.5])
        ph2word[i, :n] = words
        dur = rng.integers(1, 2 * (t_s - 6 * i) // n, n)
        ph_dur[i, :n] = dur
        np.add.at(word_dur[i], words - 1, dur)
        frames = np.repeat(np.arange(1, n + 1), dur)[:t_s]
        mel2ph[i, :len(frames)] = frames
    base_pitch = (60 + 5 * np.sin(np.linspace(0, 6, t_s))[None] + rng.normal(0, 1, (b, 1))
                  ).astype(np.float32)
    pitch = (base_pitch + rng.normal(0, 0.5, (b, t_s))).astype(np.float32)
    retake = np.zeros((b, t_s), bool)
    retake[:, t_s // 3: 2 * t_s // 3] = True
    variances = {v: rng.uniform(-70, -20, (b, t_s)).astype(np.float32) for v in VARS}
    note_midi = rng.uniform(55, 70, (b, t_n)).astype(np.float32)
    note_rest = rng.random((b, t_n)) < 0.2
    note_dur = rng.integers(2, t_s // t_n, (b, t_n)).astype(np.int32)
    mel2note = np.zeros((b, t_s), np.int32)
    for i in range(b):
        frames = np.repeat(np.arange(1, t_n + 1), note_dur[i])[:t_s]
        mel2note[i, :len(frames)] = frames
    return dict(
        tokens=tokens, midi=rng.integers(40, 80, (b, t_ph)).astype(np.int32), ph2word=ph2word,
        ph_dur=ph_dur, word_dur=word_dur, mel2ph=mel2ph, base_pitch=base_pitch, pitch=pitch,
        pitch_expr=rng.uniform(0, 1, (b, t_s)).astype(np.float32), pitch_retake=retake,
        variances=variances, variance_retake={v: retake for v in VARS},
        note_midi=note_midi, note_rest=note_rest, note_dur=note_dur,
        note_glide=rng.integers(0, 3, (b, t_n)).astype(np.int32), mel2note=mel2note)


_PAIRS = {}


def cached_pair(overrides: dict, seed: int):
    """variance_pair for VAR_HP with ``overrides``, built once per module."""
    key = (repr(sorted(overrides.items())), seed)
    if key not in _PAIRS:
        # the sampler settings do not change the parameters: share the JAX init
        shape = {k: v for k, v in overrides.items() if k not in CORES["ddpm"]
                 and k != "diff_accelerator"}
        base = cached_pair(shape, seed)[1] if shape != overrides else None
        _PAIRS[key] = variance_pair(dict(VAR_HP, **overrides), seed=seed, params=base)
    return _PAIRS[key]


def _to(x, conv):
    if isinstance(x, dict):
        return {k: _to(v, conv) for k, v in x.items()}
    return conv(x)


def _jax(inp):
    return _to(inp, jnp.asarray)


def _torch(inp):
    return _to(inp, torch.from_numpy)


@pytest.mark.parametrize("overrides", [
    dict(), dict(predict_dur=False, use_melody_encoder=True, use_glide_embed=True,
                 diffusion_type="ddpm", use_spk_id=True, num_spk=3, use_lang_id=True, num_lang=2),
])
def test_weights_round_trip_through_the_jax_converter(overrides):
    """The port's state dict carries the reference's names: the JAX package's
    own converter turns it back into the JAX parameters, leaf for leaf."""
    hp = dict(VAR_HP, **overrides)
    _, params, port = cached_pair(overrides, seed=6)
    back = convert_variance(port.module.state_dict(), hp)
    want = dict(jax.tree_util.tree_leaves_with_path(params))
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert sorted(map(jax.tree_util.keystr, got)) == sorted(map(jax.tree_util.keystr, want))
    for path, leaf in want.items():
        np.testing.assert_array_equal(got[path], np.asarray(leaf), err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("word_mode", [True, False])
def test_fs2_variance_encoder(word_mode):
    jmodel, params, port = cached_pair(dict() if word_mode else CASES["phoneme_mode"][0], seed=6)
    inp = variance_inputs(3)
    kw = dict(ph_dur=inp["ph_dur"], word_dur=inp["word_dur"] if word_mode else None)
    want = jmodel.module.apply(params, *(jnp.asarray(inp[k]) for k in ("tokens", "midi", "ph2word")),
                               infer=True, method="encode",
                               **{k: None if v is None else jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got = port.module.encode(*(torch.from_numpy(inp[k]) for k in ("tokens", "midi", "ph2word")),
                                 **{k: None if v is None else torch.from_numpy(v)
                                    for k, v in kw.items()})
    assert_close(got[0], want[0], atol=1e-5)
    if word_mode:
        assert got[1].dtype == torch.float32 and float(got[1].min()) >= 0
        assert_close(got[1], want[1], atol=TOL, rtol=0)
    else:
        assert got[1] is None and want[1] is None


def test_melody_encoder_with_glide():
    jmodel, params, port = cached_pair(CASES["melody_retake"][0], seed=6)
    inp = variance_inputs(5)
    keys = ("note_midi", "note_rest", "note_dur")
    want = jmodel.module.apply(params, *(jnp.asarray(inp[k]) for k in keys),
                               note_glide=jnp.asarray(inp["note_glide"]), method="melody_encode")
    with torch.no_grad():
        got = port.module.melody_encode(*(torch.from_numpy(inp[k]) for k in keys),
                                        note_glide=torch.from_numpy(inp["note_glide"]))
    assert tuple(got.shape) == (2, 8, 32)
    assert_close(got, want, atol=1e-5)


# (name, hp overrides, forward_infer kwargs taken from the inputs, flags)
CASES = {
    "dur_only": (dict(), ("word_dur",), dict(predict_pitch=False, predict_variances=False)),
    "pitch_retake_expr": (dict(), ("word_dur", "mel2ph", "pitch", "pitch_expr", "pitch_retake"),
                          dict(predict_variances=False)),
    "pitch_auto_expr": (dict(), ("word_dur", "pitch_expr"), dict()),
    "variances_retake": (dict(), ("word_dur", "mel2ph", "pitch", "variances", "variance_retake"),
                         dict(predict_pitch=False)),
    "melody_retake": (dict(use_melody_encoder=True, use_glide_embed=True,
                           melody_encoder_args=dict(hidden_size=16, enc_layers=2)),
                      ("word_dur", "mel2ph", "pitch", "pitch_retake", "note_midi", "note_rest",
                       "note_dur", "note_glide", "mel2note"), dict(predict_variances=False)),
    "phoneme_mode": (dict(predict_dur=False), ("ph_dur", "mel2ph"), dict()),
}
CORES = {
    "reflow": dict(),
    "ddim": dict(diffusion_type="ddpm", timesteps=100, K_step=100, diff_accelerator="ddim",
                 diff_speedup=20),
    "unipc": dict(diffusion_type="ddpm", timesteps=100, K_step=100, diff_accelerator="unipc",
                  diff_speedup=25),
    "ddpm": dict(diffusion_type="ddpm", timesteps=6, K_step=6, diff_speedup=1),
}


def _forward_pair(jmodel, params, port, inp, keys, flags, seed):
    """Both forward_infers on the same inputs and noise; returns (port, jax) outputs."""
    b, t_s = inp["base_pitch"].shape
    rng = np.random.default_rng(seed)
    noise_p = rng.standard_normal((b, t_s, 8)).astype(np.float32)
    noise_v = rng.standard_normal((b, t_s, 12)).astype(np.float32)
    key = jax.random.PRNGKey(seed)
    args = ("tokens", "midi", "ph2word", "base_pitch")
    kw = {k: inp[k] for k in keys}
    want = jmodel.forward_infer(params, key, *(jnp.asarray(inp[k]) for k in args),
                                noise_pitch=jnp.asarray(noise_p),
                                noise_variances=jnp.asarray(noise_v), **flags, **_jax(kw))
    # forward_infer splits its key into the pitch and the variance branch's
    key_p, key_v = jax.random.split(key)
    steps = jmodel.timesteps if jmodel.diffusion_type == "ddpm" else 0
    draws_p = jax_ddpm_step_noises(key_p, steps, noise_p.shape)
    draws_v = jax_ddpm_step_noises(key_v, steps, noise_v.shape)
    got = port.forward_infer(*(torch.from_numpy(inp[k]) for k in args),
                             noise_pitch=torch.from_numpy(noise_p),
                             noise_variances=torch.from_numpy(noise_v),
                             noise_fn_pitch=lambda i: draws_p[i],
                             noise_fn_variances=lambda i: draws_v[i], **flags, **_torch(kw))
    return got, want


# every case under rectified flow; the sampling cases under DDPM's cores too
PAIRS = [(case, "reflow") for case in CASES] + [
    (case, core) for core in ("ddim", "unipc", "ddpm")
    for case in ("pitch_retake_expr", "pitch_auto_expr", "variances_retake")]


@pytest.mark.parametrize("case,core", PAIRS)
def test_forward_infer(case, core):
    overrides, keys, flags = CASES[case]
    hp = dict(VAR_HP, **overrides, **CORES[core])
    jmodel, params, port = cached_pair(dict(overrides, **CORES[core]), seed=6)
    inp = variance_inputs(7)
    got, want = _forward_pair(jmodel, params, port, inp, keys, flags, seed=8)
    (dur, pitch, var), (jdur, jpitch, jvar) = got, want
    if hp["predict_dur"]:
        assert_close(dur, jdur, atol=TOL, rtol=0)
    else:
        assert dur is None and jdur is None
    if flags.get("predict_pitch") is False:
        assert pitch is None and jpitch is None
    else:
        assert 0.1 < float(pitch.abs().max()) <= 12.0
        assert_close(pitch, jpitch, atol=TOL, rtol=0)
    if flags.get("predict_variances") is False:
        assert var == {} and jvar == {}
    else:
        assert sorted(var) == sorted(jvar) == sorted(VARS)
        for v in VARS:
            assert_close(var[v], jvar[v], atol=TOL, rtol=0)


def test_forward_infer_switches_tf32_off_for_its_call(monkeypatch):
    """A float32 model runs in full float32 whatever the caller set: TF32 is
    off inside forward_infer and the caller's settings are back after it."""
    _, _, port = cached_pair(dict(), seed=6)
    seen = []
    encode = port.module.encode

    def spy(*args, **kwargs):
        seen.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        return encode(*args, **kwargs)

    monkeypatch.setattr(port.module, "encode", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    inp = variance_inputs(7)
    dur, _, _ = port.forward_infer(*(torch.from_numpy(inp[k]) for k in
                                     ("tokens", "midi", "ph2word", "base_pitch")),
                                   word_dur=torch.from_numpy(inp["word_dur"]),
                                   predict_pitch=False, predict_variances=False)
    assert seen == [(False, False)] and torch.isfinite(dur).all()
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


# ---------------------------------------------------------------------------
# the conv-stack curve predictors (no path of either package uses them)

def _predictor_state(p: dict, n_layers: int) -> dict:
    """The JAX predictor's parameters under the reference's torch names."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(np.asarray(a)))  # noqa: E731
    sd = {"pos_embed_alpha": t(p["pos_embed_alpha"]),
          "linear.weight": t(np.asarray(p["linear"]["dense"]["kernel"]).T),
          "linear.bias": t(p["linear"]["dense"]["bias"])}
    for i in range(n_layers):
        sd[f"conv.{i}.0.weight"] = t(np.asarray(p[f"conv_{i}"]["kernel"]).transpose(2, 1, 0))
        sd[f"conv.{i}.0.bias"] = t(p[f"conv_{i}"]["bias"])
        sd[f"conv.{i}.2.weight"] = t(p[f"norm_{i}"]["scale"])
        sd[f"conv.{i}.2.bias"] = t(p[f"norm_{i}"]["bias"])
    if "base_pitch_embed" in p:
        sd["base_pitch_embed.weight"] = t(np.asarray(p["base_pitch_embed"]["dense"]["kernel"]).T)
        sd["base_pitch_embed.bias"] = t(p["base_pitch_embed"]["dense"]["bias"])
    return sd


@pytest.mark.parametrize("infer", [True, False])
def test_variance_predictor(infer):
    from diffsinger_tpu.models.variance_encoder import VariancePredictor as JaxPredictor
    from diffsinger_tpu_torch.models.variance_encoder import VariancePredictor
    from tests.torch_parity import randomize

    rng = np.random.default_rng(31)
    xs = rng.standard_normal((2, 30, 32)).astype(np.float32)
    jm = JaxPredictor(vmin=-3.0, vmax=5.0, n_layers=3, n_chans=24)
    params = randomize(jm.init(jax.random.PRNGKey(0), jnp.asarray(xs)), 1)
    want = jm.apply(params, jnp.asarray(xs), infer=infer)
    port = VariancePredictor(-3.0, 5.0, 32, n_layers=3, n_chans=24).eval()
    port.load_state_dict(_predictor_state(params["params"], 3), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(xs), infer=infer)
    assert got.shape == (2, 30)
    assert_close(got, want)


def test_pitch_predictor():
    from diffsinger_tpu.models.variance_encoder import PitchPredictor as JaxPredictor
    from diffsinger_tpu_torch.models.variance_encoder import PitchPredictor
    from tests.torch_parity import randomize

    rng = np.random.default_rng(32)
    xs = rng.standard_normal((2, 30, 32)).astype(np.float32)
    base = rng.uniform(55, 75, (2, 30)).astype(np.float32)
    jm = JaxPredictor(vmin=-8.0, vmax=8.0, num_bins=40, n_layers=2, n_chans=24)
    params = randomize(jm.init(jax.random.PRNGKey(1), jnp.asarray(xs), jnp.asarray(base)), 2)
    want_pitch, want_logits = jm.apply(params, jnp.asarray(xs), jnp.asarray(base))
    port = PitchPredictor(-8.0, 8.0, 40, 1.0, 32, n_layers=2, n_chans=24).eval()
    port.load_state_dict(_predictor_state(params["params"], 2), strict=True)
    with torch.no_grad():
        pitch, logits = port(torch.from_numpy(xs), torch.from_numpy(base))
    assert logits.shape == (2, 30, 40)
    assert_close(logits, want_logits)
    assert_close(pitch, want_pitch, atol=1e-4)
