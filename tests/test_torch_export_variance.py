"""Export of the variance model (``diffsinger_tpu_torch/deployment/``) against
the JAX package's, on the CPU in float32.

* ``DiffSingerVariance.forward_pitch_deployed`` / ``forward_variance_deployed``
  against the JAX views on the same weights (seeded port weights, carried to
  JAX by its own ``convert_variance``) and the same injected noise, for
  rectified flow and DDPM, with and without the melody encoder, with
  ``expr`` given and frozen, a partial retake and a speaker: max |diff| <= 1e-4;
* the ``.pt2`` programs, exported with ``device="cpu"``, against the eager
  views: <= 1e-6; ``VarianceArtifactRuntime`` (buckets, trimming, neutral
  defaults, refusals) and the chain variance -> acoustic -> vocoder on the
  port's runtimes alone;
* the ONNX graphs: signatures and ``dsconfig.yaml`` equal to the JAX
  exporter's for the same experiment, with and without the freeze flags,
  and through the numpy interpreter against JAX's deployed views (1e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffsinger_tpu_torch.models.toplevel import DiffSingerVariance
from tests.torch_parity import VAR_HP, VOCAB

TOL = 1e-4
# VAR_HP with the frame rate and the base pitch's smoothing of configs/variance.yaml
VHP = dict(VAR_HP, hop_size=512, audio_sample_rate=44100, midi_smooth_width=0.06)
VARS = ["energy", "breathiness", "tension"]  # VAR_HP's variances
H = VAR_HP["hidden_size"]


def seeded_variance_pair(hp: dict, seed: int):
    """(JAX model, its params, port model): seeded port weights, every one
    moved off its init, given to the JAX model through the JAX package's own
    converter (cheaper than a JAX init)."""
    from diffsinger_tpu.models.toplevel import DiffSingerVariance as JaxVariance
    from diffsinger_tpu.utils.torch_model_convert import convert_variance

    torch.manual_seed(seed)
    port = DiffSingerVariance(hp, vocab_size=VOCAB, device="cpu")
    g = torch.Generator().manual_seed(seed + 1)
    state = {}
    for k, v in port.module.state_dict().items():
        scale = 0.3 if v.ndim == 1 else 0.02 + 0.5 * float(v.std())
        state[k] = v + scale * torch.randn(v.shape, generator=g)
    port.module.load_state_dict(state)
    return JaxVariance(hp, vocab_size=VOCAB), convert_variance(state, hp), port


def deployed_inputs(seed: int, b: int = 2, t_ph: int = 10, t_mel: int = 48):
    """Deployed inputs with padded phonemes and frames: frame durations that
    end before the last frame in the second row, notes on the phoneme axis,
    a pitch curve, a partial retake of each kind, expr and curves."""
    rng = np.random.default_rng(seed)
    ph_dur = np.zeros((b, t_ph), np.int32)
    note_dur = np.zeros((b, t_ph), np.int32)
    for i in range(b):
        n = t_ph - 2 * i
        ph_dur[i, :n] = rng.integers(1, 2 * (t_mel - 6 * i) // n, n)
        k = n // 2
        note_dur[i, :k] = rng.integers(2, 2 * (t_mel - 6 * i) // k, k)
    retake = np.zeros((b, t_mel), bool)
    retake[:, t_mel // 4: 3 * t_mel // 4] = True
    var_retake = np.zeros((b, t_mel, len(VARS)), bool)
    var_retake[:, t_mel // 3:, 0] = True
    var_retake[:, :, 2] = True
    return dict(
        encoder_out=rng.standard_normal((b, t_ph, H)).astype(np.float32),
        ph_dur=ph_dur, note_dur=note_dur,
        note_midi=rng.uniform(55, 70, (b, t_ph)).astype(np.float32),
        note_rest=rng.random((b, t_ph)) < 0.2,
        note_glide=rng.integers(0, 3, (b, t_ph)).astype(np.int32),
        pitch=(62 + 4 * np.sin(np.linspace(0, 5, t_mel))[None]
               + rng.normal(0, 0.3, (b, t_mel))).astype(np.float32),
        expr=rng.uniform(0, 1, (b, t_mel)).astype(np.float32),
        retake=retake, var_retake=var_retake,
        variances={v: rng.uniform(-70, -20, (b, t_mel)).astype(np.float32) for v in VARS},
        spk=rng.standard_normal((b, 1, H)).astype(np.float32),
        noise_pitch=rng.standard_normal((b, t_mel, 8)).astype(np.float32),
        noise_var=rng.standard_normal((b, t_mel, 12)).astype(np.float32))


DDPM = dict(diffusion_type="ddpm", timesteps=100, K_step=100)
# (hp overrides, pitch view keyword inputs)
VIEW_CASES = {
    "reflow": ({}, ("expr",)),
    "reflow-expr-frozen": ({}, ()),
    "reflow-melody-glide": (dict(use_melody_encoder=True, use_glide_embed=True,
                                 melody_encoder_args=dict(hidden_size=16, enc_layers=2)),
                            ("note_rest", "note_glide", "expr")),
    "reflow-spk-lang": (dict(use_spk_id=True, num_spk=3, use_lang_id=True, num_lang=2),
                        ("expr", "spk")),
    "ddpm": (DDPM, ("expr",)),
    "ddpm-melody": (dict(DDPM, use_melody_encoder=True,
                         melody_encoder_args=dict(hidden_size=16, enc_layers=2)),
                    ("note_rest",)),
}
_PAIRS = {}


def pair(case: str):
    if case not in _PAIRS:
        _PAIRS[case] = seeded_variance_pair(dict(VHP, **VIEW_CASES[case][0]), seed=3)
    return _PAIRS[case]


def _kw(inp, keys, conv):
    names = {"spk": "spk_mix_embed"}
    return {names.get(k, k): conv(inp[k]) for k in keys}


@pytest.mark.parametrize("case", list(VIEW_CASES))
def test_deployed_views_match_jax(case):
    jmodel, params, port = pair(case)
    keys = VIEW_CASES[case][1]
    inp = deployed_inputs(4)
    j, t = jnp.asarray, torch.from_numpy
    pos = ("encoder_out", "ph_dur", "note_midi", "note_dur", "pitch")
    spk = ("spk",) if "spk" in keys else ()
    outs = []
    for steps in (2, 3):
        want = jmodel.forward_pitch_deployed(
            params, None, *(j(inp[k]) for k in pos), j(inp["retake"]),
            steps=jnp.int32(steps), noise=j(inp["noise_pitch"]), **_kw(inp, keys, j))
        got = port.forward_pitch_deployed(
            *(t(inp[k]) for k in pos), t(inp["retake"]), steps=torch.tensor(steps),
            noise=t(inp["noise_pitch"]), **_kw(inp, keys, t))
        assert got.shape == (2, 48)
        assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL
        outs.append(got.numpy())
        want = jmodel.forward_variance_deployed(
            params, None, j(inp["encoder_out"]), j(inp["ph_dur"]), j(inp["pitch"]),
            _kw(inp["variances"], VARS, j), j(inp["var_retake"]), steps=jnp.int32(steps),
            noise=j(inp["noise_var"]), **_kw(inp, spk, j))
        got = port.forward_variance_deployed(
            t(inp["encoder_out"]), t(inp["ph_dur"]), t(inp["pitch"]),
            _kw(inp["variances"], VARS, t), t(inp["var_retake"]), steps=torch.tensor(steps),
            noise=t(inp["noise_var"]), **_kw(inp, spk, t))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert np.abs(g.numpy() - np.asarray(w)).max() <= TOL
    assert not np.allclose(outs[0], outs[1])  # the step count reaches the sampler


def test_linguistic_view_matches_jax():
    """The linguistic view's program module (encoder, duration predictor) with
    a speaker mix and languages, against the JAX ``encode`` in word mode."""
    from diffsinger_tpu_torch.deployment.exporters import VarianceProgram

    jmodel, params, port = pair("reflow-spk-lang")
    rng = np.random.default_rng(6)
    tokens = rng.integers(1, VOCAB, (1, 10)).astype(np.int32)
    tokens[0, 8:] = 0
    ph2word = np.array([[1, 1, 2, 3, 3, 3, 4, 5, 0, 0]], np.int32)
    ins = dict(tokens=tokens, midi=rng.integers(50, 70, (1, 10)).astype(np.int32),
               ph2word=ph2word, word_dur=rng.uniform(3, 9, (1, 10)).astype(np.float32),
               ph_spk_embed=rng.standard_normal((1, 1, H)).astype(np.float32),
               languages=(rng.integers(1, 3, (1, 10)) * (tokens > 0)).astype(np.int32))
    program = VarianceProgram(port, "linguistic", list(ins))
    with torch.no_grad():
        got = program(*(torch.from_numpy(v) for v in ins.values()))
    want = jmodel.module.apply(
        params, *(jnp.asarray(ins[k]) for k in ("tokens", "midi", "ph2word")),
        word_dur=jnp.asarray(ins["word_dur"]), ph_spk_mix_embed=jnp.asarray(ins["ph_spk_embed"]),
        languages=jnp.asarray(ins["languages"]), infer=True, method="encode")
    for g, w in zip(got, want, strict=True):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= TOL


# ---------------------------------------------------------------------------
# .pt2 programs and VarianceArtifactRuntime

def pad(a, n, value=0):
    return torch.from_numpy(np.pad(a, [(0, 0), (0, n - a.shape[1])] + [(0, 0)] * (a.ndim - 2),
                                   constant_values=value))


def runtime_inputs():
    """The JAX runtime test's request (tests/test_export.py): 10 phonemes in
    4 words, 50 frames."""
    tokens = np.zeros((1, 10), np.int32)
    tokens[0, :4] = np.arange(1, 5)
    ph2word = np.zeros((1, 10), np.int32)
    ph2word[0, :4] = [1, 1, 2, 2]
    return dict(tokens=tokens, midi=np.full((1, 10), 60, np.int32), ph2word=ph2word,
                word_dur=np.full((1, 10), 4.0, np.float32),
                ph_dur=np.full((1, 10), 5, np.int32),
                note_midi=np.full((1, 10), 62.0, np.float32),
                note_dur=np.full((1, 10), 5, np.int32),
                pitch=(62 + np.sin(np.linspace(0, 4, 50))[None]).astype(np.float32))


@pytest.fixture(scope="module")
def var_bundle(tmp_path_factory):
    """A variance experiment (every variance on, two steps) exported as
    ``.pt2`` for the CPU at bucket (16, 64): (bundle dir, exporter)."""
    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.deployment.exporters import DiffSingerVarianceExporter
    from tests.torch_parity import make_variance_exp

    root = tmp_path_factory.mktemp("var_pt2")
    ckpt_root = make_variance_exp(root, "tiny_var")
    hp = load_config(exp_name="tiny_var", infer=True, ckpt_root=ckpt_root)
    exporter = DiffSingerVarianceExporter(hp, root / "bundle", buckets=[(16, 64)], device="cpu")
    exporter.export()
    return root / "bundle", exporter


def test_pt2_views_equal_the_eager_views(var_bundle):
    """Each program through the runtime against the eager view on the padded
    inputs and the same noise, with a partial retake and expr given."""
    from diffsinger_tpu_torch.deployment.runtime import VarianceArtifactRuntime

    bundle, exporter = var_bundle
    model = exporter.model
    rt = VarianceArtifactRuntime(bundle, device="cpu")
    assert rt.variance_names() == ["energy", "breathiness", "voicing", "tension"]
    inp = runtime_inputs()
    enc, dur, bucket = rt.encode(inp["tokens"], inp["midi"], inp["ph2word"], inp["word_dur"],
                                 t_mel=50)
    with torch.no_grad():
        want_enc, want_dur = model.module.encode(
            pad(inp["tokens"], 16), pad(inp["midi"], 16), pad(inp["ph2word"], 16),
            word_dur=pad(inp["word_dur"], 16))
    assert tuple(enc.shape) == (1, 16, 32) and dur.shape == (1, 10)
    assert torch.equal(enc, want_enc) and np.array_equal(dur, want_dur[:, :10].numpy())

    rng = np.random.default_rng(5)
    retake = np.zeros((1, 50), bool)
    retake[:, 10:35] = True
    expr = rng.uniform(0, 1, (1, 50)).astype(np.float32)
    noise = torch.from_numpy(rng.standard_normal((1, 64, 8)).astype(np.float32))
    got = rt.predict_pitch(enc, inp["ph_dur"], inp["note_midi"], inp["note_dur"], inp["pitch"],
                           bucket, steps=3, noise=noise, retake=retake, expr=expr)
    want = model.forward_pitch_deployed(
        enc, pad(inp["ph_dur"], 16), pad(inp["note_midi"], 16), pad(inp["note_dur"], 16),
        pad(inp["pitch"], 64), pad(retake, 64, True), expr=pad(expr, 64, 1.0),
        steps=torch.tensor(3), noise=noise)[:, :50]
    assert got.shape == (1, 50) and np.abs(got - want.numpy()).max() <= 1e-6

    var_retake = np.ones((1, 50, 4), bool)
    var_retake[:, :20, 1] = False
    curves = {v: rng.uniform(-60, -20, (1, 50)).astype(np.float32) for v in rt.variance_names()}
    noise = torch.from_numpy(rng.standard_normal((1, 64, 16)).astype(np.float32))
    got = rt.predict_variances(enc, inp["ph_dur"], got, bucket, steps=2, noise=noise,
                               retake=var_retake, **curves)
    want = model.forward_variance_deployed(
        enc, pad(inp["ph_dur"], 16), pad(want.numpy(), 64), {v: pad(c, 64) for v, c in
                                                              curves.items()},
        pad(var_retake, 64, True), steps=torch.tensor(2), noise=noise)
    assert sorted(got) == sorted(curves)
    for v, w in zip(rt.variance_names(), want):
        assert got[v].shape == (1, 50) and np.abs(got[v] - w[:, :50].numpy()).max() <= 1e-6


def test_variance_runtime_defaults_buckets_and_refusals(var_bundle, tmp_path):
    from diffsinger_tpu_torch.deployment.runtime import VarianceArtifactRuntime

    bundle, _ = var_bundle
    rt = VarianceArtifactRuntime(bundle, device="cpu")
    inp = runtime_inputs()
    enc, _, bucket = rt.encode(inp["tokens"], inp["midi"], inp["ph2word"], inp["word_dur"],
                               t_mel=50)
    args = (enc, inp["ph_dur"], inp["note_midi"], inp["note_dur"], inp["pitch"], bucket)
    # the neutral values: retake every frame, expr 1; the seed draws the noise
    plain = rt.predict_pitch(*args, seed=3)
    assert np.array_equal(plain, rt.predict_pitch(*args, seed=3, retake=np.ones((1, 50), bool),
                                                  expr=np.ones((1, 50), np.float32)))
    assert not np.allclose(plain, rt.predict_pitch(*args, seed=4))
    assert np.isfinite(plain).all() and abs(float(plain.mean()) - 62.0) < 12.0
    curves = rt.predict_variances(enc, inp["ph_dur"], plain, bucket, seed=3)
    zeros = {v: np.zeros((1, 50), np.float32) for v in rt.variance_names()}
    assert all(np.array_equal(curves[v], c) for v, c in rt.predict_variances(
        enc, inp["ph_dur"], plain, bucket, seed=3, retake=np.ones((1, 50, 4), bool),
        **zeros).items())
    with pytest.raises(ValueError, match="no exported bucket fits"):
        rt.encode(np.ones((1, 20), np.int32), *(np.ones((1, 20), np.int32),) * 2,
                  np.ones((1, 20), np.float32), t_mel=50)

    manifest = yaml.safe_load((bundle / "dsconfig.yaml").read_text())
    (tmp_path / "dsconfig.yaml").write_text(yaml.safe_dump(dict(
        manifest, buckets={"64x512": {}, "16x64": {}, "32x128": {}, "128x256": {}})))
    rt = VarianceArtifactRuntime(tmp_path, device="cpu")
    assert [rt.pick_bucket(p, m)[:2] for p, m in ((5, 64), (17, 64), (20, 100), (100, 200),
                                                   (20, 300))] == [
        (16, 64), (32, 128), (32, 128), (128, 256), (64, 512)]
    for change, error in ((dict(flavor="onnx"), "flavor is 'onnx'"),
                          (dict(device="cuda"), "exported for 'cuda'")):
        (tmp_path / "dsconfig.yaml").write_text(yaml.safe_dump(dict(manifest, **change)))
        with pytest.raises(ValueError, match=error):
            VarianceArtifactRuntime(tmp_path, device="cpu")
    acoustic = {k: v for k, v in manifest.items() if k != "linguistic"}
    (tmp_path / "dsconfig.yaml").write_text(yaml.safe_dump(acoustic))
    with pytest.raises(ValueError, match="not a variance bundle"):
        VarianceArtifactRuntime(tmp_path, device="cpu")


def test_the_chain_runs_on_the_ports_runtimes_alone(var_bundle, tmp_path):
    """score -> pitch and curves -> mel -> waveform, from the three bundles
    through the runtimes, with no model class (tests/test_export.py's chain)."""
    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.deployment.exporters import (
        DiffSingerAcousticExporter, NSFHiFiGANExporter)
    from diffsinger_tpu_torch.deployment.runtime import (
        AcousticArtifactRuntime, VarianceArtifactRuntime, VocoderArtifactRuntime)
    from tests.torch_parity import make_exp

    ckpt_root = make_exp(tmp_path, "chain", dict(
        use_shallow_diffusion=False, use_energy_embed=True,
        backbone_args=dict(num_channels=32, num_layers=1, kernel_size=7, dropout_rate=0.0,
                           strong_cond=True)))
    hp = load_config(exp_name="chain", infer=True, ckpt_root=ckpt_root)
    DiffSingerAcousticExporter(hp, tmp_path / "acoustic", buckets=[(16, 64)],
                               device="cpu").export()
    NSFHiFiGANExporter(hp, tmp_path / "vocoder", buckets=[64], device="cpu").export()

    bundle, _ = var_bundle
    rt_var = VarianceArtifactRuntime(bundle, device="cpu")
    rt_ac = AcousticArtifactRuntime(tmp_path / "acoustic", device="cpu")
    rt_voc = VocoderArtifactRuntime(tmp_path / "vocoder", device="cpu")
    inp = runtime_inputs()
    enc, dur, bucket = rt_var.encode(inp["tokens"], inp["midi"], inp["ph2word"],
                                     inp["word_dur"], t_mel=50)
    pitch = rt_var.predict_pitch(enc, inp["ph_dur"], inp["note_midi"], inp["note_dur"],
                                 inp["pitch"], bucket, seed=7)
    curves = rt_var.predict_variances(enc, inp["ph_dur"], pitch, bucket, seed=7)
    assert pitch.shape == (1, 50) and np.isfinite(pitch).all()
    f0 = (440.0 * 2.0 ** ((pitch - 69.0) / 12.0)).astype(np.float32)
    mel2ph = np.repeat(np.arange(1, 11), 5)[None].astype(np.int32)
    mel = rt_ac.synthesize_mel(inp["tokens"], mel2ph, f0, seed=7, energy=curves["energy"])
    assert mel.shape == (1, 50, 16) and np.isfinite(mel).all()
    wav = rt_voc.vocode(mel, f0)
    assert wav.shape == (1, 50 * rt_voc.hop_size)
    assert np.isfinite(wav).all() and float(np.abs(wav).max()) > 0
