"""The variance model's ONNX graphs (``DiffSingerVarianceExporter`` with
``fmt="onnx"``) against the JAX exporter's, on one experiment folder per
exposure case: ``dsconfig.yaml`` (keys, per-view ``inputs``, file names) and
every graph's signature equal the JAX bundle's, every emitted op is in the
JAX package's audited set, and the graphs run through the port's numpy
interpreter match the JAX model's deployed views on the same weights and the
same noise (max |diff| <= 1e-4 in float32; the predicted durations, which
leave the graph through an exp, within 1e-5 of their value).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import yaml

from diffsinger_tpu.deployment.onnx.checker import check_model as jax_check_model
from diffsinger_tpu.deployment.onnx.lowering import EMITTED_OPS as JAX_EMITTED_OPS
from diffsinger_tpu_torch.config import load_config
from diffsinger_tpu_torch.deployment.exporters import DiffSingerVarianceExporter
from diffsinger_tpu_torch.deployment.onnx import run_model
from diffsinger_tpu_torch.deployment.onnx.builder import parse_model
from tests.test_torch_onnx import signature
from tests.torch_parity import make_variance_exp

TOL = 1e-4
MELODY = dict(use_melody_encoder=True, use_glide_embed=True, use_spk_id=True, num_spk=2)
CASES = {
    # melody encoder with glide; expr, glide and both speakers exposed
    "exposed": (MELODY, {}),
    # the same model with expr, glide and speaker 1 frozen in
    "frozen": (MELODY, dict(freeze_expr=True, freeze_glide=True, freeze_spk="spk1")),
}
VIEWS = ("linguistic_onnx", "pitch_onnx", "variance_onnx")


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """{case: (port exporter, JAX hparams, JAX bundle dir, port bundle dir)}."""
    from diffsinger_tpu.config import load_config as jax_load_config
    from diffsinger_tpu.deployment.exporters import DiffSingerVarianceExporter as JaxExporter

    root = tmp_path_factory.mktemp("var_onnx")
    ckpt_root = make_variance_exp(root, "var", MELODY)
    jhp = jax_load_config(exp_name="var", infer=True, ckpt_root=ckpt_root)
    php = load_config(exp_name="var", infer=True, ckpt_root=ckpt_root)
    out = {}
    for case, (_, kwargs) in CASES.items():
        JaxExporter(jhp, root / case / "jax", buckets=[(16, 64)], fmt="onnx", **kwargs).export()
        exporter = DiffSingerVarianceExporter(php, root / case / "port", buckets=[(16, 64)],
                                              fmt="onnx", device="cpu", **kwargs)
        exporter.export()
        out[case] = (exporter, jhp, root / case / "jax", root / case / "port")
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_variance_onnx_signatures_and_dsconfig_equal_the_jax_exporters(bundles, case):
    _, _, jax_dir, port_dir = bundles[case]
    jcfg = yaml.safe_load((jax_dir / "dsconfig.yaml").read_text())
    pcfg = yaml.safe_load((port_dir / "dsconfig.yaml").read_text())
    assert pcfg.pop("device") == "cpu"
    assert pcfg == jcfg
    for view in VIEWS:
        name = jcfg["buckets"]["16x64"][view]
        data = (port_dir / name).read_bytes()
        jax_check_model(data, known_ops=JAX_EMITTED_OPS)
        assert signature(data) == signature((jax_dir / name).read_bytes()), view
    pitch_inputs = parse_model((port_dir / jcfg["buckets"]["16x64"]["pitch_onnx"])
                               .read_bytes()).inputs
    if case == "exposed":
        assert pitch_inputs == ["encoder_out", "ph_dur", "note_midi", "note_rest", "note_dur",
                                "note_glide", "pitch", "expr", "retake", "spk_embed", "steps"]
        for spk in ("spk0", "spk1"):
            emb = f"var.{spk}.emb"
            np.testing.assert_allclose(np.fromfile(port_dir / emb, np.float32),
                                       np.fromfile(jax_dir / emb, np.float32), atol=1e-6)
    else:
        assert pitch_inputs == ["encoder_out", "ph_dur", "note_midi", "note_rest", "note_dur",
                                "pitch", "retake", "steps"]
    assert sorted(p.name for p in port_dir.iterdir()) == sorted(p.name for p in jax_dir.iterdir())


def deployed_feed(seed: int, hidden: int):
    """One [1, 16 phonemes] x [1, 64 frames] request with padding, a partial
    retake, expr and curves (numpy)."""
    rng = np.random.default_rng(seed)
    ph_dur = np.zeros((1, 16), np.int32)
    ph_dur[0, :12] = rng.integers(2, 8, 12)
    note_dur = np.zeros((1, 16), np.int32)
    note_dur[0, :6] = rng.integers(4, 10, 6)
    retake = np.zeros((1, 64), bool)
    retake[:, 16:48] = True
    var_retake = np.ones((1, 64, 4), bool)
    var_retake[:, :30, 2] = False
    return dict(
        encoder_out=rng.standard_normal((1, 16, hidden)).astype(np.float32), ph_dur=ph_dur,
        note_midi=rng.uniform(55, 70, (1, 16)).astype(np.float32),
        note_rest=rng.random((1, 16)) < 0.2, note_dur=note_dur,
        note_glide=rng.integers(0, 3, (1, 16)).astype(np.int32),
        pitch=(62 + 3 * np.sin(np.linspace(0, 4, 64))[None]).astype(np.float32),
        expr=rng.uniform(0, 1, (1, 64)).astype(np.float32), retake=retake,
        var_retake=var_retake, spk_embed=rng.standard_normal((1, 1, hidden)).astype(np.float32),
        **{v: rng.uniform(-60, -20, (1, 64)).astype(np.float32)
           for v in ("energy", "breathiness", "voicing", "tension")})


@pytest.mark.parametrize("case", list(CASES))
def test_variance_onnx_matches_jax_deployed_views(bundles, case):
    """Each graph of the bundle through the interpreter, against the JAX
    model's linguistic ``encode`` and deployed views, on the port's weights
    carried across by ``convert_variance``. The interpreter draws the
    graphs' RandomNormalLike from ``default_rng(rng_seed)``; the test makes
    the same draw for JAX."""
    from diffsinger_tpu.models.toplevel import DiffSingerVariance as JaxVariance
    from diffsinger_tpu.utils.torch_model_convert import convert_variance

    exporter, jhp, _, port_dir = bundles[case]
    state = exporter.model.module.state_dict()
    jmodel = JaxVariance(jhp, vocab_size=len(exporter.infer.phoneme_dictionary))
    params = convert_variance(state, jhp)
    files = exporter.bucket_files["16x64"]
    names = exporter._input_names
    hidden = jhp["hidden_size"]
    feed = deployed_feed(3, hidden)
    frozen = case == "frozen"
    spk = (state["spk_embed.weight"][1].numpy()[None, None] if frozen else feed["spk_embed"])

    tokens = np.zeros((1, 16), np.int32)
    tokens[0, :12] = np.arange(3, 15)
    ling = dict(tokens=tokens, midi=np.full((1, 16), 62, np.int32),
                ph2word=np.r_[np.repeat(np.arange(1, 7), 2), [0] * 4][None].astype(np.int32),
                word_dur=np.full((1, 16), 8.0, np.float32), ph_spk_embed=feed["spk_embed"])
    got = run_model((port_dir / files["linguistic_onnx"]).read_bytes(),
                    {k: ling[k] for k in names["linguistic"]})
    want = jmodel.module.apply(params, *(jnp.asarray(ling[k]) for k in ("tokens", "midi",
                                                                         "ph2word")),
                               word_dur=jnp.asarray(ling["word_dur"]),
                               ph_spk_mix_embed=jnp.asarray(spk), infer=True, method="encode")
    enc, dur = got
    assert np.abs(enc - np.asarray(want[0])).max() <= TOL
    # durations come out of exp(): float32's relative error, at up to 200 frames
    np.testing.assert_allclose(dur, np.asarray(want[1]), rtol=1e-5, atol=TOL)

    j = {k: jnp.asarray(v) for k, v in feed.items()}
    for steps in (2, 3):
        ins = dict(feed, steps=np.int32(steps), retake=feed["retake"])
        (pitch,) = run_model((port_dir / files["pitch_onnx"]).read_bytes(),
                             {k: ins[k] for k in names["pitch"]}, rng_seed=steps)
        noise = np.random.default_rng(steps).standard_normal((1, 64, 8)).astype(np.float32)
        want = jmodel.forward_pitch_deployed(
            params, None, j["encoder_out"], j["ph_dur"], j["note_midi"], j["note_dur"],
            j["pitch"], j["retake"], note_rest=j["note_rest"],
            note_glide=jnp.zeros((1, 16), jnp.int32) if frozen else j["note_glide"],
            expr=None if frozen else j["expr"], spk_mix_embed=jnp.asarray(spk),
            steps=jnp.int32(steps), noise=jnp.asarray(noise))
        assert pitch.shape == (1, 64) and np.abs(pitch - np.asarray(want)).max() <= TOL

        ins = dict(feed, steps=np.int32(steps), retake=feed["var_retake"])
        curves = run_model((port_dir / files["variance_onnx"]).read_bytes(),
                           {k: ins[k] for k in names["variance"]}, rng_seed=steps)
        noise = np.random.default_rng(steps).standard_normal((1, 64, 16)).astype(np.float32)
        want = jmodel.forward_variance_deployed(
            params, None, j["encoder_out"], j["ph_dur"], j["pitch"],
            {v: j[v] for v in ("energy", "breathiness", "voicing", "tension")},
            j["var_retake"], spk_mix_embed=jnp.asarray(spk), steps=jnp.int32(steps),
            noise=jnp.asarray(noise))
        for g, w in zip(curves, want, strict=True):
            assert g.shape == (1, 64) and np.abs(g - np.asarray(w)).max() <= TOL
