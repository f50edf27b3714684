"""The port's variance runtime, ``VarianceServer`` and ``cli.infer variance``
against the JAX package's, on the CPU in float32, on the shipped score-only
samples (01-07, 10).

Both packages load one experiment folder (``tests/torch_parity.py::
make_variance_exp``: ``config.yaml`` at narrow widths with all four variances
on, the dictionary, a ``model_ckpt_steps_10.ckpt`` in the reference layout that
the JAX side converts with its own converter and the port loads natively). The
JAX runtime draws its noise from ``jax.random``; the tests make the same draws
from the same keys and inject them into the port.

Tolerances: preprocessing bit-equal; integer frame durations equal; pitch
(semitones) and variance curves max |diff| <= 1e-4; in the written .ds, where
f0 is rounded to 0.1 Hz and the curves to 1e-4, one rounding step more.
"""

import copy
import importlib.util
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.config import load_config as jax_load_config
from diffsinger_tpu.inference.ds_variance import DiffSingerVarianceInfer as JaxInfer
from diffsinger_tpu.inference.serving import VarianceServer as JaxServer
from diffsinger_tpu_torch.cli import infer as cli
from diffsinger_tpu_torch.config import load_config
from diffsinger_tpu_torch.inference.ds_variance import DiffSingerVarianceInfer
from diffsinger_tpu_torch.inference.serving import VarianceServer
from diffsinger_tpu_torch.utils import ckpt as port_ckpt
from tests.torch_parity import REPO, load_ds, make_variance_exp

TOL = 1e-4
SCORE_ONLY = ("01_score_only.ds", "02_chun_feng.ds", "03_ye_se.ds", "04_xiao_niao.ds",
              "05_yue_liang.ds", "06_lv_ye.ds", "07_dong_xue.ds", "10_shan_lu.ds")
VARS = ("energy", "breathiness", "voicing", "tension")


def jax_variance_noise(seed: int):
    """noise_fn of the port's runtime that returns the draws the JAX model
    makes from PRNGKey(seed): its forward splits the key into the pitch and
    the variance branch's and draws each branch's start from its half."""
    key_p, key_v = jax.random.split(jax.random.PRNGKey(seed & 0xFFFF_FFFF))

    def noise_fn(_index, name, shape):
        key = key_p if name == "noise_pitch" else key_v
        return torch.from_numpy(np.array(jax.random.normal(key, shape, jnp.float32)))

    return noise_fn


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """(checkpoints root, JAX hparams, port hparams) of one shared folder."""
    ckpt_root = make_variance_exp(tmp_path_factory.mktemp("vexp"), "tiny_variance")
    return (ckpt_root,
            jax_load_config(exp_name="tiny_variance", infer=True, ckpt_root=ckpt_root),
            load_config(exp_name="tiny_variance", infer=True, ckpt_root=ckpt_root))


_JAX = {}


def _jax_infer(jhp):
    if "infer" not in _JAX:
        _JAX["infer"] = JaxInfer(jhp)
    return _JAX["infer"]


@pytest.fixture(scope="module")
def pair(exp):
    _, jhp, php = exp
    return _jax_infer(jhp), DiffSingerVarianceInfer(php, device="cpu")


@pytest.fixture(scope="module")
def segments():
    return [seg for name in SCORE_ONLY for seg in load_ds(name)]


def test_experiment_folder_loads_equal_weights(exp, pair):
    _, jhp, php = exp
    assert dict(jhp) == php and php["predict_voicing"] and php["diffusion_type"] == "reflow"
    jinfer, pinfer = pair
    from diffsinger_tpu.utils.torch_model_convert import convert_variance

    back = convert_variance(pinfer.model.module.state_dict(), php)
    for path, leaf in jax.tree_util.tree_leaves_with_path(jinfer.params):
        got = back
        for k in path:
            got = got[k.key]
        np.testing.assert_array_equal(got, np.asarray(leaf), err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("predict", [(), ("dur",), ("pitch",), ("energy", "tension")])
@pytest.mark.parametrize("sample", ["01_score_only.ds", "00_xiao_xing_xing.ds"])
def test_flags_and_preprocessing_bit_equal(exp, sample, predict):
    _, jhp, php = exp
    pinfer = DiffSingerVarianceInfer(php, predictions=set(predict), device="cpu")
    # the JAX runtime's prediction settings, as its __init__ sets them (its
    # model init is the slow part, so the module's one instance is reused)
    jinfer = copy.copy(_jax_infer(jhp))
    jinfer.auto_completion_mode = not predict
    jinfer.global_predict_dur = "dur" in predict and jhp["predict_dur"]
    jinfer.global_predict_pitch = "pitch" in predict and jhp["predict_pitch"]
    jinfer.variance_prediction_set = set(predict).intersection(VARS)
    jinfer.global_predict_variances = bool(jinfer.variance_prediction_set)
    for i, seg in enumerate(load_ds(sample)[:3]):
        flags = pinfer.segment_flags(seg)
        assert flags == tuple(jinfer.segment_flags(seg))
        kw = dict(load_dur=not flags[0] and (flags[1] or flags[2]),
                  load_pitch=not flags[1] and flags[2])
        want = jinfer.preprocess_input(seg, idx=i, **kw)
        got = pinfer.preprocess_input(seg, idx=i, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


def _jax_forward(jinfer, batch, flags, seed):
    return jinfer.forward_model(batch, flags, jax.random.PRNGKey(seed))


@pytest.mark.parametrize("name", SCORE_ONLY)
def test_forward_model_per_segment(pair, name):
    """Every segment of the score alone (B=1 at its buckets), auto-completion:
    durations, pitch and all four variances."""
    jinfer, pinfer = pair
    seg = load_ds(name)[0]
    flags = pinfer.segment_flags(seg)
    assert flags == (True, True, True)
    batch = pinfer.preprocess_input(seg)
    jdur, jpitch, jvars = _jax_forward(jinfer, jinfer.preprocess_input(seg), flags, 3)
    t_s = batch["base_pitch"].shape[1]
    noise = pinfer.injected_noise(jax_variance_noise(3), 0, 1,
                                  pinfer.bucket_shapes(batch)[3])
    dur, pitch, var = pinfer.forward_model(batch, flags, **noise)
    assert dur.dtype == np.int32 and dur.shape == (batch["tokens"].shape[1],)
    assert np.array_equal(dur, np.asarray(jdur))
    assert pitch.shape == (t_s,) and np.abs(pitch - np.asarray(jpitch)).max() <= TOL
    assert sorted(var) == sorted(jvars) == sorted(VARS)
    for v in VARS:
        assert np.abs(var[v] - np.asarray(jvars[v])).max() <= TOL, v


def _read(path):
    with open(path, encoding="utf8") as f:
        return json.load(f)


def assert_same_ds(got, want):
    """Two written .ds files read back to the same values: texts equal but
    for f0 (0.1 Hz steps) and the curves (1e-4 steps), held to one step more
    than the model's tolerance."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in w:
            if key in ("f0_seq",) + VARS:
                a = np.asarray(g[key].split(), np.float64)
                b = np.asarray(w[key].split(), np.float64)
                # one rounding step beside the model's tolerance: 1e-4 for the
                # curves; for f0, 1e-4 semitones is under 0.03 Hz below 500 Hz
                tol = 0.1 + 0.03 if key == "f0_seq" else 1e-4 + TOL
                assert a.shape == b.shape and np.abs(a - b).max() <= tol, key
            else:
                assert g[key] == w[key], key


def test_run_inference_writes_the_same_ds(pair, tmp_path):
    jinfer, pinfer = pair
    params = load_ds("10_shan_lu.ds")
    jinfer.run_inference(params, out_dir=tmp_path / "jax", title="t", seed=5)
    pinfer.run_inference(params, out_dir=tmp_path / "port", title="t", seed=5,
                         noise_fn=jax_variance_noise(5))
    got, want = _read(tmp_path / "port" / "t.ds"), _read(tmp_path / "jax" / "t.ds")
    assert_same_ds(got, want)
    assert all(k in got[0] for k in ("ph_dur", "f0_seq", "f0_timestep", *VARS))


def test_server_batches_and_matches(exp, segments):
    """All 16 segments of the score-only samples through both servers at
    max_batch_size=16; the port's chunks are the JAX package's."""
    _, jhp, php = exp
    jserver = JaxServer(jhp, max_batch_size=16)
    pserver = VarianceServer(php, max_batch_size=16, device="cpu")
    flags_list, batches = pserver._preprocess_all(segments)
    chunks = pserver.chunks(batches, flags_list)
    assert [len(c[1]) for c in chunks] == [16]
    keys = [pserver._group_key(b, f) for b, f in zip(batches, flags_list)]
    assert keys == [jserver._group_key(b, f) for b, f in zip(batches, flags_list)]
    want = jserver.predict_batch(segments, seed=7)
    got = pserver.predict_batch(segments, seed=7, noise_fn=jax_variance_noise(7))
    for (dur, pitch, var), (jdur, jpitch, jvar) in zip(got, want):
        assert np.array_equal(dur, np.asarray(jdur))
        assert np.abs(pitch - np.asarray(jpitch)).max() <= TOL
        for v in VARS:
            assert np.abs(var[v] - np.asarray(jvar[v])).max() <= TOL, v


def test_server_stack_rows_and_seed_warning(exp, tmp_path, segments):
    _, _, php = exp
    server = VarianceServer(php, max_batch_size=4, device="cpu")
    assert VarianceServer._stack_rows([None, None]) is None
    rows = [np.ones((1, 3)), 2 * np.ones((1, 3))]
    assert VarianceServer._stack_rows(rows).tolist() == [[1] * 3, [2] * 3]
    flags_list, batches = server._preprocess_all(segments)
    assert [len(c[1]) for c in server.chunks(batches, flags_list)] == [4, 4, 4, 4]
    params = [dict(seg, seed=1) for seg in segments[:2]]
    with pytest.warns(UserWarning, match="per-segment 'seed'"):
        server.run_inference(params, out_dir=tmp_path, title="s", seed=2)
    assert len(_read(tmp_path / "s.ds")) == 2


@pytest.fixture()
def jax_cli(monkeypatch, tmp_path):
    """scripts/infer.py as a module (it sets JAX's compilation cache at import)."""
    monkeypatch.setenv("DS_JAX_CACHE_DIR", str(tmp_path / "jax_cache"))
    spec = importlib.util.spec_from_file_location("_jax_infer_cli", REPO / "scripts" / "infer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("batch_size", [1, 16])
def test_cli_variance_writes_what_scripts_infer_writes(exp, jax_cli, monkeypatch, tmp_path,
                                                       batch_size):
    """One score through both tools from one experiment folder, the JAX draws
    injected into the port's runtime under the tool."""
    monkeypatch.setenv("DS_CKPT_ROOT", str(exp[0]))
    run = (VarianceServer if batch_size > 1 else DiffSingerVarianceInfer).run_inference

    def with_jax_noise(self, *args, **kwargs):
        return run(self, *args, noise_fn=jax_variance_noise(kwargs["seed"]), **kwargs)

    monkeypatch.setattr(VarianceServer if batch_size > 1 else DiffSingerVarianceInfer,
                        "run_inference", with_jax_noise)
    sample = str(REPO / "samples" / "07_dong_xue.ds")
    common = ["--exp", "tiny", "--seed", "2", "--batch_size", str(batch_size)]
    jax_cli.main(["variance", sample, *common, "--out", str(tmp_path / "jax")],
                 standalone_mode=False)
    cli.main(["variance", sample, *common, "--out", str(tmp_path / "port"), "--device", "cpu"])
    got = _read(tmp_path / "port" / "07_dong_xue.ds")
    assert_same_ds(got, _read(tmp_path / "jax" / "07_dong_xue.ds"))
    assert "ph_dur" in got[0] and "tension" in got[0]


def test_cli_variance_names_its_output_and_needs_a_card(exp, monkeypatch, tmp_path):
    monkeypatch.setenv("DS_CKPT_ROOT", str(exp[0]))
    sample = tmp_path / "score.ds"
    sample.write_text(json.dumps(load_ds("01_score_only.ds")))
    cli.main(["variance", str(sample), "--exp", "tiny_var", "--device", "cpu", "--seed", "1",
              "--key", "2", "--predict", "dur"])
    got = _read(tmp_path / "score_variance+2key.ds")
    assert "ph_dur" in got[0] and "f0_seq" not in got[0]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["variance", str(sample), "--exp", "tiny_var"])


def test_variance_checkpoint_loading_is_strict(tmp_path):
    ckpt_root = make_variance_exp(tmp_path, "strict_var")
    hp = load_config(exp_name="strict_var", infer=True, ckpt_root=ckpt_root)
    path = port_ckpt.checkpoint_path(ckpt_root / "strict_var", 10)
    blob = torch.load(path, weights_only=False)
    torch.save(dict(blob, category="acoustic"), path)
    with pytest.raises(RuntimeError, match="Category mismatches"):
        DiffSingerVarianceInfer(hp, device="cpu")
    blob["state_dict"].pop("model.pitch_predictor.velocity_fn.mlp.0.weight")
    torch.save(blob, path)
    with pytest.raises(RuntimeError, match="mlp.0.weight"):
        DiffSingerVarianceInfer(hp, device="cpu")
    assert port_ckpt.is_buffer_key("pitch_predictor.spec_min")
    assert not port_ckpt.is_buffer_key("pitch_predictor.velocity_fn.mlp.0.weight")
    assert not port_ckpt.is_buffer_key("pitch_embed.weight")


def test_missing_variance_checkpoint_warns(tmp_path):
    ckpt_root = make_variance_exp(tmp_path, "empty_var", variance_steps=None)
    hp = load_config(exp_name="empty_var", infer=True, ckpt_root=ckpt_root)
    with pytest.warns(UserWarning, match="RANDOM weights"):
        DiffSingerVarianceInfer(hp, device="cpu")
