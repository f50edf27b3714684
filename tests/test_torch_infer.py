"""The port's .ds inference runtime against the JAX package's, on the CPU in float32.

Both packages load the same experiment folder (``tests/torch_parity.py::make_exp``:
``config.yaml``, the dictionary, one ``model_ckpt_steps_10.ckpt`` in the reference
layout, which the JAX side converts with its own ``convert_checkpoint_file`` and
the port loads natively, and one full-NSF vocoder ``model.ckpt`` + ``config.json``).
The JAX runtime draws its noise from ``jax.random``; the tests make the same
draws from the same keys and inject them into the port.

Tolerances: preprocessing is bit-equal; mel and wav max |diff| <= 1e-4 (two
sampler steps and the vocoder in float32, sums in another order); a written
16-bit wav differs by at most one step of 1/32767 beyond that.
"""

import importlib.util
import wave

import jax
import numpy as np
import pytest
import torch

from diffsinger_tpu.config import load_config as jax_load_config
from diffsinger_tpu.inference.ds_acoustic import DiffSingerAcousticInfer as JaxInfer
from diffsinger_tpu.utils.text import load_phoneme_dictionary as jax_load_dictionary
from diffsinger_tpu_torch.cli import infer as cli
from diffsinger_tpu_torch.config import load_config
from diffsinger_tpu_torch.inference.base_svs_infer import bucket_length
from diffsinger_tpu_torch.inference.ds_acoustic import DiffSingerAcousticInfer
from diffsinger_tpu_torch.utils import ckpt as port_ckpt
from diffsinger_tpu_torch.utils.text import load_phoneme_dictionary
from diffsinger_tpu_torch.vocoders.registry import get_vocoder_cls
from tests.torch_parity import (MELS, REPO, jax_sampler_noise, jax_vocoder_noise, load_ds,
                                make_exp)

WAV_TOL = 1e-4
SAMPLE = str(REPO / "samples" / "00_xiao_xing_xing.ds")
# the three segments of samples/08 that share the 512-frame bucket
SEGMENTS = (1, 3, 6)


@pytest.fixture(scope="module")
def exp(tmp_path_factory):
    """(checkpoints root, JAX hparams, port hparams) of one shared folder."""
    ckpt_root = make_exp(tmp_path_factory.mktemp("exp"), "tiny_acoustic")
    return (ckpt_root,
            jax_load_config(exp_name="tiny_acoustic", infer=True, ckpt_root=ckpt_root),
            load_config(exp_name="tiny_acoustic", infer=True, ckpt_root=ckpt_root))


@pytest.fixture(scope="module")
def pair(exp):
    _, jhp, php = exp
    return JaxInfer(jhp), DiffSingerAcousticInfer(php, device="cpu")


def test_experiment_folder_loads_into_equal_hparams(exp):
    _, jhp, php = exp
    assert dict(jhp) == php
    assert php["infer"] is True and php["exp_name"] == "tiny_acoustic"
    assert php["work_dir"].endswith("tiny_acoustic")


# ------------------------------------------------------------------ preprocessing
RICH = dict(use_key_shift_embed=True, use_speed_embed=True, use_energy_embed=True,
            use_spk_id=True, num_spk=3, use_lang_id=True, num_lang=2,
            dictionaries={"zh": "opencpop-extension.txt", "ja": "demo-romaji.txt"},
            merged_phoneme_groups=[["zh/a", "ja/a"], ["zh/i", "ja/i"]])

SEGMENT_EDITS = {
    "plain": {},
    "gender_up": {"gender": 0.4},
    "gender_down": {"gender": -0.7},
    "gender_curve": {"gender": "0.0 1.0 -2.0 0.5", "gender_timestep": "0.5"},
    "velocity": {"velocity": "0.1 1.0 10.0", "velocity_timestep": "0.5"},
    "spk_static": {"spk_mix": {"spk0": 0.3, "spk2": 0.7}},
    "spk_dynamic": {"spk_mix": {"spk0": "0.1 0.5 0.9", "spk1": 0.4}, "spk_mix_timestep": "1.0"},
}


@pytest.fixture(scope="module")
def rich_pair(tmp_path_factory):
    """Both runtimes without models, on a multilingual, multi-speaker config."""
    ckpt_root = make_exp(tmp_path_factory.mktemp("rich"), "rich", RICH,
                         acoustic_steps=None, vocoder=None)
    ji = JaxInfer(jax_load_config(exp_name="rich", infer=True, ckpt_root=ckpt_root),
                  load_model=False, load_vocoder=False)
    ji.phoneme_dictionary = jax_load_dictionary(ji.hparams)
    pi = DiffSingerAcousticInfer(load_config(exp_name="rich", infer=True, ckpt_root=ckpt_root),
                                 load_model=False, load_vocoder=False, device="cpu")
    pi.phoneme_dictionary = load_phoneme_dictionary(pi.hparams)
    ji.load_maps()
    pi.load_maps()
    return ji, pi


def assert_same_arrays(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("case", list(SEGMENT_EDITS))
def test_preprocess_input_bit_equal_on_hand_made_segments(rich_pair, case):
    ji, pi = rich_pair
    rng = np.random.default_rng(3)
    seg = dict(load_ds("00_xiao_xing_xing.ds")[0], lang="zh", spk_mix={"spk1": 1.0},
               energy=" ".join("%.2f" % v for v in rng.uniform(-60, -20, 90)),
               energy_timestep="0.05")
    # a phoneme of a merged zh/ja group, tagged with the other language
    seg["ph_seq"] = seg["ph_seq"].replace(" a SP", " ja/a SP")
    seg.update(SEGMENT_EDITS[case])
    want = ji.preprocess_input(dict(seg))
    got = pi.preprocess_input(dict(seg))
    assert_same_arrays(got, want)
    assert {"languages", "key_shift", "speed", "energy", "spk_mix_id", "spk_mix_value"} <= set(got)
    assert got["languages"][0].tolist() == [0] * 13 + [1, 0]  # lang_map: ja 1, zh 2
    if case == "spk_dynamic":
        assert got["spk_mix_value"].shape[1] == got["mel2ph"].shape[1]
    if case == "gender_curve":
        assert got["key_shift"].min() < 0 < got["key_shift"].max()


@pytest.mark.parametrize("idx", [0, 1])
def test_preprocess_input_bit_equal_on_shipped_sample(pair, idx):
    ji, pi = pair
    seg = load_ds("00_xiao_xing_xing.ds")[idx]
    assert_same_arrays(pi.preprocess_input(seg), ji.preprocess_input(seg))


def test_pad_batch_pads_to_the_same_buckets(pair):
    ji, pi = pair
    batch = pi.preprocess_input(load_ds("08_qiu_yu.ds")[0])
    got, length = pi._pad_batch(batch)
    want, want_length = ji._pad_batch(batch)
    assert length == want_length == 607
    assert got["mel2ph"].shape == (1, 640) and got["tokens"].shape == (1, 32)
    assert_same_arrays(got, want)


# ------------------------------------------------------------------ model and vocoder
@pytest.mark.parametrize("idx", SEGMENTS)
def test_forward_wav_matches_on_shared_checkpoints(pair, idx):
    ji, pi = pair
    batch = pi.preprocess_input(load_ds("08_qiu_yu.ds")[idx])
    t_mel = bucket_length(batch["mel2ph"].shape[1])
    want = ji.forward_wav(batch, jax.random.PRNGKey(7), steps=2)
    got = pi.forward_wav(batch, None, steps=2, noise=jax_sampler_noise(7, (1, t_mel, MELS)),
                         vocoder_noise=jax_vocoder_noise(1, t_mel))
    assert got.shape == want.shape == (batch["mel2ph"].shape[1] * 512,)
    assert np.abs(want).max() > 0.05  # not silence
    assert np.abs(got - want).max() <= WAV_TOL


def test_forward_model_and_run_vocoder_match(pair):
    ji, pi = pair
    batch = pi.preprocess_input(load_ds("08_qiu_yu.ds")[6])
    want_mel, want_f0 = ji.forward_model(batch, jax.random.PRNGKey(5), steps=2)
    got_mel, got_f0 = pi.forward_model(batch, None, steps=2,
                                       noise=jax_sampler_noise(5, (1, 512, MELS)))
    assert got_mel.shape == want_mel.shape == (1, 423, MELS)
    np.testing.assert_array_equal(got_f0, want_f0)
    assert np.abs(got_mel - want_mel).max() <= WAV_TOL
    # the vocoder alone, on the unpadded mel, as the two-step path runs it
    want = ji.run_vocoder(want_mel, want_f0)
    got = pi.vocoder.spec2wav_torch(torch.from_numpy(want_mel), torch.from_numpy(want_f0),
                                    noise=jax_vocoder_noise(1, 423))[0].numpy()
    assert np.abs(got - want).max() <= WAV_TOL
    # the host API draws from its own generator: deterministic, of the right length
    again = pi.vocoder.spec2wav(want_mel[0], f0=want_f0[0])
    np.testing.assert_array_equal(again, pi.run_vocoder(want_mel, want_f0))
    assert again.shape == (423 * 512,)


def test_without_injected_noise_the_seed_decides(pair):
    _, pi = pair
    batch = pi.preprocess_input(load_ds("00_xiao_xing_xing.ds")[0])
    a = pi.forward_model(batch, pi._generator(3), steps=2)[0]
    b = pi.forward_model(batch, pi._generator(3), steps=2)[0]
    c = pi.forward_model(batch, pi._generator(4), steps=2)[0]
    np.testing.assert_array_equal(a, b)
    assert np.abs(a - c).max() > 1e-3


# ------------------------------------------------------------------ run_inference
def _read_wav(path):
    with wave.open(str(path)) as f:
        assert f.getsampwidth() == 2 and f.getnchannels() == 1
        return f.getframerate(), np.frombuffer(f.readframes(f.getnframes()), np.int16)


def test_run_inference_writes_the_same_wav_cross_fades_included(pair, tmp_path):
    ji, pi = pair
    ds = load_ds("08_qiu_yu.ds")
    # the second segment starts before the first ends: the runtime cross-fades
    params = [dict(ds[3]), dict(ds[6], offset=ds[3]["offset"] + 4.0)]
    ji.run_inference([dict(p) for p in params], out_dir=tmp_path / "jax", title="t", seed=11,
                     steps=2)
    pi.run_inference(
        [dict(p) for p in params], out_dir=tmp_path / "port", title="t", seed=11, steps=2,
        noise_fn=lambda i, shape: jax_sampler_noise(11, shape),
        vocoder_noise_fn=lambda i, b, t_mel: jax_vocoder_noise(b, t_mel))
    sr, want = _read_wav(tmp_path / "jax" / "t.wav")
    sr2, got = _read_wav(tmp_path / "port" / "t.wav")
    assert sr == sr2 == 44100 and got.shape == want.shape
    overlap = round(ds[3]["offset"] * sr) + 466 * 512 - round(params[1]["offset"] * sr)
    assert overlap > 10000  # samples under the cross-fade
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32)).max()
    assert diff <= 1 + round(WAV_TOL * 32767)
    assert np.abs(want).max() > 1000


def test_run_inference_writes_the_same_mel_npz(pair, tmp_path):
    ji, pi = pair
    params = load_ds("00_xiao_xing_xing.ds")
    ji.run_inference([dict(p) for p in params], out_dir=tmp_path / "jax", title="m", seed=2,
                     save_mel=True, steps=2, num_runs=2)
    pi.run_inference([dict(p) for p in params], out_dir=tmp_path / "port", title="m", seed=2,
                     save_mel=True, steps=2, num_runs=2,
                     noise_fn=lambda i, shape: jax_sampler_noise(2, shape))
    for run in ("m-000.mel.npz", "m-001.mel.npz"):
        want = np.load(tmp_path / "jax" / run)
        got = np.load(tmp_path / "port" / run)
        assert sorted(got.files) == sorted(want.files)
        assert int(got["num_segments"]) == 2
        for k in want.files:
            assert got[k].shape == want[k].shape, k
            assert np.abs(got[k] - want[k]).max() <= WAV_TOL, k


def test_a_segment_seed_wins_over_the_call_seed(pair, tmp_path):
    _, pi = pair
    seen = []
    real = pi._generator
    pi._generator = lambda seed: (seen.append(seed), real(seed))[1]
    try:
        params = [dict(p) for p in load_ds("00_xiao_xing_xing.ds")]
        params.append(dict(params[0], offset=10.0))
        params[1]["seed"] = 99
        pi.run_inference(params, out_dir=tmp_path, title="s", seed=5, save_mel=True, steps=2)
    finally:
        del pi._generator
    assert seen == [5, 99, 5]


# ------------------------------------------------------------------ checkpoints and the entry point
@pytest.fixture()
def jax_cli(monkeypatch, tmp_path):
    """scripts/infer.py as a module (it sets JAX's compilation cache at import)."""
    monkeypatch.setenv("DS_JAX_CACHE_DIR", str(tmp_path / "jax_cache"))
    spec = importlib.util.spec_from_file_location("_jax_infer_cli", REPO / "scripts" / "infer.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_find_exp_by_name_and_prefix(exp, jax_cli, monkeypatch):
    monkeypatch.setenv("DS_CKPT_ROOT", str(exp[0]))
    for name in ("tiny_acoustic", "tiny"):
        assert cli.find_exp(name) == jax_cli.find_exp(name) == "tiny_acoustic"
    with pytest.raises(ValueError, match="no matching exp"):
        cli.find_exp("nothing")


@pytest.mark.parametrize("depth,steps", [(None, None), (0.3, None), (None, 7), (0.6, 5)])
@pytest.mark.parametrize("legacy", [False, True])
def test_legacy_migration_and_overrides_give_equal_hparams(exp, jax_cli, depth, steps, legacy):
    _, jhp, php = exp
    jhp, php = jhp.copy(), dict(php)
    if legacy:  # a config of an older release: no T_start_infer, sampling_steps, diff_speedup
        for hp in (jhp, php):
            for k in ("T_start_infer", "sampling_steps", "time_scale_factor", "diff_speedup"):
                hp.pop(k)
            hp["pndm_speedup"] = 8
    want = jax_cli.apply_depth_steps_overrides(
        jax_cli.migrate_legacy_hparams(jhp, infer_acoustic=True), depth, steps, acoustic=True)
    got = cli.apply_depth_steps_overrides(
        cli.migrate_legacy_hparams(php, infer_acoustic=True), depth, steps, acoustic=True)
    assert got == dict(want)
    assert got["sampling_steps"] == (steps or (50 if legacy else 2))
    assert got["T_start_infer"] == pytest.approx(1 - depth if depth else 0.6 if legacy else 0.4)


def test_depth_beyond_the_trained_range_is_refused(exp):
    with pytest.raises(AssertionError, match="Depth"):
        cli.apply_depth_steps_overrides(dict(exp[2]), 0.9, None)


def _cli(ckpt_root, monkeypatch, *args):
    monkeypatch.setenv("DS_CKPT_ROOT", str(ckpt_root))
    cli.main(["acoustic", SAMPLE, "--exp", "tiny", "--device", "cpu", *map(str, args)])


def test_entry_point_same_seed_same_wav(exp, monkeypatch, tmp_path):
    for out in ("a", "b"):
        _cli(exp[0], monkeypatch, "--seed", 3, "--out", tmp_path / out)
    _cli(exp[0], monkeypatch, "--seed", 4, "--out", tmp_path / "c")
    sr, a = _read_wav(tmp_path / "a" / "00_xiao_xing_xing.wav")
    _, b = _read_wav(tmp_path / "b" / "00_xiao_xing_xing.wav")
    _, c = _read_wav(tmp_path / "c" / "00_xiao_xing_xing.wav")
    np.testing.assert_array_equal(a, b)
    assert (a != c).any()
    last = load_ds("00_xiao_xing_xing.ds")[-1]
    assert sr == 44100 and abs(len(a) - (round(last["offset"] * sr) + 388 * 512)) <= 512


def test_entry_point_batched_and_titled(exp, monkeypatch, tmp_path):
    _cli(exp[0], monkeypatch, "--seed", 3, "--batch_size", 4, "--title", "served", "--num", 2,
         "--out", tmp_path)
    sr, a = _read_wav(tmp_path / "served-000.wav")
    _, b = _read_wav(tmp_path / "served-001.wav")
    np.testing.assert_array_equal(a, b)  # --seed fixes every run
    assert np.abs(a).max() > 1000


def test_entry_point_key_shift_names_the_file_and_moves_f0(exp, monkeypatch, tmp_path):
    _cli(exp[0], monkeypatch, "--seed", 3, "--mel", "--steps", 3, "--out", tmp_path)
    _cli(exp[0], monkeypatch, "--seed", 3, "--mel", "--steps", 3, "--key", 2, "--out", tmp_path)
    base = np.load(tmp_path / "00_xiao_xing_xing.mel.npz")
    up = np.load(tmp_path / "00_xiao_xing_xing+2key.mel.npz")
    # trans_key writes the transposed f0 with one decimal
    np.testing.assert_allclose(up["f0_0"], base["f0_0"] * 2 ** (2 / 12), atol=0.06)


def test_entry_point_raises_without_a_card_unless_the_cpu_is_asked_for(exp, monkeypatch, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    monkeypatch.setenv("DS_CKPT_ROOT", str(exp[0]))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["acoustic", SAMPLE, "--exp", "tiny", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DiffSingerAcousticInfer(exp[2])


def test_variance_command_names_its_slice():
    """The variance command is ported: it takes the flags of
    ``scripts/infer.py variance`` (plus --device) and, like every entry point,
    refuses to run without a card unless the CPU is asked for."""
    args = cli.build_parser().parse_args(
        ["variance", SAMPLE, "--exp", "e", "--ckpt", "3", "--predict", "dur", "--predict",
         "pitch", "--spk", "a", "--lang", "zh", "--out", "o", "--title", "t", "--num", "2",
         "--key", "-1", "--expr", "0.5", "--seed", "4", "--steps", "8", "--batch_size", "16",
         "--device", "cpu"])
    assert (args.command, args.predict, args.expr, args.steps, args.batch_size) == (
        "variance", ["dur", "pitch"], 0.5, 8, 16)
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["variance", SAMPLE, "--exp", "e", "--expr", "1.5"])


def test_category_mismatch_raises(tmp_path):
    ckpt_root = make_exp(tmp_path, "wrong", vocoder=None)
    path = port_ckpt.checkpoint_path(ckpt_root / "wrong", 10)
    blob = torch.load(path, weights_only=False)
    torch.save(dict(blob, category="variance"), path)
    hp = load_config(exp_name="wrong", infer=True, ckpt_root=ckpt_root)
    with pytest.raises(RuntimeError, match="Category mismatches"):
        DiffSingerAcousticInfer(hp, load_vocoder=False, device="cpu")


def test_missing_checkpoints_warn_and_keep_seeded_weights(tmp_path):
    ckpt_root = make_exp(tmp_path, "empty", acoustic_steps=None, vocoder=None)
    hp = load_config(exp_name="empty", infer=True, ckpt_root=ckpt_root)
    with pytest.warns(UserWarning) as caught:
        a = DiffSingerAcousticInfer(hp, device="cpu")
    messages = [str(w.message) for w in caught]
    assert any("No checkpoint in" in m and "RANDOM weights" in m for m in messages)
    assert any("NSF-HiFiGAN checkpoint not found" in m for m in messages)
    with pytest.warns(UserWarning):
        b = DiffSingerAcousticInfer(hp, device="cpu")
    for x, y in ((a.model.module, b.model.module), (a.vocoder.model, b.vocoder.model)):
        for (k, v), w in zip(x.state_dict().items(), y.state_dict().values()):
            assert torch.equal(v, w), k


@pytest.mark.parametrize("ckpt_steps,want", [(None, 300), (300, 300), (250, 200), (100, 100)])
def test_checkpoint_discovery_by_step(tmp_path, ckpt_steps, want):
    for steps in (100, 200, 300):
        port_ckpt.checkpoint_path(tmp_path, steps).touch()
    (tmp_path / "model_ckpt_steps_400.ckpt.tmp").touch()
    assert port_ckpt.find_checkpoint(tmp_path, ckpt_steps) == (
        want, port_ckpt.checkpoint_path(tmp_path, want))


def test_checkpoint_discovery_finds_none(tmp_path):
    with pytest.raises(FileNotFoundError, match="No checkpoints found"):
        port_ckpt.find_checkpoint(tmp_path)
    port_ckpt.checkpoint_path(tmp_path, 100).touch()
    with pytest.raises(FileNotFoundError, match="at or before step 50"):
        port_ckpt.find_checkpoint(tmp_path, 50)


def test_a_checkpoint_with_other_keys_is_refused(tmp_path):
    ckpt_root = make_exp(tmp_path, "strict", vocoder=None)
    path = port_ckpt.checkpoint_path(ckpt_root / "strict", 10)
    blob = torch.load(path, weights_only=False)
    blob["state_dict"].pop("model.fs2.txt_embed.weight")
    torch.save(blob, path)
    hp = load_config(exp_name="strict", infer=True, ckpt_root=ckpt_root)
    with pytest.raises(RuntimeError, match="txt_embed"):
        DiffSingerAcousticInfer(hp, load_vocoder=False, device="cpu")


@pytest.mark.parametrize("name", ["DDSP", "ddsp", "DDSPNative", "ddspnative"])
def test_registry_returns_the_ports_ddsp_vocoders(name):
    from diffsinger_tpu_torch.vocoders import ddsp, ddsp_native

    want = ddsp.DDSP if name.lower() == "ddsp" else ddsp_native.DDSPNative
    assert get_vocoder_cls({"vocoder": name}) is want
    assert get_vocoder_cls({"vocoder": "NsfHifiGAN"}).__name__ == "NsfHifiGAN"


def test_mel_base_10_is_scaled_to_natural_log(pair):
    _, pi = pair
    rng = np.random.default_rng(0)
    mel = torch.from_numpy(rng.uniform(-5, 0, (1, 8, MELS)).astype(np.float32))
    f0 = torch.full((1, 8), 220.0)
    noise = jax_vocoder_noise(1, 8)
    want = pi.vocoder.spec2wav_torch(2.30259 * mel, f0, noise=noise)
    pi.vocoder.hparams = dict(pi.vocoder.hparams, mel_base=10)
    try:
        got = pi.vocoder.spec2wav_torch(mel, f0, noise=noise)
    finally:
        pi.vocoder.hparams = pi.hparams
    assert torch.equal(got, want)
