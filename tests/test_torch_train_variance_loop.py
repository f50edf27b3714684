"""The variance model's training runtime in the port against the JAX
package's, on the CPU: the batch sampler and ``VarianceDataset.collater`` over
an HDF5 store written by the JAX package's IndexedDatasetBuilder, and the loop
itself (a few steps through ``cli.train`` with validation, its metrics and
figures, checkpoints, rotation, resume), whose checkpoint both packages then
load for the same ``forward_infer``.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.data.batch_sampler import DsBatchSampler as JaxSampler
from diffsinger_tpu.data.dataset import VarianceDataset as JaxDataset
from diffsinger_tpu.data.indexed_datasets import IndexedDatasetBuilder
from diffsinger_tpu_torch.data.batch_sampler import DsBatchSampler
from diffsinger_tpu_torch.data.dataset import VarianceDataset
from tests.torch_parity import DICT, REPO, TINY_VARIANCE

VARIANCES = ("energy", "breathiness", "voicing", "tension")


def make_variance_binary(path, n_train=10, n_valid=2, vocab=40, seed=0):
    """A binarized variance store written by the JAX package's writer: items
    with the arrays the variance binarizer writes (phonemes with words and
    durations, notes with glides, frame alignments, base pitch, pitch, uv and
    the four curves), speaker and language ids; ``.meta`` with the length of
    every array and the item lengths."""
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for prefix, n in (("train", n_train), ("valid", n_valid)):
        writer = IndexedDatasetBuilder(path, prefix)
        meta = {"lengths": []}
        for _ in range(n):
            n_word, t = int(rng.integers(3, 8)), int(rng.integers(40, 200))
            ph_num = rng.integers(1, 3, n_word)
            n_ph = int(ph_num.sum())
            ph_dur = rng.multinomial(t - n_ph, np.ones(n_ph) / n_ph) + 1
            note_dur = np.add.reduceat(ph_dur, np.r_[0, np.cumsum(ph_num)[:-1]])
            note_midi = rng.uniform(55, 70, n_word).astype(np.float32)
            base_pitch = np.repeat(note_midi, note_dur).astype(np.float32)
            item = dict(
                tokens=rng.integers(1, vocab, n_ph), ph_dur=ph_dur,
                ph2word=np.repeat(np.arange(1, n_word + 1), ph_num),
                midi=np.repeat(np.round(note_midi), ph_num).astype(np.int64),
                mel2ph=np.repeat(np.arange(1, n_ph + 1), ph_dur),
                note_midi=note_midi, note_rest=rng.random(n_word) < 0.15, note_dur=note_dur,
                note_glide=rng.integers(0, 3, n_word), mel2note=np.repeat(np.arange(1, n_word + 1),
                                                                         note_dur),
                base_pitch=base_pitch,
                pitch=(base_pitch + rng.normal(0, 0.4, t)).astype(np.float32),
                uv=rng.random(t) < 0.1, spk_id=int(rng.integers(0, 2)),
                languages=rng.integers(0, 3, n_ph),
                **{v: rng.uniform(-70, -20, t).astype(np.float32) for v in VARIANCES})
            writer.add_item(item)
            for k, v in item.items():
                if isinstance(v, np.ndarray):
                    meta.setdefault(k, []).append(len(v))
            meta["lengths"].append(t)
        writer.finalize()
        with open(path / f"{prefix}.meta", "wb") as f:
            pickle.dump(meta, f)
    return path


COLLATE_HP = {
    "word_mode": dict(predict_dur=True, predict_pitch=True, use_glide_embed=True,
                      predict_energy=True, predict_tension=True, use_spk_id=True,
                      use_lang_id=True),
    "phoneme_mode": dict(predict_dur=False, predict_pitch=False, predict_breathiness=True),
    "durations_only": dict(predict_dur=True, predict_pitch=False),
}


@pytest.mark.parametrize("case", sorted(COLLATE_HP))
def test_sampler_and_collater_match_jax(tmp_path, case):
    """Batches of two epochs, and every collated array, equal the JAX ones;
    also with pad_to raising each axis."""
    d = make_variance_binary(tmp_path / "binary")
    hp = dict(COLLATE_HP[case], dataset_size_key="lengths")
    jds, pds = JaxDataset(d, hp, "train"), VarianceDataset(d, hp, "train")
    assert list(pds.sizes) == list(jds.sizes)
    pad_to = {"t_mel": 512, "t_txt": 32, "t_note": 48}
    for epoch in range(2):
        kw = dict(max_batch_frames=600, max_batch_size=4, seed=1234)
        js = JaxSampler(jds.sizes, shuffle_sample=True, shuffle_batch=True, **kw)
        ps = DsBatchSampler(pds.sizes, shuffle_sample=True, **kw)
        js.set_epoch(epoch)
        ps.set_epoch(epoch)
        jb, pb = list(js), list(ps)
        assert pb == jb and len(pb) > 2
        for indices in pb:
            for extra in ({}, {"pad_to": pad_to}):
                want = jds.collater([jds[i] for i in indices], **extra)
                got = pds.collater([pds[i] for i in indices], **extra)
                assert sorted(got) == sorted(want)
                for k, v in want.items():
                    assert np.asarray(got[k]).dtype == np.asarray(v).dtype, k
                    np.testing.assert_array_equal(got[k], v, err_msg=k)


# ------------------------------------------------------------------ the loop

TINY = dict(TINY_VARIANCE, use_melody_encoder=True, use_glide_embed=True, max_batch_frames=500,
            log_interval=2, val_check_interval=3, num_ckpt_keep=2, permanent_ckpt_start=3,
            permanent_ckpt_interval=3, num_valid_plots=1, max_val_batch_size=2)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """cli.train on the CPU: 4 updates, then a resume to 7."""
    import yaml

    from diffsinger_tpu_torch.cli import train as cli_train

    tmp = tmp_path_factory.mktemp("loop")
    make_variance_binary(tmp / "binary", n_train=8)
    cfg = dict(TINY, base_config=[str(REPO / "configs" / "variance.yaml")],
               binary_data_dir=str(tmp / "binary"), dictionary=str(DICT))
    (tmp / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    argv = ["--config", str(tmp / "cfg.yaml"), "--exp_name", "exp", "--ckpt_root",
            str(tmp / "ckpt"), "--device", "cpu"]
    cli_train.main(argv + ["--max_steps", "4"])
    first = sorted(p.name for p in (tmp / "ckpt" / "exp").glob("*.ckpt"))
    cli_train.main(argv + ["--max_steps", "7"])
    return tmp, argv, first


def test_loop_validates_saves_rotates_and_resumes(trained):
    """Checkpoints at each validation (steps 3, 6 and the last), step 3
    permanent; AdamW's moments carried across the resume; each validation
    writes the losses and each metric once to metrics.jsonl, and the figures
    of the first item."""
    from diffsinger_tpu_torch.utils.ckpt import load_checkpoint

    tmp, _, first = trained
    work = tmp / "ckpt" / "exp"
    assert first == ["model_ckpt_steps_3.ckpt", "model_ckpt_steps_4.ckpt"]
    assert sorted(p.name for p in work.glob("*.ckpt")) == [
        "model_ckpt_steps_3.ckpt", "model_ckpt_steps_6.ckpt", "model_ckpt_steps_7.ckpt"]
    blob = load_checkpoint(work / "model_ckpt_steps_7.ckpt", category="variance")
    assert blob["global_step"] == 7 and blob["category"] == "variance"
    assert {int(s["step"]) for s in blob["optimizer_states"][0]["state"].values()} == {7}
    lines = [json.loads(line) for line in
             (work / "lightning_logs" / "tb" / "metrics.jsonl").read_text().splitlines()]
    metric_names = {"rhythm_corr", "ph_dur_acc", "pitch_acc", "pitch_r2",
                    *(f"{v}_r2" for v in VARIANCES)}
    validations = (3, 4, 6, 7)  # every val_check_interval and each run's end
    for name in metric_names:
        steps = [line["step"] for line in lines if f"metrics/{name}" in line]
        assert steps == list(validations), name
        values = [line[f"metrics/{name}"] for line in lines if f"metrics/{name}" in line]
        assert all(np.isfinite(values)), name
        if not name.endswith("_r2"):
            assert all(0 <= v <= 1 for v in values), name
    for loss in ("dur_loss", "pitch_loss", "var_loss"):
        assert [line["step"] for line in lines if f"validation/{loss}" in line] == list(validations)
    assert any("training/grad_norm" in line for line in lines)
    figures = {p.name for p in (work / "lightning_logs" / "tb" / "figures").glob("*.png")}
    for tag in ("dur_0", "pitch_0", *(f"{v}_0" for v in VARIANCES)):
        assert f"{tag}_step7.png" in figures, tag


def test_train_cli_raises_without_a_card_unless_the_cpu_is_asked_for(trained, monkeypatch):
    from diffsinger_tpu_torch.cli import train as cli_train

    _, argv, _ = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_train.main([a for a in argv if a not in ("--device", "cpu")] + ["--max_steps", "8"])


def test_saved_checkpoint_gives_the_same_forward_infer_in_both_packages(trained):
    """The trainer's .ckpt through the port's strict loader and through the
    JAX package's torch-checkpoint converter (convert_variance): durations,
    pitch and the four curves of forward_infer on the same inputs and noise
    agree to 1e-4 plus 1e-5 of the value (the trained predictor gives
    durations of over 100 frames, where a float32 ulp is 1.5e-5)."""
    from diffsinger_tpu.config import load_config as jax_load_config
    from diffsinger_tpu.models.toplevel import DiffSingerVariance as JaxVariance
    from diffsinger_tpu.utils.ckpt import load_params_for_inference
    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.models.toplevel import DiffSingerVariance
    from diffsinger_tpu_torch.utils.ckpt import load_state_dict_for_inference
    from diffsinger_tpu_torch.utils.text import load_phoneme_dictionary
    from tests.test_torch_variance import variance_inputs

    tmp, _, _ = trained
    hp = load_config(exp_name="exp", infer=True, ckpt_root=tmp / "ckpt")
    jhp = dict(jax_load_config(exp_name="exp", infer=True, ckpt_root=tmp / "ckpt"))
    vocab = len(load_phoneme_dictionary(hp))
    port = DiffSingerVariance(hp, vocab_size=vocab, device="cpu")
    info = load_state_dict_for_inference(port.module, hp["work_dir"], category="variance")
    assert info["global_step"] == 7
    jm = JaxVariance(jhp, vocab_size=vocab)
    template = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    params, _ = load_params_for_inference(hp["work_dir"], template, category="variance",
                                          hparams=jhp)
    inp = variance_inputs(8)
    b, t_s = inp["base_pitch"].shape
    rng = np.random.default_rng(9)
    noise_p = rng.standard_normal((b, t_s, 8)).astype(np.float32)
    noise_v = rng.standard_normal((b, t_s, 16)).astype(np.float32)
    args = ("tokens", "midi", "ph2word", "base_pitch")
    keys = ("word_dur", "note_midi", "note_rest", "note_dur", "note_glide", "mel2note")
    want = jax.jit(lambda p, a, kw, n_p, n_v: jm.forward_infer(
        p, jax.random.PRNGKey(0), *a, noise_pitch=n_p, noise_variances=n_v, **kw))(
        params, [jnp.asarray(inp[k]) for k in args], {k: jnp.asarray(inp[k]) for k in keys},
        jnp.asarray(noise_p), jnp.asarray(noise_v))
    got = port.forward_infer(*(torch.from_numpy(inp[k]) for k in args),
                             noise_pitch=torch.from_numpy(noise_p),
                             noise_variances=torch.from_numpy(noise_v),
                             **{k: torch.from_numpy(inp[k]) for k in keys})
    assert sorted(got[2]) == sorted(want[2]) == sorted(VARIANCES)
    for a, w in zip((got[0], got[1], *(got[2][v] for v in VARIANCES)),
                    (want[0], want[1], *(want[2][v] for v in VARIANCES))):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=1e-4, rtol=1e-5)
