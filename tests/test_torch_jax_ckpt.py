"""The JAX trainer's checkpoints and the trainer's tensorboard events in the
PyTorch port, on the CPU.

A ``.dsckpt`` written by the JAX package's ``save_checkpoint`` (msgpack from
``flax.serialization``) into an experiment folder loads through the port's
own decoder and parameter map: the runtimes that ``cli.infer`` builds find
it, and ``forward_infer`` equals the JAX model's on the same inputs and noise
within 1e-4, for the acoustic and the variance model. The trainer resumes
from it only with ``allow_optimizer_state_reset`` (the optax state is not
carried over) and fine-tunes from the folder. The trainer's scalars, figures
and audio read back from its tensorboard event files.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.config import load_config as jax_load_config
from diffsinger_tpu.models.toplevel import DiffSingerAcoustic as JaxAcoustic
from diffsinger_tpu.models.toplevel import DiffSingerVariance as JaxVariance
from diffsinger_tpu.utils.ckpt import checkpoint_path as jax_checkpoint_path
from diffsinger_tpu.utils.ckpt import save_checkpoint as jax_save_checkpoint
from diffsinger_tpu.utils.torch_model_convert import convert_variance
from diffsinger_tpu_torch.config import load_config
from diffsinger_tpu_torch.inference.ds_acoustic import DiffSingerAcousticInfer
from diffsinger_tpu_torch.inference.ds_variance import DiffSingerVarianceInfer
from diffsinger_tpu_torch.utils import ckpt as ckpt_utils
from diffsinger_tpu_torch.utils.text import load_phoneme_dictionary
from tests.test_torch_variance import variance_inputs
from tests.torch_parity import (
    MELS, acoustic_inputs, jax_kwargs, make_exp, make_variance_exp, port_kwargs, randomize,
)

STEP = 12


def _save_jax(work_dir, params, category):
    """The JAX trainer's checkpoint of ``params``, with an optimizer state."""
    jax_save_checkpoint(jax_checkpoint_path(work_dir, STEP), params, category=category,
                        global_step=STEP, opt_state={"mu": jax.tree.map(jnp.zeros_like, params),
                                                     "count": jnp.asarray(STEP)},
                        extra={"epoch": 3})


@pytest.fixture(scope="module")
def acoustic_exp(tmp_path_factory):
    """An acoustic experiment folder holding only the JAX trainer's checkpoint."""
    root = make_exp(tmp_path_factory.mktemp("jexp"), "jax_acoustic",
                    dict(use_energy_embed=True, use_key_shift_embed=True),
                    acoustic_steps=None, vocoder=None)
    jhp = jax_load_config(exp_name="jax_acoustic", infer=True, ckpt_root=root)
    php = load_config(exp_name="jax_acoustic", infer=True, ckpt_root=root)
    vocab = len(load_phoneme_dictionary(php))
    jm = JaxAcoustic(jhp, vocab_size=vocab, out_dims=MELS)
    params = randomize(jax.jit(jm.init)(jax.random.PRNGKey(5)), 105)
    _save_jax(php["work_dir"], params, "acoustic")
    return root, jhp, php, jm, params


def test_decoder_reads_what_flax_writes(acoustic_exp):
    from flax import serialization

    _, _, php, _, _ = acoustic_exp
    path = ckpt_utils.find_checkpoint(php["work_dir"])[1]
    data = path.read_bytes()
    got, want = ckpt_utils.msgpack_restore(data), serialization.msgpack_restore(data)
    assert got["meta"] == want["meta"] == {"category": "acoustic", "global_step": STEP,
                                           "epoch": 3}
    leaves_got = jax.tree_util.tree_leaves_with_path(got)
    leaves_want = jax.tree_util.tree_leaves_with_path(want)
    assert [p for p, _ in leaves_got] == [p for p, _ in leaves_want]
    for (_, a), (_, b) in zip(leaves_got, leaves_want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_acoustic_dsckpt_infers_the_jax_output(acoustic_exp):
    """The runtime that cli.infer builds loads the folder's .dsckpt; forward_infer on
    the same inputs and noise agrees with the JAX model's within 1e-4."""
    _, _, php, jm, params = acoustic_exp
    infer = DiffSingerAcousticInfer(php, load_vocoder=False, device="cpu")
    inp = acoustic_inputs(seed=3, t_mel=40)
    noise = np.random.default_rng(4).standard_normal((2, 40, MELS)).astype(np.float32)
    keys = ("tokens", "mel2ph", "f0")
    want = jax.jit(lambda p, a, n, kw: jm.forward_infer(
        p, jax.random.PRNGKey(0), *a, noise=n, **kw).diff_out)(
        params, [jnp.asarray(inp[k]) for k in keys], jnp.asarray(noise), jax_kwargs(inp))
    got = infer.model.forward_infer(*(torch.from_numpy(inp[k]) for k in keys),
                                    noise=torch.from_numpy(noise), **port_kwargs(inp)).diff_out
    assert np.abs(np.asarray(want)).max() > 0.1
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4


def test_trainer_resumes_from_a_dsckpt_only_with_a_fresh_optimizer(acoustic_exp, tmp_path):
    """No optax state comes over: the resume raises unless
    allow_optimizer_state_reset, then starts at the checkpoint's step and
    epoch with its weights; fine-tuning takes the folder too."""
    from diffsinger_tpu_torch.training.acoustic_task import AcousticTask

    root, _, php, _, _ = acoustic_exp
    hp = dict(load_config(exp_name="jax_acoustic", infer=True, ckpt_root=root))
    want = ckpt_utils.load_checkpoint(ckpt_utils.find_checkpoint(php["work_dir"])[1],
                                      category="acoustic", hp=hp)["state_dict"]
    task = AcousticTask(hp, device="cpu")
    task.configure_optimizer()
    with pytest.raises(RuntimeError, match="optax state is not carried over"):
        task.init_or_resume()
    task = AcousticTask(dict(hp, allow_optimizer_state_reset=True), device="cpu")
    task.configure_optimizer()
    task.init_or_resume()
    assert (task.global_step, task.epoch) == (STEP, 3)
    assert task.scheduler.last_epoch == STEP
    got = task.module.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())
    fine = AcousticTask(dict(hp, work_dir=str(tmp_path / "fine"), finetune_enabled=True,
                             finetune_ckpt_path=php["work_dir"], finetune_ignored_params=[]),
                        device="cpu")
    fine.configure_optimizer()
    fine.init_or_resume()
    assert fine.global_step == 0
    got = fine.module.state_dict()
    assert all(torch.equal(got[k], v) for k, v in want.items())


def test_variance_dsckpt_infers_the_jax_output(tmp_path):
    """The variance runtime loads a folder's .dsckpt; forward_infer (pitch
    and the curves from the same first draws) agrees with the JAX model's
    within 1e-4."""
    root = make_variance_exp(tmp_path, "jax_variance", variance_steps=None)
    jhp = jax_load_config(exp_name="jax_variance", infer=True, ckpt_root=root)
    php = load_config(exp_name="jax_variance", infer=True, ckpt_root=root)
    with pytest.warns(UserWarning, match="RANDOM weights"):
        seeded = DiffSingerVarianceInfer(php, device="cpu")  # no checkpoint yet
    vocab = len(seeded.phoneme_dictionary)
    params = randomize(convert_variance(seeded.model.module.state_dict(), jhp), 7)
    _save_jax(php["work_dir"], params, "variance")
    infer = DiffSingerVarianceInfer(php, device="cpu")
    jm = JaxVariance(jhp, vocab_size=vocab)
    inp = variance_inputs(31)
    b, t = inp["mel2ph"].shape
    shapes = infer.noise_shapes(b, t)
    rng = np.random.default_rng(32)
    noises = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    names = ("tokens", "midi", "ph2word", "base_pitch")
    kw = dict(ph_dur=inp["ph_dur"], mel2ph=inp["mel2ph"], pitch=inp["pitch"])
    want = jax.jit(lambda p, a, k, n: jm.forward_infer(
        p, jax.random.PRNGKey(0), *a, noise_pitch=n["noise_pitch"],
        noise_variances=n["noise_variances"], **k))(
        params, [jnp.asarray(inp[k]) for k in names], {k: jnp.asarray(v) for k, v in kw.items()},
        {k: jnp.asarray(v) for k, v in noises.items()})
    got = infer.model.forward_infer(
        *(torch.from_numpy(inp[k]) for k in names),
        **{k: torch.from_numpy(v) for k, v in kw.items()},
        noise_pitch=torch.from_numpy(noises["noise_pitch"]),
        noise_variances=torch.from_numpy(noises["noise_variances"]))
    assert np.abs(got[1].numpy() - np.asarray(want[1])).max() <= 1e-4
    assert set(got[2]) == set(want[2]) and got[2]
    for k in got[2]:
        assert np.abs(got[2][k].numpy() - np.asarray(want[2][k])).max() <= 1e-4, k


def test_summary_logger_writes_tensorboard_events(tmp_path):
    """Scalars, a figure and audio read back through tensorboard's
    EventAccumulator; the scalars in metrics.jsonl too; a logger of a rank
    other than 0 writes nothing."""
    import json

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from diffsinger_tpu_torch.training.base_task import SummaryLogger

    log = SummaryLogger(tmp_path / "tb")
    for step, v in ((1, 0.5), (2, 0.25), (3, 0.125)):
        log.add_scalar("training/total_loss", v, step)
    log.add_scalar("validation/mel_loss", 2.0, 3)

    def figure():
        fig = plt.figure()
        plt.plot([0, 1], [1, 0])
        return fig

    log.add_figure("diffmel_0", figure, 3)
    log.add_audio("diff_0", np.sin(np.linspace(0, 100, 4410)).astype(np.float32), 3, 44100)
    log.flush()
    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    tags = acc.Tags()
    assert set(tags["scalars"]) == {"training/total_loss", "validation/mel_loss"}
    assert [(e.step, e.value) for e in acc.Scalars("training/total_loss")] == [
        (1, 0.5), (2, 0.25), (3, 0.125)]
    assert tags["images"] == ["diffmel_0"] and tags["audio"] == ["diff_0"]
    lines = [json.loads(x) for x in (tmp_path / "tb" / "metrics.jsonl").read_text().splitlines()]
    assert {"step": 3, "validation/mel_loss": 2.0} in lines and len(lines) == 4
    quiet = SummaryLogger(tmp_path / "rank1_inactive", active=False)
    quiet.add_scalar("x", 1.0, 1)
    quiet.flush()
    assert not (tmp_path / "rank1_inactive").exists()
