"""The port's training runtime against the JAX package's, on the CPU: the LR
of every scheduler class at each step, optimizer updates, gradient
accumulation and freezing, the batch sampler and the collater over an HDF5
store written by the JAX package's IndexedDatasetBuilder, and the loop itself (a few steps
through ``cli.train``, checkpoints, rotation, resume), whose checkpoint both
packages then load for the same ``forward_infer``.
"""

import pickle
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from diffsinger_tpu.data.batch_sampler import DsBatchSampler as JaxSampler
from diffsinger_tpu.data.dataset import AcousticDataset as JaxDataset
from diffsinger_tpu.data.indexed_datasets import IndexedDatasetBuilder
from diffsinger_tpu.training.schedules import build_lr_schedule
from diffsinger_tpu.training.train_state import build_optimizer as jax_build_optimizer
from diffsinger_tpu_torch.data.batch_sampler import DsBatchSampler
from diffsinger_tpu_torch.data.dataset import AcousticDataset
from diffsinger_tpu_torch.training.base_task import BaseTask, bucket_batch_size, pad_batch_rows
from diffsinger_tpu_torch.training.schedules import build_lr_scheduler
from diffsinger_tpu_torch.training.train_state import (
    build_optimizer, filter_finetune_params, freeze_params,
)
from tests.torch_parity import DICT, MELS, REPO

# ------------------------------------------------------------------ schedules

SCHEDULES = {
    "StepLR": {"scheduler_cls": "torch.optim.lr_scheduler.StepLR", "step_size": 7, "gamma": 0.5},
    "default": {"step_size": 10, "gamma": 0.75},
    "ExponentialLR": {"scheduler_cls": "torch.optim.lr_scheduler.ExponentialLR", "gamma": 0.97},
    "ConstantLR": {"scheduler_cls": "torch.optim.lr_scheduler.ConstantLR", "factor": 0.25,
                   "total_iters": 9},
    "LinearLR": {"scheduler_cls": "torch.optim.lr_scheduler.LinearLR", "start_factor": 0.1,
                 "end_factor": 0.9, "total_iters": 11},
    "MultiStepLR": {"scheduler_cls": "torch.optim.lr_scheduler.MultiStepLR",
                    "milestones": [10, 20, 45], "gamma": 0.3},
    "CosineAnnealingLR": {"scheduler_cls": "torch.optim.lr_scheduler.CosineAnnealingLR",
                          "T_max": 50, "eta_min": 0.01},
    "RSQRTSchedule": {"scheduler_cls": "modules.RSQRTSchedule", "warmup_updates": 12},
    "WarmupCosineSchedule": {"scheduler_cls": "utils.WarmupCosineSchedule", "warmup_steps": 8,
                             "t_total": 50, "eta_min": 0.05},
    "SequentialLR": {"scheduler_cls": "torch.optim.lr_scheduler.SequentialLR", "schedulers": [
        {"cls": "torch.optim.lr_scheduler.ExponentialLR", "gamma": 0.5},
        {"cls": "torch.optim.lr_scheduler.LinearLR"},
        {"cls": "torch.optim.lr_scheduler.MultiStepLR", "milestones": [10, 20]}],
        "milestones": [10, 20]},
    "ChainedScheduler": {"scheduler_cls": "torch.optim.lr_scheduler.ChainedScheduler",
                         "schedulers": [
                             {"cls": "torch.optim.lr_scheduler.ConstantLR", "factor": 0.5,
                              "total_iters": 4},
                             {"cls": "torch.optim.lr_scheduler.ExponentialLR", "gamma": 0.98}]},
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_lr_at_every_step_matches_build_lr_schedule(name):
    """60 optimizer updates: the LR the port's scheduler gives update k is the
    JAX schedule's value at k (1e-9 relative)."""
    args, base = SCHEDULES[name], 0.8
    want = build_lr_schedule(dict(args), base_lr=base, hidden_size=256)
    opt = torch.optim.SGD([torch.nn.Parameter(torch.zeros(1))], lr=base)
    sched = build_lr_scheduler(opt, dict(args), hidden_size=256)
    for k in range(60):
        assert opt.param_groups[0]["lr"] == pytest.approx(want(k), rel=1e-9, abs=1e-12), k
        opt.step()
        sched.step()


# ------------------------------------------------------------------ optimizers

OPTIMIZERS = {
    "AdamW": {"optimizer_cls": "torch.optim.AdamW", "lr": 0.01, "weight_decay": 0.05},
    "Adam": {"optimizer_cls": "torch.optim.Adam", "lr": 0.02, "beta1": 0.8, "beta2": 0.9,
             "weight_decay": 0.01},
    "SGD": {"optimizer_cls": "torch.optim.SGD", "lr": 0.05, "momentum": 0.9, "nesterov": True},
    "Adagrad": {"optimizer_cls": "torch.optim.Adagrad", "lr": 0.03, "weight_decay": 0.01},
}


class _LinearTask(BaseTask):
    """A BaseTask over one Linear layer and a squared error, for the update
    machinery alone."""

    def build_model(self):
        torch.manual_seed(0)
        return types.SimpleNamespace(module=torch.nn.Linear(5, 3))

    def build_loss_fn(self, model):
        def loss_fn(batch, **_):
            loss = (model.module(batch["x"]) - batch["y"]).square().mean()
            return loss, {"mse": loss}

        return loss_fn


def _linear_task(tmp_path, **hp):
    hp = dict(dict(work_dir=str(tmp_path), dictionary=str(DICT),
                   lr_scheduler_args={"step_size": 2, "gamma": 0.5}, clip_grad_norm=1,
                   pl_trainer_precision="32-true"), **hp)
    task = _LinearTask(hp, device="cpu")
    task.configure_optimizer()
    return task


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_updates_match_the_jax_optimizer(tmp_path, name, accum):
    """Three updates of each optimizer through the port's task (losses
    averaged over ``accum`` micro-batches, the gradient clipped to norm 1,
    StepLR) against the JAX build_optimizer (optax, MultiSteps) on the same
    gradients; 1e-5."""
    hp = dict(optimizer_args=OPTIMIZERS[name], accumulate_grad_batches=accum)
    task = _linear_task(tmp_path, **hp)
    lin = task.module
    params = {"w": jnp.asarray(lin.weight.detach().numpy()), "b": jnp.asarray(lin.bias.detach().numpy())}
    tx, _ = jax_build_optimizer(dict(hp, lr_scheduler_args=task.hp["lr_scheduler_args"],
                                     clip_grad_norm=1))
    state = tx.init(params)
    rng = np.random.default_rng(0)

    def jloss(p, x, y):
        return jnp.mean(jnp.square(x @ p["w"].T + p["b"] - y))

    for i in range(3 * accum):
        x = rng.standard_normal((4, 5)).astype(np.float32) * 3
        y = rng.standard_normal((4, 3)).astype(np.float32)
        updates, state = tx.update(jax.grad(jloss)(params, x, y), state, params)
        params = optax.apply_updates(params, updates)
        task.train_step({"x": torch.from_numpy(x), "y": torch.from_numpy(y)})
        if (i + 1) % accum == 0:
            task.apply_update()
    assert task.global_step == 3
    np.testing.assert_allclose(lin.weight.detach().numpy(), np.asarray(params["w"]), atol=1e-5)
    np.testing.assert_allclose(lin.bias.detach().numpy(), np.asarray(params["b"]), atol=1e-5)


def test_freezing_keeps_parameters_out_of_the_update():
    """Reference prefixes freeze by the port's names (the 'model.' wrapper and
    the legacy token-embedding alias mapped); a frozen parameter has
    requires_grad False and an AdamW update with weight decay leaves it as it was."""
    from diffsinger_tpu_torch.models.toplevel import AcousticModule
    from tests.torch_parity import HP, VOCAB

    module = AcousticModule(HP, VOCAB, MELS)
    frozen = freeze_params(module, ["model.fs2.encoder", "model.fs2.encoder.embed_tokens"])
    assert frozen and all(n.startswith(("fs2.encoder.", "fs2.txt_embed")) for n in frozen)
    assert "fs2.txt_embed.weight" in frozen  # the legacy alias names the token embedding
    assert module.fs2.pitch_embed.weight.requires_grad
    before = {k: v.clone() for k, v in module.state_dict().items()}
    trainable = [p for p in module.parameters() if p.requires_grad]
    assert len(trainable) == len(list(module.parameters())) - len(frozen)
    opt = build_optimizer(trainable, {"optimizer_args": {"lr": 0.1, "weight_decay": 0.1}})
    for p in trainable:
        p.grad = torch.ones_like(p)
    opt.step()
    after = module.state_dict()
    assert all(torch.equal(after[n], before[n]) for n in frozen)
    assert not torch.equal(after["fs2.pitch_embed.weight"], before["fs2.pitch_embed.weight"])


def test_filter_finetune_params():
    template = {"fs2.txt_embed.weight": torch.zeros(3, 2), "fs2.pitch_embed.weight": torch.zeros(2, 1),
                "aux.w": torch.zeros(4)}
    loaded = {"fs2.txt_embed.weight": torch.ones(3, 2), "fs2.pitch_embed.weight": torch.ones(2, 1),
              "aux.w": torch.ones(5), "gone.w": torch.ones(1)}
    out = filter_finetune_params(template, loaded, ["model.fs2.encoder.embed_tokens"],
                                 strict_shapes=False)
    assert out["fs2.txt_embed.weight"].sum() == 0 and out["fs2.pitch_embed.weight"].sum() == 2
    assert out["aux.w"].sum() == 0 and "gone.w" not in out
    with pytest.raises(ValueError):
        filter_finetune_params(template, loaded, [], strict_shapes=True)


# ------------------------------------------------------------------ data

def make_binary(path, n_train=14, n_valid=2, vocab=40, seed=0):
    """A binarized acoustic store written by the JAX package's writer: items
    with tokens, mel2ph, mel, f0, energy and a key shift; ``.meta`` with the
    lengths of each attribute."""
    path.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    for prefix, n in (("train", n_train), ("valid", n_valid)):
        writer = IndexedDatasetBuilder(path, prefix)
        meta = {"lengths": [], "mel": [], "mel2ph": [], "tokens": []}
        for _ in range(n):
            n_tok, t = int(rng.integers(4, 12)), int(rng.integers(30, 150))
            dur = rng.multinomial(t - n_tok, np.ones(n_tok) / n_tok) + 1
            item = dict(tokens=rng.integers(1, vocab, n_tok), mel2ph=np.repeat(np.arange(1, n_tok + 1), dur),
                        mel=rng.uniform(-10, -1, (t, MELS)).astype(np.float32),
                        f0=rng.uniform(150, 400, t).astype(np.float32),
                        energy=rng.uniform(-60, -20, t).astype(np.float32),
                        key_shift=float(rng.uniform(-3, 3)), spk_id=int(rng.integers(0, 2)))
            writer.add_item(item)
            for k in ("mel", "mel2ph", "tokens"):
                meta[k].append(len(item[k]))
            meta["lengths"].append(t)
        writer.finalize()
        with open(path / f"{prefix}.meta", "wb") as f:
            pickle.dump(meta, f)
    return path


@pytest.mark.parametrize("accum", [1, 2])
def test_sampler_and_collater_match_jax(tmp_path, accum):
    """Batches of three epochs, and every collated array, equal the JAX ones."""
    d = make_binary(tmp_path / "binary")
    hp = dict(use_energy_embed=True, use_key_shift_embed=True, use_spk_id=True,
              dataset_size_key="lengths")
    jds, pds = JaxDataset(d, hp, "train"), AcousticDataset(d, hp, "train")
    assert list(pds.sizes) == list(jds.sizes)
    for epoch in range(3):
        kw = dict(max_batch_frames=400, max_batch_size=4, required_batch_count_multiple=accum,
                  seed=1234)
        js = JaxSampler(jds.sizes, shuffle_sample=True, shuffle_batch=True, **kw)
        ps = DsBatchSampler(pds.sizes, shuffle_sample=True, **kw)
        js.set_epoch(epoch)
        ps.set_epoch(epoch)
        jb, pb = list(js), list(ps)
        assert pb == jb and len(pb) % accum == 0 and len(pb) > 3
        for indices in pb:
            want = jds.collater([jds[i] for i in indices])
            got = pds.collater([pds[i] for i in indices])
            assert sorted(got) == sorted(want)
            for k, v in want.items():
                np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_pad_batch_rows():
    batch = {"tokens": np.ones((3, 4), np.int32), "mel2ph": np.ones((3, 8), np.int32),
             "f0": np.arange(24, dtype=np.float32).reshape(3, 8)}
    out = pad_batch_rows(dict(batch), 3, bucket_batch_size(3))
    assert out["tokens"].shape == (4, 4) and not out["tokens"][3].any()
    assert not out["mel2ph"][3].any() and np.array_equal(out["f0"][3], batch["f0"][2])
    assert bucket_batch_size(48) == 64 and bucket_batch_size(64) == 64


# ------------------------------------------------------------------ the loop

TINY = dict(hidden_size=32, enc_layers=2, audio_num_mel_bins=MELS, sampling_steps=2,
            backbone_args=dict(num_channels=32, num_layers=2, kernel_size=31, dropout_rate=0.0,
                               strong_cond=True),
            shallow_diffusion_args=dict(
                train_aux_decoder=True, train_diffusion=True, val_gt_start=False,
                aux_decoder_arch="convnext", aux_decoder_grad=0.1,
                aux_decoder_args=dict(num_channels=16, num_layers=1, kernel_size=7,
                                      dropout_rate=0.1)),
            max_batch_frames=300, log_interval=2, val_check_interval=3, num_ckpt_keep=2,
            permanent_ckpt_start=3, permanent_ckpt_interval=3, num_valid_plots=1,
            val_with_vocoder=False, use_energy_embed=True, use_key_shift_embed=True)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """cli.train on the CPU: 4 updates, then a resume to 7."""
    import yaml

    from diffsinger_tpu_torch.cli import train as cli_train

    tmp = tmp_path_factory.mktemp("loop")
    make_binary(tmp / "binary", n_train=8)
    cfg = dict(TINY, base_config=[str(REPO / "configs" / "acoustic.yaml")],
               binary_data_dir=str(tmp / "binary"), dictionary=str(DICT))
    (tmp / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    argv = ["--config", str(tmp / "cfg.yaml"), "--exp_name", "exp", "--ckpt_root",
            str(tmp / "ckpt"), "--device", "cpu"]
    cli_train.main(argv + ["--max_steps", "4"])
    first = sorted(p.name for p in (tmp / "ckpt" / "exp").glob("*.ckpt"))
    cli_train.main(argv + ["--max_steps", "7"])
    return tmp, argv, first


def test_loop_saves_rotates_and_resumes(trained):
    from diffsinger_tpu_torch.utils.ckpt import load_checkpoint

    tmp, _, first = trained
    work = tmp / "ckpt" / "exp"
    assert first == ["model_ckpt_steps_3.ckpt", "model_ckpt_steps_4.ckpt"]
    # step 3 is permanent (start 3, interval 3); of the others the newest two stay
    assert sorted(p.name for p in work.glob("*.ckpt")) == [
        "model_ckpt_steps_3.ckpt", "model_ckpt_steps_6.ckpt", "model_ckpt_steps_7.ckpt"]
    blob = load_checkpoint(work / "model_ckpt_steps_7.ckpt", category="acoustic")
    assert blob["global_step"] == 7 and blob["epoch"] >= 1
    assert all(k.startswith("model.") for k in blob["state_dict"])
    adam = blob["optimizer_states"][0]["state"]
    assert {int(s["step"]) for s in adam.values()} == {7}  # moments carried across the resume
    assert blob["lr_schedulers"][0]["last_epoch"] == 7
    log = (work / "lightning_logs" / "tb" / "metrics.jsonl").read_text().splitlines()
    assert any("validation/mel_loss" in line for line in log)
    assert any("training/grad_norm" in line for line in log)
    assert (work / "config.yaml").exists()


def test_resume_with_another_optimizer_needs_the_reset_flag(trained):
    """A copy of the experiment resumed under SGD: refused, then allowed by
    allow_optimizer_state_reset (the weights and the step carry over)."""
    import shutil

    import yaml

    from diffsinger_tpu_torch.cli import train as cli_train
    from diffsinger_tpu_torch.utils.ckpt import load_checkpoint

    tmp, _, _ = trained
    shutil.copytree(tmp / "ckpt" / "exp", tmp / "ckpt" / "exp_sgd")
    cfg = yaml.safe_load((tmp / "cfg.yaml").read_text())
    cfg["optimizer_args"] = {"optimizer_cls": "torch.optim.SGD", "lr": 0.01}
    argv = ["--config", str(tmp / "sgd.yaml"), "--exp_name", "exp_sgd", "--ckpt_root",
            str(tmp / "ckpt"), "--device", "cpu", "--reset", "--max_steps", "8"]
    (tmp / "sgd.yaml").write_text(yaml.safe_dump(cfg))
    with pytest.raises(RuntimeError, match="allow_optimizer_state_reset"):
        cli_train.main(argv)
    (tmp / "sgd.yaml").write_text(yaml.safe_dump(dict(cfg, allow_optimizer_state_reset=True)))
    cli_train.main(argv)
    blob = load_checkpoint(tmp / "ckpt" / "exp_sgd" / "model_ckpt_steps_8.ckpt")
    assert blob["global_step"] == 8 and blob["optimizer_cls"] == "SGD"


def test_train_cli_raises_without_a_card_unless_the_cpu_is_asked_for(trained, monkeypatch):
    from diffsinger_tpu_torch.cli import train as cli_train

    _, argv, _ = trained
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli_train.main([a for a in argv if a not in ("--device", "cpu")] + ["--max_steps", "7"])


def test_saved_checkpoint_gives_the_same_forward_infer_in_both_packages(trained):
    """The trainer's .ckpt through the port's strict loader and through the
    JAX package's torch-checkpoint converter: forward_infer on the same
    inputs and noise agrees to 1e-4."""
    from diffsinger_tpu.config import load_config as jax_load_config
    from diffsinger_tpu.models.toplevel import DiffSingerAcoustic as JaxAcoustic
    from diffsinger_tpu.utils.ckpt import load_params_for_inference
    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic
    from diffsinger_tpu_torch.utils.ckpt import load_state_dict_for_inference
    from diffsinger_tpu_torch.utils.text import load_phoneme_dictionary
    from tests.torch_parity import acoustic_inputs, jax_kwargs, port_kwargs

    tmp, _, _ = trained
    hp = load_config(exp_name="exp", infer=True, ckpt_root=tmp / "ckpt")
    jhp = dict(jax_load_config(exp_name="exp", infer=True, ckpt_root=tmp / "ckpt"))
    vocab = len(load_phoneme_dictionary(hp))
    port = DiffSingerAcoustic(hp, vocab_size=vocab, out_dims=MELS, device="cpu")
    info = load_state_dict_for_inference(port.module, hp["work_dir"], category="acoustic")
    assert info["global_step"] == 7
    jm = JaxAcoustic(jhp, vocab_size=vocab, out_dims=MELS)
    template = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0)))
    params, meta = load_params_for_inference(hp["work_dir"], template, category="acoustic",
                                             hparams=jhp)
    inp = acoustic_inputs(seed=3, t_mel=40)
    noise = np.random.default_rng(4).standard_normal((2, 40, MELS)).astype(np.float32)
    keys = ("tokens", "mel2ph", "f0")
    want = jax.jit(lambda p, a, n, kw: jm.forward_infer(
        p, jax.random.PRNGKey(0), *a, noise=n, **kw).diff_out)(
        params, [jnp.asarray(inp[k]) for k in keys], jnp.asarray(noise), jax_kwargs(inp))
    got = port.forward_infer(*(torch.from_numpy(inp[k]) for k in keys),
                             noise=torch.from_numpy(noise), **port_kwargs(inp)).diff_out
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4
