"""Training over ranks in the PyTorch port against the JAX package's global
batch, on the CPU with gloo.

The JAX trainer stitches the processes' rows into one global batch and takes
one masked mean over it, so N ranks of B rows update as one process on N * B
rows. Here: the sampler's rank assignment and the pad targets against the
JAX package's; the first step of two ranks through the trainer's DDP path
(losses averaged over the ranks within 1e-6 relative of the JAX loss on the
stitched batch, whose ranks hold different numbers of valid frames; the
all-reduced gradients equal on both ranks and within 1e-4 of the largest
entry of ``jax.grad`` with the same draws), for both families; dropout masks
that differ by rank, draws that do not; ``cli.train`` on two ranks against
one process on the stitched rows (parameters within 1e-5 after 3 steps with
accumulation 2), rank 0 alone writing, a resume on two ranks; an epoch whose
ranks hold different numbers of batches; and a dead rank. Every rank runs in
a process of its own (``spawn``, a ``file://`` rendezvous in the test's
folder), joined with a deadline.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsinger_tpu.data.batch_sampler import DsBatchSampler as JaxSampler
from diffsinger_tpu.data.dataset import AcousticDataset as JaxAcousticDataset
from diffsinger_tpu.data.dataset import VarianceDataset as JaxVarianceDataset
from diffsinger_tpu.models.toplevel import DiffSingerAcoustic as JaxAcoustic
from diffsinger_tpu.models.toplevel import DiffSingerVariance as JaxVariance
from diffsinger_tpu.training.acoustic_task import make_acoustic_loss_fn as jax_acoustic_loss
from diffsinger_tpu.training.variance_task import make_variance_loss_fn as jax_variance_loss
from diffsinger_tpu_torch.config import load_config
from diffsinger_tpu_torch.data.batch_sampler import DsBatchSampler
from diffsinger_tpu_torch.data.dataset import AcousticDataset, VarianceDataset
from diffsinger_tpu_torch.parallel import dist
from diffsinger_tpu_torch.parallel.mesh import local_devices
from diffsinger_tpu_torch.training import base_task
from diffsinger_tpu_torch.training.base_task import pad_batch_rows
from diffsinger_tpu_torch.utils.convert import (
    acoustic_state_dict_from_flax, variance_state_dict_from_flax)
from tests import torch_dist_workers as workers
from tests.test_torch_train import HP_NO_DROP
from tests.test_torch_train_loop import TINY, make_binary
from tests.test_torch_train_variance import TRAIN_CASES as VAR_CASES
from tests.test_torch_train_variance import VAR_HP_NO_DROP, _jax_draws, seeded_pair
from tests.test_torch_train_variance_loop import make_variance_binary
from tests.test_torch_variance import variance_inputs
from tests.torch_parity import DICT, MELS, REPO, VOCAB, acoustic_inputs, randomize, to_numpy

SPAWN_TIMEOUT = 120  # seconds for a group of ranks to start, run and end


def run_ranks(fn, tmp_path, *args, world=2, timeout=SPAWN_TIMEOUT):
    init = tmp_path / f"rendezvous_{fn.__name__}_{len(list(tmp_path.glob('rendezvous_*')))}"
    dist.spawn(fn, world, (world, f"file://{init}", *args), timeout=timeout)


# ------------------------------------------------------------------ sampler, pad targets

@pytest.mark.parametrize("replicas", [1, 2, 4])
def test_sampler_matches_jax_for_every_rank(replicas):
    """Every rank's batches of four epochs, with and without a multiple of
    the accumulation, equal the JAX sampler's; all_rank_batches gives every
    rank's list at once."""
    sizes = np.random.default_rng(replicas).integers(30, 400, 61)
    for accum in (1, 3):
        for epoch in range(4):
            kw = dict(max_batch_frames=900, max_batch_size=5, num_replicas=replicas,
                      required_batch_count_multiple=accum, shuffle_sample=True,
                      shuffle_batch=True, seed=11)
            want = []
            for rank in range(replicas):
                js, ps = JaxSampler(sizes, rank=rank, **kw), DsBatchSampler(sizes, rank=rank, **kw)
                js.set_epoch(epoch)
                ps.set_epoch(epoch)
                assert list(ps) == list(js)
                want.append(list(js))
            assert ps.all_rank_batches() == want
            assert len({len(b) for b in want}) == 1 and len(want[0]) % accum == 0


def test_pad_targets_match_jax(tmp_path):
    """The pad targets of index sets of both datasets, from their .meta."""
    a = make_binary(tmp_path / "acoustic")
    v = make_variance_binary(tmp_path / "variance")
    steps = {"t_mel": 128, "t_txt": 16, "t_note": 16}
    rng = np.random.default_rng(0)
    for (pd, jd), path in (((AcousticDataset, JaxAcousticDataset), a),
                           ((VarianceDataset, JaxVarianceDataset), v)):
        hp = {"dataset_size_key": "lengths", "predict_dur": True, "predict_pitch": True}
        port, jax_ds = pd(path, hp, "train"), jd(path, hp, "train")
        assert port.PAD_AXES == jax_ds.PAD_AXES
        for _ in range(5):
            idx = rng.choice(len(port), 4, replace=False).tolist()
            got = port.pad_targets(idx, port.PAD_AXES, steps)
            assert got == jax_ds.pad_targets(idx, jax_ds.PAD_AXES, steps) and "t_mel" in got


def test_acoustic_collater_takes_pad_targets(tmp_path):
    hp = {"dataset_size_key": "lengths"}
    ds = AcousticDataset(make_binary(tmp_path / "a"), hp, "train")
    jds = JaxAcousticDataset(tmp_path / "a", hp, "train")
    pad_to = {"t_mel": 384, "t_txt": 32}
    got = ds.collater([ds[0], ds[1]], pad_to=pad_to)
    want = jds.collater([jds[0], jds[1]], pad_to=pad_to)
    assert got["mel"].shape[1] == 384 and got["tokens"].shape[1] == 32
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("asked,want", [
    ("auto", [0, 1, 2, 3]), (-1, [0, 1, 2, 3]), (None, [0, 1, 2, 3]), (2, [0, 1]),
    ([1, 3], [1, 3]), ((2,), [2]), ([4], None), (0, None)])
def test_local_devices_picks_the_cards(asked, want, monkeypatch):
    """``pl_trainer_devices`` as the JAX trainer reads it, on 4 visible cards;
    a card that is not there, or none, raises."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    if want is None:
        with pytest.raises(ValueError):
            local_devices(asked)
        return
    assert local_devices(asked) == [torch.device("cuda", i) for i in want]
    assert local_devices(asked, device_type="cpu") == [torch.device("cpu")]


def test_epoch_stops_at_the_positions_every_rank_has(monkeypatch):
    """A rank with more batches than its peers stops with them (it would wait
    in DDP's all-reduce for ever): the trainer's batches of an epoch whose
    ranks hold 3 and 2 batches."""
    class Stub:
        sizes = [40] * 6
        metadata = {"mel2ph": [40] * 6, "tokens": [5] * 6}
        frame_bucket, token_bucket = 128, 16
        PAD_AXES = AcousticDataset.PAD_AXES
        pad_targets = AcousticDataset.pad_targets

        def __getitem__(self, i):
            return i

        def collater(self, items, pad_to=None):
            return {"size": len(items), "indices": np.asarray(items),
                    "tokens": np.ones((len(items), pad_to["t_txt"]), np.int32)}

    peers = [[[0, 1], [2], [3]], [[4], [5]]]
    monkeypatch.setattr(DsBatchSampler, "all_rank_batches", lambda self: peers)
    assert base_task.rank_positions(peers) == 2
    for rank in (0, 1):
        task = base_task.BaseTask.__new__(base_task.BaseTask)
        task.hp, task.accum, task.rank, task.world_size = {}, 1, rank, 2
        got = list(task.epoch_batches(Stub(), 0))
        assert [(b["tokens"].shape, n, row0) for b, n, row0 in got] == [
            ((2, 16), 4, 2 * rank), ((1, 16), 2, rank)]


# ------------------------------------------------------------------ the first step

def _acoustic_case():
    """(family, hp, port state dict, global batch, JAX losses and gradients
    as the port's state dict, the injected draws)."""
    hp = dict(load_config(REPO / "configs" / "acoustic.yaml"), **HP_NO_DROP)
    hp.update(dictionary=str(DICT), pl_trainer_precision="32-true",
              optimizer_args=dict(hp["optimizer_args"], lr=1e-3))
    jm = JaxAcoustic(hp, vocab_size=VOCAB, out_dims=MELS)
    params = randomize(jax.jit(jm.init)(jax.random.PRNGKey(3)), 103)
    inp = acoustic_inputs(seed=12, b=4, t_mel=40)
    inp["mel2ph"][3] = 0  # rank 1: a short row and a row without a valid frame
    mel = np.random.default_rng(13).uniform(-11, -1, (4, 40, MELS)).astype(np.float32)
    batch = dict(tokens=inp["tokens"], mel2ph=inp["mel2ph"], f0=inp["f0"], mel=mel,
                 energy=inp["energy"], key_shift=inp["key_shift"])
    rng = jax.random.PRNGKey(14)
    (_, jlosses), jgrads = jax.jit(jax.value_and_grad(jax_acoustic_loss(jm), has_aux=True))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    _, rng_t, rng_noise = jax.random.split(rng, 3)
    t = jm.t_start + (1.0 - jm.t_start) * jax.random.uniform(rng_t, (4,))
    noise = jax.random.normal(rng_noise, mel.shape, jnp.float32)
    draws = {"t": torch.from_numpy(np.array(t)), "noise": torch.from_numpy(np.array(noise))}
    return ("acoustic", hp, acoustic_state_dict_from_flax(to_numpy(params), hp), batch,
            {k: float(v) for k, v in jlosses.items()},
            acoustic_state_dict_from_flax(to_numpy(jgrads), hp), draws)


def _variance_case():
    hp = {**load_config(REPO / "configs" / "variance.yaml"), **VAR_HP_NO_DROP,
          **VAR_CASES["melody_glide"]}
    hp.update(dictionary=str(DICT), pl_trainer_precision="32-true")
    jm = JaxVariance(hp, vocab_size=VOCAB)
    params, port = seeded_pair(hp, 21)
    inp = variance_inputs(22, b=4)
    rng = np.random.default_rng(22)
    batch = dict(tokens=inp["tokens"], ph_dur=inp["ph_dur"], mel2ph=inp["mel2ph"],
                 base_pitch=inp["base_pitch"], pitch=inp["pitch"], uv=rng.random((4, 48)) < 0.1,
                 note_midi=inp["note_midi"], note_rest=inp["note_rest"],
                 note_dur=inp["note_dur"], mel2note=inp["mel2note"], note_glide=inp["note_glide"],
                 midi=inp["midi"], ph2word=inp["ph2word"])
    var_list = [v for v in ("energy", "breathiness", "voicing", "tension") if hp.get(f"predict_{v}")]
    for v in var_list:
        batch[v] = inp["variances"].get(v, rng.uniform(-70, -20, (4, 48)).astype(np.float32))
    batch = pad_batch_rows({k: v[:3] for k, v in batch.items()}, 3, 4)
    b, t = batch["mel2ph"].shape

    def run(params, batch, rng):
        return (jax.value_and_grad(jax_variance_loss(jm), has_aux=True)(params, batch, rng),
                _jax_draws(jm, hp, var_list, rng, b, t))

    ((_, jlosses), jgrads), draws = jax.jit(run)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(23))
    draws = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), draws)
    return ("variance", hp, port.module.state_dict(), batch,
            {k: float(v) for k, v in jlosses.items()},
            variance_state_dict_from_flax(to_numpy(jgrads), hp), draws)


@pytest.mark.parametrize("family", ["acoustic", "variance"])
def test_first_step_over_two_ranks_is_jax_grad_of_the_global_batch(family, tmp_path):
    """Two ranks of 2 rows each (rank 1 with fewer valid frames, one row
    without any): the losses averaged over the ranks within 1e-6 relative of
    the JAX loss on the 4 stitched rows; each rank's all-reduced gradients
    equal the other's and are within 1e-4 of the largest entry of jax.grad,
    parameter by parameter. Micro-batch 5's draws, each rank's rows, join to
    the one-process draw at the global shape; its dropout masks differ by
    rank."""
    name, hp, state, batch, jlosses, jgrads, draws = (
        _acoustic_case() if family == "acoustic" else _variance_case())
    hp = dict(hp, work_dir=str(tmp_path / "work"), seed=5)
    blob = dict(family=name, hp=hp, vocab=VOCAB, state_dict=state, batch=batch, draws=draws,
                rows=2)
    torch.save(blob, tmp_path / "blob.pt")
    run_ranks(workers.first_step, tmp_path, str(tmp_path / "blob.pt"), str(tmp_path))
    r0, r1 = (torch.load(tmp_path / f"step_rank{r}.pt", weights_only=False) for r in (0, 1))
    assert r0["losses"] == r1["losses"]
    for k, want in jlosses.items():
        np.testing.assert_allclose(r0["losses"][k], want, rtol=1e-6, err_msg=k)
    assert set(jgrads) == set(r0["grads"])
    for n, w in jgrads.items():
        assert torch.equal(r0["grads"][n], r1["grads"][n]), n
        w = w.numpy()
        assert np.abs(r0["grads"][n].numpy() - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-6), n
    assert not torch.equal(r0["mask"], r1["mask"])
    one = workers._task(dict(blob, hp=dict(hp, work_dir=str(tmp_path / "one"))))
    tensors = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = one.micro_draws(tensors, 5, 4, 0)

    def joined(a, b):
        if isinstance(a, dict):
            return {k: joined(a[k], b[k]) for k in a}
        return torch.cat([a, b])

    got = joined(r0["micro_draws"], r1["micro_draws"])
    flat_want, flat_got = jax.tree.leaves(want), jax.tree.leaves(got)
    assert len(flat_want) == len(flat_got) > 0
    assert all(torch.equal(a, b) for a, b in zip(flat_got, flat_want))


# ------------------------------------------------------------------ cli.train over two ranks

STEPS = 3
DIST_TINY = dict(TINY, dropout=0.0, accumulate_grad_batches=2, max_batch_frames=260,
                 max_batch_size=3, val_check_interval=100, log_interval=1, num_ckpt_keep=5,
                 permanent_ckpt_interval=-1, seed=7, pl_trainer_precision="32-true",
                 shallow_diffusion_args=dict(TINY["shallow_diffusion_args"], aux_decoder_args=dict(
                     TINY["shallow_diffusion_args"]["aux_decoder_args"], dropout_rate=0.0)))


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """cli.train on two gloo ranks: 3 updates, then a resume to 4."""
    import yaml

    tmp = tmp_path_factory.mktemp("dist_loop")
    make_binary(tmp / "binary", n_train=11)
    cfg = dict(DIST_TINY, base_config=[str(REPO / "configs" / "acoustic.yaml")],
               binary_data_dir=str(tmp / "binary"), dictionary=str(DICT))
    (tmp / "cfg.yaml").write_text(yaml.safe_dump(cfg))
    argv = ["--config", str(tmp / "cfg.yaml"), "--exp_name", "exp", "--ckpt_root",
            str(tmp / "ckpt"), "--device", "cpu"]
    (tmp / "first").mkdir()
    run_ranks(workers.cli_train, tmp, argv + ["--max_steps", str(STEPS)], str(tmp / "first"))
    first = {p.name: p.read_bytes() for p in (tmp / "ckpt" / "exp").glob("*.ckpt")}
    log = (tmp / "ckpt" / "exp" / "lightning_logs" / "tb" / "metrics.jsonl").read_text()
    (tmp / "resumed").mkdir()
    run_ranks(workers.cli_train, tmp, argv + ["--max_steps", str(STEPS + 1)], str(tmp / "resumed"))
    return tmp, first, log


def _one_process_reference(tmp):
    """The 3 updates of one process on the stitched rows of both ranks, with
    the same draws (``chip_smoke.stitched_steps``, which chip_smoke.py's
    ``[train_dist]`` runs on the card)."""
    from chip_smoke import stitched_steps
    from diffsinger_tpu_torch.training.acoustic_task import AcousticTask

    hp = load_config(exp_name="exp", ckpt_root=tmp / "ckpt", infer=True)
    hp["work_dir"] = str(tmp / "reference")
    torch.manual_seed(hp["seed"])  # as cli.train seeds before it builds the task
    ref = AcousticTask(hp, device="cpu")
    ref.configure_optimizer()
    train_ds, _ = ref.build_datasets()
    stitched_steps(ref, train_ds, 2, STEPS)
    return ref.module.state_dict()


def test_two_ranks_update_as_one_process_on_the_stitched_rows(two_ranks):
    """After 3 updates (6 micro-batches, ``no_sync`` on every other one) the
    ranks' parameters are equal, and within 1e-5 of one process on the
    stitched rows; the corpus gives an odd number of batches an epoch, so one
    rank repeats a batch of its own to keep the count."""
    tmp, _, _ = two_ranks
    hp = load_config(exp_name="exp", ckpt_root=tmp / "ckpt", infer=True)
    sampler = DsBatchSampler(AcousticDataset(tmp / "binary", hp, "train").sizes,
                             max_batch_frames=hp["max_batch_frames"],
                             max_batch_size=hp["max_batch_size"], num_replicas=2,
                             required_batch_count_multiple=2, shuffle_sample=True,
                             shuffle_batch=True, seed=hp["seed"])
    _, _, leftovers = sampler._form_shared()
    assert len(leftovers) == 1
    p0, p1 = (torch.load(tmp / "first" / f"params_rank{r}.pt") for r in (0, 1))
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    want = _one_process_reference(tmp)
    err = max((p0[k] - want[k]).abs().max().item() for k in want)
    assert err <= 1e-5, err


def test_rank_zero_alone_writes_and_two_ranks_resume(two_ranks):
    """Checkpoints, metrics.jsonl (each step's line once) and the tensorboard
    events come from rank 0; the resumed ranks continue from step 3."""
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    from diffsinger_tpu_torch.utils.ckpt import load_checkpoint

    tmp, first, log = two_ranks
    work = tmp / "ckpt" / "exp"
    assert sorted(first) == ["model_ckpt_steps_3.ckpt"]
    steps = [json.loads(line)["step"] for line in log.splitlines()
             if "training/total_loss" in line]
    assert steps == [1, 2, 3]
    assert sorted(p.name for p in work.glob("*.ckpt")) == ["model_ckpt_steps_3.ckpt",
                                                           "model_ckpt_steps_4.ckpt"]
    blob = load_checkpoint(work / "model_ckpt_steps_4.ckpt", category="acoustic")
    assert blob["global_step"] == 4
    assert {int(s["step"]) for s in blob["optimizer_states"][0]["state"].values()} == {4}
    events = list((work / "lightning_logs" / "tb").glob("events.out.tfevents.*"))
    assert len(events) == 2  # one file a run, from rank 0 only
    acc = EventAccumulator(str(work / "lightning_logs" / "tb"))
    acc.Reload()
    assert [e.step for e in acc.Scalars("training/total_loss")][-4:] == [1, 2, 3, 4]
    p0, p1 = (torch.load(tmp / "resumed" / f"params_rank{r}.pt") for r in (0, 1))
    assert all(torch.equal(p0[k], p1[k]) for k in p0)
    saved = blob["state_dict"]
    assert all(torch.equal(saved["model." + k], v) for k, v in p0.items())


# ------------------------------------------------------------------ a dead rank

def test_a_dead_rank_makes_the_others_raise_within_the_timeout(tmp_path):
    run_ranks(workers.dead_peer, tmp_path, str(tmp_path), 10.0, timeout=60)
    outcome = (tmp_path / "dead_peer.txt").read_text()
    waited = float(np.load(tmp_path / "dead_peer.npy")[0])
    assert outcome != "returned" and "Error" in outcome, outcome
    assert waited <= 10.0 + 5.0, waited


# ------------------------------------------------------------------ the profile's busy time

def test_profile_busy_time_counts_overlapping_kernels_once():
    """chip_smoke.py's idle share over a DDP step: NCCL's kernel beside the
    backward counts once, and the ranges drawn over kernels (a host range's
    name, or one that holds a kernel of its stream) count not at all."""
    from types import SimpleNamespace as NS

    from chip_smoke import device_activities, union_us

    cpu, cuda = "cpu", "cuda"

    def ev(name, start, end, stream=7, device=cuda, annotation=False):
        return NS(name=name, device_type=device, device_index=0, device_resource_id=stream,
                  is_user_annotation=annotation, time_range=NS(start=start, end=end))

    events = [
        ev("DistributedDataParallel.forward", 0, 100, device=cpu, annotation=True),
        ev("DistributedDataParallel.forward", 5, 60),  # its range on the device
        ev("gemm", 5, 20), ev("conv", 30, 60), ev("adam", 90, 95),
        ev("Optimizer.step#AdamW.step", 88, 97, stream=8),  # alone on a stream of its own
        ev("Optimizer.step#AdamW.step", 80, 99, device=cpu),
        ev("a range the host never named", 89, 96),  # holds adam
        ev("ncclDevKernel_AllReduce", 40, 75, stream=9),
    ]
    acts = device_activities(events, cuda)
    assert sorted(n for n, _, _ in acts) == ["adam", "conv", "gemm", "ncclDevKernel_AllReduce"]
    busy = union_us((s, e) for _, s, e in acts)
    assert busy == 15 + 45 + 5  # gemm; conv and NCCL 30-75; adam
    assert busy - union_us((s, e) for n, s, e in acts if "nccl" not in n) == 15
    assert union_us([(0, 10), (2, 4), (10, 12), (20, 21)]) == 13
