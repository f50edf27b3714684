"""Training runtime (counterpart of diffsinger_tpu/training/base_task.py).

Step-based validation and log intervals, the ``max_updates`` stop, checkpoint
save and rotation with permanent checkpoints, resume (weights, optimizer and
scheduler states, step, micro-batch count and epoch), fine-tune loading with
ignored prefixes and shape filtering, prefix freezing, per-epoch seeded batch
sampling, and a ``metrics.jsonl`` log at ``<work_dir>/lightning_logs/tb/``.

One process per device: the card unless ``device='cpu'`` is asked for.
``pl_trainer_precision`` '16-mixed' (any 16-bit setting) trains under bf16
``torch.autocast`` over float32 parameters and optimizer states; '32' in
float32 throughout. TF32 is off during a step, so float32 products stay
float32. Validation runs in float32 in eval mode (no dropout), as the
reference's does.

Over ranks (a process group joined through ``parallel/dist.py``), a step is
the JAX package's step over one global batch. Every rank forms the epoch's
batches of all ranks (``DsBatchSampler.all_rank_batches``), loads only its
own, pads them to the pad targets and the row count of the step's global
batch (from the peers' metadata, without communication), and stops at the
position every rank has. The module runs under ``DistributedDataParallel``
(``no_sync`` on the micro-batches that do not close an accumulation), the
losses are means over the global batch (``models/losses.py``), so N ranks of
B rows update as one process on the N * B rows. Checkpoints, logs and
figures come from rank 0; host metrics are averaged over the ranks first.

Input pipeline. The batches come as one stream that spans epochs
(:meth:`BaseTask.batch_stream`), read and collated on one daemon thread and
uploaded on another (on the card: from pinned memory, on a CUDA stream of
their own, with an event that the training stream waits on),
``train_prefetch_depth`` batches ahead (``DS_PREFETCH_DEPTH`` overrides it; 0
runs both stages inline on the training thread). Each batch carries its
place in the stream, so ``epoch`` and ``epoch_position`` are those of the
batch the loop consumed, and a resumed run goes on from the next batch at
any depth. ``train_wire_dtype: float16`` sends the float32 arrays of a
training batch as float16; the loop casts them back to float32 on the device
before any arithmetic.

Draws. The diffusion times, the noises and the retake masks of a micro-batch
are drawn at the global batch's shape from a generator seeded by (seed,
micro-batch count), and each rank takes its rows, so they do not depend on
the rank count. Dropout draws from torch's default generators seeded by
(seed, micro-batch count, rank), so ranks draw different masks for their
different rows. A resumed run continues both streams instead of replaying
them.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import pathlib
import sys
import time
import types
import warnings
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from diffsinger_tpu_torch.data.batch_sampler import DsBatchSampler
from diffsinger_tpu_torch.parallel import dist
from diffsinger_tpu_torch.training.schedules import build_lr_scheduler
from diffsinger_tpu_torch.training.train_state import (
    build_optimizer, clip_grad_norm, filter_finetune_params, freeze_params,
)
from diffsinger_tpu_torch.utils import no_tf32, resolve_device, resolve_precision, tracing
from diffsinger_tpu_torch.utils import ckpt as ckpt_utils
from diffsinger_tpu_torch.utils.prefetch import PrefetchIterator, upload
from diffsinger_tpu_torch.utils.text import load_phoneme_dictionary


class SummaryLogger:
    """Scalars as tensorboard events and as JSON lines in ``metrics.jsonl``;
    figures as tensorboard images and PNG files, audio as tensorboard audio
    and wav files beside them. Without matplotlib the figures are skipped,
    with one printed line. ``active=False`` (the ranks other than 0) writes
    nothing."""

    def __init__(self, log_dir, active: bool = True):
        self.log_dir = pathlib.Path(log_dir)
        self.active = active
        self._lines = []
        self._no_figures = False
        self.writer = None
        if active:
            # tensorboard's own switch: with ``tensorboard.compat.notf`` present
            # it writes events through its stub instead of importing
            # TensorFlow where that is installed (seconds, for nothing used)
            sys.modules.setdefault("tensorboard.compat.notf",
                                   types.ModuleType("tensorboard.compat.notf"))
            from torch.utils.tensorboard import SummaryWriter

            self.log_dir.mkdir(parents=True, exist_ok=True)
            self.writer = SummaryWriter(str(self.log_dir))

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        if not self.active:
            return
        self.writer.add_scalar(tag, float(value), int(step))
        self._lines.append(json.dumps({"step": int(step), tag: float(value)}) + "\n")

    def add_figure(self, tag: str, make_figure, step: int) -> None:
        """``make_figure()`` draws the figure; it is called only when it can be saved."""
        if self._no_figures or not self.active:
            return
        try:
            import matplotlib.pyplot as plt
        except ImportError:
            self._no_figures = True
            print("| matplotlib is not installed: validation figures are skipped")
            return
        fig = make_figure()
        out = self.log_dir / "figures"
        out.mkdir(exist_ok=True)
        fig.savefig(out / f"{tag}_step{step}.png")
        self.writer.add_figure(tag, fig, int(step), close=False)
        plt.close(fig)

    def add_audio(self, tag: str, audio: np.ndarray, step: int, sample_rate: int) -> None:
        if not self.active:
            return
        from diffsinger_tpu_torch.utils.infer_utils import save_wav

        out = self.log_dir / "audio"
        out.mkdir(exist_ok=True)
        save_wav(audio, out / f"{tag}_step{step}.wav", sample_rate)
        self.writer.add_audio(tag, np.asarray(audio, np.float32)[None], int(step),
                              sample_rate=sample_rate)

    def flush(self) -> None:
        if not self.active:
            return
        with open(self.log_dir / "metrics.jsonl", "a") as f:
            f.writelines(self._lines)
        self._lines = []
        self.writer.flush()


_MASK_KEYS_ON_PAD = ("tokens", "mel2ph", "mel2note")


def pad_batch_rows(batch: dict, size: int, target_b: int) -> dict:
    """Pad the batch axis from ``size`` to ``target_b`` rows with copies of
    the last item whose ``tokens`` / ``mel2ph`` / ``mel2note`` are zero, so
    every loss mask gives them zero weight (and every value stays finite)."""
    if size >= target_b:
        return batch
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == size:
            rows = np.repeat(v[-1:], target_b - size, 0)
            if k in _MASK_KEYS_ON_PAD:
                rows = np.zeros_like(rows)
            batch[k] = np.concatenate([v, rows], 0)
    return batch


def bucket_batch_size(n: int) -> int:
    """The batch size rounded up to a power of two, as the JAX trainer pads
    its batches (so both train on batches of the same shapes)."""
    return 1 << (n - 1).bit_length()


def prefetch_depth(hp: dict) -> int:
    """Batches the input pipeline's stages run ahead of the loop: the
    ``DS_PREFETCH_DEPTH`` environment variable, else ``train_prefetch_depth``
    (default 1); 0 runs them inline."""
    return int(os.environ.get("DS_PREFETCH_DEPTH", hp.get("train_prefetch_depth", 1)))


def wire_float16(hp: dict) -> bool:
    """Whether ``train_wire_dtype`` sends a batch's float32 arrays as float16."""
    return str(hp.get("train_wire_dtype", "float32")).lower() in ("float16", "f16", "fp16")


def to_wire(batch: dict) -> dict:
    """The float32 arrays of a numpy batch as float16, the others as they are."""
    return {k: v.astype(np.float16) if isinstance(v, np.ndarray) and v.dtype == np.float32
            else v for k, v in batch.items()}


def micro_seed(seed: int, micro: int) -> int:
    """The seed of micro-batch ``micro``'s draws (times, noises, retake masks)."""
    return ((seed & 0xFFFF_FFFF) << 32) | (micro & 0xFFFF_FFFF)


def dropout_seed(seed: int, micro: int, rank: int) -> int:
    """The seed of rank ``rank``'s dropout masks in micro-batch ``micro``."""
    digest = hashlib.blake2b(f"dropout/{seed}/{micro}/{rank}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") >> 1


def rank_positions(peer_batches: List[List[List[int]]]) -> int:
    """The batch positions of an epoch that every rank has: a rank with a
    batch more than its peers would wait in DDP's all-reduce for ever."""
    return min(len(b) for b in peer_batches)


def take_rows(draws: dict, start: int, stop: int) -> dict:
    """Rows [start, stop) of every tensor of ``draws`` (dicts of them too)."""
    return {k: (take_rows(v, start, stop) if isinstance(v, dict) else v[start:stop])
            for k, v in draws.items()}


class _LossModule(torch.nn.Module):
    """The loss of a batch as a module's forward, for DDP to wrap: DDP's
    hooks see only what runs through its forward."""

    def __init__(self, module: torch.nn.Module, loss_fn):
        super().__init__()
        self.module = module
        self.loss_fn = loss_fn

    def forward(self, batch, draws):
        return self.loss_fn(batch, **draws)


class BaseTask:
    """Generic training runtime; a subclass provides the model, the loss and
    the datasets."""

    category: str = "base"

    def __init__(self, hp: dict, device=None):
        self.hp = hp
        self.device = resolve_device(device)
        self.rank, self.world_size = dist.rank(), dist.world_size()
        self.ddp = None
        self.work_dir = pathlib.Path(hp["work_dir"] or ".")
        self.phoneme_dictionary = load_phoneme_dictionary(hp)
        self.amp_dtype = resolve_precision(hp.get("pl_trainer_precision", "32-true"))
        if self.amp_dtype == torch.float32:
            self.amp_dtype = None
        self.model = self.build_model()
        self.module = self.model.module
        self.loss_fn = self.build_loss_fn(self.model)
        self.logger = SummaryLogger(self.work_dir / "lightning_logs" / "tb",
                                    active=self.rank == 0)
        self.global_step = 0
        # the place in the batch stream after the last batch consumed: the
        # epoch, and how many of its batches were consumed
        self.epoch = 0
        self.epoch_position = 0
        self._upload_stream = None
        # streaming validation metrics, {name: state with ``value()``}: reset
        # by each run_validation, updated by validation_extras
        self.metric_states: Dict[str, object] = {}

    # -- subclass contract --------------------------------------------------
    def build_model(self):
        raise NotImplementedError()

    def build_loss_fn(self, model):
        """``loss_fn(batch, **draws) -> (total, {name: loss})`` on device tensors."""
        raise NotImplementedError()

    def build_datasets(self):
        raise NotImplementedError()

    def validation_extras(self, valid_ds, batch: dict) -> None:
        """Task-specific figures and audio for a validation batch, and updates
        of ``self.metric_states``."""

    def draw(self, batch: Dict[str, torch.Tensor], n_rows: int, generator) -> dict:
        """The loss function's draws (times, noises, retake masks) for a batch
        of ``n_rows`` rows shaped as ``batch`` (the global batch of a step),
        from ``generator`` in the order the loss function would draw them."""
        return {}

    # ------------------------------------------------------------------
    def to_device(self, batch: dict) -> Dict[str, torch.Tensor]:
        """A collated numpy batch as tensors on the task's device."""
        return {k: upload(v, self.device) for k, v in batch.items() if isinstance(v, np.ndarray)}

    def autocast(self):
        if self.amp_dtype is None:
            return contextlib.nullcontext()
        return torch.autocast(self.device.type, dtype=self.amp_dtype)

    def frozen_prefixes(self) -> list:
        hp = self.hp
        prefixes = list(hp.get("frozen_params") or []) if hp.get("freezing_enabled", False) else []
        # staged shallow-diffusion training: the branch left out of the loss
        # gets no gradient; freezing it keeps the optimizer off it entirely
        if hp.get("use_shallow_diffusion", False):
            shallow = hp.get("shallow_diffusion_args", {})
            if not shallow.get("train_diffusion", True):
                prefixes.append("diffusion")
            if not shallow.get("train_aux_decoder", True):
                prefixes.append("aux_decoder")
        return prefixes

    def configure_optimizer(self):
        """Freeze, then the optimizer over the trainable parameters and its scheduler."""
        freeze_params(self.module, self.frozen_prefixes())
        self.params = [p for p in self.module.parameters() if p.requires_grad]
        self.optimizer = build_optimizer(self.params, self.hp)
        self.scheduler = build_lr_scheduler(self.optimizer, self.hp["lr_scheduler_args"],
                                            hidden_size=self.hp.get("hidden_size", 256))
        self.accum = max(1, int(self.hp.get("accumulate_grad_batches", 1)))

    def wrap_ddp(self) -> None:
        """Put the module under DistributedDataParallel when the process has
        joined a group (of one rank too). Its parameters are broadcast from
        rank 0. No search for unused
        parameters: in the shipped configs every parameter that trains gets a
        gradient in each step, and the branches that staged training leaves
        out of the loss are frozen (:meth:`frozen_prefixes`)."""
        if not dist.is_initialized() or self.ddp is not None:
            return
        from torch.nn.parallel import DistributedDataParallel

        self.ddp = DistributedDataParallel(
            _LossModule(self.module, self.loss_fn),
            device_ids=[self.device] if self.device.type == "cuda" else None)

    def micro_draws(self, batch: Dict[str, torch.Tensor], micro: int, n_rows: int,
                    row0: int) -> dict:
        """Seed micro-batch ``micro``'s dropout stream (by rank) and return its
        draws: made at the global batch's ``n_rows`` rows, this rank's rows
        from ``row0``."""
        seed = self.hp.get("seed") or 0
        torch.manual_seed(dropout_seed(seed, micro, self.rank))
        generator = torch.Generator(self.device).manual_seed(micro_seed(seed, micro))
        draws = self.draw(batch, n_rows, generator)
        return take_rows(draws, row0, row0 + batch["tokens"].shape[0])

    def train_step(self, batch: Dict[str, torch.Tensor], *, sync: bool = True, **draws):
        """Forward and backward of one micro-batch (losses averaged over the
        accumulated micro-batches); returns the detached losses (this rank's
        shares of the global ones). Over ranks the gradients are all-reduced
        only when ``sync`` (the micro-batch that closes an accumulation)."""
        self.module.train()
        sync_ctx = (self.ddp.no_sync() if self.ddp is not None and not sync
                    else contextlib.nullcontext())
        with sync_ctx, no_tf32():
            with tracing.span("ds.train.forward"), self.autocast():
                if self.ddp is not None:
                    total, losses = self.ddp(batch, draws)
                else:
                    total, losses = self.loss_fn(batch, **draws)
            with tracing.span("ds.train.backward"):
                (total / self.accum).backward()
        return {"total_loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}

    def apply_update(self) -> torch.Tensor:
        """Clip, step the optimizer and the scheduler, clear the gradients;
        returns the gradient norm before clipping (over ranks, of the
        all-reduced gradients: the same on every rank)."""
        with tracing.span("ds.train.clip"):
            norm = clip_grad_norm(self.params, float(self.hp.get("clip_grad_norm", 0) or 0))
        with tracing.span("ds.train.optimizer"):
            self.optimizer.step()
            self.scheduler.step()
            self.optimizer.zero_grad(set_to_none=True)
        self.global_step += 1
        return norm

    # ------------------------------------------------------------------
    def init_or_resume(self) -> None:
        """Load the newest checkpoint of the work dir (weights, optimizer,
        scheduler, step, epoch; the JAX trainer's ``.dsckpt`` when the folder
        holds no checkpoint of the port's), else the fine-tune checkpoint if
        enabled. Every rank loads."""
        hp = self.hp
        ckpts = ckpt_utils.any_checkpoints(self.work_dir)
        if ckpts:
            path = ckpts[-1][1]
            blob = ckpt_utils.load_checkpoint(path, category=self.category, hp=hp)
            self.module.load_state_dict(ckpt_utils.strip_model_prefix(blob["state_dict"]),
                                        strict=True)
            self.global_step = int(blob["global_step"])
            self.epoch = int(blob.get("epoch", 0))
            self.epoch_position = int(blob.get("epoch_position", 0))
            try:
                if path.suffix == ".dsckpt":
                    raise KeyError("the JAX trainer's optax state is not carried over")
                saved_cls = blob.get("optimizer_cls", type(self.optimizer).__name__)
                if saved_cls != type(self.optimizer).__name__:
                    raise ValueError(f"the checkpoint's optimizer is {saved_cls}")
                self.optimizer.load_state_dict(blob["optimizer_states"][0])
                restored = True
            except (KeyError, IndexError, ValueError, RuntimeError) as e:
                if not hp.get("allow_optimizer_state_reset", False):
                    raise RuntimeError(
                        f"optimizer state in {path} does not match the current optimizer "
                        f"config ({e!r}). Set allow_optimizer_state_reset: true to continue "
                        "with a reinitialized optimizer (moments restart from zero; the LR "
                        "schedule is fast-forwarded to the global step).") from e
                self.log(f"| optimizer state not restored ({e!r}); reinitialized by "
                         "allow_optimizer_state_reset=true")
                restored = False
            if restored and blob.get("lr_schedulers"):
                self.scheduler.load_state_dict(blob["lr_schedulers"][0])
            else:  # re-simulate the schedule up to the global step
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    for _ in range(self.global_step):
                        self.scheduler.step()
            self.log(f"| resumed from {path} at step {self.global_step} (epoch {self.epoch})")
            return
        if hp.get("finetune_enabled", False) and hp.get("finetune_ckpt_path"):
            path = pathlib.Path(hp["finetune_ckpt_path"])
            if path.is_dir():  # an experiment folder, the port's or the JAX trainer's
                path = ckpt_utils.find_checkpoint(path)[1]
            blob = ckpt_utils.load_checkpoint(path, category=self.category, hp=hp)
            state = filter_finetune_params(
                self.module.state_dict(), ckpt_utils.strip_model_prefix(blob["state_dict"]),
                hp.get("finetune_ignored_params", []),
                strict_shapes=hp.get("finetune_strict_shapes", True))
            self.module.load_state_dict(state, strict=True)
            self.log(f"| finetune from {path}")

    def log(self, msg: str) -> None:
        """Print on rank 0 only."""
        if self.rank == 0:
            print(msg, flush=True)

    def save(self) -> None:
        """Rank 0 writes the checkpoint and rotates; every rank waits for it."""
        hp = self.hp
        if self.rank == 0:
            path = ckpt_utils.checkpoint_path(self.work_dir, self.global_step)
            ckpt_utils.save_checkpoint(path, self.module, category=self.category,
                                       global_step=self.global_step, epoch=self.epoch,
                                       epoch_position=self.epoch_position,
                                       optimizer=self.optimizer, scheduler=self.scheduler)
            deleted = ckpt_utils.keep_checkpoints(
                self.work_dir, num_ckpt_keep=hp.get("num_ckpt_keep", 5),
                permanent_ckpt_start=hp.get("permanent_ckpt_start", 0),
                permanent_ckpt_interval=hp.get("permanent_ckpt_interval", -1))
            print(f"| saved checkpoint at step {self.global_step}"
                  + (f" (rotated {len(deleted)})" if deleted else ""))
        dist.barrier()

    # ------------------------------------------------------------------
    def bucket_steps(self, ds) -> Dict[str, int]:
        return {"t_mel": ds.frame_bucket, "t_txt": ds.token_bucket, "t_note": ds.token_bucket}

    def epoch_plan(self, train_ds, epoch: int) -> List[Tuple[List[int], Optional[dict], int]]:
        """This rank's batches of ``epoch`` before any item is read: (item
        indices, pad targets or None, rows of the batch). Over ranks every
        rank pads to the pad targets and the row count of the global batch
        and keeps only the positions all ranks have."""
        hp = self.hp
        sampler = DsBatchSampler(
            train_ds.sizes, max_batch_frames=hp.get("max_batch_frames", 50000),
            max_batch_size=hp.get("max_batch_size", 64), num_replicas=self.world_size,
            rank=self.rank, frame_count_grid=hp.get("sampler_frame_count_grid", 6),
            required_batch_count_multiple=self.accum,
            sort_by_similar_size=hp.get("sort_by_len", True), shuffle_sample=True,
            shuffle_batch=True, seed=hp.get("seed") or 0)
        sampler.epoch = epoch
        peers = sampler.all_rank_batches()
        plan = []
        for pos in range(rank_positions(peers)):
            pad_to = None
            if self.world_size > 1:
                pad_to = train_ds.pad_targets([i for b in peers for i in b[pos]],
                                              train_ds.PAD_AXES, self.bucket_steps(train_ds))
            plan.append((peers[self.rank][pos], pad_to,
                         bucket_batch_size(max(len(b[pos]) for b in peers))))
        return plan

    def epoch_batches(self, train_ds, epoch: int, skip: int = 0) -> Iterator[Tuple[dict, int, int]]:
        """This rank's batches of ``epoch`` from position ``skip`` on, read,
        collated and padded (:meth:`epoch_plan`): yields (numpy batch, rows of
        the step's global batch, this rank's first row in it)."""
        for indices, pad_to, target_b in self.epoch_plan(train_ds, epoch)[skip:]:
            batch = train_ds.collater([train_ds[i] for i in indices], pad_to=pad_to)
            size = batch.pop("size")
            batch.pop("indices")
            yield (pad_batch_rows(batch, size, target_b), target_b * self.world_size,
                   target_b * self.rank)

    def batch_stream(self, train_ds, epoch: int, skip: int = 0):
        """The training batches for ever, from position ``skip`` of ``epoch``
        on, across epochs: yields (numpy batch in the wire format, rows of the
        global batch, this rank's first row, the (epoch, position) after the
        batch). The first stage of the input pipeline; it draws no random
        numbers, so the loop sees the same batches at every depth. Only this
        stage reads ``train_ds``, and validation reads its own store on the
        training thread, so no store reader is shared between threads."""
        wire_f16 = wire_float16(self.hp)
        while True:
            n = len(self.epoch_plan(train_ds, epoch))
            if n == 0:
                raise RuntimeError(
                    "the training epoch formed no batches: an empty dataset, or every batch "
                    "position dropped by the ranks' minimum; check max_batch_frames against the "
                    "item lengths")
            for pos, (batch, n_rows, row0) in enumerate(
                    self.epoch_batches(train_ds, epoch, skip), skip):
                yield ((to_wire(batch) if wire_f16 else batch), n_rows, row0,
                       (epoch, pos + 1) if pos + 1 < n else (epoch + 1, 0))
            epoch, skip = epoch + 1, 0

    def upload_batch(self, item):
        """The second stage of the input pipeline: the batch's arrays to the
        device. On the card the copy runs on the upload stream, and an event
        recorded after it goes with the batch."""
        batch, n_rows, row0, after = item
        if self.device.type != "cuda":
            return self.to_device(batch), None, n_rows, row0, after
        with torch.cuda.device(self.device):  # a new thread does not inherit the current device
            if self._upload_stream is None:
                self._upload_stream = torch.cuda.Stream()
            with torch.cuda.stream(self._upload_stream):
                tensors = self.to_device(batch)
                ready = torch.cuda.Event()
                ready.record(self._upload_stream)
        return tensors, ready, n_rows, row0, after

    def next_batch(self, batches) -> Tuple[Dict[str, torch.Tensor], int, int]:
        """The loop's next batch from the pipeline: the training stream waits
        on the device for its upload, the caching allocator learns that the
        training stream uses its tensors, float16 wire arrays become float32,
        and ``epoch`` / ``epoch_position`` move past it."""
        tensors, ready, n_rows, row0, (self.epoch, self.epoch_position) = next(batches)
        if ready is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ready)
            for t in tensors.values():
                t.record_stream(stream)
        batch = {k: v.float() if v.dtype == torch.float16 else v for k, v in tensors.items()}
        return batch, n_rows, row0

    def start(self, max_steps: Optional[int] = None) -> int:
        """Train to ``max_steps`` (default ``max_updates``) optimizer updates;
        returns the global step reached."""
        hp = self.hp
        self.configure_optimizer()
        self.init_or_resume()
        self.wrap_ddp()
        train_ds, valid_ds = self.build_datasets()
        max_updates = max_steps if max_steps is not None else hp.get("max_updates", 160000)
        val_interval = hp.get("val_check_interval", 2000)
        log_interval = hp.get("log_interval", 100)
        sanity = int(hp.get("num_sanity_val_steps", 1) or 0)
        if sanity > 0 and len(valid_ds) > 0:
            self.run_validation(valid_ds, limit_batches=sanity, sanity=True)

        profile_steps = int(hp.get("profile_steps", 0) or 0)
        profile_start = self.global_step + 3  # after the first steps' allocations
        profiler = None
        traced = tracing.enabled()  # the profiler's window turns the program's spans on
        micro = self.global_step * self.accum
        last_val = last_log = self.global_step
        t_last = time.time()
        metrics = {}
        # the input pipeline: read and collate, then upload, each on a daemon
        # thread ``depth`` batches ahead (at most 2 * depth + 1 batches staged),
        # or both inline at depth 0
        depth = prefetch_depth(hp)
        stream = self.batch_stream(train_ds, self.epoch, self.epoch_position)
        stages = []
        if depth > 0:
            stages.append(PrefetchIterator(stream, depth, name="ds-collate"))
            stages.append(PrefetchIterator(map(self.upload_batch, stages[0]), depth,
                                           name="ds-upload"))
            batches = stages[-1]
        else:
            batches = map(self.upload_batch, stream)
        try:
            while self.global_step < max_updates:
                batch, n_rows, row0 = self.next_batch(batches)
                if profile_steps and profiler is None and self.global_step >= profile_start:
                    profiler = torch.profiler.profile()
                    profiler.__enter__()
                    tracing.enable(True)
                closes = (micro + 1) % self.accum == 0
                metrics = self.train_step(batch, sync=closes,
                                          **self.micro_draws(batch, micro, n_rows, row0))
                micro += 1
                if not closes:
                    continue
                metrics["grad_norm"] = self.apply_update()
                step = self.global_step
                if profiler is not None and step >= profile_start + profile_steps:
                    tracing.enable(traced)
                    profiler.__exit__(None, None, None)
                    if self.rank == 0:
                        (self.work_dir / "profile").mkdir(parents=True, exist_ok=True)
                        profiler.export_chrome_trace(str(self.work_dir / "profile" / "trace.json"))
                        print(f"| profiler trace saved to {self.work_dir / 'profile'}")
                    profiler, profile_steps = None, 0
                if step % log_interval == 0 and step != last_log:
                    last_log = step
                    values = dist.all_reduce_mean(metrics)
                    lr = self.optimizer.param_groups[0]["lr"]
                    dt, t_last = time.time() - t_last, time.time()
                    self.logger.add_scalar("training/lr", lr, step)
                    for k, v in values.items():
                        self.logger.add_scalar(f"training/{k}", v, step)
                    self.log(f"| step {step} " + " ".join(f"{k}={v:.4f}" for k, v in values.items())
                             + f" lr={lr:.2e} ({log_interval / max(dt, 1e-9):.2f} it/s)")
                    self.logger.flush()
                if step % val_interval == 0 and step != last_val:
                    last_val = step
                    self.run_validation(valid_ds)
                    self.save()
        finally:
            tracing.enable(traced)
            for stage in stages:  # stop the threads, upstream first; release the staged batches
                stage.close()
        if self.global_step != last_val:
            self.run_validation(valid_ds)
            self.save()
        self.logger.flush()
        return self.global_step

    @torch.no_grad()
    def run_validation(self, valid_ds, limit_batches: Optional[int] = None,
                       sanity: bool = False) -> Dict[str, float]:
        """Mean validation losses (float32, eval mode, draws from a generator
        seeded 42 for every batch); the task's extras unless ``sanity``, which
        only checks that the losses are finite. Each streaming metric is
        logged once, after the last batch, as ``metrics/{name}``; the returned
        dict holds it under that key beside the losses.

        Over ranks, as the JAX trainer: the set is walked in chunks of a
        fixed size whose tail indices wrap, each rank takes its slice of a
        chunk (padded to the chunk's pad targets), the losses are the chunk's
        global ones, and rank 0 alone runs the extras on its slice."""
        hp = self.hp
        self.module.eval()
        self.metric_states = {}
        n = len(valid_ds)
        n_proc, rank = self.world_size, self.rank
        bs = max(1, hp.get("max_val_batch_size", 1))
        max_frames = int(hp.get("max_val_batch_frames", 60000) or 0)
        if max_frames > 0 and n > 0:
            bs = max(1, min(bs, max_frames // max(int(np.max(valid_ds.sizes)), 1)))
        acc: Dict[str, list] = {}
        for n_batches, i in enumerate(range(0, n, bs * n_proc)):
            if limit_batches is not None and n_batches >= limit_batches:
                break
            pad_to = None
            if n_proc > 1:
                chunk = [min(j, n - 1) for j in range(i, i + bs * n_proc)]
                idxs = chunk[rank * bs:(rank + 1) * bs]
                pad_to = valid_ds.pad_targets(chunk, valid_ds.PAD_AXES,
                                              self.bucket_steps(valid_ds))
            else:
                idxs = list(range(i, min(n, i + bs)))
            batch = valid_ds.collater([valid_ds[j] for j in idxs], pad_to=pad_to)
            batch.pop("size")
            batch.pop("indices")
            batch = self.to_device(batch)
            generator = torch.Generator(self.device).manual_seed(42)
            draws = take_rows(self.draw(batch, len(idxs) * n_proc, generator),
                              rank * len(idxs), (rank + 1) * len(idxs)) or {"generator": generator}
            with no_tf32():
                _, losses = self.loss_fn(batch, **draws)
            for k, v in dist.all_reduce_mean(losses).items():
                acc.setdefault(k, []).append(v)
            if not sanity and rank == 0:
                self.validation_extras(valid_ds, {"indices": idxs, **batch})
        self.module.train()
        means = {k: float(np.mean(v)) for k, v in acc.items()}
        if sanity:
            bad = sorted(k for k, v in means.items() if not np.isfinite(v))
            if bad:
                raise RuntimeError(f"sanity validation produced non-finite losses: {bad}")
            self.log("| sanity validation ok: "
                     + " ".join(f"{k}={v:.4f}" for k, v in means.items()))
            return means
        for k, v in means.items():
            self.logger.add_scalar(f"validation/{k}", v, self.global_step)
        metrics = {f"metrics/{k}": st.value() for k, st in self.metric_states.items()}
        for k, v in metrics.items():
            self.logger.add_scalar(k, v, self.global_step)
        self.log(f"| validation @ {self.global_step}: "
                 + " ".join(f"{k}={v:.4f}" for k, v in {**means, **metrics}.items()))
        self.logger.flush()
        return {**means, **metrics}
