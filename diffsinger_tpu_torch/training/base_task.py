"""Training runtime (counterpart of diffsinger_tpu/training/base_task.py).

Step-based validation and log intervals, the ``max_updates`` stop, checkpoint
save and rotation with permanent checkpoints, resume (weights, optimizer and
scheduler states, step, micro-batch count and epoch), fine-tune loading with
ignored prefixes and shape filtering, prefix freezing, per-epoch seeded batch
sampling, and a ``metrics.jsonl`` log at ``<work_dir>/lightning_logs/tb/``.

One process, one device: the card unless ``device='cpu'`` is asked for.
``pl_trainer_precision`` '16-mixed' (any 16-bit setting) trains under bf16
``torch.autocast`` over float32 parameters and optimizer states; '32' in
float32 throughout. TF32 is off during a step, so float32 products stay
float32. Validation runs in float32 in eval mode (no dropout), as the
reference's does. The random draws of a micro-batch (dropout, diffusion time,
noise) come from torch's generators seeded by (seed, micro-batch count), so a
resumed run continues the stream instead of replaying it.
"""

from __future__ import annotations

import contextlib
import json
import pathlib
import time
import warnings
from typing import Dict, Optional

import numpy as np
import torch

from diffsinger_tpu_torch.data.batch_sampler import DsBatchSampler
from diffsinger_tpu_torch.training.schedules import build_lr_scheduler
from diffsinger_tpu_torch.training.train_state import (
    build_optimizer, clip_grad_norm, filter_finetune_params, freeze_params,
)
from diffsinger_tpu_torch.utils import no_tf32, resolve_device, resolve_precision
from diffsinger_tpu_torch.utils import ckpt as ckpt_utils
from diffsinger_tpu_torch.utils.text import load_phoneme_dictionary


class SummaryLogger:
    """Scalars as JSON lines in ``metrics.jsonl``; figures as PNG files and
    audio as wav files beside it. Without matplotlib the figures are skipped,
    with one printed line."""

    def __init__(self, log_dir):
        self.log_dir = pathlib.Path(log_dir)
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self._lines = []
        self._no_figures = False

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._lines.append(json.dumps({"step": int(step), tag: float(value)}) + "\n")

    def add_figure(self, tag: str, make_figure, step: int) -> None:
        """``make_figure()`` draws the figure; it is called only when it can be saved."""
        if self._no_figures:
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
        plt.close(fig)

    def add_audio(self, tag: str, audio: np.ndarray, step: int, sample_rate: int) -> None:
        from diffsinger_tpu_torch.utils.infer_utils import save_wav

        out = self.log_dir / "audio"
        out.mkdir(exist_ok=True)
        save_wav(audio, out / f"{tag}_step{step}.wav", sample_rate)

    def flush(self) -> None:
        with open(self.log_dir / "metrics.jsonl", "a") as f:
            f.writelines(self._lines)
        self._lines = []


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


def micro_seed(seed: int, micro: int) -> int:
    """The seed of micro-batch ``micro``'s draws."""
    return ((seed & 0xFFFF_FFFF) << 32) | (micro & 0xFFFF_FFFF)


class BaseTask:
    """Generic training runtime; a subclass provides the model, the loss and
    the datasets."""

    category: str = "base"

    def __init__(self, hp: dict, device=None):
        self.hp = hp
        self.device = resolve_device(device)
        self.work_dir = pathlib.Path(hp["work_dir"] or ".")
        self.phoneme_dictionary = load_phoneme_dictionary(hp)
        self.amp_dtype = resolve_precision(hp.get("pl_trainer_precision", "32-true"))
        if self.amp_dtype == torch.float32:
            self.amp_dtype = None
        self.model = self.build_model()
        self.module = self.model.module
        self.loss_fn = self.build_loss_fn(self.model)
        self.logger = SummaryLogger(self.work_dir / "lightning_logs" / "tb")
        self.global_step = 0
        self.epoch = 0
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

    # ------------------------------------------------------------------
    def to_device(self, batch: dict) -> Dict[str, torch.Tensor]:
        """A collated numpy batch as tensors on the task's device."""
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device, non_blocking=True)
                for k, v in batch.items() if isinstance(v, np.ndarray)}

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

    def train_step(self, batch: Dict[str, torch.Tensor], **draws):
        """Forward and backward of one micro-batch (losses averaged over the
        accumulated micro-batches); returns the detached losses."""
        self.module.train()
        with no_tf32():
            with self.autocast():
                total, losses = self.loss_fn(batch, **draws)
            (total / self.accum).backward()
        return {"total_loss": total.detach(), **{k: v.detach() for k, v in losses.items()}}

    def apply_update(self) -> torch.Tensor:
        """Clip, step the optimizer and the scheduler, clear the gradients;
        returns the gradient norm before clipping."""
        norm = clip_grad_norm(self.params, float(self.hp.get("clip_grad_norm", 0) or 0))
        self.optimizer.step()
        self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.global_step += 1
        return norm

    # ------------------------------------------------------------------
    def init_or_resume(self) -> None:
        """Load the newest checkpoint of the work dir (weights, optimizer,
        scheduler, step, epoch), else the fine-tune checkpoint if enabled."""
        hp = self.hp
        ckpts = ckpt_utils.list_checkpoints(self.work_dir)
        if ckpts:
            path = ckpts[-1][1]
            blob = ckpt_utils.load_checkpoint(path, category=self.category)
            self.module.load_state_dict(ckpt_utils.strip_model_prefix(blob["state_dict"]),
                                        strict=True)
            self.global_step = int(blob["global_step"])
            self.epoch = int(blob.get("epoch", 0))
            try:
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
                print(f"| optimizer state not restored ({e!r}); reinitialized by "
                      "allow_optimizer_state_reset=true")
                restored = False
            if restored and blob.get("lr_schedulers"):
                self.scheduler.load_state_dict(blob["lr_schedulers"][0])
            else:  # re-simulate the schedule up to the global step
                with warnings.catch_warnings():
                    warnings.simplefilter("ignore")
                    for _ in range(self.global_step):
                        self.scheduler.step()
            print(f"| resumed from {path} at step {self.global_step} (epoch {self.epoch})")
            return
        if hp.get("finetune_enabled", False) and hp.get("finetune_ckpt_path"):
            blob = ckpt_utils.load_checkpoint(hp["finetune_ckpt_path"])
            state = filter_finetune_params(
                self.module.state_dict(), ckpt_utils.strip_model_prefix(blob["state_dict"]),
                hp.get("finetune_ignored_params", []),
                strict_shapes=hp.get("finetune_strict_shapes", True))
            self.module.load_state_dict(state, strict=True)
            print(f"| finetune from {hp['finetune_ckpt_path']}")

    def save(self) -> None:
        hp = self.hp
        path = ckpt_utils.checkpoint_path(self.work_dir, self.global_step)
        ckpt_utils.save_checkpoint(path, self.module, category=self.category,
                                   global_step=self.global_step, epoch=self.epoch,
                                   optimizer=self.optimizer, scheduler=self.scheduler)
        deleted = ckpt_utils.keep_checkpoints(
            self.work_dir, num_ckpt_keep=hp.get("num_ckpt_keep", 5),
            permanent_ckpt_start=hp.get("permanent_ckpt_start", 0),
            permanent_ckpt_interval=hp.get("permanent_ckpt_interval", -1))
        print(f"| saved checkpoint at step {self.global_step}"
              + (f" (rotated {len(deleted)})" if deleted else ""))

    # ------------------------------------------------------------------
    def start(self, max_steps: Optional[int] = None) -> int:
        """Train to ``max_steps`` (default ``max_updates``) optimizer updates;
        returns the global step reached."""
        hp = self.hp
        self.configure_optimizer()
        self.init_or_resume()
        train_ds, valid_ds = self.build_datasets()
        max_updates = max_steps if max_steps is not None else hp.get("max_updates", 160000)
        val_interval = hp.get("val_check_interval", 2000)
        log_interval = hp.get("log_interval", 100)
        seed = hp.get("seed") or 0
        sanity = int(hp.get("num_sanity_val_steps", 1) or 0)
        if sanity > 0 and len(valid_ds) > 0:
            self.run_validation(valid_ds, limit_batches=sanity, sanity=True)

        profile_steps = int(hp.get("profile_steps", 0) or 0)
        profile_start = self.global_step + 3  # after the first steps' allocations
        profiler = None
        micro = self.global_step * self.accum
        last_val = last_log = self.global_step
        t_last = time.time()
        metrics = {}
        while self.global_step < max_updates:
            sampler = DsBatchSampler(
                train_ds.sizes, max_batch_frames=hp.get("max_batch_frames", 50000),
                max_batch_size=hp.get("max_batch_size", 64),
                frame_count_grid=hp.get("sampler_frame_count_grid", 6),
                required_batch_count_multiple=self.accum,
                sort_by_similar_size=hp.get("sort_by_len", True), shuffle_sample=True,
                seed=seed)
            sampler.set_epoch(self.epoch)
            for indices in sampler:
                if self.global_step >= max_updates:
                    break
                batch = train_ds.collater([train_ds[i] for i in indices])
                size = batch.pop("size")
                batch.pop("indices")
                batch = self.to_device(pad_batch_rows(batch, size, bucket_batch_size(size)))
                if profile_steps and profiler is None and self.global_step >= profile_start:
                    profiler = torch.profiler.profile()
                    profiler.__enter__()
                torch.manual_seed(micro_seed(seed, micro))
                metrics = self.train_step(batch)
                micro += 1
                if micro % self.accum:
                    continue
                metrics["grad_norm"] = self.apply_update()
                step = self.global_step
                if profiler is not None and step >= profile_start + profile_steps:
                    profiler.__exit__(None, None, None)
                    (self.work_dir / "profile").mkdir(parents=True, exist_ok=True)
                    profiler.export_chrome_trace(str(self.work_dir / "profile" / "trace.json"))
                    print(f"| profiler trace saved to {self.work_dir / 'profile'}")
                    profiler, profile_steps = None, 0
                if step % log_interval == 0 and step != last_log:
                    last_log = step
                    values = {k: float(v) for k, v in metrics.items()}
                    lr = self.optimizer.param_groups[0]["lr"]
                    dt, t_last = time.time() - t_last, time.time()
                    self.logger.add_scalar("training/lr", lr, step)
                    for k, v in values.items():
                        self.logger.add_scalar(f"training/{k}", v, step)
                    print(f"| step {step} " + " ".join(f"{k}={v:.4f}" for k, v in values.items())
                          + f" lr={lr:.2e} ({log_interval / max(dt, 1e-9):.2f} it/s)")
                    self.logger.flush()
                if step % val_interval == 0 and step != last_val:
                    last_val = step
                    self.run_validation(valid_ds)
                    self.save()
            else:
                self.epoch += 1
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
        dict holds it under that key beside the losses."""
        hp = self.hp
        self.module.eval()
        self.metric_states = {}
        n = len(valid_ds)
        bs = max(1, hp.get("max_val_batch_size", 1))
        max_frames = int(hp.get("max_val_batch_frames", 60000) or 0)
        if max_frames > 0 and n > 0:
            bs = max(1, min(bs, max_frames // max(int(np.max(valid_ds.sizes)), 1)))
        acc: Dict[str, list] = {}
        for n_batches, i in enumerate(range(0, n, bs)):
            if limit_batches is not None and n_batches >= limit_batches:
                break
            idxs = list(range(i, min(n, i + bs)))
            batch = valid_ds.collater([valid_ds[j] for j in idxs])
            batch.pop("size")
            batch.pop("indices")
            batch = self.to_device(batch)
            generator = torch.Generator(self.device).manual_seed(42)
            with no_tf32():
                _, losses = self.loss_fn(batch, generator=generator)
            for k, v in losses.items():
                acc.setdefault(k, []).append(float(v))
            if not sanity:
                self.validation_extras(valid_ds, {"indices": idxs, **batch})
        self.module.train()
        means = {k: float(np.mean(v)) for k, v in acc.items()}
        if sanity:
            bad = sorted(k for k, v in means.items() if not np.isfinite(v))
            if bad:
                raise RuntimeError(f"sanity validation produced non-finite losses: {bad}")
            print("| sanity validation ok: " + " ".join(f"{k}={v:.4f}" for k, v in means.items()))
            return means
        for k, v in means.items():
            self.logger.add_scalar(f"validation/{k}", v, self.global_step)
        metrics = {f"metrics/{k}": st.value() for k, st in self.metric_states.items()}
        for k, v in metrics.items():
            self.logger.add_scalar(k, v, self.global_step)
        print(f"| validation @ {self.global_step}: "
              + " ".join(f"{k}={v:.4f}" for k, v in {**means, **metrics}.items()))
        self.logger.flush()
        return {**means, **metrics}
