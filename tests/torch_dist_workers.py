"""Rank processes of tests/test_torch_dist.py, started with ``spawn``.

Each function runs as one rank of a gloo group on the CPU, joined through
the launch contract (``DS_COORDINATOR_ADDRESS`` a ``file://`` URL in the
test's temporary folder, so parallel test workers never share a port). This
module imports torch and the port only: a spawned process re-imports it, and
the JAX side of a comparison stays in the test process.
"""

from __future__ import annotations

import os
import time
import traceback
from pathlib import Path

import numpy as np
import torch

TIMEOUT_S = 60  # the group's: a rank that dies makes the others raise


def join_group(rank: int, world: int, init_method: str, timeout_s: float = TIMEOUT_S) -> None:
    os.environ.update(DS_COORDINATOR_ADDRESS=init_method, DS_NUM_PROCESSES=str(world),
                      DS_PROCESS_ID=str(rank), DS_DIST_TIMEOUT=str(timeout_s))
    os.environ.pop("MASTER_ADDR", None)
    torch.set_num_threads(1)


def cli_train(rank: int, world: int, init_method: str, argv: list, out: str) -> None:
    """``cli.train`` as one rank; this rank's parameters saved after it."""
    join_group(rank, world, init_method)
    from diffsinger_tpu_torch.cli import train

    task = train.main(argv)
    torch.save(task.module.state_dict(), Path(out) / f"params_rank{rank}.pt")


def first_step(rank: int, world: int, init_method: str, blob_path: str, out: str) -> None:
    """One training step of the task a blob describes, through the trainer's
    DDP path: this rank's rows of the global batch and of the global draws.
    Saves the losses the ranks' shares average to, this rank's all-reduced
    gradients, and the dropout mask and the draws of micro-batch 5."""
    join_group(rank, world, init_method)
    from diffsinger_tpu_torch.parallel import dist
    from diffsinger_tpu_torch.training.base_task import take_rows

    dist.maybe_initialize_distributed("cpu")
    blob = torch.load(blob_path, weights_only=False)
    task = _task(blob)
    task.module.load_state_dict(blob["state_dict"])
    task.configure_optimizer()
    task.wrap_ddp()
    rows = blob["rows"]
    batch = {k: torch.from_numpy(v[rank * rows:(rank + 1) * rows])
             for k, v in blob["batch"].items()}
    draws = take_rows(blob["draws"], rank * rows, (rank + 1) * rows)
    metrics = task.train_step(batch, sync=True, **draws)
    losses = dist.all_reduce_mean(metrics)
    grads = {n: p.grad.clone() for n, p in task.module.named_parameters()}
    micro_draws = task.micro_draws(batch, 5, rows * world, rank * rows)
    mask = torch.nn.functional.dropout(torch.ones(256), 0.5, training=True) > 0
    torch.save(dict(losses=losses, grads=grads, mask=mask, micro_draws=micro_draws),
               Path(out) / f"step_rank{rank}.pt")
    dist.destroy()


def _task(blob):
    from diffsinger_tpu_torch.models.toplevel import DiffSingerAcoustic, DiffSingerVariance
    from diffsinger_tpu_torch.training.acoustic_task import AcousticTask
    from diffsinger_tpu_torch.training.variance_task import VarianceTask

    vocab = blob["vocab"]
    if blob["family"] == "acoustic":
        class Task(AcousticTask):
            def build_model(self):
                return DiffSingerAcoustic(self.hp, vocab_size=vocab,
                                          out_dims=self.hp["audio_num_mel_bins"], device="cpu")
    else:
        class Task(VarianceTask):
            def build_model(self):
                return DiffSingerVariance(self.hp, vocab_size=vocab, device="cpu")
    return Task(blob["hp"], device="cpu")


def dead_peer(rank: int, world: int, init_method: str, out: str, timeout_s: float) -> None:
    """Rank 1 leaves right after joining; rank 0 then all-reduces and
    records what it raised and after how long."""
    join_group(rank, world, init_method, timeout_s)
    from diffsinger_tpu_torch.parallel import dist

    dist.maybe_initialize_distributed("cpu")
    if rank == 1:
        os._exit(0)
    time.sleep(1.0)
    t0 = time.monotonic()
    try:
        dist.all_reduce_sum(torch.ones(3))
        outcome = "returned"
    except Exception:
        outcome = traceback.format_exc(limit=1)
    np.save(Path(out) / "dead_peer.npy", np.array([time.monotonic() - t0]))
    (Path(out) / "dead_peer.txt").write_text(outcome)
    os._exit(0)
