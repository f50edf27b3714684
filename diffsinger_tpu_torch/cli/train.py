"""Training entry point of the port (counterpart of scripts/train.py):

    python -m diffsinger_tpu_torch.cli.train --config CONFIG --exp_name EXP
        [--hparams k=v,...] [--reset] [--max_steps N] [--infer] [--profile N]
        [--ckpt_root DIR] [--device cpu]

It trains the task that the config's ``task_cls`` names (the acoustic or the
variance model) in ``<ckpt_root>/<EXP>``, resuming from the newest checkpoint
there. It runs on the card unless ``--device cpu`` is given, and raises when
there is no card. Three ways to run:

* under ``torchrun`` (``torchrun --nproc_per_node N -m
  diffsinger_tpu_torch.cli.train ...``) or the JAX package's launch contract
  (``DS_COORDINATOR_ADDRESS``, ``DS_NUM_PROCESSES``, ``DS_PROCESS_ID``), each
  process joins the group as one rank: NCCL on the cards, gloo with
  ``--device cpu``;
* otherwise, when ``pl_trainer_devices`` picks more than one card (``auto``:
  every visible one), it starts one rank per card itself (``spawn``, a group
  over ``tcp://localhost``);
* otherwise one process on one device.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
from pathlib import Path

import torch

root_dir = Path(__file__).resolve().parents[2]


def task_class(task_cls: str):
    """The port's task for a config's ``task_cls`` (a JAX package or reference
    class path), by class name."""
    name = task_cls.rsplit(".", 1)[-1]
    if name == "AcousticTask":
        from diffsinger_tpu_torch.training.acoustic_task import AcousticTask

        return AcousticTask
    if name == "VarianceTask":
        from diffsinger_tpu_torch.training.variance_task import VarianceTask

        return VarianceTask
    raise ValueError(f"unknown task {task_cls!r}: AcousticTask or VarianceTask")


def run_rank(rank: int, world_size: int, init_method: str, device_indices, argv) -> None:
    """One rank of a run that ``main`` spawned: the launch contract in the
    environment, then ``main``."""
    os.environ.update(DS_COORDINATOR_ADDRESS=init_method, DS_NUM_PROCESSES=str(world_size),
                      DS_PROCESS_ID=str(rank), DS_LOCAL_RANK=str(device_indices[rank]))
    main(argv)


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def main(argv=None):
    parser = argparse.ArgumentParser(description="train a DiffSinger model")
    parser.add_argument("--config", type=str, default="", help="training config file")
    parser.add_argument("--exp_name", type=str, default="", help="experiment name")
    parser.add_argument("--hparams", type=str, default="", help="k=v,k2=v2 overrides")
    parser.add_argument("--reset", action="store_true", help="ignore saved work-dir config")
    parser.add_argument("--max_steps", type=int, default=None, help="override max_updates")
    parser.add_argument("--infer", action="store_true",
                        help="run validation over the valid set only")
    parser.add_argument("--profile", type=int, default=0, metavar="N",
                        help="trace N training steps (after warmup) with torch.profiler "
                             "into <work_dir>/profile")
    parser.add_argument("--ckpt_root", type=str, default="",
                        help="checkpoints root directory (default: <repo>/checkpoints)")
    parser.add_argument("--device", type=str, default=None,
                        help="device to train on (default: the card; with a launcher, "
                             "this rank's card)")
    args = parser.parse_args(argv)

    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.parallel import dist

    def config(write_snapshot=True):
        return load_config(args.config, args.hparams, exp_name=args.exp_name, infer=args.infer,
                           reset=args.reset, ckpt_root=args.ckpt_root or (root_dir / "checkpoints"),
                           write_snapshot=write_snapshot)

    if dist.launcher_env() is None:
        hp = config()
        on_card = args.device in (None, "cuda") and torch.cuda.is_available()
        if on_card and not args.infer:
            from diffsinger_tpu_torch.parallel.mesh import local_devices

            devices = local_devices(hp.get("pl_trainer_devices", "auto"))
            if len(devices) > 1:
                from diffsinger_tpu_torch.ops import native

                native.build()  # once, before the ranks load the kernels
                print(f"| training on {len(devices)} cards, one process each")
                dist.spawn(run_rank, len(devices),
                           (len(devices), f"tcp://localhost:{_free_port()}",
                            [d.index for d in devices],
                            sys.argv[1:] if argv is None else list(argv)))
                return None
        device = args.device
    else:
        device = dist.maybe_initialize_distributed(args.device)
        if dist.is_main_process():  # it writes the work dir's config snapshot first
            hp = config()
            dist.barrier()
        else:
            dist.barrier()
            hp = config(write_snapshot=False)
    try:
        if args.profile:
            hp["profile_steps"] = args.profile
        cls = task_class(hp["task_cls"])
        if dist.is_main_process():
            print("| Task: ", cls)
        # as the reference's seed_everything: the initial weights come from the seed
        # (over ranks DDP then broadcasts rank 0's)
        torch.manual_seed(hp.get("seed") or 0)
        task = cls(hp, device=device)
        if args.infer:
            task.configure_optimizer()
            task.init_or_resume()
            _, valid_ds = task.build_datasets()
            task.run_validation(valid_ds)
            return task
        task.start(max_steps=args.max_steps)
        return task
    finally:
        dist.destroy()


if __name__ == "__main__":
    main()
