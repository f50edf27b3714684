"""Training entry point of the port (counterpart of scripts/train.py):

    python -m diffsinger_tpu_torch.cli.train --config CONFIG --exp_name EXP
        [--hparams k=v,...] [--reset] [--max_steps N] [--infer] [--profile N]
        [--ckpt_root DIR] [--device cpu]

It trains the task that the config's ``task_cls`` names (the acoustic or the
variance model) in ``<ckpt_root>/<EXP>``, resuming from the newest checkpoint
there. It runs on the card unless ``--device cpu`` is given, and raises when
there is no card.
"""

from __future__ import annotations

import argparse
from pathlib import Path

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


def main(argv=None) -> None:
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
                        help="device to train on (default: the card)")
    args = parser.parse_args(argv)

    from diffsinger_tpu_torch.config import load_config

    hp = load_config(args.config, args.hparams, exp_name=args.exp_name, infer=args.infer,
                     reset=args.reset, ckpt_root=args.ckpt_root or (root_dir / "checkpoints"))
    if args.profile:
        hp["profile_steps"] = args.profile
    cls = task_class(hp["task_cls"])
    print("| Task: ", cls)
    task = cls(hp, device=args.device)
    if args.infer:
        task.configure_optimizer()
        task.init_or_resume()
        _, valid_ds = task.build_datasets()
        task.run_validation(valid_ds)
        return
    task.start(max_steps=args.max_steps)


if __name__ == "__main__":
    main()
