"""Inference entry point of the port (counterpart of scripts/infer.py):

    python -m diffsinger_tpu_torch.cli.infer acoustic DS_FILE --exp EXP [options]
    python -m diffsinger_tpu_torch.cli.infer variance DS_FILE --exp EXP [options]

The same flags, checkpoint discovery (``checkpoints/<EXP>`` by name or prefix,
root overridable through ``DS_CKPT_ROOT``), key transposition and legacy
hparams migration as the JAX package's tool. It runs on the card unless
``--device cpu`` is given, and raises when there is no card.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import sys
from pathlib import Path
from collections import OrderedDict
from typing import List, Optional

root_dir = Path(__file__).resolve().parents[2]


def ckpt_root_dir() -> Path:
    """Checkpoints root: <repo>/checkpoints, overridable via DS_CKPT_ROOT."""
    return Path(os.environ.get("DS_CKPT_ROOT", "") or (root_dir / "checkpoints"))


def find_exp(exp: str) -> str:
    """Match the experiment folder by exact name or by prefix."""
    ckpt_root = ckpt_root_dir()
    if not (ckpt_root / exp).exists():
        for subdir in sorted(ckpt_root.iterdir()) if ckpt_root.exists() else []:
            if subdir.is_dir() and subdir.name.startswith(exp):
                print(f"| match ckpt by prefix: {subdir.name}")
                return subdir.name
        raise ValueError(
            f"There are no matching exp starting with '{exp}' in 'checkpoints' folder. "
            "Please specify '--exp' as the folder name or prefix."
        )
    print(f"| found ckpt by name: {exp}")
    return exp


def migrate_legacy_hparams(hp, infer_acoustic: bool = True):
    """Fill the keys that configs of older releases lack from the ones they had."""
    if "diff_speedup" not in hp and "pndm_speedup" in hp:
        hp["diff_speedup"] = hp["pndm_speedup"]
    if infer_acoustic:
        if "T_start" not in hp:
            hp["T_start"] = 1 - hp["K_step"] / hp["timesteps"]
        if "T_start_infer" not in hp:
            hp["T_start_infer"] = 1 - hp["K_step_infer"] / hp["timesteps"]
        if "sampling_steps" not in hp:
            if hp.get("use_shallow_diffusion", False):
                hp["sampling_steps"] = hp["K_step_infer"] // hp["diff_speedup"]
            else:
                hp["sampling_steps"] = hp["timesteps"] // hp["diff_speedup"]
    else:
        if "sampling_steps" not in hp:
            hp["sampling_steps"] = hp["timesteps"] // hp["diff_speedup"]
    if "time_scale_factor" not in hp:
        hp["time_scale_factor"] = hp["timesteps"]
    return hp


def apply_depth_steps_overrides(hp, depth, steps, acoustic: bool = True):
    if depth is not None:
        assert depth <= 1 - hp["T_start"], (
            f"Depth should not be larger than 1 - T_start ({1 - hp['T_start']})"
        )
        hp["K_step_infer"] = round(hp["timesteps"] * depth)
        hp["T_start_infer"] = 1 - depth
    if steps is not None:
        if acoustic and hp.get("use_shallow_diffusion", False):
            step_size = (1 - hp["T_start_infer"]) / steps
            if "K_step_infer" in hp:
                hp["diff_speedup"] = max(1, round(step_size * hp["K_step_infer"]))
        elif "timesteps" in hp:
            hp["diff_speedup"] = max(1, round(hp["timesteps"] / steps))
        hp["sampling_steps"] = steps
    return hp


def _load_ds(proj: pathlib.Path):
    with open(proj, "r", encoding="utf-8") as f:
        params = json.load(f)
    if not isinstance(params, list):
        params = [params]
    if not params:
        print("The input file is empty.")
        sys.exit(0)
    return params


def _ranged(kind, lo=None, hi=None):
    """argparse type: ``kind`` within [lo, hi]."""
    def parse(text):
        value = kind(text)
        if (lo is not None and value < lo) or (hi is not None and value > hi):
            raise argparse.ArgumentTypeError(f"{text} is not in the range [{lo}, {hi}]")
        return value
    return parse


def _ds_file(text) -> pathlib.Path:
    path = pathlib.Path(text).resolve()
    if not path.is_file():
        raise argparse.ArgumentTypeError(f"file '{text}' does not exist")
    return path


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m diffsinger_tpu_torch.cli.infer")
    sub = parser.add_subparsers(dest="command", required=True)

    ac = sub.add_parser("acoustic", help="Run DiffSinger acoustic model inference")
    ac.add_argument("proj", type=_ds_file, metavar="DS_FILE")
    ac.add_argument("--exp", type=str, required=True, metavar="EXP")
    ac.add_argument("--ckpt", type=_ranged(int, 0), metavar="STEPS")
    ac.add_argument("--spk", type=str)
    ac.add_argument("--lang", type=str)
    ac.add_argument("--out", type=pathlib.Path)
    ac.add_argument("--title", type=str)
    ac.add_argument("--num", type=_ranged(int, 1), default=1)
    ac.add_argument("--key", type=int, default=0, help="Key transition of pitch")
    ac.add_argument("--gender", type=_ranged(float, -1, 1))
    ac.add_argument("--seed", type=int, default=-1)
    ac.add_argument("--depth", type=_ranged(float, 0, 1))
    ac.add_argument("--steps", type=_ranged(int, 1))
    ac.add_argument("--mel", action="store_true",
                    help="Save intermediate mel format instead of waveform")
    ac.add_argument("--batch_size", type=_ranged(int, 1), default=1,
                    help="Serve segments in bucket-grouped batches of this size "
                         "(throughput mode; per-segment seeds are ignored)")
    ac.add_argument("--device", type=str, default=None,
                    help="'cpu' to run without a card; default: the card")

    var = sub.add_parser("variance", help="Run DiffSinger variance model inference")
    var.add_argument("proj", type=_ds_file, metavar="DS_FILE")
    var.add_argument("--exp", type=str, required=True, metavar="EXP")
    var.add_argument("--ckpt", type=_ranged(int, 0), metavar="STEPS")
    var.add_argument("--predict", type=str, action="append", default=[], metavar="TAGS")
    var.add_argument("--spk", type=str)
    var.add_argument("--lang", type=str)
    var.add_argument("--out", type=pathlib.Path)
    var.add_argument("--title", type=str)
    var.add_argument("--num", type=_ranged(int, 1), default=1)
    var.add_argument("--key", type=int, default=0)
    var.add_argument("--expr", type=_ranged(float, 0, 1))
    var.add_argument("--seed", type=int, default=-1)
    var.add_argument("--steps", type=_ranged(int, 1))
    var.add_argument("--batch_size", type=_ranged(int, 1), default=1,
                     help="serve segments in flag/bucket-grouped batches of up to this size")
    var.add_argument("--device", type=str, default=None,
                     help="'cpu' to run without a card; default: the card")
    return parser


def acoustic(args) -> None:
    proj = args.proj
    name = proj.stem if not args.title else args.title
    out = proj.parent if args.out is None else args.out
    params = _load_ds(proj)

    from diffsinger_tpu_torch.utils.infer_utils import parse_commandline_spk_mix, trans_key

    if args.key != 0:
        params = trans_key(params, args.key)
        if not args.title:
            name += "%+dkey" % args.key
        print(f"| key transition: {args.key:+d}")

    from diffsinger_tpu_torch.config import load_config

    hp = load_config(exp_name=find_exp(args.exp), infer=True, ckpt_root=ckpt_root_dir())
    hp = migrate_legacy_hparams(hp, infer_acoustic=True)
    hp = apply_depth_steps_overrides(hp, args.depth, args.steps, acoustic=True)

    spk_mix = (parse_commandline_spk_mix(args.spk)
               if hp["use_spk_id"] and args.spk is not None else None)
    for param in params:
        if args.gender is not None and hp.get("use_key_shift_embed", False):
            param["gender"] = args.gender
        if spk_mix is not None:
            param["spk_mix"] = spk_mix
        if args.lang is not None:
            param["lang"] = args.lang

    if args.batch_size > 1 and not args.mel:
        from diffsinger_tpu_torch.inference.serving import AcousticServer

        infer_ins = AcousticServer(hp, max_batch_size=args.batch_size, ckpt_steps=args.ckpt,
                                   device=args.device)
    else:
        from diffsinger_tpu_torch.inference.ds_acoustic import DiffSingerAcousticInfer

        infer_ins = DiffSingerAcousticInfer(hp, load_vocoder=not args.mel, ckpt_steps=args.ckpt,
                                            device=args.device)
    print(f"| Model: {type(infer_ins.model)}")
    try:
        infer_ins.run_inference(
            params, out_dir=out, title=name, num_runs=args.num,
            spk_mix=spk_mix, seed=args.seed, save_mel=args.mel,
            steps=hp.get("sampling_steps") if args.steps is None else args.steps,
        )
    except KeyboardInterrupt:
        sys.exit(-1)


def variance(args) -> None:
    proj = args.proj
    name = proj.stem if not args.title else args.title
    out = proj.parent if args.out is None else args.out
    if (not out or out.resolve() == proj.parent.resolve()) and not args.title:
        name += "_variance"
    params = [OrderedDict(p) for p in _load_ds(proj)]

    from diffsinger_tpu_torch.utils.infer_utils import parse_commandline_spk_mix, trans_key

    if args.key != 0:
        params = trans_key(params, args.key)
        if not args.title:
            name += "%+dkey" % args.key
        print(f"| key transition: {args.key:+d}")

    from diffsinger_tpu_torch.config import load_config

    hp = load_config(exp_name=find_exp(args.exp), infer=True, ckpt_root=ckpt_root_dir())
    hp = migrate_legacy_hparams(hp, infer_acoustic=False)
    hp = apply_depth_steps_overrides(hp, None, args.steps, acoustic=False)

    spk_mix = (parse_commandline_spk_mix(args.spk)
               if hp["use_spk_id"] and args.spk is not None else None)
    for param in params:
        if args.expr is not None:
            param["expr"] = args.expr
        if spk_mix is not None:
            param["ph_spk_mix_backup"] = param.get("ph_spk_mix")
            param["spk_mix_backup"] = param.get("spk_mix")
            param["ph_spk_mix"] = param["spk_mix"] = spk_mix
        if args.lang is not None:
            param["lang"] = args.lang

    kwargs = dict(ckpt_steps=args.ckpt, predictions=set(args.predict), device=args.device)
    if args.batch_size > 1:
        from diffsinger_tpu_torch.inference.serving import VarianceServer

        infer_ins = VarianceServer(hp, max_batch_size=args.batch_size, **kwargs)
    else:
        from diffsinger_tpu_torch.inference.ds_variance import DiffSingerVarianceInfer

        infer_ins = DiffSingerVarianceInfer(hp, **kwargs)
    print(f"| Model: {type(infer_ins.model)}")
    try:
        infer_ins.run_inference(params, out_dir=out, title=name, num_runs=args.num,
                                seed=args.seed)
    except KeyboardInterrupt:
        sys.exit(-1)


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    if args.command == "variance":
        variance(args)
    else:
        acoustic(args)


if __name__ == "__main__":
    main()
