"""Export entry point of the port (counterpart of scripts/export.py):

    python -m diffsinger_tpu_torch.cli.export acoustic --exp EXP [options]
    python -m diffsinger_tpu_torch.cli.export variance --exp EXP [options]
    python -m diffsinger_tpu_torch.cli.export nsf-hifigan --config CONFIG [options]

``acoustic`` writes the acoustic model's bundle (``.pt2`` programs that run
the hand-written kernels on the card, and/or ONNX graphs, with
``dsconfig.yaml`` and the attachments) to ``--out`` (default
``artifacts/<EXP>``); ``variance`` the variance model's (its linguistic,
pitch and variance views); ``nsf-hifigan`` the vocoder's (``vocoder.yaml``).
The experiment lookup is ``cli.infer``'s (``checkpoints/<EXP>`` by name or
prefix, root overridable through ``DS_CKPT_ROOT``). A ``.pt2`` runs on the
device it was exported on: the card unless ``--device cpu`` is given, and an
error when there is no card.
"""

from __future__ import annotations

import argparse
import pathlib
from typing import List, Optional

from diffsinger_tpu_torch.cli.infer import (
    _ranged, ckpt_root_dir, find_exp, migrate_legacy_hparams, root_dir)
from diffsinger_tpu_torch.config import load_config
from diffsinger_tpu_torch.deployment.exporters import (
    BaseExporter, DiffSingerAcousticExporter, DiffSingerVarianceExporter, NSFHiFiGANExporter)


def parse_buckets(value: Optional[str]):
    """'64x512,128x1024' -> [(64, 512), (128, 1024)]; '256,512' -> [256, 512]."""
    if not value:
        return None
    buckets = []
    for part in value.split(","):
        dims = [int(d) for d in part.strip().split("x")]
        buckets.append(tuple(dims) if len(dims) > 1 else dims[0])
    return buckets


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m diffsinger_tpu_torch.cli.export")
    sub = parser.add_subparsers(dest="command", required=True)

    def common(p, buckets_help):
        p.add_argument("--out", type=pathlib.Path)
        p.add_argument("--buckets", type=str, help=buckets_help)
        p.add_argument("--format", dest="fmt", choices=BaseExporter.FORMATS, default="pt2",
                       help="artifact format (onnx = OpenUTAU-style graphs)")
        p.add_argument("--device", type=str, default=None,
                       help="the device the .pt2 programs will run on; 'cpu' to export "
                            "without a card; default: the card")

    ac = sub.add_parser("acoustic", help="Export DiffSinger acoustic model")
    ac.add_argument("--exp", type=str, required=True, metavar="EXP")
    ac.add_argument("--ckpt", type=_ranged(int, 0), metavar="STEPS")
    ac.add_argument("--freeze_gender", type=_ranged(float, -1, 1),
                    help="(for random pitch shifting) freeze this gender value into the "
                         "model instead of exposing a runtime `gender` input")
    ac.add_argument("--freeze_velocity", action="store_true",
                    help="(for random time stretching) freeze the default velocity "
                         "instead of exposing a runtime `velocity` input")
    ac.add_argument("--export_spk", type=str, action="append", default=[],
                    help="(multi-speaker) speaker or 'alias=mix' to export as .emb; "
                         "repeatable")
    ac.add_argument("--freeze_spk", type=str,
                    help="(multi-speaker) speaker or 'alias=mix' to freeze into the model")
    common(ac, "shape set, e.g. '64x512,128x1024' (t_txt x t_mel per bucket)")

    var = sub.add_parser("variance", help="Export DiffSinger variance model")
    var.add_argument("--exp", type=str, required=True, metavar="EXP")
    var.add_argument("--ckpt", type=_ranged(int, 0), metavar="STEPS")
    var.add_argument("--freeze_expr", action="store_true",
                     help="freeze the pitch expressiveness instead of exposing a runtime "
                          "`expr` input")
    var.add_argument("--freeze_glide", action="store_true",
                     help="(melody encoder with glide embeds) freeze glide 'none' instead "
                          "of exposing a runtime `note_glide` input")
    var.add_argument("--export_spk", type=str, action="append", default=[],
                     help="(multi-speaker) speaker or 'alias=mix' to export as .emb; "
                          "repeatable")
    var.add_argument("--freeze_spk", type=str,
                     help="(multi-speaker) speaker or 'alias=mix' to freeze into the model")
    common(var, "shape set, e.g. '64x512,128x1024' (t_ph x t_mel per bucket)")

    voc = sub.add_parser("nsf-hifigan", help="Export NSF-HiFiGAN vocoder")
    voc.add_argument("--config", type=pathlib.Path, required=True,
                     help="config file with vocoder_ckpt")
    common(voc, "mel-length set, e.g. '256,512,1024'")
    return parser


def acoustic(args) -> None:
    if args.export_spk and args.freeze_spk:
        raise SystemExit("--export_spk is exclusive to --freeze_spk.")
    exp = find_exp(args.exp)
    hp = load_config(exp_name=exp, infer=True, ckpt_root=ckpt_root_dir())
    hp = migrate_legacy_hparams(hp, infer_acoustic=True)
    DiffSingerAcousticExporter(
        hp, args.out or (root_dir / "artifacts" / exp), ckpt_steps=args.ckpt,
        freeze_gender=args.freeze_gender, freeze_velocity=args.freeze_velocity,
        export_spk=list(args.export_spk), freeze_spk=args.freeze_spk,
        buckets=parse_buckets(args.buckets), fmt=args.fmt, device=args.device,
    ).export()


def variance(args) -> None:
    if args.export_spk and args.freeze_spk:
        raise SystemExit("--export_spk is exclusive to --freeze_spk.")
    exp = find_exp(args.exp)
    hp = load_config(exp_name=exp, infer=True, ckpt_root=ckpt_root_dir())
    hp = migrate_legacy_hparams(hp, infer_acoustic=False)
    DiffSingerVarianceExporter(
        hp, args.out or (root_dir / "artifacts" / exp), ckpt_steps=args.ckpt,
        freeze_expr=args.freeze_expr, freeze_glide=args.freeze_glide,
        export_spk=list(args.export_spk), freeze_spk=args.freeze_spk,
        buckets=parse_buckets(args.buckets), fmt=args.fmt, device=args.device,
    ).export()


def nsf_hifigan(args) -> None:
    if not args.config.is_file():
        raise SystemExit(f"config file not found: {args.config}")
    hp = load_config(args.config, infer=True)
    NSFHiFiGANExporter(hp, args.out or (root_dir / "artifacts" / "nsf_hifigan"),
                       buckets=parse_buckets(args.buckets), fmt=args.fmt,
                       device=args.device).export()


def main(argv: Optional[List[str]] = None) -> None:
    args = build_parser().parse_args(argv)
    {"acoustic": acoustic, "variance": variance, "nsf-hifigan": nsf_hifigan}[args.command](args)


if __name__ == "__main__":
    main()
