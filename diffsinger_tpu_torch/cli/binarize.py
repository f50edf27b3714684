"""Binarization entry point of the port (counterpart of scripts/binarize.py):

    python -m diffsinger_tpu_torch.cli.binarize --config CONFIG [--hparams k=v,...]
        [--device cpu]

It binarizes the config's ``datasets`` into ``binary_data_dir`` with the
binarizer that the config's ``binarizer_cls`` names (acoustic or variance).
The features are computed on the card unless ``--device cpu`` is given; it
raises when there is no card.
"""

from __future__ import annotations

import argparse
import time


def binarizer_class(binarizer_cls: str):
    """The port's binarizer for a config's ``binarizer_cls`` (a JAX package or
    reference class path), by class name."""
    name = binarizer_cls.rsplit(".", 1)[-1]
    if name == "AcousticBinarizer":
        from diffsinger_tpu_torch.data.acoustic_binarizer import AcousticBinarizer

        return AcousticBinarizer
    if name == "VarianceBinarizer":
        from diffsinger_tpu_torch.data.variance_binarizer import VarianceBinarizer

        return VarianceBinarizer
    raise ValueError(f"unknown binarizer {binarizer_cls!r}: AcousticBinarizer or VarianceBinarizer")


def binarize(hp: dict, device=None):
    """Binarize with the config's binarizer on ``device`` (the card unless
    named). Prints the seconds of binarization per second of audio and the
    stages' split, and returns the binarizer."""
    cls = binarizer_class(hp["binarizer_cls"])
    print("| Binarizer: ", cls)
    binarizer = cls(hp, device=device)
    t0 = time.perf_counter()
    binarizer.process()
    seconds = time.perf_counter() - t0
    audio = sum(t["seconds"] for t in binarizer.totals.values())
    items = sum(t["items"] for t in binarizer.totals.values())
    split = ", ".join(f"{k} {v:.2f} s" for k, v in binarizer.timer.seconds.items())
    print(f"| binarized {items} items, {audio:.1f} s of audio, in {seconds:.2f} s on "
          f"{binarizer.device}: {seconds / max(audio, 1e-9):.4f} s a second of audio ({split})")
    return binarizer


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description="binarize data")
    parser.add_argument("--config", type=str, required=True, help="training config file")
    parser.add_argument("--hparams", type=str, default="", help="k=v,k2=v2 overrides")
    parser.add_argument("--device", type=str, default=None,
                        help="device to compute the features on (default: the card)")
    args = parser.parse_args(argv)

    from diffsinger_tpu_torch.config import load_config

    binarize(load_config(args.config, args.hparams), device=args.device)


if __name__ == "__main__":
    main()
