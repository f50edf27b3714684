"""Speaker-embedding surgery (counterpart of scripts/drop_spk.py):

    python -m diffsinger_tpu_torch.cli.drop_spk CKPT OUTPUT --spk ID [ID ...]
        [--mode zeros|random|mean|cyclic] [--seed N]

Edits the rows of the given speaker ids in every ``spk_embed`` table of a
port checkpoint (``utils/ckpt.py``'s layout: ``state_dict`` keys ending in
``spk_embed.weight``) and writes the result to OUTPUT:

* ``zeros``: the rows become 0;
* ``random``: normal draws scaled by ``hidden ** -0.5`` from numpy's
  ``default_rng(seed)``, as the JAX script draws them;
* ``mean``: the mean of the rows not edited;
* ``cyclic``: the j-th edited row takes the (j mod n)-th row not edited.

Everything else in the checkpoint is kept. Host work only: no card needed.
"""

from __future__ import annotations

import argparse
import pathlib
from typing import List, Optional

import numpy as np


def edit_rows(table: np.ndarray, spk: List[int], mode: str, rng: np.random.Generator) -> np.ndarray:
    """The table [n, h] with the rows of ``spk`` replaced as ``mode`` says."""
    table = np.array(table)
    n, h = table.shape
    others = [i for i in range(n) if i not in set(spk)]
    for j, s in enumerate(spk):
        assert 0 <= s < n, f"spk id {s} out of range [0, {n})"
        if mode == "zeros":
            table[s] = 0.0
        elif mode == "random":
            table[s] = rng.standard_normal(h).astype(table.dtype) * (h ** -0.5)
        elif mode == "mean":
            table[s] = table[others].mean(axis=0) if others else 0.0
        elif mode == "cyclic":
            table[s] = table[others[j % len(others)]] if others else 0.0
        else:
            raise ValueError(f"unknown mode {mode!r}")
    return table


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="python -m diffsinger_tpu_torch.cli.drop_spk",
                                     description="edit speaker embedding rows of a checkpoint")
    parser.add_argument("ckpt", type=pathlib.Path, help="input checkpoint (.ckpt)")
    parser.add_argument("output", type=pathlib.Path, help="output checkpoint path")
    parser.add_argument("--spk", type=int, nargs="+", required=True, help="speaker ids to edit")
    parser.add_argument("--mode", choices=["zeros", "random", "mean", "cyclic"], default="zeros")
    parser.add_argument("--seed", type=int, default=0)
    return parser


def main(argv: Optional[List[str]] = None) -> pathlib.Path:
    args = build_parser().parse_args(argv)
    import torch

    from diffsinger_tpu_torch.utils.ckpt import load_checkpoint

    blob = load_checkpoint(args.ckpt)
    state = blob.get("state_dict", blob)
    keys = [k for k in state if k.endswith("spk_embed.weight")]
    assert keys, "no speaker embedding found in checkpoint"
    rng = np.random.default_rng(args.seed)
    for key in keys:
        table = state[key]
        edited = edit_rows(table.detach().cpu().numpy(), args.spk, args.mode, rng)
        state[key] = torch.from_numpy(edited).to(table.dtype)
        print(f"| edited {key}: rows {args.spk} mode={args.mode}")
    args.output.parent.mkdir(parents=True, exist_ok=True)
    torch.save(blob, args.output)
    print(f"| saved: {args.output}")
    return args.output


if __name__ == "__main__":
    main()
