#!/usr/bin/env python3
"""Rehearse chip_smoke.py's binarization phases on the CPU.

    python3 tools/rehearse_binarize_phase.py binarize_ext [--items 6] [--out DIR]
    python3 tools/rehearse_binarize_phase.py binarize [--items 40]

Runs ``binarize_phase`` or ``binarize_ext_phase`` as the script does, with
"cuda" mapped to the CPU: ``resolve_device`` returns the CPU in the modules
that imported it, ``torch.device("cuda")`` is the CPU, the CUDA memory,
synchronisation and cuFFT-plan calls are stubs, and ``DS_WORLD_BACKEND=device`` makes
``hnsep: world`` take the twin as on the card. It finds wrong paths, shapes
and control flow before a chip call. Every time, rate and idle share it
prints is a CPU number; the profiler sees no device there, and the
card-against-CPU checks compare the CPU with itself.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("phase", choices=("binarize", "binarize_ext"))
    parser.add_argument("--items", type=int, default=None,
                        help="phrases of the seeded corpus (default: 40 for binarize, 6 for "
                             "binarize_ext's rmvpe + vr runs, whose harvest + world run takes "
                             "the first chip_smoke.EXT_WORLD_ITEMS)")
    parser.add_argument("--out", type=Path, default=None,
                        help="folder for the phase's files and report (default: a new temporary one)")
    args = parser.parse_args(argv)
    os.environ.setdefault("DS_WORLD_BACKEND", "device")
    sys.path.insert(0, str(ROOT))

    import torch

    import chip_smoke
    import diffsinger_tpu_torch.utils as utils

    cpu = torch.device("cpu")

    def on_the_cpu(device=None):
        return cpu

    utils.resolve_device = on_the_cpu
    for name in ("diffsinger_tpu_torch.dsp.common", "diffsinger_tpu_torch.data.base_binarizer",
                 "diffsinger_tpu_torch.training.base_task", "diffsinger_tpu_torch.models.rmvpe"):
        __import__(name, fromlist=["_"]).resolve_device = on_the_cpu
    for stub, value in (("synchronize", None), ("reset_peak_memory_stats", None),
                        ("max_memory_allocated", 0), ("memory_allocated", 0),
                        ("empty_cache", None)):
        setattr(torch.cuda, stub, lambda *a, _v=value, **k: _v)
    torch.Tensor.cuda = lambda self, *a, **k: self
    torch.backends.cuda.cufft_plan_cache = {0: argparse.Namespace(size=0)}
    device_cls = torch.device

    class CpuForCuda:
        def __new__(cls, *a, **k):
            return device_cls("cpu") if a and a[0] == "cuda" else device_cls(*a, **k)

    torch.device = CpuForCuda
    out = args.out or Path(tempfile.mkdtemp(prefix="rehearse_"))
    out.mkdir(parents=True, exist_ok=True)
    chip_smoke.OUT_DIR = out
    if args.phase == "binarize":
        chip_smoke.BIN_ITEMS = args.items or 40
        chip_smoke.BIN_SECONDS = (2.0, 4.0)
        phase = chip_smoke.binarize_phase
    else:
        chip_smoke.EXT_ITEMS = args.items or 6
        phase = chip_smoke.binarize_ext_phase
    t0 = time.perf_counter()
    report, counts = phase("the CPU (a rehearsal, not a device number)", lambda: None,
                           lambda: {"K1": 0, "K2": 0, "K3": 0})
    print(f"[rehearsal] {args.phase} on the CPU in {time.perf_counter() - t0:.1f} s; launches "
          f"{counts}; report in {out / 'rehearsal.json'}")
    (out / "rehearsal.json").write_text(json.dumps(report, indent=1, default=str))


if __name__ == "__main__":
    main()
