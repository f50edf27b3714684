#!/usr/bin/env python3
"""Run some of chip_smoke.py's phases alone on the card.

    python3 tools/chip_phases.py train_remat pipeline

Builds the kernel libraries as ``chip_smoke.py`` does, then runs each named
phase (``train_remat``, ``pipeline``) with the script's own function, launch
counters and checks, and writes their reports to
``chiprun_out/chip_phases.json``. A quicker check of those phases than the
whole script, which runs every phase; exits non-zero when a phase fails.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PHASES = ("train_remat", "pipeline")


def main(argv=None) -> None:
    names = list(sys.argv[1:] if argv is None else argv) or list(PHASES)
    unknown = [n for n in names if n not in PHASES]
    if unknown:
        raise SystemExit(f"unknown phases {unknown}: choose from {PHASES}")
    import torch

    import chip_smoke
    from diffsinger_tpu_torch.ops import depthwise_conv, flash_attention, lynx_fused, native

    if not torch.cuda.is_available():
        chip_smoke.fail("CUDA is not available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() \
        else "nvidia-smi unavailable"
    chip_smoke.log(card)
    counters = {"K1": depthwise_conv, "K2": lynx_fused, "K3": flash_attention}

    def reset_counts():
        for m in counters.values():
            m.launches = 0
        flash_attention.bwd_launches = 0

    def read_counts():
        return {k: m.launches for k, m in counters.items()}

    t0 = time.perf_counter()
    native.build()
    for name in native.KERNEL_SOURCES:
        native.load(name)
    report = {"card": card, "build_s": time.perf_counter() - t0, "phases": {}, "seconds": {}}
    chip_smoke.OUT_DIR.mkdir(exist_ok=True)
    run = {"train_remat": lambda: chip_smoke.train_remat_phase(card, reset_counts, read_counts),
           "pipeline": lambda: chip_smoke.pipeline_phase(card, reset_counts, read_counts)}
    for name in names:
        t0 = time.perf_counter()
        report["phases"][name] = run[name]()[0]
        report["seconds"][name] = time.perf_counter() - t0
        chip_smoke.log(f"[chip_phases] {name} took {report['seconds'][name]:.1f} s on {card}")
    (chip_smoke.OUT_DIR / "chip_phases.json").write_text(json.dumps(report, indent=1, default=str))
    chip_smoke.log(card)


if __name__ == "__main__":
    main()
