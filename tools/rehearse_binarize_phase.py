#!/usr/bin/env python3
"""Rehearse chip_smoke.py's binarization and pipeline phases on the CPU.

    python3 tools/rehearse_binarize_phase.py binarize_ext [--items 6] [--out DIR]
    python3 tools/rehearse_binarize_phase.py binarize [--items 40]
    python3 tools/rehearse_binarize_phase.py pipeline [--items 40]

Runs ``binarize_phase``, ``binarize_ext_phase`` or ``pipeline_phase`` as the
script does, with "cuda" mapped to the CPU: ``resolve_device`` returns the
CPU in the modules that imported it, ``torch.device("cuda")`` is the CPU
(but for the pipeline, which names no device), the CUDA memory,
synchronisation and cuFFT-plan calls are stubs, and
``DS_WORLD_BACKEND=device`` makes ``hnsep: world`` take the twin as on the
card. It finds wrong paths, shapes
and control flow before a chip call. Every time, rate and idle share it
prints is a CPU number; the profiler sees no device there, and the
card-against-CPU checks compare the CPU with itself. The pipeline runs
narrow models (``NARROW``) over phrases of 2-4 s with a 32-channel vocoder,
and its launch checks, which read 0 on the CPU, log instead of failing.
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
# the pipeline's models at rehearsal widths (config keys on top of the shipped ones)
NARROW = {
    "acoustic": dict(hidden_size=32, enc_layers=2, sampling_steps=2, max_batch_frames=2000,
                     backbone_args=dict(num_channels=32, num_layers=2, kernel_size=31,
                                        dropout_rate=0.0, strong_cond=True),
                     shallow_diffusion_args=dict(aux_decoder_args=dict(
                         num_channels=16, num_layers=1, kernel_size=7, dropout_rate=0.1))),
    "variance": dict(hidden_size=32, enc_layers=2, sampling_steps=2, max_batch_frames=2000,
                     dur_prediction_args=dict(hidden_size=32, num_layers=2),
                     pitch_prediction_args=dict(backbone_args=dict(
                         num_layers=2, num_channels=32, dilation_cycle_length=2)),
                     variances_prediction_args=dict(backbone_args=dict(
                         num_layers=2, num_channels=32, dilation_cycle_length=2))),
}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("phase", choices=("binarize", "binarize_ext", "pipeline"))
    parser.add_argument("--items", type=int, default=None,
                        help="phrases of the seeded corpus (default: 40 for binarize and "
                             "pipeline, 6 for binarize_ext's rmvpe + vr runs, whose harvest + "
                             "world run takes "
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
    for name in ("dsp.common", "data.base_binarizer", "training.base_task", "models.rmvpe",
                 "models.toplevel", "inference.ds_acoustic", "inference.ds_variance",
                 "deployment.runtime", "deployment.exporters", "vocoders.nsf_hifigan",
                 "vocoders.nsf_hifigan_model"):
        __import__("diffsinger_tpu_torch." + name, fromlist=["_"]).resolve_device = on_the_cpu
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

    if args.phase != "pipeline":  # torch.export's tracer needs the real class
        torch.device = CpuForCuda
    out = args.out or Path(tempfile.mkdtemp(prefix="rehearse_"))
    out.mkdir(parents=True, exist_ok=True)
    chip_smoke.OUT_DIR = out
    if args.phase == "binarize":
        chip_smoke.BIN_ITEMS = args.items or 40
        chip_smoke.BIN_SECONDS = (2.0, 4.0)
        phase = chip_smoke.binarize_phase
    elif args.phase == "binarize_ext":
        chip_smoke.EXT_ITEMS = args.items or 6
        phase = chip_smoke.binarize_ext_phase
    else:
        chip_smoke.PIPE_ITEMS = args.items or 40
        chip_smoke.BIN_SECONDS = (2.0, 4.0)
        chip_smoke.PIPE_CONFIG = NARROW
        chip_smoke.VOCODER_CHANNELS = 32
        chip_smoke.fail = lambda msg: print(f"FAIL (logged): {msg}", flush=True)
        phase = chip_smoke.pipeline_phase
    t0 = time.perf_counter()
    report, counts = phase("the CPU (a rehearsal, not a device number)", lambda: None,
                           lambda: {"K1": 0, "K2": 0, "K3": 0})
    print(f"[rehearsal] {args.phase} on the CPU in {time.perf_counter() - t0:.1f} s; launches "
          f"{counts}; report in {out / 'rehearsal.json'}")
    (out / "rehearsal.json").write_text(json.dumps(report, indent=1, default=str))


if __name__ == "__main__":
    main()
