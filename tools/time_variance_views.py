"""The exported variance views against their eager calls in a fresh process.

``chip_smoke.py`` times the linguistic, pitch and variance ``.pt2`` views
in turns with eager inside its long process, after every other phase. This
script does the same from a process that has run nothing else: it builds
the kernels, writes ``configs/variance.yaml`` at full width with all four
variances and seeded weights (``chip_smoke.write_variance_experiment``),
exports the ``.pt2`` views on the card at the bucket (64, 512), warms each
route twice and times a [1, 56]-phoneme score at 20 steps in turns (eager,
``.pt2``, ``.pt2``, eager; three requests each). It prints one line for
each view and writes ``chiprun_out/variance_views_fresh.json``.

    python3 tools/time_variance_views.py   # on a machine with a CUDA card
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

BUCKET = (64, 512)


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        sys.exit("CUDA is not available")
    from diffsinger_tpu_torch.config import load_config
    from diffsinger_tpu_torch.deployment.exporters import DiffSingerVarianceExporter
    from diffsinger_tpu_torch.deployment.runtime import VarianceArtifactRuntime
    from diffsinger_tpu_torch.ops import native

    t_start = time.perf_counter()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip() or "nvidia-smi unavailable"
    native.build()
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        name, _, _ = chip_smoke.write_variance_experiment(root)
        hp = load_config(exp_name=name, infer=True, ckpt_root=root / "checkpoints")
        exporter = DiffSingerVarianceExporter(hp, root / "variance", buckets=(BUCKET,),
                                              fmt="pt2", device="cuda")
        chip_smoke.quiet(exporter.export)
        rt = VarianceArtifactRuntime(root / "variance", device="cuda")
        req = chip_smoke.variance_request(56, seed=31)
        calls = chip_smoke.variance_view_calls(exporter.model, rt, req, *BUCKET)
        for _ in range(2):  # first calls: cuDNN's plans, the programs' lazy set-up
            enc, _, bucket = calls["pt2_encode"]()
            enc_e, _ = calls["eager_encode"]()
            pitch = calls["pt2_pitch"](enc, bucket)
            calls["eager_pitch"](enc_e)
            calls["pt2_variance"](enc, pitch, bucket)
        turns = chip_smoke.variance_view_turns(calls, BUCKET[1])
    report = {"card": card, "request": [req["tokens"].shape[1], req["pitch"].shape[1]],
              "steps": int(rt.manifest["sampling_steps"]), "views": {}}
    for view, r in turns.items():
        ratio = r["mean"]["pt2"] / r["mean"]["eager"]
        report["views"][view] = dict(r, ratio_of_means=ratio)
        print(f"{view}: .pt2 {r['mean']['pt2'] * 1e3:.2f} ms mean "
              f"({r['best']['pt2'] * 1e3:.2f} best), eager {r['mean']['eager'] * 1e3:.2f} ms "
              f"mean ({r['best']['eager'] * 1e3:.2f} best), .pt2 / eager {ratio:.3f} on {card}")
    report["seconds"] = time.perf_counter() - t_start
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "variance_views_fresh.json").write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
