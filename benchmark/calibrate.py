"""Readings for the limits of ``correct``, for one cell, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... --control-seeds 1,2,3 \
        [--faults step_unchanged,answer_altered --fault-seeds 1,2,3] [--seconds 3] \
        [--out chiprun_out/calibrate.json]

For each seed of ``--seeds`` a short run of the program at the cell's own
load, checked against the reference as a run checks it (the lower
readings); for each seed of ``--control-seeds`` the same with the control,
the reference one precision below the configuration's, in the program's
place (the upper readings); for each fault of ``--faults`` (``faults.py``)
and each seed of ``--fault-seeds`` the program with that fault planted at the
cell's own widths. Prints and writes every compared number of every run. The
benchmark's own runs never run the control or a fault.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

CONTROL = {"bf16": "fp8", "float32": "tf32"}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    parser.add_argument("--faults", default="")
    parser.add_argument("--fault-seeds", default="")
    parser.add_argument("--seconds", type=float, default=3.0)
    parser.add_argument("--out", default=None)
    args = parser.parse_args()

    import torch

    from benchmark import faults, harness, run as bench_run

    device = torch.device("cuda", 0)
    bench = harness.benchmark()
    cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
    config = harness.load_json(harness.HERE / "configs" / f"{cell['config']}.json")
    lowp = CONTROL[config["precision"]]
    rows = []
    seeds = lambda text: [int(s) for s in text.split(",") if s]  # noqa: E731
    plan = [(s, None, None) for s in seeds(args.seeds)]
    plan += [(s, lowp, None) for s in seeds(args.control_seeds)]
    plan += [(s, None, f) for f in args.faults.split(",") if f for s in seeds(args.fault_seeds)]
    for seed, control, fault in plan:
        t0 = time.perf_counter()
        patches = faults.Patches()
        if fault:
            faults.plant(fault, patches.set)
        try:
            run = bench_run.execute(args.workload, seed, args.seconds, False, device,
                                    lowp=control)
        finally:
            patches.undo()
        row = {"seed": seed, "control": control, "fault": fault, "attempted": run.attempted,
               "song_s_per_s": run.e2e.get("song_s_per_s"),
               "seconds": time.perf_counter() - t0,
               "compared": {c.name: c.value for c in run.checks},
               "phrases": run.layer.get("phrase_wav_rel_rms"),
               "leaves_left_out": run.layer.get("leaves_left_out")}
        rows.append(row)
        print(json.dumps(row), flush=True)
    summary = {}
    whos = {"program": lambda r: r["control"] is None and r["fault"] is None,
            "control": lambda r: r["control"] is not None}
    whos.update({f: (lambda r, f=f: r["fault"] == f) for f in args.faults.split(",") if f})
    for who, mine in whos.items():
        picked = [r for r in rows if mine(r)]
        for name in (picked[0]["compared"] if picked else {}):
            values = [r["compared"][name] for r in picked]
            summary[f"{who}.{name}"] = {"max": max(values), "min": min(values), "n": len(values)}
    print(json.dumps({"summary": summary, "card": torch.cuda.get_device_name(0)}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"rows": rows, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
