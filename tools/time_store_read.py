#!/usr/bin/env python3
"""Time the port's HDF5 store codec against h5py on one store, on the host.

    python3 tools/time_store_read.py [--items 2000] [--out DIR]

Writes a store of acoustic items shaped as ``configs/acoustic.yaml``'s
binarizer makes them (a phrase of 3-12 s: mel [T, 128] float32, f0, energy,
breathiness, voicing and tension [T] float32, mel2ph [T] and tokens int64,
spk_id, key_shift and speed scalars) twice, with ``hdf5.Writer`` and with
h5py as the JAX package's builder writes it, then reads every item of each
file in turns (port, h5py, h5py, port) through ``IndexedDataset`` and
through h5py as the JAX package's ``IndexedDataset`` reads it. Prints
microseconds an item for each and the store's MB; the page cache is warm
(the files were just written), as it is for a store read epoch after epoch.
Needs h5py; these are host (CPU) times.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def items(n: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    for i in range(n):
        t = int(rng.integers(258, 1034))  # 3-12 s at 44.1 kHz, hop 512
        n_tok = t // 12
        yield {"spk_id": i % 3, "mel": rng.standard_normal((t, 128)).astype(np.float32),
               "tokens": rng.integers(1, 60, n_tok), "mel2ph": np.sort(rng.integers(1, n_tok, t)),
               "f0": rng.uniform(100, 500, t).astype(np.float32),
               **{v: rng.uniform(-60, -10, t).astype(np.float32)
                  for v in ("energy", "breathiness", "voicing", "tension")},
               "key_shift": 0.0, "speed": 1.0}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--items", type=int, default=2000)
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import h5py

    from diffsinger_tpu_torch.data.indexed_datasets import IndexedDataset, IndexedDatasetBuilder

    out = args.out or Path(tempfile.mkdtemp(prefix="store_"))
    (out / "port").mkdir(parents=True, exist_ok=True)
    (out / "h5py").mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    builder = IndexedDatasetBuilder(out / "port", "train")
    for it in items(args.items):
        builder.add_item(it)
    builder.finalize()
    write_port = time.perf_counter() - t0
    t0 = time.perf_counter()
    with h5py.File(out / "h5py" / "train.data", "w") as f:
        for i, it in enumerate(items(args.items)):
            for k, v in it.items():
                f.create_dataset(f"{i}/{k}", data=v)
    write_h5py = time.perf_counter() - t0

    def read_port(folder):
        ds = IndexedDataset(folder, "train")
        return [ds[i] for i in range(len(ds))]

    def read_h5py(folder):  # the JAX package's IndexedDataset
        with h5py.File(folder / "train.data", "r") as f:
            return [{k: (v[()].item() if v.shape == () else np.asarray(v[()]))
                     for k, v in f[str(i)].items()} for i in range(len(f))]

    times = {}
    for name, fn in (("port", read_port), ("h5py", read_h5py), ("h5py", read_h5py),
                     ("port", read_port)):
        for folder in ("port", "h5py"):
            t0 = time.perf_counter()
            got = fn(out / folder)
            times.setdefault(f"{name} reads {folder}'s file", []).append(
                (time.perf_counter() - t0) / len(got) * 1e6)
    report = {
        "items": args.items,
        "store_mb": {k: (out / k / "train.data").stat().st_size / 1e6 for k in ("port", "h5py")},
        "write_us_per_item": {"port": write_port / args.items * 1e6,
                              "h5py": write_h5py / args.items * 1e6},
        "read_us_per_item": {k: min(v) for k, v in times.items()},
        "read_us_per_item_runs": times,
    }
    print(json.dumps(report, indent=1))


if __name__ == "__main__":
    main()
