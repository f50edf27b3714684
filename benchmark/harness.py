"""What every cell's run shares: finding the cell's files by name, the run's
context, the guard against JAX, the reference's comparisons, the result.

A cell of ``BENCHMARK.json`` names a configuration (``configs/<config>.json``)
and a traffic mix (``traffic/<traffic>.json``); the mix names its driver
(``drivers/<driver>.py``), and each per-layer metric is read by
``metrics/<metric>.py``. Nothing here knows a cell by name.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "diffsinger_tpu")


def load_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return module


def forbidden_modules() -> List[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (``diffsinger_tpu_torch`` is not ``diffsinger_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


@dataclasses.dataclass
class Check:
    """One compared number: the run is correct only if ``value <= limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit  # NaN fails


@dataclasses.dataclass
class Run:
    """One run of a cell: what the driver gets, and what it fills in."""

    cell: dict
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    scratch: Path
    lowp: Optional[str] = None  # "fp8" / "tf32": the control replaces the program
    tracer: object = None
    instrument: object = None  # the driver's: opens its host ranges, returns its counts
    # filled by the driver
    window_start: float = 0.0
    attempted: int = 0
    failed: int = 0
    e2e: Dict[str, float] = dataclasses.field(default_factory=dict)
    layer: Dict = dataclasses.field(default_factory=dict)
    checks: List[Check] = dataclasses.field(default_factory=list)
    memory_peak_bytes: int = 0


def read_metrics(names: List[str], layer: Dict) -> Dict[str, dict]:
    """Each per-layer metric from its reader; a reader that finds nothing
    returns None and the metric is left out."""
    out = {}
    for name in names:
        reader = load_module(HERE / "metrics" / f"{name}.py", f"bench_metric_{len(out)}")
        value = reader.read(layer)
        if value is not None:
            out[name] = {"value": value, "unit": reader.UNIT}
    return out


def rel_rms(got, want) -> float:
    """||got - want|| / ||want|| over a whole array (float64)."""
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(np.sum((got - want) ** 2) / max(np.sum(want ** 2), 1e-30)))
