"""Guards: nothing of the benchmark imports JAX or the JAX package, the
reference imports nothing of the program, and a run's last line has the
contract's keys, or the run prints no line at all."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import harness
from benchmark.run import result_line

HERE = Path(__file__).resolve().parent.parent
PY_FILES = sorted(HERE.rglob("*.py"))


def imported_top_names(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"))):
        if isinstance(node, ast.Import):
            names.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", PY_FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_imports(path):
    assert not imported_top_names(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = imported_top_names(path)
    assert "diffsinger_tpu_torch" not in names and "benchmark" not in names


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "diffsinger_tpu_torch.fake_leaf", object())
    assert "diffsinger_tpu_torch" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.fake_leaf", object())
    assert "jaxlib" in harness.forbidden_modules()


def fake_run(trace: bool, cell_name: str = None) -> harness.Run:
    bench = harness.benchmark()
    cell = next(w for w in bench["workloads"] if cell_name in (None, w["name"]))
    run = harness.Run(cell=cell, config={}, mix={}, seed=1, seconds=1.0, trace=trace,
                      device=torch.device("cpu"), scratch=Path("."))
    run.attempted = 3
    run.e2e = {"song_s_per_s": 123.0, "train_frames_per_s": 4e4, "setup_s": 4.5}
    run.layer = {"counts": {"padded_frames": 100, "true_frames": 80, "lynx_least_s": 0.2},
                 "window_s": 1.0,
                 "song_s": 2.0, "true_flops": 1e12, "peak_flops": 989e12, "wait_s": 0.01,
                 "peak_mem_bytes": 2**33,
                 "trace": {"window_s": 1.0, "busy_s": 0.7,
                           "device_s": {"lynxnet.convmodule": 0.4, "vocoder": 0.3, "wavenet": 0.5},
                           "device_ops": [["k", 0.5]], "idle_gaps": [["server.request", 0.3]]}}
    run.checks = [harness.Check("x", 0.1, 0.2)]
    return run


CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace, cell):
    bench = harness.benchmark()
    out = result_line(fake_run(trace, cell), bench, "NVIDIA H100 80GB HBM3", 1)
    keys = list(out)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "compared" and set(keys) <= {
        "correct", "attempted", "failed", "metrics", "device", "breakdown", "compared"}
    assert out["correct"] is True
    dev = {"platform", "kind", "count", "memory_peak_bytes"} | (
        {"busy_s", "window_s"} if trace else set())
    assert set(out["device"]) == dev
    # exactly the cell's metrics of the run's kind, each reader finding its numbers
    names = {m["name"] for m in (bench["per_layer"] if trace else bench["end_to_end"])
             if cell in m.get("workloads", [cell])}
    assert set(out["metrics"]) == names
    for m in out["metrics"].values():
        assert set(m) == {"value", "unit"}
    if trace:
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(out)


def run_cli(cwd: Path, env_extra=None):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **(env_extra or {}))
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                           harness.benchmark()["workloads"][0]["name"], "--seed", "1",
                           "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_no_card_no_result():
    proc = run_cli(harness.ROOT)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_benchmark_alone_no_result(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = run_cli(tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_on_the_card():
    """One short run of each cell on the card: the last line is the contract's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    for cell in harness.benchmark()["workloads"]:
        proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell["name"],
                               "--seed", "3", "--seconds", "2", "--trace", "0"],
                              cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
        assert proc.returncode == 0, proc.stderr[-2000:]
        out = json.loads(proc.stdout.strip().splitlines()[-1])
        assert out["correct"] is True and out["device"]["platform"] == "gpu"
        assert set(out["metrics"]) == {m["name"] for m in harness.benchmark()["end_to_end"]
                                       if cell["name"] in m.get("workloads", [cell["name"]])}
