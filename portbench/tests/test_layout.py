"""A configuration, a cell, a traffic mix or a metric is added by adding
files alone; the runner refuses to start without a CUDA device; nothing
of the benchmark imports JAX or the JAX package."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import time
from pathlib import Path

from portbench.harness import Bench, run_cell

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def test_dropped_in_cell_config_and_metric_are_found(tiny_root):
    """New files only: a configuration, a cell on an existing traffic kind,
    a metric reader; ``BENCHMARK.json`` gains entries, no file of the
    benchmark is edited."""
    before = {p: p.read_bytes() for p in (tiny_root / "portbench").rglob("*") if p.is_file()}
    d = tiny_root / "portbench"
    (d / "configs" / "poisson2d_tiny.json").write_text(json.dumps({
        "name": "poisson2d_tiny", "generator": "poisson_2d", "generator_params": {"n": 12},
        "dtype": "float32", "reduced": []}))
    (d / "workloads" / "poisson_tiny.jacobi_pcg.json").write_text(json.dumps({
        "name": "poisson_tiny.jacobi_pcg", "config": "poisson2d_tiny", "traffic": "jacobi_pcg",
        "kind": "solve_loop",
        "params": {"solver": "pcg", "solver_kw": {"tol": 1e-5, "maxiter": 500},
                   "preconditioner": "jacobi", "pool": 2, "check_samples": 4,
                   "trace_requests": 1},
        "limits": {"residual": 1e-3}, "why": "dropped in"}))
    (d / "metrics" / "requests_done.py").write_text(
        "def read(run):\n    return float(run.requests)\n")
    spec = json.loads((tiny_root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "poisson2d_tiny", "source": "test", "reduced": [],
                            "file": "portbench/configs/poisson2d_tiny.json", "why": "test"})
    spec["workloads"].append({"name": "poisson_tiny.jacobi_pcg", "config": "poisson2d_tiny",
                              "traffic": "jacobi_pcg", "chips": 1, "why": "test"})
    spec["end_to_end"].append({"name": "requests_done", "unit": "requests", "better": "higher",
                               "bound": 0.25, "source": "host_clock",
                               "workloads": ["poisson_tiny.jacobi_pcg"]})
    spec["end_to_end"][0]["workloads"].append("poisson_tiny.jacobi_pcg")
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(spec))
    for p, data in before.items():
        assert p.read_bytes() == data
    bench = Bench(tiny_root)
    line = run_cell(bench, "poisson_tiny.jacobi_pcg", seed=4, seconds=0.05, trace=False,
                    device="cpu", t_start=time.perf_counter())
    assert line["correct"] is True
    assert set(line["metrics"]) == {"solve_ms", "setup_s", "requests_done"}
    assert line["metrics"]["requests_done"]["value"] == line["attempted"]


def test_runner_refuses_without_cuda(tmp_path):
    """No visible CUDA device: exit code 2 and no result line."""
    import torch

    env = {"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    if torch.cuda.is_available():
        env["CUDA_VISIBLE_DEVICES"] = ""
    res = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload",
                          "poisson2048.cg", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300, env=env)
    assert res.returncode == 2
    assert res.stdout == ""
    assert "no CUDA device" in res.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_jax_or_jax_package_imports():
    for path in BENCH_DIR.rglob("*.py"):
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "sparse_matrix_tpu"), (path, mod)


def test_reference_imports_nothing_of_the_program():
    for name in ("reference.py", "roofline.py", "control.py"):
        for mod in _imports(BENCH_DIR / name):
            assert not mod.startswith("sparse_matrix_tpu"), (name, mod)
    for path in (BENCH_DIR / "generators").glob("*.py"):
        for mod in _imports(path):
            assert not mod.startswith("sparse_matrix_tpu"), (path, mod)
