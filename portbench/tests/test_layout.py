"""A configuration, a cell, a traffic mix, a traffic kind or a metric is
added by adding files alone, and so joins the benchmark's CPU tests; a
configuration without a tiny size, or a kind without planted faults, is
named by its file; the runner refuses to start without a CUDA device;
nothing of the benchmark imports JAX or the JAX package."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

from portbench.control import control_readings
from portbench.harness import Bench, run_cell

from .conftest import (cells, configs_without_tiny, copy_bench, fault_cases, faults,
                       kinds_without_faults, make_tiny_bench)

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


#: a toy traffic kind, as a later PR would bring it: a fixed number of
#: normalised applies of the dispatched operator from a seeded vector
POWER_STEPS = '''
from typing import NamedTuple

import numpy as np

from portbench import reference


class Answer(NamedTuple):
    x: object
    j: int
    iterations: int
    failed: bool


def normalised_applies(matvec, x, steps):
    for _ in range(steps):
        y = matvec(x)
        x = y / y.norm()
    return x


class Traffic:
    def __init__(self, ctx):
        self.ctx, self.p = ctx, ctx.params

    def setup(self):
        from sparse_matrix_tpu_torch.formats.csr import CsrMatrix
        from sparse_matrix_tpu_torch.ops.operator import SpmvOperator

        m = self.ctx.matrix
        a = CsrMatrix(m.rows, m.cols, m.vals.astype(np.float32), m.indices, m.offsets,
                      is_sorted=True)
        self.op = self.ctx.plan("operator", lambda: SpmvOperator(a, device=self.ctx.device))
        self.pool = self._pool()

    def _pool(self):
        torch, ctx = self.ctx.torch, self.ctx
        return torch.randn((int(self.p["pool"]), ctx.matrix.rows), generator=ctx.generator(),
                           device=ctx.device, dtype=torch.float32)

    def set_ranges(self, on):
        pass

    def request(self, i):
        j = i % int(self.p["pool"])
        steps = int(self.p["steps"])
        return Answer(normalised_applies(self.op, self.pool[j], steps), j, steps, False)

    def release(self):
        self.op = self.pool = None

    def _reference(self, x, dtype):
        a = reference.upload(self.ctx.matrix.astype(np.float32), self.ctx.device, dtype)
        return normalised_applies(lambda v: reference.matvec(a, v), x.to(dtype),
                                  int(self.p["steps"]))

    def check(self, samples):
        torch = self.ctx.torch
        pool = self._pool()
        worst = 0.0
        for _i, ans in samples:
            ref = self._reference(pool[ans.j], torch.float64)
            err = float((ans.x.to(torch.float64) - ref).norm() / ref.norm())
            worst = max(worst, err if err == err else float("inf"))
        return {"x_error": {"value": worst, "limit": float(self.ctx.workload["limits"]["x_error"])}}

    def control(self, count):
        dtype = getattr(self.ctx.torch, self.ctx.workload["control"]["dtype"])
        pool = self._pool()
        return [(j, Answer(self._reference(pool[j], dtype), j, 0, False))
                for j in range(min(count, pool.shape[0]))]

    def work(self):
        return {}
'''

POWER_STEPS_FAULTS = '''
CHECK = "x_error"


def unchanged_steps(monkeypatch):
    from sparse_matrix_tpu_torch.ops.operator import SpmvOperator

    monkeypatch.setattr(SpmvOperator, "__call__", lambda self, x: x.clone())


def altered_answers(monkeypatch):
    from sparse_matrix_tpu_torch.ops.operator import SpmvOperator

    orig = SpmvOperator.__call__

    def altered(self, x):
        y = orig(self, x).clone()
        y[0] += 1.0
        return y

    monkeypatch.setattr(SpmvOperator, "__call__", altered)


FAULTS = {"unchanged_steps": unchanged_steps, "altered_answers": altered_answers}
'''


def test_dropped_in_config_and_traffic_kind_join_every_test(tmp_path, monkeypatch):
    """New files only, on a copy of the benchmark as it stands: a
    configuration with its tiny size, a traffic kind with its control and
    check, that kind's faults; ``BENCHMARK.json`` gains entries. The shared
    helpers list the new cell for the run, control and fault tests; its
    tiny run is correct; its control and each of its faults are not."""
    src = copy_bench(tmp_path / "src")
    d = src / "portbench"
    before = {p: p.read_bytes() for p in d.rglob("*") if p.is_file()}
    old_spec = json.loads((src / "BENCHMARK.json").read_text())
    cell, kind, config = "toy512.power_steps", "toy_power_steps", "toy_poisson2d_512"
    (d / "configs" / f"{config}.json").write_text(json.dumps({
        "name": config, "generator": "poisson_2d", "generator_params": {"n": 512},
        "dtype": "float32", "reduced": [], "tiny": {"run": {"n": 16}}}))
    (d / "traffic" / f"{kind}.py").write_text(POWER_STEPS)
    (d / "faults" / f"{kind}.py").write_text(POWER_STEPS_FAULTS)
    (d / "workloads" / f"{cell}.json").write_text(json.dumps({
        "name": cell, "config": config, "traffic": "power_steps", "kind": kind,
        "params": {"steps": 8, "pool": 2, "check_samples": 4, "trace_requests": 1},
        "limits": {"x_error": 1e-4}, "control": {"dtype": "bfloat16"}, "why": "dropped in"}))
    spec = json.loads(json.dumps(old_spec))
    spec["configs"].append({"name": config, "source": "test", "reduced": [],
                            "file": f"portbench/configs/{config}.json", "why": "test"})
    spec["workloads"].append({"name": cell, "config": config, "traffic": "power_steps",
                              "chips": 1, "why": "test"})
    next(m for m in spec["end_to_end"] if m["name"] == "solve_ms")["workloads"].append(cell)
    next(m for m in spec["per_layer"] if m["name"] == "plan_s")["workloads"].append(cell)
    (src / "BENCHMARK.json").write_text(json.dumps(spec))

    for p, data in before.items():
        assert p.read_bytes() == data, p
    for key in ("configs", "workloads"):
        assert spec[key][:len(old_spec[key])] == old_spec[key]

    assert cells(src) == cells() + [cell]
    assert fault_cases(src) == fault_cases() + [(cell, "unchanged_steps"),
                                                (cell, "altered_answers")]
    assert configs_without_tiny(src) == configs_without_tiny()
    assert kinds_without_faults(src) == kinds_without_faults()

    run_root = make_tiny_bench(tmp_path / "run", source=src)
    line = run_cell(Bench(run_root), cell, seed=2**31 + 21, seconds=0.02, trace=False,
                    device="cpu", t_start=time.perf_counter())
    assert line["correct"] is True, line["checks"]
    assert set(line["metrics"]) == {"solve_ms", "setup_s"}

    ctl_root = make_tiny_bench(tmp_path / "control", "control", source=src)
    checks = control_readings(Bench(ctl_root), cell, 2**31 + 21, 2, "cpu")
    assert checks["x_error"]["value"] > checks["x_error"]["limit"], checks

    planted = faults(src, kind)
    for name, fault in planted.FAULTS.items():
        with monkeypatch.context() as mp:
            fault(mp)
            line = run_cell(Bench(run_root), cell, seed=2**31 + 21, seconds=0.02, trace=False,
                            device="cpu", t_start=time.perf_counter())
        assert line["correct"] is False, name
        assert line["checks"]["x_error"]["value"] > line["checks"]["x_error"]["limit"], name


def test_every_config_has_a_tiny_size():
    missing = configs_without_tiny()
    assert not missing, "\n".join(missing)


def test_every_kind_has_planted_faults():
    missing = kinds_without_faults()
    assert not missing, "\n".join(missing)


@pytest.mark.parametrize("config", ["poisson2d_2048", "hpcg_104"])
def test_config_without_tiny_is_named(tmp_path, config):
    """Only that configuration is named, by its file; its cells leave the
    run, control and fault tests' lists and the tiny benchmark; the faults'
    guard is unmoved."""
    root = copy_bench(tmp_path / "src")
    path = root / "portbench" / "configs" / f"{config}.json"
    cfg = json.loads(path.read_text())
    cfg.pop("tiny", None)
    path.write_text(json.dumps(cfg))
    msgs = configs_without_tiny(root)
    named = [m for m in msgs if m.startswith(f"portbench/configs/{config}.json: ")]
    assert len(named) == 1 and set(msgs) == set(configs_without_tiny()) | set(named)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    own = [w["name"] for w in spec["workloads"] if w["config"] == config]
    assert own and not set(own) & set(cells(root))
    assert cells(root) == [c for c in cells() if c not in own]
    assert fault_cases(root) == [fc for fc in fault_cases() if fc[0] not in own]
    tiny = json.loads((make_tiny_bench(tmp_path / "tiny", source=root)
                       / "BENCHMARK.json").read_text())
    assert [w["name"] for w in tiny["workloads"]] == cells(root)
    assert kinds_without_faults(root) == kinds_without_faults()


@pytest.mark.parametrize("emptied", [False, True])
def test_kind_without_faults_is_named(tmp_path, emptied):
    """A kind's faults file removed, or its ``FAULTS`` emptied: only that
    file is named, with the cells it leaves without a fault."""
    root = copy_bench(tmp_path / "src")
    path = root / "portbench" / "faults" / "spgemm_refresh.py"
    if emptied:
        path.write_text("FAULTS = {}\n")
    else:
        path.unlink(missing_ok=True)
    msgs = kinds_without_faults(root)
    named = [m for m in msgs if m.startswith("portbench/faults/spgemm_refresh.py: ")]
    assert len(named) == 1 and set(msgs) == set(kinds_without_faults()) | set(named)
    assert "femlike262k.spgemm_refresh" in named[0]
    assert fault_cases(root) == [fc for fc in fault_cases() if fc[1] not in
                                 ("stale_product", "altered_product", "half_products")]
    assert configs_without_tiny(root) == configs_without_tiny()


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
