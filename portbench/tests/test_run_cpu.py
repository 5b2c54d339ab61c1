"""A run of every cell on the CPU at tiny sizes: the program's plain
versions answer, the reference compares, the result line is whole."""

from __future__ import annotations

import json
import sys
import time
import types

import pytest

from portbench.harness import Bench, finish, foreign_modules, run_cell

from .conftest import cells

CELLS = cells()


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_cpu(tiny_root, cell):
    bench = Bench(tiny_root)
    line = run_cell(bench, cell, seed=2**31 + 12345, seconds=0.05, trace=False,
                    device="cpu", t_start=time.perf_counter())
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    names = {m["name"] for m in bench.metrics(cell, False)}
    assert set(line["metrics"]) == names
    assert "setup_s" in names
    assert list(line)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_on_cpu_reports_counters(tiny_root, cell):
    """On the CPU the trace holds no device operation: the device metrics
    are left out, the program's counters and host clocks are read."""
    bench = Bench(tiny_root)
    line = run_cell(bench, cell, seed=7, seconds=0.01, trace=True, device="cpu",
                    t_start=time.perf_counter())
    assert line["correct"] is True
    assert "plan_s" in line["metrics"]
    for name in line["metrics"]:
        assert not name.startswith(("device_idle", "spmv_roofline", "spgemm_roofline",
                                    "precond_ms", "kernels_per_solve", "spgemm_device_ms"))
    assert line["device"]["busy_s"] == 0.0


def _cg_run(root, monkeypatch, loads=None):
    """A run of ``poisson2048.cg`` in a process cleared of JAX and the JAX
    package (restored after the test); with ``loads``, the program's
    ``cg_solve`` loads a stub module of that name under the timed path."""
    import sparse_matrix_tpu_torch.solvers.cg as cg

    for name in foreign_modules():
        monkeypatch.delitem(sys.modules, name)
    if loads is not None:
        solve = cg.cg_solve

        def loading(*args, **kw):
            monkeypatch.setitem(sys.modules, loads, types.ModuleType(loads))
            return solve(*args, **kw)

        monkeypatch.setattr(cg, "cg_solve", loading)
    return run_cell(Bench(root), "poisson2048.cg", seed=2**31 + 77, seconds=0.02, trace=False,
                    device="cpu", t_start=time.perf_counter())


@pytest.mark.parametrize("stub", ["jax", "jaxlib", "flax.linen", "sparse_matrix_tpu.ops"])
def test_run_that_loads_jax_prints_no_result(tiny_root, monkeypatch, capsys, stub):
    """JAX, Flax or the JAX package loaded on the timed path: its answers
    are right, but the run prints no result, returns non-zero and names
    what it found on standard error."""
    line = _cg_run(tiny_root, monkeypatch, loads=stub)
    assert line["correct"] is True
    capsys.readouterr()
    assert finish(line) == 3
    out, err = capsys.readouterr()
    assert out == ""
    assert stub.split(".")[0] in err and stub in err


def test_run_without_jax_prints_its_line(tiny_root, monkeypatch, capsys):
    """The same run with nothing foreign loaded prints its line; the port's
    own top-level name, which begins with the JAX package's, is not
    foreign, nor is a name that merely begins with ``jax``."""
    assert foreign_modules({"sparse_matrix_tpu_torch": 0, "sparse_matrix_tpu_torch.ops": 0,
                            "jaxtyping": 0, "flax_like": 0, "jax": 0, "jax._src": 0,
                            "sparse_matrix_tpu": 0}) == ["jax", "jax._src", "sparse_matrix_tpu"]
    line = _cg_run(tiny_root, monkeypatch)
    capsys.readouterr()
    assert finish(line) == 0
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == line
    assert err.strip().splitlines()[-1].startswith("check ")
