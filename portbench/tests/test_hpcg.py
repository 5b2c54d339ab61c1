"""The HPCG cell's own pieces: its generator and its reference copy held
to the port's, its work counts, its two metric readers on a synthetic
trace, its control and a planted fault failing its comparison, and a run
on the CPU at a small grid."""

from __future__ import annotations

import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import hpcg_work
from portbench.control import control_readings
from portbench.generators import load
from portbench.harness import Bench, Run, run_cell
from portbench.roofline import occupied_diagonals, plain_form_bytes
from portbench.tests.conftest import make_tiny_bench
from portbench.tracing import Trace

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
CELL = "hpcg104.mg_pcg"


@pytest.mark.parametrize("grid", [(1, 1, 1), (2, 3, 4), (16, 16, 16), (24, 16, 8), (13, 13, 13)])
def test_generator_equals_port(grid):
    from sparse_matrix_tpu_torch.solvers.hpcg import hpcg_problem

    ours = load("hpcg_27pt").make(None, nx=grid[0], ny=grid[1], nz=grid[2])
    theirs, _b = hpcg_problem(*grid)
    assert (ours.rows, ours.cols) == (theirs.rows, theirs.cols)
    for name in ("offsets", "indices", "vals"):
        a, b = getattr(ours, name), getattr(theirs, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_reference_copy_equals_the_port_reference():
    """``reference_hpcg.py`` is the port's ``reference/hpcg.py``, byte for
    byte (the benchmark keeps its own copy so that a change to the
    program cannot move its yardstick)."""
    ours = (BENCH_DIR / "reference_hpcg.py").read_bytes()
    theirs = (ROOT / "sparse_matrix_tpu_torch" / "reference" / "hpcg.py").read_bytes()
    assert ours == theirs


@pytest.mark.parametrize("grid", [(16, 16, 16), (24, 16, 8), (13, 13, 13), (2, 2, 2)])
def test_work_counts_are_the_generators(grid):
    m = load("hpcg_27pt").make(None, nx=grid[0], ny=grid[1], nz=grid[2])
    rows, nnz, ndiag = hpcg_work.stencil_counts(*grid)
    assert (rows, nnz) == (m.rows, m.nnz())
    assert ndiag == occupied_diagonals(m.row_ids(), m.indices)


def test_vcycle_least_time_at_104():
    """104^3: the finest level's DIA planes (27 x 1,124,864 x 8 bytes)
    plus r and x read and x written, 270 MB a sweep direction, four
    directions; three coarser levels; all bound by bytes."""
    nbytes, flops = hpcg_work.sweep_work(104, 104, 104)
    rows = 104 ** 3
    assert nbytes == 27 * (rows * 8 + 4) + 24 * rows
    assert nbytes == plain_form_bytes(rows, rows, 310 ** 3, 27, 8) + 24 * rows
    want = sum((4 if lvl < 3 else 2) * hpcg_work.sweep_work(*(104 >> lvl,) * 3)[0]
               for lvl in range(4)) / 3.35e12
    assert hpcg_work.vcycle_symgs_s(104, 104, 104, 4) == pytest.approx(want, rel=1e-12)
    assert 0.36e-3 < want < 0.37e-3


def _x(name, ts, dur, cat="user_annotation", corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _trace(symgs_us):
    """A sub-window of two requests: one graph launch a request, each
    replaying two SymGS kernels and a DIA kernel."""
    evs = [_x("portbench.window", 0, 1000), _x("portbench.request", 10, 400),
           _x("portbench.request", 500, 400),
           _x("cudaGraphLaunch", 20, 5, "cuda_runtime", 1),
           _x("cudaGraphLaunch", 510, 5, "cuda_runtime", 2)]
    for corr, t0 in ((1, 30), (2, 530)):
        evs += [_x("void (anonymous namespace)::spmx_symgs_color<double>(double const*)",
                   t0, symgs_us, "kernel", corr),
                _x("void (anonymous namespace)::spmx_symgs_color<double>(double const*)",
                   t0 + 100, symgs_us, "kernel", corr),
                _x("void (anonymous namespace)::dia_kernel<double, double>(double const*)",
                   t0 + 200, 50, "kernel", corr)]
    return Trace(evs)


def _reader(name):
    return Bench(ROOT).reader(name)


def test_symgs_readers_on_a_synthetic_trace():
    run = Run()
    run.trace = _trace(30.0)
    run.trace_requests = 2
    run.iterations = [50, 50, 50]
    run.work = {"symgs_vcycle_s": 1.0e-6}
    # 4 SymGS kernels of 30 us over 2 requests
    assert _reader("symgs_ms.solve").read(run) == pytest.approx(0.060)
    # 2 requests x 51 V-cycles x 1 us over 120 us
    assert _reader("symgs_roofline.solve").read(run) == pytest.approx(100.0 * 102 / 120)


def test_symgs_readers_read_nothing_without_the_kernel():
    """A trace without the SymGS kernel (a program without it), or no
    trace, reads nothing; the roofline also needs the cell's work."""
    run = Run()
    run.trace_requests = 2
    run.iterations = [50]
    run.work = {"symgs_vcycle_s": 1.0e-6}
    for name in ("symgs_ms.solve", "symgs_roofline.solve"):
        assert _reader(name).read(run) is None
    run.trace = Trace([_x("portbench.window", 0, 1000),
                       _x("cudaLaunchKernel", 20, 5, "cuda_runtime", 1),
                       _x("void dia_kernel<float>(float const*)", 30, 40, "kernel", 1)])
    for name in ("symgs_ms.solve", "symgs_roofline.solve"):
        assert _reader(name).read(run) is None
    run.trace, run.work = _trace(30.0), {}
    assert _reader("symgs_roofline.solve").read(run) is None
    assert _reader("symgs_ms.solve").read(run) == pytest.approx(0.060)


@pytest.fixture
def hpcg_root(tmp_path):
    return _tiny_at(tmp_path, 16)


def _tiny_at(tmp_path, side):
    """A tiny benchmark whose HPCG grid is ``side``^3, the grid that these
    tests' reasoning needs, whatever the configuration's own tiny size."""
    root = make_tiny_bench(tmp_path)
    path = root / "portbench" / "configs" / "hpcg_104.json"
    cfg = json.loads(path.read_text())
    cfg["generator_params"] = {"nx": side, "ny": side, "nz": side}
    path.write_text(json.dumps(cfg))
    return root


def test_cell_runs_correct_on_cpu_with_its_checks(hpcg_root):
    line = run_cell(Bench(hpcg_root), CELL, seed=2**31 + 3, seconds=0.05, trace=False,
                    device="cpu", t_start=time.perf_counter())
    assert line["correct"] is True and line["failed"] == 0
    assert set(line["checks"]) == {"iterations", "residual", "x_error"}
    assert line["checks"]["iterations"]["value"] == 0
    assert line["checks"]["x_error"]["value"] < 1e-12
    assert set(line["metrics"]) == {"solve_ms", "solve_ms_p95", "setup_s"}


def test_control_fails_at_32(tmp_path):
    """The reference in float32 in the program's place fails on x_error
    (a finite reading some 1e-7 above the 1e-9 limit; at 32^3 its
    recurrence does not underflow as it does at 16^3)."""
    checks = control_readings(Bench(_tiny_at(tmp_path, 32)), CELL, 2**32 + 9, 1, "cpu")
    x = checks["x_error"]
    assert np.isfinite(x["value"]) and x["value"] > 10 * x["limit"]


def _forward_only(passes, x, r):
    """A SymGS step with its backward sweep dropped."""
    for rows, jc, live, coef, dg in passes:
        xv = torch.where(live, x[jc], 0.0)
        x[rows] = (r[rows] - (coef * xv).sum(0)) / dg
    return x


def test_dropped_backward_sweep_is_caught(hpcg_root, monkeypatch):
    """At 16^3 both sets converge to roundoff within 50 iterations, so any
    sound preconditioner gives the same x: the cell's sets are cut to 5
    iterations here, where x still shows the preconditioner (at 104^3, 50
    iterations leave the residual near 1e-7)."""
    import sparse_matrix_tpu_torch.ops.symgs as symgs

    path = hpcg_root / "portbench" / "workloads" / f"{CELL}.json"
    wl = json.loads(path.read_text())
    wl["params"]["solver_kw"]["maxiter"] = 5
    path.write_text(json.dumps(wl))
    assert run_cell(Bench(hpcg_root), CELL, seed=11, seconds=0.02, trace=False, device="cpu",
                    t_start=time.perf_counter())["correct"] is True
    monkeypatch.setattr(symgs, "_symgs_torch", _forward_only)
    line = run_cell(Bench(hpcg_root), CELL, seed=11, seconds=0.02, trace=False, device="cpu",
                    t_start=time.perf_counter())
    assert line["correct"] is False
    assert line["checks"]["x_error"]["value"] > line["checks"]["x_error"]["limit"]


def test_cell_and_config_are_declared():
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next(w for w in spec["workloads"] if w["name"] == CELL)
    assert cell["chips"] == 1 and cell["config"] == "hpcg_104"
    cfg = json.loads((BENCH_DIR / "configs" / "hpcg_104.json").read_text())
    assert cfg["dtype"] == "float64" and cfg["reduced"] == []
    assert cfg["rows"] == 104 ** 3 and cfg["nnz"] == 310 ** 3
