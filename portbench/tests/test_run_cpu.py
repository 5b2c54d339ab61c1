"""A run of every cell on the CPU at tiny sizes: the program's plain
versions answer, the reference compares, the result line is whole."""

from __future__ import annotations

import json
import time

import pytest

from portbench.harness import Bench, run_cell

CELLS = [w["name"] for w in json.loads((__import__("pathlib").Path(__file__).resolve()
                                        .parents[2] / "BENCHMARK.json").read_text())["workloads"]]


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
