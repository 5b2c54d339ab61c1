"""The program's spans in the benchmark's trace (``portbench/spans.py``):

* a hand-built Chrome trace with the benchmark's ranges, the program's
  spans and device operations gives each of the five readings its
  hand-computed value;
* the nine per-layer readers of ``BENCHMARK.json`` read the same values
  from a trace with and without the program's spans, whether or not the
  spans join the trace's ranges;
* the breakdown names an idle gap by the innermost span of either kind;
* on the CPU, a tiny cell's set-up and traced sub-window with the spans
  on give the readings of its layers (also read from the spans kept in
  memory over unprofiled requests), and with them off give none.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from portbench.harness import Bench, Run
from portbench.spans import Memory, ProgramTrace, operator_plan_s, readings, run_spans
from portbench.tests.conftest import cells, make_tiny_bench
from portbench.tracing import Trace

ROOT = Path(__file__).resolve().parents[2]
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
PER_LAYER = [m["name"] for m in SPEC["per_layer"]]


def _x(name, ts, dur, cat="user_annotation", **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def _kernel(name, ts, dur, corr, launch_ts):
    """A device kernel and the runtime call that launched it."""
    return [_x(name, ts, dur, cat="kernel", correlation=corr),
            _x("cudaLaunchKernel", launch_ts, 2, cat="cuda_runtime", correlation=corr)]


BENCH_EVENTS = [
    _x("portbench.window", 0, 1000),
    _x("portbench.request", 10, 400),
    _x("portbench.request", 500, 400),
    _x("portbench.matvec", 31, 28), _x("portbench.matvec", 521, 38),
    _x("portbench.precond", 201, 58), _x("portbench.precond", 721, 78),
    _x("aten::mul", 60, 5, cat="cpu_op"),
    *_kernel("dia_kernel", 40, 30, 1, 35),
    *_kernel("elementwise_kernel", 75, 10, 2, 62),
    *_kernel("lanepack_kernel", 215, 20, 3, 212),
    *_kernel("dia_kernel", 530, 30, 4, 525),
    *_kernel("lanepack_kernel", 740, 40, 5, 735),
]
#: two solves: (20, 400) and (510, 890); the V-cycle's levels inside M^-1;
#: three refreshes outside them
PROGRAM_EVENTS = [
    _x("spmx.solve", 20, 380),
    _x("spmx.krylov.matvec", 30, 30),
    _x("spmx.krylov.sync", 100, 50),
    _x("spmx.krylov.precond", 200, 60),
    _x("spmx.amg.level0", 200, 58),
    _x("spmx.amg.level1", 210, 40),
    _x("spmx.amg.coarse", 220, 10),
    _x("spmx.krylov.sync", 300, 40),
    _x("spmx.solve", 510, 380),
    _x("spmx.krylov.matvec", 520, 40),
    _x("spmx.krylov.sync", 600, 100),
    _x("spmx.krylov.precond", 720, 80),
    _x("spmx.amg.level0", 720, 78),
    _x("spmx.amg.level1", 730, 60),
    _x("spmx.esc.multiply", 900, 20),
    _x("spmx.esc.multiply", 930, 30),
    _x("spmx.esc.multiply", 965, 30),
]


def test_five_readings_hand_computed():
    tr = ProgramTrace(BENCH_EVENTS + PROGRAM_EVENTS)
    got = readings(tr, 2, [])
    # solve self time: 380 - (30 + 50 + 60 + 40) and 380 - (40 + 100 + 80) us
    assert got["krylov_host_ms.solve"] == pytest.approx((200 + 160) / 1e3 / 2)
    assert got["sync_wait_ms.solve"] == pytest.approx((50 + 40 + 100) / 1e3 / 2)
    assert got["vcycle_coarse_ms.solve"] == pytest.approx((40 + 60) / 1e3 / 2)
    assert got["spgemm_host_ms"] == pytest.approx((20 + 30 + 30) / 1e3 / 3)
    assert "operator_plan_s" not in got
    assert readings(Trace(BENCH_EVENTS), 2, []) == {}


def test_operator_plan_s_sums_the_outermost_plans():
    from sparse_matrix_tpu_torch.utils.profiling import Span

    spans = [Span("spmx.plan.amg.plan", -1, 0, 10_000_000_000),
             Span("spmx.plan.operator", 0, 1_000_000_000, 2_000_000_000),
             Span("spmx.plan.operator", 0, 3_000_000_000, 3_500_000_000),
             # a plan inside a plan is counted once, with its outer one
             Span("spmx.plan.operator", 2, 3_100_000_000, 3_200_000_000),
             Span("spmx.plan.operator", -1, 11_000_000_000, 11_250_000_000)]
    assert operator_plan_s(spans) == pytest.approx(1.0 + 0.5 + 0.25)
    assert operator_plan_s(spans[:1]) is None


def _run(trace):
    run = Run()
    run.trace, run.trace_requests = trace, 2
    run.plan_s, run.iterations = 1.5, [15, 16]
    run.work = {"matvec_bytes": 1e6, "matvec_flops": 1e6, "spgemm_bytes": 2e6,
                "spgemm_flops": 2e6}
    return run


def test_existing_readers_unmoved_by_program_spans():
    bench = Bench(ROOT)
    assert len(PER_LAYER) >= 9
    base = {m: bench.reader(m).read(_run(Trace(BENCH_EVENTS))) for m in PER_LAYER}
    assert sum(v is not None for v in base.values()) >= 7
    for tr in (Trace(BENCH_EVENTS + PROGRAM_EVENTS), ProgramTrace(BENCH_EVENTS + PROGRAM_EVENTS)):
        assert {m: bench.reader(m).read(_run(tr)) for m in PER_LAYER} == base


def test_breakdown_names_the_innermost_span():
    events = BENCH_EVENTS + PROGRAM_EVENTS
    # the gap before kernel 5 opens at 560, inside the second solve; its
    # launch at 735 lies under no CPU operation
    tr = ProgramTrace(events)
    assert tr.host_context(565, 5) == "spmx.solve > none"
    assert tr.host_context(232, 3) == "spmx.amg.level1 > none"
    assert tr.host_context(225, 3) == "spmx.amg.coarse > none"
    assert tr.host_context(65, 2) == "spmx.solve > aten::mul"
    # without the program's spans the benchmark's own range names it
    assert Trace(events).host_context(232, 3) == "portbench.precond > none"
    gaps = dict(tr.breakdown()["idle_gaps"])
    assert "spmx.amg.level1 > none" in gaps or "spmx.solve > none" in gaps
    assert not any(k.startswith("portbench.precond") for k in gaps)


CELL_READINGS = {
    "poisson2048.amg_pcg": {"krylov_host_ms.solve", "sync_wait_ms.solve",
                            "vcycle_coarse_ms.solve", "operator_plan_s"},
    "poisson2048.cg": {"krylov_host_ms.solve", "sync_wait_ms.solve", "operator_plan_s"},
    "femlike262k.ilu_bicgstab": {"krylov_host_ms.solve", "sync_wait_ms.solve",
                                 "operator_plan_s"},
    "femlike262k.spgemm_refresh": {"spgemm_host_ms"},
}
FIVE = {"krylov_host_ms.solve", "sync_wait_ms.solve", "vcycle_coarse_ms.solve",
        "spgemm_host_ms", "operator_plan_s"}


@pytest.mark.parametrize("cell", [c for c in sorted(CELL_READINGS) if c in cells()])
@pytest.mark.parametrize("spans", [True, False])
def test_tiny_cell_on_cpu(tmp_path, cell, spans):
    from sparse_matrix_tpu_torch.utils import profiling

    # the spans' tiny Poisson, 64^2, keeps two AMG levels above the coarse
    # size, so a level 1
    root = make_tiny_bench(tmp_path, "spans")
    line = run_spans(Bench(root), cell, seed=2**31 + 99, spans=spans, device="cpu")
    assert not profiling.enabled()
    got = FIVE & set(line["metrics"])
    assert got == (CELL_READINGS[cell] if spans else set())
    assert (line["spans_per_request"] > 0) == spans
    assert (line["setup_spans"] > 0) == spans
    for name in got:
        assert line["metrics"][name] > 0
    # the same requests again, unprofiled, read from the spans in memory
    solve = {"solve_span_ms"} if "sync_wait_ms.solve" in CELL_READINGS[cell] else set()
    assert set(line["untraced"]) == ((CELL_READINGS[cell] - {"operator_plan_s"}) | solve
                                     if spans else set())
    assert all(v > 0 for v in line["untraced"].values())


def test_memory_spans_read_as_the_trace_does():
    from sparse_matrix_tpu_torch.utils.profiling import Span

    spans, stack = [], []  # parents by containment, in opening order
    for ev in sorted(PROGRAM_EVENTS, key=lambda e: (e["ts"], -e["dur"])):
        while stack and spans[stack[-1]].end_ns <= ev["ts"] * 1000:
            stack.pop()
        spans.append(Span(ev["name"], stack[-1] if stack else -1, ev["ts"] * 1000,
                          (ev["ts"] + ev["dur"]) * 1000))
        stack.append(len(spans) - 1)
    assert readings(Memory(spans), 2, []) == pytest.approx(
        readings(ProgramTrace(BENCH_EVENTS + PROGRAM_EVENTS), 2, []))
