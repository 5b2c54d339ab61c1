"""A cell's traced sub-window read by the program's own spans.

    python3 portbench/spans.py --workload <cell> --seed <n> [--spans 1|0]

The port marks its layer boundaries with spans
(``sparse_matrix_tpu_torch/utils/profiling.py``: ``spmx.solve``,
``spmx.krylov.sync``, ``spmx.amg.level1``, ``spmx.esc.multiply``,
``spmx.plan.operator``, ...), off unless switched on. ``run.py`` does not
switch them on; this tool does what a traced run would do with them on,
without the measured window:

1. set-up as a run does (matrix, plans, pool), the spans on, so the plans'
   spans are recorded in memory (``operator_plan_s``);
2. the cell's ``warm_requests``, the spans off;
3. with the spans on, ``trace_requests`` requests with no profiler, read
   from the spans kept in memory (``untraced``): the readings below
   without the profiler's own cost on every operation, and
   ``solve_span_ms``, a solve's whole span; before any profiler has run
   in the process, which leaves the launches slower after it;
4. the traced sub-window of ``--trace 1`` (as many requests again, each
   waited for, inside the benchmark's ranges), the spans on again
   (``--spans 0`` leaves them off, and skips step 3: the same sub-window
   without them, to read what they cost).

It prints one JSON line: the cell's per-layer metrics as a traced run
reads them (the rooflines, which need the comparison's counts, left
out), the five readings below, the spans a request, and the
breakdown, whose idle gaps are named by the innermost span of either the
benchmark or the program.

* ``krylov_host_ms.solve``: self time of ``spmx.solve``, its duration
  less what its children ``spmx.krylov.matvec``, ``.precond`` and
  ``.sync`` cover, a solve: the Python and PyTorch launches of the
  Krylov updates;
* ``sync_wait_ms.solve``: ``spmx.krylov.sync``'s duration a solve, the
  host blocked at the stopping test;
* ``vcycle_coarse_ms.solve``: ``spmx.amg.level1``'s duration a solve,
  everything below the fine level on the host clock;
* ``spgemm_host_ms``: ``spmx.esc.multiply``'s duration a product, the
  host's cost to enqueue one refresh;
* ``operator_plan_s``: the summed duration of the outermost
  ``spmx.plan.operator`` spans of set-up.

The first four are host intervals of the profiler's trace (microseconds,
the clock of the device operations); the fifth comes from the spans kept
in memory. A program without spans reads none of them.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import (ROOT, Bench, Context, Run, _request, make_matrix,  # noqa: E402
                               power_limit_w)
from portbench.tracing import REQUEST, WINDOW, Trace, _Intervals  # noqa: E402

PROGRAM = "spmx."
KRYLOV_CHILDREN = ("spmx.krylov.matvec", "spmx.krylov.precond", "spmx.krylov.sync")


def program_ranges(events):
    """The program's spans in a Chrome trace's events, by name."""
    spans = {}
    for ev in events:
        if (ev.get("ph") == "X" and ev.get("cat") == "user_annotation"
                and ev.get("name", "").startswith(PROGRAM)):
            ts = float(ev.get("ts", 0.0))
            spans.setdefault(ev["name"], []).append((ts, ts + float(ev.get("dur", 0.0))))
    return {k: _Intervals(v) for k, v in spans.items()}


class ProgramTrace(Trace):
    """The benchmark's ``Trace`` with the program's spans among its ranges,
    so the breakdown names them; ``ProgramTrace.from_profiler`` exports a
    profiler's trace as ``Trace`` does."""

    def __init__(self, events):
        super().__init__(events)
        self.ranges.update(program_ranges(events))


def host_s_in(trace, name: str) -> float | None:
    """Summed seconds of the range ``name``'s intervals; None where the
    trace has none."""
    iv = trace.ranges.get(name)
    if iv is None or not len(iv):
        return None
    return sum(e - s for s, e in zip(iv.start, iv.end)) / 1e6


def self_s(trace, name: str, children) -> float | None:
    """Summed seconds of ``name``'s intervals less the part of each that
    the intervals of ``children`` cover."""
    total = host_s_in(trace, name)
    if total is None:
        return None
    parent = trace.ranges[name]
    kids = sorted((s, e) for c in children if c in trace.ranges
                  for s, e in zip(trace.ranges[c].start, trace.ranges[c].end))
    covered = 0.0
    for ps, pe in zip(parent.start, parent.end):
        end = ps
        for s, e in kids:
            s, e = max(s, end), min(e, pe)
            if e > s:
                covered += e - s
                end = e
    return total - covered / 1e6


def _per(value_s, n, scale=1e3):
    return None if value_s is None or not n else value_s * scale / n


def krylov_host_ms(trace, solves: int):
    return _per(self_s(trace, "spmx.solve", KRYLOV_CHILDREN), solves)


def sync_wait_ms(trace, solves: int):
    return _per(host_s_in(trace, "spmx.krylov.sync"), solves)


def vcycle_coarse_ms(trace, solves: int):
    return _per(host_s_in(trace, "spmx.amg.level1"), solves)


def spgemm_host_ms(trace):
    return _per(host_s_in(trace, "spmx.esc.multiply"), trace.count("spmx.esc.multiply"))


def operator_plan_s(spans):
    """The summed seconds of the outermost ``spmx.plan.operator`` spans of
    a list of the program's in-memory spans; None where it holds none."""
    def inside_one(s):
        p = s.parent
        while p >= 0:
            if spans[p].name == "spmx.plan.operator":
                return True
            p = spans[p].parent
        return False

    ops = [s for s in spans if s.name == "spmx.plan.operator" and not inside_one(s)]
    return sum(s.end_ns - s.start_ns for s in ops) / 1e9 if ops else None


class Memory:
    """In-memory spans (``profiling.take()``) seen as a trace's ranges, in
    microseconds, for the readers above."""

    def __init__(self, spans):
        by_name = {}
        for s in spans:
            by_name.setdefault(s.name, []).append((s.start_ns / 1e3, s.end_ns / 1e3))
        self.ranges = {k: _Intervals(v) for k, v in by_name.items()}

    def count(self, name: str) -> int:
        iv = self.ranges.get(name)
        return 0 if iv is None else len(iv)


def readings(trace, solves: int, setup_spans) -> dict:
    out = {"krylov_host_ms.solve": krylov_host_ms(trace, solves),
           "sync_wait_ms.solve": sync_wait_ms(trace, solves),
           "vcycle_coarse_ms.solve": vcycle_coarse_ms(trace, solves),
           "spgemm_host_ms": spgemm_host_ms(trace),
           "operator_plan_s": operator_plan_s(setup_spans)}
    return {k: v for k, v in out.items() if v is not None}


def run_spans(bench: Bench, name: str, *, seed: int, spans: bool, device) -> dict:
    """Set-up, warm requests and the traced sub-window of cell ``name``,
    the program's spans on (``spans``) in set-up and the sub-window."""
    import torch

    from sparse_matrix_tpu_torch.utils import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl = bench.workload(name)
    cfg = bench.config(wl["config"])
    dev = torch.device(device)
    ctx = Context(torch, dev, seed, wl, cfg, make_matrix(bench, cfg, wl, seed))
    traffic = bench.traffic_kind(wl["kind"]).Traffic(ctx)
    profiling.take()
    if spans:
        profiling.enable()
    traffic.setup()
    profiling.disable()
    setup_spans = profiling.take()
    for k in range(int(wl["params"].get("warm_requests", 1))):
        traffic.request(k)
        ctx.sync()
    n_tr = int(wl["params"]["trace_requests"])
    untraced = {}
    if spans:
        profiling.enable()
        solved = sum(_request(torch, dev, traffic, n_tr + j, False)[0].iterations is not None
                     for j in range(n_tr))
        profiling.disable()
        mem = Memory(profiling.take())
        untraced = readings(mem, solved, [])
        if solved:
            untraced["solve_span_ms"] = _per(host_s_in(mem, "spmx.solve"), solved)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    run = Run()
    run.plan_s = ctx.plan_s
    traffic.set_ranges(True)
    if spans:
        profiling.enable()
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            for j in range(n_tr):
                with torch.profiler.record_function(REQUEST):
                    out, _ = _request(torch, dev, traffic, j, False)
                if out.iterations is not None:
                    run.iterations.append(out.iterations)
    profiling.disable()
    traffic.set_ranges(False)
    profiling.take()
    run.trace = ProgramTrace.from_profiler(prof)
    del prof
    run.trace_requests = n_tr
    traffic.release()
    metrics = {}
    for m in bench.metrics(name, True):
        val = bench.reader(m["name"]).read(run)
        if val is not None:
            metrics[m["name"]] = float(val)
    solves = n_tr if run.iterations else 0
    metrics.update(readings(run.trace, solves, setup_spans))
    n_spans = sum(len(iv) for k, iv in run.trace.ranges.items() if k.startswith(PROGRAM))
    return {"workload": name, "seed": seed, "spans": bool(spans), "metrics": metrics,
            "untraced": untraced,
            "spans_per_request": n_spans / n_tr, "setup_spans": len(setup_spans),
            "device": {"kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                                else "cpu"),
                       "power_limit_w": power_limit_w() if dev.type == "cuda" else None,
                       "busy_s": run.trace.busy_s(), "window_s": run.trace.window_s()},
            "breakdown": run.trace.breakdown()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Read a cell's traced sub-window by program span.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--spans", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("spans: no CUDA device is visible", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    line = run_spans(Bench(ROOT), args.workload, seed=args.seed, spans=bool(args.spans),
                     device="cuda")
    line["seconds"] = time.perf_counter() - t0
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
