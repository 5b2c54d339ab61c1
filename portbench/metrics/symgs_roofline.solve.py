"""``symgs_roofline.solve`` (%, device trace): the least time of a
solve's symmetric Gauss-Seidel steps over their device time
(``symgs_ms.solve``). The least time of a V-cycle's steps
(``hpcg_work.vcycle_symgs_s``, from the configuration alone: each level's
matrix in its smallest plain form with 8-byte values, r read once and x
read and written once, a sweep direction; over the HBM peak or, if
longer, the operations over the FP64 peak) times the V-cycles a solve
runs, the mean ``iterations`` counter of the window plus one (PCG's first
``M^-1`` comes before its first iteration), times the traced solves. The
same work whatever implements the sweep."""

from portbench.hpcg_work import symgs_device_s


def read(run):
    tr = run.trace
    if tr is None or not run.trace_requests or "symgs_vcycle_s" not in run.work:
        return None
    s = symgs_device_s(tr)
    if not s or not run.iterations:
        return None
    vcycles = sum(run.iterations) / len(run.iterations) + 1
    return 100.0 * run.trace_requests * vcycles * run.work["symgs_vcycle_s"] / s
