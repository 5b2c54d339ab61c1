"""``precond_ms.ilu`` (ms/solve, device trace): ``precond_ms.solve`` in the
cells whose end-to-end solve time is the tail, ``solve_ms_p95``: device
time of the operations launched inside the benchmark's range around the
``M^-1`` callable, over the solves of the traced sub-window."""


def read(run):
    tr = run.trace
    if tr is None or not run.trace_requests:
        return None
    s = tr.device_s_in("portbench.precond")
    return None if not s else s * 1e3 / run.trace_requests
