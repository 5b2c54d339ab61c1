"""``kernels_per_solve.ilu`` (kernels/solve, device trace):
``kernels_per_solve`` in the cells whose end-to-end solve time is the
tail, ``solve_ms_p95``: the device kernels of the traced sub-window,
PyTorch's own among them, over its solves."""


def read(run):
    tr = run.trace
    if tr is None or not run.trace_requests:
        return None
    n = len(tr.kernels())
    return n / run.trace_requests if n else None
