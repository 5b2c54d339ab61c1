"""``kernels_per_solve`` (kernels/solve, device trace): the device kernels
of the traced sub-window, PyTorch's own among them, over its solves."""


def read(run):
    tr = run.trace
    if tr is None or not run.trace_requests:
        return None
    n = len(tr.kernels())
    return n / run.trace_requests if n else None
