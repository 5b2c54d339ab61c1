"""``symgs_ms.solve`` (ms/solve, device trace): the device time of the
symmetric Gauss-Seidel colour-pass kernels over the solves of the traced
sub-window. The kernels are picked out by the symbol the port gives them
(``hpcg_work.SYMGS_KERNEL``, ``spmx_symgs_color``), not by a range: the
V-cycle runs as one CUDA graph replay, whose kernels all fall in the range
of its launch. A program without the kernel reads nothing."""

from portbench.hpcg_work import symgs_device_s


def read(run):
    tr = run.trace
    if tr is None or not run.trace_requests:
        return None
    s = symgs_device_s(tr)
    return s * 1e3 / run.trace_requests if s else None
