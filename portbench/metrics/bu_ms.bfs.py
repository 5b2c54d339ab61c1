"""``bu_ms.bfs`` (ms/solve, device trace): the device time of the
bottom-up kernels (named ``spmx_bfs_bu*``, ``bfs_work.BU_KERNELS``: each
bottom-up step and the frontier's conversions between queue and bitmap)
over the searches of the traced sub-window. A program without them reads
nothing."""

from portbench.bfs_work import BU_KERNELS, kernels_device_s


def read(run):
    tr = run.trace
    if tr is None or not run.trace_requests:
        return None
    s = kernels_device_s(tr, BU_KERNELS)
    return s * 1e3 / run.trace_requests if s else None
