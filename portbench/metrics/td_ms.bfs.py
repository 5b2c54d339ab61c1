"""``td_ms.bfs`` (ms/solve, device trace): the device time of the top-down
kernels (named ``spmx_bfs_td*``, ``bfs_work.TD_KERNELS``: the search's
start, each top-down step's claims and their finishing pass) over the
searches of the traced sub-window. A program without them reads
nothing."""

from portbench.bfs_work import TD_KERNELS, kernels_device_s


def read(run):
    tr = run.trace
    if tr is None or not run.trace_requests:
        return None
    s = kernels_device_s(tr, TD_KERNELS)
    return s * 1e3 / run.trace_requests if s else None
