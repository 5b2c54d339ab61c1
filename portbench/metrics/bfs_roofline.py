"""``bfs_roofline`` (%, device trace): the least time of the traced
searches (``bfs_work.bfs_bytes`` of each traced root, from the reference's
reached count, over the HBM peak; ``roofline.bound_s``) over the device
time of the operations launched inside their ``portbench.request``
ranges. The same work whatever implements the search."""

from portbench.roofline import bound_s


def read(run):
    tr = run.trace
    if tr is None or "bfs_bytes" not in run.work:
        return None
    s = tr.device_s_in("portbench.request")
    if not s:
        return None
    return 100.0 * bound_s(run.work["bfs_bytes"], 0.0) / s
