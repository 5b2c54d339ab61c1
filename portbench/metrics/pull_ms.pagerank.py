"""``pull_ms.pagerank`` (ms/solve, device trace): device time of the
operations launched inside the benchmark's range around the PageRank
operator (``portbench.matvec``: every pull), over the rankings of the
traced sub-window."""


def read(run):
    tr = run.trace
    if tr is None or not run.trace_requests:
        return None
    s = tr.device_s_in("portbench.matvec")
    return None if not s else s * 1e3 / run.trace_requests
