"""``solve_ms_p95`` (ms): the 95th percentile of the window's solves, each
timed by CUDA events, timestamps the device writes in its own stream (the
clock its trace reads), from the call until the answer's last operation,
so the host's gaps inside the solve count."""

import numpy as np

#: the harness times each request of the window by CUDA events
LATENCIES = True


def read(run):
    if not run.latencies_ms:
        return None
    return float(np.percentile(np.asarray(run.latencies_ms), 95))
