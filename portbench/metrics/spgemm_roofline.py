"""``spgemm_roofline`` (%, device trace): a refreshed product's least time
(A's and B's values and patterns read once, C's values written once, over
the HBM peak; or its operations over the float32 peak, whichever is
longer; ``roofline.spgemm_refresh_work``) times the products of the
traced sub-window, over the device time inside the benchmark's range
around ``multiply_device``."""

from portbench.roofline import bound_s


def read(run):
    tr = run.trace
    if tr is None or "spgemm_bytes" not in run.work:
        return None
    s, n = tr.device_s_in("portbench.multiply"), tr.count("portbench.multiply")
    if not s or not n:
        return None
    return 100.0 * n * bound_s(run.work["spgemm_bytes"], run.work["spgemm_flops"]) / s
