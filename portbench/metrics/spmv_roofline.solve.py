"""``spmv_roofline.solve`` (%, device trace): the outer Krylov matvec's
least time (its compulsory bytes, the matrix in its smallest plain form
with x read and y written once, over the HBM peak; or its operations
over the float32 peak, whichever is longer; ``roofline.spmv_work``) times
the applies in the traced sub-window, over the device time of the
operations launched inside the benchmark's range around it. The same
work whatever format or kernel does it."""

from portbench.roofline import bound_s


def read(run):
    tr = run.trace
    if tr is None or "matvec_bytes" not in run.work:
        return None
    s, n = tr.device_s_in("portbench.matvec"), tr.count("portbench.matvec")
    if not s or not n:
        return None
    return 100.0 * n * bound_s(run.work["matvec_bytes"], run.work["matvec_flops"]) / s
