"""``spgemm_device_ms`` (ms, device trace): device time of the operations
launched inside the benchmark's range around ``multiply_device``, per
product of the traced sub-window."""


def read(run):
    tr = run.trace
    if tr is None:
        return None
    s, n = tr.device_s_in("portbench.multiply"), tr.count("portbench.multiply")
    return None if not s or not n else s * 1e3 / n
