"""``device_idle.ilu`` (%, device trace): ``device_idle.solve`` in the
cells whose end-to-end solve time is the tail, ``solve_ms_p95``: 1 - the
union of the device operations' intervals over the span of the traced
sub-window of solves."""

from portbench.tracing import device_idle_pct


def read(run):
    return device_idle_pct(run.trace)
