"""``device_idle.spgemm`` (%, device trace): 1 - the union of the device
operations' intervals over the span of the traced sub-window of
products."""

from portbench.tracing import device_idle_pct


def read(run):
    return device_idle_pct(run.trace)
