"""``spgemm_ms`` (ms, host clock): the measured window over the refreshed
products completed in it, C ready on the device for each."""


def read(run):
    return run.window_s * 1e3 / run.requests if run.requests else None
