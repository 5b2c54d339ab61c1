"""``solve_ms`` (ms, host clock): the measured window over the right-hand
sides solved in it, every request of the window counted."""


def read(run):
    return run.window_s * 1e3 / run.requests if run.requests else None
