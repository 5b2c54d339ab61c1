"""``solve_ms.ilu`` (ms, host clock): ``solve_ms`` read in the cells where
the host's pace spreads it too widely for a bound, the measured window
over the right-hand sides solved in it, every request counted."""


def read(run):
    return run.window_s * 1e3 / run.requests if run.requests else None
