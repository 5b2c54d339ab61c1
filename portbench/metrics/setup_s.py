"""``setup_s`` (s, host clock): from the start of the process to the
start of the measured window: imports, the device's start, the matrix,
the plans, the pool, the warm-up request and, in a checkout's first run,
the build of the port's kernels."""


def read(run):
    return run.setup_s
