"""``iterations`` (program counter): the mean of the solver's own
``CgResult.iterations`` over the solves of the measured window."""


def read(run):
    return sum(run.iterations) / len(run.iterations) if run.iterations else None
