"""``iterations.ilu`` (program counter): ``iterations`` in the cells whose
end-to-end solve time is the tail, ``solve_ms_p95``: the mean of the
solver's own ``CgResult.iterations`` over the solves of the window."""


def read(run):
    return sum(run.iterations) / len(run.iterations) if run.iterations else None
