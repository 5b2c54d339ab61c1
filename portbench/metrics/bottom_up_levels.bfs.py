"""``bottom_up_levels.bfs`` (levels/solve, program counter): the mean of
the program's own ``BfsResult.bottom_up_levels`` over the searches of the
traced sub-window (the traffic's ``work()``): whether, and for how many
steps, the direction switch engages."""


def read(run):
    return run.work.get("bottom_up_levels")
