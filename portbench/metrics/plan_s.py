"""``plan_s`` (s, host clock): the cell's plans inside set-up, each timed
to the end of its device work: the operator, the preconditioner
(``amg_setup`` whole for AMG: coarsening, operator plans, pseudo-inverse,
upload) and the SpGEMM plan (``EscSpgemm.__init__``)."""


def read(run):
    return run.plan_s
