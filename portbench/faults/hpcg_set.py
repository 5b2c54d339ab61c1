"""Planted faults of traffic kind ``hpcg_set``: a set runs through
``amg_pcg_solve``, PCG's steps, so ``solve_loop``'s faults reach it and
break it the same way (see ``faults/solve_loop.py``)."""

from __future__ import annotations

from portbench.faults.solve_loop import altered_answers, unchanged_steps

#: the comparison each fault must push past its limit
CHECK = "residual"

FAULTS = {"unchanged_steps": unchanged_steps, "altered_answers": altered_answers}
