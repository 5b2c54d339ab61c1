"""Traffic kind ``solve_loop``: a library caller solving ``A x = b`` for
one seeded right-hand side after another, waiting for each answer.

Cell parameters (``workloads/<cell>.json``, ``params``):

* ``solver``: ``"cg"`` (``cg_solve`` over the automatically dispatched
  ``SpmvOperator``), ``"pcg"`` (``pcg_solve``), ``"bicgstab"``
  (``bicgstab_solve``) or ``"amg_pcg"`` (``amg_pcg_solve`` with a
  hierarchy built once);
* ``solver_kw``: ``tol``, ``maxiter`` and the entry's other keywords;
* ``preconditioner``: null, ``"ilu0"`` (``ilu_preconditioner``),
  ``"ic0"`` (``ic_preconditioner``) or ``"jacobi"``, with
  ``preconditioner_kw``; ``amg_kw`` for ``amg_setup``;
* ``pool``: right-hand sides drawn once on the device from the seed
  (float32 standard normal), request i solving pool entry ``i % pool``;
* ``check_samples``, ``trace_requests``: see ``harness.py``;
* ``control``: the plain reference solver (``"cg"`` or ``"bicgstab"``),
  its ``dtype`` and ``maxiter``, put in the program's place by
  ``control.py``.

The answer of each sampled request is held to ``limits.residual``:
``||b - A x|| / ||b||`` with A the float32 matrix the program was given,
in float64.
"""

from __future__ import annotations

import time
from typing import NamedTuple

from portbench import reference
from portbench.generators.csr import Csr
from portbench.roofline import occupied_diagonals, spmv_work
from portbench.tracing import ranged


class Answer(NamedTuple):
    x: object
    j: int  # pool entry
    iterations: int
    failed: bool


def program_matrix(csr: Csr, dtype):
    """The port's host ``CsrMatrix`` of a generator's matrix, values in
    ``dtype``."""
    from sparse_matrix_tpu_torch.formats.csr import CsrMatrix

    return CsrMatrix(csr.rows, csr.cols, csr.vals.astype(dtype), csr.indices, csr.offsets,
                     is_sorted=True)


class Traffic:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.params
        self._ranges = False

    # -- set-up --------------------------------------------------------------

    def setup(self):
        import numpy as np
        import sparse_matrix_tpu_torch.solvers.amg as amg
        import sparse_matrix_tpu_torch.solvers.bicgstab as bicgstab
        import sparse_matrix_tpu_torch.solvers.cg as cg
        import sparse_matrix_tpu_torch.solvers.ilu as ilu
        from sparse_matrix_tpu_torch.ops.operator import SpmvOperator

        ctx, p = self.ctx, self.p
        torch, dev = ctx.torch, ctx.device
        a = program_matrix(ctx.matrix, np.dtype(ctx.config["dtype"]))
        solver = p["solver"]
        self.hier = self.op = self.m_inv = None
        if solver == "amg_pcg":
            marks = []

            def on_phase(level, name, **info):
                ctx.sync()
                marks.append((f"amg_setup.{level}.{name}", time.perf_counter()))

            def setup():
                marks.append(("start", time.perf_counter()))
                return amg.amg_setup(a, device=dev, on_phase=on_phase, **p.get("amg_kw", {}))

            self.hier = ctx.plan("amg_setup", setup)
            for (_, t0), (label, t1) in zip(marks, marks[1:]):
                ctx.note(label, t1 - t0)
            self.entry = amg.amg_pcg_solve
        else:
            self.op = ctx.plan("operator", lambda: SpmvOperator(a, device=dev))
            self.entry = {"cg": cg.cg_solve, "pcg": cg.pcg_solve, "bicgstab": bicgstab.bicgstab_solve}[solver]
        pre = p.get("preconditioner")
        if pre:
            kw = p.get("preconditioner_kw", {})
            make = {"ilu0": lambda: ilu.ilu_preconditioner(a, device=dev, **kw),
                    "ic0": lambda: ilu.ic_preconditioner(a, device=dev, **kw),
                    "jacobi": lambda: cg.jacobi_preconditioner(a, dev)}[pre]
            self.m_inv = ctx.plan("preconditioner", make)
        self.a_program = a
        self.pool = self._pool()

    def _given(self):
        """The generator's matrix with the values the program is given."""
        import numpy as np

        return self.ctx.matrix.astype(np.dtype(self.ctx.config["dtype"]))

    def _pool(self):
        torch, ctx = self.ctx.torch, self.ctx
        return torch.randn((int(self.p["pool"]), ctx.matrix.rows), generator=ctx.generator(), device=ctx.device,
                           dtype=torch.float32)

    def set_ranges(self, on: bool):
        self._ranges = bool(on)

    # -- requests ------------------------------------------------------------

    def solve(self, b):
        kw = dict(self.p.get("solver_kw", {}))
        solver = self.p["solver"]
        op, m_inv, hier = self.op, self.m_inv, self.hier
        if self._ranges:
            if hier is not None:
                hier = _RangedHierarchy(hier)
            else:
                op = ranged(op, "portbench.matvec")
                if m_inv is not None:
                    m_inv = ranged(m_inv, "portbench.precond")
        if solver == "amg_pcg":
            return self.entry(self.a_program, b, hierarchy=hier, **kw)
        if solver == "cg":
            return self.entry(op, b, **kw)
        if solver == "pcg":
            return self.entry(op, b, m_inv, **kw)
        return self.entry(op, b, m_inv=m_inv, **kw)

    def request(self, i: int) -> Answer:
        j = i % int(self.p["pool"])
        res = self.solve(self.pool[j])
        it = int(res.iterations)
        return Answer(res.x, j, it, it >= int(self.p["solver_kw"]["maxiter"]))

    def release(self):
        """Free the program's state; the sampled answers stay."""
        self.hier = self.op = self.m_inv = self.pool = self.entry = None
        self.a_program = None

    # -- comparison ----------------------------------------------------------

    def check(self, samples):
        """The worst residual of the sampled answers, in float64."""
        torch = self.ctx.torch
        a64 = reference.upload(self._given(), self.ctx.device, torch.float64)
        pool = self._pool()
        worst = 0.0
        for _i, ans in samples:
            worst = max(worst, reference.residual_ratio(a64, ans.x, pool[ans.j]))
        return {"residual": {"value": worst, "limit": float(self.ctx.workload["limits"]["residual"])}}

    def control(self, count: int):
        """Answers of the plain reference solver in the control's dtype,
        put in the program's place, for the first ``count`` pool entries."""
        torch = self.ctx.torch
        c = self.ctx.workload["control"]
        dtype = getattr(torch, c["dtype"])
        a = reference.upload(self._given(), self.ctx.device, dtype)
        solve = {"cg": reference.cg, "bicgstab": reference.bicgstab}[c["solver"]]
        pool = self._pool()
        tol = float(self.p["solver_kw"]["tol"])
        out = []
        for j in range(min(count, pool.shape[0])):
            x, it = solve(a, pool[j], tol=tol, maxiter=int(c["maxiter"]))
            out.append((j, Answer(x, j, it, False)))
        return out

    def work(self):
        m = self.ctx.matrix
        nbytes, flops = spmv_work(m.rows, m.cols, m.nnz(),
                                  occupied_diagonals(m.row_ids(), m.indices))
        return {"matvec_bytes": nbytes, "matvec_flops": flops}


class _RangedHierarchy:
    """An ``AmgHierarchy`` seen by ``amg_pcg_solve`` with the benchmark's
    ranges around its outer Krylov matvec (the finest operator) and its
    ``M^-1`` (the V-cycle)."""

    def __init__(self, hier):
        self._h = hier
        self.levels = hier.levels
        self.device = hier.device
        self.dtype = hier.dtype
        outer = hier.outer_a_op if hier.outer_a_op is not None else hier.levels[0].a_op
        self.outer_a_op = ranged(outer, "portbench.matvec")

    def preconditioner(self):
        return ranged(self._h.preconditioner(), "portbench.precond")
