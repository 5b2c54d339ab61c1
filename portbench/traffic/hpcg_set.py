"""Traffic kind ``hpcg_set``: HPCG's conjugate-gradient sets, one after
another, each waited for (HPCG 3.1 run with one process a card).

A request is one set: ``amg_pcg_solve(A, b, hierarchy=h, tol, maxiter)``
from x0 = 0 in the configuration's dtype, with ``h`` the port's
``hpcg_hierarchy`` on the configuration's grid (built once in set-up) and
``A`` its finest operator (``amg_pcg_solve`` runs the hierarchy's own).

Cell parameters (``workloads/<cell>.json``, ``params``):

* ``levels``: the multigrid's levels (HPCG's 4);
* ``solver_kw``: ``tol`` and ``maxiter`` of a set (HPCG's 0 and 50: every
  set runs 50 iterations);
* ``pool``: right-hand sides made once on the device from the seed:
  entry 0 is HPCG's ``b = A 1``, entry ``k > 0`` is ``A u_k`` with ``u_k``
  standard normal; request i solves entry ``i % pool``;
* ``check_samples``, ``trace_requests``, ``warm_requests``: see
  ``harness.py``;
* ``control``: the ``dtype`` in which the plain reference
  (``reference_hpcg.py``) answers in the program's place.

Each sampled answer is compared in float64 with the plain reference's
own set on the same b (``reference_hpcg.cg_set``, float64, the same
levels, tolerance and iterations): ``iterations``, how far its count
lies from ``maxiter``; ``residual``, its ``||b - A x|| / ||b||`` less the
reference's; ``x_error``, ``||x - x_ref|| / ||x_ref||``. The worst of
each is held to ``limits``. A run reads the outer matvec (the finest
operator) and ``M^-1`` inside the benchmark's ranges, as ``solve_loop``
does for AMG.
"""

from __future__ import annotations

import math

from portbench import hpcg_work
from portbench import reference_hpcg as ref
from portbench.roofline import occupied_diagonals, spmv_work
from portbench.traffic.solve_loop import Answer, _RangedHierarchy


def _finite(v: float) -> float:
    """``v``, or inf where it is not a number (so it fails every limit)."""
    return v if not math.isnan(v) else math.inf


class Traffic:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.params
        self._ranges = False
        g = ctx.config["generator_params"]
        self.grid = (int(g["nx"]), int(g["ny"]), int(g["nz"]))

    # -- set-up --------------------------------------------------------------

    def setup(self):
        import sparse_matrix_tpu_torch.solvers.amg as amg
        from sparse_matrix_tpu_torch.solvers.hpcg import hpcg_hierarchy

        ctx = self.ctx
        nx, ny, nz = self.grid
        dtype = getattr(ctx.torch, ctx.config["dtype"])
        self.hier = ctx.plan("hpcg_hierarchy", lambda: hpcg_hierarchy(
            nx, ny, nz, device=ctx.device, dtype=dtype, levels=int(self.p["levels"])))
        self.amg = amg
        self.pool = self._pool()

    def _pool(self):
        """The seeded right-hand sides, (pool, rows), in float64."""
        torch, ctx = self.ctx.torch, self.ctx
        nx, ny, nz = self.grid
        k = int(self.p["pool"])
        u = torch.randn((k - 1, nx * ny * nz), generator=ctx.generator(), device=ctx.device,
                        dtype=torch.float64)
        rows = [ref.hpcg_rhs(nx, ny, nz, dtype=torch.float64, device=ctx.device)]
        rows += [ref.apply_a(u[i].reshape(nz, ny, nx)).reshape(-1) for i in range(k - 1)]
        return torch.stack(rows)

    def set_ranges(self, on: bool):
        self._ranges = bool(on)

    # -- requests ------------------------------------------------------------

    def request(self, i: int) -> Answer:
        j = i % int(self.p["pool"])
        kw = self.p["solver_kw"]
        hier = _RangedHierarchy(self.hier) if self._ranges else self.hier
        res = self.amg.amg_pcg_solve(self.hier.levels[0].a_op, self.pool[j], hierarchy=hier,
                                     tol=float(kw["tol"]), maxiter=int(kw["maxiter"]))
        it = int(res.iterations)
        return Answer(res.x, j, it, it != int(kw["maxiter"]))

    def release(self):
        """Free the program's state; the sampled answers stay."""
        self.hier = self.pool = self.amg = None

    # -- comparison ----------------------------------------------------------

    def _reference(self, b, dtype):
        nx, ny, nz = self.grid
        kw = self.p["solver_kw"]
        return ref.cg_set(b.to(dtype), nx, ny, nz, levels=int(self.p["levels"]),
                          maxiter=int(kw["maxiter"]), tol=float(kw["tol"]))

    def _residual(self, x, b) -> float:
        nx, ny, nz = self.grid
        r = b - ref.apply_a(x.reshape(nz, ny, nx)).reshape(-1)
        return float(r.norm()) / float(b.norm())

    def check(self, samples):
        """The worst of each comparison over the sampled answers, in
        float64, against the reference's float64 set on the same b."""
        torch = self.ctx.torch
        pool = self._pool()
        maxiter = int(self.p["solver_kw"]["maxiter"])
        refs = {}
        worst = {"iterations": 0.0, "residual": 0.0, "x_error": 0.0}
        for _i, ans in samples:
            b = pool[ans.j]
            if ans.j not in refs:
                xr = self._reference(b, torch.float64).x
                refs[ans.j] = (xr, self._residual(xr, b))
            xr, res_ref = refs[ans.j]
            x = ans.x.to(device=b.device, dtype=torch.float64)
            got = {"iterations": float(abs(int(ans.iterations) - maxiter)),
                   "residual": self._residual(x, b) - res_ref,
                   "x_error": float((x - xr).norm()) / float(xr.norm())}
            for k, v in got.items():
                worst[k] = max(worst[k], _finite(v))
        lim = self.ctx.workload["limits"]
        return {k: {"value": v, "limit": float(lim[k])} for k, v in worst.items()}

    def control(self, count: int):
        """Answers of the plain reference in the control's dtype, put in
        the program's place, for the first ``count`` pool entries."""
        torch = self.ctx.torch
        dtype = getattr(torch, self.ctx.workload["control"]["dtype"])
        pool = self._pool()
        out = []
        for j in range(min(count, pool.shape[0])):
            s = self._reference(pool[j], dtype)
            out.append((j, Answer(s.x, j, s.iterations, False)))
        return out

    def work(self):
        m = self.ctx.matrix
        nbytes, flops = spmv_work(m.rows, m.cols, m.nnz(),
                                  occupied_diagonals(m.row_ids(), m.indices),
                                  value_bytes=hpcg_work.VALUE_BYTES)
        return {"matvec_bytes": nbytes, "matvec_flops": flops,
                "symgs_vcycle_s": hpcg_work.vcycle_symgs_s(*self.grid, int(self.p["levels"]))}
