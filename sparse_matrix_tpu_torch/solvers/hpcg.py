"""HPCG on the port: the 27-point problem and HPCG's geometric multigrid as
an :class:`~.amg.AmgHierarchy`, solved through ``amg_pcg_solve``.

The High Performance Conjugate Gradients benchmark (HPCG 3.1; Dongarra,
Heroux, Luszczek; hpcg-benchmark.org), one process:

* :func:`hpcg_problem` is its ``GenerateProblem``: on an ``nx * ny * nz``
  grid, row ``ix + nx (iy + ny iz)`` holds 26 on the diagonal and -1 for
  each in-grid neighbour of the 27-point stencil, columns ascending; ``b =
  A 1``, so ``b_i = 26 - (nnz_i - 1)``.
* :func:`hpcg_hierarchy` is its ``GenerateCoarseProblem`` and
  ``ComputeMG``: ``levels`` grids, each the last halved in every dimension
  with the stencil regenerated there (no Galerkin product), every level's
  A a planned :class:`~..ops.operator.SpmvOperator` (the dispatch takes
  DIA), restriction by injection ``rc = (r - A x)[f2c]`` and prolongation
  ``x[f2c] += xc`` at ``f2c[i] = 2 ixc + nx (2 iyc + ny 2 izc)`` (an index
  gather and an index copy, no SpMV), one symmetric Gauss-Seidel step
  before and after on every level but the coarsest (``smoother="symgs"``,
  ``nu=1``) and one from zero on the coarsest.

A set is then ``amg_pcg_solve(A, b, hierarchy=h, tol=0.0, maxiter=50)``
from x0 = 0, in float64. The Gauss-Seidel sweeps visit the 8 parity
colours of the grid (``ops/symgs.py``) where HPCG's reference code sweeps
the rows in natural order: a reordering HPCG's rules allow an optimised
run, and what GPU runs of HPCG do. ``sparse_matrix_tpu_torch/reference/
hpcg.py`` is the plain version the tests hold this to.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..formats.csr import CsrMatrix
from ..utils.profiling import span

__all__ = ["hpcg_problem", "hpcg_hierarchy", "coarse_points"]

#: the diagonal of every row
DIAGONAL = 26.0


def hpcg_problem(nx: int, ny: int, nz: int, *, dtype=np.float64) -> Tuple[CsrMatrix, np.ndarray]:
    """HPCG's ``GenerateProblem`` on one process: ``(A, b)``, A a sorted
    host CSR of the 27-point operator and ``b = A 1``."""
    if min(nx, ny, nz) < 1:
        raise ValueError(f"hpcg_problem: grid {nx} x {ny} x {nz} is empty")
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    ix, iy, iz = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    cols, ok = [], []
    # HPCG's loops over sz, sy, sx give each row's columns in ascending order
    for sz in (-1, 0, 1):
        for sy in (-1, 0, 1):
            for sx in (-1, 0, 1):
                cols.append(idx + sx + nx * (sy + ny * sz))
                ok.append((ix + sx >= 0) & (ix + sx < nx) & (iy + sy >= 0) & (iy + sy < ny)
                          & (iz + sz >= 0) & (iz + sz < nz))
    cols, ok = np.stack(cols, axis=1), np.stack(ok, axis=1)
    vals = np.where(cols == idx[:, None], DIAGONAL, -1.0).astype(dtype)
    counts = ok.sum(axis=1)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    a = CsrMatrix(n, n, vals[ok], cols[ok].astype(np.uint32), offsets, is_sorted=True)
    b = (DIAGONAL - (counts - 1)).astype(dtype)
    return a, b


def coarse_points(nx: int, ny: int, nz: int) -> np.ndarray:
    """HPCG's ``f2c`` of the grid halved from ``nx * ny * nz``: the fine row
    of each coarse row ``ixc + (nx/2) (iyc + (ny/2) izc)``, int64."""
    ncx, ncy, ncz = nx // 2, ny // 2, nz // 2
    i = np.arange(ncx * ncy * ncz, dtype=np.int64)
    ixc, iyc, izc = i % ncx, (i // ncx) % ncy, i // (ncx * ncy)
    return 2 * ixc + nx * (2 * iyc + ny * 2 * izc)


class _Restrict:
    """Injection ``r[f2c]`` of a vector: HPCG's restriction of the
    residual ``r - A x`` the V-cycle forms."""

    def __init__(self, f2c: torch.Tensor, fine_rows: int):
        self.f2c, self.rows, self.cols = f2c, int(f2c.numel()), fine_rows

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return v.index_select(0, self.f2c)


class _Prolong:
    """The fine-grid vector that is ``xc`` at ``f2c`` and 0 elsewhere, so
    the V-cycle's ``x + P xc`` is HPCG's ``x[f2c] += xc``."""

    def __init__(self, f2c: torch.Tensor, fine_rows: int):
        self.f2c, self.rows, self.cols = f2c, fine_rows, int(f2c.numel())

    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        return v.new_zeros(self.rows).index_copy_(0, self.f2c, v)


def hpcg_hierarchy(nx: int, ny: int, nz: int, *, device, dtype=torch.float64,
                   levels: int = 4):
    """HPCG's multigrid on an ``nx * ny * nz`` grid as an
    :class:`~.amg.AmgHierarchy` on ``device`` in ``dtype``: ``levels - 1``
    smoothed levels and a coarsest level smoothed from zero, each with its
    operator (planned by :class:`~..ops.operator.SpmvOperator`), its parity
    colouring and its :class:`~..ops.symgs.SymgsPlan`; smoother
    ``"symgs"``, ``nu=1``. A grid whose sides are not divisible by
    ``2^(levels - 1)`` is refused, as HPCG refuses it. The build is the
    span ``spmx.plan.hpcg``."""
    from ..device import require_device
    from ..formats.dia import try_dia_from_csr
    from ..ops.operator import _NP_DTYPES, SpmvOperator
    from ..ops.symgs import SymgsPlan, parity_colors
    from .amg import AmgHierarchy, AmgLevel

    if levels < 1:
        raise ValueError(f"hpcg_hierarchy: levels must be >= 1, got {levels}")
    step = 1 << (levels - 1)
    if min(nx, ny, nz) < step or nx % step or ny % step or nz % step:
        raise ValueError(f"hpcg_hierarchy: grid {nx} x {ny} x {nz} is not divisible by "
                         f"2^{levels - 1} = {step} in every dimension ({levels} levels)")
    dev = require_device(device)
    np_dtype = _NP_DTYPES[dtype]
    with span("spmx.plan.hpcg"):
        built = []
        for lvl in range(levels):
            gx, gy, gz = nx >> lvl, ny >> lvl, nz >> lvl
            a, _b = hpcg_problem(gx, gy, gz, dtype=np_dtype)
            op = SpmvOperator(a, device=dev, dtype=dtype)
            dia = try_dia_from_csr(a, dtype=np_dtype)
            if dia is None:
                raise ValueError(f"hpcg_hierarchy: the {gx} x {gy} x {gz} level has no DIA form "
                                 "for its Gauss-Seidel planes")
            plan = SymgsPlan(dia, parity_colors(gx, gy, gz), device=dev, dtype=dtype)
            p_op = pt_op = None
            if lvl + 1 < levels:
                f2c = torch.from_numpy(coarse_points(gx, gy, gz)).to(dev)
                p_op, pt_op = _Prolong(f2c, a.rows), _Restrict(f2c, a.rows)
            built.append(AmgLevel(a_op=op, p_op=p_op, pt_op=pt_op, dinv=None, lam=None,
                                  n=a.rows, nnz=a.nnz(), symgs=plan))
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return AmgHierarchy(built[:-1], None, smoother="symgs", nu=1, coarse_level=built[-1])
