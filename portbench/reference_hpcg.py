"""HPCG 3.1 written plainly on grid tensors: its 27-point problem, its
multigrid preconditioner and its conjugate-gradient set.

The High Performance Conjugate Gradients benchmark (Dongarra, Heroux,
Luszczek; hpcg-benchmark.org), reference code ``GenerateProblem``,
``GenerateCoarseProblem``, ``ComputeSPMV``, ``ComputeSYMGS``,
``ComputeMG`` and ``CG``, on one process:

* the operator on an ``nx * ny * nz`` grid, row ``ix + nx (iy + ny iz)``:
  26 on the diagonal and -1 to each of the up to 26 in-grid neighbours, so
  ``A x = 26 x - (the sum of the 26 zero-padded shifts of x)``;
  ``b = A 1``, ``x0 = 0``;
* the preconditioner: ``levels`` grids, each the last halved in every
  dimension and the same stencil regenerated there (no Galerkin product);
  restriction by injection at the points ``(2 izc, 2 iyc, 2 ixc)``
  (``rc = (r - A x)[::2, ::2, ::2]``), prolongation by adding there
  (``x[::2, ::2, ::2] += xc``); one symmetric Gauss-Seidel step (a forward
  sweep, then a backward one) before and one after on every level but the
  coarsest, and one step from zero on the coarsest;
* CG as HPCG's ``CG``: ``maxiter`` iterations, stopping early only where
  ``||r|| / ||r0||`` falls to ``tol`` or below.

Departures from HPCG's reference code:

* **Colour order.** HPCG's ``ComputeSYMGS`` sweeps the rows in their
  natural order. Here a sweep visits eight colours, ``c = (ix & 1) + 2 (iy
  & 1) + 4 (iz & 1)``, 0 to 7 forward and 7 to 0 backward, and updates all
  rows of a colour at once from the current x. No two rows of one colour
  are coupled by the stencil, so this is exact Gauss-Seidel in that order
  of the rows; HPCG's rules allow an optimised run to reorder so, and GPU
  runs of HPCG use multicolouring.
* **The update of a row** is ``(r_i + s_i) / 26`` with ``s_i`` the sum of
  its in-grid neighbours, where HPCG subtracts every product of the row,
  the diagonal's included, and adds the diagonal's back. The sums are
  taken in another order, so the last bits differ.
* **Neighbour sums** are taken as the 3 x 3 x 3 box sum of the zero-padded
  grid, one axis at a time, less the centre: the sum of the 26 shifts in
  another order.

Everything runs in the dtype of the right-hand side given (float64 for the
reference; float32 for the control that must fail). TF32 is switched off
for matrix products and convolutions, though no such operation is used.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = [
    "HpcgSet",
    "apply_a",
    "cg_set",
    "hpcg_rhs",
    "neighbour_sum",
    "symgs",
    "vcycle",
]

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: the diagonal of every row
DIAGONAL = 26.0


class HpcgSet(NamedTuple):
    x: torch.Tensor  # (nx * ny * nz,) in the natural row order
    iterations: int
    residual_ratio: float  # ||r|| / ||r0|| of the recurrence, as HPCG reports it


def _box(xp: torch.Tensor, pz: int, py: int, px: int) -> torch.Tensor:
    """The 3 x 3 x 3 box sums of the zero-padded grid ``xp`` (nz + 2, ny +
    2, nx + 2) at the points ``(pz::2, py::2, px::2)`` of the grid, or at
    every point where each parity is None; one axis at a time."""
    nz, ny, nx = (s - 2 for s in xp.shape)

    def along(t, dim, n, p):
        # grid point g sums the padded positions g, g + 1 and g + 2
        idx = [slice(None)] * 3
        out = None
        for d in range(3):
            idx[dim] = slice(d, d + n) if p is None else slice(p + d, d + n, 2)
            out = t[tuple(idx)] if out is None else out + t[tuple(idx)]
        return out

    t = along(xp, 2, nx, px)
    t = along(t, 1, ny, py)
    return along(t, 0, nz, pz)


def neighbour_sum(x3: torch.Tensor) -> torch.Tensor:
    """The sum of each point's in-grid neighbours (the 26 zero-padded
    shifts), for every point of the grid ``x3`` (nz, ny, nx)."""
    xp = torch.nn.functional.pad(x3, (1, 1, 1, 1, 1, 1))
    return _box(xp, None, None, None) - x3


def apply_a(x3: torch.Tensor) -> torch.Tensor:
    """``A x`` on the grid: ``26 x - the neighbour sum``."""
    return DIAGONAL * x3 - neighbour_sum(x3)


def symgs(x3: torch.Tensor, r3: torch.Tensor) -> torch.Tensor:
    """One symmetric Gauss-Seidel step toward ``A x = r`` from ``x3``: the
    colours 0..7, then 7..0, each colour's points updated at once from the
    current x. Returns the new grid (``x3`` is not written)."""
    x3 = x3.clone()
    for c in (*range(8), *range(7, -1, -1)):
        pz, py, px = c >> 2, (c >> 1) & 1, c & 1
        sub = (slice(pz, None, 2), slice(py, None, 2), slice(px, None, 2))
        xp = torch.nn.functional.pad(x3, (1, 1, 1, 1, 1, 1))
        s = _box(xp, pz, py, px) - x3[sub]
        x3[sub] = (r3[sub] + s) / DIAGONAL
    return x3


def vcycle(r3: torch.Tensor, levels: int) -> torch.Tensor:
    """HPCG's ``ComputeMG`` on the grid residual ``r3``: ``M^-1 r`` as a
    grid, from x = 0."""
    x3 = symgs(torch.zeros_like(r3), r3)
    if levels <= 1:
        return x3
    rc = (r3 - apply_a(x3))[::2, ::2, ::2]
    x3[::2, ::2, ::2] += vcycle(rc.contiguous(), levels - 1)
    return symgs(x3, r3)


def hpcg_rhs(nx: int, ny: int, nz: int, *, dtype=torch.float64, device="cpu") -> torch.Tensor:
    """HPCG's ``b = A 1``: ``26 - (in-grid neighbours)`` at each row."""
    return apply_a(torch.ones((nz, ny, nx), dtype=dtype, device=device)).reshape(-1)


def _dot(u, v):
    return (u * v).sum()


def cg_set(b: torch.Tensor, nx: int, ny: int, nz: int, *, levels: int = 4,
           maxiter: int = 50, tol: float = 0.0) -> HpcgSet:
    """One HPCG set from x0 = 0 on ``b`` (the natural row order), in b's
    dtype: HPCG's ``CG`` with the ``levels``-level V-cycle, ``maxiter``
    iterations, stopping early only where ``||r|| / ||r0|| <= tol``."""
    shape = (nz, ny, nx)
    x = torch.zeros(shape, dtype=b.dtype, device=b.device)
    r = b.reshape(shape) - apply_a(x)
    normr0 = float(torch.sqrt(_dot(r, r)))
    normr = normr0
    p = rtz = None
    k = 0
    while k < maxiter and normr / normr0 > tol:
        k += 1
        z = vcycle(r, levels)
        if k == 1:
            p = z.clone()
            rtz = _dot(r, z)
        else:
            old = rtz
            rtz = _dot(r, z)
            p = z + (rtz / old) * p
        ap = apply_a(p)
        alpha = rtz / _dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        normr = float(torch.sqrt(_dot(r, r)))
    return HpcgSet(x.reshape(-1), k, normr / normr0)
