"""Conjugate-gradient solvers driven by a pluggable matvec.

Counterpart of ``sparse_matrix_tpu/solvers/cg.py``: the same recurrences
and stopping rule (iterate while ``rs > tol^2 * |b|^2`` and
``k < maxiter``), written as Python loops over tensors instead of
``lax.while_loop``. Each iteration reads the residual norm to the host
once to test the stopping rule; that read waits for the device, so every
iteration pays one host-device synchronisation (CUDA graphs would remove
it; see PERF.md). Spans (``utils/profiling.py``, off by default) mark
each solve (``spmx.solve``), its outer matvecs (``spmx.krylov.matvec``),
its ``M^-1`` (``spmx.krylov.precond``) and its host reads
(``spmx.krylov.sync``). The matvec is any callable on tensors, typically an
:class:`~sparse_matrix_tpu_torch.ops.operator.SpmvOperator`.

On a CUDA vector, :func:`cg_solve` and :func:`pcg_solve` run their
iterations' vector work as the fused kernels of ``csrc/krylov_update.cu``
(a :class:`~sparse_matrix_tpu_torch.native.kernels.KrylovScratch` a
solve): an inner product ``p . Ap``, one pass that updates x and r in place
and takes ``r . r``, and one that updates p in place, with alpha and beta
read from 0-d device scalars inside the kernels. The solve owns the
vectors they write (x, the fresh residual, and p, copied once from r or
z); nothing the caller passed is written. On the CPU the steps are the
plain PyTorch expressions.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..native.kernels import KrylovScratch
from ..utils.profiling import span

__all__ = [
    "CgResult",
    "cg_solve",
    "cg_solve_ir",
    "cg_solve_multi",
    "pcg_solve",
    "pcg_solve_multi",
    "jacobi_preconditioner",
]


class CgResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual_norm: torch.Tensor  # 0-d ((K,) for the multi-RHS solvers), on x's device


def _tol2_t(tol: float, b_norm2: torch.Tensor) -> torch.Tensor:
    """``tol^2 * |b|^2`` (``|b|^2`` replaced by 1 when b = 0), taken in the
    working dtype as the reference does; elementwise over K columns."""
    t = torch.tensor(tol, dtype=b_norm2.dtype, device=b_norm2.device)
    return t ** 2 * torch.where(b_norm2 > 0, b_norm2, 1.0)


def _tol2(tol: float, b_norm2: torch.Tensor) -> float:
    t = _tol2_t(tol, b_norm2)
    with span("spmx.krylov.sync"):
        return float(t)


#: the slots of a solve's KrylovScratch: the recurrence's numerator (CG's
#: r.r, PCG's r.z) alternates between slots 0 and 1, PCG's r.r between 2
#: and 3, each step writing the slot its input does not hold; p.Ap is slot 4
_NUM, _RR, _PAP = 0, 2, 4


def _scratch_of(s: torch.Tensor, like: torch.Tensor):
    """The KrylovScratch that wrote the 0-d scalar ``s``, or a new one when
    another op made it or it does not fit ``like``."""
    ks = getattr(s, "krylov_scratch", None)
    return ks if ks is not None and ks.fits(like) else KrylovScratch(like)


def _next(ks, s: torch.Tensor, first: int) -> int:
    """The slot of the pair ``first``, ``first + 1`` that ``s`` is not."""
    return first + 1 if s is ks.slots[first] else first


def _matvec(matvec, v):
    """``matvec(v)``, the Krylov loop's outer matvec, in its span."""
    with span("spmx.krylov.matvec"):
        return matvec(v)


def _precond(precond, v):
    """``precond(v)``, the loop's ``M^-1``, in its span; ``precond`` None
    is the identity."""
    if precond is None:
        return v
    with span("spmx.krylov.precond"):
        return precond(v)


def _above(v: torch.Tensor, bound: float) -> bool:
    """The stopping test ``v > bound``: one host read of ``v``, which
    waits for the device."""
    with span("spmx.krylov.sync"):
        return float(v) > bound


def _flag(flag: torch.Tensor) -> bool:
    """A stopping test's host read of a 0-d flag."""
    with span("spmx.krylov.sync"):
        return bool(flag)


def cg_solve(
    matvec: Callable,
    b: torch.Tensor,
    x0=None,
    *,
    tol: float = 1e-6,
    maxiter: int = 1000,
) -> CgResult:
    """Solve ``A x = b`` for symmetric positive-definite ``A``.

    Convergence: ||r||_2 <= tol * ||b||_2.
    """
    with span("spmx.solve"):
        x = torch.zeros_like(b) if x0 is None else x0.clone()
        r = b - _matvec(matvec, x)
        if r.is_cuda:
            # the fused step updates p in place, so p must not be r
            ks = KrylovScratch(r)
            p = r.clone()
            rs = ks.dot(r, r, _NUM)
        else:
            p = r
            rs = torch.dot(r, r)
        tol2 = _tol2(tol, torch.dot(b, b))
        k = 0
        while k < maxiter and _above(rs, tol2):
            x, r, p, rs = _cg_step(matvec, x, r, p, rs)
            k += 1
        return CgResult(x=x, iterations=k, residual_norm=torch.sqrt(rs))


def _cg_step(matvec, x, r, p, rs):
    """One iteration of :func:`cg_solve` (its device work; the stopping
    test's host read stays in the loop): the next ``(x, r, p, rs)``. On a
    CUDA vector four kernels (the matvec, ``p . Ap``, the x and r update
    with ``r . r``, the p update) update x, r and p in place and return
    them with the new ``rs``, a slot of the solve's KrylovScratch."""
    ap = _matvec(matvec, p)
    if ap.is_cuda:
        ks = _scratch_of(rs, x)
        pap = ks.dot(p, ap, _PAP)
        rs_new = ks.cg_update(x, r, p, ap, rs, pap, _next(ks, rs, _NUM))
        ks.p_update(p, r, rs_new, rs)
        return x, r, p, rs_new
    alpha = rs / torch.dot(p, ap)
    x = x + alpha * p
    r = r - alpha * ap
    rs_new = torch.dot(r, r)
    p = r + (rs_new / rs) * p
    return x, r, p, rs_new


def _ir_inner_step(matvec_lo, d, q, p, rs):
    """One inner iteration of :func:`cg_solve_ir` (CG on ``A_lo d = r``
    with guarded divisions): the next ``(d, q, p, rs)``."""
    ap = _matvec(matvec_lo, p)
    pap = torch.dot(p, ap)
    alpha = rs / torch.where(pap == 0, 1.0, pap)
    d = d + alpha * p
    q = q - alpha * ap
    rs_new = torch.dot(q, q)
    p = q + (rs_new / torch.where(rs == 0, 1.0, rs)) * p
    return d, q, p, rs_new


def cg_solve_ir(
    matvec_hi: Callable,
    matvec_lo: Callable,
    b: torch.Tensor,
    x0=None,
    *,
    tol: float = 1e-6,
    maxiter: int = 1000,
    inner_tol: float = 1e-2,
    inner_maxiter: int = 200,
) -> CgResult:
    """Mixed-precision CG by iterative refinement.

    Outer loop at working precision: true residual ``r = b - A_hi x``
    (``matvec_hi``, e.g. the f32 operator). Inner loop: CG on the
    low-precision operator (``matvec_lo``, e.g. the same operator with bf16
    value planes, ``SpmvOperator(a, device=..., values_dtype=torch.bfloat16)``)
    solving ``A_lo d = r`` to ``inner_tol`` relative; then ``x += d``.
    ``iterations`` counts inner matvecs and ``maxiter`` bounds that count.
    """
    def inner(r, budget):
        d = torch.zeros_like(r)
        q = r
        p = r
        rs = torch.dot(r, r)
        itol2 = _tol2(inner_tol, rs)
        k = 0
        while k < inner_maxiter and k < budget and _above(rs, itol2):
            d, q, p, rs = _ir_inner_step(matvec_lo, d, q, p, rs)
            k += 1
        return d, k

    with span("spmx.solve"):
        x = torch.zeros_like(b) if x0 is None else x0.clone()
        tol2 = _tol2(tol, torch.dot(b, b))
        r0 = b - _matvec(matvec_hi, x)
        rr = torch.dot(r0, r0)
        k = 0
        while k < maxiter and _above(rr, tol2):
            r = b - _matvec(matvec_hi, x)
            d, ki = inner(r, maxiter - k)
            x = x + d
            r2 = b - _matvec(matvec_hi, x)
            rr = torch.dot(r2, r2)
            k += ki
        return CgResult(x=x, iterations=k, residual_norm=torch.sqrt(rr))


def jacobi_preconditioner(m, device, dtype=torch.float32) -> Callable:
    """M^-1 = diag(A)^-1 as a vector multiply (host ``CsrMatrix`` input,
    zero diagonal entries replaced by 1). Broadcasts over a trailing
    right-hand-side axis."""
    rids = m.row_ids()
    on_diag = m.indices.astype(np.int64) == rids
    d = np.ones(m.rows, dtype=np.float64)
    d[rids[on_diag]] = m.vals[on_diag].astype(np.float64)
    d[d == 0.0] = 1.0
    inv = torch.from_numpy(1.0 / d).to(device=device, dtype=dtype)

    def apply(r):
        return inv.reshape((-1,) + (1,) * (r.dim() - 1)) * r

    return apply


def pcg_solve(
    matvec: Callable,
    b: torch.Tensor,
    precond: Callable,
    x0=None,
    *,
    tol: float = 1e-6,
    maxiter: int = 1000,
) -> CgResult:
    """Preconditioned CG: ``precond`` applies M^-1 (e.g.
    :func:`jacobi_preconditioner`); convergence on the true residual
    ||r||_2 <= tol * ||b||_2."""
    with span("spmx.solve"):
        x = torch.zeros_like(b) if x0 is None else x0.clone()
        r = b - _matvec(matvec, x)
        z = _precond(precond, r)
        if r.is_cuda:
            # the fused step updates p in place, so p must not be z
            ks = KrylovScratch(r)
            p = z.clone()
            rz = ks.dot(r, z, _NUM)
            rr = ks.dot(r, r, _RR)
        else:
            p = z
            rz = torch.dot(r, z)
            rr = torch.dot(r, r)
        tol2 = _tol2(tol, torch.dot(b, b))
        k = 0
        while k < maxiter and _above(rr, tol2):
            x, r, p, rz, rr = _pcg_step(matvec, precond, x, r, p, rz)
            k += 1
        return CgResult(x=x, iterations=k, residual_norm=torch.sqrt(rr))


def _pcg_step(matvec, precond, x, r, p, rz):
    """One iteration of :func:`pcg_solve` (its device work; the stopping
    test's host read stays in the loop): the next ``(x, r, p, rz, rr)``. On
    a CUDA vector: the matvec, ``p . Ap``, the x and r update with ``r .
    r``, ``M^-1``, ``r . z`` and the p update, x, r and p in place, ``rz``
    and ``rr`` slots of the solve's KrylovScratch."""
    ap = _matvec(matvec, p)
    if ap.is_cuda:
        ks = _scratch_of(rz, x)
        pap = ks.dot(p, ap, _PAP)
        j = _next(ks, rz, _NUM)
        rr = ks.cg_update(x, r, p, ap, rz, pap, _RR + j - _NUM)
        z = _precond(precond, r)
        rz_new = ks.dot(r, z, j)
        ks.p_update(p, z, rz_new, rz)
        return x, r, p, rz_new, rr
    alpha = rz / torch.dot(p, ap)
    x = x + alpha * p
    r = r - alpha * ap
    z = _precond(precond, r)
    rz_new = torch.dot(r, z)
    p = z + (rz_new / rz) * p
    return x, r, p, rz_new, torch.dot(r, r)


def _rhs_layout(b: torch.Tensor, rhs_axis: int):
    """(colsum, bc) for K systems on ``rhs_axis``: per-column inner
    products (K,) and the broadcast of a (K,) row over the layout."""
    ax = rhs_axis % b.dim()
    red = tuple(i for i in range(b.dim()) if i != ax)
    bshape = [1] * b.dim()
    bshape[ax] = b.shape[ax]

    def colsum(u, v):
        return torch.sum(u * v, dim=red)

    def bc(s):
        return s.reshape(bshape)

    return colsum, bc


def cg_solve_multi(
    matvec_multi: Callable,
    b: torch.Tensor,
    *,
    tol: float = 1e-6,
    maxiter: int = 1000,
    rhs_axis: int = -1,
) -> CgResult:
    """CG over K right-hand sides at once: ``b`` carries K systems on
    ``rhs_axis`` and ``matvec_multi`` maps that layout to itself — the
    (n, K) column layout by default (e.g. ``SpmvOperator.matmat``), or a
    packed layout with ``rhs_axis=1`` (``dia_matvec_multi``,
    ``aligned_matvec_multi``, ``lanepack_matvec_multi``; a BELL operator's
    ``matmat`` serves the column layout). Each column runs its own recurrence
    (per-column alpha and beta); columns iterate in lockstep and a
    converged column freezes until all have converged or ``maxiter`` is
    reached. One host read per iteration tests the stopping rule.
    ``residual_norm`` is the (K,) recursive residual norms."""
    with span("spmx.solve"):
        colsum, bc = _rhs_layout(b, rhs_axis)
        x = torch.zeros_like(b)
        r = b - _matvec(matvec_multi, x)
        p = r
        rs = colsum(r, r)
        tol2 = _tol2_t(tol, colsum(b, b))
        live = rs > tol2
        k = 0
        while k < maxiter and _flag(live.any()):
            x, r, p, rs, live = _cg_multi_step(matvec_multi, colsum, bc, tol2, live,
                                               x, r, p, rs)
            k += 1
        return CgResult(x=x, iterations=k, residual_norm=torch.sqrt(rs))


def _cg_multi_step(matvec_multi, colsum, bc, tol2, live, x, r, p, rs):
    """One iteration of :func:`cg_solve_multi` (its device work; the host
    read of ``live.any()`` stays in the loop): the columns in ``live``
    advance, the others keep their state. Returns the next
    ``(x, r, p, rs, live)``."""
    ap = _matvec(matvec_multi, p)
    pap = colsum(p, ap)
    alpha = torch.where(live, rs / torch.where(pap == 0, 1.0, pap), 0.0)
    x = x + bc(alpha) * p
    r = r - bc(alpha) * ap
    rs_new = colsum(r, r)
    beta = torch.where(live, rs_new / torch.where(rs == 0, 1.0, rs), 0.0)
    p = torch.where(bc(live), r + bc(beta) * p, p)
    rs = torch.where(live, rs_new, rs)
    return x, r, p, rs, rs > tol2


def pcg_solve_multi(
    matvec_multi: Callable,
    b: torch.Tensor,
    precond: Callable,
    *,
    tol: float = 1e-6,
    maxiter: int = 1000,
    rhs_axis: int = -1,
) -> CgResult:
    """Preconditioned CG over K right-hand sides in lockstep, layout-generic
    like :func:`cg_solve_multi` (``precond`` maps the layout to itself; with
    the (n, K) layout :func:`jacobi_preconditioner` broadcasts). Each column
    runs its own PCG recurrence on the M-inner product r.z and converges
    on its true residual; converged columns freeze."""
    with span("spmx.solve"):
        colsum, bc = _rhs_layout(b, rhs_axis)
        x = torch.zeros_like(b)
        r = b - _matvec(matvec_multi, x)
        z = _precond(precond, r)
        p = z
        rz = colsum(r, z)
        rr = colsum(r, r)
        tol2 = _tol2_t(tol, colsum(b, b))
        k = 0
        while k < maxiter:
            live = rr > tol2
            if not _flag(live.any()):
                break
            x, r, p, rz, rr = _pcg_multi_step(matvec_multi, precond, colsum, bc, live,
                                              x, r, p, rz, rr)
            k += 1
        return CgResult(x=x, iterations=k, residual_norm=torch.sqrt(rr))


def _pcg_multi_step(matvec_multi, precond, colsum, bc, live, x, r, p, rz, rr):
    """One iteration of :func:`pcg_solve_multi` (its device work; the host
    read of ``live.any()`` stays in the loop): the columns in ``live``
    advance, the others keep their state. Returns the next
    ``(x, r, p, rz, rr)``."""
    ap = _matvec(matvec_multi, p)
    pap = colsum(p, ap)
    alpha = torch.where(live, rz / torch.where(pap == 0, 1.0, pap), 0.0)
    x = x + bc(alpha) * p
    r = r - bc(alpha) * ap
    z = _precond(precond, r)
    rz_new = colsum(r, z)
    beta = torch.where(live, rz_new / torch.where(rz == 0, 1.0, rz), 0.0)
    p = torch.where(bc(live), z + bc(beta) * p, p)
    rz = torch.where(live, rz_new, rz)
    rr = torch.where(live, colsum(r, r), rr)
    return x, r, p, rz, rr
