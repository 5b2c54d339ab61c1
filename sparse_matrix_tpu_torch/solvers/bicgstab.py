"""BiCGSTAB for general (nonsymmetric) systems.

Counterpart of ``sparse_matrix_tpu/solvers/bicgstab.py``: the same
recurrences, breakdown guards and right preconditioning, written as a
Python loop over tensors. Each iteration reads one flag to the host for
the stopping test (residual above tolerance and no breakdown). Breakdown
(rho or omega collapsing to ~0) ends the loop with the current iterate.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..utils.profiling import span
from .cg import CgResult, _flag, _matvec, _precond, _tol2_t

__all__ = ["bicgstab_solve"]

_EPS = 1e-30


def _guard(v: torch.Tensor) -> torch.Tensor:
    """``v`` with magnitudes under ``_EPS`` replaced by ``_EPS``."""
    return torch.where(v.abs() < _EPS, _EPS, v)


def _bicgstab_step(matvec, m_inv, r_hat, x, p, r, rho):
    """One iteration: the next ``(x, p, r, rho, rr, ok)``; ``m_inv`` None
    is the identity."""
    p_hat = _precond(m_inv, p)
    v = _matvec(matvec, p_hat)
    alpha = rho / _guard(torch.dot(r_hat, v))
    s = r - alpha * v
    s_hat = _precond(m_inv, s)
    t = _matvec(matvec, s_hat)
    tt = torch.dot(t, t)
    omega = torch.dot(t, s) / torch.where(tt < _EPS, _EPS, tt)
    x = x + alpha * p_hat + omega * s_hat
    r = s - omega * t
    rho_new = torch.dot(r_hat, r)
    beta = (rho_new / _guard(rho)) * (alpha / _guard(omega))
    p = r + beta * (p - omega * v)
    ok = (rho_new.abs() > _EPS) & (omega.abs() > _EPS)
    return x, p, r, rho_new, torch.dot(r, r), ok


def bicgstab_solve(
    matvec: Callable,
    b: torch.Tensor,
    x0=None,
    *,
    tol: float = 1e-6,
    maxiter: int = 1000,
    m_inv: Callable = None,
) -> CgResult:
    """Solve ``A x = b`` for general square ``A``; ``||r|| <= tol * ||b||``.

    ``m_inv`` right-preconditions (van der Vorst's variant: the search
    directions are preconditioned and the recurrence tracks the true
    residual, so the stopping test needs no unpreconditioned re-check);
    pass e.g. :func:`~.ilu.ilu_preconditioner`.
    """
    with span("spmx.solve"):
        x = torch.zeros_like(b) if x0 is None else x0.clone()
        r = b - _matvec(matvec, x)
        r_hat = r
        rho = torch.dot(r_hat, r)
        p = r
        rr = torch.dot(r, r)
        tol2 = _tol2_t(tol, torch.dot(b, b))
        live = rr > tol2
        k = 0
        while k < maxiter and _flag(live):
            x, p, r, rho, rr, ok = _bicgstab_step(matvec, m_inv, r_hat, x, p, r, rho)
            live = (rr > tol2) & ok
            k += 1
        return CgResult(x=x, iterations=k, residual_norm=torch.sqrt(rr))
