"""Restarted GMRES(m) for general systems.

Counterpart of ``sparse_matrix_tpu/solvers/gmres.py``: the same Arnoldi
cycle, Givens rotations applied on the fly (so the residual norm is known
without solving the least-squares problem per step), right
preconditioning and iteration count, written as Python loops. The Krylov
basis, an (m + 1, n) buffer, and its products stay on the device; each
Arnoldi step reads its new Hessenberg column (m + 1 numbers) to the host,
where the rotations, the stopping test and the back substitution run in
the working dtype, so every step pays one host read.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..utils.profiling import span
from .cg import CgResult, _matvec, _precond

__all__ = ["gmres_solve"]

_EPS = 1e-30


def _arnoldi_cycle(matvec, m_inv, b, x, m: int, tol_abs: float):
    """One GMRES(m) cycle from ``x``: returns ``(x_new, |b - A x_new|)``."""
    np_dtype = torch.empty(0, dtype=b.dtype).numpy().dtype
    r = b - _matvec(matvec, x)
    beta = torch.sqrt(torch.dot(r, r))
    basis = torch.zeros((m + 1, b.shape[0]), dtype=b.dtype, device=b.device)
    basis[0] = r / torch.clamp(beta, min=_EPS)
    h = np.zeros((m + 1, m), np_dtype)  # Hessenberg, Givens-reduced
    cs = np.zeros(m, np_dtype)
    sn = np.zeros(m, np_dtype)
    g = np.zeros(m + 1, np_dtype)
    g[0] = _read(beta)
    eps = np_dtype.type(_EPS)
    for j in range(m):
        if abs(g[j]) <= tol_abs:
            break
        w = _matvec(matvec, _precond(m_inv, basis[j]))
        # Gram-Schmidt against the j + 1 basis vectors built so far
        hcol_t = basis[: j + 1] @ w
        w = w - hcol_t @ basis[: j + 1]
        hnext = torch.sqrt(torch.dot(w, w))
        basis[j + 1] = w / torch.clamp(hnext, min=_EPS)
        hcol = np.zeros(m + 1, np_dtype)
        hcol[: j + 2] = _read(torch.cat([hcol_t, hnext[None]]))
        for i in range(j):  # the earlier rotations, on the new column
            a = cs[i] * hcol[i] + sn[i] * hcol[i + 1]
            hcol[i + 1] = -sn[i] * hcol[i] + cs[i] * hcol[i + 1]
            hcol[i] = a
        denom = np.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
        c = hcol[j] / max(denom, eps)
        s = hcol[j + 1] / max(denom, eps)
        hcol[j], hcol[j + 1] = denom, 0
        cs[j], sn[j] = c, s
        g[j + 1] = -s * g[j]
        g[j] = c * g[j]
        h[:, j] = hcol
    # back-substitute the m x m triangular system (rows never reduced give
    # y = 0 through the EPS guard)
    y = np.zeros(m, np_dtype)
    for i in range(m - 1, -1, -1):
        si = g[i] - h[i] @ y
        y[i] = si / h[i, i] if abs(h[i, i]) > eps else 0
    y_t = torch.from_numpy(y).to(b.device)
    x_new = x + _precond(m_inv, y_t @ basis[:m])
    r_new = b - _matvec(matvec, x_new)
    return x_new, torch.sqrt(torch.dot(r_new, r_new))


def _read(t: torch.Tensor) -> np.ndarray:
    """A host read of ``t`` for the rotations and the stopping test."""
    with span("spmx.krylov.sync"):
        return t.cpu().numpy()


def gmres_solve(
    matvec: Callable,
    b: torch.Tensor,
    x0=None,
    *,
    restart: int = 30,
    tol: float = 1e-6,
    maxiter: int = 1000,
    m_inv: Callable = None,
) -> CgResult:
    """Solve ``A x = b`` for general square ``A``; ``||r|| <= tol * ||b||``.

    ``maxiter`` bounds the inner iterations, counted by whole cycles of
    ``restart`` as in the reference. ``m_inv`` right-preconditions (the
    Arnoldi basis spans the Krylov space of ``A M^-1``; the stopping test
    sees the true residual, and only the cycle's update pays one extra
    ``m_inv``); pair with :func:`~.ilu.ilu_preconditioner`.
    """
    with span("spmx.solve"):
        m = min(restart, b.shape[0])
        x = torch.zeros_like(b) if x0 is None else x0.clone()
        b_norm = float(_read(torch.sqrt(torch.dot(b, b))))
        tol_abs = tol * (b_norm if b_norm > 0 else 1.0)
        r0 = b - _matvec(matvec, x)
        res = torch.sqrt(torch.dot(r0, r0))
        k = 0
        while k < maxiter and float(_read(res)) > tol_abs:
            x, res = _arnoldi_cycle(matvec, m_inv, b, x, m, tol_abs)
            k += m
        return CgResult(x=x, iterations=k, residual_norm=res)
