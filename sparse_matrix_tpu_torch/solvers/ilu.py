"""Incomplete factorizations (ILU(0), IC(0), ILUT) and triangular solves.

Counterpart of ``sparse_matrix_tpu/solvers/ilu.py``:

* **Factorization on the host**, in the port's own C++ runtime
  (``native/src/spmx_host.cpp`` through ``native/host.py``, copied from the
  reference's native runtime): the IKJ row variant on the fixed CSR
  pattern for ILU(0), Saad's dual-dropping ILUT. The Python loops
  (:func:`_ilu0_python`, :func:`_ilut_python`, :func:`_trisolve_python`)
  are the plain versions the tests hold the library to; nothing falls back
  to them.
* **Triangular solves on the device by Jacobi sweeps**
  (:class:`TriangularJacobi`): for ``T = D + N`` the iteration
  ``x <- D^-1 (b - N x)`` has a nilpotent iteration matrix, so it is exact
  after ``depth(T) - 1`` sweeps, and a small fixed count is the Chow-Patel
  approximate solve. N is applied through the port's
  :class:`~sparse_matrix_tpu_torch.ops.operator.SpmvOperator`;
  ``fused=True`` on a DIA factor runs every sweep in one launch of the
  fused kernel (``ops/trisweep.py``). IC uses the same sweep count on L and
  L^T, so ``M^-1 = S^T S`` is symmetric for any count, as PCG needs.
* **Exact solves on the host** (:func:`trisolve_host`) for setup work and
  oracles.

Not ported: ``TriangularJacobi.as_pytree`` and ``apply`` (jit arguments;
the port runs eagerly).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..formats.csr import CsrMatrix
from ..native import host
from ..utils.profiling import span

__all__ = [
    "IluFactors",
    "ilu0",
    "ilut",
    "ilut_preconditioner",
    "ic0",
    "trisolve_host",
    "TriangularJacobi",
    "ilu_preconditioner",
    "ic_preconditioner",
    "ic_pcg_solve",
    "save_ilu_factors",
    "load_ilu_factors",
]


def _diag_positions(a) -> np.ndarray:
    """Per-row position of the diagonal entry in CSR storage (-1 if absent);
    needs sorted column indices."""
    diag_pos = np.full(a.rows, -1, dtype=np.int64)
    rid = a.row_ids()
    mask = a.indices.astype(np.int64) == rid
    diag_pos[rid[mask]] = np.flatnonzero(mask)
    return diag_pos


def _subset(t, keep, vals) -> CsrMatrix:
    """The entries of sorted, duplicate-free CSR ``t`` where ``keep``, with
    values ``vals``: what ``CsrMatrix.from_coo`` of those triplets returns
    (as the reference builds its factors), without its sort, since a masked
    subset of sorted rows stays sorted."""
    offsets = np.zeros(t.rows + 1, dtype=np.int64)
    np.cumsum(np.bincount(t.row_ids()[keep], minlength=t.rows), out=offsets[1:])
    return CsrMatrix(t.rows, t.cols, vals, t.indices[keep], offsets, is_sorted=True)


class IluFactors(NamedTuple):
    """ILU factors ``A ~= L @ U``: ``l`` unit lower triangular (explicit 1.0
    diagonal), ``u`` upper triangular with the pivots; both sorted CSR."""

    l: CsrMatrix
    u: CsrMatrix


def _factor_vals(a):
    """ILU(0) on a copy of A's values in the host runtime; returns (vals,
    diag_pos)."""
    if not a.is_sorted:
        raise ValueError("ilu0 requires sorted CSR (use from_coo / sort first)")
    if a.rows != a.cols:
        raise ValueError("ilu0 requires a square matrix")
    vals = np.ascontiguousarray(a.vals).copy()
    diag_pos = _diag_positions(a)
    rc = host.ilu0_native(a.rows, a.cols, a.offsets, a.indices, vals, diag_pos)
    if rc >= 0:
        raise ValueError(f"ilu0: zero pivot in row {rc}")
    return vals, diag_pos


def _ilu0_python(rows, offsets, indices, vals, diag_pos):
    """Plain IKJ loop of ``spmx_ilu0_*`` (in place on ``vals``); returns
    the first zero-pivot row or -1."""
    w = {}
    for i in range(rows):
        b, e = int(offsets[i]), int(offsets[i + 1])
        for t in range(b, e):
            w[int(indices[t])] = t
        for t in range(b, e):
            k = int(indices[t])
            if k >= i:
                break
            dk = int(diag_pos[k])
            if dk < 0 or vals[dk] == 0:
                return k
            f = vals[t] / vals[dk]
            vals[t] = f
            for s in range(dk + 1, int(offsets[k + 1])):
                p = w.get(int(indices[s]))
                if p is not None:
                    vals[p] -= f * vals[s]
        if diag_pos[i] < 0 or vals[int(diag_pos[i])] == 0:
            return i
        w.clear()
    return -1


def ilu0(a) -> IluFactors:
    """ILU(0): incomplete LU on A's own sparsity pattern (no fill)."""
    vals, _ = _factor_vals(a)  # every row has its diagonal once this succeeds
    rid = a.row_ids()
    cid = a.indices.astype(np.int64)
    on_l = cid <= rid
    upper = cid >= rid
    # L: strict lower + explicit unit diagonal
    l = _subset(a, on_l, np.where((cid == rid)[on_l], vals.dtype.type(1), vals[on_l]))
    return IluFactors(l, _subset(a, upper, vals[upper]))


def ic0(a) -> CsrMatrix:
    """IC(0): incomplete Cholesky ``A ~= L @ L^T`` for symmetric positive
    definite ``A`` (the pattern of A's lower triangle), from the ILU(0)
    identity for symmetric input, ``U = D L^T``: ``L_c = L_unit @
    sqrt(D)``. Raises if a pivot is not positive."""
    vals, diag_pos = _factor_vals(a)
    d = vals[diag_pos]
    if (d <= 0).any():
        bad = int(np.flatnonzero(d <= 0)[0])
        raise ValueError(f"ic0: non-positive pivot in row {bad} (input not SPD?)")
    sq = np.sqrt(d.astype(np.float64)).astype(vals.dtype)
    rid = a.row_ids()
    cid = a.indices.astype(np.int64)
    on_l = cid <= rid
    r, c = rid[on_l], cid[on_l]
    # column-scale the unit-lower factor by sqrt(d); the diagonal becomes sqrt(d)
    return _subset(a, on_l, np.where(c == r, sq[r], vals[on_l] * sq[c]))


def _trisolve_python(t, b, *, lower: bool, unit: bool = False) -> np.ndarray:
    """Plain row loop of ``spmx_trisolve_*``: ``T x = b`` in the dtype of
    ``t.vals``."""
    x = np.ascontiguousarray(b, dtype=t.vals.dtype).copy()
    diag_pos = _diag_positions(t)
    vals = t.vals
    idx = t.indices.astype(np.int64)
    order = range(t.rows) if lower else range(t.rows - 1, -1, -1)
    for i in order:
        bb, e = int(t.offsets[i]), int(t.offsets[i + 1])
        acc = x[i]
        for s in range(bb, e):
            j = int(idx[s])
            if (lower and j < i) or (not lower and j > i):
                acc -= vals[s] * x[j]
        if not unit:
            d = int(diag_pos[i])
            if d < 0 or vals[d] == 0:
                raise ValueError(f"trisolve: zero pivot in row {i}")
            acc /= vals[d]
        x[i] = acc
    return x


def trisolve_host(t, b, *, lower: bool, unit: bool = False) -> np.ndarray:
    """Exact host triangular solve ``T x = b`` (sorted CSR ``t``; the host
    runtime), in the dtype of ``t.vals``."""
    x = np.ascontiguousarray(np.asarray(b), dtype=t.vals.dtype).copy()
    rc = host.trisolve_native(t.rows, t.offsets, t.indices, t.vals, _diag_positions(t), x,
                              lower=lower, unit=unit)
    if rc >= 0:
        raise ValueError(f"trisolve: zero pivot in row {rc}")
    return x


class TriangularJacobi:
    """Device triangular solve by Jacobi sweeps on a triangular CSR ``T``.

    ``T = D + N`` with strictly triangular ``N``; ``x_{k+1} = D^-1 (b - N
    x_k)`` from ``x_0 = D^-1 b``. ``D^-1 N`` is nilpotent, so ``sweeps >=
    depth(T) - 1`` is exact; small fixed counts give the Chow-Patel
    approximate solve. ``N`` is applied through a planned
    :class:`~sparse_matrix_tpu_torch.ops.operator.SpmvOperator` on
    ``device`` (vectors through ``__call__``, (n, K) blocks through
    ``matmat``). ``values_dtype=torch.bfloat16`` stores N's planes
    half-width where its format allows it (elsewhere it is dropped, as in
    the reference).

    ``fused=True`` on a factor whose N takes the DIA format runs vector
    solves through the fused kernel (``ops/trisweep.py``: one launch per
    solve, float32 planes from the host DIA data whatever
    ``values_dtype``); it raises for a DIA factor under 128 rows. The
    default (None) is the loop form, as in the reference, whose v5e
    measurement found the fused kernel slower; PERF.md has the H100's.
    """

    def __init__(self, t, *, device, sweeps: int = 4, dtype=torch.float32, force=None,
                 fused=None, values_dtype=None):
        from ..ops.operator import _NP_DTYPES, SpmvOperator

        if t.rows != t.cols:
            raise ValueError("triangular solve needs a square operator")
        np_dtype = _NP_DTYPES[dtype]
        self.sweeps = int(sweeps)
        rid = t.row_ids()
        cid = t.indices.astype(np.int64)
        diag_pos = _diag_positions(t)
        if (diag_pos < 0).any():
            raise ValueError("triangular factor is missing a diagonal entry")
        d = t.vals[diag_pos].astype(np.float64)
        if (d == 0).any():
            raise ValueError("triangular factor has a zero diagonal")
        self.n_op = None
        strict = cid != rid
        n_vals = t.vals[strict].astype(np_dtype)
        n_mat = (_subset(t, strict, n_vals) if t.is_sorted
                 else CsrMatrix.from_coo(t.rows, t.cols, rid[strict], cid[strict], n_vals))
        if values_dtype is not None:
            try:
                self.n_op = SpmvOperator(n_mat, device=device, dtype=dtype, force=force,
                                         values_dtype=values_dtype)
            except ValueError:
                pass
        if self.n_op is None:
            self.n_op = SpmvOperator(n_mat, device=device, dtype=dtype, force=force)
        self.device = self.n_op.device
        self.dinv = torch.from_numpy((1.0 / d).astype(np_dtype)).to(self.device)
        self._fused = None
        if fused is True and self.n_op.format == "dia":
            from ..ops.trisweep import plan_trisweep

            self._fused = plan_trisweep(self.n_op.part("dia").plan, t.rows, device=self.device)
            if self._fused is None:
                raise ValueError("factor is not fusable (not banded or too small)")

    def __call__(self, b: torch.Tensor) -> torch.Tensor:
        """The approximate solve ``T x = b``, in the span
        ``spmx.ilu.sweep``."""
        with span("spmx.ilu.sweep"):
            if b.dim() == 1 and self._fused is not None:
                from ..ops.trisweep import trisweep

                return trisweep(self._fused, b, self.dinv, sweeps=self.sweeps)
            dinv = self.dinv if b.dim() == 1 else self.dinv[:, None]
            apply_n = self.n_op if b.dim() == 1 else self.n_op.matmat
            x = dinv * b
            for _ in range(self.sweeps):
                x = dinv * (b - apply_n(x))
            return x


def ilu_preconditioner(a, *, device, sweeps: int = 4, dtype=torch.float32, force=None,
                       fused=None, values_dtype=None) -> Callable:
    """``M^-1 r ~= U^-1 L^-1 r`` from ILU(0), both solves by Jacobi sweeps
    on ``device``. For unsymmetric systems (BiCGStab, GMRES). The
    factorization and both sweep plans are the span ``spmx.plan.ilu``."""
    with span("spmx.plan.ilu"):
        f = ilu0(a)
        kw = dict(device=device, sweeps=sweeps, dtype=dtype, force=force, fused=fused,
                  values_dtype=values_dtype)
        sl = TriangularJacobi(f.l, **kw)
        su = TriangularJacobi(f.u, **kw)
    return lambda r: su(sl(r))


def ic_preconditioner(a, *, device, sweeps: int = 4, dtype=torch.float32, force=None,
                      fused=None, values_dtype=None) -> Callable:
    """Symmetric PSD ``M^-1 ~= L^-T L^-1`` from IC(0). Both solves use the
    same sweep count, so the lower-solve polynomial ``S`` and the
    upper-solve polynomial are exact transposes and ``M^-1 = S^T S`` for
    any sweep count, as PCG requires. The factorization and both sweep
    plans are the span ``spmx.plan.ilu``."""
    with span("spmx.plan.ilu"):
        lc = ic0(a)
        kw = dict(device=device, sweeps=sweeps, dtype=dtype, force=force, fused=fused,
                  values_dtype=values_dtype)
        sl = TriangularJacobi(lc, **kw)
        su = TriangularJacobi(lc.transpose(), **kw)
    return lambda r: su(sl(r))


def ic_pcg_solve(a, b: torch.Tensor, *, device, sweeps: int = 4, tol: float = 1e-6,
                 maxiter: int = 1000, dtype=torch.float32, force=None, values_dtype=None):
    """IC(0)-preconditioned CG on a host CSR operator, on ``device`` (``b``
    must be there)."""
    from ..ops.operator import SpmvOperator
    from .cg import pcg_solve

    op = SpmvOperator(a, device=device, dtype=dtype, force=force)
    m_inv = ic_preconditioner(a, device=device, sweeps=sweeps, dtype=dtype, force=force,
                              values_dtype=values_dtype)
    return pcg_solve(op, b, m_inv, tol=tol, maxiter=maxiter)


def _ilut_rows(a, tau, p):
    """Plain row loop of ``spmx_ilut_*``: per row, the kept L entries
    ``[(col, val)]`` and the U entries with the diagonal first."""
    import heapq

    rows, offsets, indices, vals = a.rows, a.offsets, a.indices.astype(np.int64), a.vals
    l_rows, u_store = [], []
    for i in range(rows):
        w = {}
        norm2 = 0.0
        heap = []
        for t in range(int(offsets[i]), int(offsets[i + 1])):
            j = int(indices[t])
            v = float(vals[t])
            w[j] = w.get(j, 0.0) + v
            norm2 += v * v
            if j < i:
                heapq.heappush(heap, j)
        taui = tau * np.sqrt(norm2)
        last = -1
        while heap:
            k = heapq.heappop(heap)
            if k == last or k not in w:
                continue
            last = k
            wk = w[k]
            if abs(wk) < taui:
                w[k] = 0.0
                continue
            urow = u_store[k]
            wk /= urow[0][1]
            w[k] = wk
            for j, uv in urow[1:]:
                upd = wk * uv
                if j not in w:
                    if abs(upd) < taui:
                        continue
                    w[j] = -upd
                    if j < i:
                        heapq.heappush(heap, j)
                else:
                    w[j] -= upd
        # commit the diagonal at storage precision (the library stores the
        # factors in vals.dtype): a pivot that underflows to 0 there reports
        # a zero pivot here rather than inf/NaN factors later
        diag = float(np.asarray(w.get(i, 0.0), dtype=vals.dtype))
        if diag == 0.0:
            raise ValueError(f"ilut: zero pivot in row {i}")
        lpart = sorted(
            ((abs(v), j, v) for j, v in w.items() if j < i and v != 0.0 and abs(v) >= taui),
            reverse=True,
        )[:p]
        upart = sorted(
            ((abs(v), j, v) for j, v in w.items() if j > i and v != 0.0 and abs(v) >= taui),
            reverse=True,
        )[:p]
        l_rows.append([(j, v) for _a, j, v in lpart])
        u_store.append([(i, diag)] + [(j, v) for _a, j, v in upart])
    return l_rows, u_store


def _ilut_python(a, *, tau: float = 1e-3, p: int = 10) -> IluFactors:
    """Plain version of :func:`ilut` (the reference's Python branch)."""
    dtype = np.asarray(a.vals).dtype
    n = a.rows
    l_rows, u_rows = _ilut_rows(a, tau, p)
    ar = np.arange(n, dtype=np.int64)

    def coo(rows_):
        r = np.concatenate([np.full(len(rw), i, np.int64) for i, rw in enumerate(rows_)])
        c = np.concatenate([np.array([j for j, _ in rw], np.int64) for rw in rows_])
        v = np.concatenate([np.array([v for _, v in rw], dtype) for rw in rows_])
        return r, c, v

    lr, lc, lv = coo(l_rows)
    ur, uc, uv = coo(u_rows)
    l = CsrMatrix.from_coo(n, n, np.concatenate([lr, ar]), np.concatenate([lc, ar]),
                           np.concatenate([lv, np.ones(n, dtype=dtype)]))
    return IluFactors(l, CsrMatrix.from_coo(n, n, ur, uc, uv))


def ilut(a, *, tau: float = 1e-3, p: int = 10) -> IluFactors:
    """ILUT(p, tau): threshold incomplete LU with a per-row fill cap
    (Saad's dual-dropping rule: entries under ``tau * ||row||_2`` vanish,
    then only the ``p`` largest survive per L/U part; the diagonal always
    stays). ``tau=0, p>=n`` is exact LU. Runs in the host runtime."""
    if not a.is_sorted:
        raise ValueError("ilut requires sorted CSR")
    if a.rows != a.cols:
        raise ValueError("ilut requires a square matrix")
    if p < 1:
        raise ValueError("ilut needs p >= 1")
    vals = np.ascontiguousarray(a.vals)
    l_cnt, l_idx, l_val, u_cnt, u_idx, u_val = host.ilut_native(
        a.rows, a.cols, a.offsets, a.indices, vals, tau=tau, p=p)
    n = a.rows
    ar = np.arange(n, dtype=np.int64)
    keep_l = (np.arange(n * p) % p) < np.repeat(l_cnt, p)
    lr = np.concatenate([np.repeat(ar, l_cnt), ar])
    lc = np.concatenate([l_idx[keep_l].astype(np.int64), ar])
    lv = np.concatenate([l_val[keep_l], np.ones(n, dtype=vals.dtype)])
    keep_u = (np.arange(n * (p + 1)) % (p + 1)) < np.repeat(u_cnt, p + 1)
    l = CsrMatrix.from_coo(n, n, lr, lc, lv)
    u = CsrMatrix.from_coo(n, n, np.repeat(ar, u_cnt), u_idx[keep_u].astype(np.int64),
                           u_val[keep_u])
    return IluFactors(l, u)


def ilut_preconditioner(a, *, device, tau: float = 1e-3, p: int = 10, sweeps: int = 4,
                        dtype=torch.float32, force=None) -> Callable:
    """``M^-1 r ~= U^-1 L^-1 r`` from ILUT, the stronger (more fill) sibling
    of :func:`ilu_preconditioner`; its solves take the loop form. The
    factorization and both sweep plans are the span ``spmx.plan.ilu``."""
    with span("spmx.plan.ilu"):
        f = ilut(a, tau=tau, p=p)
        sl = TriangularJacobi(f.l, device=device, sweeps=sweeps, dtype=dtype, force=force)
        su = TriangularJacobi(f.u, device=device, sweeps=sweeps, dtype=dtype, force=force)
    return lambda r: su(sl(r))


def save_ilu_factors(path, f: IluFactors) -> None:
    """Persist ILU/ILUT factors in the reference's npz layout (either
    package loads the file)."""
    np.savez(
        path,
        l_vals=f.l.vals, l_indices=f.l.indices, l_offsets=f.l.offsets,
        u_vals=f.u.vals, u_indices=f.u.indices, u_offsets=f.u.offsets,
        shape=np.array([f.l.rows, f.l.cols], np.int64),
    )


def load_ilu_factors(path) -> IluFactors:
    """Inverse of :func:`save_ilu_factors` (files of either package)."""
    with np.load(path, allow_pickle=False) as z:
        rows, cols = (int(v) for v in z["shape"])
        return IluFactors(
            CsrMatrix(rows, cols, z["l_vals"], z["l_indices"], z["l_offsets"], is_sorted=True),
            CsrMatrix(rows, cols, z["u_vals"], z["u_indices"], z["u_offsets"], is_sorted=True),
        )
