"""Plain PyTorch references of the benchmark, and the lower-precision
controls built from them.

Nothing here imports the port or takes anything it made: the matrices
come from the benchmark's own generators (``generators/``), the
right-hand sides and value vectors from the benchmark's seeded pools.
Every function takes a ``dtype``: the references run in float64; the same
code in bfloat16, put in the program's place, is the control that the
comparisons must fail.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

#: unit roundoff of float32, the precision the configurations state
U_F32 = 2.0 ** -24


class DeviceCsr(NamedTuple):
    """A CSR on the device as plain tensors: each entry's row and column
    (int64) and value (``dtype``)."""

    rows: int
    cols: int
    row: torch.Tensor
    col: torch.Tensor
    val: torch.Tensor
    offsets: torch.Tensor


def upload(csr, device, dtype) -> DeviceCsr:
    """A generator's ``Csr`` on ``device`` with values in ``dtype``: give it
    the values the program is given (``csr.astype`` the configuration's
    dtype), to be widened or narrowed from there."""
    vals = torch.from_numpy(np.ascontiguousarray(csr.vals))
    return DeviceCsr(csr.rows, csr.cols,
                     torch.from_numpy(csr.row_ids()).to(device),
                     torch.from_numpy(csr.indices.astype(np.int64)).to(device),
                     vals.to(device=device, dtype=dtype),
                     torch.from_numpy(csr.offsets).to(device))


def matvec(a: DeviceCsr, x: torch.Tensor) -> torch.Tensor:
    """``A x`` in the dtype of A's values: each product gathered, then
    added into its row."""
    prod = a.val * x[a.col]
    y = torch.zeros(a.rows, dtype=prod.dtype, device=x.device)
    return y.index_add_(0, a.row, prod)


def residual_ratio(a: DeviceCsr, x: torch.Tensor, b: torch.Tensor) -> float:
    """``||b - A x||_2 / ||b||_2`` with A, x and b in A's dtype (float64
    for the reference)."""
    dt = a.val.dtype
    r = b.to(dt) - matvec(a, x.to(dt))
    den = float(torch.linalg.vector_norm(b.to(dt)))
    return float(torch.linalg.vector_norm(r)) / (den if den > 0 else 1.0)


def _dot(u, v):
    return (u * v).sum()


def cg(a: DeviceCsr, b: torch.Tensor, *, tol: float, maxiter: int, check_every: int = 50):
    """Plain conjugate gradients on A's dtype, from x = 0, stopping once
    ``||r|| <= tol ||b||`` (tested every ``check_every`` iterations) or at
    ``maxiter``. Returns ``(x, iterations)``."""
    b = b.to(a.val.dtype)
    x = torch.zeros_like(b)
    r = b.clone()
    p = r.clone()
    rs = _dot(r, r)
    tol2 = tol * tol * float(_dot(b, b))
    k = 0
    while k < maxiter:
        if k % check_every == 0 and float(rs) <= tol2:
            break
        ap = matvec(a, p)
        alpha = rs / _dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = _dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new
        k += 1
    return x, k


def bicgstab(a: DeviceCsr, b: torch.Tensor, *, tol: float, maxiter: int,
             check_every: int = 10):
    """Plain unpreconditioned BiCGSTAB on A's dtype, from x = 0, stopping
    once ``||r|| <= tol ||b||`` (tested every ``check_every`` iterations),
    at ``maxiter``, or on a breakdown. Returns ``(x, iterations)``."""
    b = b.to(a.val.dtype)
    x = torch.zeros_like(b)
    r = b.clone()
    r_hat = r.clone()
    p = r.clone()
    rho = _dot(r_hat, r)
    tol2 = tol * tol * float(_dot(b, b))
    k = 0
    while k < maxiter:
        if k % check_every == 0:
            rr, rh = float(_dot(r, r)), float(rho)
            if rr <= tol2 or rh == 0.0 or not np.isfinite(rr):
                break
        v = matvec(a, p)
        alpha = rho / _dot(r_hat, v)
        s = r - alpha * v
        t = matvec(a, s)
        omega = _dot(t, s) / _dot(t, t)
        x = x + alpha * p + omega * s
        r = s - omega * t
        rho_new = _dot(r_hat, r)
        p = r + (rho_new / rho) * (alpha / omega) * (p - omega * v)
        rho = rho_new
        k += 1
    return x, k


class ProductPattern(NamedTuple):
    """The structure of ``C = A B`` for plain refreshed products: each
    scalar product's A entry ``ea`` and B entry ``eb``, its entry ``inv``
    of C, C's sorted packed keys ``row * cols + col`` and the number of
    products an entry of C sums."""

    ea: torch.Tensor
    eb: torch.Tensor
    inv: torch.Tensor
    keys: torch.Tensor
    count: torch.Tensor
    cols: int


def product_pattern(a: DeviceCsr, b: DeviceCsr) -> ProductPattern:
    """Every scalar product ``A[i, k] B[k, j]``, listed by A's entries."""
    dev = a.row.device
    blen = (b.offsets[1:] - b.offsets[:-1])[a.col]
    total = int(blen.sum())
    ea = torch.repeat_interleave(torch.arange(a.col.numel(), device=dev), blen,
                                 output_size=total)
    first = torch.cumsum(blen, 0) - blen
    eb = b.offsets[a.col[ea]] + (torch.arange(total, device=dev) - first[ea])
    keys, inv, count = torch.unique(a.row[ea] * b.cols + b.col[eb], sorted=True,
                                    return_inverse=True, return_counts=True)
    return ProductPattern(ea, eb, inv, keys, count, b.cols)


def product_values(pat: ProductPattern, a_vals: torch.Tensor, b_vals: torch.Tensor,
                   dtype) -> tuple:
    """``(C's values, (|A||B|) of each entry)`` in ``dtype``: the products
    added into their entries."""
    prod = a_vals.to(dtype)[pat.ea] * b_vals.to(dtype)[pat.eb]
    n = pat.keys.numel()
    c = torch.zeros(n, dtype=dtype, device=prod.device).index_add_(0, pat.inv, prod)
    mag = torch.zeros(n, dtype=dtype, device=prod.device).index_add_(0, pat.inv, prod.abs())
    return c, mag


def product_error(pat: ProductPattern, row, col, val, nnz: int, ref, mag):
    """Compare a product ``(row, col, val)`` with ``nnz`` live entries
    against the float64 reference on ``pat``: ``(entries off the
    reference's pattern, worst error over the float32 bound)``. The bound
    of an entry is ``(n_ij + 2) u (|A||B|)_ij`` with u the float32 unit
    roundoff and n_ij its number of products; inf where the patterns
    differ."""
    n_ref = pat.keys.numel()
    if nnz != n_ref:
        return abs(nnz - n_ref) + n_ref, float("inf")
    keys = row[:nnz].long() * pat.cols + col[:nnz].long()
    off = int((keys != pat.keys).sum())
    if off:
        return off, float("inf")
    err = (val[:nnz].double() - ref).abs()
    bound = (pat.count.double() + 2.0) * U_F32 * mag
    bad = ~torch.isfinite(err)
    if bool(bad.any()):
        return 0, float("inf")
    return 0, float((err / torch.clamp(bound, min=1e-300)).max())
