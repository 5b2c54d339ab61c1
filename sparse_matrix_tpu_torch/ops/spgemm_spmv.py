"""Same-pattern SpGEMM as SpMV.

Counterpart of ``sparse_matrix_tpu/ops/spgemm_spmv.py``. With both
sparsity patterns fixed, which products land in which output entry is plan
data, so an amortised SpGEMM's reduction is one SpMV with a selection
matrix ``S`` (outputs x product slots) built once on the host and applied
through the port's ``SpmvOperator`` (its format dispatch, and with it the
SpMV kernels):

* :class:`ReduceSpmv` reduces the ESC expansion's product stream:
  ``C.vals = S @ p``; the output rows, columns and nnz are plan constants;
* :class:`FixedSideSpgemm` folds one side's frozen values into the
  selection matrix, ``W[(r, c), pos_B(k, c)] = A[r, k]``, so that
  ``C.vals = W @ rhs.vals``: one SpMV whose nnz is the product count.

**Finite-stream contract** (the reference's): with finite values the
results are the SpMV's: within the per-output bound of
:func:`reduce_f64_bound`, which for scan-mode formats (LanePack, stripe
scan) scales with the mass of the chunk an output's run sits in, not
with the output's own products (ROADMAP.md C8, C14). The windowed SpMV
formats read
zero-weight slots inside their gather windows, so a non-finite value can
turn other outputs of its window into NaN (``0 * inf``); the sort
reduction (``EscSpgemm(reduce="sort")``) confines non-finite values
exactly. The reference's native fused plan pass for
:func:`_fixedside_select` is not ported (ROADMAP.md queue A item 17): the
numpy branch runs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import require_device
from ..formats.csr import INDEX_DTYPE, OFFSET_DTYPE, CsrMatrix
from .device_sorted import PaddedCoo, expand_plan, padded_to_host
from .spmv import _TORCH_DTYPES, _t

__all__ = ["ReduceSpmv", "FixedSideSpgemm", "reduce_f64_bound"]

def _check_int32_cols(rows: int, cols: int) -> None:
    """The engines' output row and column arrays are int32, as every
    device array of the library."""
    if cols >= 2**31 or rows >= 2**31:
        raise ValueError(
            f"SpMV-reduce SpGEMM engines carry int32 output coordinates; "
            f"got rows={rows}, cols={cols} (>= 2^31). Use the sort-"
            f"reduction ESC engine or the host engine for wider outputs."
        )


def _fixedside_select(lhs: CsrMatrix, rhs: CsrMatrix, fixed: str):
    """FixedSideSpgemm's grouped selection matrix (the reference's numpy
    branch): ``(S, out_row, out_col, nnz_out, num_products)``."""
    src, q, out_r = expand_plan(lhs, rhs)
    out_c = rhs.indices.astype(np.int64)[q]
    key = out_r.astype(np.int64) * rhs.cols + out_c
    if fixed == "lhs":
        idx, w_vals, cols_x = q, lhs.vals[src], rhs.nnz()
    else:
        idx, w_vals, cols_x = src, rhs.vals[q], lhs.nnz()
    s, out_row, out_col, nnz_out = _group_by_key(
        key, rhs.cols, cols_x, sub_order=idx, indices=idx, vals=w_vals)
    return s, out_row, out_col, nnz_out, len(key)


def _group_by_key(key: np.ndarray, out_cols: int, cols_x: int,
                  sub_order: Optional[np.ndarray] = None,
                  indices: Optional[np.ndarray] = None,
                  vals: Optional[np.ndarray] = None):
    """Group positions by ``key`` into a CSR matrix whose row i selects
    (and sums) the positions of the i-th distinct key.

    ``indices`` maps grouped positions to matrix columns (default: the
    position itself); ``sub_order`` orders the columns within a row (it
    must make them strictly increasing); ``vals`` default to ones.
    Returns ``(S, out_row, out_col, nnz_out)``; ``S`` is None (no
    operator) for no keys.
    """
    n = len(key)
    if n == 0:
        return None, np.zeros(0, np.int32), np.zeros(0, np.int32), 0
    if sub_order is None:
        ord_ = np.argsort(key, kind="stable")
    else:
        ord_ = np.lexsort((sub_order, key))
    ks = key[ord_]
    head = np.empty(n, dtype=bool)
    head[0] = True
    np.not_equal(ks[1:], ks[:-1], out=head[1:])
    starts = np.flatnonzero(head)
    nnz_out = len(starts)
    offsets = np.empty(nnz_out + 1, dtype=OFFSET_DTYPE)
    offsets[:-1] = starts
    offsets[-1] = n
    uk = ks[starts]
    out_row = (uk // out_cols).astype(np.int32)
    out_col = (uk % out_cols).astype(np.int32)
    col_idx = ord_ if indices is None else np.asarray(indices)[ord_]
    v = (np.ones(n, np.float32) if vals is None
         else np.asarray(vals, np.float32)[ord_])
    s = CsrMatrix(nnz_out, cols_x, v, col_idx.astype(INDEX_DTYPE), offsets,
                  is_sorted=True)
    return s, out_row, out_col, nnz_out


class _ZeroOperator:
    """The operator of a plan with no products: applies to an empty
    result, so degenerate plans compose."""

    format = "zero"

    def __init__(self, dtype, device):
        self._dtype = dtype
        self._device = device

    def __call__(self, x):
        return torch.zeros(0, dtype=self._dtype, device=self._device)


def _operator(s, force, dtype, device):
    tdt = _TORCH_DTYPES[np.dtype(dtype)]
    if s is None:
        return _ZeroOperator(tdt, device)
    from .operator import SpmvOperator

    return SpmvOperator(s, device=device, dtype=tdt, force=force)


class ReduceSpmv:
    """Fixed-pattern reduction of an ESC product stream: ``S @ p``.

    Built from an :class:`~.esc_expand.ExpandPlan`'s padded ``out_key``;
    ``S`` never references the sentinel-keyed padding slots, so they drop
    out structurally. ``force`` pins the SpMV format of ``S`` (default:
    the operator's dispatch)."""

    def __init__(self, out_key_padded: np.ndarray, num_products: int, rows: int, cols: int,
                 *, device, force: Optional[str] = None, dtype=np.float32):
        _check_int32_cols(rows, cols)
        key = np.asarray(out_key_padded[:num_products], np.int64)
        s, out_row, out_col, nnz_out = _group_by_key(key, cols, len(out_key_padded))
        self.device = require_device(device)
        self.rows, self.cols = rows, cols
        self._num_products = num_products
        self.nnz_out = nnz_out
        self.out_row_host = np.asarray(out_row)
        self.out_col_host = np.asarray(out_col)
        self.out_row = _t(out_row, self.device)
        self.out_col = _t(out_col, self.device)
        self.selection = s
        self.op = _operator(s, force, dtype, self.device)

    def reduce(self, p) -> PaddedCoo:
        """Products (padded plan order) -> exact row-sorted PaddedCoo."""
        # the windowed SpMV formats read the pad slots with weight zero,
        # and 0 * inf = NaN: zero them first
        live = torch.arange(p.shape[0], device=p.device) < self._num_products
        p = torch.where(live, p, torch.zeros((), dtype=p.dtype, device=p.device))
        val = self.op(p)
        return PaddedCoo(self.out_row, self.out_col, val,
                         torch.tensor(self.nnz_out, dtype=torch.int32, device=self.device),
                         self.rows, self.cols)


class FixedSideSpgemm:
    """``C = A @ B`` with one side's values frozen: SpGEMM as one SpMV.

    ``fixed="lhs"``: ``C.vals = W @ rhs_vals`` with one entry of ``W`` per
    intermediate product, ``W[(r, c), pos_B(k, c)] = A[r, k]``; the
    varying side's values are taken in CSR order. ``fixed="rhs"`` mirrors
    it (``x`` = the lhs values). The output pattern is a plan constant;
    results are exact row-sorted :class:`~.device_sorted.PaddedCoo`. The
    engine of Galerkin triple products ``R @ A @ P`` with R and P frozen.
    """

    def __init__(self, lhs: CsrMatrix, rhs: CsrMatrix, *, device, fixed: str = "lhs",
                 dtype=np.float32, force: Optional[str] = None):
        if lhs.cols != rhs.rows:
            raise ValueError("LHS cols != RHS rows")
        if fixed not in ("lhs", "rhs"):
            raise ValueError("fixed must be 'lhs' or 'rhs'")
        _check_int32_cols(lhs.rows, rhs.cols)
        self.device = require_device(device)
        s, out_row, out_col, nnz_out, num_products = _fixedside_select(lhs, rhs, fixed)
        self.rows, self.cols = lhs.rows, rhs.cols
        self.fixed = fixed
        self.num_products = num_products
        self.nnz_out = nnz_out
        self._dtype = _TORCH_DTYPES[np.dtype(dtype)]
        self.out_row_host = np.asarray(out_row)
        self.out_col_host = np.asarray(out_col)
        self.out_row = _t(out_row, self.device)
        self.out_col = _t(out_col, self.device)
        self._default_x = _t((rhs.vals if fixed == "lhs" else lhs.vals).astype(dtype),
                              self.device)
        self.selection = s
        self.op = _operator(s, force, dtype, self.device)

    def multiply_device(self, vals=None) -> PaddedCoo:
        """One SpMV: ``vals`` = the varying side's values in CSR order
        (default: those captured at plan time)."""
        x = self._default_x if vals is None else torch.as_tensor(
            vals, dtype=self._dtype, device=self.device)
        return PaddedCoo(self.out_row, self.out_col, self.op(x),
                         torch.tensor(self.nnz_out, dtype=torch.int32, device=self.device),
                         self.rows, self.cols)

    def multiply(self, vals=None) -> CsrMatrix:
        return padded_to_host(self.multiply_device(vals))


def reduce_f64_bound(engine, x):
    """``(vals_f64, bound)`` for a :class:`ReduceSpmv` or
    :class:`FixedSideSpgemm` applied to ``x`` (the product stream, or the
    varying side's values): the float64 ``selection @ x`` and the float32
    bound of ``spmv_f64_bound`` for the SpMV format that applies it (the
    C8 form for the LanePack and stripe-scan plans it runs)."""
    from .spmv import spmv_f64_bound

    x = np.asarray(x, dtype=np.float64)
    if engine.selection is None:
        return np.zeros(0), np.zeros(0)
    op = engine.op
    lanepack = [p for p in (op._plan,
                            op._aligned.spill if op._aligned is not None else None,
                            op._bell.spill if op._bell is not None else None) if p is not None]
    stripe = () if op._stripe is None else (op._stripe,)
    return spmv_f64_bound(engine.selection, x, lanepack=tuple(lanepack), stripe=stripe)
