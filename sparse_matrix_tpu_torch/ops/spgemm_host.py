"""Host SpGEMM: the FLOP planner, the Gustavson hash engine and the
vectorized ESC engine, in numpy.

Counterpart of ``sparse_matrix_tpu/ops/spgemm_host.py`` (its numpy
branches):

* :func:`flops_per_row` / :func:`partition_rows_by_flops` — the per-row
  intermediate-product counts and the FLOP-balanced row split;
* :func:`spgemm_hash_host` — Gustavson row-wise SpGEMM. The reference
  calls its native C++ hash engine here, which the port does not have
  (ROADMAP.md queue A item 17). By default it runs a vectorized stand-in:
  expand the products in lhs-CSR order, stable-sort them by (row, col),
  add each output entry's products in that order. ``force_python=True``
  runs the reference's per-row dict loop. Both add each entry's products
  in lhs-CSR order, as the hash engine does, so both give the same values
  as the reference's ``force_python=True``, bit for bit;
* :func:`spgemm_esc_host` — expand, sort, compress through
  ``CsrMatrix.from_coo``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..formats.csr import INDEX_DTYPE, OFFSET_DTYPE, CsrMatrix

__all__ = [
    "flops_per_row",
    "partition_rows_by_flops",
    "spgemm_hash_host",
    "spgemm_esc_host",
    "expand_products",
]


def flops_per_row(lhs: CsrMatrix, rhs: CsrMatrix) -> np.ndarray:
    """Intermediate products of each output row, ``sum over k in row i of
    lhs of nnz(rhs row k)``: an upper bound on the row's output nnz."""
    rhs_row_nnz = np.diff(rhs.offsets)
    gathered = rhs_row_nnz[lhs.indices.astype(np.int64)]
    cs = np.zeros(len(gathered) + 1, dtype=np.int64)
    np.cumsum(gathered, out=cs[1:])
    return cs[lhs.offsets[1:]] - cs[lhs.offsets[:-1]]


def partition_rows_by_flops(flop_row: np.ndarray, num_parts: int) -> np.ndarray:
    """``num_parts + 1`` row boundaries of contiguous chunks of about equal
    FLOPs: boundary ``t`` at ``searchsorted(prefix, avg * t, 'right') -
    1`` over the inclusive prefix sum (the reference's rule)."""
    rows = len(flop_row)
    ps = np.zeros(rows + 1, dtype=np.int64)
    np.cumsum(flop_row, out=ps[1:])
    total = int(ps[-1])
    avg = -(-total // num_parts) if num_parts > 0 else total  # ceil div
    bounds = [0]
    for t in range(1, num_parts):
        bounds.append(int(np.searchsorted(ps, avg * t, side="right")) - 1)
    bounds.append(rows)
    return np.asarray(bounds, dtype=np.int64)


def _expand_index(lhs: CsrMatrix, rhs: CsrMatrix) -> Tuple[np.ndarray, np.ndarray]:
    """``(src, q)``: for every intermediate product in lhs-CSR order, its
    lhs entry and its rhs entry."""
    k_idx = lhs.indices.astype(np.int64)
    reps = np.diff(rhs.offsets)[k_idx]  # products per lhs entry
    total = int(reps.sum())
    src = np.repeat(np.arange(lhs.nnz(), dtype=np.int64), reps)
    run_starts = np.zeros(lhs.nnz() + 1, dtype=np.int64)
    np.cumsum(reps, out=run_starts[1:])
    within = np.arange(total, dtype=np.int64) - run_starts[src]
    q = rhs.offsets[k_idx[src]].astype(np.int64) + within
    return src, q


def expand_products(lhs: CsrMatrix, rhs: CsrMatrix) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """All intermediate products of ``C = A @ B`` as COO triplets, in
    lhs-CSR order: lhs entry (r, k, a) emits ``(r, rhs.indices[q], a *
    rhs.vals[q])`` for each q in rhs row k."""
    src, q = _expand_index(lhs, rhs)
    out_r = lhs.row_ids()[src]
    out_c = rhs.indices.astype(np.int64)[q]
    out_v = lhs.vals[src] * rhs.vals[q]
    return out_r, out_c, out_v


def spgemm_esc_host(lhs: CsrMatrix, rhs: CsrMatrix, *, output_sorted: bool = True) -> CsrMatrix:
    """Expand-sort-compress SpGEMM, vectorized in numpy."""
    if lhs.cols != rhs.rows:
        raise ValueError("LHS cols != RHS rows")
    r, c, v = expand_products(lhs, rhs)
    out = CsrMatrix.from_coo(lhs.rows, rhs.cols, r, c, v)
    return CsrMatrix(lhs.rows, rhs.cols, out.vals, out.indices, out.offsets,
                     is_sorted=output_sorted)


def spgemm_hash_host(lhs: CsrMatrix, rhs: CsrMatrix, *, output_sorted: bool = False,
                     force_python: bool = False) -> CsrMatrix:
    """Gustavson SpGEMM on the host; each output entry sums its products
    in lhs-CSR order, and cancellation zeros stay explicit.

    The default route is vectorized (see the module docstring); its rows
    come back column-sorted whatever ``output_sorted`` says, with
    ``is_sorted=output_sorted``. ``force_python=True`` runs the per-row
    dict loop, whose unsorted rows keep first-appearance order.
    """
    if lhs.cols != rhs.rows:
        raise ValueError("LHS cols != RHS rows")
    if force_python:
        return _spgemm_hash_python(lhs, rhs, output_sorted=output_sorted)
    dtype = np.result_type(lhs.vals.dtype, rhs.vals.dtype)
    src, q = _expand_index(lhs, rhs)
    key = lhs.row_ids()[src] * rhs.cols + rhs.indices.astype(np.int64)[q]
    # stable: within one output entry the products keep lhs-CSR order
    order = np.argsort(key, kind="stable")
    key = key[order]
    prod = lhs.vals[src[order]].astype(dtype) * rhs.vals[q[order]].astype(dtype)
    del src, q, order
    n = len(key)
    head = np.empty(n, dtype=bool)
    if n:
        head[0] = True
        np.not_equal(key[1:], key[:-1], out=head[1:])
    seg = np.cumsum(head) - 1
    vals = np.zeros(int(head.sum()), dtype=dtype)
    np.add.at(vals, seg, prod)  # sequential, in entry order
    ukey = key[head]
    offsets = np.zeros(lhs.rows + 1, dtype=OFFSET_DTYPE)
    offsets[1:] = np.bincount(ukey // rhs.cols, minlength=lhs.rows)
    np.cumsum(offsets, out=offsets)
    return CsrMatrix(lhs.rows, rhs.cols, vals, (ukey % rhs.cols).astype(INDEX_DTYPE),
                     offsets, is_sorted=output_sorted)


def _spgemm_hash_python(lhs: CsrMatrix, rhs: CsrMatrix, *, output_sorted: bool) -> CsrMatrix:
    """The reference's dict loop: per row, one dict from output column to
    running sum, filled in lhs-CSR order (symbolic and numeric phases in
    one pass)."""
    rows = lhs.rows
    dtype = np.result_type(lhs.vals.dtype, rhs.vals.dtype)
    out_rows = []
    lo_all, li_all, lv_all = lhs.offsets, lhs.indices, lhs.vals
    ro_all, ri_all, rv_all = rhs.offsets, rhs.indices, rhs.vals
    for i in range(rows):
        acc = {}
        for p in range(int(lo_all[i]), int(lo_all[i + 1])):
            k = int(li_all[p])
            t = lv_all[p]
            for q in range(int(ro_all[k]), int(ro_all[k + 1])):
                j = int(ri_all[q])
                t1 = t * rv_all[q]
                if j in acc:
                    acc[j] = acc[j] + t1
                else:
                    acc[j] = t1
        cols = sorted(acc) if output_sorted else list(acc)
        out_rows.append((cols, [acc[c] for c in cols]))
    nnz_row = np.array([len(c) for c, _ in out_rows], dtype=np.int64)
    offsets = np.zeros(rows + 1, dtype=OFFSET_DTYPE)
    np.cumsum(nnz_row, out=offsets[1:])
    nnz = int(offsets[-1])
    indices = np.empty(nnz, dtype=INDEX_DTYPE)
    vals = np.empty(nnz, dtype=dtype)
    for i, (cols, vv) in enumerate(out_rows):
        lo = int(offsets[i])
        indices[lo : lo + len(cols)] = cols
        vals[lo : lo + len(cols)] = vv
    return CsrMatrix(lhs.rows, rhs.cols, vals, indices, offsets, is_sorted=output_sorted)
