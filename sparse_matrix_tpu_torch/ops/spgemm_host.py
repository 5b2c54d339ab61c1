"""Host SpGEMM: the FLOP planner, the Gustavson hash engine and the
vectorized ESC engine.

Counterpart of ``sparse_matrix_tpu/ops/spgemm_host.py``:

* :func:`flops_per_row` / :func:`partition_rows_by_flops` — the per-row
  intermediate-product counts (one sweep of the host library) and the
  FLOP-balanced row split;
* :func:`spgemm_hash_host` — Gustavson row-wise SpGEMM in the port's host
  library (``native/src/spmx_host.cpp``, a copy of the reference's native
  engine: threaded symbolic and numeric phases over linear-probe hash
  tables, or a dense accumulator where the output columns are few), as
  the reference runs it. Each output entry sums its products in lhs-CSR
  order and cancellation zeros stay explicit. Two plain versions stay as
  the tests' oracles, called by name and never as a fallback:
  :func:`_spgemm_hash_numpy` (expand the products in lhs-CSR order,
  stable-sort them by (row, column), add each entry's products in that
  order) and :func:`_spgemm_hash_python` (the reference's per-row dict
  loop; under the debug flag it runs a
  :class:`~..utils.linprobe.LinProbeMap` beside the dict and records
  probe-length histograms, as the reference's does). Both give the
  library's values bit for bit;
* :func:`spgemm_esc_host` — expand, sort, compress through
  ``CsrMatrix.from_coo``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..formats.csr import INDEX_DTYPE, OFFSET_DTYPE, CsrMatrix
from ..native import host
from ..utils.debugflags import debug_enabled, record_histogram
from ..utils.linprobe import LinProbeMap

__all__ = [
    "flops_per_row",
    "partition_rows_by_flops",
    "spgemm_hash_host",
    "spgemm_esc_host",
    "expand_products",
]


def flops_per_row(lhs: CsrMatrix, rhs: CsrMatrix) -> np.ndarray:
    """Intermediate products of each output row, ``sum over k in row i of
    lhs of nnz(rhs row k)``: an upper bound on the row's output nnz. One
    sweep of the host library."""
    return host.flops_per_row_native(lhs, rhs)


def _flops_per_row_numpy(lhs: CsrMatrix, rhs: CsrMatrix) -> np.ndarray:
    """Plain version of :func:`flops_per_row`: a gather and a windowed
    sum."""
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

    Runs the host library's engine (:func:`~..native.host.spgemm_hash_native`,
    values of float32, float64 or int64): with ``output_sorted=False`` its
    rows come back in its table order, as the reference's native engine
    returns them. ``force_python=True`` runs the reference's dict loop,
    whose unsorted rows keep first-appearance order.
    """
    if lhs.cols != rhs.rows:
        raise ValueError("LHS cols != RHS rows")
    if force_python:
        return _spgemm_hash_python(lhs, rhs, output_sorted=output_sorted)
    return host.spgemm_hash_native(lhs, rhs, output_sorted=output_sorted)


def _spgemm_hash_numpy(lhs: CsrMatrix, rhs: CsrMatrix, *,
                       output_sorted: bool = False) -> CsrMatrix:
    """Plain vectorized version of :func:`spgemm_hash_host`: its values
    bit for bit, its rows column-sorted whatever ``output_sorted`` says
    (``is_sorted=output_sorted``)."""
    if lhs.cols != rhs.rows:
        raise ValueError("LHS cols != RHS rows")
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
    one pass). Under the debug flag it records the plan's and the
    output's row-length histograms and, from a
    :class:`~..utils.linprobe.LinProbeMap` run beside the dict, the probe
    lengths (``spgemm.*`` in ``utils.debugflags``)."""
    rows = lhs.rows
    dtype = np.result_type(lhs.vals.dtype, rhs.vals.dtype)
    instrument = debug_enabled()
    if instrument:
        row_nz = _flops_per_row_numpy(lhs, rhs)
        record_histogram(
            "spgemm.plan.row_nz", dict(zip(*map(list, np.unique(row_nz, return_counts=True)))))
    out_rows = []
    lo_all, li_all, lv_all = lhs.offsets, lhs.indices, lhs.vals
    ro_all, ri_all, rv_all = rhs.offsets, rhs.indices, rhs.vals
    for i in range(rows):
        acc = {}
        if instrument:
            table = LinProbeMap(max(1, int(row_nz[i])), record_probes=True)
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
                if instrument:
                    table.upsert(j, t1, lambda a, b: a + b)
        if instrument:
            record_histogram("spgemm.numeric.probe_lengths", table.probe_lengths)
        cols = sorted(acc) if output_sorted else list(acc)
        out_rows.append((cols, [acc[c] for c in cols]))
    nnz_row = np.array([len(c) for c, _ in out_rows], dtype=np.int64)
    if instrument:
        record_histogram(
            "spgemm.symbolic.row_nz",
            dict(zip(*map(list, np.unique(nnz_row, return_counts=True)))))
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


def _colmap_spgemm_python(lhs: CsrMatrix, rhs: CsrMatrix):
    """Plain version of :func:`~..native.host.colmap_spgemm_native` (same
    signature and None rule): the dict loop, column-sorted rows. The
    library's per-row merge adds each column's products in lhs-CSR order,
    as the loop does."""
    dtype = np.result_type(lhs.vals.dtype, rhs.vals.dtype)
    if (np.dtype(dtype) not in (np.dtype(np.float32), np.dtype(np.float64))
            or np.diff(rhs.offsets).max(initial=0) > 1):
        return None
    return _spgemm_hash_python(lhs, rhs, output_sorted=True)
