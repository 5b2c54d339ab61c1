"""Host CSR matrix: the subset of ``sparse_matrix_tpu/formats/csr.py`` that
the planners, the operator's dispatch, the SpGEMM engines and the tests
use.

Same arrays and conventions as the reference: ``vals``, ``indices``
(uint32), ``offsets`` (int64, ``rows + 1``), an ``is_sorted`` flag, and a
``_cache`` dict in which the planners memoize structure analyses (row ids,
slab counts, DIA probes, row-band samples, the transpose). ``A @ B`` runs
``spgemm_auto`` on the port's default device (``device.default_device``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["CsrMatrix", "INDEX_DTYPE", "OFFSET_DTYPE", "sample_row_bands"]

INDEX_DTYPE = np.uint32
OFFSET_DTYPE = np.int64


def _check_dims(rows: int, cols: int):
    rows, cols = int(rows), int(cols)
    if rows <= 0 or cols <= 0:
        raise ValueError("matrix dimensions must be positive (got %r x %r)" % (rows, cols))
    return rows, cols


class CsrMatrix:
    """Compressed sparse row matrix with optional within-row column sorting."""

    __slots__ = ("_rows", "_cols", "vals", "indices", "offsets", "is_sorted", "_cache")

    def __init__(self, rows: int, cols: int, vals, indices, offsets, *, is_sorted: bool):
        self._rows, self._cols = _check_dims(rows, cols)
        self.vals = np.asarray(vals)
        self.indices = np.asarray(indices, dtype=INDEX_DTYPE)
        self.offsets = np.asarray(offsets, dtype=OFFSET_DTYPE)
        self.is_sorted = bool(is_sorted)
        # memo for idempotent structure analyses (planners probe the same
        # matrix repeatedly during dispatch)
        self._cache = {}

    @classmethod
    def from_coo(cls, rows: int, cols: int, r, c, v, *, sum_duplicates: bool = True) -> "CsrMatrix":
        """Sorted CSR from COO triplets (lexsort by row, then column);
        duplicate coordinates are summed unless ``sum_duplicates=False``."""
        rows, cols = _check_dims(rows, cols)
        r = np.asarray(r, dtype=np.int64)
        c = np.asarray(c, dtype=np.int64)
        v = np.asarray(v)
        order = np.lexsort((c, r))
        r, c, v = r[order], c[order], v[order]
        if sum_duplicates and len(r):
            keys = r * cols + c
            head = np.empty(len(keys), dtype=bool)
            head[0] = True
            np.not_equal(keys[1:], keys[:-1], out=head[1:])
            seg = np.cumsum(head) - 1
            summed = np.zeros(int(seg[-1]) + 1, dtype=v.dtype)
            np.add.at(summed, seg, v)  # in entry order, dtype kept
            v = summed
            r, c = r[head], c[head]
        offsets = np.zeros(rows + 1, dtype=OFFSET_DTYPE)
        offsets[1:] = np.bincount(r, minlength=rows)
        np.cumsum(offsets, out=offsets)
        return cls(rows, cols, v, c.astype(INDEX_DTYPE), offsets, is_sorted=True)

    @classmethod
    def new(cls, rows: int, cols: int, *, dtype=np.float64, is_sorted: bool = True) -> "CsrMatrix":
        """An empty ``rows x cols`` matrix."""
        rows, cols = _check_dims(rows, cols)
        return cls(
            rows,
            cols,
            np.zeros(0, dtype=dtype),
            np.zeros(0, dtype=INDEX_DTYPE),
            np.zeros(rows + 1, dtype=OFFSET_DTYPE),
            is_sorted=is_sorted,
        )

    @classmethod
    def identity(cls, n: int, *, dtype=np.float64, is_sorted: bool = True) -> "CsrMatrix":
        """The ``n x n`` identity."""
        return cls(n, n, np.ones(n, dtype=dtype), np.arange(n, dtype=INDEX_DTYPE),
                   np.arange(n + 1, dtype=OFFSET_DTYPE), is_sorted=is_sorted)

    def to_dense(self) -> np.ndarray:
        a = np.zeros((self._rows, self._cols), dtype=self.vals.dtype)
        # duplicate-free by construction (from_coo sums duplicates)
        a[self.row_ids(), self.indices.astype(np.int64)] = self.vals
        return a

    @property
    def rows(self) -> int:
        return self._rows

    @property
    def cols(self) -> int:
        return self._cols

    @property
    def shape(self):
        return (self._rows, self._cols)

    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def row_ids(self) -> np.ndarray:
        """Per-entry row index (expansion of ``offsets``), memoized; treat
        the result as read-only."""
        out = self._cache.get("row_ids")
        if out is None:
            out = np.repeat(np.arange(self._rows, dtype=np.int64), np.diff(self.offsets))
            self._cache["row_ids"] = out
        return out

    # -- structure ------------------------------------------------------------
    def transpose(self) -> "CsrMatrix":
        """Transpose by a stable (col, row) sort (the reference's numpy
        branch): transposed rows come out sorted. Memoized both ways; the
        port's matrices are not mutated in place, so the memo needs no
        version stamp."""
        t = self._cache.get("transpose")
        if t is None:
            order = np.lexsort((self.row_ids(), self.indices.astype(np.int64)))
            offsets = np.zeros(self._cols + 1, dtype=OFFSET_DTYPE)
            offsets[1:] = np.bincount(self.indices.astype(np.int64), minlength=self._cols)
            np.cumsum(offsets, out=offsets)
            t = CsrMatrix(self._cols, self._rows, self.vals[order],
                          self.row_ids()[order].astype(INDEX_DTYPE), offsets,
                          is_sorted=self.is_sorted)
            self._cache["transpose"] = t
            t._cache["transpose"] = self
        return t

    @property
    def T(self) -> "CsrMatrix":
        return self.transpose()

    # -- arithmetic -------------------------------------------------------------
    def apply_elementwise(self, rhs: "CsrMatrix", f) -> "CsrMatrix":
        """Union merge ``f(t1, t2)`` over every position present in either
        operand, the absent side as zero; cancellation zeros stay explicit
        (the reference's ``apply_elementwise``). ``f`` is a vectorized
        binary function."""
        if self.shape != rhs.shape:
            raise ValueError("matrices must have identical dimensions")
        dtype = np.result_type(self.vals.dtype, rhs.vals.dtype)
        zero = dtype.type(0)
        r = np.concatenate([self.row_ids(), rhs.row_ids()])
        c = np.concatenate([self.indices.astype(np.int64), rhs.indices.astype(np.int64)])
        v = np.concatenate([self.vals.astype(dtype), rhs.vals.astype(dtype)])
        tag = np.concatenate([np.zeros(self.nnz(), np.int8), np.ones(rhs.nnz(), np.int8)])
        if self._rows * self._cols < 2**62:
            # stable on one packed key: lhs before rhs within a position
            order = np.argsort(r * self._cols + c, kind="stable")
        else:
            order = np.lexsort((tag, c, r))
        r, c, v, tag = r[order], c[order], v[order], tag[order]
        n = len(r)
        if n == 0:
            return CsrMatrix(self._rows, self._cols, v, c.astype(INDEX_DTYPE),
                             np.zeros(self._rows + 1, dtype=OFFSET_DTYPE), is_sorted=True)
        head = np.empty(n, dtype=bool)
        head[0] = True
        head[1:] = (r[1:] != r[:-1]) | (c[1:] != c[:-1])
        both = ~head  # the rhs half of a position both operands hold
        lhs_v = np.where(tag == 0, v, zero)
        rhs_v = np.where(tag == 1, v, zero)
        next_rhs = np.zeros(n, dtype=dtype)
        next_rhs[:-1] = np.where(both[1:], rhs_v[1:], zero)
        t1 = np.where(head, lhs_v, zero)
        t2 = np.where(head, np.where(tag == 0, next_rhs, rhs_v), zero)
        out_v = f(t1[head], t2[head])
        r_o, c_o = r[head], c[head]
        offsets = np.zeros(self._rows + 1, dtype=OFFSET_DTYPE)
        offsets[1:] = np.bincount(r_o, minlength=self._rows)
        np.cumsum(offsets, out=offsets)
        return CsrMatrix(self._rows, self._cols, np.asarray(out_v, dtype=dtype),
                         c_o.astype(INDEX_DTYPE), offsets, is_sorted=True)

    def __add__(self, rhs: "CsrMatrix") -> "CsrMatrix":
        return self.apply_elementwise(rhs, np.add)

    def __sub__(self, rhs: "CsrMatrix") -> "CsrMatrix":
        return self.apply_elementwise(rhs, np.subtract)

    def __matmul__(self, rhs: "CsrMatrix") -> "CsrMatrix":
        # unsorted output, as the reference's; the engine is picked by
        # spgemm_auto's cost model on the port's default device
        from ..ops.spgemm_block import spgemm_auto

        return spgemm_auto(self, rhs, output_sorted=False)


def sample_row_bands(m: CsrMatrix, target_nnz: int = 200_000):
    """(sub_csr, scale): four contiguous row bands totalling about
    ``target_nnz`` entries, and the factor that scales entry, slab and
    chunk counts back up. The dispatch estimators run on it for
    multi-million-nnz operators. Memoized per (matrix, target)."""
    nnz = m.nnz()
    if nnz <= target_nnz:
        return m, 1.0
    memo = m._cache.setdefault("row_band_sample", {})
    hit = memo.get(target_nnz)
    if hit is not None:
        return hit
    nbands = 4
    band_nnz = target_nnz // nbands
    starts = np.linspace(0, nnz - band_nnz, nbands).astype(np.int64)
    offs = m.offsets
    vals_parts, idx_parts, counts, bounds = [], [], [], []
    new_row = 0
    for st in starts:
        r0 = int(np.searchsorted(offs, st, side="right") - 1)
        r1 = int(np.searchsorted(offs, st + band_nnz, side="right"))
        r1 = min(max(r1, r0 + 1), m.rows)
        lo, hi = int(offs[r0]), int(offs[r1])
        vals_parts.append(m.vals[lo:hi])
        idx_parts.append(m.indices[lo:hi].astype(np.int64))
        counts.append(np.diff(offs[r0 : r1 + 1]))
        bounds.append(r0 - new_row)  # band's row renumbering shift
        new_row += r1 - r0
    # shift each band's columns with its rows (plus one uniform offset C
    # that keeps them non-negative), so every element offset c - r, and
    # with it the layer/bucket/chunk structure, survives the renumbering
    C = max(max(bounds), 0)
    idx_parts = [(ip - sh + C).astype(INDEX_DTYPE) for ip, sh in zip(idx_parts, bounds)]
    cnt = np.concatenate(counts)
    sub_offs = np.zeros(len(cnt) + 1, OFFSET_DTYPE)
    np.cumsum(cnt, out=sub_offs[1:])
    sub = CsrMatrix(
        len(cnt), m.cols + C, np.concatenate(vals_parts),
        np.concatenate(idx_parts), sub_offs, is_sorted=m.is_sorted,
    )
    out = (sub, nnz / max(1, sub.nnz()))
    memo[target_nnz] = out
    return out
