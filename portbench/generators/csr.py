"""A plain host CSR on numpy arrays, with the port's ``CsrMatrix``
conventions: ``offsets`` int64 (``rows + 1``), ``indices`` uint32,
``vals`` in the generator's dtype, rows sorted by column."""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Csr(NamedTuple):
    rows: int
    cols: int
    offsets: np.ndarray
    indices: np.ndarray
    vals: np.ndarray

    def nnz(self) -> int:
        return int(self.indices.shape[0])

    def row_ids(self) -> np.ndarray:
        return np.repeat(np.arange(self.rows, dtype=np.int64), np.diff(self.offsets))

    def astype(self, dtype) -> "Csr":
        return self._replace(vals=self.vals.astype(dtype))


def from_coo(rows: int, cols: int, r, c, v, *, sum_duplicates: bool = True) -> Csr:
    """Sorted CSR from COO triplets (by row, then column, equal keys in entry
    order); duplicate coordinates summed in entry order unless
    ``sum_duplicates=False``. The port's ``CsrMatrix.from_coo`` (a lexsort
    and ``np.add.at``) gives the same arrays: a stable sort of the packed
    key orders as the lexsort does, and ``np.bincount`` adds each bin's
    float64 values in entry order as ``np.add.at`` does."""
    r = np.asarray(r, dtype=np.int64)
    c = np.asarray(c, dtype=np.int64)
    v = np.asarray(v)
    keys = r * cols + c
    order = np.argsort(keys, kind="stable")
    keys, r, c, v = keys[order], r[order], c[order], v[order]
    if sum_duplicates and len(r):
        head = np.empty(len(keys), dtype=bool)
        head[0] = True
        np.not_equal(keys[1:], keys[:-1], out=head[1:])
        seg = np.cumsum(head) - 1
        if v.dtype == np.float64:
            v = np.bincount(seg, weights=v, minlength=int(seg[-1]) + 1)
        else:
            summed = np.zeros(int(seg[-1]) + 1, dtype=v.dtype)
            np.add.at(summed, seg, v)
            v = summed
        r, c = r[head], c[head]
    offsets = np.zeros(rows + 1, dtype=np.int64)
    offsets[1:] = np.bincount(r, minlength=rows)
    np.cumsum(offsets, out=offsets)
    return Csr(int(rows), int(cols), offsets, c.astype(np.uint32), v)
