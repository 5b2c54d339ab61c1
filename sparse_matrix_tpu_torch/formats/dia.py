"""DIA (diagonal) format for banded matrices.

Counterpart of ``sparse_matrix_tpu/formats/dia.py`` (its numpy branches):
``data[b, i] = A[i, i + offsets[b]]``, zero where row ``i`` has no entry on
band ``b``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .csr import CsrMatrix

__all__ = ["DiaMatrix", "try_dia_from_csr"]

MAX_BANDS = 64
MIN_FILL = 0.25  # band slots actually used


@dataclass(frozen=True)
class DiaMatrix:
    rows: int
    cols: int
    data: np.ndarray  # (nbands, rows)
    offsets: tuple  # band offsets (col - row), python ints

    @property
    def nbands(self) -> int:
        return int(self.data.shape[0])

    def nnz(self) -> int:
        return int(np.count_nonzero(self.data))

    def to_csr(self) -> CsrMatrix:
        """Sorted CSR of the nonzero in-shape band slots (exact zeros are
        dropped)."""
        rows_l, cols_l, vals_l = [], [], []
        i = np.arange(self.rows, dtype=np.int64)
        for b, off in enumerate(self.offsets):
            j = i + off
            ok = (j >= 0) & (j < self.cols) & (self.data[b] != 0)
            rows_l.append(i[ok])
            cols_l.append(j[ok])
            vals_l.append(self.data[b][ok])
        return CsrMatrix.from_coo(self.rows, self.cols, np.concatenate(rows_l),
                                  np.concatenate(cols_l), np.concatenate(vals_l),
                                  sum_duplicates=False)


def try_dia_from_csr(
    m: CsrMatrix,
    *,
    dtype=np.float32,
    max_bands: int = MAX_BANDS,
    min_fill: float = MIN_FILL,
) -> Optional[DiaMatrix]:
    """DIA form of ``m`` when it has at most ``max_bands`` distinct
    diagonals filling at least ``min_fill`` of the band storage, else
    None. Memoized on the matrix."""
    if m.nnz() == 0:
        return None
    key = ("dia", np.dtype(dtype).str, max_bands, float(min_fill))
    cache = getattr(m, "_cache", None)
    if cache is not None and key in cache:
        return cache[key]
    res = _try_dia_from_csr(m, dtype=dtype, max_bands=max_bands, min_fill=min_fill)
    if cache is not None:
        cache[key] = res
    return res


def _try_dia_from_csr(m, *, dtype, max_bands, min_fill):
    r = m.row_ids()
    c = m.indices.astype(np.int64)
    if m.nnz() > 1_000_000:
        # sampled pre-filter: 100k entries showing more than max_bands
        # distinct offsets reject for certain
        idx = np.linspace(0, m.nnz() - 1, 100_000).astype(np.int64)
        if len(np.unique(c[idx] - r[idx])) > max_bands:
            return None
    offs = np.unique(c - r)
    if len(offs) > max_bands:
        return None
    if m.nnz() < min_fill * len(offs) * m.rows:
        return None
    data = np.zeros((len(offs), m.rows), dtype=dtype)
    vals = m.vals if m.vals.dtype == np.dtype(dtype) else m.vals.astype(dtype)
    band = np.searchsorted(offs, c - r)
    data[band, r] = vals
    return DiaMatrix(m.rows, m.cols, data, tuple(int(o) for o in offs))
