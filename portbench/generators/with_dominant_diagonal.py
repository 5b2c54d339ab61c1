"""The matrix's pattern and values with every diagonal entry (added where
the pattern lacks it) set to its row's absolute sum plus ``shift``: the
strictly diagonally dominant unsymmetric system of the ILU path. A copy of
the port's ``bench/corpus.py::with_dominant_diagonal``."""

from __future__ import annotations

import numpy as np

from portbench.generators.csr import Csr, from_coo


def transform(m: Csr, *, shift: float = 2.0) -> Csr:
    r = m.row_ids()
    c = m.indices.astype(np.int64)
    diag = np.bincount(r, weights=np.abs(m.vals).astype(np.float64), minlength=m.rows) + shift
    off = r != c
    ar = np.arange(m.rows, dtype=np.int64)
    return from_coo(m.rows, m.cols, np.r_[r[off], ar], np.r_[c[off], ar],
                    np.r_[m.vals[off], diag.astype(m.vals.dtype)])
