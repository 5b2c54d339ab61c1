"""2D Poisson 5-point Laplacian model problem (the CG workload).

A host numpy copy of ``sparse_matrix_tpu/solvers/poisson.py``'s
``poisson_2d_csr``, returning the port's ``CsrMatrix``.
"""

from __future__ import annotations

import numpy as np

from ..formats.csr import CsrMatrix

__all__ = ["poisson_2d_csr"]


def poisson_2d_csr(n: int, *, dtype=np.float64) -> CsrMatrix:
    """The n^2 x n^2 five-point Laplacian on an n x n grid (Dirichlet).

    Row for grid point (i, j): 4 on the diagonal, -1 for each in-grid
    neighbor. Built directly in COO, O(n^2).
    """
    idx = np.arange(n * n, dtype=np.int64)
    i, j = idx // n, idx % n

    rows = [idx]
    cols = [idx]
    vals = [np.full(n * n, 4, dtype=dtype)]

    for di, dj in ((-1, 0), (1, 0), (0, -1), (0, 1)):
        ii, jj = i + di, j + dj
        ok = (ii >= 0) & (ii < n) & (jj >= 0) & (jj < n)
        rows.append(idx[ok])
        cols.append((ii * n + jj)[ok])
        vals.append(np.full(int(ok.sum()), -1, dtype=dtype))

    return CsrMatrix.from_coo(
        n * n,
        n * n,
        np.concatenate(rows),
        np.concatenate(cols),
        np.concatenate(vals),
        sum_duplicates=False,
    )
