"""The n^2 x n^2 five-point Laplacian on an n x n grid (Dirichlet): 4 on
the diagonal, -1 for each in-grid neighbour. A copy of the port's
``solvers/poisson.py::poisson_2d_csr``; it draws nothing from ``rng``."""

from __future__ import annotations

import numpy as np

from portbench.generators.csr import Csr


def make(rng, *, n: int) -> Csr:
    """Each row's entries written in column order (north, west, centre,
    east, south), so no sort is needed: the arrays of the port's COO build
    and sort."""
    idx = np.arange(n * n, dtype=np.int64)
    i, j = idx // n, idx % n
    cols = np.stack([idx - n, idx - 1, idx, idx + 1, idx + n], axis=1)
    ok = np.stack([i > 0, j > 0, np.ones(n * n, dtype=bool), j < n - 1, i < n - 1], axis=1)
    vals = np.broadcast_to(np.array([-1.0, -1.0, 4.0, -1.0, -1.0]), cols.shape)
    offsets = np.zeros(n * n + 1, dtype=np.int64)
    np.cumsum(ok.sum(axis=1), out=offsets[1:])
    return Csr(n * n, n * n, offsets, cols[ok].astype(np.uint32), vals[ok].copy())
