"""HPCG's 27-point operator on an ``nx * ny * nz`` grid (HPCG 3.1's
``GenerateProblem``, one process): row ``ix + nx (iy + ny iz)`` holds 26
on the diagonal and -1 for each in-grid neighbour, columns ascending. A
numpy copy of the port's ``solvers/hpcg.py::hpcg_problem`` (its A; the
right-hand sides are the traffic's); it draws nothing from ``rng``."""

from __future__ import annotations

import numpy as np

from portbench.generators.csr import Csr


def make(rng, *, nx: int, ny: int, nz: int) -> Csr:
    """Each row's entries written in HPCG's loop order (sz, sy, sx from -1
    to 1), which is column order, so no sort is needed."""
    n = nx * ny * nz
    idx = np.arange(n, dtype=np.int64)
    ix, iy, iz = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    cols, ok = [], []
    for sz in (-1, 0, 1):
        for sy in (-1, 0, 1):
            for sx in (-1, 0, 1):
                cols.append(idx + sx + nx * (sy + ny * sz))
                ok.append((ix + sx >= 0) & (ix + sx < nx) & (iy + sy >= 0) & (iy + sy < ny)
                          & (iz + sz >= 0) & (iz + sz < nz))
    cols, ok = np.stack(cols, axis=1), np.stack(ok, axis=1)
    vals = np.where(cols == idx[:, None], 26.0, -1.0)
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(ok.sum(axis=1), out=offsets[1:])
    return Csr(n, n, offsets, cols[ok].astype(np.uint32), vals[ok])
