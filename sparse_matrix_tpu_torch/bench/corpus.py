"""The bench's synthetic matrix classes, as ``bench.py`` builds them.

Copies of five generators of ``sparse_matrix_tpu/bench/corpus.py``. The
same ``numpy.random.Generator`` state gives the same matrices.
:func:`with_dominant_diagonal` makes the unsymmetric systems of the ILU
path from any of them; :func:`dense_block_tridiagonal` is the block
kernels' dense-block case.
"""

from __future__ import annotations

import numpy as np

from ..formats.csr import CsrMatrix

__all__ = ["random_uniform", "power_law_rows", "blocked", "random_local", "fem_like",
           "bench_classes", "with_dominant_diagonal", "dense_block_tridiagonal"]


def random_uniform(rng, n, density) -> CsrMatrix:
    """``n * n * density`` entries at uniform random positions (duplicates
    summed)."""
    nnz = int(n * n * density)
    r = rng.integers(0, n, nnz)
    c = rng.integers(0, n, nnz)
    v = rng.standard_normal(nnz)
    return CsrMatrix.from_coo(n, n, r, c, v)


def blocked(rng, n, block, density_in_block) -> CsrMatrix:
    """Block-tridiagonal: ``block x block`` tiles on the three central
    block diagonals, each with ``block^2 * density_in_block`` random
    entries."""
    nb = n // block
    rows, cols, vals = [], [], []
    for bi in range(nb):
        for bj in (bi - 1, bi, bi + 1):
            if 0 <= bj < nb:
                k = int(block * block * density_in_block)
                rows.append(bi * block + rng.integers(0, block, k))
                cols.append(bj * block + rng.integers(0, block, k))
                vals.append(rng.standard_normal(k))
    return CsrMatrix.from_coo(
        n, n, np.concatenate(rows), np.concatenate(cols), np.concatenate(vals)
    )


def dense_block_tridiagonal(rng, n, block) -> CsrMatrix:
    """Block-tridiagonal with every entry of its ``block x block`` tiles
    stored (random normal float32 values): the block kernels' dense-block
    case, where every depth index of every block product is live."""
    nb = n // block
    bi = np.repeat(np.arange(nb), 3)
    bj = bi + np.tile([-1, 0, 1], nb)
    keep = (bj >= 0) & (bj < nb)
    bi, bj = bi[keep], bj[keep]
    r = (bi[:, None] * block + np.arange(block)[None, :])[:, :, None]
    c = (bj[:, None] * block + np.arange(block)[None, :])[:, None, :]
    rows = np.broadcast_to(r, (bi.size, block, block)).ravel()
    cols = np.broadcast_to(c, (bi.size, block, block)).ravel()
    vals = rng.standard_normal(rows.size).astype(np.float32)
    return CsrMatrix.from_coo(n, n, rows, cols, vals)


def power_law_rows(rng, n, avg_nnz, alpha: float = 1.5) -> CsrMatrix:
    """Pareto row lengths: a few very heavy rows, uniform random columns."""
    lens = np.minimum((rng.pareto(alpha, n) + 1) * avg_nnz / 3, n).astype(np.int64)
    r = np.repeat(np.arange(n), lens)
    c = rng.integers(0, n, len(r))
    v = rng.standard_normal(len(r))
    return CsrMatrix.from_coo(n, n, r, c, v)


def random_local(rng, n, per_row, bandwidth) -> CsrMatrix:
    """Random columns within a band around the diagonal."""
    r = np.repeat(np.arange(n, dtype=np.int64), per_row)
    off = rng.integers(-bandwidth, bandwidth + 1, size=len(r))
    c = np.clip(r + off, 0, n - 1)
    v = rng.standard_normal(len(r))
    return CsrMatrix.from_coo(n, n, r, c, v)


def fem_like(rng, n_side, jitter) -> CsrMatrix:
    """9-point stencil with per-entry index jitter (clustered locality)."""
    n = n_side * n_side
    offs = np.array([-n_side - 1, -n_side, -n_side + 1, -1, 0, 1,
                     n_side - 1, n_side, n_side + 1], dtype=np.int64)
    r = np.repeat(np.arange(n, dtype=np.int64), len(offs))
    c = r + np.tile(offs, n) + rng.integers(-jitter, jitter + 1, size=len(r))
    keep = (c >= 0) & (c < n)
    r, c = r[keep], c[keep]
    v = rng.standard_normal(len(r))
    return CsrMatrix.from_coo(n, n, r, c, v)


def bench_classes(seed: int = 0):
    """``[(name, class tag, CsrMatrix)]`` for the three 262k-row bench
    classes, drawn in ``bench.py``'s order from one seeded generator."""
    rng = np.random.default_rng(seed)
    return [
        ("femlike_262k", "local", fem_like(rng, 512, 2)),
        ("randlocal_262k", "scatter", random_local(rng, 1 << 18, 16, 4096)),
        ("powerlaw_262k", "skew", power_law_rows(rng, 1 << 18, 16)),
    ]


def with_dominant_diagonal(m: CsrMatrix, shift: float = 2.0) -> CsrMatrix:
    """``m``'s pattern and values with every diagonal entry (added where
    the pattern lacks it) set to its row's absolute sum plus ``shift``: the
    reference tests' strictly diagonally dominant unsymmetric system
    (``np.fill_diagonal(d, np.abs(d).sum(axis=1) + shift)``,
    ``tests/test_ilu.py``)."""
    r = m.row_ids()
    c = m.indices.astype(np.int64)
    diag = np.abs(m.vals).astype(np.float64)
    diag = np.bincount(r, weights=diag, minlength=m.rows) + shift
    off = r != c
    ar = np.arange(m.rows, dtype=np.int64)
    return CsrMatrix.from_coo(m.rows, m.cols, np.r_[r[off], ar], np.r_[c[off], ar],
                              np.r_[m.vals[off], diag.astype(m.vals.dtype)])
