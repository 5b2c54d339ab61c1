"""FEM-like class of the JAX package's bench corpus: a 9-point stencil on
an ``n_side`` x ``n_side`` grid with per-entry index jitter in
``[-jitter, jitter]`` (clustered locality), random normal values,
duplicates summed. A copy of the port's ``bench/corpus.py::fem_like``:
the same ``numpy.random.Generator`` state gives the same matrix."""

from __future__ import annotations

import numpy as np

from portbench.generators.csr import Csr, from_coo


def make(rng, *, n_side: int, jitter: int) -> Csr:
    n = n_side * n_side
    offs = np.array([-n_side - 1, -n_side, -n_side + 1, -1, 0, 1,
                     n_side - 1, n_side, n_side + 1], dtype=np.int64)
    r = np.repeat(np.arange(n, dtype=np.int64), len(offs))
    c = r + np.tile(offs, n) + rng.integers(-jitter, jitter + 1, size=len(r))
    keep = (c >= 0) & (c < n)
    r, c = r[keep], c[keep]
    v = rng.standard_normal(len(r))
    return from_coo(n, n, r, c, v)
