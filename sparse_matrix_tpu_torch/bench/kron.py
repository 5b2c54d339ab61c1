"""GAP's ``kron`` graph: the Graph500 Kronecker generator of the GAP
Benchmark Suite (Beamer, Asanovic, Patterson, arXiv:1508.03619; gapbs
``src/generator.h``, ``MakeKronEL``), made as GAP makes its graphs.

* ``edgefactor * 2**scale`` edges, each drawing one uniform number a level
  for ``scale`` levels; the number picks a quadrant of the adjacency
  matrix with probabilities ``a``, ``b``, ``c`` and ``1 - a - b - c``
  (GAP's comparisons: below ``a + b`` the row bit stays 0 and the column
  bit is set above ``a``; else the row bit is set and the column bit is
  set above ``a + b + c``), the first level giving the highest bit;
* vertex ids permuted uniformly at random;
* the graph made undirected, and GAP's squish (``SquishGraph``):
  self-loops and duplicate edges dropped.

The result is the port's :class:`CsrMatrix` of the adjacency pattern, rows
sorted by column, uint32 columns, unit float32 values.

The random numbers are not GAP's ``std::mt19937`` stream. Each is a
counter-based hash of (the seed drawn from ``rng``, the edge, the level)
in integer arithmetic (:func:`mix`, a 32-bit multiply-xorshift whose
multipliers are below ``2**31``, so that no product leaves a signed 64-bit
integer), and the permutation orders the vertices by a 63-bit hash of
their id. So the CPU and the card give the same graph for a seed, and the
graph can be built on the card: at scale 25 the generator's sort holds
about 2**30 64-bit keys, which the host would take minutes over. Edges
are drawn in chunks of ``2**25`` to bound the temporaries.

The benchmark keeps its own copy (``portbench/generators/kron.py``), held
array-equal to this one by its tests.
"""

from __future__ import annotations

import numpy as np

from ..formats.csr import CsrMatrix

__all__ = ["kronecker", "mix", "thresholds", "MUL1", "MUL2", "GOLDEN"]

M32 = 0xFFFFFFFF
#: the multipliers of :func:`mix` (both odd and below 2**31)
MUL1, MUL2 = 0x7FEB352D, 0x5BD1E995
#: the per-level step of the edge hash
GOLDEN = 0x9E3779B9
CHUNK = 1 << 25


def mix(h):
    """A 32-bit multiply-xorshift of ``h`` (int64 values in ``[0,
    2**32)``, a torch tensor or a numpy array), masked to 32 bits after
    each multiply."""
    h = h ^ (h >> 16)
    h = (h * MUL1) & M32
    h = h ^ (h >> 15)
    h = (h * MUL2) & M32
    return h ^ (h >> 16)


def thresholds(a: float, b: float, c: float):
    """GAP's quadrant bounds ``a``, ``a + b``, ``a + b + c`` on the 32-bit
    scale of a drawn number."""
    return tuple(int(p * 2.0 ** 32) for p in (a, a + b, a + b + c))


def _edges(e, scale: int, s0: int, s1: int, t):
    """The Kronecker endpoints ``(src, dst)`` of the edges ``e`` (int64)
    before the permutation."""
    t_a, t_ab, t_abc = t
    he = mix((e + s0) & M32)
    src = e.new_zeros(e.shape)
    dst = e.new_zeros(e.shape)
    for level in range(scale):
        u = mix(he ^ ((s1 + level * GOLDEN) & M32))
        low = u < t_ab
        src = (src << 1) | (~low).long()
        dst = (dst << 1) | (low & (u > t_a) | ~low & (u > t_abc)).long()
    return src, dst


def _permutation(n: int, s2: int, s3: int, dev):
    """The vertex permutation: ids ranked by a 63-bit hash (ties, which a
    63-bit key makes rare, kept in id order)."""
    import torch

    v = torch.arange(n, dtype=torch.int64, device=dev)
    key = (mix((v + s2) & M32) << 31) | (mix((v ^ s3) & M32) >> 1)
    return torch.sort(key, stable=True).indices


def kronecker(rng, *, scale: int, edgefactor: int, a: float, b: float, c: float,
              device=None) -> CsrMatrix:
    """The graph of the four 32-bit seeds drawn from ``rng``, built on
    ``device`` (by default the card where one is visible, else the CPU)."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    n = 1 << int(scale)
    m = int(edgefactor) * n
    s0, s1, s2, s3 = (int(s) for s in rng.integers(0, 1 << 32, size=4, dtype=np.uint64))
    t = thresholds(a, b, c)
    perm = _permutation(n, s2, s3, dev)
    keys = []
    for lo in range(0, m, CHUNK):
        e = torch.arange(lo, min(m, lo + CHUNK), dtype=torch.int64, device=dev)
        src, dst = _edges(e, int(scale), s0, s1, t)
        src, dst = perm[src], perm[dst]
        keep = src != dst
        src, dst = src[keep], dst[keep]
        keys += [src * n + dst, dst * n + src]
    del perm
    keys = torch.unique(torch.cat(keys))
    rows = torch.bincount(keys >> int(scale), minlength=n)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    torch.cumsum(rows, 0, out=offsets[1:])
    cols = (keys & (n - 1)).to(torch.int32)
    del keys, rows
    offsets = offsets.cpu().numpy()
    cols = cols.cpu().numpy().view(np.uint32)
    return CsrMatrix(n, n, np.ones(cols.shape[0], dtype=np.float32), cols, offsets,
                     is_sorted=True)
