"""GAP's PageRank written plainly over a graph's CSR pattern.

The GAP Benchmark Suite (Beamer, Asanovic, Patterson, arXiv:1508.03619),
reference code ``src/pr_spmv.cc``, ``PageRankPull``:

* scores start at ``1 / n`` and the base score is ``(1 - damping) / n``,
  both taken in the working dtype;
* each iteration sets ``contrib[v] = s[v] / deg[v]`` and ``s[u] = base +
  damping * sum_{v in N(u)} contrib[v]`` (an undirected graph: a row's
  entries are the vertex's neighbours, in and out);
* it stops after ``maxiter`` iterations, or once the L1 change ``sum |s_new
  - s_old|``, accumulated in float64, falls below ``tol``.

Departures from GAP:

* **The Jacobi form.** GAP has two PageRank kernels: ``pr.cc``, whose pull
  reads the scores of the same sweep (a Gauss-Seidel update, so its result
  depends on the order of its rows), and ``pr_spmv.cc``, which pulls from
  the last iteration's contributions (a Jacobi update, a sparse
  matrix-vector product). This is the second, the one that parallelises on
  a card.
* **Degree 0.** A vertex of degree 0 contributes 0 (GAP's division gives
  inf there; in an undirected graph no vertex pulls from it), and keeps the
  base score. Like GAP, no dangling mass is redistributed.

The pull gathers the contributions of a block of rows' entries and adds
them into the block's rows with ``index_add_``, block after block of
about ``block_entries`` entries (:func:`row_blocks`), each block's row ids
made on the offsets' device: a graph of a billion entries needs no row ids
for all its entries at once, and nothing on the host. Everything runs in
``dtype`` (float64 for the reference, bfloat16 for the control that must
fail), on the device of the offsets.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["PageRank", "row_blocks", "pull", "pagerank"]


class PageRank(NamedTuple):
    scores: torch.Tensor
    iterations: int


def row_blocks(offsets: torch.Tensor, block_entries: int):
    """``[(r0, r1, e0, e1)]``: consecutive row ranges ``[r0, r1)`` holding
    entries ``[e0, e1)``, cut at the start of each row that holds a
    multiple of ``block_entries``: a block holds at most ``block_entries``
    entries beyond its first row."""
    rows = offsets.numel() - 1
    nnz = int(offsets[-1])
    cuts = torch.arange(block_entries, max(nnz, block_entries), block_entries,
                        dtype=torch.int64, device=offsets.device)
    inner = torch.searchsorted(offsets, cuts, right=True) - 1
    bounds = sorted({0, rows, *inner.tolist()})
    at = offsets[torch.tensor(bounds, device=offsets.device)].tolist()
    return [(r0, r1, e0, e1) for r0, r1, e0, e1 in zip(bounds, bounds[1:], at, at[1:])
            if r1 > r0]


def pull(offsets: torch.Tensor, cols: torch.Tensor, contrib: torch.Tensor, blocks) -> torch.Tensor:
    """``incoming[u] = sum_{v in N(u)} contrib[v]``, block by block."""
    incoming = torch.zeros(offsets.numel() - 1, dtype=contrib.dtype, device=contrib.device)
    for r0, r1, e0, e1 in blocks:
        if e1 == e0:
            continue
        local = torch.repeat_interleave(
            torch.arange(r1 - r0, device=offsets.device), offsets[r0 + 1:r1 + 1] - offsets[r0:r1],
            output_size=e1 - e0)
        incoming[r0:r1].index_add_(0, local, contrib[cols[e0:e1].long()])
    return incoming


def pagerank(offsets: torch.Tensor, cols: torch.Tensor, *, dtype=torch.float64,
             damping: float = 0.85, tol: float = 1e-4, maxiter: int = 20,
             block_entries: int = 1 << 26) -> PageRank:
    """GAP's pull PageRank of the graph with row ``offsets`` (int64) and
    column ids ``cols`` (any integer type; int32 holding uint32 bits is
    read as such below 2**31 vertices) in ``dtype``."""
    n = offsets.numel() - 1
    blocks = row_blocks(offsets, block_entries)
    deg = (offsets[1:] - offsets[:-1]).to(dtype)
    deg = torch.where(deg > 0, deg, torch.inf)
    base = (torch.tensor(1.0, dtype=dtype) - damping) / n
    base = base.to(offsets.device)
    s = torch.full((n,), 1.0, dtype=dtype, device=offsets.device) / n
    k = 0
    while k < maxiter:
        s_new = pull(offsets, cols, s / deg, blocks) * damping + base
        err = float((s_new - s).abs().sum(dtype=torch.float64))
        s = s_new
        k += 1
        if err < tol:
            break
    return PageRank(s, k)
