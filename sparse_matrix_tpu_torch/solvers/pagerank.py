"""PageRank by pull iterations over a planned operator: GAP's
``PageRankPull`` (the GAP Benchmark Suite, Beamer, Asanovic, Patterson,
arXiv:1508.03619; gapbs ``src/pr_spmv.cc``).

Scores start at ``1 / n``. Each iteration computes ``contrib[v] = s[v] /
deg[v]`` and ``s[u] = (1 - damping) / n + damping * sum_{v in N(u)}
contrib[v]``, the sum a pull through the operator (the graph's adjacency,
an undirected graph's rows being its in-neighbours), and stops after
``maxiter`` iterations or once the L1 change ``sum |s_new - s_old|``,
taken in float64 as GAP takes it, falls below ``tol``. A vertex of degree
0 contributes 0 (it has no neighbour, so in an undirected graph nobody
pulls it; GAP's division gives inf there) and keeps the base score; no
dangling mass is redistributed, as in GAP.

The vector work is PyTorch's elementwise operations. Spans
(``utils/profiling.py``, off by default): ``spmx.pagerank`` around a call,
``spmx.pagerank.pull`` around each pull, ``spmx.pagerank.sync`` around
each stopping test's host read.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils.profiling import span

__all__ = ["PageRankResult", "pagerank"]


class PageRankResult(NamedTuple):
    scores: torch.Tensor
    iterations: int


def pagerank(op: Callable, degrees: torch.Tensor, *, damping: float = 0.85, tol: float = 1e-4,
             maxiter: int = 20) -> PageRankResult:
    """GAP's pull PageRank over ``op`` (``y = A x`` for the graph's
    adjacency A, typically an :class:`~sparse_matrix_tpu_torch.ops.operator.
    SpmvOperator` of float32 values) with the vertices' ``degrees`` on its
    device. Returns float32 scores and the iterations run."""
    with span("spmx.pagerank"):
        n = degrees.numel()
        deg = degrees.to(torch.float32)
        deg = torch.where(deg > 0, deg, torch.inf)
        # GAP's float arithmetic: (1.0f - kDamp) / n
        base = ((torch.tensor(1.0, dtype=torch.float32) - damping) / n).item()
        s = torch.full((n,), 1.0 / n, dtype=torch.float32, device=degrees.device)
        k = 0
        while k < maxiter:
            with span("spmx.pagerank.pull"):
                incoming = op(s / deg)
            s_new = incoming.mul_(damping).add_(base)
            err = (s_new - s).abs_().sum(dtype=torch.float64)
            s = s_new
            k += 1
            with span("spmx.pagerank.sync"):
                if float(err) < tol:
                    break
        return PageRankResult(s, k)
