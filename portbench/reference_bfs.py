"""Breadth-first search written plainly over a graph's CSR pattern, and
Graph500's validation of a BFS tree against it.

:func:`bfs` is a level-synchronous top-down BFS: each level gathers the
rows of the frontier's vertices and gives every neighbour not yet reached
the next depth and one of the frontier's vertices as its parent. It
returns the depth of every vertex (-1 where unreached), a parent array
(the source its own parent, -1 where unreached) and the deepest level. Its
parents are valid but need not be those of another BFS: where several
frontier vertices share an unreached neighbour, any of them may be the
parent (on a card, which one depends on the order of the writes). What
every BFS from the same source agrees on is the depths, and so the set of
valid parents; :func:`tree_errors` checks a parent array by them.

:func:`tree_errors` is Graph500's validation of a BFS tree (kernel 2's
``validate``), held to this BFS's depths. A vertex counts as an error
where

* it is the source and not its own parent;
* it is unreached here and has a parent;
* it is reached here, is not the source, and has none;
* its parent is not one of its neighbours (a binary search of its row,
  whose columns are sorted);
* its parent's depth here is not one less than its own.

Together these imply that the tree has no cycle (every parent edge goes
one level up) and that its depths are these.

The gathers run on the device of ``offsets``, a block of at most
``block_entries`` entries (or ``block_rows`` vertices for the validation)
at a time, so that a graph of a billion entries needs no more than a few
GB beside its CSR. Column ids are read as int64 from the int32 bits of
uint32 columns (ids below 2**31). Imports ``torch`` alone.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Bfs", "bfs", "tree_errors"]


class Bfs(NamedTuple):
    depths: torch.Tensor  # int32, -1 where unreached
    parents: torch.Tensor  # int32, the source its own, -1 where unreached
    levels: int  # the deepest depth reached


def _frontier_blocks(deg: torch.Tensor, block_entries: int):
    """``[(i0, i1)]``: consecutive ranges of the frontier, each ending at
    the vertex whose degree carries the running sum past a multiple of
    ``block_entries``: a range holds at most ``block_entries`` entries
    and one row more."""
    cum = torch.cumsum(deg, 0)
    total = int(cum[-1]) if cum.numel() else 0
    cuts = torch.arange(block_entries, max(total, block_entries), block_entries,
                        dtype=torch.int64, device=deg.device)
    inner = torch.searchsorted(cum, cuts, right=False) + 1
    bounds = sorted({0, deg.numel(), *inner.clamp(max=deg.numel()).tolist()})
    return list(zip(bounds, bounds[1:]))


def bfs(offsets: torch.Tensor, cols: torch.Tensor, source: int, *, max_levels=None,
        block_entries: int = 1 << 25) -> Bfs:
    """BFS from ``source`` over the graph with row ``offsets`` (int64) and
    column ids ``cols``; ``max_levels`` stops it after that many levels
    (the control's short search)."""
    dev = offsets.device
    n = offsets.numel() - 1
    depths = torch.full((n,), -1, dtype=torch.int32, device=dev)
    parents = torch.full((n,), -1, dtype=torch.int32, device=dev)
    depths[source] = 0
    parents[source] = source
    frontier = torch.tensor([source], dtype=torch.int64, device=dev)
    level = 0
    while frontier.numel() and (max_levels is None or level < max_levels):
        deg = offsets[frontier + 1] - offsets[frontier]
        for i0, i1 in _frontier_blocks(deg, block_entries):
            f, d = frontier[i0:i1], deg[i0:i1]
            count = int(d.sum())
            if count == 0:
                continue
            local = torch.repeat_interleave(torch.arange(i1 - i0, device=dev), d,
                                            output_size=count)
            excl = torch.cumsum(d, 0) - d
            pos = offsets[f][local] + torch.arange(count, device=dev) - excl[local]
            nbr = cols[pos].long()
            new = depths[nbr] == -1
            nbr, u = nbr[new], f[local[new]]
            depths[nbr] = level + 1
            parents[nbr] = u.to(torch.int32)
            del local, excl, pos, new, u, nbr
        level += 1
        frontier = torch.nonzero(depths == level).flatten()
    return Bfs(depths, parents, int(depths.max()))


def tree_errors(offsets: torch.Tensor, cols: torch.Tensor, source: int, parents: torch.Tensor,
                depths: torch.Tensor, *, block_rows: int = 1 << 24) -> int:
    """The vertices where ``parents`` breaks one of Graph500's rules
    against the reference's ``depths`` from ``source`` (see the module
    docstring)."""
    dev = offsets.device
    n = offsets.numel() - 1
    parents = parents.to(device=dev, dtype=torch.int64)
    if parents.numel() != n:
        return n
    errors = int(parents[source] != source)
    reached = depths >= 0
    has = parents >= 0
    errors += int((~reached & has).sum())
    lost = reached & ~has
    lost[source] = False
    errors += int(lost.sum())
    check = reached & has
    check[source] = False
    hi_deg = int((offsets[1:] - offsets[:-1]).max()) if n else 0
    steps = max(hi_deg, 1).bit_length() + 1
    for v0 in range(0, n, block_rows):
        v = torch.nonzero(check[v0:v0 + block_rows]).flatten() + v0
        if not v.numel():
            continue
        p = parents[v]
        bad = p >= n
        p = p.clamp(max=n - 1)
        bad |= depths[p].long() != depths[v].long() - 1
        # lower bound of p in v's sorted row
        lo, end = offsets[v], offsets[v + 1]
        hi = end.clone()
        for _ in range(steps):
            mid = (lo + hi) // 2
            active = lo < hi
            less = cols[mid.clamp(max=max(cols.numel() - 1, 0))].long() < p
            lo, hi = torch.where(active & less, mid + 1, lo), torch.where(active & ~less, mid, hi)
        found = lo < end
        found &= cols[lo.clamp(max=max(cols.numel() - 1, 0))].long() == p
        bad |= ~found
        errors += int(bad.sum())
    return errors
