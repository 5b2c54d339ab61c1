"""Planted faults of traffic kind ``bfs``: each takes pytest's
``monkeypatch`` and breaks the program's search under it (its plain
PyTorch steps, which the CPU runs take); the run must then fail
``CHECK``:

* the bottom-up step takes a vertex's first neighbour already visited,
  the vertices it found earlier in the same step among them, not the
  first in the frontier;
* one level fewer: the deepest level's vertices left without a parent;
* the top-down step expands only the first ``TILE_CUT`` entries of each
  frontier row (a tile that cuts the hubs, whatever the graph's size);
* the frontier bitmap never cleared before a queue is laid into it, so
  the bits of earlier steps and searches stay.
"""

from __future__ import annotations

#: the comparison each fault must push past its limit
CHECK = "tree_errors"

#: the entries of each frontier row that the cut top-down step expands
TILE_CUT = 4


def _bfs_module():
    import sparse_matrix_tpu_torch.graph.bfs as gbfs

    return gbfs


def visited_not_frontier(monkeypatch):
    import torch

    gbfs = _bfs_module()

    def step(plan, parents, flip):
        nxt = plan.bits[flip ^ 1]
        nxt.zero_()
        found = 0
        for v in torch.nonzero(plan.unvisited).flatten().tolist():
            row = plan.cols[plan.offsets[v]:plan.offsets[v + 1]].tolist()
            hit = next((c for c in row if not bool(plan.unvisited[c])), None)
            if hit is not None:
                parents[v] = hit
                plan.unvisited[v] = False
                nxt[v] = True
                found += 1
        plan.counts[0], plan.counts[1] = found, 0

    monkeypatch.setattr(gbfs, "_bottom_up_torch", step)


def one_level_fewer(monkeypatch):
    import torch

    gbfs = _bfs_module()
    orig = gbfs.bfs

    def short(plan, source, **kw):
        res = orig(plan, source, **kw)
        parents = res.parents.clone()
        depth = torch.full_like(parents, -1)
        depth[source] = 0
        for k in range(res.levels):
            hit = (depth == -1) & (parents >= 0)
            hit &= depth[parents.clamp(min=0).long()] == k
            depth[hit] = k + 1
        parents[depth == res.levels] = -1
        return gbfs.BfsResult(parents, res.levels - 1, res.bottom_up_levels)

    monkeypatch.setattr(gbfs, "bfs", short)


def hubs_cut(monkeypatch):
    import torch

    gbfs = _bfs_module()
    orig = gbfs._frontier_entries_torch

    def cut(plan, cur, q):
        u, v = orig(plan, cur, q)
        if not u.numel():
            return u, v
        head = torch.ones_like(u, dtype=torch.bool)
        head[1:] = u[1:] != u[:-1]
        at = torch.arange(u.numel())
        rank = at - torch.cummax(torch.where(head, at, 0), 0).values
        keep = rank < TILE_CUT
        return u[keep], v[keep]

    monkeypatch.setattr(gbfs, "_frontier_entries_torch", cut)


def frontier_never_cleared(monkeypatch):
    gbfs = _bfs_module()

    def enter(plan, cur, q, flip):
        plan.bits[flip][plan.queues[cur, :q].long()] = True

    monkeypatch.setattr(gbfs, "_enter_bitmap_torch", enter)


FAULTS = {"visited_not_frontier": visited_not_frontier, "one_level_fewer": one_level_fewer,
          "hubs_cut": hubs_cut, "frontier_never_cleared": frontier_never_cleared}
