"""Direction-optimizing breadth-first search: GAP's ``bfs`` kernel (the GAP
Benchmark Suite, Beamer, Asanovic, Patterson, arXiv:1508.03619; gapbs
``src/bfs.cc``, ``DOBFS``), Beamer's top-down and bottom-up steps, on the
card.

``plan = BfsPlan(csr, device=...)`` puts the pattern of an undirected
graph on the device once (int64 offsets, the uint32 columns as int32 bits;
no values) with the search's state; ``bfs(plan, source)`` runs one search
and returns a fresh ``parents`` (int32: the source its own parent, -1
where unreached), ``levels``, the deepest level reached, and
``bottom_up_levels``, the steps run bottom-up.

GAP's heuristic, on the host between the steps (``alpha`` 15, ``beta``
18): the search starts top-down with ``edges_to_check`` = nnz and
``scout_count`` = deg(source). Before each top-down step it switches to
bottom-up where ``scout_count > edges_to_check // alpha``; a top-down step
takes its ``scout_count`` from ``edges_to_check`` and returns the degree
sum of the vertices it found as the next. It stays bottom-up while the
frontier grows or is larger than ``n // beta``, then goes back to top-down
with ``scout_count`` 1. The frontier is a queue in the top-down steps and a
bitmap in the bottom-up ones, converted at each switch. The two numbers
each step hands the host (the vertices found and, top-down, their degree
sum) are reduced on the device and read once a step.

Parents. A top-down step gives a found vertex the smallest of its frontier
neighbours (an integer minimum on its parent, whatever the order of the
claims: within a search an unvisited vertex with an edge has the parent
``NONE``, and the search's end writes -1 where one is left); a bottom-up
step the first in column order, which is the smallest, since a row's
columns are sorted. So the parents are the same whichever direction a
step takes, and two calls give equal parents.

Only symmetric patterns: a bottom-up step reads a vertex's row as its
in-neighbours, which holds for an undirected graph (GAP's ``kron``) and is
not checked here; a directed graph would need the transposed pattern.
Rows must be sorted (``csr.is_sorted``).

On CUDA the steps are the kernels of ``csrc/bfs.cu`` (``native.kernels.
PreparedBfs``; ``launch_counts["bfs_top_down"]``, ``["bfs_bottom_up"]``);
on the CPU the plain PyTorch functions below, the same steps on the same
state (bitmaps as bool tensors), with the same parents. On either
device a top-down step first scans the frontier's degrees into their
inclusive sums (``torch.cumsum``). Spans
(``utils/profiling.py``, off by default): ``spmx.plan.bfs`` around the
plan, ``spmx.bfs`` around a search, ``spmx.bfs.top_down`` and
``spmx.bfs.bottom_up`` around each step, ``spmx.bfs.sync`` around each
step's host read.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import require_device
from ..formats.csr import CsrMatrix
from ..utils.profiling import span

__all__ = ["BfsPlan", "BfsResult", "bfs", "ALPHA", "BETA"]

#: GAP's switch to bottom-up (``scout_count > edges_to_check / alpha``)
ALPHA = 15
#: GAP's switch back to top-down (a shrinking frontier of ``<= n / beta``)
BETA = 18
#: the parent of an unvisited vertex with an edge within a search: no claim
NONE = 2 ** 31 - 1


class BfsResult(NamedTuple):
    parents: torch.Tensor
    levels: int
    bottom_up_levels: int


def _bitmap_words(mask: torch.Tensor) -> torch.Tensor:
    """The bool ``mask`` packed into int32 words, bit ``v & 31`` of word
    ``v >> 5``."""
    words = -(-mask.numel() // 32)
    padded = torch.zeros(words * 32, dtype=torch.int64, device=mask.device)
    padded[:mask.numel()] = mask
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    packed = (padded.view(words, 32) << shifts).sum(1)
    return torch.where(packed >= 1 << 31, packed - (1 << 32), packed).to(torch.int32)


class BfsPlan:
    """An undirected graph's pattern on ``device`` and the state of a search
    over it (see the module docstring)."""

    def __init__(self, csr: CsrMatrix, *, device):
        with span("spmx.plan.bfs"):
            self.device = require_device(device)
            n = csr.rows
            if csr.cols != n:
                raise ValueError(f"bfs: a graph's adjacency is square, not {n} x {csr.cols}")
            if not 1 <= n < 1 << 31:
                raise ValueError(f"bfs: {n} vertices; the search takes 1 to 2**31 - 1")
            if not csr.is_sorted:
                raise ValueError("bfs: the rows' columns must be sorted")
            self.rows, self.nnz = n, csr.nnz()
            self._host_offsets = csr.offsets
            dev = self.device
            self.offsets = torch.from_numpy(np.ascontiguousarray(csr.offsets)).to(dev)
            self.cols = torch.from_numpy(np.ascontiguousarray(csr.indices).view(np.int32)).to(dev)
            has_edges = torch.diff(self.offsets) > 0
            self.queues = torch.empty((2, n), dtype=torch.int32, device=dev)
            self.prefix = torch.empty(n, dtype=torch.int64, device=dev)
            self.counts = torch.zeros(2, dtype=torch.int64, device=dev)
            self.launch = None
            if dev.type == "cuda":
                from ..native.kernels import prepare_bfs

                self.has_edges = _bitmap_words(has_edges)
                self.unvisited = torch.empty_like(self.has_edges)
                self.bits = torch.zeros((2, self.has_edges.numel()), dtype=torch.int32,
                                        device=dev)
                self.launch = prepare_bfs(self.offsets, self.cols, self.has_edges,
                                          self.unvisited, self.bits, self.queues, self.prefix,
                                          self.counts)
            else:
                self.has_edges = has_edges
                self.unvisited = torch.empty_like(has_edges)
                self.bits = torch.zeros((2, n), dtype=torch.bool, device=dev)

    def degree(self, v: int) -> int:
        return int(self._host_offsets[v + 1] - self._host_offsets[v])

    # -- the steps: the kernels on CUDA, the plain functions on the CPU ------

    def _start(self, parents, source: int) -> None:
        if self.launch is not None:
            self.launch.start(parents, source)
        else:
            _start_torch(self, parents, source)

    def _top_down(self, parents, cur: int, q: int) -> None:
        self.prefix[:q].cumsum_(0)  # the frontier's degrees into their inclusive sums
        if self.launch is not None:
            self.launch.top_down(parents, cur, q)
        else:
            _top_down_torch(self, parents, cur, q)

    def _enter_bitmap(self, cur: int, q: int, flip: int) -> None:
        if self.launch is not None:
            self.launch.enter_bitmap(cur, q, flip)
        else:
            _enter_bitmap_torch(self, cur, q, flip)

    def _bottom_up(self, parents, flip: int) -> None:
        if self.launch is not None:
            self.launch.bottom_up(parents, flip)
        else:
            _bottom_up_torch(self, parents, flip)

    def _leave_bitmap(self, flip: int, cur: int) -> None:
        if self.launch is not None:
            self.launch.leave_bitmap(flip, cur)
        else:
            _leave_bitmap_torch(self, flip, cur)

    def _end(self, parents) -> None:
        if self.launch is not None:
            self.launch.end(parents)
        else:
            _end_torch(self, parents)

    def _read(self):
        """The step's two counts, read by the host."""
        with span("spmx.bfs.sync"):
            return self.counts.tolist()


def bfs(plan: BfsPlan, source: int, *, alpha: int = ALPHA, beta: int = BETA) -> BfsResult:
    """GAP's direction-optimizing BFS from ``source`` over ``plan``'s graph
    (see the module docstring)."""
    source = int(source)
    n = plan.rows
    if not 0 <= source < n:
        raise ValueError(f"bfs: source {source} outside [0, {n})")
    with span("spmx.bfs"):
        parents = torch.empty(n, dtype=torch.int32, device=plan.device)
        plan._start(parents, source)
        cur = flip = 0
        q = 1
        edges_to_check = plan.nnz
        scout = plan.degree(source)
        levels = bottom_up = 0
        while q:
            if scout > edges_to_check // alpha:
                plan._enter_bitmap(cur, q, flip)
                awake = q
                while True:
                    old = awake
                    with span("spmx.bfs.bottom_up"):
                        plan._bottom_up(parents, flip)
                        awake = plan._read()[0]
                    flip ^= 1
                    bottom_up += 1
                    levels += awake > 0
                    if not (awake >= old or awake > n // beta):
                        break
                if awake:
                    plan._leave_bitmap(flip, cur)
                q, scout = awake, 1
            else:
                edges_to_check -= scout
                with span("spmx.bfs.top_down"):
                    plan._top_down(parents, cur, q)
                    q, scout = plan._read()
                cur ^= 1
                levels += q > 0
        plan._end(parents)
        return BfsResult(parents, levels, bottom_up)


# -- the plain PyTorch steps (CPU tensors), the kernels' state and results --


def _degrees(plan: BfsPlan, v: torch.Tensor) -> torch.Tensor:
    return plan.offsets[v + 1] - plan.offsets[v]


def _rows(plan: BfsPlan, v: torch.Tensor, deg: torch.Tensor):
    """``(slot, pos)`` of every entry of the rows of ``v``: its index in
    ``v`` and its position in ``cols``, row after row in column order."""
    total = int(deg.sum())
    slot = torch.repeat_interleave(torch.arange(v.numel(), device=v.device), deg,
                                   output_size=total)
    start = plan.offsets[v] - (torch.cumsum(deg, 0) - deg)
    return slot, start[slot] + torch.arange(total, device=v.device)


def _start_torch(plan: BfsPlan, parents, source: int) -> None:
    parents.copy_(torch.where(plan.has_edges, NONE, -1))
    parents[source] = source
    plan.unvisited.copy_(plan.has_edges)
    plan.unvisited[source] = False
    plan.queues[0, 0] = source
    plan.prefix[0] = plan.degree(source)


def _frontier_entries_torch(plan: BfsPlan, cur: int, q: int):
    """``(u, v)`` of every entry of the frontier's rows: the frontier
    vertex and its neighbour."""
    queue = plan.queues[cur, :q].long()
    ends = plan.prefix[:q]
    deg = torch.diff(ends, prepend=ends.new_zeros(1))
    slot, pos = _rows(plan, queue, deg)
    return queue[slot], plan.cols[pos].long()


def _top_down_torch(plan: BfsPlan, parents, cur: int, q: int) -> None:
    """The top-down step (``prefix[:q]`` holds the inclusive sums of the
    frontier's degrees): each unvisited neighbour claimed on its parent by
    its smallest frontier vertex, the found vertices queued (in increasing
    order)."""
    u, v = _frontier_entries_torch(plan, cur, q)
    keep = plan.unvisited[v]
    u, v = u[keep], v[keep]
    parents.scatter_reduce_(0, v, u.to(torch.int32), "amin")
    found = torch.unique(v)
    k = found.numel()
    plan.queues[cur ^ 1, :k] = found.to(torch.int32)
    plan.unvisited[found] = False
    deg = _degrees(plan, found)
    plan.prefix[:k] = deg
    plan.counts[0], plan.counts[1] = k, int(deg.sum())


def _enter_bitmap_torch(plan: BfsPlan, cur: int, q: int, flip: int) -> None:
    front = plan.bits[flip]
    front.zero_()
    front[plan.queues[cur, :q].long()] = True


def _bottom_up_torch(plan: BfsPlan, parents, flip: int) -> None:
    """The bottom-up step: each unvisited vertex takes the first neighbour
    in column order (the smallest) that is in the frontier."""
    front, nxt = plan.bits[flip], plan.bits[flip ^ 1]
    live = torch.nonzero(plan.unvisited).flatten()
    slot, pos = _rows(plan, live, _degrees(plan, live))
    c = plan.cols[pos].long()
    hit = front[c]
    best = torch.full((live.numel(),), NONE, dtype=torch.int64, device=live.device)
    best.scatter_reduce_(0, slot[hit], c[hit], "amin")
    got = best < NONE
    found = live[got]
    parents[found] = best[got].to(torch.int32)
    plan.unvisited[found] = False
    nxt.zero_()
    nxt[found] = True
    plan.counts[0], plan.counts[1] = found.numel(), 0


def _end_torch(plan: BfsPlan, parents) -> None:
    parents[plan.unvisited] = -1


def _leave_bitmap_torch(plan: BfsPlan, flip: int, cur: int) -> None:
    found = torch.nonzero(plan.bits[flip]).flatten()
    k = found.numel()
    plan.queues[cur, :k] = found.to(torch.int32)
    plan.prefix[:k] = _degrees(plan, found)
    plan.counts[0], plan.counts[1] = k, 0
