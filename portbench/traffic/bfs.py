"""Traffic kind ``bfs``: a caller searching one graph from one root after
another, each search waited for: Graph500's kernel 2 and GAP's ``bfs``
kernel (``bfs.cc``'s ``DOBFS``, direction-optimizing, GAP's alpha 15 and
beta 18), run on one card.

Set-up plans the program's ``BfsPlan`` of the graph's pattern (no
``force``, no values). The roots are a pool of ``roots`` vertices drawn
from the seed, uniformly over the vertices of degree >= 1, with
replacement (Graph500's 64 search keys; GAP's ``SourcePicker``). Request
``i`` is one ``bfs(plan, root)`` from pool entry ``i % roots``.

Cell parameters (``workloads/<cell>.json``, ``params``): ``roots``;
``check_samples``, ``trace_requests``, ``warm_requests``: see
``harness.py``. The control is the plain reference stopped one level
short, its deepest level left unreached.

Each sampled answer is compared with the plain reference
(``reference_bfs.py``, a level-synchronous BFS with no floats) from the
same root, held to ``limits``: ``tree_errors``, the vertices where the
answer's parents break Graph500's validation against the reference's
depths (``reference_bfs.tree_errors``: the root its own parent, a parent
for every vertex the reference reaches and for no other, each parent a
neighbour one level up); ``levels``, how far the answer's deepest level
lies from the reference's. Parents may differ from the reference's where
both are valid.
"""

from __future__ import annotations

import numpy as np

from portbench import reference_bfs as ref
from portbench.bfs_work import bfs_bytes
from portbench.traffic.solve_loop import Answer


def pick_roots(offsets: np.ndarray, seed: int, count: int) -> np.ndarray:
    """``count`` vertices drawn from ``seed``, uniformly over those of
    degree >= 1, with replacement."""
    candidates = np.flatnonzero(np.diff(offsets) > 0)
    if not candidates.size:
        raise ValueError("bfs: the graph has no edge, so no root")
    rng = np.random.default_rng([int(seed) % (1 << 64), 0xBF5])
    return candidates[rng.integers(0, candidates.size, size=int(count))]


class Traffic:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.params
        self._ranges = False
        self._traced = []  # (pool entry, bottom_up_levels) of each traced search
        self._refs = {}  # pool entry -> the reference's search
        self._graph_dev = None
        self.roots = pick_roots(ctx.matrix.offsets, ctx.seed, self.p["roots"])

    # -- set-up --------------------------------------------------------------

    def setup(self):
        import sparse_matrix_tpu_torch.graph.bfs as gbfs
        from sparse_matrix_tpu_torch.formats.csr import CsrMatrix

        ctx = self.ctx
        m = ctx.matrix
        g = CsrMatrix(m.rows, m.cols, m.vals, m.indices, m.offsets, is_sorted=True)
        self.plan = ctx.plan("bfs", lambda: gbfs.BfsPlan(g, device=ctx.device))
        self.g = gbfs

    def set_ranges(self, on: bool):
        self._ranges = bool(on)

    # -- requests ------------------------------------------------------------

    def request(self, i: int) -> Answer:
        j = i % len(self.roots)
        res = self.g.bfs(self.plan, int(self.roots[j]))
        if self._ranges:
            self._traced.append((j, res.bottom_up_levels))
        return Answer(res.parents, j, int(res.levels), False)

    def release(self):
        """Free the program's state; the sampled answers stay."""
        self.plan = self.g = None

    # -- comparison ----------------------------------------------------------

    def _graph(self):
        """The graph's offsets and columns on the device (kept for the
        references)."""
        if self._graph_dev is None:
            torch, m, dev = self.ctx.torch, self.ctx.matrix, self.ctx.device
            self._graph_dev = (torch.from_numpy(m.offsets).to(dev),
                               torch.from_numpy(np.ascontiguousarray(m.indices).view(np.int32))
                               .to(dev))
        return self._graph_dev

    def _reference(self, j: int):
        if j not in self._refs:
            offsets, cols = self._graph()
            self._refs[j] = ref.bfs(offsets, cols, int(self.roots[j]))
        return self._refs[j]

    def check(self, samples):
        """The worst of each comparison over the sampled answers, against
        the reference from the same root."""
        offsets, cols = self._graph()
        worst = {"tree_errors": 0.0, "levels": 0.0}
        for _i, ans in samples:
            want = self._reference(ans.j)
            root = int(self.roots[ans.j])
            got = {"tree_errors": float(ref.tree_errors(offsets, cols, root, ans.x, want.depths)),
                   "levels": float(abs(int(ans.iterations) - want.levels))}
            for k, v in got.items():
                worst[k] = max(worst[k], v)
        lim = self.ctx.workload["limits"]
        return {k: {"value": v, "limit": float(lim[k])} for k, v in worst.items()}

    def control(self, count: int):
        """Answers of the plain reference stopped one level before its end,
        its deepest level left unreached, put in the program's place from
        the first ``count`` roots."""
        offsets, cols = self._graph()
        out = []
        for j in range(min(count, len(self.roots))):
            full = self._reference(j)
            res = ref.bfs(offsets, cols, int(self.roots[j]), max_levels=max(full.levels - 1, 0))
            out.append((j, Answer(res.parents, j, res.levels, False)))
        return out

    def _reached(self, j: int) -> int:
        """The vertices the reference reaches from root ``j``: those of its
        component, so a root inside a component already searched takes
        that search's count."""
        root = int(self.roots[j])
        for want in self._refs.values():
            if int(want.depths[root]) >= 0:
                return int((want.depths >= 0).sum())
        return int((self._reference(j).depths >= 0).sum())

    def work(self):
        """The least bytes of the traced searches (``bfs_work.bfs_bytes``,
        from the reference's reached counts), which ``bfs_roofline``
        reads, and the program's mean ``bottom_up_levels`` over them."""
        if not self._traced:
            return {}
        n = self.ctx.matrix.rows
        return {"bfs_bytes": float(sum(bfs_bytes(n, self._reached(j)) for j, _ in self._traced)),
                "bottom_up_levels": sum(b for _, b in self._traced) / len(self._traced)}
