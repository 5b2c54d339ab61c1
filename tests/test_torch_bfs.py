"""GAP's direction-optimizing BFS (``graph/bfs.py``) on the CPU.

The port's search, through its plain PyTorch steps, against the plain
reference (``reference/bfs.py``) by Graph500's rules and against the
depths that the JAX package's ``graph/csgraph.py::breadth_first_order``
gives, on seeded Kronecker graphs (scales 8-12), a path, a star, a graph
of two components and a graph with an isolated root; each under GAP's
switch, with every step top-down, with the search bottom-up from its first
step and back to top-down once the frontier shrinks, and with every step
bottom-up. Its parents are each vertex's smallest neighbour one level up,
whichever direction a step took. The reference's validation names each
broken rule; the plan refuses what it cannot search; the spans nest.
"""

from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparse_matrix_tpu.formats.csr import CsrMatrix as RefCsr  # noqa: E402
from sparse_matrix_tpu.graph.csgraph import breadth_first_order  # noqa: E402
from sparse_matrix_tpu_torch.bench import kron  # noqa: E402
from sparse_matrix_tpu_torch.formats.csr import CsrMatrix  # noqa: E402
from sparse_matrix_tpu_torch.graph import bfs as gbfs  # noqa: E402
from sparse_matrix_tpu_torch.reference import bfs as ref  # noqa: E402

KRON = dict(edgefactor=16, a=0.57, b=0.19, c=0.19)
#: (alpha, beta): GAP's switch; every step top-down (the scout count never
#: passes the edges left); bottom-up from the first step, back to top-down
#: once the frontier shrinks; every step bottom-up
SWITCHES = {"gap": (15, 18), "top_down": (1, 18), "bottom_up_first": (10 ** 12, 1),
            "bottom_up": (10 ** 12, 10 ** 12)}


def _undirected(n, edges) -> CsrMatrix:
    """The symmetric pattern of ``edges`` (pairs), sorted rows, unit
    values, duplicates dropped."""
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    r = np.concatenate([e[:, 0], e[:, 1]])
    c = np.concatenate([e[:, 1], e[:, 0]])
    return CsrMatrix.from_coo(n, n, r, c, np.ones(r.size, dtype=np.float32))


def _graph(name: str):
    """``(graph, roots)``."""
    if name.startswith("kron"):
        scale = int(name[4:])
        g = kron.kronecker(np.random.default_rng(scale + 3), scale=scale, device="cpu", **KRON)
        deg = np.diff(g.offsets)
        roots = np.random.default_rng(scale).choice(np.flatnonzero(deg > 0), 3)
        return g, [int(r) for r in roots]
    if name == "path":
        perm = np.random.default_rng(5).permutation(60)
        return _undirected(60, np.stack([perm[:-1], perm[1:]], 1)), [int(perm[0]), int(perm[29])]
    if name == "star":
        return _undirected(41, [(7, v) for v in range(41) if v != 7]), [7, 0, 40]
    if name == "two_components":
        rng = np.random.default_rng(9)
        a = rng.integers(0, 30, size=(90, 2))
        b = rng.integers(30, 50, size=(40, 2))
        edges = np.concatenate([a, b])
        return _undirected(50, edges[edges[:, 0] != edges[:, 1]]), [0, 31]
    if name == "isolated_root":
        return _undirected(20, [(0, 1), (1, 2), (2, 3), (5, 6)]), [4, 19]
    raise KeyError(name)


GRAPHS = ["kron8", "kron10", "kron12", "path", "star", "two_components", "isolated_root"]


def _torch_graph(g):
    return torch.from_numpy(g.offsets), torch.from_numpy(g.indices.view(np.int32))


def _jax_depths(g, root: int) -> np.ndarray:
    """Depths from the JAX package's BFS order and predecessors."""
    a = RefCsr(g.rows, g.cols, g.vals, g.indices, g.offsets, is_sorted=True)
    order, pred = breadth_first_order(a, root, directed=True, return_predecessors=True)
    depth = np.full(g.rows, -1, dtype=np.int64)
    depth[order[0]] = 0
    for w in order[1:]:
        depth[w] = depth[pred[w]] + 1
    return depth


def _smallest_parents(g, root: int, depths: np.ndarray) -> np.ndarray:
    """Each reached vertex's smallest neighbour one level up (the root its
    own parent, -1 where unreached)."""
    want = np.full(g.rows, -1, dtype=np.int64)
    want[root] = root
    for v in np.flatnonzero(depths > 0):
        row = g.indices[g.offsets[v]:g.offsets[v + 1]].astype(np.int64)
        want[v] = row[depths[row] == depths[v] - 1].min()
    return want


@pytest.mark.parametrize("switch", sorted(SWITCHES))
@pytest.mark.parametrize("name", GRAPHS)
def test_bfs_holds_to_reference_and_jax_depths(name, switch):
    g, roots = _graph(name)
    alpha, beta = SWITCHES[switch]
    plan = gbfs.BfsPlan(g, device="cpu")
    offsets, cols = _torch_graph(g)
    for root in roots:
        res = gbfs.bfs(plan, root, alpha=alpha, beta=beta)
        want = ref.bfs(offsets, cols, root)
        depths = want.depths.numpy()
        np.testing.assert_array_equal(depths, _jax_depths(g, root))
        assert ref.tree_errors(offsets, cols, root, res.parents, want.depths) == 0
        assert ref.tree_errors(offsets, cols, root, want.parents, want.depths) == 0
        assert res.levels == want.levels == max(int(depths.max()), 0)
        assert res.parents.dtype == torch.int32
        np.testing.assert_array_equal(res.parents.numpy(), _smallest_parents(g, root, depths))
        if switch == "top_down" or g.offsets[root + 1] == g.offsets[root]:
            assert res.bottom_up_levels == 0
        elif switch in ("bottom_up_first", "bottom_up"):
            assert res.bottom_up_levels >= 1


def test_gap_switch_engages_on_kron():
    """At scales 10-12 GAP's heuristic runs two or three steps bottom-up
    from each root, as it does at scales 16-20."""
    for scale in (10, 12):
        g, roots = _graph(f"kron{scale}")
        plan = gbfs.BfsPlan(g, device="cpu")
        for root in roots:
            assert 2 <= gbfs.bfs(plan, root).bottom_up_levels <= 3


def test_searches_on_one_plan_do_not_interfere():
    """A plan's state carries nothing from one search to the next: each
    search equals the same search on a fresh plan."""
    g, roots = _graph("kron10")
    plan = gbfs.BfsPlan(g, device="cpu")
    got = [gbfs.bfs(plan, r) for r in roots + roots[::-1]]
    for r, res in zip(roots + roots[::-1], got):
        fresh = gbfs.bfs(gbfs.BfsPlan(g, device="cpu"), r)
        assert torch.equal(res.parents, fresh.parents)
        assert (res.levels, res.bottom_up_levels) == (fresh.levels, fresh.bottom_up_levels)


def test_reference_stopped_short_leaves_the_deepest_level():
    g, roots = _graph("kron10")
    offsets, cols = _torch_graph(g)
    full = ref.bfs(offsets, cols, roots[0])
    short = ref.bfs(offsets, cols, roots[0], max_levels=full.levels - 1)
    assert short.levels == full.levels - 1
    deepest = int((full.depths == full.levels).sum())
    assert ref.tree_errors(offsets, cols, roots[0], short.parents, full.depths) == deepest > 0


@pytest.mark.parametrize("block", [1, 3, 64, 1 << 25])
def test_reference_blocks_give_the_same_depths(block):
    g, roots = _graph("kron12")
    offsets, cols = _torch_graph(g)
    want = ref.bfs(offsets, cols, roots[0])
    got = ref.bfs(offsets, cols, roots[0], block_entries=block)
    assert torch.equal(got.depths, want.depths)
    assert ref.tree_errors(offsets, cols, roots[0], got.parents, want.depths,
                           block_rows=max(block, 7)) == 0


def _broken(rule: str, g, root, parents, depths):
    """``parents`` with one vertex breaking ``rule``."""
    p = parents.clone()
    d = depths.numpy()
    deep = int(np.flatnonzero(d == d.max())[0])

    def row(v):
        return g.indices[g.offsets[v]:g.offsets[v + 1]].astype(np.int64)

    if rule == "root_not_own_parent":
        p[root] = deep
    elif rule == "unreached_with_parent":
        p[int(np.flatnonzero(d < 0)[0])] = root
    elif rule == "reached_without_parent":
        p[deep] = -1
    elif rule == "parent_not_a_neighbour":
        p[deep] = next(int(u) for u in np.flatnonzero(d == d[deep] - 1)
                       if int(u) not in set(row(deep).tolist()))
    elif rule == "parent_at_the_same_level":
        v = next(int(v) for v in np.flatnonzero(d > 0) if (d[row(v)] == d[v]).any())
        p[v] = int(row(v)[d[row(v)] == d[v]][0])
    elif rule == "parent_out_of_range":
        p[deep] = g.rows + 5
    return p


@pytest.mark.parametrize("rule", ["root_not_own_parent", "unreached_with_parent",
                                  "reached_without_parent", "parent_not_a_neighbour",
                                  "parent_at_the_same_level", "parent_out_of_range"])
def test_tree_errors_counts_each_broken_rule(rule):
    g = kron.kronecker(np.random.default_rng(21), scale=10, device="cpu", **KRON)
    offsets, cols = _torch_graph(g)
    root = int(np.flatnonzero(np.diff(g.offsets) > 0)[0])
    want = ref.bfs(offsets, cols, root)
    d = want.depths.numpy()
    assert (d < 0).any() and d.max() >= 2
    p = _broken(rule, g, root, want.parents, want.depths)
    assert ref.tree_errors(offsets, cols, root, p, want.depths) == 1


@pytest.mark.parametrize("case", ["rectangular", "unsorted"])
def test_plan_refuses(case):
    g, _ = _graph("star")
    if case == "rectangular":
        g = CsrMatrix(g.rows, g.cols + 1, g.vals, g.indices, g.offsets, is_sorted=True)
    else:
        g = CsrMatrix(g.rows, g.cols, g.vals, g.indices, g.offsets, is_sorted=False)
    with pytest.raises(ValueError):
        gbfs.BfsPlan(g, device="cpu")


@pytest.mark.parametrize("source", [-1, 41])
def test_bfs_refuses_a_source_outside(source):
    g, _ = _graph("star")
    with pytest.raises(ValueError):
        gbfs.bfs(gbfs.BfsPlan(g, device="cpu"), source)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100])
def test_bitmap_words(n):
    mask = torch.from_numpy(np.random.default_rng(n).random(n) < 0.5)
    words = gbfs._bitmap_words(mask)
    assert words.dtype == torch.int32 and words.numel() == -(-n // 32)
    bits = (words.long().unsqueeze(1) >> torch.arange(32)) & 1
    assert torch.equal(bits.flatten()[:n].bool(), mask)
    assert not bits.flatten()[n:].any()


def test_spans_nest_and_leave_the_bits():
    from sparse_matrix_tpu_torch.utils import profiling

    g, roots = _graph("kron10")
    off = gbfs.bfs(gbfs.BfsPlan(g, device="cpu"), roots[0])
    profiling.enable()
    try:
        plan = gbfs.BfsPlan(g, device="cpu")
        on = gbfs.bfs(plan, roots[0])
        spans = profiling.take()
    finally:
        profiling.disable()
    assert torch.equal(on.parents, off.parents)
    names = [s.name for s in spans]
    assert names[0] == "spmx.plan.bfs" and spans[0].parent == -1
    top = names.index("spmx.bfs")
    assert spans[top].parent == -1
    steps = [s for s in spans if s.name in ("spmx.bfs.top_down", "spmx.bfs.bottom_up")]
    assert all(s.parent == top for s in steps)
    assert sum(s.name == "spmx.bfs.bottom_up" for s in steps) == on.bottom_up_levels
    syncs = [s for s in spans if s.name == "spmx.bfs.sync"]
    assert len(syncs) == len(steps)
    assert all(names[s.parent] in ("spmx.bfs.top_down", "spmx.bfs.bottom_up") for s in syncs)
