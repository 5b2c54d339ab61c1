"""The BFS cell's own pieces: the reference copy held to the port's, the
least work by hand, the roots drawn from the seed, the readers on a
synthetic trace, and the pieces that must import nothing of the program."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import reference_bfs as ref
from portbench.bfs_work import bfs_bytes
from portbench.generators import load
from portbench.harness import Bench, Run
from portbench.roofline import bound_s
from portbench.tracing import Trace

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
KRON = dict(edgefactor=16, a=0.57, b=0.19, c=0.19)


def test_reference_copy_equals_the_port_reference():
    """``reference_bfs.py`` is the port's ``reference/bfs.py``, byte for
    byte."""
    ours = (BENCH_DIR / "reference_bfs.py").read_bytes()
    theirs = (ROOT / "sparse_matrix_tpu_torch" / "reference" / "bfs.py").read_bytes()
    assert ours == theirs


@pytest.mark.parametrize("name", ["reference_bfs.py", "bfs_work.py"])
def test_imports_nothing_of_the_program(name):
    from portbench.tests.test_layout import _imports

    for mod in _imports(BENCH_DIR / name):
        assert not mod.startswith("sparse_matrix_tpu"), (name, mod)


def test_bfs_bytes_by_hand():
    """A parent written and an entry read for each reached vertex but the
    root, each at the narrowest id: 2 bytes up to 65,536 vertices, 4 at
    scale 25 (17.0M reached: 136 MB, 0.041 ms at 3.35 TB/s)."""
    assert bfs_bytes(1000, 1) == 0
    assert bfs_bytes(1000, 701) == 700 * 2 * 2
    assert bfs_bytes(1 << 16, 5) == 4 * 2 * 2
    assert bfs_bytes((1 << 16) + 1, 5) == 4 * 2 * 4
    assert bfs_bytes(1 << 25, 17_000_001) == 17_000_000 * 8
    assert bound_s(bfs_bytes(1 << 25, 17_000_001), 0.0) == pytest.approx(4.06e-5, rel=1e-2)


@pytest.mark.parametrize("seed", [1, 2**31 + 77, 2**33 + 5])
def test_roots_are_seeded_and_have_edges(seed):
    from portbench.traffic.bfs import pick_roots

    g = load("kron").make(np.random.default_rng(3), scale=9, **KRON)
    deg = np.diff(g.offsets)
    roots = pick_roots(g.offsets, seed, 64)
    assert roots.shape == (64,) and np.all(deg[roots] > 0)
    assert np.array_equal(roots, pick_roots(g.offsets, seed, 64))
    assert not np.array_equal(roots, pick_roots(g.offsets, seed + 1, 64))


def _x(name, ts, dur, cat="user_annotation", **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def test_readers_on_a_synthetic_trace():
    """Two searches inside ``portbench.request``: a top-down kernel of 100
    us and a bottom-up one of 300 us each, a PyTorch kernel of 50 us; the
    directions' readers take their kernels by symbol, the roofline the
    least time of the traced roots over all the requests' device time, the
    counter the traffic's mean."""
    from portbench.traffic.bfs import Traffic

    ev = [_x("portbench.window", 0, 10000),
          _x("portbench.request", 100, 2000), _x("portbench.request", 5000, 2000)]
    kernels = [("(anonymous namespace)::spmx_bfs_td_expand(SpmxBfsPlan, int const*, long, "
                "int*)", 100), ("(anonymous namespace)::spmx_bfs_bu_step(SpmxBfsPlan, int*, "
                                "unsigned int const*, unsigned int*)", 300),
               ("void at::native::cumsum_kernel", 50)]
    corr = 0
    for t0 in (100, 5000):
        at = t0 + 10
        for name, dur in kernels:
            corr += 1
            ev += [_x("cudaLaunchKernel", at, 2, cat="cuda_runtime", correlation=corr),
                   _x(name, at + 5, dur, cat="kernel", correlation=corr)]
            at += dur + 10
    g = load("kron").make(np.random.default_rng(6), scale=9, **KRON)
    ctx = SimpleNamespace(matrix=g, seed=5, params={"roots": 4}, device=torch.device("cpu"),
                          torch=torch, workload={})
    traffic = Traffic(ctx)
    traffic._traced = [(0, 2), (1, 3)]
    run = Run()
    run.trace, run.trace_requests = Trace(ev), 2
    run.work = traffic.work()
    offsets = torch.from_numpy(g.offsets)
    cols = torch.from_numpy(g.indices.view(np.int32))
    reached = [int((ref.bfs(offsets, cols, int(r)).depths >= 0).sum()) for r in traffic.roots[:2]]
    want = sum(bfs_bytes(g.rows, k) for k in reached)
    assert run.work == {"bfs_bytes": float(want), "bottom_up_levels": 2.5}
    bench = Bench(ROOT)
    assert bench.reader("td_ms.bfs").read(run) == pytest.approx(0.1)
    assert bench.reader("bu_ms.bfs").read(run) == pytest.approx(0.3)
    assert bench.reader("bottom_up_levels.bfs").read(run) == 2.5
    assert bench.reader("bfs_roofline").read(run) == pytest.approx(
        100 * bound_s(want, 0.0) / 900e-6)
    run.work = {}
    assert bench.reader("bfs_roofline").read(run) is None
    assert bench.reader("bottom_up_levels.bfs").read(run) is None
