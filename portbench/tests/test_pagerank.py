"""The PageRank cell's own pieces: the Kronecker generator held to the
port's (whose tests check its hash rule and GAP's squish), the pull's work
counts by hand, the reference copy
held to the port's, its row blocks, and the pull's metric readers on a
synthetic trace."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from portbench import reference_pagerank as ref
from portbench.generators import load
from portbench.harness import Run
from portbench.pagerank_work import pull_work
from portbench.tracing import Trace

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
KRON = dict(edgefactor=16, a=0.57, b=0.19, c=0.19)


@pytest.mark.parametrize("scale,seed", [(8, 0), (8, 2**33 + 9), (5, 7), (11, 3)])
def test_generator_equals_port(scale, seed):
    """``generators/kron.py`` is the port's ``bench/kron.py``, array for
    array (the port's tests hold that one to a plain numpy rendering of
    the hash rule)."""
    from sparse_matrix_tpu_torch.bench.kron import kronecker

    g = load("kron").make(np.random.default_rng(seed), scale=scale, **KRON)
    theirs = kronecker(np.random.default_rng(seed), scale=scale, device="cpu", **KRON)
    assert (g.rows, g.cols) == (theirs.rows, theirs.cols)
    for f in ("offsets", "indices", "vals"):
        np.testing.assert_array_equal(getattr(g, f), getattr(theirs, f))
        assert getattr(g, f).dtype == getattr(theirs, f).dtype
    assert g.indices.dtype == np.uint32 and g.offsets.dtype == np.int64
    assert g.vals.dtype == np.float32 and np.all(g.vals == 1)


def test_pull_work_by_hand():
    """1,000 vertices, 5,000 entries: 2-byte columns and row pointers
    (5,001 <= 65,536), no values, 4-byte contributions read and sums
    written; one add an entry. Scale 25: 4-byte columns and pointers."""
    assert pull_work(1000, 5000) == (5000 * 2 + 1001 * 2 + 8 * 1000, 5000.0)
    n, nnz = 1 << 25, 1_040_000_000
    assert pull_work(n, nnz) == (4 * nnz + 4 * (n + 1) + 8 * n, float(nnz))


def test_reference_copy_equals_the_port_reference():
    """``reference_pagerank.py`` is the port's ``reference/pagerank.py``,
    byte for byte."""
    ours = (BENCH_DIR / "reference_pagerank.py").read_bytes()
    theirs = (ROOT / "sparse_matrix_tpu_torch" / "reference" / "pagerank.py").read_bytes()
    assert ours == theirs


@pytest.mark.parametrize("block", [1, 7, 1000, 1 << 26])
def test_row_blocks_partition_the_graph(block):
    g = load("kron").make(np.random.default_rng(4), scale=9, **KRON)
    offsets = torch.from_numpy(g.offsets)
    blocks = ref.row_blocks(offsets, block)
    assert blocks[0][0] == 0 and blocks[-1][1] == g.rows
    assert all(b[1] == c[0] for b, c in zip(blocks, blocks[1:]))
    assert all(int(offsets[r0]) == e0 and int(offsets[r1]) == e1 for r0, r1, e0, e1 in blocks)
    contrib = torch.rand(g.rows, dtype=torch.float64)
    want = torch.zeros(g.rows, dtype=torch.float64).index_add_(
        0, torch.from_numpy(g.row_ids()), contrib[torch.from_numpy(g.indices.astype(np.int64))])
    got = ref.pull(offsets, torch.from_numpy(g.indices.view(np.int32)), contrib, blocks)
    assert torch.allclose(got, want, rtol=1e-12, atol=0)


def test_pull_readers_on_a_synthetic_trace():
    """Two pulls of 1.5 ms inside ``portbench.matvec`` over two requests:
    ``pull_ms.pagerank`` 1.5 ms a ranking, and ``spmv_roofline.solve``,
    from the traffic's work (a pull's least work under the matvec's keys),
    the least time of two pulls over 3 ms."""
    from portbench.harness import Bench
    from portbench.roofline import bound_s
    from portbench.traffic.pagerank import Traffic

    ev = [{"ph": "X", "cat": "user_annotation", "name": "portbench.window", "ts": 0, "dur": 10000},
          {"ph": "X", "cat": "user_annotation", "name": "portbench.matvec", "ts": 100, "dur": 10},
          {"ph": "X", "cat": "user_annotation", "name": "portbench.matvec", "ts": 3000, "dur": 10},
          {"ph": "X", "cat": "cuda_runtime", "name": "launch", "ts": 105, "dur": 1,
           "args": {"correlation": 1}},
          {"ph": "X", "cat": "cuda_runtime", "name": "launch", "ts": 3005, "dur": 1,
           "args": {"correlation": 2}},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 200, "dur": 1500,
           "args": {"correlation": 1}},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 3100, "dur": 1500,
           "args": {"correlation": 2}}]
    g = load("kron").make(np.random.default_rng(6), scale=9, **KRON)
    traffic = Traffic(SimpleNamespace(matrix=g, params={}))
    run = Run()
    run.trace, run.trace_requests = Trace(ev), 2
    run.work = traffic.work()
    nbytes, flops = pull_work(g.rows, g.nnz())
    assert run.work == {"matvec_bytes": nbytes, "matvec_flops": flops}
    bench = Bench(ROOT)
    assert bench.reader("pull_ms.pagerank").read(run) == pytest.approx(1.5)
    assert bench.reader("spmv_roofline.solve").read(run) == pytest.approx(
        100 * 2 * bound_s(nbytes, flops) / 3e-3)
    run.work = {}
    assert bench.reader("spmv_roofline.solve").read(run) is None
