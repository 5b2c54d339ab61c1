"""The fused triangular sweeps in their kernel's schedule
(sparse_matrix_tpu_torch/ops/trisweep.py ``_trisweep_chunks_torch``,
``plan_trisweep``, ``trisweep_chunk_rows``).

The trisweep kernel (csrc/trisweep.cu) gives each chunk of T rows one
thread block for every level and hands the ``min(w, T)`` rows a
neighbour reads (w = max |offset|) over through per-(chunk, level) slots,
chunks taken in ticket order. ``_trisweep_chunks_torch`` runs that schedule
on the CPU, reading a neighbour's rows only from its published slots (a
read of an unpublished row raises). These tests hold it to the plain
version ``_trisweep_torch`` bit for bit on L and L^T of a Poisson IC(0)
factor and on L and U of a fem-like ILU(0) factor, with T below, equal to
and above w and rows not a multiple of T, at 0, 1, 4 and 7 sweeps and at
depth - 1 (the exact solve), and at one row a chunk and one chunk for all
rows, and pin the planner's refusal of offsets of both signs (N is the
strict part of a triangular factor) and its chunk sizes. Inputs are made
with numpy from fixed seeds.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparse_matrix_tpu_torch.bench import corpus  # noqa: E402
from sparse_matrix_tpu_torch.formats.csr import CsrMatrix  # noqa: E402
from sparse_matrix_tpu_torch.formats.dia import DiaMatrix  # noqa: E402
from sparse_matrix_tpu_torch.ops import trisweep as tw  # noqa: E402
from sparse_matrix_tpu_torch.solvers import ilu  # noqa: E402
from sparse_matrix_tpu_torch.solvers.poisson import poisson_2d_csr  # noqa: E402


def _f32(m):
    return CsrMatrix(m.rows, m.cols, m.vals.astype(np.float32), m.indices, m.offsets,
                     is_sorted=m.is_sorted)


@functools.lru_cache(maxsize=None)
def _factor(case):
    """L or L^T of Poisson 20^2's IC(0) (400 rows, reach 20), or L or U of
    the ILU(0) of a dominant fem-like matrix (144 rows, reach 15)."""
    if case.startswith("poisson"):
        lc = ilu.ic0(poisson_2d_csr(20, dtype=np.float32))
        return lc if case == "poisson_L" else lc.transpose()
    f = ilu.ilu0(corpus.with_dominant_diagonal(
        _f32(corpus.fem_like(np.random.default_rng(16), 12, 2))))
    return f.l if case == "fem_L" else f.u


def _depth(t) -> int:
    """The levels of the triangular factor's dependency graph: depth - 1
    sweeps are the exact solve."""
    lower = bool(np.all(t.indices.astype(np.int64) <= t.row_ids()))
    level = np.zeros(t.rows, np.int64)
    order = range(t.rows) if lower else range(t.rows - 1, -1, -1)
    for i in order:
        cols = t.indices[t.offsets[i]:t.offsets[i + 1]].astype(np.int64)
        dep = cols[cols < i] if lower else cols[cols > i]
        level[i] = 1 + (int(level[dep].max()) if dep.size else 0)
    return int(level.max())


def _inputs(case):
    t = _factor(case)
    sj = ilu.TriangularJacobi(t, device="cpu", fused=True)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(t.rows).astype(np.float32))
    return t, sj._fused, b, sj.dinv


@pytest.mark.parametrize("sweeps", [0, 1, 4, 7, "depth-1"])
@pytest.mark.parametrize("chunk", ["below", "equal", "above"])
@pytest.mark.parametrize("case", ["poisson_L", "poisson_LT", "fem_L", "fem_U"])
def test_chunk_schedule_equals_plain_bitwise(case, chunk, sweeps):
    t, plan, b, dinv = _inputs(case)
    reach = max(abs(o) for o in plan.offsets)
    assert reach == (20 if case.startswith("poisson") else 15)
    chunk_rows = {"below": reach // 2 + 3, "equal": reach, "above": 3 * reach + 5}[chunk]
    if chunk != "equal":
        assert plan.rows % chunk_rows
    s = _depth(t) - 1 if sweeps == "depth-1" else sweeps
    got = tw._trisweep_chunks_torch(plan, b, dinv, s, chunk_rows)
    want = tw._trisweep_torch(plan.data, b, dinv, offsets=plan.offsets, rows=plan.rows, sweeps=s)
    assert torch.equal(got, want)
    if sweeps == "depth-1":
        lower = case in ("poisson_L", "fem_L")
        np.testing.assert_allclose(got.numpy(), ilu.trisolve_host(t, b.double().numpy(),
                                                                  lower=lower),
                                   rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("chunk_rows", [1, 2, 10_000])
@pytest.mark.parametrize("case", ["poisson_LT", "fem_L"])
def test_chunk_schedule_at_extreme_chunk_sizes(case, chunk_rows):
    """One row a chunk (every neighbour row from a slot, up to the reach's
    chunks back) and one chunk for all rows (no slot at all)."""
    _, plan, b, dinv = _inputs(case)
    got = tw._trisweep_chunks_torch(plan, b, dinv, 5, chunk_rows)
    assert torch.equal(got, tw._trisweep_torch(plan.data, b, dinv, offsets=plan.offsets,
                                               rows=plan.rows, sweeps=5))


@pytest.mark.parametrize("offsets", [(-3, 2), (-1, 1), (5, -128)])
def test_plan_trisweep_refuses_mixed_signs(offsets):
    rows = 512
    d = DiaMatrix(rows, rows, np.ones((len(offsets), rows), np.float32), offsets)
    assert tw.plan_trisweep(d, rows, device="cpu") is None
    with pytest.raises(ValueError, match="one sign"):
        tw.TrisweepPlan(offsets, np.ones((len(offsets), rows), np.float32), rows, device="cpu")


@pytest.mark.parametrize("nb, rows, reach, want", [
    (2, 4_194_304, 2048, 4096), (10, 262_144, 515, 1024), (2, 4096, 64, 4096),
    (2, 600, 24, 1024), (0, 300, 0, 512), (3, 2_097_152, 16384, 4096),
    (900, 10_000, 1, None)])
def test_chunk_rows_fit_two_blocks_an_sm(nb, rows, reach, want):
    """The default chunk: the largest power of two whose offsets, planes,
    b, dinv, two levels and staged neighbour rows (the reach, up to 8192)
    fit 113 KB of shared memory (two blocks an H100 SM), at most the rows
    rounded up to a power of two; None (no plan) when 32 rows do not
    fit."""
    halo = tw.trisweep_halo((-reach,) if reach else ())
    assert halo == (reach if reach <= tw.TRISWEEP_MAX_HALO else 0)
    got = tw.trisweep_chunk_rows(nb, rows, halo)
    assert got == want
    if got is not None:
        assert tw.trisweep_smem_bytes(nb, got, halo) <= tw.TRISWEEP_SMEM_BYTES
        assert 2 * (tw.trisweep_smem_bytes(nb, got, halo) + 1024) <= 228 * 1024
