"""Row-block segments of the aligned and LanePack plans
(sparse_matrix_tpu_torch/ops/spmv.py: ``chunk_segments``, the
``segments``/``rb_seg`` device arrays, ``_segments_torch``).

The CUDA kernels give each row block one writer by walking the plan's
chunks as segments. These tests hold the segments to their contract on
small plans of each shape the main path runs (Poisson aligned; femlike and
randlocal LanePack, dense and per_rb; randlocal aligned with its LanePack
spill; power-law LanePack at kw 16), for segment lengths that do and do
not cut row blocks:

* every real chunk lies in exactly one segment, in plan order; a segment
  covers one row block and at most G chunks; every row block has a
  segment, an empty one where it has no chunk;
* slab padding: one padding chunk stands for all (row block 0, and only
  when row block 0 is live), the rest are left out;
* the segment evaluation equals ``_aligned_torch`` / ``_lanepack_torch``
  and the JAX package's ``spmv_aligned`` / ``spmv_lanepack`` on the CPU
  within ``spmv_f64_bound`` (the C8 form wherever a LanePack chunk takes
  part), and gives the plain version's NaN/inf rows for a non-finite x.

Inputs are made with numpy from fixed seeds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sparse_matrix_tpu.formats import aligned as ref_aligned  # noqa: E402
from sparse_matrix_tpu.formats import csr as ref_csr  # noqa: E402
from sparse_matrix_tpu.formats import lanepack as ref_lanepack  # noqa: E402
from sparse_matrix_tpu.ops import spmv as ref  # noqa: E402
from sparse_matrix_tpu_torch.bench import corpus  # noqa: E402
from sparse_matrix_tpu_torch.formats.aligned import plan_aligned  # noqa: E402
from sparse_matrix_tpu_torch.formats.csr import CsrMatrix  # noqa: E402
from sparse_matrix_tpu_torch.formats.lanepack import plan_lanepack  # noqa: E402
from sparse_matrix_tpu_torch.ops import spmv  # noqa: E402
from sparse_matrix_tpu_torch.solvers.poisson import poisson_2d_csr  # noqa: E402


def _ref(m):
    return ref_csr.CsrMatrix(m.rows, m.cols, m.vals, m.indices, m.offsets,
                             is_sorted=m.is_sorted)


def _f32(m):
    return CsrMatrix(m.rows, m.cols, m.vals.astype(np.float32), m.indices, m.offsets,
                     is_sorted=m.is_sorted)


# (name, matrix, planner kind, LanePack pack or None, kw or None)
SHAPES = {
    "poisson_aligned": (lambda: poisson_2d_csr(48, dtype=np.float32), "aligned", None, None),
    "femlike_dense": (lambda: _f32(corpus.fem_like(np.random.default_rng(1), 48, 2)),
                      "lanepack", "dense", None),
    "femlike_per_rb": (lambda: _f32(corpus.fem_like(np.random.default_rng(1), 48, 2)),
                       "lanepack", "per_rb", None),
    "randlocal_dense": (lambda: _f32(corpus.random_local(np.random.default_rng(2), 2048, 16, 512)),
                        "lanepack", "dense", None),
    "randlocal_per_rb": (lambda: _f32(corpus.random_local(np.random.default_rng(2), 2048, 16, 512)),
                         "lanepack", "per_rb", None),
    "randlocal_aligned_spill": (
        lambda: _f32(corpus.random_local(np.random.default_rng(2), 4096, 16, 1024)),
        "aligned", None, None),
    "powerlaw_kw16": (lambda: _f32(corpus.power_law_rows(np.random.default_rng(3), 4096, 16)),
                      "lanepack", "dense", 16),
}


def _plan(name):
    make, kind, pack, kw = SHAPES[name]
    m = make()
    if kind == "aligned":
        plan = plan_aligned(m)
        assert (plan.spill is not None) == name.endswith("spill")
    else:
        plan = plan_lanepack(m, pack=pack, kw=kw)
        assert plan.pack == pack and (kw is None or plan.kw == kw)
    return m, kind, plan


def _device_arrays_of(kind):
    return spmv.aligned_device_arrays if kind == "aligned" else spmv.lanepack_device_arrays


def _slot_arrays(kind, plan):
    chunks = plan.num_slabs * 8
    arrays = [plan.vals, plan.lane] + ([plan.ends, plan.starts] if kind == "lanepack" else [])
    return [a.reshape(chunks, 128) for a in arrays]


def _padding(kind, plan):
    """Per chunk: True for a slab padding chunk (row block 0, window 0,
    every slot array zero)."""
    chunks = plan.num_slabs * 8
    pad = (plan.chunk_rb[:chunks] == 0) & (plan.col_off[:chunks] == 0)
    for a in _slot_arrays(kind, plan):
        pad &= ~np.any(a != 0, axis=1)
    return pad


def _check_segments(kind, plan, arrs, g):
    seg = arrs["segments"].numpy()
    rb_seg = arrs["rb_seg"].numpy()
    chunks = plan.num_slabs * 8
    r128 = plan.r128
    assert seg.dtype == np.int32 and rb_seg.dtype == np.int32
    assert seg.ndim == 2 and seg.shape[1] == 4 and rb_seg.shape == (r128 + 1,)
    rb, first, count, slot = seg.T.astype(np.int64)
    # sorted by row block; rb_seg gives each row block's first segment and count
    assert np.all(np.diff(rb) >= 0)
    assert rb_seg[0] == 0 and rb_seg[-1] == seg.shape[0]
    nseg = np.diff(rb_seg)
    assert np.all(nseg >= 1)
    assert np.array_equal(rb, np.repeat(np.arange(r128), nseg))
    # at most g chunks, one row block each; an empty segment only alone
    assert np.all((count >= 0) & (count <= g))
    assert np.all((count > 0) | (nseg[rb] == 1))
    covered = np.concatenate([np.arange(f, f + c) for f, c in zip(first, count)] or [[]])
    covered = covered.astype(np.int64)
    assert np.all(plan.chunk_rb[covered] == np.repeat(rb, count))
    # every chunk at most once, in plan order within its row block
    assert np.unique(covered).size == covered.size
    for r in range(r128):
        mine = covered[np.repeat(rb, count) == r]
        assert np.all(np.diff(mine) > 0)
    # every real chunk exactly once; padding: one stands for all, where row block 0 is live
    pad = _padding(kind, plan)
    real = np.nonzero(~pad)[0]
    assert np.array_equal(np.setdiff1d(covered, np.nonzero(pad)[0]), real)
    kept_pad = np.intersect1d(covered, np.nonzero(pad)[0])
    want = 1 if pad.any() and plan.rb_mask[0] > 0 else 0
    assert kept_pad.size == want
    assert covered.size == real.size + want
    assert chunks == 0 or covered.max() < chunks
    # scratch slots: -1 for a sole segment, else numbered in segment order
    multi = nseg[rb] > 1
    assert np.all(slot[~multi] == -1)
    assert np.array_equal(slot[multi], np.arange(int(multi.sum())))
    assert arrs["seg_slots"] == int(multi.sum())


def _evaluations(kind, plan, arrs, x):
    """(segment evaluation, plain version) of the whole plan, spill included."""
    if kind == "aligned":
        y_seg = spmv._segments_torch("aligned", arrs, x, rows=plan.rows, cols=plan.cols)
        y_plain = spmv._aligned_torch(arrs, x, rows=plan.rows, cols=plan.cols)
        if plan.spill is not None:
            sp = arrs["spill"]
            y_seg = y_seg + spmv._segments_torch("lanepack", sp, x, rows=plan.rows,
                                                 cols=plan.cols, kw=plan.spill.kw)
            y_plain = y_plain + spmv._lanepack_torch(sp, x, rows=plan.rows, cols=plan.cols,
                                                     kw=plan.spill.kw)
        return y_seg, y_plain
    return (spmv._segments_torch("lanepack", arrs, x, rows=plan.rows, cols=plan.cols,
                                 kw=plan.kw),
            spmv._lanepack_torch(arrs, x, rows=plan.rows, cols=plan.cols, kw=plan.kw))


def _scanned(kind, plan):
    if kind == "lanepack":
        return (plan,)
    return () if plan.spill is None else (plan.spill,)


@pytest.mark.parametrize("g", [1, 3, spmv.SEGMENT_CHUNKS])
@pytest.mark.parametrize("name", list(SHAPES))
def test_segments_cover_the_plan(name, g, monkeypatch):
    monkeypatch.setattr(spmv, "SEGMENT_CHUNKS", g)
    _m, kind, plan = _plan(name)
    arrs = _device_arrays_of(kind)(plan, "cpu")
    _check_segments(kind, plan, arrs, g)
    if kind == "aligned" and plan.spill is not None:
        _check_segments("lanepack", plan.spill, arrs["spill"], g)


@pytest.mark.parametrize("g", [2, spmv.SEGMENT_CHUNKS])
@pytest.mark.parametrize("name", list(SHAPES))
def test_segment_evaluation_matches_plain_and_reference(name, g, monkeypatch):
    monkeypatch.setattr(spmv, "SEGMENT_CHUNKS", g)
    m, kind, plan = _plan(name)
    arrs = _device_arrays_of(kind)(plan, "cpu")
    x_np = np.random.default_rng(5).standard_normal(m.cols).astype(np.float32)
    x = torch.from_numpy(x_np)
    y_seg, y_plain = _evaluations(kind, plan, arrs, x)
    y64, bound = spmv.spmv_f64_bound(m, x_np, lanepack=_scanned(kind, plan))
    for y in (y_seg, y_plain):
        assert y.shape == (m.rows,) and y.dtype == torch.float32
        assert np.all(np.abs(y.double().numpy() - y64) <= bound)
    # the JAX package's CPU path on its own plan of the same matrix
    if kind == "aligned":
        y_ref = ref.spmv_aligned(ref_aligned.plan_aligned(_ref(m)), jnp.asarray(x_np))
    else:
        _, _, pack, kw = SHAPES[name]
        y_ref = ref.spmv_lanepack(ref_lanepack.plan_lanepack(_ref(m), pack=pack, kw=kw),
                                  jnp.asarray(x_np))
    y_ref = np.asarray(y_ref, dtype=np.float64)
    assert np.all(np.abs(y_ref - y64) <= bound)
    assert np.all(np.abs(y_seg.double().numpy() - y_ref) <= bound)


@pytest.mark.parametrize("where", ["x0", "inner"])
@pytest.mark.parametrize("value", [np.inf, np.nan])
@pytest.mark.parametrize("name", ["poisson_aligned", "femlike_per_rb", "randlocal_aligned_spill"])
def test_segment_evaluation_nonfinite_rows(name, value, where, monkeypatch):
    """A non-finite x gives the plain version's NaN and inf rows: padding
    chunks add 0 * x[0] to row block 0, which one kept chunk reproduces."""
    monkeypatch.setattr(spmv, "SEGMENT_CHUNKS", 2)
    m, kind, plan = _plan(name)
    arrs = _device_arrays_of(kind)(plan, "cpu")
    x_np = np.random.default_rng(6).standard_normal(m.cols).astype(np.float32)
    x_np[0 if where == "x0" else m.cols // 2 + 3] = value
    y_seg, y_plain = _evaluations(kind, plan, arrs, torch.from_numpy(x_np))
    a, b = y_seg.numpy(), y_plain.numpy()
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.array_equal(np.isposinf(a), np.isposinf(b))
    assert np.array_equal(np.isneginf(a), np.isneginf(b))
    assert not np.all(np.isfinite(b))


def test_segments_of_masked_and_empty_row_blocks(monkeypatch):
    """Row blocks 0, 2 and 4 hold no entry: each gets one empty segment, and
    no padding chunk is kept (row block 0 is masked)."""
    monkeypatch.setattr(spmv, "SEGMENT_CHUNKS", 2)
    rng = np.random.default_rng(7)
    mask = rng.random((640, 512)) < 0.03
    for rb in (0, 2, 4):
        mask[rb * 128: (rb + 1) * 128] = False
    r, c = np.nonzero(mask)
    m = CsrMatrix.from_coo(640, 512, r, c, rng.standard_normal(r.size).astype(np.float32))
    for pack in ("dense", "per_rb"):
        plan = plan_lanepack(m, pack=pack)
        arrs = spmv.lanepack_device_arrays(plan, "cpu")
        _check_segments("lanepack", plan, arrs, 2)
        seg = arrs["segments"].numpy()
        assert np.all(seg[np.isin(seg[:, 0], [0, 2, 4]), 2] == 0)
        x = torch.from_numpy(rng.standard_normal(512).astype(np.float32))
        y = spmv._segments_torch("lanepack", arrs, x, rows=640, cols=512, kw=plan.kw)
        assert torch.all(y[:128] == 0) and torch.all(y[256:384] == 0) and torch.all(y[512:] == 0)


def test_segments_of_an_empty_plan():
    m = CsrMatrix.from_coo(300, 200, np.zeros(0, np.int64), np.zeros(0, np.int64),
                           np.zeros(0, np.float32))
    for kind, plan in (("lanepack", plan_lanepack(m)), ("aligned", plan_aligned(m))):
        arrs = _device_arrays_of(kind)(plan, "cpu")
        seg = arrs["segments"].numpy()
        assert seg.shape == (plan.r128, 4) and np.all(seg[:, 2] == 0)
        y = spmv._segments_torch(kind, arrs, torch.ones(200), rows=300, cols=200)
        assert y.shape == (300,) and torch.all(y == 0)


def test_chunk_segments_cuts_runs():
    """Chunks of one row block split at gaps and every g chunks; row blocks
    with no chunk get an empty segment; slots number the cut row blocks."""
    chunk_rb = np.array([0, 0, 0, 2, 2, 0, 2, 2, 2], np.int32)
    keep = np.array([1, 1, 1, 1, 1, 0, 1, 1, 1], bool)
    seg, rb_seg, slots = spmv.chunk_segments(chunk_rb, keep, 4, 2)
    assert seg.tolist() == [[0, 0, 2, 0], [0, 2, 1, 1], [1, 0, 0, -1],
                            [2, 3, 2, 2], [2, 6, 2, 3], [2, 8, 1, 4], [3, 0, 0, -1]]
    assert rb_seg.tolist() == [0, 2, 3, 6, 7] and slots == 5
    for g in (0, 33):
        with pytest.raises(ValueError, match=r"in \[1, 32\]"):
            spmv.chunk_segments(chunk_rb, keep, 4, g)
