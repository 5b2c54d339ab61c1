"""The aligned and LanePack SpMM in their kernels' order, and the
row-major SpMM call paths (sparse_matrix_tpu_torch/ops/spmv.py
``_segments_torch`` on a (cols, K) block; ops/spmm.py
``_spmm_aligned_into``, ``spmm_aligned``, ``_lanepack_spmm_into``,
``spmm_lanepack``, ``spmm_bell``).

The LanePack SpMM kernel (csrc/spmm_lanepack.cu) gives each row block one
writer: a warp sums a segment of the row block's chunks (at most G
consecutive chunks, ``ops.spmv.chunk_segments``) for up to 8 columns, each
column with its own prefix-sum scan, and the last warp of a cut row block
adds the segments in order. ``_segments_torch`` evaluates a plan in that
order on the CPU. These tests hold it, at K in {2, 8, 16}, both packs and
kw 16, for G = 1, 2 and 32 (cut and whole row blocks), to:

* ``_lanepack_spmm_torch``, the plain counterpart of the reference's
  kernel, column by column within ``spmv_f64_bound`` in its C8 form (the
  run sums are differences of chunk prefix sums, whose rounding depends on
  the chunk's mass; the two orders add the chunks' contributions in
  different orders, so they are not bit-equal);
* the JAX package's ``spmm_lanepack_packed`` on the CPU (its Pallas kernel
  in interpret mode), within the same bound, and within ``2e-5 * max(1,
  max|Y|)`` of the port (as tests/test_torch_spmm.py);
* the plain version's zero rows on empty and masked row blocks, and its
  NaN and inf rows for a non-finite x.

The aligned SpMM kernel (csrc/spmm_aligned.cu) sums the same segments
with no scan: each product rounded, added in plan order, segments in
order. ``_segments_torch("aligned", ...)`` on the block is held, at K in
{2, 8, 16} and G in {1, 2, 32}, to ``_aligned_spmm_torch`` unpacked
(bit for bit where no row block is cut, the same additions in the same
order; else within ``spmv_f64_bound``), to the JAX package's
``spmm_aligned_packed`` (within the bound and ``2e-5 * max(1, max|Y|)``),
to zero rows on empty and masked row blocks and to the plain version's
NaN and inf entries for a non-finite X; ``_spmm_aligned_into`` and
``spmm_aligned`` must write every row in store mode and add in add mode.

The row-major paths: ``spmm_lanepack`` and ``spmm_bell`` take X (cols, K)
and give Y (rows, K) with no packing on the card; on the CPU their results
must equal the unpacked plain versions bit for bit, ``spmm_bell``'s with
and without a spill against the reference's ``spmm_bell`` as in
tests/test_torch_spmm.py. Inputs are made with numpy from fixed seeds.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sparse_matrix_tpu.formats import aligned as ref_aligned  # noqa: E402
from sparse_matrix_tpu.formats import bell as ref_bell  # noqa: E402
from sparse_matrix_tpu.formats import csr as ref_csr  # noqa: E402
from sparse_matrix_tpu.formats import lanepack as ref_lanepack  # noqa: E402
from sparse_matrix_tpu.ops import spmm as ref_spmm  # noqa: E402
from sparse_matrix_tpu_torch.bench import corpus  # noqa: E402
from sparse_matrix_tpu_torch.formats.aligned import plan_aligned  # noqa: E402
from sparse_matrix_tpu_torch.formats.bell import plan_bell  # noqa: E402
from sparse_matrix_tpu_torch.formats.csr import CsrMatrix  # noqa: E402
from sparse_matrix_tpu_torch.formats.lanepack import plan_lanepack  # noqa: E402
from sparse_matrix_tpu_torch.ops import spmm, spmv, spmv_bell  # noqa: E402
from sparse_matrix_tpu_torch.solvers.poisson import poisson_2d_csr  # noqa: E402


def _ref(m):
    return ref_csr.CsrMatrix(m.rows, m.cols, m.vals, m.indices, m.offsets,
                             is_sorted=m.is_sorted)


def _f32(m):
    return CsrMatrix(m.rows, m.cols, m.vals.astype(np.float32), m.indices, m.offsets,
                     is_sorted=m.is_sorted)


# (matrix, pack, kw or None): the main path's LanePack shapes, small
SHAPES = {
    "poisson_dense": (lambda: poisson_2d_csr(40, dtype=np.float32), "dense", None),
    "femlike_per_rb": (lambda: _f32(corpus.fem_like(np.random.default_rng(1), 32, 2)),
                       "per_rb", None),
    "randlocal_dense": (lambda: _f32(corpus.random_local(np.random.default_rng(2), 1024, 16, 256)),
                        "dense", None),
    "powerlaw_kw16": (lambda: _f32(corpus.power_law_rows(np.random.default_rng(3), 2048, 16)),
                      "dense", 16),
}


@functools.lru_cache(maxsize=None)
def _case(name):
    make, pack, kw = SHAPES[name]
    m = make()
    plan = plan_lanepack(m, pack=pack, kw=kw)
    assert plan.pack == pack and (kw is None or plan.kw == kw)
    return m, plan


def _X(seed, n, k):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference(name, k):
    """The JAX package's packed LanePack SpMM of the case, unpacked."""
    m, plan = _case(name)
    _, pack, kw = SHAPES[name]
    rp = ref_lanepack.plan_lanepack(_ref(m), pack=pack, kw=kw)
    x3 = ref_spmm.pack_rhs(jnp.asarray(_X(k, m.cols, k)), m.cols, guard=rp.kw)
    return np.asarray(ref_spmm.unpack_rhs(ref_spmm.spmm_lanepack_packed(rp, x3), m.rows),
                      dtype=np.float64)


def _plain(plan, arrs, X):
    """``_lanepack_spmm_torch`` on X (cols, K), unpacked to (rows, K)."""
    y3 = spmm._lanepack_spmm_torch(arrs, spmm.pack_rhs(X, plan.cols, guard=0), cols=plan.cols,
                                   kw=plan.kw)
    return spmm.unpack_rhs(y3, plan.rows)


def _within_bound(m, plan, X_np, Y):
    for q in range(X_np.shape[1]):
        y64, bound = spmv.spmv_f64_bound(m, X_np[:, q], lanepack=(plan,))
        err = np.abs(np.asarray(Y, np.float64)[:, q] - y64)
        assert np.all(err <= bound), (q, float(np.max(err / np.maximum(bound, 1e-300))))


@pytest.mark.parametrize("k", [2, 8, 16])
@pytest.mark.parametrize("g", [1, 2, 32])
@pytest.mark.parametrize("name", list(SHAPES))
def test_segment_order_spmm_matches_plain_and_reference(name, g, k, monkeypatch):
    monkeypatch.setattr(spmv, "SEGMENT_CHUNKS", g)
    m, plan = _case(name)
    arrs = spmv.lanepack_device_arrays(plan, "cpu")
    if g <= 2:
        assert int(arrs["segments"][:, 3].max()) >= 0  # some row block is cut
    X_np = _X(k, m.cols, k)
    X = torch.from_numpy(X_np)
    y_seg = spmv._segments_torch("lanepack", arrs, X, rows=m.rows, cols=m.cols, kw=plan.kw)
    y_plain = _plain(plan, arrs, X)
    assert y_seg.shape == (m.rows, k) and y_seg.dtype == torch.float32
    _within_bound(m, plan, X_np, y_seg)
    _within_bound(m, plan, X_np, y_plain)
    y_ref = _reference(name, k)
    _within_bound(m, plan, X_np, y_ref)
    assert np.max(np.abs(y_seg.numpy() - y_ref)) <= 2e-5 * max(1.0, float(np.max(np.abs(y_ref))))
    # column q of the block is the SpMV order on column q
    for q in (0, k - 1):
        y1 = spmv._segments_torch("lanepack", arrs, X[:, q].contiguous(), rows=m.rows,
                                  cols=m.cols, kw=plan.kw)
        assert torch.equal(y1, y_seg[:, q])


@pytest.mark.parametrize("pack", ["dense", "per_rb"])
def test_segment_order_spmm_of_masked_and_empty_row_blocks(pack, monkeypatch):
    """Row blocks 0, 2 and 4 hold no entry: their rows are zero in every
    column, as in the plain version."""
    monkeypatch.setattr(spmv, "SEGMENT_CHUNKS", 2)
    rng = np.random.default_rng(7)
    mask = rng.random((640, 512)) < 0.03
    for rb in (0, 2, 4):
        mask[rb * 128: (rb + 1) * 128] = False
    r, c = np.nonzero(mask)
    m = CsrMatrix.from_coo(640, 512, r, c, rng.standard_normal(r.size).astype(np.float32))
    plan = plan_lanepack(m, pack=pack)
    arrs = spmv.lanepack_device_arrays(plan, "cpu")
    X_np = _X(8, 512, 8)
    X = torch.from_numpy(X_np)
    y = spmv._segments_torch("lanepack", arrs, X, rows=640, cols=512, kw=plan.kw)
    for rb in (0, 2, 4):
        assert torch.all(y[rb * 128: (rb + 1) * 128] == 0)
    assert torch.equal(y == 0, _plain(plan, arrs, X) == 0)
    _within_bound(m, plan, X_np, y)


@pytest.mark.parametrize("where", ["x0", "inner"])
@pytest.mark.parametrize("value", [np.inf, np.nan])
@pytest.mark.parametrize("name", ["poisson_dense", "femlike_per_rb"])
def test_segment_order_spmm_nonfinite_rows(name, value, where, monkeypatch):
    """A non-finite X gives the plain version's NaN and inf entries, column
    by column (slab padding adds 0 * X[0, q] to row block 0)."""
    monkeypatch.setattr(spmv, "SEGMENT_CHUNKS", 2)
    m, plan = _case(name)
    arrs = spmv.lanepack_device_arrays(plan, "cpu")
    X_np = _X(11, m.cols, 4)
    X_np[0 if where == "x0" else m.cols // 2 + 3, 1] = value
    X = torch.from_numpy(X_np)
    a = spmv._segments_torch("lanepack", arrs, X, rows=m.rows, cols=m.cols, kw=plan.kw).numpy()
    b = _plain(plan, arrs, X).numpy()
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.array_equal(np.isposinf(a), np.isposinf(b))
    assert np.array_equal(np.isneginf(a), np.isneginf(b))
    assert not np.all(np.isfinite(b[:, 1])) and np.all(np.isfinite(b[:, [0, 2, 3]]))


@pytest.mark.parametrize("packed", [True, False])
def test_lanepack_spmm_into_store_and_add(packed):
    """Store mode writes every row of y (packed: zeros on the row blocks
    past r128); add mode adds the same result onto y."""
    m, plan = _case("randlocal_dense")
    arrs = spmv.lanepack_device_arrays(plan, "cpu")
    X = torch.from_numpy(_X(3, m.cols, 5))
    x = spmm.pack_rhs(X, m.cols, guard=plan.kw) if packed else X
    shape = x.shape if packed else (m.rows, 5)
    y = torch.full(shape, float("nan"))
    spmm._lanepack_spmm_into(plan, arrs, x, y, packed=packed)
    want = _plain(plan, arrs, X)
    got = spmm.unpack_rhs(y, m.rows) if packed else y
    assert torch.equal(got, want)
    if packed:
        assert int(torch.count_nonzero(y[plan.r128:])) == 0
    y0 = torch.from_numpy(np.random.default_rng(4).standard_normal(shape).astype(np.float32))
    y_add = y0.clone()
    spmm._lanepack_spmm_into(plan, arrs, x, y_add, packed=packed, add=True)
    if packed:
        assert torch.equal(y_add[: plan.r128], y0[: plan.r128] + y[: plan.r128])
        assert torch.equal(y_add[plan.r128:], y0[plan.r128:])
    else:
        assert torch.equal(y_add, y0 + y)


@pytest.mark.parametrize("k", [1, 3, 8, 20])
def test_spmm_lanepack_row_major_equals_packed(k):
    """``spmm_lanepack`` (X and Y row-major, no packing on the card) gives
    the unpacked result of ``spmm_lanepack_packed`` bit for bit."""
    m, plan = _case("femlike_per_rb")
    assert spmm.lanepack_spmm_uses_kernel(plan, k)
    X = torch.from_numpy(_X(k, m.cols, k))
    Y = spmm.spmm_lanepack(plan, X)
    assert Y.shape == (m.rows, k) and Y.is_contiguous()
    y3 = spmm.spmm_lanepack_packed(plan, spmm.pack_rhs(X, m.cols, guard=plan.kw))
    assert torch.equal(Y, spmm.unpack_rhs(y3, m.rows))


BELL_MATRICES = {
    "randlocal": lambda: corpus.random_local(np.random.default_rng(2), 512, 12, 300),
    "powerlaw_spill": lambda: corpus.power_law_rows(np.random.default_rng(0), 512, 16),
}


@pytest.mark.parametrize("k", [3, 10])
@pytest.mark.parametrize("span", [128, 256])
@pytest.mark.parametrize("name", list(BELL_MATRICES))
def test_spmm_bell_row_major_is_the_unpacked_plain_version(name, span, k):
    """``spmm_bell`` returns (rows, K): the unpacked plain version (plus
    the spill's plain version) bit for bit, and the reference's
    ``spmm_bell`` within 2e-5 * max(1, max|Y|), with and without a spill,
    at K that is not a multiple of 4."""
    m = BELL_MATRICES[name]()
    plan = plan_bell(m, span=span)
    assert (plan.spill is not None) == (name == "powerlaw_spill")
    arrs = spmv_bell.bell_device_arrays(plan, "cpu")
    X_np = _X(k + span, m.cols, k)
    X = torch.from_numpy(X_np)
    Y = spmm.spmm_bell(plan, X, device_arrays=arrs)
    y3 = spmm._bell_spmm_torch(arrs["vals"], arrs["lane"], X, ds=plan.ds, modes=plan.modes,
                               span=plan.span, cols=plan.cols)
    if plan.spill is not None:
        y3 = y3 + spmm._lanepack_spmm_torch(arrs["spill"], spmm.pack_rhs(X, m.cols),
                                            cols=m.cols, kw=plan.spill.kw)
    assert Y.shape == (m.rows, k) and torch.equal(Y, spmm.unpack_rhs(y3, m.rows))
    y_ref = np.asarray(ref_spmm.spmm_bell(ref_bell.plan_bell(_ref(m), span=span),
                                          jnp.asarray(X_np)))
    assert np.max(np.abs(Y.numpy() - y_ref)) <= 2e-5 * max(1.0, float(np.max(np.abs(y_ref))))


def test_row_major_spmm_refuses_malformed_x():
    m, plan = _case("femlike_per_rb")
    for bad, err in ((torch.zeros(m.cols + 1, 8), ValueError),
                     (torch.zeros(m.cols, 8, dtype=torch.float64), TypeError)):
        with pytest.raises(err):
            spmm.spmm_lanepack(plan, bad)
    bp = plan_bell(BELL_MATRICES["randlocal"]())
    for bad, err in ((torch.zeros(bp.cols - 1, 8), ValueError),
                     (torch.zeros(bp.cols, 8, dtype=torch.float64), TypeError)):
        with pytest.raises(err):
            spmm.spmm_bell(bp, bad)


# (matrix): aligned shapes with no spill, small
ALIGNED = {
    "poisson": lambda: poisson_2d_csr(40, dtype=np.float32),
    "banded_rect": lambda: _banded(900, 700, (-300, -129, -1, 0, 2, 131), seed=4),
}


def _banded(rows, cols, offsets, *, seed, skip_rbs=()):
    rng = np.random.default_rng(seed)
    r = np.repeat(np.arange(rows), len(offsets))
    c = r + np.tile(offsets, rows)
    keep = (c >= 0) & (c < cols) & ~np.isin(r // 128, skip_rbs)
    return CsrMatrix.from_coo(rows, cols, r[keep], c[keep],
                              rng.standard_normal(int(keep.sum())).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _aligned_case(name):
    m = ALIGNED[name]()
    plan = plan_aligned(m)
    assert plan.spill is None
    return m, plan


def _within_plain_bound(m, X_np, Y):
    for q in range(X_np.shape[1]):
        y64, bound = spmv.spmv_f64_bound(m, X_np[:, q])
        err = np.abs(np.asarray(Y, np.float64)[:, q] - y64)
        assert np.all(err <= bound), (q, float(np.max(err / np.maximum(bound, 1e-300))))


def _aligned_plain(plan, arrs, X):
    """``_aligned_spmm_torch`` on X (cols, K), unpacked to (rows, K)."""
    return spmm.unpack_rhs(spmm._aligned_spmm_torch(arrs, spmm.pack_rhs(X, plan.cols),
                                                    rows=plan.rows), plan.rows)


@pytest.mark.parametrize("k", [2, 8, 16])
@pytest.mark.parametrize("g", [1, 2, 32])
@pytest.mark.parametrize("name", list(ALIGNED))
def test_aligned_segment_order_spmm_matches_plain_and_reference(name, g, k, monkeypatch):
    monkeypatch.setattr(spmv, "SEGMENT_CHUNKS", g)
    m, plan = _aligned_case(name)
    arrs = spmv.aligned_device_arrays(plan, "cpu")
    cut = int(arrs["segments"][:, 3].max()) >= 0
    assert cut or g > 2
    X_np = _X(k + 40, m.cols, k)
    X = torch.from_numpy(X_np)
    y_seg = spmv._segments_torch("aligned", arrs, X, rows=m.rows, cols=m.cols)
    y_plain = _aligned_plain(plan, arrs, X)
    assert y_seg.shape == (m.rows, k) and y_seg.dtype == torch.float32
    if not cut:
        assert torch.equal(y_seg, y_plain)
    _within_plain_bound(m, X_np, y_seg)
    rp = ref_aligned.plan_aligned(_ref(m))
    x3 = ref_spmm.pack_rhs(jnp.asarray(X_np), m.cols)
    y_ref = np.asarray(ref_spmm.unpack_rhs(ref_spmm.spmm_aligned_packed(rp, x3), m.rows),
                       dtype=np.float64)
    _within_plain_bound(m, X_np, y_ref)
    assert np.max(np.abs(y_seg.numpy() - y_ref)) <= 2e-5 * max(1.0, float(np.max(np.abs(y_ref))))
    for q in (0, k - 1):  # column q of the block is the SpMV order on column q
        y1 = spmv._segments_torch("aligned", arrs, X[:, q].contiguous(), rows=m.rows,
                                  cols=m.cols)
        assert torch.equal(y1, y_seg[:, q])


@pytest.mark.parametrize("g", [2, 32])
def test_aligned_segment_order_spmm_of_masked_and_empty_row_blocks(g, monkeypatch):
    """Row blocks 0, 2 and 4 hold no entry: their rows are zero in every
    column, as in the plain version."""
    monkeypatch.setattr(spmv, "SEGMENT_CHUNKS", g)
    m = _banded(700, 512, (-130, -1, 0, 1, 130), seed=7, skip_rbs=(0, 2, 4))
    plan = plan_aligned(m)
    assert plan.spill is None and plan.rb_mask[[0, 2, 4]].sum() == 0
    arrs = spmv.aligned_device_arrays(plan, "cpu")
    X_np = _X(8, 512, 8)
    X = torch.from_numpy(X_np)
    y = spmv._segments_torch("aligned", arrs, X, rows=700, cols=512)
    for rb in (0, 2, 4):
        assert torch.all(y[rb * 128: (rb + 1) * 128] == 0)
    plain = _aligned_plain(plan, arrs, X)
    assert torch.equal(y == 0, plain == 0)
    _within_plain_bound(m, X_np, y)


@pytest.mark.parametrize("where", ["x0", "inner"])
@pytest.mark.parametrize("value", [np.inf, np.nan])
@pytest.mark.parametrize("name", list(ALIGNED))
def test_aligned_segment_order_spmm_nonfinite_rows(name, value, where, monkeypatch):
    """A non-finite X gives the plain version's NaN and inf entries, column
    by column (slab padding adds 0 * X[0, q] to row block 0)."""
    monkeypatch.setattr(spmv, "SEGMENT_CHUNKS", 2)
    m, plan = _aligned_case(name)
    arrs = spmv.aligned_device_arrays(plan, "cpu")
    X_np = _X(12, m.cols, 4)
    X_np[0 if where == "x0" else m.cols // 2 + 3, 1] = value
    X = torch.from_numpy(X_np)
    a = spmv._segments_torch("aligned", arrs, X, rows=m.rows, cols=m.cols).numpy()
    b = _aligned_plain(plan, arrs, X).numpy()
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.array_equal(np.isposinf(a), np.isposinf(b))
    assert np.array_equal(np.isneginf(a), np.isneginf(b))
    assert not np.all(np.isfinite(b[:, 1])) and np.all(np.isfinite(b[:, [0, 2, 3]]))


@pytest.mark.parametrize("packed", [True, False])
def test_spmm_aligned_into_store_and_add(packed):
    """Store mode writes every row of y (packed: zeros on the row blocks
    past r128); add mode adds the same result onto y; ``spmm_aligned``
    (row-major, no packing on the card) is the unpacked packed result."""
    m, plan = _aligned_case("banded_rect")
    arrs = spmv.aligned_device_arrays(plan, "cpu")
    X = torch.from_numpy(_X(3, m.cols, 5))
    x = spmm.pack_rhs(X, m.cols) if packed else X
    shape = (plan.r128 + 2, 5, 128) if packed else (m.rows, 5)
    y = torch.full(shape, float("nan"))
    spmm._spmm_aligned_into(plan, arrs, x, y, packed=packed)
    want = _aligned_plain(plan, arrs, X)
    got = spmm.unpack_rhs(y, m.rows) if packed else y
    assert torch.equal(got, want)
    assert torch.equal(spmm.spmm_aligned(plan, X, device_arrays=arrs), want)
    if packed:
        assert int(torch.count_nonzero(y[plan.r128:])) == 0
