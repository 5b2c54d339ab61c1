"""The ESC expansion's segment schedule and the planned sort reduction
(sparse_matrix_tpu_torch/ops/esc_expand.py ``ExpandPlan.segments``,
``expand_tiles``, ``expand_segment_arrays``, ``_expand_segments_torch``;
ops/device_sorted.py ``plan_sort_reduce``, ``_sum_runs_torch`` and
``EscSpgemm(reduce="sort")``) on the CPU, against the plain version of the
lane form (``_expand_torch``), the reference's ``expand_products`` (its
interpret branch) and the per-call sort (``_packed_reduce_presort``).

Tolerances: the expansion is bit-equal (``==``) on the real slots and 0 on
the padding (one f32 multiply a slot in every version); the planned sort
reduction equals the per-call sort bit for bit (the same sorted sequence,
the same sequential adds from +0), and both equal float32 sums taken in
sorted order with ``np.add.at``; ``EscSpgemm`` results are held to the
reference's pattern and to ``spgemm_err_over_bound <= 1`` (``(n_ij + 2)
* u * (|A||B|)_ij`` against the float64 product). The tile windows are
checked exactly: every real slot's operand positions lie inside its
tile's windows, which is what the kernel's staging relies on.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sparse_matrix_tpu.formats import csr as ref_csr  # noqa: E402
from sparse_matrix_tpu.ops import device_sorted as ref_ds  # noqa: E402
from sparse_matrix_tpu.ops import esc_expand as ref_ee  # noqa: E402
from sparse_matrix_tpu_torch.bench import corpus  # noqa: E402
from sparse_matrix_tpu_torch.formats.csr import CsrMatrix  # noqa: E402
from sparse_matrix_tpu_torch.native.kernels import ESC_STAGE, ESC_TILE  # noqa: E402
from sparse_matrix_tpu_torch.ops import device_sorted as ds  # noqa: E402
from sparse_matrix_tpu_torch.ops import esc_expand as ee  # noqa: E402
from sparse_matrix_tpu_torch.ops import spgemm_block as sb  # noqa: E402


def _ref(m):
    return ref_csr.CsrMatrix(m.rows, m.cols, m.vals, m.indices, m.offsets,
                             is_sorted=m.is_sorted)


def _coo(rows, cols, r, c, seed):
    v = np.random.default_rng(seed).standard_normal(len(r)).astype(np.float32)
    return CsrMatrix.from_coo(rows, cols, np.asarray(r), np.asarray(c), v)


def _uniform(seed, n, density):
    m = corpus.random_uniform(np.random.default_rng(seed), n, density)
    return CsrMatrix(m.rows, m.cols, m.vals.astype(np.float32), m.indices, m.offsets,
                     is_sorted=True)


def _cases():
    """(lhs, rhs) pairs: the SpGEMM tests' expansion cases, then the edge
    cases of the segment schedule."""
    rng = np.random.default_rng(40)
    fem = corpus.fem_like(np.random.default_rng(23), 20, 2)
    fem = CsrMatrix(fem.rows, fem.cols, fem.vals.astype(np.float32), fem.indices, fem.offsets,
                    is_sorted=True)
    n = 300
    # one entry a column (lk = 1) times a denser rhs; a denser lhs times one
    # entry a row (rk = 1)
    perm_cols = rng.permutation(n)
    lk1 = _coo(n, n, perm_cols, np.arange(n), 41)
    rk1 = _coo(n, n, np.arange(n), rng.permutation(n), 42)
    # a dense column times a dense row: one k of 64 * 96 = 6,144 products,
    # three tiles of 2,048
    col = _coo(64, 1, np.arange(64), np.zeros(64, np.int64), 43)
    row = _coo(1, 96, np.zeros(96, np.int64), np.arange(96), 44)
    # the identity pattern squared: 2,048 ks of one product each in one tile
    diag = _coo(2048, 2048, np.arange(2048), np.arange(2048), 45)
    # empty rows and columns on both sides
    keep = rng.random(n) < 0.6
    er = rng.integers(0, n, 1500)
    ec = rng.integers(0, n, 1500)
    sel = keep[er] & keep[ec]
    sparse_holes = _coo(n, n, er[sel], ec[sel], 46)
    # a long lhs column (lk = 3,000 > ESC_STAGE) and rhs rows of two: a tile
    # holds rows of that column in part and across a row boundary
    tall = _coo(3000, 3, np.arange(3000), np.zeros(3000, np.int64), 47)
    short = _coo(3, 5, [0, 0, 1, 2, 2], [1, 4, 0, 2, 3], 48)
    return {
        "uniform": (_uniform(20, 300, 0.02), _uniform(20, 300, 0.02)),
        "rect": (_coo(300, 280, rng.integers(0, 300, 2200), rng.integers(0, 280, 2200), 21),
                 _coo(280, 310, rng.integers(0, 280, 1800), rng.integers(0, 310, 1800), 22)),
        "unpadded": (_coo(64, 1, np.arange(64), np.zeros(64, np.int64), 18),
                     _coo(1, 32, np.zeros(32, np.int64), np.arange(32), 19)),
        "fem": (fem, fem),
        "lk1": (lk1, _uniform(49, n, 0.03)),
        "rk1": (_uniform(50, n, 0.03), rk1),
        "multi_tile_k": (col, row),
        "tiny_ks": (diag, diag),
        "holes": (sparse_holes, sparse_holes),
        "wide_window": (tall, short),
    }


CASES = list(_cases())


def _lanes_plain(xp, lv_csc, rv):
    arrs = ee.expand_device_arrays(xp, "cpu")
    return ee._expand_torch(lv_csc, rv, arrs["lv_lane"], arrs["rv_lane"], arrs["lv_off"],
                            arrs["rv_off"], num_products=xp.num_products)


@pytest.mark.parametrize("case", CASES)
def test_segment_schedule_equals_lanes_and_reference(case):
    a, b = _cases()[case]
    xp = ee.plan_expand_kmajor(a, b)
    n, slots = xp.num_products, xp.num_slabs * 1024
    # whole slabs, no padding slot: 2,048, 6,144 and 2,048 products
    assert (slots == n) == (case in ("unpadded", "multi_tile_k", "tiny_ks"))
    # the segments: one a k with lk * rk > 0, in k order, covering the slots
    seg = xp.segments
    assert seg.dtype == np.int64 and seg.shape[1] == 4
    lk = np.bincount(a.indices, minlength=a.cols)
    rk = np.diff(b.offsets)
    ks = np.nonzero(lk * rk)[0]
    assert np.array_equal(seg[:-1, 1], lk[ks])
    assert np.array_equal(np.diff(seg[:, 0]), (lk * rk)[ks])
    assert tuple(seg[-1]) == (n, 1, 0, 0) and seg[0, 0] == 0
    lv = torch.from_numpy(a.vals[xp.perm_csc])
    rv = torch.from_numpy(b.vals)
    want = _lanes_plain(xp, lv, rv)
    got = ee._expand_segments_torch(lv, rv, torch.from_numpy(seg), num_products=n,
                                    num_slots=slots)
    assert got.dtype == torch.float32 and torch.equal(got, want) and not got[n:].any()
    # and through the reference's lane plan and interpret branch
    rxp = ref_ee.plan_expand_kmajor(_ref(a), _ref(b))
    if rxp is not None:
        rp = np.asarray(ref_ee.expand_products(rxp, jnp.asarray(lv.numpy()),
                                               jnp.asarray(rv.numpy())))
        assert np.array_equal(got[:n].numpy(), rp[:n])
    # the segment arrays through expand_products, CSC-permuted and fresh
    # CSR-order lhs values read through perm_csc
    arrs = ee.expand_segment_arrays(xp, "cpu")
    assert "launch" not in arrs and arrs["segments"].dtype == torch.int32
    assert torch.equal(ee.expand_products(xp, lv, rv, device_arrays=arrs), want)
    fresh = np.random.default_rng(51).standard_normal(a.nnz()).astype(np.float32)
    want_fresh = _lanes_plain(xp, torch.from_numpy(fresh[xp.perm_csc]), rv)
    for arrays in (arrs, None):
        got_fresh = ee.expand_products(xp, torch.from_numpy(fresh), rv, device_arrays=arrays,
                                       csr_order=True)
        assert torch.equal(got_fresh, want_fresh)


@pytest.mark.parametrize("tile", [64, 128, 1024, ESC_TILE])
@pytest.mark.parametrize("case", CASES)
def test_tile_windows_cover_every_slot(case, tile):
    a, b = _cases()[case]
    xp = ee.plan_expand_kmajor(a, b)
    n, slots = xp.num_products, xp.num_slabs * 1024
    tiles = ee.expand_tiles(xp, tile)
    g = xp.segments.shape[0] - 1
    assert tiles.shape == (-(-slots // tile), 8) and not tiles[:, 6:].any()
    a_pos, e_pos = (t.numpy() for t in ee._segment_positions(torch.from_numpy(xp.segments), n))
    t_of = np.arange(n) // tile
    assert np.all(a_pos >= tiles[t_of, 1]) and np.all(a_pos < tiles[t_of, 2])
    assert np.all(e_pos >= tiles[t_of, 3]) and np.all(e_pos < tiles[t_of, 4])
    assert np.all(tiles[:, 2] <= a.nnz()) and np.all(tiles[:, 4] <= b.nnz())
    # the first segment of a tile holds its first slot; padding tiles hold
    # the sentinel and empty windows
    t0 = np.arange(tiles.shape[0]) * tile
    live = t0 < n
    jf = tiles[live, 0]
    assert np.all(xp.segments[jf, 0] <= t0[live]) and np.all(t0[live] < xp.segments[jf + 1, 0])
    assert np.all(tiles[~live, 0] == g) and not tiles[~live, 1:].any()
    # the last segment of a tile holds its last real slot
    jl = tiles[live, 5]
    last_slot = np.minimum(t0[live] + tile, n) - 1
    assert np.all(xp.segments[jl, 0] <= last_slot) and np.all(last_slot < xp.segments[jl + 1, 0])
    assert np.all(jl >= jf)
    # the rhs positions rise with the slot: the rhs windows are tight
    first = t0[live]
    last = np.minimum(first + tile, n) - 1
    assert np.array_equal(tiles[live, 3], e_pos[first])
    assert np.array_equal(tiles[live, 4], e_pos[last] + 1)


def test_wide_window_exceeds_the_stage():
    """The case whose lhs windows outgrow shared memory, read from device
    memory by the kernel (the card test runs it)."""
    xp = ee.plan_expand_kmajor(*_cases()["wide_window"])
    tiles = ee.expand_tiles(xp)
    assert np.any(tiles[:, 2] - tiles[:, 1] > ESC_STAGE)
    assert np.any(tiles[:, 2] - tiles[:, 1] <= ESC_STAGE)


def _old_reduce(key, p, rows, cols, padded):
    row, col, val, nnz = ds._packed_reduce_presort(key, p, rows, cols)
    return row, col, val, int(nnz) - int(padded)


@pytest.mark.parametrize("case", CASES)
def test_planned_sort_reduction_equals_the_per_call_sort(case):
    a, b = _cases()[case]
    xp = ee.plan_expand_kmajor(a, b)
    padded = xp.num_slabs * 1024 > xp.num_products
    key = torch.from_numpy(xp.out_key)
    runs = ds.plan_sort_reduce(key, a.rows, b.cols, padded=padded)
    assert "launch" not in runs
    assert runs["order"].dtype == runs["run_off"].dtype == torch.int32
    rng = np.random.default_rng(52)
    lv = torch.from_numpy(a.vals[xp.perm_csc])
    rv = torch.from_numpy(b.vals)
    p = ee.expand_products(xp, lv, rv)
    # cancellations, signed zeros and a NaN/inf among the products
    q = p.clone()
    n = xp.num_products
    idx = rng.choice(n, size=min(n, 7), replace=False)
    q[idx[:3]] = -0.0
    q[idx[3:5]] = float("inf")
    q[idx[5:6]] = float("nan")
    for prods in (p, q):
        row, col, val, nnz = _old_reduce(key, prods, a.rows, b.cols, padded)
        got = ds._sum_runs_torch(prods, runs["order"], runs["run_off"])
        assert int(runs["nnz"]) == runs["num_summed"] == nnz
        assert torch.equal(runs["row"], row) and torch.equal(runs["col"], col)
        assert torch.equal(got.isnan(), val.isnan())
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(val))
        assert torch.equal(torch.signbit(got), torch.signbit(val))
        assert not got[nnz:].any()
    # both are float32 sums from +0 in sorted order
    order = runs["order"].long().numpy()
    run_of = np.repeat(np.arange(runs["run_off"].numel() - 1),
                       np.diff(runs["run_off"].numpy()))
    want = np.zeros(order.size, np.float32)
    np.add.at(want, run_of, p.numpy()[order])
    assert np.array_equal(ds._sum_runs_torch(p, runs["order"], runs["run_off"]).numpy(), want)


@pytest.mark.parametrize("case", CASES)
def test_esc_spgemm_sort_runs_no_sort_per_call(case, monkeypatch):
    a, b = _cases()[case]
    eng = ds.EscSpgemm(a, b, device="cpu", reduce="sort")
    assert eng.engine == "pallas" and eng._rspmv is None
    xp = eng._xplan
    assert set(eng._expand_arrs) == {"segments", "tiles", "perm"}
    key = torch.from_numpy(xp.out_key)
    p = ee.expand_products(xp, torch.from_numpy(a.vals[xp.perm_csc]), torch.from_numpy(b.vals))
    want = _old_reduce(key, p, a.rows, b.cols, eng._padded)

    def no_sort(*args, **kw):
        raise AssertionError("torch.sort called in multiply_device")

    monkeypatch.setattr(torch, "sort", no_sort)
    got = eng.multiply_device()
    again = eng.multiply_device()
    monkeypatch.undo()
    assert int(got.nnz) == want[3] and got.row.shape == want[0].shape
    for g, w in zip(got[:3], want[:3]):
        assert torch.equal(g, w)
    assert torch.equal(got.val, again.val)
    c = ds.padded_to_host(got)
    ref = ref_ds.EscSpgemm(_ref(a), _ref(b), reduce="sort")
    rc = ref.multiply()
    assert np.array_equal(c.offsets, rc.offsets) and np.array_equal(c.indices, rc.indices)
    assert sb.spgemm_err_over_bound(a, b, c) <= 1.0
    # a re-multiply with fresh values on both sides
    rng = np.random.default_rng(53)
    nl = rng.standard_normal(a.nnz()).astype(np.float32)
    nr = rng.standard_normal(b.nnz()).astype(np.float32)
    a2 = CsrMatrix(a.rows, a.cols, nl, a.indices, a.offsets, is_sorted=a.is_sorted)
    b2 = CsrMatrix(b.rows, b.cols, nr, b.indices, b.offsets, is_sorted=b.is_sorted)
    c2 = ds.padded_to_host(eng.multiply_device(lhs_vals=nl, rhs_vals=nr))
    assert sb.spgemm_err_over_bound(a2, b2, c2) <= 1.0
    rc2 = ref_ds.padded_to_host(ref.multiply_device(lhs_vals=jnp.asarray(nl),
                                                    rhs_vals=jnp.asarray(nr)))
    assert np.array_equal(c2.indices, rc2.indices)
    p2 = ee.expand_products(xp, torch.from_numpy(nl[xp.perm_csc]), torch.from_numpy(nr))
    want2 = _old_reduce(key, p2, a.rows, b.cols, eng._padded)
    got2 = eng.multiply_device(lhs_vals=torch.from_numpy(nl), rhs_vals=torch.from_numpy(nr))
    assert torch.equal(got2.val, want2[2])
