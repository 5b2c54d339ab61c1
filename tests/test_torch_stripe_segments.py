"""Stripe segments (sparse_matrix_tpu_torch/ops/spmv.py: ``stripe_segments``,
the ``segments``/``stripe_seg`` device arrays, ``_stripe_segments_torch``).

The stripe kernel gives each stripe's rows one writer by walking the
plan's slabs as segments, one thread block each. These tests hold the
segments to their contract on small plans of each shape the main path runs
(scan(2,2) on a random-local matrix, scan(8,16) on power-law rows, a
select plan with its scan-mode spill chain) and of the edge cases (rows
that are not a multiple of ``L * 128``, masked and empty row blocks and
stripes, 16 levels, an empty plan), for segment lengths that do and do not
cut stripes:

* every slab lies in exactly one segment, in plan order; a segment covers
  one stripe and at most g slabs; every stripe of the rows has a segment,
  an empty one where it has no slab; scratch slots number the segments of
  cut stripes;
* the segment evaluation (the kernel's order: chunk by chunk within a
  segment, segment by segment within a stripe) equals ``_stripe_torch``
  and the JAX package's ``spmv_stripe`` on the CPU within
  ``spmv_f64_bound`` (scan-mode rows in the C8 form);
* non-finite x: its NaN and inf rows are the plain version's, padding
  chunks of other stripes included (they add ``0 * x[0]`` to stripe 0).

Inputs are made with numpy from fixed seeds.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sparse_matrix_tpu.formats import csr as ref_csr  # noqa: E402
from sparse_matrix_tpu.formats import stripe as ref_stripe  # noqa: E402
from sparse_matrix_tpu.ops import spmv as ref_spmv  # noqa: E402
from sparse_matrix_tpu_torch.bench import corpus  # noqa: E402
from sparse_matrix_tpu_torch.formats.csr import CsrMatrix  # noqa: E402
from sparse_matrix_tpu_torch.formats.stripe import plan_stripe  # noqa: E402
from sparse_matrix_tpu_torch.ops import spmv  # noqa: E402


def _ref(m):
    return ref_csr.CsrMatrix(m.rows, m.cols, m.vals, m.indices, m.offsets,
                             is_sorted=m.is_sorted)


def _f32(m):
    return CsrMatrix(m.rows, m.cols, m.vals.astype(np.float32), m.indices, m.offsets,
                     is_sorted=m.is_sorted)


def _masked(rows, cols, empty_rbs, seed):
    rng = np.random.default_rng(seed)
    mask = rng.random((rows, cols)) < 0.03
    for rb in empty_rbs:
        mask[rb * 128: (rb + 1) * 128] = False
    r, c = np.nonzero(mask)
    return CsrMatrix.from_coo(rows, cols, r, c, rng.standard_normal(r.size).astype(np.float32))


def _partial():
    rng = np.random.default_rng(2)
    r, c = rng.integers(0, 700, 9000), rng.integers(0, 6000, 9000)
    return CsrMatrix.from_coo(700, 6000, r, c, rng.standard_normal(9000).astype(np.float32))


# name -> (matrix, mode, levels, kw)
SHAPES = {
    "randlocal_scan_L2_kw2": (
        lambda: _f32(corpus.random_local(np.random.default_rng(1), 4096, 16, 1024)),
        "scan", 2, 2),
    "powerlaw_scan_L8_kw16": (
        lambda: _f32(corpus.power_law_rows(np.random.default_rng(3), 4096, 16)),
        "scan", 8, 16),
    "powerlaw_select_spill": (
        lambda: _f32(corpus.power_law_rows(np.random.default_rng(4), 3000, 12)),
        "select", 4, 2),
    "partial_stripe_L4": (_partial, "scan", 4, 2),
    "empty_stripes_L1": (lambda: _masked(640, 512, (0, 2, 4), 5), "select", 1, 1),
    "masked_rbs_L2": (lambda: _masked(768, 512, (0, 3, 4), 6), "scan", 2, 1),
    "levels16": (lambda: _f32(corpus.power_law_rows(np.random.default_rng(7), 4096, 8)),
                 "scan", 16, 1),
}


def _plan(name):
    make, mode, levels, kw = SHAPES[name]
    m = make()
    plan = plan_stripe(m, mode=mode, levels=levels, kw=kw)
    if name.endswith("spill"):
        assert plan.spill is not None and plan.spill.spill is None
    return m, plan


def _chain(plan, arrs):
    while plan is not None:
        yield plan, arrs
        plan, arrs = plan.spill, arrs.get("spill")


def _check_segments(plan, arrs, g):
    seg = arrs["segments"].numpy()
    stripe_seg = arrs["stripe_seg"].numpy()
    lvl = plan.levels
    stripes = -(-plan.rows // (lvl * 128))
    assert seg.dtype == np.int32 and stripe_seg.dtype == np.int32
    assert seg.ndim == 2 and seg.shape[1] == 4 and stripe_seg.shape == (stripes + 1,)
    st, first, count, slot = seg.T.astype(np.int64)
    # sorted by stripe; stripe_seg gives each stripe's first segment and count
    assert stripe_seg[0] == 0 and stripe_seg[-1] == seg.shape[0]
    nseg = np.diff(stripe_seg)
    assert np.all(nseg >= 1)
    assert np.array_equal(st, np.repeat(np.arange(stripes), nseg))
    # at most g slabs, of the segment's stripe; an empty segment only alone
    assert np.all((count >= 0) & (count <= g))
    assert np.all((count > 0) | (nseg[st] == 1))
    covered = np.concatenate([np.arange(f, f + c) for f, c in zip(first, count)] or [[]])
    covered = covered.astype(np.int64)
    assert np.array_equal(plan.stripe_rb[covered] // lvl, np.repeat(st, count))
    # every slab exactly once, in plan order
    assert np.array_equal(covered, np.arange(plan.num_slabs))
    # scratch slots: -1 for a sole segment, else numbered in segment order
    multi = nseg[st] > 1
    assert np.all(slot[~multi] == -1)
    assert np.array_equal(slot[multi], np.arange(int(multi.sum())))
    assert arrs["seg_slots"] == int(multi.sum())
    # padding chunks of another stripe than their slab's
    chunks = plan.num_slabs * 8
    foreign = np.repeat(plan.stripe_rb[: plan.num_slabs] // lvl, 8) != plan.chunk_stripe[:chunks]
    assert arrs["foreign_pad"] == bool(foreign.any())


def _evaluate(plan, arrs, x, fn):
    y = None
    for p, a in _chain(plan, arrs):
        yp = fn(a, x, rows=p.rows, cols=p.cols, lvl=p.levels, kw=p.kw, scan=p.mode == "scan")
        y = yp if y is None else y + yp
    return y


def _segment_slabs(monkeypatch, g):
    """Segments of at most g slabs for every plan (None: the default)."""
    if g is not None:
        monkeypatch.setattr(spmv, "stripe_segment_slabs", lambda levels: g)


@pytest.mark.parametrize("g", [1, 2, 3, 8])
@pytest.mark.parametrize("name", list(SHAPES))
def test_stripe_segments_cover_the_plan(name, g, monkeypatch):
    _segment_slabs(monkeypatch, g)
    _m, plan = _plan(name)
    arrs = spmv.stripe_device_arrays(plan, "cpu")
    for p, a in _chain(plan, arrs):
        _check_segments(p, a, g)


def test_stripe_segments_cut_stripes(monkeypatch):
    """Slabs of one stripe split every g slabs; a stripe with no slab gets an
    empty segment; slots number the cut stripes' segments."""
    m = _masked(640, 512, (2, 3), 8)
    plan = plan_stripe(m, mode="scan", levels=2, kw=1)
    per = np.bincount(plan.stripe_rb[: plan.num_slabs] // 2, minlength=3)
    assert per[1] == 0 and per[0] > 2 and per[2] > 0
    _segment_slabs(monkeypatch, 2)
    seg, stripe_seg, slots = spmv.stripe_segments(plan)
    n0 = -(-per[0] // 2)
    assert seg[:n0, 0].tolist() == [0] * n0 and seg[:n0, 3].tolist() == list(range(n0))
    assert seg[:n0, 1].tolist() == list(range(0, per[0], 2))
    assert seg[n0].tolist() == [1, 0, 0, -1]
    assert stripe_seg.tolist()[:3] == [0, n0, n0 + 1]
    assert slots == n0 + (-(-per[2] // 2) if per[2] > 2 else 0)
    for bad in (0, 33):
        _segment_slabs(monkeypatch, bad)
        with pytest.raises(ValueError, match=r"in \[1, 32\]"):
            spmv.stripe_segments(plan)


def test_stripe_segments_default_length(monkeypatch):
    """Plans of at most 2 levels take segments of 8 slabs by default, deeper
    plans segments of 4."""
    for name, g in (("randlocal_scan_L2_kw2", 8), ("powerlaw_scan_L8_kw16", 4)):
        _m, plan = _plan(name)
        assert spmv.stripe_segment_slabs(plan.levels) == g
        seg, _stripe_seg, _slots = spmv.stripe_segments(plan)
        with monkeypatch.context() as mp:
            _segment_slabs(mp, g)
            assert np.array_equal(seg, spmv.stripe_segments(plan)[0])
        per_stripe = np.bincount(plan.stripe_rb[: plan.num_slabs] // plan.levels)
        assert seg[:, 2].max() == min(g, per_stripe.max())


def test_stripe_segments_refuse_unordered_slabs():
    _m, plan = _plan("randlocal_scan_L2_kw2")
    assert plan.num_slabs > 2
    rb = plan.stripe_rb.copy()
    rb[[0, plan.num_slabs - 1]] = rb[[plan.num_slabs - 1, 0]]
    with pytest.raises(ValueError, match="consecutive"):
        spmv.stripe_segments(dataclasses.replace(plan, stripe_rb=rb))


def test_stripe_segments_of_an_empty_plan():
    m = CsrMatrix.from_coo(300, 200, np.zeros(0, np.int64), np.zeros(0, np.int64),
                           np.zeros(0, np.float32))
    for mode in ("scan", "select"):
        plan = plan_stripe(m, mode=mode, levels=2, kw=1)
        arrs = spmv.stripe_device_arrays(plan, "cpu")
        assert arrs["segments"].numpy().tolist() == [[0, 0, 0, -1], [1, 0, 0, -1]]
        assert arrs["stripe_seg"].numpy().tolist() == [0, 1, 2]
        y = spmv._stripe_segments_torch(arrs, torch.ones(200), rows=300, cols=200, lvl=2,
                                        kw=1, scan=mode == "scan")
        assert y.shape == (300,) and torch.all(y == 0)


@pytest.mark.parametrize("g", [1, None])
@pytest.mark.parametrize("name", list(SHAPES))
def test_stripe_segment_evaluation_matches_plain_and_reference(name, g, monkeypatch):
    _segment_slabs(monkeypatch, g)
    m, plan = _plan(name)
    arrs = spmv.stripe_device_arrays(plan, "cpu")
    x_np = np.random.default_rng(9).standard_normal(m.cols).astype(np.float32)
    x = torch.from_numpy(x_np)
    y_seg = _evaluate(plan, arrs, x, spmv._stripe_segments_torch)
    y_plain = _evaluate(plan, arrs, x, spmv._stripe_torch)
    assert torch.equal(y_plain, spmv.spmv_stripe(plan, x, device_arrays=arrs))
    y64, bound = spmv.spmv_f64_bound(m, x_np, stripe=(plan,))
    for y in (y_seg, y_plain):
        assert y.shape == (m.rows,) and y.dtype == torch.float32
        assert np.all(np.abs(y.double().numpy() - y64) <= bound)
    # the JAX package's CPU path (_stripe_reference) on its own plan of the matrix
    _, mode, levels, kw = SHAPES[name]
    ref_plan = ref_stripe.plan_stripe(_ref(m), mode=mode, levels=levels, kw=kw)
    y_ref = np.asarray(ref_spmv.spmv_stripe(ref_plan, jnp.asarray(x_np)), dtype=np.float64)
    assert np.all(np.abs(y_ref - y64) <= bound)
    assert np.all(np.abs(y_seg.double().numpy() - y_ref) <= bound)


@pytest.mark.parametrize("where", ["x0", "inner"])
@pytest.mark.parametrize("value", [np.inf, np.nan])
@pytest.mark.parametrize("name", ["randlocal_scan_L2_kw2", "powerlaw_select_spill",
                                  "masked_rbs_L2"])
def test_stripe_segment_evaluation_nonfinite_rows(name, value, where, monkeypatch):
    """The rule: every (level, lane) pair of every chunk adds its gather, a
    run or not, and a slab's padding chunks of another stripe add 0 * x[0]
    to stripe 0, so a non-finite x gives the plain version's NaN and inf
    rows (masked row blocks stay 0)."""
    _segment_slabs(monkeypatch, 2)
    m, plan = _plan(name)
    arrs = spmv.stripe_device_arrays(plan, "cpu")
    x_np = np.random.default_rng(10).standard_normal(m.cols).astype(np.float32)
    x_np[0 if where == "x0" else m.cols // 2 + 3] = value
    x = torch.from_numpy(x_np)
    a = _evaluate(plan, arrs, x, spmv._stripe_segments_torch).numpy()
    b = _evaluate(plan, arrs, x, spmv._stripe_torch).numpy()
    assert np.array_equal(np.isnan(a), np.isnan(b))
    assert np.array_equal(np.isposinf(a), np.isposinf(b))
    assert np.array_equal(np.isneginf(a), np.isneginf(b))
    assert not np.all(np.isfinite(b))
    live = np.repeat(plan.rb_mask[: -(-m.rows // 128)] > 0, 128)[: m.rows]
    assert np.all(a[~live] == 0)


def test_stripe_foreign_padding_reaches_stripe_zero():
    """A stripe other than 0 whose last slab is partly padding: with x[0]
    non-finite, the plain version's NaN lands on stripe 0's live rows (and
    not on that stripe's), and so does the segment evaluation's."""
    m, plan = _plan("randlocal_scan_L2_kw2")
    arrs = spmv.stripe_device_arrays(plan, "cpu")
    assert arrs["foreign_pad"]
    x_np = np.random.default_rng(11).standard_normal(m.cols).astype(np.float32)
    x_np[0] = np.inf
    x = torch.from_numpy(x_np)
    a = spmv._stripe_segments_torch(arrs, x, rows=m.rows, cols=m.cols, lvl=2, kw=2, scan=True)
    b = spmv._stripe_torch(arrs, x, rows=m.rows, cols=m.cols, lvl=2, kw=2, scan=True)
    assert torch.all(torch.isnan(b[:256])) and torch.all(torch.isnan(a[:256]))
    assert torch.equal(torch.isnan(a), torch.isnan(b))
