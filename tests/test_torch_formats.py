"""Port parity: the host planners (sparse_matrix_tpu_torch/formats/,
utils/autotune.py) and the operator's dispatch.

From the same COO arrays, the port's planners and the reference's give
plans whose every field is equal: arrays ``np.array_equal`` with equal
dtypes, scalars ``==`` (DIA, LanePack in both packs, aligned with and
without spill, BELL, and stripe in scan and select mode over L in
{1, 2, 4, 8} and KW in {1, 2, 16}, int8 and int16 lanes, a select plan with
its scan-mode spill). ``SpmvOperator(m, device="cpu")`` picks the
reference's format and, for stripe, the same plan.
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparse_matrix_tpu.formats import aligned as ref_aligned  # noqa: E402
from sparse_matrix_tpu.formats import bell as ref_bell  # noqa: E402
from sparse_matrix_tpu.formats import csr as ref_csr  # noqa: E402
from sparse_matrix_tpu.formats import dia as ref_dia  # noqa: E402
from sparse_matrix_tpu.formats import lanepack as ref_lanepack  # noqa: E402
from sparse_matrix_tpu.formats import stripe as ref_stripe  # noqa: E402
from sparse_matrix_tpu.ops import operator as ref_op  # noqa: E402
from sparse_matrix_tpu.utils import autotune as ref_autotune  # noqa: E402
from sparse_matrix_tpu_torch.bench import corpus  # noqa: E402
from sparse_matrix_tpu_torch.formats import aligned, bell, csr, dia, lanepack, stripe  # noqa: E402
from sparse_matrix_tpu_torch.ops.operator import SpmvOperator  # noqa: E402
from sparse_matrix_tpu_torch.solvers.poisson import poisson_2d_csr  # noqa: E402
from sparse_matrix_tpu_torch.utils import autotune  # noqa: E402


def _ref(m):
    """The reference's CsrMatrix over the same arrays."""
    return ref_csr.CsrMatrix(m.rows, m.cols, m.vals, m.indices, m.offsets,
                             is_sorted=m.is_sorted)


def _equal(a, b, path="plan"):
    """Every field of two plans equal: arrays with equal dtypes, nested
    plans recursively."""
    if dataclasses.is_dataclass(a):
        assert dataclasses.is_dataclass(b), path
        fa = [f.name for f in dataclasses.fields(a)]
        assert fa == [f.name for f in dataclasses.fields(b)], path
        for name in fa:
            _equal(getattr(a, name), getattr(b, name), f"{path}.{name}")
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype, path
        assert np.array_equal(a, b), path
    else:
        assert a == b, (path, a, b)


def _random(seed, rows, cols, nnz):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, rows, nnz)
    c = rng.integers(0, cols, nnz)
    v = rng.standard_normal(nnz).astype(np.float32)
    return r, c, v


def _scatter(seed=0, n=3000):
    return corpus.random_local(np.random.default_rng(seed), n, 10, 600)


def _skew(seed=0, n=3000):
    return corpus.power_law_rows(np.random.default_rng(seed), n, 12)


def test_csr_from_coo_sums_duplicates_like_reference():
    r, c, v = _random(0, 300, 200, 4000)  # many duplicate coordinates
    for dup in (True, False):
        m = csr.CsrMatrix.from_coo(300, 200, r, c, v, sum_duplicates=dup)
        ref = ref_csr.CsrMatrix.from_coo(300, 200, r, c, v, sum_duplicates=dup)
        for f in ("offsets", "indices", "vals"):
            _equal(getattr(m, f), getattr(ref, f), f)
        assert m.nnz() == ref.nnz() and m.is_sorted and np.array_equal(m.row_ids(), ref.row_ids())


def test_sample_row_bands_like_reference():
    m = _skew(1, 40_000)
    sub, scale = csr.sample_row_bands(m, 50_000)
    ref_sub, ref_scale = ref_csr.sample_row_bands(_ref(m), 50_000)
    assert scale == ref_scale and (sub.rows, sub.cols) == (ref_sub.rows, ref_sub.cols)
    for f in ("offsets", "indices", "vals"):
        _equal(getattr(sub, f), getattr(ref_sub, f), f)
    assert csr.sample_row_bands(m, 50_000)[0] is sub  # memoized


def test_autotune_defaults_are_the_references():
    for name, value in autotune.DEFAULTS.items():
        assert ref_autotune.DEFAULTS[name] == value == autotune.get(name)
    with pytest.raises(KeyError):
        autotune.get("no_such_constant")


@pytest.mark.parametrize("case", ["poisson", "rect", "too_many_bands", "f64"])
def test_dia_plan_parity(case):
    if case == "rect":
        rows, cols = 500, 260
        r = np.repeat(np.arange(rows), 4)
        c = r + np.tile([-250, -7, 0, 9], rows)
        keep = (c >= 0) & (c < cols)
        m = csr.CsrMatrix.from_coo(rows, cols, r[keep], c[keep],
                                   np.ones(int(keep.sum()), np.float32))
    elif case == "too_many_bands":
        m = _scatter()
    else:
        m = poisson_2d_csr(24, dtype=np.float32)
    dtype = np.float64 if case == "f64" else np.float32
    plan = dia.try_dia_from_csr(m, dtype=dtype)
    ref = ref_dia.try_dia_from_csr(_ref(m), dtype=dtype)
    assert (plan is None) == (ref is None) == (case == "too_many_bands")
    if plan is not None:
        _equal(plan, ref)
        assert dia.try_dia_from_csr(m, dtype=dtype) is plan  # memoized


@pytest.mark.parametrize("pack", ["auto", "dense", "per_rb"])
@pytest.mark.parametrize("kw", [None, 1, 4])
def test_lanepack_plan_parity(pack, kw):
    m = _skew(kw or 0)
    _equal(lanepack.plan_lanepack(m, kw=kw, pack=pack),
           ref_lanepack.plan_lanepack(_ref(m), kw=kw, pack=pack))


def test_lanepack_plan_parity_empty_row_blocks():
    r, c, v = _random(3, 100, 900, 2000)
    m = csr.CsrMatrix.from_coo(640, 900, r * 3 % 640 // 128 * 256 % 640, c, v)
    _equal(lanepack.plan_lanepack(m), ref_lanepack.plan_lanepack(_ref(m)))


@pytest.mark.parametrize("name", ["poisson", "scatter", "rect"])
def test_aligned_plan_parity(name):
    if name == "poisson":
        m = poisson_2d_csr(40, dtype=np.float32)
    elif name == "scatter":
        m = _scatter(2)
    else:
        m = csr.CsrMatrix.from_coo(300, 1000, *_random(4, 300, 1000, 5000))
    plan = aligned.plan_aligned(m)
    _equal(plan, ref_aligned.plan_aligned(_ref(m)))


def test_aligned_plan_parity_with_spill(monkeypatch, tmp_path):
    # a huge aligned slab cost makes both planners spill low-fill chunks
    p = tmp_path / "autotune.json"
    p.write_text(json.dumps({"lanepack_aligned_slab_ns": 1e6}))
    monkeypatch.setenv("SPMX_AUTOTUNE_CACHE", str(p))
    monkeypatch.setitem(autotune.DEFAULTS, "lanepack_aligned_slab_ns", 1e6)
    ref_autotune.reset_cache()
    try:
        m = _scatter(3)
        plan = aligned.plan_aligned(m)
        assert plan.spill is not None
        _equal(plan, ref_aligned.plan_aligned(_ref(m)))
    finally:
        ref_autotune.reset_cache()


@pytest.mark.parametrize("span", [None, 128, 256])
@pytest.mark.parametrize("name", ["poisson", "femlike", "spill"])
def test_bell_plan_parity(span, name):
    if name == "poisson":
        m = poisson_2d_csr(48, dtype=np.float32)
    elif name == "femlike":
        m = corpus.fem_like(np.random.default_rng(0), 40, 2)
    else:
        a = poisson_2d_csr(96, dtype=np.float32)
        rng = np.random.default_rng(3)
        r = np.r_[a.row_ids(), rng.integers(0, a.rows, 40)]
        c = np.r_[a.indices.astype(np.int64), rng.integers(0, a.cols, 40)]
        v = np.r_[a.vals, rng.standard_normal(40).astype(np.float32)]
        m = csr.CsrMatrix.from_coo(a.rows, a.cols, r, c, v)
    plan = bell.plan_bell(m, span=span)
    if name == "spill":
        assert plan.spill is not None
    _equal(plan, ref_bell.plan_bell(_ref(m), span=span))
    assert bell.estimate_bell(m) == ref_bell.estimate_bell(_ref(m))


@pytest.mark.parametrize("kw", [1, 2, 16])
@pytest.mark.parametrize("levels", [1, 2, 4, 8])
@pytest.mark.parametrize("mode", ["scan", "select"])
def test_stripe_plan_parity(mode, levels, kw):
    m = _skew(levels * 31 + kw)
    plan = stripe.plan_stripe(m, mode=mode, levels=levels, kw=kw)
    assert plan.mode == mode and plan.levels == levels
    assert plan.lane.dtype == (np.int8 if plan.kw == 1 else np.int16)
    _equal(plan, ref_stripe.plan_stripe(_ref(m), mode=mode, levels=levels, kw=kw))


def test_stripe_int8_and_int16_lanes_and_select_spill_covered():
    m = _skew(5)
    scan = stripe.plan_stripe(m, mode="scan", levels=2, kw=1)
    sel = stripe.plan_stripe(m, mode="select", levels=4, kw=2)
    assert scan.lane.dtype == np.int8 and scan.starts is not None
    assert sel.starts is None and sel.spill is not None and sel.spill.mode == "scan"
    _equal(sel, ref_stripe.plan_stripe(_ref(m), mode="select", levels=4, kw=2))


@pytest.mark.parametrize("mode", ["auto", "scan", "select"])
def test_stripe_cost_model_grid_parity(mode):
    m = _scatter(6)
    _equal(stripe.plan_stripe(m, mode=mode), ref_stripe.plan_stripe(_ref(m), mode=mode))


def test_stripe_empty_plan_parity():
    m = csr.CsrMatrix.from_coo(64, 64, np.zeros(0, np.int64), np.zeros(0, np.int64),
                               np.zeros(0, np.float32), sum_duplicates=False)
    plan = stripe.plan_stripe(m, mode="scan", levels=2, kw=1)
    assert plan.num_slabs == 0
    _equal(plan, ref_stripe.plan_stripe(_ref(m), mode="scan", levels=2, kw=1))


DISPATCH = {
    "poisson": lambda: poisson_2d_csr(48, dtype=np.float32),
    "femlike": lambda: corpus.fem_like(np.random.default_rng(0), 48, 2),
    "scatter": lambda: corpus.random_local(np.random.default_rng(1), 1 << 16, 16, 4096),
    "skew": lambda: corpus.power_law_rows(np.random.default_rng(2), 1 << 14, 16),
    "scatter_small": lambda: _scatter(7),
    "rect": lambda: csr.CsrMatrix.from_coo(400, 3000, *_random(8, 400, 3000, 20_000)),
}


@pytest.mark.parametrize("name", list(DISPATCH))
def test_dispatch_parity(name):
    m = DISPATCH[name]()
    ref = ref_op.SpmvOperator(_ref(m))
    op = SpmvOperator(m, device="cpu")
    assert op.format == ref.format
    for attr in ("_dia", "_plan", "_aligned", "_bell", "_stripe"):
        mine, theirs = getattr(op, attr), getattr(ref, attr, None)
        assert (mine is None) == (theirs is None), attr
        if mine is not None:
            _equal(mine, theirs, attr)
    if name in ("scatter", "skew"):
        assert op.format == "stripe"
