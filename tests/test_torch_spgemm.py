"""Port parity: the SpGEMM engines and their dispatch (sparse_matrix_tpu_torch/
ops/spgemm_host.py, spgemm_dia.py, esc_expand.py, device_sorted.py,
spgemm_spmv.py, spgemm_block.py ``spgemm_auto``; formats/csr.py transpose
and merges, formats/dia.py ``to_csr``, formats/device.py).

Both packages get the same numpy-seeded CSR matrices (at most 512 rows);
the port runs on the CPU (plain versions of its kernels), the JAX package
on its CPU path (its expansion kernel's interpret branch). Tolerances:

* plans (``flops_per_row``, ``partition_rows_by_flops``,
  ``plan_expand_kmajor`` with ``out_key`` compared by value,
  ``_group_by_key``, ``expand_plan``) and host structure ops (transpose,
  ``+``, ``-``, ``identity``, ``DiaMatrix.to_csr``, the device transpose,
  add and sub): array-equal;
* the expansion: bit-equal (``==``) on the real product slots, zero on
  the padding slots (one f32 multiply per slot in every version);
* the host hash engine (both routes) and ``spgemm_esc_host``: values
  ``==`` to the reference's ``force_python=True`` / ``spgemm_esc_host``
  (each entry adds its products in lhs-CSR order), rows compared
  column-sorted where the output is unsorted;
* band convolution: the reference's offsets and pattern, values within
  ``2e-6 * max|C|`` of the reference's (XLA fuses its multiply-adds into
  FMAs on the CPU, the port rounds the product and the sum apart) and,
  as a CSR, within ``spgemm_err_over_bound <= 1``;
* ESC engines, ``FixedSideSpgemm`` and ``spgemm_auto``: the reference's
  pattern (offsets and indices equal, cancellation zeros kept where the
  reference keeps them); values of the sort reduction and the host and
  band engines within ``spgemm_err_over_bound <= 1`` (``(n_ij + 2) * u *
  (|A||B|)_ij`` per entry of the union of both patterns against the
  float64 product); values of an SpMV reduction (``ReduceSpmv``,
  ``FixedSideSpgemm``) within ``reduce_f64_bound`` of its selection
  matrix and input (the SpMV bound of ``spmv_f64_bound``, the C8 form for
  the scan-mode formats the dispatch picks), and within the SpGEMM bound
  as well where the selection matrix runs the aligned or ELL format. With
  LanePack, stripe scan or BELL the reference's own results exceed the
  SpGEMM bound by up to 8e4 on these cases: ROADMAP.md C14.
"""

import importlib
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sparse_matrix_tpu.formats import csr as ref_csr  # noqa: E402
from sparse_matrix_tpu.formats import dia as ref_dia  # noqa: E402
from sparse_matrix_tpu.formats.device import DeviceCsr as RefDeviceCsr  # noqa: E402
from sparse_matrix_tpu.ops import device_sorted as ref_ds  # noqa: E402
from sparse_matrix_tpu.ops import esc_expand as ref_ee  # noqa: E402
from sparse_matrix_tpu.ops import spgemm_host as ref_sh  # noqa: E402
from sparse_matrix_tpu.ops import spgemm_spmv as ref_ss  # noqa: E402
from sparse_matrix_tpu.utils import autotune as ref_autotune  # noqa: E402
from sparse_matrix_tpu_torch import device as port_device  # noqa: E402
from sparse_matrix_tpu_torch.bench import corpus  # noqa: E402
from sparse_matrix_tpu_torch.formats.csr import CsrMatrix  # noqa: E402
from sparse_matrix_tpu_torch.formats.device import DeviceCsr  # noqa: E402
from sparse_matrix_tpu_torch.formats.dia import DiaMatrix, try_dia_from_csr  # noqa: E402
from sparse_matrix_tpu_torch.ops import device_sorted as ds  # noqa: E402
from sparse_matrix_tpu_torch.ops import esc_expand as ee  # noqa: E402
from sparse_matrix_tpu_torch.ops import spgemm_block as sb  # noqa: E402
from sparse_matrix_tpu_torch.ops import spgemm_dia as sd  # noqa: E402
from sparse_matrix_tpu_torch.ops import spgemm_host as sh  # noqa: E402
from sparse_matrix_tpu_torch.ops import spgemm_spmv as ss  # noqa: E402
from sparse_matrix_tpu_torch.solvers.poisson import poisson_2d_csr  # noqa: E402
from sparse_matrix_tpu_torch.utils import autotune  # noqa: E402

# the reference's ops package rebinds these module names to functions
ref_sd = importlib.import_module("sparse_matrix_tpu.ops.spgemm_dia")
ref_sb = importlib.import_module("sparse_matrix_tpu.ops.spgemm_block")


@pytest.fixture(autouse=True)
def cpu_default_device():
    """``A @ B`` and ``spgemm_auto(device=None)`` run on the CPU here."""
    before = port_device._DEFAULT
    port_device.set_default_device("cpu")
    yield
    port_device._DEFAULT = before


def _ref(m):
    return ref_csr.CsrMatrix(m.rows, m.cols, m.vals, m.indices, m.offsets,
                             is_sorted=m.is_sorted)


def _f32(m):
    return CsrMatrix(m.rows, m.cols, m.vals.astype(np.float32), m.indices, m.offsets,
                     is_sorted=m.is_sorted)


def _uniform(seed, n=300, density=0.02, dtype=np.float32):
    m = corpus.random_uniform(np.random.default_rng(seed), n, density)
    return CsrMatrix(m.rows, m.cols, m.vals.astype(dtype), m.indices, m.offsets,
                     is_sorted=True)


def _rect(seed, rows, cols, nnz, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return CsrMatrix.from_coo(rows, cols, rng.integers(0, rows, nnz), rng.integers(0, cols, nnz),
                              rng.standard_normal(nnz).astype(dtype))


def _unsorted(m, seed):
    """``m`` with each row's entries in a random order (is_sorted=False)."""
    rng = np.random.default_rng(seed)
    key = m.row_ids() * (m.nnz() + 1) + rng.permutation(m.nnz())
    order = np.argsort(key)
    return CsrMatrix(m.rows, m.cols, m.vals[order], m.indices[order], m.offsets,
                     is_sorted=False)


def _canon(m):
    """(offsets, indices, vals) with every row column-sorted."""
    order = np.lexsort((m.indices.astype(np.int64), m.row_ids()))
    return np.asarray(m.offsets), np.asarray(m.indices)[order], np.asarray(m.vals)[order]


def _same(got, want, *, values=True):
    g, w = _canon(got), _canon(want)
    assert (got.rows, got.cols) == (want.rows, want.cols)
    assert np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
    if values:
        assert g[2].dtype == w[2].dtype and np.array_equal(g[2], w[2])


def _bounded(a, b, c):
    assert sb.spgemm_err_over_bound(a, b, c) <= 1.0


def _same_pattern_bounded(a, b, c, ref_c):
    _same(c, ref_c, values=False)
    _bounded(a, b, c)


def _reduce_bounded(engine, x, c):
    """``c`` (host CSR of an SpMV reduction's result) within the SpMV bound
    of the engine's selection matrix applied to ``x``."""
    y64, bound = ss.reduce_f64_bound(engine, x)
    assert c.vals.shape == y64.shape and np.all(np.abs(c.vals - y64) <= bound)


def _esc_bounded(eng, a, b, c):
    """An ESC result for operands ``a``, ``b``: the SpGEMM bound for the
    sort reduction; for the SpMV reduction the SpMV bound of its product
    stream, and the SpGEMM bound too unless the selection matrix runs a
    scan-mode or windowed format (C14)."""
    if eng._rspmv is None or eng._rspmv.op.format not in _SCAN_FORMATS:
        _bounded(a, b, c)
    if eng._rspmv is None:
        return
    xp = eng._xplan
    p = ee.expand_products(xp, torch.from_numpy(a.vals[xp.perm_csc].astype(np.float32)),
                           torch.from_numpy(b.vals.astype(np.float32)))
    _reduce_bounded(eng._rspmv, p.numpy(), c)


# the selection-matrix formats whose sums exceed the SpGEMM bound, in the
# reference too (C14)
_SCAN_FORMATS = ("lanepack", "stripe", "bell")


# ---------------------------------------------------------------------------
# host planner and engines
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("parts", [1, 3, 7])
def test_flops_per_row_and_partition_match_reference(parts):
    a, b = _rect(1, 200, 150, 900), _rect(2, 150, 170, 700)
    f = sh.flops_per_row(a, b)
    rf = ref_sh.flops_per_row(_ref(a), _ref(b))
    assert np.array_equal(f, rf)
    assert np.array_equal(sh.partition_rows_by_flops(f, parts),
                          ref_sh.partition_rows_by_flops(rf, parts))


@pytest.mark.parametrize("force_python", [False, True])
@pytest.mark.parametrize("output_sorted", [False, True])
@pytest.mark.parametrize("sorted_lhs", [True, False])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spgemm_hash_host_equals_reference(dtype, sorted_lhs, output_sorted, force_python):
    a = _uniform(3, 250, 0.03, dtype)
    if not sorted_lhs:
        a = _unsorted(a, 4)
    b = _uniform(5, 250, 0.03, dtype)
    c = sh.spgemm_hash_host(a, b, output_sorted=output_sorted, force_python=force_python)
    want = ref_sh.spgemm_hash_host(_ref(a), _ref(b), output_sorted=output_sorted,
                                   force_python=True)
    assert c.is_sorted == output_sorted
    _same(c, want)
    if force_python or output_sorted:  # the same row order too
        assert np.array_equal(c.indices, want.indices) and np.array_equal(c.vals, want.vals)


def test_spgemm_hash_host_keeps_cancellation_zeros():
    a = CsrMatrix.from_coo(4, 4, [0, 0, 1], [0, 1, 1], np.array([1.0, 1.0, 2.0], np.float32))
    b = CsrMatrix.from_coo(4, 4, [0, 1, 1], [0, 0, 2], np.array([1.0, -1.0, 3.0], np.float32))
    for fp in (False, True):
        c = sh.spgemm_hash_host(a, b, output_sorted=True, force_python=fp)
        _same(c, ref_sh.spgemm_hash_host(_ref(a), _ref(b), output_sorted=True,
                                         force_python=True))
        assert c.nnz() == 4 and c.vals[0] == 0
    with pytest.raises(ValueError, match="LHS cols"):
        sh.spgemm_hash_host(a, CsrMatrix.new(3, 4))


@pytest.mark.parametrize("output_sorted", [True, False])
def test_spgemm_esc_host_equals_reference(output_sorted):
    a, b = _rect(6, 120, 90, 800, np.float64), _rect(7, 90, 130, 600, np.float64)
    c = sh.spgemm_esc_host(a, b, output_sorted=output_sorted)
    want = ref_sh.spgemm_esc_host(_ref(a), _ref(b), output_sorted=output_sorted)
    for f in ("offsets", "indices", "vals"):
        assert np.array_equal(getattr(c, f), getattr(want, f)), f
    assert c.is_sorted == want.is_sorted
    r, cc, v = sh.expand_products(a, b)
    rr, rc, rv = ref_sh.expand_products(_ref(a), _ref(b))
    assert np.array_equal(r, rr) and np.array_equal(cc, rc) and np.array_equal(v, rv)


# ---------------------------------------------------------------------------
# CSR structure ops, DIA, DeviceCsr
# ---------------------------------------------------------------------------


def _fields_equal(got, want):
    assert (got.rows, got.cols, got.is_sorted) == (want.rows, want.cols, want.is_sorted)
    for f in ("offsets", "indices", "vals"):
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype and np.array_equal(g, w), f


@pytest.mark.parametrize("sorted_rows", [True, False])
def test_csr_transpose_matches_reference(sorted_rows):
    a = _rect(8, 140, 90, 700)
    if not sorted_rows:
        a = _unsorted(a, 9)
    t = a.transpose()
    _fields_equal(t, _ref(a).transpose())
    assert t.transpose() is a and a.T is t  # memoized both ways
    assert t.shape == (90, 140)


def test_csr_add_sub_identity_match_reference():
    a, b = _rect(10, 60, 70, 400), _rect(11, 60, 70, 400, np.float64)
    _fields_equal(a + b, _ref(a) + _ref(b))
    _fields_equal(a - b, _ref(a) - _ref(b))
    d = a - a  # every position a cancellation zero, kept explicit
    _fields_equal(d, _ref(a) - _ref(a))
    assert d.nnz() == a.nnz() and not d.vals.any()
    _fields_equal(CsrMatrix.identity(9, dtype=np.float32),
                  ref_csr.CsrMatrix.identity(9, dtype=np.float32))
    with pytest.raises(ValueError, match="identical dimensions"):
        a + CsrMatrix.new(70, 60)


def test_dia_to_csr_and_nnz_match_reference():
    a = poisson_2d_csr(12, dtype=np.float32)
    d = try_dia_from_csr(a)
    rd = ref_dia.try_dia_from_csr(_ref(a))
    assert d.nnz() == rd.nnz() == a.nnz()
    _fields_equal(d.to_csr(), rd.to_csr())


def test_device_csr_round_trip():
    a = _unsorted(_rect(12, 50, 40, 300), 13)
    d = DeviceCsr.from_host(a, device="cpu")
    rd = RefDeviceCsr.from_host(_ref(a))
    for f in ("vals", "indices", "offsets", "row_ids"):
        assert np.array_equal(getattr(d, f).numpy(), np.asarray(getattr(rd, f))), f
        assert getattr(d, f).dtype == (torch.float32 if f == "vals" else torch.int32)
    assert (d.nnz, d.shape, d.is_sorted) == (a.nnz(), (50, 40), False)
    _fields_equal(d.to_host(), rd.to_host())


# ---------------------------------------------------------------------------
# band convolution
# ---------------------------------------------------------------------------


def test_spgemm_dia_poisson_squared_matches_reference():
    a = poisson_2d_csr(16, dtype=np.float32)
    d, rd = try_dia_from_csr(a), ref_dia.try_dia_from_csr(_ref(a))
    c = sd.spgemm_dia(d, d, device="cpu")
    rc = ref_sd.spgemm_dia(rd, rd)
    _dia_agree(c, rc)
    _same(c.to_csr(), rc.to_csr(), values=False)
    _bounded(a, a, c.to_csr())


def _dia_agree(c, rc):
    assert c.offsets == rc.offsets and c.data.shape == rc.data.shape
    assert np.array_equal(c.data != 0, rc.data != 0)
    assert np.max(np.abs(c.data - rc.data)) <= 2e-6 * max(1.0, float(np.abs(rc.data).max()))


def _band_cases():
    """Shapes of the reference's test_band_conv_matches_dense: l, m, n in
    [2, 12], one to four distinct offsets in [-6, 6] per operand."""
    rng = np.random.default_rng(17)
    for _ in range(12):
        l, m, n = (int(v) for v in rng.integers(2, 13, 3))
        oa = tuple(sorted(rng.choice(np.arange(-6, 7), int(rng.integers(1, 5)), replace=False)))
        ob = tuple(sorted(rng.choice(np.arange(-6, 7), int(rng.integers(1, 5)), replace=False)))
        yield l, m, n, tuple(int(o) for o in oa), tuple(int(o) for o in ob), int(rng.integers(1000))


@pytest.mark.parametrize("l,m,n,offs_a,offs_b,seed", list(_band_cases()))
def test_spgemm_dia_band_conv_matches_reference(l, m, n, offs_a, offs_b, seed):
    rng = np.random.default_rng(seed)

    def make(rows, cols, offs):
        data = np.zeros((len(offs), rows), np.float32)
        i = np.arange(rows)
        for k, o in enumerate(offs):
            ok = (i + o >= 0) & (i + o < cols)
            data[k][ok] = rng.standard_normal(ok.sum()).astype(np.float32)
        return data

    da, db = make(l, m, offs_a), make(m, n, offs_b)
    c = sd.spgemm_dia(DiaMatrix(l, m, da, offs_a), DiaMatrix(m, n, db, offs_b), device="cpu")
    rc = ref_sd.spgemm_dia(ref_dia.DiaMatrix(l, m, da, offs_a), ref_dia.DiaMatrix(m, n, db, offs_b))
    _dia_agree(c, rc)
    a, b = DiaMatrix(l, m, da, offs_a).to_csr(), DiaMatrix(m, n, db, offs_b).to_csr()
    _bounded(a, b, c.to_csr())
    with pytest.raises(ValueError, match="LHS cols"):
        sd.spgemm_dia(DiaMatrix(l, m, da, offs_a), DiaMatrix(m + 1, n, np.zeros((1, m + 1),
                                                                                np.float32), (0,)),
                      device="cpu")


# ---------------------------------------------------------------------------
# the expansion plan and its kernel's plain version
# ---------------------------------------------------------------------------


def _expand_pairs():
    col = CsrMatrix.from_coo(64, 1, np.arange(64), np.zeros(64, np.int64),
                             np.random.default_rng(18).standard_normal(64).astype(np.float32))
    row = CsrMatrix.from_coo(1, 32, np.zeros(32, np.int64), np.arange(32),
                             np.random.default_rng(19).standard_normal(32).astype(np.float32))
    return {
        "uniform": (_uniform(20), _uniform(20)),
        "rect": (_rect(21, 300, 280, 2200), _rect(22, 280, 310, 1800)),
        "unpadded": (col, row),  # 2,048 products: two whole slabs
        "fem": (_f32(corpus.fem_like(np.random.default_rng(23), 20, 2)),) * 2,
    }


@pytest.mark.parametrize("case", ["uniform", "rect", "unpadded", "fem"])
def test_plan_expand_kmajor_and_expansion_match_reference(case):
    a, b = _expand_pairs()[case]
    xp = ee.plan_expand_kmajor(a, b)
    rxp = ref_ee.plan_expand_kmajor(_ref(a), _ref(b))
    assert rxp is not None
    for f in ("rows", "cols", "num_products", "kw_lv", "kw_rv"):
        assert getattr(xp, f) == getattr(rxp, f), f
    for f in ("lv_lane", "rv_lane", "lv_off", "rv_off", "perm_csc"):
        g, w = getattr(xp, f), getattr(rxp, f)
        assert g.dtype == w.dtype and np.array_equal(g, w), f
    assert xp.out_key.dtype == np.int64 and np.array_equal(xp.out_key, rxp.out_key)
    n = xp.num_products
    assert (xp.num_slabs * 1024 == n) == (case == "unpadded")
    lv, rv = a.vals[xp.perm_csc], b.vals
    p = ee.expand_products(xp, torch.from_numpy(lv), torch.from_numpy(rv))
    rp = np.asarray(ref_ee.expand_products(rxp, jnp.asarray(lv), jnp.asarray(rv)))
    assert p.shape == (xp.num_slabs * 1024,) and p.dtype == torch.float32
    assert np.array_equal(p[:n].numpy(), rp[:n]) and not p[n:].any()
    arrs = ee.expand_device_arrays(xp, "cpu")
    assert torch.equal(ee._expand_torch(torch.from_numpy(lv), torch.from_numpy(rv),
                                        arrs["lv_lane"], arrs["rv_lane"], arrs["lv_off"],
                                        arrs["rv_off"], num_products=n), p)


def test_plan_expand_kmajor_empty_product():
    a = CsrMatrix.from_coo(3, 4, [0, 2], [3, 3], np.ones(2, np.float32))
    b = CsrMatrix.from_coo(4, 3, [0, 1], [0, 1], np.ones(2, np.float32))
    assert ee.plan_expand_kmajor(a, b) is None
    assert ref_ee.plan_expand_kmajor(_ref(a), _ref(b)) is None
    with pytest.raises(ValueError, match="LHS cols"):
        ee.plan_expand_kmajor(a, a)


def _beyond_gates():
    """Products the reference sends to its gather engine: an int32 key
    overflow ((rows + 1) * cols >= 2^31) and a window wider than its
    _MAX_KW = 64 (a dense lhs column of 9,000 entries)."""
    rng = np.random.default_rng(24)
    wide_a = CsrMatrix.from_coo(70000, 300, rng.integers(0, 70000, 900),
                                rng.integers(0, 300, 900),
                                rng.standard_normal(900).astype(np.float32))
    wide_b = CsrMatrix.from_coo(300, 40000, rng.integers(0, 300, 900),
                                rng.integers(0, 40000, 900),
                                rng.standard_normal(900).astype(np.float32))
    dense_col = CsrMatrix.from_coo(9000, 2, np.arange(9000), np.zeros(9000, np.int64),
                                   rng.standard_normal(9000).astype(np.float32))
    short = CsrMatrix.from_coo(2, 3, [0, 0, 0, 1], [0, 1, 2, 1],
                               rng.standard_normal(4).astype(np.float32))
    return {"int32_key": (wide_a, wide_b), "window": (dense_col, short)}


@pytest.mark.parametrize("case", ["int32_key", "window"])
def test_expansion_beyond_the_reference_gates(case):
    a, b = _beyond_gates()[case]
    assert ref_ee.plan_expand_kmajor(_ref(a), _ref(b)) is None
    xp = ee.plan_expand_kmajor(a, b)
    assert xp is not None and xp.out_key.max() == a.rows * b.cols
    eng = ds.EscSpgemm(a, b, device="cpu", reduce="sort")
    assert eng.engine == "pallas"
    ref = ref_ds.EscSpgemm(_ref(a), _ref(b), reduce="sort")
    assert ref.engine == "xla_gather"
    _same_pattern_bounded(a, b, eng.multiply(), ref.multiply())


# ---------------------------------------------------------------------------
# the ESC engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("reduce", ["sort", "spmv", "auto"])
@pytest.mark.parametrize("engine", ["pallas", "xla"])
@pytest.mark.parametrize("case", ["uniform", "rect"])
def test_esc_spgemm_matches_reference(case, engine, reduce):
    a, b = _expand_pairs()[case]
    eng = ds.EscSpgemm(a, b, device="cpu", engine=engine, reduce=reduce)
    ref = ref_ds.EscSpgemm(_ref(a), _ref(b), engine=engine, reduce=reduce)
    assert eng.engine == ref.engine and eng.num_products == ref.num_products
    assert (eng._rspmv is None) == (ref._rspmv is None)
    c = eng.multiply()
    _same(c, ref.multiply(), values=False)
    _esc_bounded(eng, a, b, c)
    assert c.nnz() == int(ref.multiply_device().nnz)
    # fresh values with the same patterns, on either side
    rng = np.random.default_rng(25)
    nl = rng.standard_normal(a.nnz()).astype(np.float32)
    nr = rng.standard_normal(b.nnz()).astype(np.float32)
    a2 = CsrMatrix(a.rows, a.cols, nl, a.indices, a.offsets, is_sorted=True)
    b2 = CsrMatrix(b.rows, b.cols, nr, b.indices, b.offsets, is_sorted=True)
    _esc_bounded(eng, a2, b, ds.padded_to_host(eng.multiply_device(lhs_vals=nl)))
    _esc_bounded(eng, a, b2, ds.padded_to_host(eng.multiply_device(rhs_vals=torch.from_numpy(nr))))
    _esc_bounded(eng, a2, b2, ds.padded_to_host(eng.multiply_device(lhs_vals=nl, rhs_vals=nr)))


def test_esc_spgemm_padded_result_layout():
    a, b = _expand_pairs()["uniform"]
    eng = ds.EscSpgemm(a, b, device="cpu", reduce="sort")
    assert eng._padded
    p = eng.multiply_device()
    rp = ref_ds.EscSpgemm(_ref(a), _ref(b), reduce="sort").multiply_device()
    n = int(p.nnz)
    assert n == int(rp.nnz) and p.row.shape == rp.row.shape
    assert p.row.dtype == p.col.dtype == torch.int32 and p.nnz.dtype == torch.int32
    assert np.array_equal(p.row[:n].numpy(), np.asarray(rp.row)[:n])
    assert np.array_equal(p.col[:n].numpy(), np.asarray(rp.col)[:n])
    # the sentinel run and the tail: row == rows, value 0
    assert torch.all(p.row[n:] == a.rows) and not p.val[n:].any()


def test_esc_spgemm_unpadded_plan_keeps_its_last_entry():
    a, b = _expand_pairs()["unpadded"]
    eng = ds.EscSpgemm(a, b, device="cpu", reduce="sort")
    assert not eng._padded
    c = eng.multiply()
    assert c.nnz() == 64 * 32
    _same_pattern_bounded(a, b, c, ref_ds.EscSpgemm(_ref(a), _ref(b), reduce="sort").multiply())


def test_esc_spgemm_empty_product():
    a = CsrMatrix.from_coo(3, 4, [0, 2], [3, 3], np.ones(2, np.float32))
    b = CsrMatrix.from_coo(4, 3, [0, 1], [0, 1], np.ones(2, np.float32))
    eng = ds.EscSpgemm(a, b, device="cpu")
    assert eng.engine == "xla_gather" and eng.num_products == 0
    p = eng.multiply_device()
    assert int(p.nnz) == 0 and p.row.numel() == 0
    c = eng.multiply()
    assert c.nnz() == 0 and (c.rows, c.cols) == (3, 3)
    with pytest.raises(ValueError, match="expansion kernel unavailable"):
        ds.EscSpgemm(a, b, device="cpu", engine="pallas")
    with pytest.raises(ValueError, match="pallas expansion unavailable"):
        ref_ds.EscSpgemm(_ref(a), _ref(b), engine="pallas")
    with pytest.raises(ValueError, match="LHS cols"):
        ds.EscSpgemm(a, a, device="cpu")
    with pytest.raises(ValueError, match="reduce"):
        ds.EscSpgemm(a, b, device="cpu", reduce="scan")


def test_esc_spgemm_nonfinite_switch_and_pad_mask():
    rng = np.random.default_rng(167)
    r = rng.integers(0, 5, 24)
    c = rng.integers(0, 21, 24)
    key = np.unique(r * 21 + c)
    a = CsrMatrix.from_coo(5, 21, key // 21, key % 21, rng.standard_normal(len(key)))
    bv = rng.standard_normal(8)
    bv[3] = np.inf
    br = np.sort(rng.choice(21, 8, replace=False))
    b = CsrMatrix.from_coo(21, 1, br, np.zeros(8, np.int64), bv)
    e = ds.EscSpgemm(a, b, device="cpu", reduce="auto")
    re = ref_ds.EscSpgemm(_ref(a), _ref(b), reduce="auto")
    assert e._rspmv is None and re._rspmv is None
    got = e.multiply()
    want = re.multiply()
    _same(got, want, values=False)
    fin = np.isfinite(want.vals)
    assert np.array_equal(np.isfinite(got.vals), fin)
    np.testing.assert_allclose(got.vals[fin], want.vals[fin], rtol=1e-5, atol=1e-6)
    b2 = CsrMatrix.from_coo(21, 1, br, np.zeros(8, np.int64), np.where(np.isfinite(bv), bv, 7.0))
    e2 = ds.EscSpgemm(a, b2, device="cpu", reduce="spmv")
    assert e2._rspmv is not None
    c2 = e2.multiply()
    _same(c2, ref_ds.EscSpgemm(_ref(a), _ref(b2), reduce="spmv").multiply(), values=False)
    _esc_bounded(e2, _f32(a), _f32(b2), c2)


def test_spgemm_esc_device_and_expand_plan_match_reference():
    a, b = _expand_pairs()["rect"]
    plan = ds.expand_plan(a, b)
    for g, w in zip(plan, ref_ds.expand_plan(_ref(a), _ref(b))):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    da, db = DeviceCsr.from_host(a, device="cpu"), DeviceCsr.from_host(b, device="cpu")
    c = ds.padded_to_host(ds.spgemm_esc_device(da, db, host_pair=(a, b), device="cpu"))
    want = ref_ds.padded_to_host(ref_ds.spgemm_esc_device(
        RefDeviceCsr.from_host(_ref(a)), RefDeviceCsr.from_host(_ref(b)),
        plan=ref_ds.expand_plan(_ref(a), _ref(b))))
    _same_pattern_bounded(a, b, c, want)
    with pytest.raises(ValueError, match="need plan"):
        ds.spgemm_esc_device(da, db, device="cpu")


# ---------------------------------------------------------------------------
# the SpMV-reduce engines
# ---------------------------------------------------------------------------


def test_group_by_key_matches_reference():
    rng = np.random.default_rng(26)
    key = rng.integers(0, 500, 3000).astype(np.int64)
    sub = rng.permutation(3000)
    vals = rng.standard_normal(3000)
    for kw in ({}, dict(sub_order=sub, indices=sub, vals=vals)):
        s, r, c, n = ss._group_by_key(key, 37, 3000, **kw)
        rs, rr, rc, rn = ref_ss._group_by_key(key, 37, 3000, **kw)
        assert n == rn and np.array_equal(r, rr) and np.array_equal(c, rc)
        _fields_equal(s, rs)
    assert ss._group_by_key(np.zeros(0, np.int64), 4, 4)[0] is None


def test_reduce_spmv_drops_and_masks_padding():
    key = np.array([7, 3, 3, 12, 7], np.int64)
    pad = np.concatenate([key, np.full(3, 99, np.int64)])
    r = ss.ReduceSpmv(pad, 5, rows=4, cols=4, device="cpu")
    assert r.nnz_out == 3
    # non-finite garbage in the pad slots must not reach the outputs
    p = torch.tensor([1, 2, 3, 4, 5, np.nan, np.inf, -np.inf], dtype=torch.float32)
    out = r.reduce(p)
    rr = ref_ss.ReduceSpmv(pad.astype(np.int32), 5, rows=4, cols=4)
    rout = rr.reduce(jnp.asarray(p.numpy()))
    assert np.array_equal(out.row.numpy(), np.asarray(rout.row))
    assert np.array_equal(out.col.numpy(), np.asarray(rout.col))
    assert np.array_equal(out.val.numpy(), [5.0, 6.0, 4.0])
    assert int(out.nnz) == 3
    with pytest.raises(ValueError, match="int32"):
        ss.ReduceSpmv(np.zeros(4, np.int64), 4, rows=2, cols=2**31 + 5, device="cpu")


@pytest.mark.parametrize("fixed", ["lhs", "rhs"])
def test_fixed_side_spgemm_matches_reference(fixed):
    a, b = _rect(27, 50, 40, 300), _rect(28, 40, 45, 280)
    f = ss.FixedSideSpgemm(a, b, device="cpu", fixed=fixed)
    rf = ref_ss.FixedSideSpgemm(_ref(a), _ref(b), fixed=fixed)
    assert (f.num_products, f.nnz_out) == (rf.num_products, rf.nnz_out)
    assert np.array_equal(f.out_row_host, rf.out_row_host)
    assert np.array_equal(f.out_col_host, rf.out_col_host)
    c = f.multiply()
    _same(c, rf.multiply(), values=False)
    var = a if fixed == "rhs" else b
    _reduce_bounded(f, var.vals, c)
    if f.op.format not in _SCAN_FORMATS:
        _bounded(a, b, c)
    nv = np.random.default_rng(29).standard_normal(var.nnz()).astype(np.float32)
    _reduce_bounded(f, nv, f.multiply(nv))


def test_fixed_side_empty_and_bad_arguments():
    a = CsrMatrix.from_coo(3, 4, [0, 2], [3, 3], np.ones(2, np.float32))
    b = CsrMatrix.from_coo(4, 3, [0, 1], [0, 1], np.ones(2, np.float32))
    f = ss.FixedSideSpgemm(a, b, device="cpu")
    assert f.num_products == 0 and f.nnz_out == 0 and f.op.format == "zero"
    out = f.multiply()
    assert out.nnz() == 0 and (out.rows, out.cols) == (3, 3)
    with pytest.raises(ValueError, match="LHS cols"):
        ss.FixedSideSpgemm(a, a, device="cpu")
    with pytest.raises(ValueError, match="fixed"):
        ss.FixedSideSpgemm(a, b, device="cpu", fixed="both")


def test_galerkin_triple_product():
    """``P^T (A P)`` with P frozen: two FixedSide multiplies follow A's
    values; their result has the reference's pattern and is within the
    bound of each product."""
    rng = np.random.default_rng(30)
    a = _uniform(31, 120, 0.05)
    p = CsrMatrix.from_coo(120, 30, np.arange(120), np.arange(120) // 4,
                           rng.standard_normal(120).astype(np.float32))
    pt = p.transpose()
    ap = ss.FixedSideSpgemm(a, p, device="cpu", fixed="rhs")  # x = A.vals
    ap_m = ap.multiply()
    pap = ss.FixedSideSpgemm(pt, ap_m, device="cpu", fixed="lhs")  # x = (A P).vals
    rap = ref_ss.FixedSideSpgemm(_ref(a), _ref(p), fixed="rhs")
    rpap = ref_ss.FixedSideSpgemm(_ref(pt), rap.multiply(), fixed="lhs")
    c = pap.multiply()
    _same(ap_m, rap.multiply(), values=False)
    _same(c, rpap.multiply(), values=False)
    _reduce_bounded(ap, a.vals, ap_m)
    _reduce_bounded(pap, ap_m.vals, c)
    # A's values drift, the patterns stay: chain the two SpMVs
    nv = rng.standard_normal(a.nnz()).astype(np.float32)
    ap2 = ap.multiply(nv)
    _reduce_bounded(ap, nv, ap2)
    _reduce_bounded(pap, ap2.vals, pap.multiply(ap2.vals))
    want = pt.to_dense().astype(np.float64) @ (
        CsrMatrix(a.rows, a.cols, nv, a.indices, a.offsets, is_sorted=True).to_dense()
        .astype(np.float64) @ p.to_dense().astype(np.float64))
    got = pap.multiply(ap2.vals).to_dense()
    assert np.max(np.abs(got - want)) <= 1e-5 * max(1.0, float(np.abs(want).max()))


# ---------------------------------------------------------------------------
# device transpose, add, sub
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("sorted_rows", [True, False])
def test_device_ops_equal_host_forms(sorted_rows):
    a, b = _rect(32, 90, 110, 600), _rect(33, 90, 110, 500)
    if not sorted_rows:
        a = _unsorted(a, 34)
    b = CsrMatrix.from_coo(b.rows, b.cols, np.r_[b.row_ids(), a.row_ids()[:50]],
                           np.r_[b.indices, a.indices[:50]], np.r_[b.vals, a.vals[:50]])
    da, db = DeviceCsr.from_host(a, device="cpu"), DeviceCsr.from_host(b, device="cpu")
    t = ds.transpose_device(da).to_host()
    _fields_equal(t, CsrMatrix(a.cols, a.rows, a.transpose().vals, a.transpose().indices,
                               a.transpose().offsets, is_sorted=True))
    _fields_equal(ds.padded_to_host(ds.add_device(da, db)), a + b)
    diff = ds.padded_to_host(ds.sub_device(da, db))
    _fields_equal(diff, a - b)
    # the reference's device forms give the same arrays
    rda, rdb = RefDeviceCsr.from_host(_ref(a)), RefDeviceCsr.from_host(_ref(b))
    _fields_equal(diff, ref_ds.padded_to_host(ref_ds.sub_device(rda, rdb)))
    _fields_equal(t, ref_ds.transpose_device(rda).to_host())
    z = ds.padded_to_host(ds.sub_device(da, da))  # cancellation zeros stay
    assert z.nnz() == a.nnz() and not z.vals.any()
    with pytest.raises(ValueError, match="identical dimensions"):
        ds.add_device(da, DeviceCsr.from_host(a.transpose(), device="cpu"))


# ---------------------------------------------------------------------------
# spgemm_auto and A @ B
# ---------------------------------------------------------------------------


def test_matmul_on_default_device_matches_reference():
    a = _uniform(35, 200, 0.03)
    c = a @ a
    want = _ref(a) @ _ref(a)
    assert not c.is_sorted and c.is_sorted == want.is_sorted
    _same(c, want, values=False)
    _bounded(a, a, c)
    # the host engine's values are the reference's dict loop's
    _same(c, ref_sh.spgemm_hash_host(_ref(a), _ref(a), force_python=True))
    with pytest.raises(ValueError, match="LHS cols != RHS rows"):
        a @ CsrMatrix.new(7, 3)


def test_matmul_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    port_device._DEFAULT = "cuda"
    a = _uniform(36, 50, 0.05)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        a @ a
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        port_device.set_default_device("cuda")


def test_spgemm_auto_tiny_banded_stays_on_host(monkeypatch):
    a = poisson_2d_csr(8, dtype=np.float32)  # banded, 64 rows: host-tiny

    def boom(*_a, **_k):
        raise AssertionError("band convolution reached for a tiny product")

    monkeypatch.setattr(sd, "spgemm_dia", boom)
    c = sb.spgemm_auto(a, a, device="cpu")
    _same(c, ref_sb.spgemm_auto(_ref(a), _ref(a)))
    assert c.is_sorted
    _bounded(a, a, c)


def test_spgemm_auto_banded_takes_band_convolution(monkeypatch, tmp_path):
    # the shortcut fires once the host estimate clears the sync constant
    monkeypatch.setitem(autotune.DEFAULTS, "device_call_sync_s", 1e-12)
    path = tmp_path / "autotune.json"
    path.write_text(json.dumps({"device_call_sync_s": 1e-12}))
    monkeypatch.setenv("SPMX_AUTOTUNE_CACHE", str(path))
    ref_autotune.reset_cache()
    try:
        a = poisson_2d_csr(16, dtype=np.float32)
        for output_sorted in (True, False):
            c = sb.spgemm_auto(a, a, device="cpu", output_sorted=output_sorted)
            want = ref_sb.spgemm_auto(_ref(a), _ref(a), output_sorted=output_sorted)
            assert c.is_sorted == want.is_sorted == output_sorted
            _same(c, want, values=False)
            _bounded(a, a, c)
        assert try_dia_from_csr(a) is not None
        # a non-banded product on the CPU goes to the host engine
        u = _uniform(37, 150, 0.04)
        _same(sb.spgemm_auto(u, u, device="cpu"),
              ref_sh.spgemm_hash_host(_ref(u), _ref(u), output_sorted=True, force_python=True))
    finally:
        ref_autotune.reset_cache()


def test_spgemm_auto_one_entry_rows_fall_through():
    """An rhs with at most one entry per row: the reference's native column
    relabel; the port's host engine gives the same values within the bound
    and the pattern up to cancellation zeros."""
    a = _uniform(38, 160, 0.05)
    rng = np.random.default_rng(39)
    keep = rng.random(160) < 0.8
    r = np.flatnonzero(keep)
    p = CsrMatrix.from_coo(160, 40, r, rng.integers(0, 40, len(r)),
                           rng.standard_normal(len(r)).astype(np.float32))
    c = sb.spgemm_auto(a, p, device="cpu")
    want = ref_sb.spgemm_auto(_ref(a), _ref(p))
    _bounded(a, p, c)
    got_keys = set(zip(c.row_ids(), c.indices.tolist()))
    want_keys = set(zip(want.row_ids(), want.indices.tolist()))
    assert want_keys <= got_keys
    extra = [k for k in got_keys - want_keys]
    dense = c.to_dense()
    assert all(dense[i, j] == 0 for i, j in extra)


def test_spgemm_cost_estimates_match_reference(monkeypatch):
    monkeypatch.setattr("os.cpu_count", lambda: 4)
    for a, b in ((_uniform(40, 300, 0.02), _uniform(41, 300, 0.02)),
                 (_f32(corpus.blocked(np.random.default_rng(42), 512, 64, 0.05)),) * 2):
        got = sb.spgemm_cost_estimates(a, b)
        want = ref_sb.spgemm_cost_estimates(_ref(a), _ref(b))
        assert got.keys() == want.keys()
        for k in got:
            assert got[k] == pytest.approx(want[k], rel=1e-12), k
