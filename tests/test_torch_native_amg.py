"""The port's host library for AMG and the hash SpGEMM
(sparse_matrix_tpu_torch/native/host.py, native/src/spmx_host.cpp), each
routine against the port's plain version and the reference's native routine
(sparse_matrix_tpu/native/loader.py), on numpy-seeded inputs.

Tolerances: array-equal everywhere. Each routine is a copy of the
reference's C++ built with its g++ flags, so it equals the reference's
native routine bit for bit; the plain versions (the reference's numpy and
Python branches) make the same float64 or float32 operations in the same
order. The reference's routines run only where its library loaded in this
process (``ref_path``, ROADMAP C17: a concurrent first build can make it
fall back to its Python loops for good); there each test holds the port to
the reference's own fallback instead, so the file passes on either path.

Unsorted rows of the hash engine keep the table order of its linear-probe
tables (``h(k) = k * 107``, capacity twice the next power of two of the
row's exact nnz, at least 16), which ``utils.linprobe.LinProbeMap`` replays
independently; the SPA variant keeps first-appearance order, the dict
loop's.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401  (tests/conftest.py configures it)

from sparse_matrix_tpu import native as ref_native  # noqa: E402
from sparse_matrix_tpu.formats import csr as ref_csr  # noqa: E402
from sparse_matrix_tpu.ops import spgemm_block as ref_sb  # noqa: E402
from sparse_matrix_tpu.ops import spgemm_host as ref_sh  # noqa: E402
from sparse_matrix_tpu.solvers import amg as ref_amg  # noqa: E402
from sparse_matrix_tpu_torch.bench import corpus  # noqa: E402
from sparse_matrix_tpu_torch.formats.csr import CsrMatrix  # noqa: E402
from sparse_matrix_tpu_torch.native import host  # noqa: E402
from sparse_matrix_tpu_torch.ops import spgemm_block as sb  # noqa: E402
from sparse_matrix_tpu_torch.ops import spgemm_host as sh  # noqa: E402
from sparse_matrix_tpu_torch.solvers import amg  # noqa: E402
from sparse_matrix_tpu_torch.solvers.poisson import poisson_2d_csr  # noqa: E402
from sparse_matrix_tpu_torch.utils import autotune  # noqa: E402
from sparse_matrix_tpu_torch.utils.linprobe import LinProbeMap  # noqa: E402


@pytest.fixture(scope="module")
def ref_path():
    """``"native"`` if the reference's native library runs in this process,
    else ``"python"``; asked once, as its loader settles it once."""
    from sparse_matrix_tpu.native import loader

    return "native" if loader.native_available() else "python"


def _ref(m):
    return ref_csr.CsrMatrix(m.rows, m.cols, m.vals, m.indices, m.offsets,
                             is_sorted=m.is_sorted)


def _same(got, want, path=""):
    assert (got.rows, got.cols) == (want.rows, want.cols)
    for f in ("offsets", "indices", "vals"):
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f"{f}; reference path: {path}")


def _sym_dense(rng, n, dens, dtype):
    d = (rng.random((n, n)) < dens) * rng.standard_normal((n, n))
    d = d + d.T + 4.0 * np.eye(n)
    r, c = np.nonzero(d)
    return CsrMatrix.from_coo(n, n, r, c, d[r, c].astype(dtype))


def _matrix(kind, dtype=np.float32):
    rng = np.random.default_rng(5)
    if kind == "poisson":
        return poisson_2d_csr(24, dtype=dtype)
    if kind == "femlike":
        f = corpus.fem_like(rng, 20, 1)
        f = f + f.transpose()
        d = corpus.with_dominant_diagonal(f)
        return CsrMatrix(d.rows, d.cols, d.vals.astype(dtype), d.indices, d.offsets,
                         is_sorted=True)
    n, dens = {"sparse97": (97, 0.06), "sparse200": (200, 0.02), "diag64": (64, 0.0)}[kind]
    return _sym_dense(rng, n, dens, dtype)


KINDS = ["poisson", "femlike", "sparse97", "sparse200", "diag64"]


# -- aggregation -----------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_aggregation_passes_match_plain_and_reference(kind, ref_path):
    m = _matrix(kind)
    so, si = amg.strength_graph(m)
    n = m.rows
    got, plain = np.full(n, -1, np.int64), np.full(n, -1, np.int64)
    na = host.aggregate_pass_native(1, so, si, got)
    assert na == amg._aggregate_pass_python(1, so, si, plain)
    np.testing.assert_array_equal(got, plain)
    assert host.aggregate_pass_native(2, so, si, got) == amg._aggregate_pass_python(
        2, so, si, plain)
    np.testing.assert_array_equal(got, plain)
    na3 = host.aggregate_pass_native(3, so, si, got, na)
    assert na3 == amg._aggregate_pass_python(3, so, si, plain, na)
    np.testing.assert_array_equal(got, plain)
    assert (got >= 0).all() and got.max() == na3 - 1
    # the whole clustering against the reference's (native, or its loops)
    agg, n_agg = amg.aggregate_strong(n, so, si)
    ref_agg, ref_na = ref_amg.aggregate_strong(n, so, si)
    assert n_agg == ref_na == na3, ref_path
    np.testing.assert_array_equal(agg, ref_agg, err_msg=ref_path)
    np.testing.assert_array_equal(agg, got)


def test_aggregation_rejects_bad_graphs():
    agg = np.full(4, -1, np.int64)
    with pytest.raises(ValueError, match="out of range"):
        host.aggregate_pass_native(1, np.array([0, 1, 1, 1, 1]), np.array([7]), agg)
    with pytest.raises(TypeError, match="int64"):
        host.aggregate_pass_native(1, np.zeros(5, np.int64), np.zeros(0, np.int64),
                                   np.full(4, -1, np.int32))


# -- strength, diagonal, scaling, smoother ---------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["poisson", "femlike", "sparse97"])
def test_strength_and_diag_abssum_match(kind, dtype, ref_path):
    m = _matrix(kind, dtype)
    if kind == "sparse97":  # a zero diagonal: the row-max rule
        vals = m.vals.copy()
        vals[(m.indices.astype(np.int64) == m.row_ids()) & (m.row_ids() == 5)] = 0
        m = CsrMatrix(m.rows, m.cols, vals, m.indices, m.offsets, is_sorted=True)
    got = host.amg_strength_native(m.rows, m.offsets, m.indices, m.vals, 0.08)
    plain = amg._strength_numpy(m.rows, m.offsets, m.indices, m.vals, 0.08)
    for g, p in zip(got, plain):
        np.testing.assert_array_equal(g, p)
    # the Gershgorin bound amg_coarsen takes from abssum: the plain form's
    dinv = np.where(got[0] != 0, 1.0 / np.where(got[0] == 0, 1.0, got[0]), 1.0)
    assert float(np.max(got[1] * np.abs(dinv))) == amg._lambda_max_dinv_a(m, dinv)
    if ref_path == "native":
        want = ref_native.amg_strength_native(m.rows, m.offsets, m.indices, m.vals, 0.08)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    so, si = ref_amg.strength_graph(_ref(m), 0.08)
    np.testing.assert_array_equal(got[2], so, err_msg=ref_path)
    np.testing.assert_array_equal(got[3], si, err_msg=ref_path)
    # magnitudes past 1e150 take the numpy sweep, as in the reference
    big = CsrMatrix(m.rows, m.cols, m.vals.astype(np.float64) * 1e200, m.indices, m.offsets,
                    is_sorted=True)
    assert host.amg_strength_native(big.rows, big.offsets, big.indices, big.vals, 0.08) is None
    so_b, si_b = amg.strength_graph(big)
    want_b = ref_amg.strength_graph(_ref(big))
    np.testing.assert_array_equal(so_b, want_b[0])
    np.testing.assert_array_equal(si_b, want_b[1])


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_scale_rows_and_jacobi_smoother_match(dtype, ref_path):
    m = _matrix("femlike", dtype)
    rng = np.random.default_rng(7)
    s = rng.random(m.rows) + 0.5
    got = host.scale_rows_native(m.rows, m.offsets, m.vals, s)
    np.testing.assert_array_equal(got, amg._scale_rows_numpy(m.rows, m.offsets, m.vals, s))
    np.testing.assert_array_equal(amg._scale_rows(m, s).vals, got)
    want = ref_amg._scale_rows(_ref(m), s).vals
    np.testing.assert_array_equal(got, want, err_msg=ref_path)

    ws = rng.random(m.rows)
    got = host.jacobi_smoother_native(m.rows, m.offsets, m.indices, m.vals, ws)
    np.testing.assert_array_equal(
        got, amg._jacobi_smoother_numpy(m.rows, m.offsets, m.indices, m.vals, ws))
    np.testing.assert_array_equal(got, ref_amg._jacobi_smoother_matrix(_ref(m), ws).vals,
                                  err_msg=ref_path)
    # a row without an explicit diagonal: False, the reference's meaning
    keep = ~((m.indices.astype(np.int64) == m.row_ids()) & (m.row_ids() == 3))
    cut = CsrMatrix.from_coo(m.rows, m.cols, m.row_ids()[keep], m.indices[keep],
                             m.vals[keep])
    assert host.jacobi_smoother_native(cut.rows, cut.offsets, cut.indices, cut.vals,
                                       ws) is False
    assert amg._jacobi_smoother_numpy(cut.rows, cut.offsets, cut.indices, cut.vals,
                                      ws) is False
    assert amg._jacobi_smoother_matrix(cut, ws) is None
    assert ref_amg._jacobi_smoother_matrix(_ref(cut), ws) is None
    if ref_path == "native":
        assert ref_native.jacobi_smoother_native(cut.rows, cut.offsets, cut.indices,
                                                 cut.vals, ws) is False


# -- colmap products -------------------------------------------------------


def _tentative(m, dtype):
    so, si = amg.strength_graph(m)
    agg, na = amg.aggregate_strong(m.rows, so, si)
    return amg.tentative_prolongator(agg, na, dtype=dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_colmap_products_match(dtype, ref_path):
    a = _matrix("poisson", dtype)
    t = _tentative(a, dtype)
    got = host.colmap_spgemm_native(a, t)
    _same(got, sh._colmap_spgemm_python(a, t))
    if ref_path == "native":
        _same(got, ref_native.colmap_spgemm_native(_ref(a), _ref(t)))
    ws = 0.7 / np.abs(a.vals).max() * (1.0 + 0.01 * np.arange(a.rows))
    got = host.colmap_smoothed_native(a, ws, t)
    _same(got, amg._colmap_smoothed_python(a, ws, t))
    # the fused pass equals the smoother matrix times T through the colmap
    _same(got, host.colmap_spgemm_native(amg._jacobi_smoother_matrix(a, ws), t))
    if ref_path == "native":
        _same(got, ref_native.colmap_smoothed_native(_ref(a), ws, _ref(t)))

    # rows without an explicit diagonal take the identity's term; an empty
    # row of T drops its terms
    rng = np.random.default_rng(3)
    n = 24
    dense = (rng.random((n, n)) < 0.2) * rng.standard_normal((n, n))
    dense[np.arange(0, n, 3), np.arange(0, n, 3)] = 0.0
    r, c = np.nonzero(dense)
    a2 = CsrMatrix.from_coo(n, n, r, c, dense[r, c].astype(dtype))
    agg = rng.integers(0, 5, n)
    t2 = amg.tentative_prolongator(agg.astype(np.int64), 5, dtype=dtype)
    keep = np.arange(n) != 7
    t2 = CsrMatrix.from_coo(n, 5, np.flatnonzero(keep), t2.indices[keep], t2.vals[keep])
    ws2 = rng.random(n)
    got = host.colmap_smoothed_native(a2, ws2, t2)
    _same(got, amg._colmap_smoothed_python(a2, ws2, t2))
    if ref_path == "native":
        _same(got, ref_native.colmap_smoothed_native(_ref(a2), ws2, _ref(t2)))
    td = t2.to_dense().astype(np.float64)
    want = (np.eye(n) - np.diag(ws2) @ dense) @ td
    tol = 1e-12 if dtype == np.float64 else 1e-5
    np.testing.assert_allclose(got.to_dense(), want, rtol=tol, atol=tol)
    _same(host.colmap_spgemm_native(a2, t2), sh._colmap_spgemm_python(a2, t2))


def test_colmap_preconditions_return_none():
    a = _matrix("poisson", np.float32)
    two = CsrMatrix.from_coo(a.rows, 3, [0, 0], [0, 1], np.ones(2, np.float32))
    assert host.colmap_spgemm_native(a, two) is None
    assert sh._colmap_spgemm_python(a, two) is None
    assert host.colmap_smoothed_native(a, np.ones(a.rows), two) is None
    assert amg._colmap_smoothed_python(a, np.ones(a.rows), two) is None
    ai = CsrMatrix(a.rows, a.cols, a.vals.astype(np.int64), a.indices, a.offsets,
                   is_sorted=True)
    t = _tentative(a, np.int64)
    assert host.colmap_spgemm_native(ai, t) is None
    rect = CsrMatrix.from_coo(4, 5, [0, 1], [0, 4], np.ones(2, np.float32))
    assert host.colmap_smoothed_native(rect, np.ones(4), _tentative(a, np.float32)) is None


# -- the hash engine -------------------------------------------------------


def _operands(engine, dtype):
    """(lhs, rhs) whose product takes the SPA variant (dense enough) or the
    hash tables (fewer products than a quarter of rhs's columns)."""
    rng = np.random.default_rng(11)
    if engine == "spa":
        a = corpus.random_uniform(rng, 300, 0.03)
        b = corpus.random_uniform(rng, 300, 0.03)
    else:
        a = CsrMatrix.from_coo(120, 200, rng.integers(0, 120, 600),
                               rng.integers(0, 200, 600), rng.standard_normal(600))
        b = CsrMatrix.from_coo(200, 40_000, rng.integers(0, 200, 1500),
                               rng.integers(0, 300, 1500) * 131, rng.standard_normal(1500))

    def cast(m):
        v = m.vals
        v = (np.round(v * 8)).astype(np.int64) if dtype == np.int64 else v.astype(dtype)
        return CsrMatrix(m.rows, m.cols, v, m.indices, m.offsets, is_sorted=True)

    return cast(a), cast(b)


def _table_order(lhs, rhs, c):
    """``c``'s rows in the order of the engine's hash tables, replayed with
    ``LinProbeMap`` sized from each row's exact nnz."""
    idx = []
    for i in range(lhs.rows):
        nz = int(c.offsets[i + 1] - c.offsets[i])
        if nz == 0:
            continue
        t = LinProbeMap(nz)
        for p in range(lhs.offsets[i], lhs.offsets[i + 1]):
            k = int(lhs.indices[p])
            for q in range(rhs.offsets[k], rhs.offsets[k + 1]):
                t.upsert(int(rhs.indices[q]), 0, lambda x, y: x)
        idx.extend(k for k, _ in t.drain())
    return np.asarray(idx, dtype=np.uint32)


@pytest.mark.parametrize("output_sorted", [False, True])
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int64])
@pytest.mark.parametrize("engine", ["hash", "spa"])
def test_hash_engine_matches_reference(engine, dtype, output_sorted, ref_path):
    a, b = _operands(engine, dtype)
    flops = int(sh.flops_per_row(a, b).sum())
    assert (flops >= b.cols // 4) == (engine == "spa")
    c1 = host.spgemm_hash_native(a, b, output_sorted=output_sorted, num_threads=1)
    c4 = host.spgemm_hash_native(a, b, output_sorted=output_sorted, num_threads=4)
    _same(c4, c1)
    assert c1.is_sorted == output_sorted
    _same(sh.spgemm_hash_host(a, b, output_sorted=output_sorted), c1)
    if ref_path == "native":
        for nt in (1, 4):
            _same(c1, ref_native.spgemm_hash_native(_ref(a), _ref(b),
                                                    output_sorted=output_sorted,
                                                    num_threads=nt))
    # the dict loop: the same values; its row order where SPA keeps
    # first-appearance order, or with sorted rows
    loop = sh._spgemm_hash_python(a, b, output_sorted=output_sorted)
    np.testing.assert_array_equal(c1.offsets, loop.offsets)
    if output_sorted or engine == "spa":
        _same(c1, loop)
        _same(c1, ref_sh.spgemm_hash_host(_ref(a), _ref(b), output_sorted=output_sorted,
                                          force_python=True))
    else:
        np.testing.assert_array_equal(c1.indices, _table_order(a, b, c1))
        order = np.lexsort((c1.indices.astype(np.int64), c1.row_ids()))
        _same(CsrMatrix(c1.rows, c1.cols, c1.vals[order], c1.indices[order], c1.offsets,
                        is_sorted=True),
              sh._spgemm_hash_python(a, b, output_sorted=True))
    # the vectorized plain version: the same values, rows sorted
    _same(sh._spgemm_hash_numpy(a, b, output_sorted=True),
          sh._spgemm_hash_python(a, b, output_sorted=True))


def test_hash_engine_probe_histograms(monkeypatch):
    from sparse_matrix_tpu_torch.utils import debugflags

    a, b = _operands("hash", np.float32)
    monkeypatch.setattr(debugflags, "_DEBUG", True)
    debugflags.clear_histograms()
    try:
        c = host.spgemm_hash_native(a, b)
        h = debugflags.get_histograms()
        lookups = int(sh.flops_per_row(a, b).sum())
        assert sum(h["native_probe_numeric"].values()) == lookups
        assert sum(h["native_probe_symbolic"].values()) == lookups
        assert sum(h["native_row_nz"].values()) == a.rows
        debugflags.clear_histograms()
        loop = sh._spgemm_hash_python(a, b, output_sorted=False)
        h = debugflags.get_histograms()
        assert sum(h["spgemm.numeric.probe_lengths"].values()) == lookups
        assert sum(h["spgemm.symbolic.row_nz"].values()) == a.rows
        assert sum(k * v for k, v in h["spgemm.plan.row_nz"].items()) == lookups
        assert loop.nnz() == c.nnz()
    finally:
        debugflags.clear_histograms()


def test_flops_per_row_native_matches_numpy():
    a, b = _operands("spa", np.float32)
    np.testing.assert_array_equal(sh.flops_per_row(a, b), sh._flops_per_row_numpy(a, b))
    np.testing.assert_array_equal(sh.flops_per_row(a, b),
                                  ref_sh.flops_per_row(_ref(a), _ref(b)))
    with pytest.raises(ValueError, match="LHS cols"):
        host.flops_per_row_native(a, CsrMatrix.new(7, 3))
    def half(m):
        return CsrMatrix(m.rows, m.cols, m.vals.astype(np.float16), m.indices, m.offsets,
                         is_sorted=True)

    with pytest.raises(TypeError, match="float16"):
        host.spgemm_hash_native(half(a), half(b))


# -- spgemm_auto: the colmap shortcut (ROADMAP C20) ------------------------


def test_spgemm_auto_takes_colmap_first(monkeypatch, ref_path):
    """An rhs with at most one entry per row goes to the column relabel
    before every other rule, as in the reference. Banded x diagonal past the
    host-tiny threshold used to take band convolution, whose CSR drops
    computed zeros: here the diagonal holds explicit zeros, whose products
    the relabel keeps as explicit entries of A's pattern."""
    monkeypatch.setitem(autotune.DEFAULTS, "device_call_sync_s", 1e-12)
    a = poisson_2d_csr(16, dtype=np.float32)
    rng = np.random.default_rng(17)
    d = rng.standard_normal(a.rows).astype(np.float32)
    d[::5] = 0.0
    diag = CsrMatrix(a.rows, a.rows, d, np.arange(a.rows, dtype=np.uint32),
                     np.arange(a.rows + 1, dtype=np.int64), is_sorted=True)
    assert sb.spgemm_auto_engine(a, diag, device="cpu") == "colmap"
    for output_sorted in (True, False):
        c = sb.spgemm_auto(a, diag, device="cpu", output_sorted=output_sorted)
        # A's pattern whole, each entry a_ij * d_j, computed zeros kept
        np.testing.assert_array_equal(c.offsets, a.offsets)
        np.testing.assert_array_equal(c.indices, a.indices)
        np.testing.assert_array_equal(c.vals, a.vals * d[a.indices.astype(np.int64)])
        assert c.is_sorted and np.count_nonzero(c.vals == 0) > 0
        if ref_path == "native":
            _same(c, ref_sb.spgemm_auto(_ref(a), _ref(diag), output_sorted=output_sorted))
    # more than one entry in a row of rhs: the other rules, as before
    two = CsrMatrix.from_coo(a.rows, a.rows, [0, 0], [0, 1], np.ones(2, np.float32))
    assert sb.spgemm_auto_engine(a, two, device="cpu") != "colmap"


# -- a missing or broken library raises ------------------------------------


def test_missing_library_raises(monkeypatch, tmp_path):
    import shutil

    monkeypatch.setattr(host, "_LIB", None)
    monkeypatch.setattr(host, "LIB", tmp_path / "libmissing.so")
    monkeypatch.setattr(shutil, "which", lambda _name: None)
    with pytest.raises(RuntimeError, match="g.. not found"):
        host.hardware_threads()
    monkeypatch.undo()

    # a library without the AMG symbols: loading it raises, nothing falls back
    src = tmp_path / "partial.cpp"
    src.write_text('extern "C" int spmx_hardware_threads() { return 1; }\n')
    monkeypatch.setattr(host, "_LIB", None)
    monkeypatch.setattr(host, "SRC", src)
    monkeypatch.setattr(host, "LIB", tmp_path / "libpartial.so")
    monkeypatch.setattr(host, "BUILD_DIR", tmp_path)
    with pytest.raises(AttributeError, match="spmx_"):
        host.amg_strength_native(4, np.arange(5), np.arange(4), np.ones(4), 0.08)
    assert host._LIB is None
    # a source that does not compile
    src.write_text("this is not C++\n")
    monkeypatch.setattr(host, "LIB", tmp_path / "libbroken.so")
    with pytest.raises(RuntimeError, match="g.. failed"):
        amg.aggregate_strong(4, np.zeros(5, np.int64), np.zeros(0, np.int64))
