"""Port parity for the IC/ILU path: the host factorizations, the fused
triangular sweep's plain version, TriangularJacobi, and IC-PCG, BiCGSTAB
and GMRES with ILU preconditioners (sparse_matrix_tpu_torch/solvers/ilu.py,
bicgstab.py, gmres.py, ops/trisweep.py, native/host.py).

The same inputs, made from a numpy seed, go through the JAX package and the
port (the reference's CSR is built over the port's arrays). Tolerances:

* factors and exact solves: array-equal to the reference's on the path the
  reference took in this process (``ref_path``): its native library, held
  to the port's host library (the same C++ built with the same g++ flags),
  or its Python loops, held to the port's copies of them
  (``_ilu0_python``, ``_ilut_python``, ``_trisolve_python``: the same
  numpy scalar operations in the same order, so equal bits). The reference
  falls back to its loops for good when its library fails to load: under
  ``SPMX_NO_NATIVE=1``, or when a concurrent test process is still writing
  the library it builds at first use. Each assertion names the path;
* the port's library against its own Python loops within 1e-12 (f64) and
  1e-6 (f32) of the largest magnitude (the compiler may contract a
  multiply and a subtract that numpy rounds apart, and a few f32 entries
  cancel);
* the plain trisweep against the reference's ``trisweep()`` (its
  ``_trisweep_xla`` on the CPU): within 4 float32 ulps of the largest
  magnitude of the reference's result (XLA may contract a multiply and an
  add that PyTorch rounds apart, so entries that cancel differ by more ulps
  of their own), and both within the float64 running bound of
  ``trisweep_f64_bound``;
* TriangularJacobi against the reference's: rtol 1e-6, atol 1e-7;
* solvers: iterations within +-2 of the reference's and ``|x - x_ref| <=
  1e-4 |x_ref|``, as in test_torch_cg.py (the JAX package runs in float32
  here, so both run in float32).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sparse_matrix_tpu.formats import csr as ref_csr  # noqa: E402
from sparse_matrix_tpu.formats import dia as ref_dia  # noqa: E402
from sparse_matrix_tpu.ops import operator as ref_op  # noqa: E402
from sparse_matrix_tpu.ops import trisweep as ref_tw  # noqa: E402
from sparse_matrix_tpu.solvers import bicgstab as ref_bicgstab  # noqa: E402
from sparse_matrix_tpu.solvers import gmres as ref_gmres  # noqa: E402
from sparse_matrix_tpu.solvers import ilu as ref_ilu  # noqa: E402
from sparse_matrix_tpu_torch.formats.csr import CsrMatrix  # noqa: E402
from sparse_matrix_tpu_torch.formats.dia import DiaMatrix, try_dia_from_csr  # noqa: E402
from sparse_matrix_tpu_torch.native import host  # noqa: E402
from sparse_matrix_tpu_torch.ops import trisweep as tw  # noqa: E402
from sparse_matrix_tpu_torch.ops.operator import SpmvOperator  # noqa: E402
from sparse_matrix_tpu_torch.solvers import ilu  # noqa: E402
from sparse_matrix_tpu_torch.solvers.bicgstab import bicgstab_solve  # noqa: E402
from sparse_matrix_tpu_torch.solvers.gmres import gmres_solve  # noqa: E402
from sparse_matrix_tpu_torch.solvers.poisson import poisson_2d_csr  # noqa: E402


def _ref(m):
    """The reference's CsrMatrix over the same arrays."""
    return ref_csr.CsrMatrix(m.rows, m.cols, m.vals, m.indices, m.offsets,
                             is_sorted=m.is_sorted)


def _csr(d):
    r, c = np.nonzero(d)
    return CsrMatrix.from_coo(d.shape[0], d.shape[1], r, c, d[r, c])


def _spd_dense(rng, n, dens=0.08):
    """The reference tests' strictly diagonally dominant symmetric matrix."""
    m = (rng.random((n, n)) < dens) * rng.standard_normal((n, n))
    m = (m + m.T) / 2
    np.fill_diagonal(m, np.abs(m).sum(axis=1) + 1.0)
    return m


def _unsym_dense(rng, n, shift, dens=0.03):
    """The reference tests' unsymmetric dominant matrix (tests/test_ilu.py:214)."""
    d = (rng.random((n, n)) < dens) * rng.standard_normal((n, n))
    np.fill_diagonal(d, np.abs(d).sum(axis=1) + shift)
    return d


def _same_csr(got, want, path=""):
    for f in ("offsets", "indices", "vals"):
        np.testing.assert_array_equal(getattr(got, f), np.asarray(getattr(want, f)),
                                      err_msg=f"{f}; reference path: {path}")


@pytest.fixture(scope="module")
def ref_path():
    """``"native"`` if the reference's ILU routines run its native library in
    this process, else ``"python"`` (its Python loops). Asked once: the
    reference's loader settles the answer at its first call."""
    from sparse_matrix_tpu.native import loader

    return "native" if loader.native_available() else "python"


def _ilu0_python_binding(rows, cols, offsets, indices, vals, diag_pos):
    """``host.ilu0_native``'s signature over the port's Python loop."""
    return ilu._ilu0_python(rows, offsets, indices.astype(np.int64), vals, diag_pos)


def _on_ref_path(path, monkeypatch):
    """Make the port's ILU(0) and IC(0) take the path the reference took:
    its host library, or (``"python"``) its own Python loop in the
    library's place."""
    if path == "python":
        monkeypatch.setattr(host, "ilu0_native", _ilu0_python_binding)


def _ilut_on(path, a, **kw):
    return ilu.ilut(a, **kw) if path == "native" else ilu._ilut_python(a, **kw)


def _trisolve_on(path, t, b, **kw):
    return (ilu.trisolve_host if path == "native" else ilu._trisolve_python)(t, b, **kw)


def _matrix(kind, dtype):
    rng = np.random.default_rng(0)
    if kind == "poisson":
        return poisson_2d_csr(12, dtype=dtype)
    n, dens = {"spd7": (7, 0.08), "spd40": (40, 0.08), "spd120": (120, 0.08),
               "dense30": (30, 1.0)}[kind]
    return _csr(_spd_dense(rng, n, dens).astype(dtype))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("kind", ["spd7", "spd40", "spd120", "dense30", "poisson"])
def test_ilu0_and_ic0_match_reference(kind, dtype, ref_path, monkeypatch):
    a = _matrix(kind, dtype)
    rf, rc = ref_ilu.ilu0(_ref(a)), ref_ilu.ic0(_ref(a))
    _on_ref_path(ref_path, monkeypatch)
    f = ilu.ilu0(a)
    _same_csr(f.l, rf.l, ref_path)
    _same_csr(f.u, rf.u, ref_path)
    _same_csr(ilu.ic0(a), rc, ref_path)


@pytest.mark.parametrize("tau,p", [(1e-3, 6), (0.0, 40), (1e-1, 3)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_ilut_matches_reference(dtype, tau, p, ref_path):
    a = _csr(_spd_dense(np.random.default_rng(21), 40, 0.3).astype(dtype))
    f, rf = _ilut_on(ref_path, a, tau=tau, p=p), ref_ilu.ilut(_ref(a), tau=tau, p=p)
    _same_csr(f.l, rf.l, ref_path)
    _same_csr(f.u, rf.u, ref_path)


def _close(got, want, dtype):
    """``|got - want| <= rel * max|want|``, rel 1e-12 (f64) or 1e-6 (f32)."""
    rel = 1e-12 if dtype == np.float64 else 1e-6
    assert np.max(np.abs(got - want)) <= rel * np.max(np.abs(want))


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_host_library_matches_python_loops(dtype):
    rng = np.random.default_rng(1)
    a = _csr(_spd_dense(rng, 60, 0.15).astype(dtype))
    dp = ilu._diag_positions(a)
    v_lib, v_py = a.vals.copy(), a.vals.copy()
    assert host.ilu0_native(a.rows, a.cols, a.offsets, a.indices, v_lib, dp) == -1
    assert ilu._ilu0_python(a.rows, a.offsets, a.indices.astype(np.int64), v_py, dp) == -1
    _close(v_lib, v_py, dtype)
    f, fp = ilu.ilut(a, tau=1e-3, p=6), ilu._ilut_python(a, tau=1e-3, p=6)
    for got, want in ((f.l, fp.l), (f.u, fp.u)):
        _close(got.to_dense(), want.to_dense(), dtype)
    lu = ilu.ilu0(a)
    b = rng.standard_normal(a.rows)
    for t, lower, unit in ((lu.l, True, True), (lu.u, False, False), (lu.l, True, False)):
        _close(ilu.trisolve_host(t, b, lower=lower, unit=unit),
               ilu._trisolve_python(t, b, lower=lower, unit=unit), dtype)


def test_zero_pivots_and_validation_raise():
    z = _csr(np.array([[0.0, 1.0], [1.0, 1.0]]))
    for fn in (ilu.ilu0, ilu.ilut):
        with pytest.raises(ValueError, match="zero pivot in row 0"):
            fn(z)
    with pytest.raises(ValueError, match="zero pivot in row 0"):
        ilu._ilut_python(z)
    assert ilu._ilu0_python(2, z.offsets, z.indices.astype(np.int64), z.vals.copy(),
                            ilu._diag_positions(z)) == 0
    with pytest.raises(ValueError, match="non-positive pivot"):
        ilu.ic0(_csr(np.array([[1.0, 2.0], [2.0, 1.0]])))
    with pytest.raises(ValueError, match="square"):
        ilu.ilu0(_csr(np.ones((2, 3))))
    with pytest.raises(ValueError, match="p >= 1"):
        ilu.ilut(poisson_2d_csr(4), p=0)
    # upper triangular with a stored zero pivot in row 1
    upper = CsrMatrix(2, 2, np.array([1.0, 2.0, 0.0]), np.array([0, 1, 1]),
                      np.array([0, 2, 3]), is_sorted=True)
    for fn in (ilu.trisolve_host, ilu._trisolve_python):
        with pytest.raises(ValueError, match="zero pivot in row 1"):
            fn(upper, np.ones(2), lower=False)
    a = poisson_2d_csr(4)
    with pytest.raises(ValueError, match="offsets"):
        host.ilu0_native(a.rows, a.cols, a.offsets[:-1], a.indices, a.vals.copy(),
                         ilu._diag_positions(a))
    with pytest.raises(ValueError, match="out of range"):
        host.ilu0_native(a.rows, a.cols - 1, a.offsets, a.indices, a.vals.copy(),
                         ilu._diag_positions(a))
    with pytest.raises(TypeError, match="float32 and float64"):
        host.ilu0_native(a.rows, a.cols, a.offsets, a.indices, a.vals.astype(np.float16),
                         ilu._diag_positions(a))


def test_host_build_without_gxx_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(host.shutil, "which", lambda name: None)
    monkeypatch.setattr(host, "LIB", tmp_path / "missing.so")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        host.build()


def test_trisolve_host_matches_reference(ref_path, monkeypatch):
    rng = np.random.default_rng(4)
    a = _csr(_spd_dense(rng, 90))
    rf = ref_ilu.ilu0(_ref(a))
    _on_ref_path(ref_path, monkeypatch)
    f = ilu.ilu0(a)
    b = rng.standard_normal(a.rows)
    msg = f"reference path: {ref_path}"
    y = _trisolve_on(ref_path, f.l, b, lower=True, unit=True)
    np.testing.assert_array_equal(y, ref_ilu.trisolve_host(rf.l, b, lower=True, unit=True),
                                  err_msg=msg)
    np.testing.assert_array_equal(_trisolve_on(ref_path, f.u, y, lower=False),
                                  ref_ilu.trisolve_host(rf.u, y, lower=False), err_msg=msg)


def _strict_dia(t):
    """The strict part of a triangular factor in the port's and the
    reference's DIA form (float32 planes)."""
    rid, cid = t.row_ids(), t.indices.astype(np.int64)
    s = cid != rid
    n = CsrMatrix.from_coo(t.rows, t.cols, rid[s], cid[s], t.vals[s].astype(np.float32))
    d = try_dia_from_csr(n, dtype=np.float32)
    return d, ref_dia.DiaMatrix(d.rows, d.cols, d.data, d.offsets)


@pytest.fixture(scope="module")
def ic_factor():
    return ilu.ic0(poisson_2d_csr(24, dtype=np.float32))  # 576 rows: fusable


@pytest.mark.parametrize("sweeps", [0, 1, 4])
@pytest.mark.parametrize("side", ["L", "LT"])
def test_trisweep_plain_matches_reference(ic_factor, side, sweeps):
    t = ic_factor if side == "L" else ic_factor.transpose()
    d, rd = _strict_dia(t)
    rng = np.random.default_rng(11)
    b = rng.standard_normal(t.rows).astype(np.float32)
    dinv = (1.0 / t.vals[ilu._diag_positions(t)].astype(np.float64)).astype(np.float32)
    plan = tw.plan_trisweep(d, t.rows, device="cpu")
    bt, dt = torch.from_numpy(b), torch.from_numpy(dinv)
    got = tw.trisweep(plan, bt, dt, sweeps=sweeps).numpy()
    want = np.asarray(ref_tw.trisweep(ref_tw.plan_trisweep(rd, t.rows), jnp.asarray(b),
                                      jnp.asarray(dinv), sweeps=sweeps))
    assert np.max(np.abs(got - want)) <= 4 * np.spacing(np.max(np.abs(want)))
    x64, bound = tw.trisweep_f64_bound(plan, bt, dt, sweeps=sweeps)
    for x in (got, want):
        assert np.all(np.abs(x - x64.numpy()) <= bound.numpy())


def test_trisweep_exact_after_depth_sweeps():
    """Nilpotency: depth(L) - 1 = 2 * 16 - 2 sweeps on Poisson 16^2's IC
    factor reproduce the exact host solve (rtol 2e-4, atol 2e-5, the
    reference's test_ilu.py tolerance), and stay within the f64 bound."""
    lc = ilu.ic0(poisson_2d_csr(16, dtype=np.float32))
    d, _ = _strict_dia(lc)
    b = np.random.default_rng(6).standard_normal(lc.rows).astype(np.float32)
    dinv = torch.from_numpy((1.0 / lc.vals[ilu._diag_positions(lc)]).astype(np.float32))
    plan = tw.plan_trisweep(d, lc.rows, device="cpu")
    x = tw.trisweep(plan, torch.from_numpy(b), dinv, sweeps=30).numpy()
    np.testing.assert_allclose(x, ilu.trisolve_host(lc, b.astype(np.float64), lower=True),
                               rtol=2e-4, atol=2e-5)
    x64, bound = tw.trisweep_f64_bound(plan, torch.from_numpy(b), dinv, sweeps=30)
    assert np.all(np.abs(x - x64.numpy()) <= bound.numpy())


@pytest.mark.parametrize("rhs", ["vector", "block3"])
@pytest.mark.parametrize("fused", [True, None])
@pytest.mark.parametrize("side", ["L", "LT"])
def test_triangular_jacobi_matches_reference(ic_factor, side, fused, rhs):
    t = ic_factor if side == "L" else ic_factor.transpose()
    rng = np.random.default_rng(12)
    b = rng.standard_normal((t.rows,) if rhs == "vector" else (t.rows, 3)).astype(np.float32)
    sj = ilu.TriangularJacobi(t, device="cpu", sweeps=4, fused=fused)
    assert (sj._fused is not None) == (fused is True)
    rj = ref_ilu.TriangularJacobi(_ref(t), sweeps=4, dtype=np.float32, fused=fused)
    np.testing.assert_allclose(sj(torch.from_numpy(b)).numpy(), np.asarray(rj(jnp.asarray(b))),
                               rtol=1e-6, atol=1e-7)


def test_plan_trisweep_gates(ic_factor):
    """rows < 128 gives no plan, fused=True then raises, the default and
    fused=False give none; a factor the reference refuses for its VMEM cap
    is planned by the port."""
    assert ilu.TriangularJacobi(ic_factor, device="cpu", sweeps=2)._fused is None
    assert ilu.TriangularJacobi(ic_factor, device="cpu", sweeps=2, fused=False)._fused is None
    tiny = ilu.ic0(poisson_2d_csr(8, dtype=np.float32))
    with pytest.raises(ValueError, match="not fusable"):
        ilu.TriangularJacobi(tiny, device="cpu", sweeps=2, fused=True)
    d, rd = _strict_dia(tiny)
    assert tw.plan_trisweep(d, tiny.rows, device="cpu") is None
    assert ref_tw.plan_trisweep(rd, tiny.rows) is None
    rows = 2_500_000  # (2 + 4) * rows * 4 B = 60 MB > the reference's 56 MB cap
    big = np.zeros((2, rows), np.float32)
    assert ref_tw.plan_trisweep(ref_dia.DiaMatrix(rows, rows, big, (-1000, -1)), rows) is None
    plan = tw.plan_trisweep(DiaMatrix(rows, rows, big, (-1000, -1)), rows, device="cpu")
    assert plan is not None and tuple(plan.data.shape) == (2, rows)


def test_trisweep_rejects_bad_inputs(ic_factor):
    d, _ = _strict_dia(ic_factor)
    plan = tw.plan_trisweep(d, ic_factor.rows, device="cpu")
    b = torch.ones(ic_factor.rows)
    with pytest.raises(ValueError, match="sweeps"):
        tw.trisweep(plan, b, b, sweeps=-1)
    with pytest.raises(ValueError, match="must be"):
        tw.trisweep(plan, b[:-1], b[:-1], sweeps=1)


def _same_solution(res, ref_res):
    x, x_ref = res.x.numpy().astype(np.float64), np.asarray(ref_res.x, np.float64)
    assert abs(res.iterations - int(ref_res.iterations)) <= 2
    assert np.linalg.norm(x - x_ref) <= 1e-4 * np.linalg.norm(x_ref)


@pytest.mark.parametrize("sweeps", [1, 6])
def test_ic_pcg_matches_reference(sweeps):
    a = poisson_2d_csr(32, dtype=np.float32)
    b = np.random.default_rng(8).standard_normal(a.rows).astype(np.float32)
    res = ilu.ic_pcg_solve(a, torch.from_numpy(b), device="cpu", sweeps=sweeps, tol=1e-5,
                           maxiter=2000)
    ref_res = ref_ilu.ic_pcg_solve(_ref(a), jnp.asarray(b), sweeps=sweeps, tol=1e-5,
                                   maxiter=2000)
    _same_solution(res, ref_res)
    assert float(res.residual_norm) <= 1e-5 * np.linalg.norm(b) * (1 + 1e-6)


@pytest.mark.parametrize("fused", [True, None])
def test_pcg_with_fused_ic_matches_loop_form(fused):
    """ic_preconditioner(fused=True) and the loop form give the same
    iterate sequence on the CPU (the same float32 operations in the same
    order): equal iterations, x within 1e-6 relative."""
    from sparse_matrix_tpu_torch.solvers.cg import pcg_solve

    a = poisson_2d_csr(24, dtype=np.float32)
    b = torch.from_numpy(np.random.default_rng(3).standard_normal(a.rows).astype(np.float32))
    op = SpmvOperator(a, device="cpu")
    loop = pcg_solve(op, b, ilu.ic_preconditioner(a, device="cpu", sweeps=2), tol=1e-5)
    res = pcg_solve(op, b, ilu.ic_preconditioner(a, device="cpu", sweeps=2, fused=fused),
                    tol=1e-5)
    assert res.iterations == loop.iterations
    assert float(torch.linalg.norm(res.x - loop.x)) <= 1e-6 * float(torch.linalg.norm(loop.x))


@pytest.mark.parametrize("precond", [None, "ilu0"])
def test_bicgstab_matches_reference(precond):
    rng = np.random.default_rng(9)
    d = _unsym_dense(rng, 200, 2.0).astype(np.float32)
    a = _csr(d)
    b = rng.standard_normal(200).astype(np.float32)
    m_inv = ref_m = None
    if precond:
        m_inv = ilu.ilu_preconditioner(a, device="cpu", sweeps=5, fused=True)
        ref_m = ref_ilu.ilu_preconditioner(_ref(a), sweeps=5)
    res = bicgstab_solve(SpmvOperator(a, device="cpu"), torch.from_numpy(b), tol=1e-6,
                         maxiter=400, m_inv=m_inv)
    ref_res = ref_bicgstab.bicgstab_solve(ref_op.SpmvOperator(_ref(a)), jnp.asarray(b),
                                          tol=1e-6, maxiter=400, m_inv=ref_m)
    _same_solution(res, ref_res)
    assert np.linalg.norm(d.astype(np.float64) @ res.x.numpy() - b) < 1e-5 * np.linalg.norm(b)


@pytest.mark.parametrize("precond", [None, "ilu0"])
def test_gmres_matches_reference(precond):
    rng = np.random.default_rng(10)
    d = _unsym_dense(rng, 300, 1.5).astype(np.float32)
    a = _csr(d)
    b = rng.standard_normal(300).astype(np.float32)
    m_inv = ref_m = None
    if precond:
        m_inv = ilu.ilu_preconditioner(a, device="cpu", sweeps=5)
        ref_m = ref_ilu.ilu_preconditioner(_ref(a), sweeps=5)
    res = gmres_solve(SpmvOperator(a, device="cpu"), torch.from_numpy(b), restart=6,
                      tol=1e-6, maxiter=600, m_inv=m_inv)
    ref_res = ref_gmres.gmres_solve(ref_op.SpmvOperator(_ref(a)), jnp.asarray(b), restart=6,
                                    tol=1e-6, maxiter=600, m_inv=ref_m)
    _same_solution(res, ref_res)
    assert np.linalg.norm(d.astype(np.float64) @ res.x.numpy() - b) < 1e-4 * np.linalg.norm(b)


def test_ilut_preconditioned_bicgstab_matches_reference():
    """The reference's fill-needing matrix (tests/test_ilu.py:307-315)."""
    n = 400
    d = np.zeros((n, n), np.float32)
    idx = np.arange(n)
    d[idx, idx] = 4.0
    d[idx[1:], idx[:-1]] = -1.9
    d[idx[:-1], idx[1:]] = -0.7
    far = idx[:-17]
    d[far, far + 17] = -0.9
    d[far + 17, far] = -0.4
    a = _csr(d)
    b = np.random.default_rng(23).standard_normal(n).astype(np.float32)
    res = bicgstab_solve(SpmvOperator(a, device="cpu"), torch.from_numpy(b), tol=1e-6,
                         maxiter=500,
                         m_inv=ilu.ilut_preconditioner(a, device="cpu", tau=1e-4, p=12,
                                                       sweeps=5))
    ref_res = ref_bicgstab.bicgstab_solve(
        ref_op.SpmvOperator(_ref(a)), jnp.asarray(b), tol=1e-6, maxiter=500,
        m_inv=ref_ilu.ilut_preconditioner(_ref(a), tau=1e-4, p=12, sweeps=5))
    _same_solution(res, ref_res)


def test_zero_rhs_takes_no_iteration():
    a = _csr(_unsym_dense(np.random.default_rng(2), 50, 2.0).astype(np.float32))
    op = SpmvOperator(a, device="cpu")
    z = torch.zeros(a.rows)
    for res in (bicgstab_solve(op, z), gmres_solve(op, z)):
        assert res.iterations == 0 and torch.count_nonzero(res.x) == 0


def test_ilu_factors_files_cross_load(tmp_path):
    a = _csr(_spd_dense(np.random.default_rng(30), 50, 0.2))
    rf = ref_ilu.ilut(_ref(a), tau=1e-3, p=8)
    ref_ilu.save_ilu_factors(tmp_path / "ref.npz", rf)
    f = ilu.load_ilu_factors(tmp_path / "ref.npz")
    _same_csr(f.l, rf.l)
    _same_csr(f.u, rf.u)
    ilu.save_ilu_factors(tmp_path / "port.npz", ilu.ilut(a, tau=1e-3, p=8))
    back = ref_ilu.load_ilu_factors(tmp_path / "port.npz")
    _same_csr(back.l, f.l)
    _same_csr(back.u, f.u)
