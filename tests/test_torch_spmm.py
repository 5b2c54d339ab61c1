"""Port parity: multi-RHS applies and solvers (sparse_matrix_tpu_torch/
ops/spmv_dia.py SpMM, ops/spmm.py, ``SpmvOperator.matmat``,
solvers/cg.py ``cg_solve_multi`` / ``pcg_solve_multi``).

Each package plans the same matrix with its own planners; the port's CPU
path (the plain versions of the DIA, aligned, LanePack and BELL SpMM
kernels) is held to the JAX package's CPU path, after unpacking from the
packed layouts (whose padding differs: the port does not round to the
reference's 256-row steps, nor K to multiples of 8). Tolerances:

* port vs JAX, both f32: ``max|dY| <= 2e-5 * max(1, max|Y|)``;
* port vs float64, column by column: ``spmv_f64_bound`` (plain products
  ``(nnz_row + 1) * u * (|A||x|)_i``, rows with LanePack runs the C8 form);
  LanePack SpMM rows, whose run sums are differences of chunk prefix
  sums, get ``(2*128 + nnz_row) * u * ((|A||x|)_i + P_i)`` with P_i the mass
  of the chunks holding the row's runs (ROADMAP.md C8); bf16 BELL planes
  are held to the bound of their bf16-rounded values;
* ``cg_solve_multi`` on Poisson 32^2 at K=4: iterations within +-2 of the
  reference's, ``|X_port - X_ref| <= 1e-4 * |X_ref|``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sparse_matrix_tpu.formats import aligned as ref_aligned  # noqa: E402
from sparse_matrix_tpu.formats import bell as ref_bell  # noqa: E402
from sparse_matrix_tpu.formats import csr as ref_csr  # noqa: E402
from sparse_matrix_tpu.formats import dia as ref_dia  # noqa: E402
from sparse_matrix_tpu.formats import lanepack as ref_lanepack  # noqa: E402
from sparse_matrix_tpu.ops import operator as ref_op  # noqa: E402
from sparse_matrix_tpu.ops import spmm as ref_spmm  # noqa: E402
from sparse_matrix_tpu.ops import spmv_dia as ref_spmv_dia  # noqa: E402
from sparse_matrix_tpu.solvers import cg as ref_cg  # noqa: E402
from sparse_matrix_tpu_torch.bench import corpus  # noqa: E402
from sparse_matrix_tpu_torch.formats.aligned import plan_aligned  # noqa: E402
from sparse_matrix_tpu_torch.formats.bell import plan_bell  # noqa: E402
from sparse_matrix_tpu_torch.formats.csr import CsrMatrix  # noqa: E402
from sparse_matrix_tpu_torch.formats.dia import try_dia_from_csr  # noqa: E402
from sparse_matrix_tpu_torch.formats.lanepack import plan_lanepack  # noqa: E402
from sparse_matrix_tpu_torch.ops import spmm, spmv_bell, spmv_dia  # noqa: E402
from sparse_matrix_tpu_torch.ops.operator import SpmvOperator  # noqa: E402
from sparse_matrix_tpu_torch.ops.spmv import spmv_f64_bound  # noqa: E402
from sparse_matrix_tpu_torch.solvers import cg  # noqa: E402
from sparse_matrix_tpu_torch.solvers.poisson import poisson_2d_csr  # noqa: E402


def _ref(m):
    """The reference's CsrMatrix over the same arrays."""
    return ref_csr.CsrMatrix(m.rows, m.cols, m.vals, m.indices, m.offsets,
                             is_sorted=m.is_sorted)


def _agree(y, y_ref):
    y_ref = np.asarray(y_ref)
    assert y.shape == y_ref.shape and y.dtype == np.float32
    assert np.max(np.abs(y - y_ref), initial=0.0) <= 2e-5 * max(
        1.0, float(np.max(np.abs(y_ref), initial=0.0))
    )


def _bounded(m, X, Y, **kw):
    for q in range(X.shape[1]):
        y64, bound = spmv_f64_bound(m, X[:, q], **kw)
        assert np.all(np.abs(Y[:, q] - y64) <= bound), q


def _X(seed, n, k):
    return np.random.default_rng(seed).standard_normal((n, k)).astype(np.float32)


@pytest.mark.parametrize("k", [2, 8, 16])
def test_spmm_dia_stream_matches_reference(k):
    m = poisson_2d_csr(40, dtype=np.float32)
    dia = try_dia_from_csr(m)
    X = _X(k, m.cols, k)
    Y = spmv_dia.spmm_dia_stream(dia, torch.from_numpy(X)).numpy()
    ref = ref_spmv_dia.spmm_dia_stream(ref_dia.try_dia_from_csr(_ref(m)), jnp.asarray(X))
    _agree(Y, ref)
    _bounded(m, X, Y)


def test_spmm_dia_stream_bf16_planes_and_rectangular():
    rows, cols = 500, 260
    r = np.repeat(np.arange(rows), 5)
    c = r + np.tile([-250, -7, 0, 1, 9], rows)
    keep = (c >= 0) & (c < cols)
    rng = np.random.default_rng(1)
    m = CsrMatrix.from_coo(rows, cols, r[keep], c[keep],
                           rng.standard_normal(int(keep.sum())).astype(np.float32))
    dia = try_dia_from_csr(m)
    X = _X(2, cols, 3)
    for vdt in (None, torch.bfloat16):
        arrs = spmv_dia.dia_device_arrays(dia, "cpu", values_dtype=vdt)
        Y = spmv_dia.spmm_dia_stream(dia, torch.from_numpy(X), device_arrays=arrs).numpy()
        vals = None if vdt is None else torch.from_numpy(m.vals).to(vdt).double().numpy()
        _bounded(m, X, Y, vals=vals)


def test_spmm_dia_stream_refuses_k():
    dia = try_dia_from_csr(poisson_2d_csr(8, dtype=np.float32))
    for k in (1, 17):
        with pytest.raises(ValueError, match="K must be"):
            spmv_dia.spmm_dia_stream(dia, torch.zeros(64, k))


def test_dia_pack_roundtrip_and_guards():
    m = poisson_2d_csr(20, dtype=np.float32)  # 400 rows: a partial row block
    dia = try_dia_from_csr(m)
    X = torch.from_numpy(_X(3, m.rows, 4))
    x3 = spmv_dia.dia_pack_rhs(dia, X)
    lo = -min(dia.offsets) // 128 + 1
    hi = max(dia.offsets) // 128 + 2
    assert x3.shape == (lo + 4 + hi, 4, 128)
    assert torch.equal(spmv_dia.dia_unpack_rhs(dia, x3), X)
    y3 = spmv_dia.dia_matvec_multi(dia, 4, "cpu")(x3)
    assert y3.shape == x3.shape
    assert int(torch.count_nonzero(y3[:lo])) == 0 and int(torch.count_nonzero(y3[lo + 4:])) == 0
    Y = spmv_dia.dia_unpack_rhs(dia, y3).numpy()
    ref_d = ref_dia.try_dia_from_csr(_ref(m))
    ref_mv = ref_spmv_dia.dia_matvec_multi(ref_d, 4)
    ref_y3 = ref_mv(ref_spmv_dia.dia_pack_rhs(ref_d, jnp.asarray(X.numpy())))
    _agree(Y, ref_spmv_dia.dia_unpack_rhs(ref_d, ref_y3))
    with pytest.raises(ValueError, match="square"):
        rect = CsrMatrix.from_coo(300, 200, np.arange(200), np.arange(200), np.ones(200))
        spmv_dia.dia_matvec_multi(try_dia_from_csr(rect), 4, "cpu")


@pytest.mark.parametrize("k", [1, 4, 8])
@pytest.mark.parametrize("name", ["poisson", "rect"])
def test_spmm_aligned_matches_reference(k, name):
    if name == "poisson":
        m = poisson_2d_csr(48, dtype=np.float32)
    else:
        rng = np.random.default_rng(5)
        r, c = rng.integers(0, 300, 6000), rng.integers(0, 700, 6000)
        m = CsrMatrix.from_coo(300, 700, r, c, rng.standard_normal(6000).astype(np.float32))
    X = _X(k, m.cols, k)
    Y = spmm.spmm_aligned(plan_aligned(m), torch.from_numpy(X)).numpy()
    _agree(Y, ref_spmm.spmm_aligned(ref_aligned.plan_aligned(_ref(m)), jnp.asarray(X)))
    _bounded(m, X, Y)


def test_spmm_aligned_with_lanepack_spill(monkeypatch, tmp_path):
    import json

    from sparse_matrix_tpu.utils import autotune as ref_autotune
    from sparse_matrix_tpu_torch.utils import autotune

    p = tmp_path / "autotune.json"
    p.write_text(json.dumps({"lanepack_aligned_slab_ns": 1e6}))
    monkeypatch.setenv("SPMX_AUTOTUNE_CACHE", str(p))
    monkeypatch.setitem(autotune.DEFAULTS, "lanepack_aligned_slab_ns", 1e6)
    ref_autotune.reset_cache()
    try:
        m = corpus.random_local(np.random.default_rng(2), 2048, 12, 700)
        plan = plan_aligned(m)
        ref_plan = ref_aligned.plan_aligned(_ref(m))
    finally:
        ref_autotune.reset_cache()
    assert plan.spill is not None
    X = _X(6, m.cols, 4)
    Y = spmm.spmm_aligned(plan, torch.from_numpy(X)).numpy()
    _agree(Y, ref_spmm.spmm_aligned(ref_plan, jnp.asarray(X)))
    _bounded(m, X, Y, lanepack=(plan.spill,))


def test_aligned_matvec_multi_matches_reference():
    m = poisson_2d_csr(24, dtype=np.float32)  # 576 rows: a partial row block
    plan = plan_aligned(m)
    X = _X(7, m.cols, 3)
    x3 = spmm.pack_rhs(torch.from_numpy(X), m.cols)
    assert x3.shape == (plan.c128 + 1, 3, 128)
    y3 = spmm.aligned_matvec_multi(plan, 3, "cpu")(x3)
    assert y3.shape == x3.shape and int(torch.count_nonzero(y3[plan.r128:])) == 0
    ref_plan = ref_aligned.plan_aligned(_ref(m))
    ref_y3 = ref_spmm.aligned_matvec_multi(ref_plan, 3)(ref_spmm.pack_rhs(jnp.asarray(X), m.cols))
    _agree(y3.numpy(), ref_y3)
    with pytest.raises(ValueError, match="columns"):
        spmm.aligned_matvec_multi(plan, 4, "cpu")(x3)


def _with_random_entries(a, extra, seed):
    rng = np.random.default_rng(seed)
    r = np.r_[a.row_ids(), rng.integers(0, a.rows, extra)]
    c = np.r_[a.indices.astype(np.int64), rng.integers(0, a.cols, extra)]
    v = np.r_[a.vals, rng.standard_normal(extra).astype(np.float32)]
    return CsrMatrix.from_coo(a.rows, a.cols, r, c, v)


MATMAT = {
    "dia": (lambda: poisson_2d_csr(32, dtype=np.float32), None),
    "hybrid": (lambda: _with_random_entries(poisson_2d_csr(20, dtype=np.float32), 100, 1),
               "hybrid"),
    "aligned": (lambda: poisson_2d_csr(32, dtype=np.float32), "aligned"),
    "lanepack": (lambda: poisson_2d_csr(16, dtype=np.float32), "lanepack"),
    "stripe": (lambda: corpus.power_law_rows(np.random.default_rng(0), 1 << 12, 16), "stripe"),
    "bell": (lambda: corpus.fem_like(np.random.default_rng(0), 40, 2), "bell"),
    "ell": (lambda: poisson_2d_csr(32, dtype=np.float32), "ell"),
    "lanepack_large": (lambda: corpus.power_law_rows(np.random.default_rng(1), 1 << 15, 16),
                       "lanepack"),
}


# every format the dispatch can pick, at K = 1, 3 (below the SpMM kernels'
# K >= 8 where they exist), 8 and 16 (the packed kernels), and K = 20 (two
# chunks of 10 for DIA and BELL); nothing raises NotImplementedError
@pytest.mark.parametrize("fmt,k", [(f, k) for f in MATMAT for k in (1, 3, 8, 16)]
                         + [(f, 20) for f in ("dia", "aligned", "stripe", "ell", "bell")])
def test_matmat_matches_reference(fmt, k):
    make, force = MATMAT[fmt]
    m = make()
    op = SpmvOperator(m, device="cpu", force=force)
    ref = ref_op.SpmvOperator(_ref(m), force=force)
    assert op.format == ref.format == (force or "dia")
    X = _X(k, m.cols, k)
    Y = op.matmat(torch.from_numpy(X)).numpy()
    _agree(Y, ref.matmat(jnp.asarray(X)))
    kw = {}
    if op.part("stripe") is not None:
        kw["stripe"] = (op.part("stripe").plan,)
    if op.part("lanepack") is not None:
        kw["lanepack"] = (op.part("lanepack").plan,)
    if op.part("bell") is not None and op.part("bell").plan.spill is not None:
        kw["lanepack"] = (op.part("bell").plan.spill,)
    _bounded(m, X, Y, **kw)


def test_matmat_raises_valueerror_on_malformed_x():
    # on the BELL and LanePack operators (B8, B7) matmat raises a
    # ValueError that names the expected (cols, K) shape
    bell_op = SpmvOperator(corpus.fem_like(np.random.default_rng(0), 40, 2), device="cpu",
                           force="bell")
    with pytest.raises(ValueError, match=rf"\({bell_op.cols}, K\)"):
        bell_op.matmat(torch.zeros(bell_op.cols + 1, 8))
    small = SpmvOperator(poisson_2d_csr(16, dtype=np.float32), device="cpu", force="lanepack")
    with pytest.raises(ValueError, match=r"\(256, K\)"):
        small.matmat(torch.zeros(100, 2))
    with pytest.raises(ValueError, match=r"\(256, K\)"):
        small.matmat(torch.zeros(256))


def _lanepack_matrix():
    return corpus.power_law_rows(np.random.default_rng(1), 400, 12)


@pytest.mark.parametrize("k", [2, 8, 16])
@pytest.mark.parametrize("pack", ["dense", "per_rb"])
@pytest.mark.parametrize("kw", [1, 4])
def test_spmm_lanepack_matches_reference(k, pack, kw):
    m = _lanepack_matrix()
    plan = plan_lanepack(m, kw=kw, pack=pack)
    ref_plan = ref_lanepack.plan_lanepack(_ref(m), kw=kw, pack=pack)
    assert (plan.kw, plan.pack) == (kw, pack) and spmm.lanepack_spmm_uses_kernel(plan, k)
    X = _X(k, m.cols, k)
    Y = spmm.spmm_lanepack(plan, torch.from_numpy(X)).numpy()
    _agree(Y, ref_spmm.spmm_lanepack(ref_plan, jnp.asarray(X)))
    _bounded(m, X, Y, lanepack=(plan,))


def test_spmm_lanepack_packed_needs_no_guard():
    # the kernel and its plain version read x as zero past cols: an x3
    # without guard rows gives the result of the reference's kw-guarded one
    m = _lanepack_matrix()
    plan = plan_lanepack(m, kw=4)
    X = torch.from_numpy(_X(9, m.cols, 5))
    y0 = spmm.spmm_lanepack_packed(plan, spmm.pack_rhs(X, m.cols, guard=0))
    y4 = spmm.spmm_lanepack_packed(plan, spmm.pack_rhs(X, m.cols, guard=plan.kw))
    assert y0.shape == (plan.r128, 5, 128) and torch.equal(y0, y4)
    with pytest.raises(ValueError, match="packed"):
        spmm.spmm_lanepack_packed(plan, spmm.pack_rhs(X, m.cols)[:2])


def test_lanepack_matvec_multi_cg_matches_reference(poisson32):
    a, B = poisson32
    plan = plan_lanepack(a)
    x3 = spmm.pack_rhs(torch.from_numpy(B), a.cols, guard=plan.kw)
    mv = spmm.lanepack_matvec_multi(plan, 4, "cpu")
    y3 = mv(x3)
    assert y3.shape == x3.shape and int(torch.count_nonzero(y3[plan.r128:])) == 0
    res = cg.cg_solve_multi(mv, x3, tol=1e-5, maxiter=500, rhs_axis=1)
    rp = ref_lanepack.plan_lanepack(_ref(a))
    ref_res = ref_cg.cg_solve_multi(ref_spmm.lanepack_matvec_multi(rp, 4),
                                    ref_spmm.pack_rhs(jnp.asarray(B), a.cols, guard=rp.kw),
                                    tol=1e-5, maxiter=500, rhs_axis=1)
    _same(res, ref_res, lambda x: spmm.unpack_rhs(x, a.rows),
          lambda x: ref_spmm.unpack_rhs(x, a.rows))
    with pytest.raises(ValueError, match="columns"):
        mv(spmm.pack_rhs(torch.from_numpy(B[:, :3]), a.cols, guard=plan.kw))


BELL_MATRICES = {
    # mixed-sign layer bases, no spill
    "randlocal": lambda: corpus.random_local(np.random.default_rng(2), 512, 12, 300),
    # mixed-sign bases and a LanePack spill
    "powerlaw_spill": lambda: corpus.power_law_rows(np.random.default_rng(0), 512, 16),
}


@pytest.mark.parametrize("k", [2, 8, 16])
@pytest.mark.parametrize("span", [128, 256])
@pytest.mark.parametrize("name", list(BELL_MATRICES))
def test_spmm_bell_matches_reference(name, span, k):
    m = BELL_MATRICES[name]()
    plan = plan_bell(m, span=span)
    assert min(plan.ds) < 0 < max(plan.ds)
    assert (plan.spill is not None) == (name == "powerlaw_spill")
    X = _X(k, m.cols, k)
    Y = spmm.spmm_bell(plan, torch.from_numpy(X)).numpy()
    _agree(Y, ref_spmm.spmm_bell(ref_bell.plan_bell(_ref(m), span=span), jnp.asarray(X)))
    _bounded(m, X, Y, lanepack=() if plan.spill is None else (plan.spill,))


@pytest.mark.parametrize("span", [128, 256])
def test_spmm_bell_bf16_planes(span):
    m = BELL_MATRICES["randlocal"]()
    plan = plan_bell(m, span=span)
    arrs = spmv_bell.bell_device_arrays(plan, "cpu", values_dtype=torch.bfloat16)
    X = _X(span, m.cols, 8)
    Y = spmm.spmm_bell(plan, torch.from_numpy(X), device_arrays=arrs).numpy()
    vals = torch.from_numpy(m.vals.astype(np.float32)).to(torch.bfloat16).double().numpy()
    _bounded(m, X, Y, vals=vals)
    # column q of the SpMM is the SpMV of column q
    for q in (0, 7):
        y = spmv_bell.spmv_bell(plan, torch.from_numpy(np.ascontiguousarray(X[:, q])),
                                device_arrays=arrs).numpy()
        _agree(Y[:, q], y)


def test_spmm_bell_refuses_k():
    plan = plan_bell(BELL_MATRICES["randlocal"]())
    for k in (1, 17):
        assert not spmm.bell_spmm_viable(plan, k)
        with pytest.raises(ValueError, match="2 <= K <= 16"):
            spmm.spmm_bell(plan, torch.zeros(plan.cols, k))


def _same(res, ref_res, unpack=lambda x: x, ref_unpack=lambda x: x):
    x = unpack(res.x).numpy().astype(np.float64)
    x_ref = np.asarray(ref_unpack(ref_res.x), np.float64)
    assert abs(res.iterations - int(ref_res.iterations)) <= 2
    assert np.linalg.norm(x - x_ref) <= 1e-4 * np.linalg.norm(x_ref)


@pytest.fixture(scope="module")
def poisson32():
    a = poisson_2d_csr(32, dtype=np.float32)
    return a, _X(0, a.rows, 4)


def test_cg_solve_multi_columns(poisson32):
    a, B = poisson32
    op = SpmvOperator(a, device="cpu")
    res = cg.cg_solve_multi(op.matmat, torch.from_numpy(B), tol=1e-5, maxiter=500)
    ref = ref_op.SpmvOperator(_ref(a))
    ref_res = ref_cg.cg_solve_multi(ref.matmat, jnp.asarray(B), tol=1e-5, maxiter=500)
    _same(res, ref_res)
    assert res.residual_norm.shape == (4,)
    assert np.all(res.residual_norm.numpy() <= 1e-5 * np.linalg.norm(B, axis=0) * (1 + 1e-6))


def test_cg_solve_multi_packed_dia(poisson32):
    a, B = poisson32
    dia = try_dia_from_csr(a)
    res = cg.cg_solve_multi(spmv_dia.dia_matvec_multi(dia, 4, "cpu"),
                            spmv_dia.dia_pack_rhs(dia, torch.from_numpy(B)),
                            tol=1e-5, maxiter=500, rhs_axis=1)
    rd = ref_dia.try_dia_from_csr(_ref(a))
    ref_res = ref_cg.cg_solve_multi(ref_spmv_dia.dia_matvec_multi(rd, 4),
                                    ref_spmv_dia.dia_pack_rhs(rd, jnp.asarray(B)),
                                    tol=1e-5, maxiter=500, rhs_axis=1)
    _same(res, ref_res, lambda x: spmv_dia.dia_unpack_rhs(dia, x),
          lambda x: ref_spmv_dia.dia_unpack_rhs(rd, x))


def test_cg_solve_multi_packed_aligned(poisson32):
    a, B = poisson32
    plan = plan_aligned(a)
    res = cg.cg_solve_multi(spmm.aligned_matvec_multi(plan, 4, "cpu"),
                            spmm.pack_rhs(torch.from_numpy(B), a.cols),
                            tol=1e-5, maxiter=500, rhs_axis=1)
    rp = ref_aligned.plan_aligned(_ref(a))
    ref_res = ref_cg.cg_solve_multi(ref_spmm.aligned_matvec_multi(rp, 4),
                                    ref_spmm.pack_rhs(jnp.asarray(B), a.cols),
                                    tol=1e-5, maxiter=500, rhs_axis=1)
    _same(res, ref_res, lambda x: spmm.unpack_rhs(x, a.rows),
          lambda x: ref_spmm.unpack_rhs(x, a.rows))


def test_pcg_solve_multi_jacobi(poisson32):
    a, B = poisson32
    op = SpmvOperator(a, device="cpu")
    res = cg.pcg_solve_multi(op.matmat, torch.from_numpy(B), cg.jacobi_preconditioner(a, "cpu"),
                             tol=1e-5, maxiter=500)
    ref = ref_op.SpmvOperator(_ref(a))
    ref_res = ref_cg.pcg_solve_multi(ref.matmat, jnp.asarray(B),
                                     ref_cg.jacobi_preconditioner(_ref(a)),
                                     tol=1e-5, maxiter=500)
    _same(res, ref_res)


def test_cg_solve_multi_zero_column_and_freeze():
    a = poisson_2d_csr(16, dtype=np.float32)
    B = _X(1, a.rows, 3)
    B[:, 1] = 0.0
    op = SpmvOperator(a, device="cpu")
    res = cg.cg_solve_multi(op.matmat, torch.from_numpy(B), tol=1e-5, maxiter=300)
    assert int(torch.count_nonzero(res.x[:, 1])) == 0
    single = cg.cg_solve(op, torch.from_numpy(B[:, 0]), tol=1e-5, maxiter=300)
    assert abs(single.iterations - res.iterations) <= 2
