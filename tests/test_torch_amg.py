"""Port parity for smoothed-aggregation AMG (sparse_matrix_tpu_torch/
solvers/amg.py) against the JAX package's solvers/amg.py, on numpy-seeded
inputs: Poisson 32^2 and 64^2, the anisotropic Poisson of
tests/test_amg.py (eps = 0.01), a diagonal matrix, and a small symmetric
diagonally dominant femlike matrix. The port runs on the CPU (its plain
versions of the kernels), the JAX package on its CPU path.

Tolerances:

* the host half (strength graph, aggregation, tentative prolongator, every
  level of ``amg_coarsen``: A_l, P_l, dinv_l, lam_l and the coarse
  operator; the saved npz arrays): array-equal, dtypes included. The
  reference runs its native library or, where that did not load in this
  process (``ref_path``, ROADMAP C17), its numpy and Python branches; the
  port is held to it on the same path: its host library, or its plain
  versions bound in the library's place. The two routes of the port are
  also held equal to each other;
* the formats of every level's A, P and P^T: equal;
* the V-cycle, on a vector and on an (n, 8) block: within 1e-5 normwise
  relative of the reference's (XLA on the CPU contracts some multiplies
  and adds that PyTorch rounds apart, ROADMAP C16);
* AMG-PCG, Jacobi and Chebyshev smoothing: iterations within +-1 of the
  reference's, ``dense @ x`` within 5e-4 of b (tests/test_amg.py's bound),
  on Poisson 32^2 (both smoothers) and the anisotropic case (Jacobi); the
  other cases, whose reference solves take a long XLA compile on the CPU,
  hold the port to tests/test_amg.py's acceptance alone (fewer than 40
  iterations; a block solve in at most 25).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparse_matrix_tpu.formats import csr as ref_csr  # noqa: E402
from sparse_matrix_tpu.solvers import amg as ref_amg  # noqa: E402
from sparse_matrix_tpu_torch.bench import corpus  # noqa: E402
from sparse_matrix_tpu_torch.formats.csr import CsrMatrix  # noqa: E402
from sparse_matrix_tpu_torch.native import host  # noqa: E402
from sparse_matrix_tpu_torch.ops import spgemm_host as sh  # noqa: E402
from sparse_matrix_tpu_torch.solvers import amg  # noqa: E402
from sparse_matrix_tpu_torch.solvers.poisson import poisson_2d_csr  # noqa: E402

CPU = "cpu"


@pytest.fixture(scope="module")
def ref_path():
    """``"native"`` if the reference's native library runs in this process,
    else ``"python"`` (its numpy and Python branches)."""
    from sparse_matrix_tpu.native import loader

    return "native" if loader.native_available() else "python"


def _plain_route(monkeypatch):
    """Bind the port's plain versions in the host library's place: the
    route the reference takes without its library."""
    monkeypatch.setattr(host, "amg_strength_native", amg._strength_numpy)
    monkeypatch.setattr(host, "aggregate_pass_native", amg._aggregate_pass_python)
    monkeypatch.setattr(host, "colmap_smoothed_native", amg._colmap_smoothed_python)
    monkeypatch.setattr(host, "colmap_spgemm_native", sh._colmap_spgemm_python)
    monkeypatch.setattr(host, "jacobi_smoother_native", amg._jacobi_smoother_numpy)
    monkeypatch.setattr(host, "scale_rows_native", amg._scale_rows_numpy)
    monkeypatch.setattr(host, "flops_per_row_native", sh._flops_per_row_numpy)
    monkeypatch.setattr(
        host, "spgemm_hash_native",
        lambda lhs, rhs, *, output_sorted=False, num_threads=0:
            sh._spgemm_hash_python(lhs, rhs, output_sorted=output_sorted))


def _ref(m):
    return ref_csr.CsrMatrix(m.rows, m.cols, m.vals, m.indices, m.offsets,
                             is_sorted=m.is_sorted)


def _aniso(n=24, eps=0.01):
    idx = lambda i, j: i * n + j  # noqa: E731
    r, c, v = [], [], []
    for i in range(n):
        for j in range(n):
            r.append(idx(i, j)); c.append(idx(i, j)); v.append(2 + 2 * eps)  # noqa: E702
            if i > 0: r.append(idx(i, j)); c.append(idx(i - 1, j)); v.append(-eps)  # noqa
            if i < n - 1: r.append(idx(i, j)); c.append(idx(i + 1, j)); v.append(-eps)  # noqa
            if j > 0: r.append(idx(i, j)); c.append(idx(i, j - 1)); v.append(-1.0)  # noqa
            if j < n - 1: r.append(idx(i, j)); c.append(idx(i, j + 1)); v.append(-1.0)  # noqa
    return CsrMatrix.from_coo(n * n, n * n, np.array(r), np.array(c),
                              np.array(v, dtype=np.float32))


def _femlike():
    f = corpus.fem_like(np.random.default_rng(5), 24, 1)
    d = corpus.with_dominant_diagonal(f + f.transpose())
    return CsrMatrix(d.rows, d.cols, d.vals.astype(np.float32), d.indices, d.offsets,
                     is_sorted=True)


# matrix -> the coarse_size the reference's tests (or the default) use
CASES = {
    "poisson32": (lambda: poisson_2d_csr(32, dtype=np.float32), 100),
    "poisson64": (lambda: poisson_2d_csr(64, dtype=np.float32), 400),
    "aniso24": (_aniso, 80),
    "diag600": (lambda: CsrMatrix.from_coo(600, 600, np.arange(600), np.arange(600),
                                           np.linspace(1.0, 3.0, 600).astype(np.float32)),
                400),
    "femlike24": (_femlike, 60),
}


def _same_csr(got, want, what):
    assert (got.rows, got.cols) == (want.rows, want.cols), what
    for f in ("offsets", "indices", "vals"):
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, (what, f)
        np.testing.assert_array_equal(g, w, err_msg=f"{what}.{f}")


def _same_coarsening(got, want, tag):
    (levels, coarse), (ref_levels, ref_coarse) = got, want
    assert len(levels) == len(ref_levels), tag
    for i, ((a, p, d, lam), (ra, rp, rd, rlam)) in enumerate(zip(levels, ref_levels)):
        _same_csr(a, ra, f"{tag} A_{i}")
        _same_csr(p, rp, f"{tag} P_{i}")
        assert d.dtype == rd.dtype
        np.testing.assert_array_equal(d, rd, err_msg=f"{tag} dinv_{i}")
        assert lam == rlam, (tag, i)
    _same_csr(coarse, ref_coarse, f"{tag} coarse")


@pytest.mark.parametrize("kind", list(CASES))
def test_amg_coarsen_matches_reference(kind, ref_path, monkeypatch):
    make, coarse_size = CASES[kind]
    a = make()
    want = ref_amg.amg_coarsen(_ref(a), coarse_size=coarse_size)
    library = amg.amg_coarsen(a, coarse_size=coarse_size, device=CPU)
    with monkeypatch.context() as mp:
        _plain_route(mp)
        plain = amg.amg_coarsen(a, coarse_size=coarse_size, device=CPU)
    _same_coarsening(library, plain, f"{kind} library/plain")
    _same_coarsening(library if ref_path == "native" else plain, want,
                     f"{kind} on the reference's {ref_path} path")
    if kind == "diag600":
        assert len(library[0]) == 0  # aggregation merges nothing

    # every level's strength graph, aggregates and tentative P, both routes
    for cur, *_ in library[0]:
        so, si = amg.strength_graph(cur)
        rso, rsi = ref_amg.strength_graph(_ref(cur))
        np.testing.assert_array_equal(so, rso)
        np.testing.assert_array_equal(si, rsi)
        agg, na = amg.aggregate_strong(cur.rows, so, si)
        rng_agg, rna = ref_amg.aggregate_strong(cur.rows, rso, rsi)
        assert na == rna
        np.testing.assert_array_equal(agg, rng_agg)
        plain_agg = np.full(cur.rows, -1, np.int64)
        n1 = amg._aggregate_pass_python(1, so, si, plain_agg)
        amg._aggregate_pass_python(2, so, si, plain_agg)
        assert amg._aggregate_pass_python(3, so, si, plain_agg, n1) == na
        np.testing.assert_array_equal(plain_agg, agg)
        _same_csr(amg.tentative_prolongator(agg, na, dtype=cur.vals.dtype),
                  ref_amg.tentative_prolongator(rng_agg, rna, dtype=cur.vals.dtype),
                  f"{kind} P0")


def test_save_load_matches_reference(tmp_path):
    a = poisson_2d_csr(64, dtype=np.float32)
    levels, coarse = amg.amg_coarsen(a, coarse_size=60, device=CPU)
    mine, theirs = tmp_path / "port.npz", tmp_path / "ref.npz"
    amg.save_amg_coarsening(mine, levels, coarse)
    ref_amg.save_amg_coarsening(
        theirs, [(_ref(a_l), _ref(p_l), d, lam) for a_l, p_l, d, lam in levels], _ref(coarse))
    zm, zt = np.load(mine), np.load(theirs)
    assert sorted(zm.files) == sorted(zt.files)
    for k in zm.files:
        assert zm[k].dtype == zt[k].dtype, k
        np.testing.assert_array_equal(zm[k], zt[k], err_msg=k)
    # each package reads the other's file
    _same_coarsening(amg.load_amg_coarsening(theirs), (levels, coarse), "load(ref)")
    _same_coarsening(ref_amg.load_amg_coarsening(mine), (levels, coarse), "ref load(port)")


@pytest.mark.parametrize("kind", ["poisson64", "aniso24", "femlike24"])
def test_level_formats_match_reference(kind):
    make, coarse_size = CASES[kind]
    a = make()
    hier = amg.amg_setup(a, coarse_size=coarse_size, device=CPU)
    ref_hier = ref_amg.amg_setup(_ref(a), coarse_size=coarse_size, dtype=np.float32)
    assert len(hier.levels) == len(ref_hier.levels) > 0
    for lv, rlv in zip(hier.levels, ref_hier.levels):
        assert (lv.a_op.format, lv.p_op.format, lv.pt_op.format) == (
            rlv.a_op.format, rlv.p_op.format, rlv.pt_op.format)
        assert (lv.n, lv.nnz, lv.lam) == (rlv.n, rlv.nnz, rlv.lam)
        assert lv.dinv.dtype == torch.float32 and lv.dinv.device.type == "cpu"
        np.testing.assert_array_equal(lv.dinv.numpy(), np.asarray(rlv.dinv))
    np.testing.assert_array_equal(hier.coarse_inv.numpy(), np.asarray(ref_hier.coarse_inv))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


@pytest.mark.parametrize("k", [None, 8])
@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_vcycle_matches_reference(smoother, k):
    a = poisson_2d_csr(32, dtype=np.float32)
    hier = amg.amg_setup(a, coarse_size=100, smoother=smoother, device=CPU)
    ref_hier = ref_amg.amg_setup(_ref(a), coarse_size=100, smoother=smoother,
                                 dtype=np.float32)
    assert len(hier.levels) == 2
    shape = (a.rows,) if k is None else (a.rows, k)
    r = np.random.default_rng(13).standard_normal(shape).astype(np.float32)
    got = hier.vcycle(torch.from_numpy(r))
    assert got.shape == shape and got.dtype == torch.float32
    want = jax.jit(ref_hier.vcycle)(jnp.asarray(r))
    assert _rel(got.numpy(), want) <= 1e-5
    if k is not None:  # the block V-cycle is k independent V-cycles
        one = hier.vcycle(torch.from_numpy(np.ascontiguousarray(r[:, 3])))
        assert _rel(got[:, 3].numpy(), one.numpy()) <= 1e-5


@pytest.mark.parametrize("k", [None, 8])
@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
def test_preconditioner_off_the_card_stays_eager(smoother, k, monkeypatch):
    """``preconditioner()`` on a CPU vector or an (n, K) block runs the
    eager V-cycle: the bits of ``hier.vcycle``, in a tensor of the
    caller's own, with no graph captured and no kernel launch counted."""
    from sparse_matrix_tpu_torch.native import kernels

    def no_capture(*_args):
        raise AssertionError("a CUDA graph was captured off the card")

    monkeypatch.setattr(amg, "_capture_vcycle", no_capture)
    a = poisson_2d_csr(32, dtype=np.float32)
    hier = amg.amg_setup(a, coarse_size=100, smoother=smoother, device=CPU)
    shape = (a.rows,) if k is None else (a.rows, k)
    r = torch.from_numpy(np.random.default_rng(14).standard_normal(shape).astype(np.float32))
    before = dict(kernels.launch_counts)
    m_inv = hier.preconditioner()
    got = m_inv(r)
    assert torch.equal(got, hier.vcycle(r)) and got.data_ptr() != r.data_ptr()
    assert torch.equal(m_inv(r), got)
    assert hier._graph is None and kernels.launch_counts == before


def _check_solution(a, x, b):
    dense = a.to_dense().astype(np.float64)
    np.testing.assert_allclose(dense @ np.asarray(x, np.float64), b, atol=5e-4)


@pytest.mark.parametrize("kind,smoother", [("poisson32", "jacobi"), ("poisson32", "chebyshev"),
                                           ("aniso24", "jacobi")])
def test_amg_pcg_matches_reference(kind, smoother):
    make, coarse_size = CASES[kind]
    a = make()
    b = np.random.default_rng(3).standard_normal(a.rows).astype(np.float32)
    hier = amg.amg_setup(a, coarse_size=coarse_size, smoother=smoother, device=CPU)
    res = amg.amg_pcg_solve(a, torch.from_numpy(b), tol=1e-6, maxiter=80, hierarchy=hier)
    ref_hier = ref_amg.amg_setup(_ref(a), coarse_size=coarse_size, smoother=smoother,
                                 dtype=np.float32)
    ref_res = jax.jit(lambda bb: ref_amg.amg_pcg_solve(_ref(a), bb, tol=1e-6, maxiter=80,
                                                       hierarchy=ref_hier))(b)
    assert abs(res.iterations - int(ref_res.iterations)) <= 1
    assert res.iterations < 40
    _check_solution(a, res.x.numpy(), b)
    _check_solution(a, np.asarray(ref_res.x), b)


@pytest.mark.parametrize("kind,smoother", [("aniso24", "chebyshev"), ("femlike24", "jacobi"),
                                           ("femlike24", "chebyshev")])
def test_amg_pcg_converges(kind, smoother):
    """The cases whose reference solve (a long XLA compile on the CPU) the
    parity test above leaves out: tests/test_amg.py's acceptance."""
    make, coarse_size = CASES[kind]
    a = make()
    b = np.random.default_rng(3).standard_normal(a.rows).astype(np.float32)
    res = amg.amg_pcg_solve(a, torch.from_numpy(b), tol=1e-6, maxiter=80,
                            coarse_size=coarse_size, smoother=smoother, device=CPU)
    assert res.iterations < 40
    _check_solution(a, res.x.numpy(), b)


def test_amg_block_pcg_and_one_call_setup():
    """(n, K) right-hand sides through one block V-cycle and one SpMM an
    iteration (tests/test_amg.py's block acceptance: at most 25
    iterations, every column within the bound)."""
    a = poisson_2d_csr(24, dtype=np.float32)
    rng = np.random.default_rng(9)
    bb = rng.standard_normal((a.rows, 4)).astype(np.float32)
    res = amg.amg_pcg_solve(a, torch.from_numpy(bb), tol=1e-6, maxiter=60,
                            coarse_size=80, device=CPU)
    assert res.x.shape == (a.rows, 4) and res.residual_norm.shape == (4,)
    assert res.iterations <= 25
    for q in range(4):
        _check_solution(a, res.x[:, q].numpy(), bb[:, q])
    m_inv = amg.amg_preconditioner(a, coarse_size=80, device=CPU)
    assert m_inv(torch.from_numpy(bb[:, 0])).shape == (a.rows,)


def test_amg_degenerate_and_bf16_planes():
    # a diagonal matrix: no level, the coarse solve is the whole solve
    make, coarse_size = CASES["diag600"]
    a = make()
    hier = amg.amg_setup(a, coarse_size=coarse_size, device=CPU)
    assert len(hier.levels) == 0
    b = np.ones(a.rows, dtype=np.float32)
    res = amg.amg_pcg_solve(a, torch.from_numpy(b), tol=1e-6, maxiter=20, hierarchy=hier)
    np.testing.assert_allclose(res.x.numpy() * a.vals, b, atol=1e-4)
    # bf16 planes where the format takes them, an f32 outer operator
    p = poisson_2d_csr(32, dtype=np.float32)
    hier = amg.amg_setup(p, coarse_size=100, device=CPU, values_dtype=torch.bfloat16)
    ref_hier = ref_amg.amg_setup(_ref(p), coarse_size=100, dtype=np.float32,
                                 values_dtype=jnp.bfloat16)
    assert hier.outer_a_op is not None and hier.outer_a_op.format == "dia"
    assert [(lv.a_op.format, lv.p_op.format, lv.pt_op.format) for lv in hier.levels] == [
        (lv.a_op.format, lv.p_op.format, lv.pt_op.format) for lv in ref_hier.levels]
    b = np.random.default_rng(4).standard_normal(p.rows).astype(np.float32)
    res = amg.amg_pcg_solve(p, torch.from_numpy(b), tol=1e-5, maxiter=60, hierarchy=hier)
    _check_solution(p, res.x.numpy(), b)
    with pytest.raises(ValueError, match="square"):
        amg.amg_setup(CsrMatrix.from_coo(4, 5, [0], [0], np.ones(1, np.float32)), device=CPU)


def test_amg_setup_needs_a_card_unless_cpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        amg.amg_setup(poisson_2d_csr(8, dtype=np.float32))
