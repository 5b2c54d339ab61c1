"""Port parity for the slice as a whole: SpmvOperator + CG
(sparse_matrix_tpu_torch/solvers/cg.py, entry.py).

On Poisson 32^2 with a seeded right-hand side, the port and the JAX
package run the same solver over their own operators. Tolerances:
iterations within +-2 of the reference's, ``|x_port - x_ref| <= 1e-4 *
|x_ref|``. The port's ``entry()`` step equals ``__graft_entry__.entry()``'s
step on the same inputs within ``2e-5 * max(1, max|v|)`` per output.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sparse_matrix_tpu.formats import csr as ref_csr  # noqa: E402
from sparse_matrix_tpu.ops import operator as ref_op  # noqa: E402
from sparse_matrix_tpu.solvers import cg as ref_cg  # noqa: E402
from sparse_matrix_tpu_torch.ops.operator import SpmvOperator  # noqa: E402
from sparse_matrix_tpu_torch.solvers import cg  # noqa: E402
from sparse_matrix_tpu_torch.solvers.poisson import poisson_2d_csr  # noqa: E402

N = 32
TOL = 1e-5


@pytest.fixture(scope="module")
def problem():
    a = poisson_2d_csr(N, dtype=np.float32)
    b = np.random.default_rng(0).standard_normal(a.rows).astype(np.float32)
    return a, b


def _ref(m):
    """The reference's CsrMatrix over the same arrays."""
    return ref_csr.CsrMatrix(m.rows, m.cols, m.vals, m.indices, m.offsets,
                             is_sorted=m.is_sorted)


def _same_solution(res, ref_res):
    x, x_ref = res.x.numpy().astype(np.float64), np.asarray(ref_res.x, np.float64)
    assert abs(res.iterations - int(ref_res.iterations)) <= 2
    assert np.linalg.norm(x - x_ref) <= 1e-4 * np.linalg.norm(x_ref)


@pytest.mark.parametrize("force", [None, "aligned", "bell", "lanepack"])
def test_cg_solve(problem, force):
    a, b = problem
    op = SpmvOperator(a, device="cpu", force=force)
    res = cg.cg_solve(op, torch.from_numpy(b), tol=TOL, maxiter=500)
    ref_res = ref_cg.cg_solve(ref_op.SpmvOperator(_ref(a), force=force), jnp.asarray(b),
                              tol=TOL, maxiter=500)
    _same_solution(res, ref_res)
    assert float(res.residual_norm) <= TOL * np.linalg.norm(b) * (1 + 1e-6)


def test_pcg_solve_jacobi(problem):
    a, b = problem
    op = SpmvOperator(a, device="cpu")
    res = cg.pcg_solve(op, torch.from_numpy(b), cg.jacobi_preconditioner(a, "cpu"),
                       tol=TOL, maxiter=500)
    ref_res = ref_cg.pcg_solve(ref_op.SpmvOperator(_ref(a)), jnp.asarray(b),
                               ref_cg.jacobi_preconditioner(_ref(a)), tol=TOL, maxiter=500)
    _same_solution(res, ref_res)


def test_cg_solve_ir_bf16_planes(problem):
    a, b = problem
    hi = SpmvOperator(a, device="cpu")
    lo = SpmvOperator(a, device="cpu", values_dtype=torch.bfloat16)
    assert lo.part("dia").arrays["data"].dtype == torch.bfloat16
    res = cg.cg_solve_ir(hi, lo, torch.from_numpy(b), tol=TOL, maxiter=2000)
    ref_res = ref_cg.cg_solve_ir(
        ref_op.SpmvOperator(_ref(a)), ref_op.SpmvOperator(_ref(a), values_dtype=jnp.bfloat16),
        jnp.asarray(b), tol=TOL, maxiter=2000,
    )
    _same_solution(res, ref_res)


def test_cg_zero_rhs_takes_no_iteration():
    a = poisson_2d_csr(8, dtype=np.float32)
    res = cg.cg_solve(SpmvOperator(a, device="cpu"), torch.zeros(a.rows))
    assert res.iterations == 0 and torch.count_nonzero(res.x) == 0


def test_entry_step_matches_reference():
    from __graft_entry__ import entry as ref_entry

    from sparse_matrix_tpu_torch.entry import entry

    def close(v, r):
        v, r = v.numpy(), np.asarray(r)
        assert v.shape == r.shape
        assert np.max(np.abs(v - r)) <= 2e-5 * max(1.0, float(np.max(np.abs(r))))

    step, args = entry("cpu")
    ref_step, ref_args = ref_entry()
    assert np.array_equal(args[1].numpy(), np.asarray(ref_args[1]))  # same b
    for v, r in zip(args, ref_args):
        close(v, r)
    for v, r in zip(step(*args), ref_step(*ref_args)):
        close(v, r)


def _plain_cg_step(matvec, x, r, p, rs):
    """The CG step's arithmetic before the fused CUDA kernels, copied: the
    CPU path must keep its bits."""
    ap = matvec(p)
    alpha = rs / torch.dot(p, ap)
    x = x + alpha * p
    r = r - alpha * ap
    rs_new = torch.dot(r, r)
    p = r + (rs_new / rs) * p
    return x, r, p, rs_new


def _plain_pcg_step(matvec, precond, x, r, p, rz):
    """The PCG step's arithmetic before the fused CUDA kernels, copied."""
    ap = matvec(p)
    alpha = rz / torch.dot(p, ap)
    x = x + alpha * p
    r = r - alpha * ap
    z = precond(r)
    rz_new = torch.dot(r, z)
    p = z + (rz_new / rz) * p
    return x, r, p, rz_new, torch.dot(r, r)


@pytest.mark.parametrize("kind", ["cg", "pcg"])
@pytest.mark.parametrize("n", [1, 1001, 4096])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_steps_keep_their_bits(kind, n, dtype):
    """On CPU tensors ``_cg_step`` and ``_pcg_step`` are the plain PyTorch
    expressions: three chained steps give the bits of the copied arithmetic,
    and the inputs are not written."""
    rng = np.random.default_rng(n)
    diag = torch.from_numpy(4.0 + rng.random(n)).to(dtype)
    inv = 1.0 / diag

    def matvec(v):  # SPD: a diagonal plus a symmetric tridiagonal
        y = diag * v
        y[1:] -= v[:-1]
        y[:-1] -= v[1:]
        return y

    def precond(v):
        return inv * v

    b = torch.from_numpy(rng.standard_normal(n)).to(dtype)
    r = b - matvec(torch.zeros_like(b))
    z = precond(r) if kind == "pcg" else r
    state = (torch.zeros_like(b), r, z, torch.dot(r, z))
    want = state
    for _ in range(3):
        kept = [t.clone() for t in state]
        if kind == "cg":
            got = cg._cg_step(matvec, *state)
            want = _plain_cg_step(matvec, *want)
        else:
            got = cg._pcg_step(matvec, precond, *state)
            want = _plain_pcg_step(matvec, precond, *want[:4])
        assert all(_same_bits(t, k) for t, k in zip(state, kept))
        assert all(g.dtype == dtype and _same_bits(g, w) for g, w in zip(got, want))
        state = got[:4]


def _same_bits(a, b):
    """Equal bits, NaN included (n = 1 converges in one step, and the
    next step divides 0 by 0)."""
    ints = torch.int32 if a.dtype == torch.float32 else torch.int64
    return a.shape == b.shape and torch.equal(a.view(ints), b.view(ints))
