"""HPCG on the port (``solvers/hpcg.py``, ``ops/symgs.py`` and the
``"symgs"`` hierarchy of ``solvers/amg.py``) against the plain reference
``sparse_matrix_tpu_torch/reference/hpcg.py``, on the CPU in float64.

Tolerances: the port and the reference compute the same operations in
float64 with the sums taken in other orders (the port gathers a row's 26
products and sums them; the reference adds the zero-padded grid one axis
at a time), so each result differs by a few units of roundoff (1.1e-16)
of its size. One V-cycle is a fixed linear map of a few dozen such steps:
1e-13 relative is some thousand roundoffs. A 50-iteration set carries each
iteration's rounding into the next; at these sizes it converges to the
roundoff level, and 1e-12 relative leaves a factor of a thousand over
what the two differ by (2e-16 to 3e-16 measured).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparse_matrix_tpu_torch.formats.dia import try_dia_from_csr  # noqa: E402
from sparse_matrix_tpu_torch.ops import symgs  # noqa: E402
from sparse_matrix_tpu_torch.reference import hpcg as ref  # noqa: E402
from sparse_matrix_tpu_torch.solvers import amg  # noqa: E402
from sparse_matrix_tpu_torch.solvers.hpcg import (coarse_points, hpcg_hierarchy,  # noqa: E402
                                                  hpcg_problem)

GRIDS = [(16, 16, 16), (24, 16, 8)]


def _rhs(nx, ny, nz, seed):
    """``A u`` for a seeded standard normal u, as the benchmark's pool."""
    u = torch.from_numpy(np.random.default_rng(seed).standard_normal(nx * ny * nz))
    return ref.apply_a(u.reshape(nz, ny, nx)).reshape(-1)


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("grid", [(1, 1, 1), (2, 3, 4), (16, 16, 16), (24, 16, 8), (13, 13, 13)])
def test_problem_nnz_and_rhs(grid):
    """nnz is (3 nx - 2)(3 ny - 2)(3 nz - 2), (3n - 2)^3 on a cube; rows
    are sorted with 26 on the diagonal and -1 elsewhere; b = A 1."""
    nx, ny, nz = grid
    a, b = hpcg_problem(nx, ny, nz)
    assert a.rows == a.cols == nx * ny * nz
    assert a.nnz() == (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)
    rids = a.row_ids()
    cols = a.indices.astype(np.int64)
    assert np.all(np.diff(cols)[np.diff(rids) == 0] > 0)
    assert np.all(a.vals == np.where(cols == rids, 26.0, -1.0))
    np.testing.assert_array_equal(b, np.bincount(rids, weights=a.vals, minlength=a.rows))
    np.testing.assert_array_equal(b, ref.hpcg_rhs(nx, ny, nz).numpy())


def test_problem_operator_is_the_reference_stencil():
    """The CSR's product equals the reference's grid operator."""
    nx, ny, nz = 6, 5, 4
    a, _ = hpcg_problem(nx, ny, nz)
    x = np.random.default_rng(2).standard_normal(a.rows)
    y = a.to_dense() @ x
    want = ref.apply_a(torch.from_numpy(x).reshape(nz, ny, nx)).reshape(-1).numpy()
    np.testing.assert_allclose(y, want, rtol=0, atol=1e-13)


@pytest.mark.parametrize("grid", GRIDS + [(13, 13, 13), (2, 2, 2)])
def test_parity_colours_couple_no_rows(grid):
    """No nonzero slot couples two rows of one parity colour; a colouring
    that does (every row one colour) is refused by the plan."""
    a, _ = hpcg_problem(*grid)
    dia = try_dia_from_csr(a, dtype=np.float64)
    colors = symgs.parity_colors(*grid)
    assert colors.min() == 0 and colors.max() == 7
    assert symgs.coupled_same_color(dia, colors) == 0
    with pytest.raises(ValueError, match="couples"):
        symgs.SymgsPlan(dia, np.zeros(a.rows, dtype=np.int64), device="cpu")


def _sequential_symgs(a, x, r, order):
    """Gauss-Seidel row by row in ``order``, then in reverse: the plain
    loop the colour passes must equal."""
    x = x.copy()
    dense = a.to_dense()
    for i in (*order, *order[::-1]):
        row = dense[i]
        x[i] = (r[i] - (row @ x - row[i] * x[i])) / row[i]
    return x


@pytest.mark.parametrize("grid", [(4, 4, 4), (6, 4, 2), (3, 5, 2)])
def test_colour_symgs_equals_sequential_sweep(grid):
    """One colour-ordered SymGS step (the plain version of the kernel)
    equals a row-by-row forward and backward sweep over the rows sorted by
    colour, natural order within a colour (the same order of updates);
    within 1e-14 relative, the sums being taken in other orders."""
    a, _ = hpcg_problem(*grid)
    rng = np.random.default_rng(7)
    x0, r = rng.standard_normal(a.rows), rng.standard_normal(a.rows)
    colors = symgs.parity_colors(*grid)
    plan = symgs.SymgsPlan(try_dia_from_csr(a, dtype=np.float64), colors, device="cpu")
    got = plan.step(torch.from_numpy(x0.copy()), torch.from_numpy(r)).numpy()
    want = _sequential_symgs(a, x0, r, list(np.argsort(colors, kind="stable")))
    np.testing.assert_allclose(got, want, rtol=1e-14, atol=1e-14)
    # the natural order is another Gauss-Seidel: the colours change the answer
    natural = _sequential_symgs(a, x0, r, list(range(a.rows)))
    assert not np.allclose(got, natural, rtol=1e-6)


def test_symgs_step_in_float32_and_blocks():
    """The plain step runs in float32 within 1e-6 of float64 (a few
    float32 roundoffs, 6e-8 each, over a step); a step takes vectors only,
    and an (n, K) block is refused."""
    grid = (8, 6, 4)
    a, _ = hpcg_problem(*grid)
    dia = try_dia_from_csr(a, dtype=np.float64)
    colors = symgs.parity_colors(*grid)
    r = torch.from_numpy(np.random.default_rng(8).standard_normal(a.rows))
    p64 = symgs.SymgsPlan(dia, colors, device="cpu")
    p32 = symgs.SymgsPlan(dia, colors, device="cpu", dtype=torch.float32)
    x64 = p64.step(torch.zeros(a.rows, dtype=torch.float64), r)
    x32 = p32.step(torch.zeros(a.rows), r.float())
    assert x32.dtype == torch.float32 and _rel(x32.double(), x64) < 1e-6
    block = torch.stack([r, r], dim=1)
    with pytest.raises(ValueError, match="vectors"):
        p64.step(torch.zeros_like(block), block)


@pytest.mark.parametrize("grid", [(12, 16, 16), (16, 16, 4), (16, 16, 20)])
def test_hierarchy_refuses_indivisible_grid(grid):
    """Four levels need every side divisible by 8, as HPCG requires."""
    with pytest.raises(ValueError, match="not divisible"):
        hpcg_hierarchy(*grid, device="cpu")


def test_hierarchy_levels():
    """Four levels 16^3 .. 2^3: three smoothed levels with their injection
    at HPCG's f2c points and a coarsest level smoothed from zero; every
    level's operator is DIA and carries its colouring's plan."""
    h = hpcg_hierarchy(16, 16, 16, device="cpu")
    assert [lv.n for lv in h.levels] == [4096, 512, 64] and h.coarse_level.n == 8
    assert h.coarse_inv is None and h.smoother == "symgs" and h.nu == 1
    assert h.dtype == torch.float64 and h.device == torch.device("cpu")
    for lv in h.levels + [h.coarse_level]:
        assert lv.a_op.format == "dia" and lv.symgs.colors == 8
    f2c = coarse_points(16, 16, 16)
    assert f2c[:3].tolist() == [0, 2, 4] and f2c[8] == 2 * 16 and f2c[64] == 2 * 256
    v = torch.arange(4096, dtype=torch.float64)
    assert torch.equal(h.levels[0].pt_op(v), v[torch.from_numpy(f2c)])
    up = h.levels[0].p_op(torch.ones(512, dtype=torch.float64))
    assert float(up.sum()) == 512 and torch.equal(up[torch.from_numpy(f2c)], torch.ones(512,
                                                                                        dtype=torch.float64))


@pytest.mark.parametrize("grid", GRIDS)
def test_vcycle_matches_reference(grid):
    nx, ny, nz = grid
    h = hpcg_hierarchy(nx, ny, nz, device="cpu")
    r = _rhs(nx, ny, nz, 11)
    want = ref.vcycle(r.reshape(nz, ny, nx), 4).reshape(-1)
    assert _rel(h.vcycle(r), want) < 1e-13
    assert _rel(h.preconditioner()(r), want) < 1e-13


@pytest.mark.parametrize("grid", GRIDS)
@pytest.mark.parametrize("seed", [0, 2**33 + 5])
def test_set_matches_reference(grid, seed):
    """A whole set, 50 iterations at tol 0 through ``amg_pcg_solve``,
    against the reference's ``cg_set`` on the same b."""
    nx, ny, nz = grid
    a, b0 = hpcg_problem(nx, ny, nz)
    b = torch.from_numpy(b0) if seed == 0 else _rhs(nx, ny, nz, seed)
    h = hpcg_hierarchy(nx, ny, nz, device="cpu")
    res = amg.amg_pcg_solve(a, b, hierarchy=h, tol=0.0, maxiter=50)
    want = ref.cg_set(b, nx, ny, nz, levels=4, maxiter=50)
    assert res.iterations == want.iterations == 50
    assert _rel(res.x, want.x) < 1e-12
    r = b - ref.apply_a(res.x.reshape(nz, ny, nx)).reshape(-1)
    assert float(r.norm() / b.norm()) < 1e-12


def test_set_in_float32_is_not_the_float64_set():
    """The reference in float32 (the benchmark's control) stays some 1e-7
    away from the float64 set, far past the 1e-12 the port keeps. (20
    iterations: at 16^3 the float32 recurrence's residual falls so far by
    50 that r.z underflows and the set ends in NaN.)"""
    nx, ny, nz = 16, 16, 16
    b = _rhs(nx, ny, nz, 3)
    x64 = ref.cg_set(b, nx, ny, nz, maxiter=20).x
    x32 = ref.cg_set(b.float(), nx, ny, nz, maxiter=20).x
    assert x32.dtype == torch.float32 and _rel(x32.double(), x64) > 1e-9


def test_hierarchy_spans_and_counts():
    """The build is the span ``spmx.plan.hpcg``; a V-cycle holds 7
    ``spmx.amg.symgs`` steps (two on each of three levels, one on the
    coarsest, inside ``spmx.amg.coarse``)."""
    from sparse_matrix_tpu_torch.utils import profiling

    profiling.take()
    profiling.enable()
    try:
        h = hpcg_hierarchy(16, 16, 16, device="cpu")
        h.vcycle(_rhs(16, 16, 16, 1))
    finally:
        profiling.disable()
    spans = profiling.take()
    names = [s.name for s in spans]
    assert names.count("spmx.plan.hpcg") == 1 and spans[0].name == "spmx.plan.hpcg"
    assert names.count("spmx.plan.operator") == 4
    assert names.count("spmx.amg.symgs") == 7
    coarse = names.index("spmx.amg.coarse")
    assert spans[coarse + 1].name == "spmx.amg.symgs" and spans[coarse + 1].parent == coarse


def test_hierarchy_needs_plans_and_one_coarse_solve():
    """The ``"symgs"`` smoother needs a plan on every level it smooths; a
    hierarchy takes exactly one of ``coarse_inv`` and ``coarse_level``."""
    h = hpcg_hierarchy(16, 16, 16, device="cpu")
    bare = h.levels[0]._replace(symgs=None)
    with pytest.raises(ValueError, match="SymgsPlan"):
        amg.AmgHierarchy([bare], None, coarse_level=h.coarse_level, smoother="symgs", nu=1)
    with pytest.raises(ValueError, match="coarse"):
        amg.AmgHierarchy(h.levels, None, smoother="symgs", nu=1)
    with pytest.raises(ValueError, match="coarse"):
        amg.AmgHierarchy(h.levels, torch.eye(8, dtype=torch.float64),
                         coarse_level=h.coarse_level, smoother="symgs", nu=1)
    # HPCG's levels carry no inverse diagonal: Jacobi on them is refused
    with pytest.raises(ValueError, match="dinv"):
        amg.AmgHierarchy(h.levels, None, coarse_level=h.coarse_level, smoother="jacobi",
                         nu=1, omega=0.6)


def test_graph_key_holds_what_can_change():
    """The graph key holds the smoother and its knobs, which a caller may
    change after the build, and not the coarse solve, which the build
    fixes; a V-cycle reads ``nu`` when it runs."""
    h = hpcg_hierarchy(16, 16, 16, device="cpu")
    assert h._graph_key() == ("symgs", 1, None)
    h.nu = 2
    assert h._graph_key() == ("symgs", 2, None)
    r = _rhs(16, 16, 16, 3)
    two = h.vcycle(r)
    h.nu = 1
    assert not torch.equal(two, h.vcycle(r))
