"""The port's CUDA kernels on the card (marked ``cuda``; they skip where no
GPU is visible). Run on a Hopper GPU with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX, which this file does
not use). Each kernel, called through its wrapper on CUDA tensors at small
shapes, is held to its plain PyTorch version on the same device and to the
float64 bound of ``spmv_f64_bound`` (per column for the SpMM kernels); the
wrapper's launch count must grow.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparse_matrix_tpu_torch.bench import corpus  # noqa: E402
from sparse_matrix_tpu_torch.formats.aligned import plan_aligned  # noqa: E402
from sparse_matrix_tpu_torch.formats.bell import plan_bell  # noqa: E402
from sparse_matrix_tpu_torch.formats.csr import CsrMatrix  # noqa: E402
from sparse_matrix_tpu_torch.formats.dia import try_dia_from_csr  # noqa: E402
from sparse_matrix_tpu_torch.formats.lanepack import plan_lanepack  # noqa: E402
from sparse_matrix_tpu_torch.formats.stripe import plan_stripe  # noqa: E402
from sparse_matrix_tpu_torch.ops import spmm, spmv, spmv_bell, spmv_dia  # noqa: E402
from sparse_matrix_tpu_torch.solvers.poisson import poisson_2d_csr  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (compute capability 9.0)")
    from sparse_matrix_tpu_torch.device import require_device

    return require_device("cuda")


def _run(kernel, m, x_np, dev, run, plain, **bound_kw):
    from sparse_matrix_tpu_torch.native import kernels

    before = kernels.launch_counts[kernel]
    y = run()
    torch.cuda.synchronize()
    assert kernels.launch_counts[kernel] > before
    assert y.is_cuda and y.shape == (m.rows,)
    y_plain = plain()
    y64, bound = spmv.spmv_f64_bound(m, x_np, **bound_kw)
    yk = y.double().cpu().numpy()
    assert np.all(np.abs(yk - y64) <= bound)
    assert np.all(np.abs(y_plain.double().cpu().numpy() - y64) <= bound)


def _x(m, dev, seed=0):
    x = np.random.default_rng(seed).standard_normal(m.cols).astype(np.float32)
    return x, torch.from_numpy(x).to(dev)


@pytest.mark.parametrize("shape", ["poisson", "rect_wide", "rect_tall"])
@pytest.mark.parametrize("vdt", [None, torch.bfloat16])
def test_dia_kernel(dev, shape, vdt):
    if shape == "poisson":
        m = poisson_2d_csr(40, dtype=np.float32)
    else:
        rows, cols = (300, 900) if shape == "rect_wide" else (900, 300)
        rng = np.random.default_rng(1)
        r = np.repeat(np.arange(rows), 5)
        c = r + np.tile([-200, -1, 0, 3, 250], rows)
        keep = (c >= 0) & (c < cols)
        m = CsrMatrix.from_coo(rows, cols, r[keep], c[keep],
                               rng.standard_normal(int(keep.sum())).astype(np.float32))
    dia = try_dia_from_csr(m)
    arrs = spmv_dia.dia_device_arrays(dia, dev, values_dtype=vdt)
    x_np, x = _x(m, dev)
    vals = None if vdt is None else torch.from_numpy(m.vals.astype(np.float32)).to(vdt).double().numpy()
    _run("dia", m, x_np, dev,
         lambda: spmv_dia.spmv_dia(dia, x, device_arrays=arrs),
         lambda: spmv_dia._spmv_dia_torch(arrs["data"], x, offsets=dia.offsets,
                                          rows=dia.rows, cols=dia.cols),
         vals=vals)


@pytest.mark.parametrize("name", ["poisson", "randlocal_spill"])
def test_aligned_kernel(dev, name):
    if name == "poisson":
        m = poisson_2d_csr(64, dtype=np.float32)
    else:
        m = corpus.random_local(np.random.default_rng(2), 4096, 16, 1024)
    plan = plan_aligned(m)
    assert (plan.spill is not None) == (name != "poisson")
    arrs = spmv.aligned_device_arrays(plan, dev)
    x_np, x = _x(m, dev)

    def plain():
        y = spmv._aligned_torch(arrs, x, rows=plan.rows, cols=plan.cols)
        if plan.spill is not None:
            y = y + spmv._lanepack_torch(arrs["spill"], x, rows=plan.rows,
                                         cols=plan.cols, kw=plan.spill.kw)
        return y

    _run("aligned", m, x_np, dev, lambda: spmv.spmv_aligned(plan, x, device_arrays=arrs),
         plain, lanepack=() if plan.spill is None else (plan.spill,))


@pytest.mark.parametrize("kw", [1, 2, 4])
@pytest.mark.parametrize("pack", ["dense", "per_rb"])
def test_lanepack_kernel(dev, kw, pack):
    m = corpus.power_law_rows(np.random.default_rng(kw), 3000, 12)
    plan = plan_lanepack(m, kw=kw, pack=pack)
    arrs = spmv.lanepack_device_arrays(plan, dev)
    x_np, x = _x(m, dev)
    _run("lanepack", m, x_np, dev,
         lambda: spmv.spmv_lanepack(plan, x, device_arrays=arrs),
         lambda: spmv._lanepack_torch(arrs, x, rows=plan.rows, cols=plan.cols, kw=plan.kw),
         lanepack=(plan,))


@pytest.mark.parametrize("span", [128, 256])
@pytest.mark.parametrize("vdt", [None, torch.bfloat16])
def test_bell_kernel(dev, span, vdt):
    m = corpus.fem_like(np.random.default_rng(3), 64, 2)
    plan = plan_bell(m, span=span)
    arrs = spmv_bell.bell_device_arrays(plan, dev, values_dtype=vdt)
    x_np, x = _x(m, dev)
    vals = None if vdt is None else torch.from_numpy(m.vals.astype(np.float32)).to(vdt).double().numpy()

    def plain():
        y = spmv_bell._bell_torch(arrs["vals"], arrs["lane"], x, ds=plan.ds, modes=plan.modes,
                                  span=plan.span, rows=plan.rows, cols=plan.cols)
        if plan.spill is not None:
            y = y + spmv._lanepack_torch(arrs["spill"], x, rows=plan.rows,
                                         cols=plan.cols, kw=plan.spill.kw)
        return y

    _run("bell", m, x_np, dev, lambda: spmv_bell.spmv_bell(plan, x, device_arrays=arrs),
         plain, vals=vals, lanepack=() if plan.spill is None else (plan.spill,))


@pytest.mark.parametrize("force", [None, "aligned", "bell", "lanepack"])
def test_cg_on_card_matches_cpu(dev, force):
    from sparse_matrix_tpu_torch.ops.operator import SpmvOperator
    from sparse_matrix_tpu_torch.solvers.cg import cg_solve

    a = poisson_2d_csr(48, dtype=np.float32)
    b = torch.from_numpy(np.random.default_rng(4).standard_normal(a.rows).astype(np.float32))
    res_gpu = cg_solve(SpmvOperator(a, device=dev, force=force), b.to(dev), tol=1e-5)
    res_cpu = cg_solve(SpmvOperator(a, device="cpu", force=force), b, tol=1e-5)
    assert abs(res_gpu.iterations - res_cpu.iterations) <= 2
    x_g, x_c = res_gpu.x.cpu().double(), res_cpu.x.double()
    assert torch.linalg.norm(x_g - x_c) <= 1e-4 * torch.linalg.norm(x_c)


def test_wrapper_refuses_wrong_dtype(dev):
    m = poisson_2d_csr(8, dtype=np.float32)
    dia = try_dia_from_csr(m)
    arrs = spmv_dia.dia_device_arrays(dia, dev)
    with pytest.raises(TypeError, match="dtype"):
        spmv_dia.spmv_dia(dia, torch.zeros(m.cols, dtype=torch.float64, device=dev),
                          device_arrays=arrs)


@pytest.mark.parametrize("mode,levels,kw", [
    ("scan", 1, 1), ("scan", 2, 2), ("scan", 8, 16),
    ("select", 1, 1), ("select", 4, 2), ("select", 8, 8),
])
def test_stripe_kernel(dev, mode, levels, kw):
    m = corpus.power_law_rows(np.random.default_rng(levels + kw), 3000, 12)
    plan = plan_stripe(m, mode=mode, levels=levels, kw=kw)
    assert plan.lane.dtype == (np.int8 if plan.kw == 1 else np.int16)
    if mode == "select":
        assert plan.spill is not None and plan.spill.mode == "scan"
    arrs = spmv.stripe_device_arrays(plan, dev)
    x_np, x = _x(m, dev)

    def plain():
        y = spmv._stripe_torch(arrs, x, rows=plan.rows, cols=plan.cols, lvl=plan.levels,
                               kw=plan.kw, scan=plan.mode == "scan")
        if plan.spill is not None:
            y = y + spmv.spmv_stripe(plan.spill, x.cpu()).to(dev)
        return y

    _run("stripe", m, x_np, dev, lambda: spmv.spmv_stripe(plan, x, device_arrays=arrs),
         plain, stripe=(plan,))


def test_stripe_kernel_empty_plan_launches_nothing(dev):
    from sparse_matrix_tpu_torch.native import kernels

    m = CsrMatrix.from_coo(300, 300, np.zeros(0, np.int64), np.zeros(0, np.int64),
                           np.zeros(0, np.float32))
    plan = plan_stripe(m, mode="scan", levels=2, kw=1)
    before = kernels.launch_counts["stripe"]
    y = spmv.spmv_stripe(plan, torch.ones(300, device=dev))
    assert kernels.launch_counts["stripe"] == before
    assert y.shape == (300,) and int(torch.count_nonzero(y)) == 0


def _run_multi(kernel, m, X_np, run, plain, **bound_kw):
    from sparse_matrix_tpu_torch.native import kernels

    before = kernels.launch_counts[kernel]
    Y = run()
    torch.cuda.synchronize()
    assert kernels.launch_counts[kernel] > before
    assert Y.is_cuda and Y.shape == (m.rows, X_np.shape[1])
    Yk, Yp = Y.double().cpu().numpy(), plain().double().cpu().numpy()
    for q in range(X_np.shape[1]):
        y64, bound = spmv.spmv_f64_bound(m, X_np[:, q], **bound_kw)
        assert np.all(np.abs(Yk[:, q] - y64) <= bound)
        assert np.all(np.abs(Yp[:, q] - y64) <= bound)


@pytest.mark.parametrize("k", [2, 8, 16])
@pytest.mark.parametrize("vdt", [None, torch.bfloat16])
def test_dia_spmm_kernel(dev, k, vdt):
    m = poisson_2d_csr(40, dtype=np.float32)
    dia = try_dia_from_csr(m)
    arrs = spmv_dia.dia_device_arrays(dia, dev, values_dtype=vdt)
    X_np = np.random.default_rng(k).standard_normal((m.cols, k)).astype(np.float32)
    X = torch.from_numpy(X_np).to(dev)
    vals = None if vdt is None else torch.from_numpy(m.vals).to(vdt).double().numpy()
    _run_multi("dia_spmm", m, X_np,
               lambda: spmv_dia.spmm_dia_stream(dia, X, device_arrays=arrs),
               lambda: spmv_dia._spmm_dia_torch(arrs["data"], X, offsets=dia.offsets,
                                                rows=dia.rows),
               vals=vals)


def test_dia_matvec_multi_keeps_guards_zero(dev):
    m = poisson_2d_csr(40, dtype=np.float32)
    dia = try_dia_from_csr(m)
    X = torch.from_numpy(np.random.default_rng(0).standard_normal((m.cols, 4))
                         .astype(np.float32)).to(dev)
    x3 = spmv_dia.dia_pack_rhs(dia, X)
    y3 = spmv_dia.dia_matvec_multi(dia, 4, dev)(x3)
    lo = -min(0, min(dia.offsets)) // 128 + 1
    body = y3[lo : lo + -(-m.rows // 128)].transpose(1, 2).reshape(-1, 4)
    assert y3.shape == x3.shape
    assert int(torch.count_nonzero(y3[:lo])) == 0
    assert int(torch.count_nonzero(y3[lo + -(-m.rows // 128):])) == 0
    assert int(torch.count_nonzero(body[m.rows:])) == 0


@pytest.mark.parametrize("k", [2, 8, 16])
@pytest.mark.parametrize("name", ["poisson", "randlocal_spill"])
def test_aligned_spmm_kernel(dev, k, name):
    if name == "poisson":
        m = poisson_2d_csr(64, dtype=np.float32)
    else:
        m = corpus.random_local(np.random.default_rng(2), 4096, 16, 1024)
    plan = plan_aligned(m)
    assert (plan.spill is not None) == (name != "poisson")
    arrs = spmv.aligned_device_arrays(plan, dev)
    X_np = np.random.default_rng(k).standard_normal((m.cols, k)).astype(np.float32)
    X = torch.from_numpy(X_np).to(dev)

    def plain():
        y3 = torch.zeros((plan.r128, k, 128), device=dev)
        x3 = spmm.pack_rhs(X, plan.cols)
        y3 += spmm._aligned_spmm_torch(arrs, x3, rows=plan.rows)
        if plan.spill is not None:
            y3 = y3 + spmm.pack_rhs(torch.stack(
                [spmv._lanepack_torch(arrs["spill"], X[:, q], rows=plan.rows,
                                      cols=plan.cols, kw=plan.spill.kw) for q in range(k)],
                dim=1), plan.rows)[: plan.r128]
        return spmm.unpack_rhs(y3, plan.rows)

    _run_multi("aligned_spmm", m, X_np,
               lambda: spmm.spmm_aligned(plan, X, device_arrays=arrs), plain,
               lanepack=() if plan.spill is None else (plan.spill,))


@pytest.mark.parametrize("kind", ["dia", "aligned"])
def test_cg_solve_multi_on_card_matches_cpu(dev, kind):
    from sparse_matrix_tpu_torch.solvers.cg import cg_solve_multi

    a = poisson_2d_csr(48, dtype=np.float32)
    B = torch.from_numpy(np.random.default_rng(5).standard_normal((a.rows, 4))
                         .astype(np.float32))
    out = {}
    for d in (dev, torch.device("cpu")):
        if kind == "dia":
            dia = try_dia_from_csr(a)
            mv, x3 = spmv_dia.dia_matvec_multi(dia, 4, d), spmv_dia.dia_pack_rhs(dia, B.to(d))
            unpack = lambda y3: spmv_dia.dia_unpack_rhs(dia, y3)  # noqa: E731
        else:
            plan = plan_aligned(a)
            mv, x3 = spmm.aligned_matvec_multi(plan, 4, d), spmm.pack_rhs(B.to(d), a.cols)
            unpack = lambda y3: spmm.unpack_rhs(y3, a.rows)  # noqa: E731
        res = cg_solve_multi(mv, x3, tol=1e-5, maxiter=2000, rhs_axis=1)
        out[d.type] = (res.iterations, unpack(res.x).double().cpu())
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 2
    assert torch.linalg.norm(out["cuda"][1] - out["cpu"][1]) <= 1e-4 * torch.linalg.norm(out["cpu"][1])
