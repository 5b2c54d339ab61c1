"""The port's CUDA kernels on the card (marked ``cuda``; they skip where no
GPU is visible). Run on a Hopper GPU with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX, which this file does
not use). Each kernel, called through its wrapper on CUDA tensors at small
shapes, is held to its plain PyTorch version on the same device and to the
float64 bound of ``spmv_f64_bound``; the wrapper's launch count must grow.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparse_matrix_tpu.formats.aligned import plan_aligned  # noqa: E402
from sparse_matrix_tpu.formats.bell import plan_bell  # noqa: E402
from sparse_matrix_tpu.formats.csr import CsrMatrix  # noqa: E402
from sparse_matrix_tpu.formats.dia import try_dia_from_csr  # noqa: E402
from sparse_matrix_tpu.formats.lanepack import plan_lanepack  # noqa: E402
from sparse_matrix_tpu_torch.bench import corpus  # noqa: E402
from sparse_matrix_tpu_torch.ops import spmv, spmv_bell, spmv_dia  # noqa: E402
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
