"""The port's CUDA kernels on the card (marked ``cuda``; they skip where no
GPU is visible). Run on a Hopper GPU with

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py configures JAX, which this file does
not use). Each kernel, called through its wrapper on CUDA tensors at small
shapes, is held to its plain PyTorch version on the same device and to the
float64 bound of ``spmv_f64_bound`` (per column for the SpMM kernels; for
the block SpGEMM, ``(n_ij + 2) * u * (|A||B|)_ij`` per entry, plus ``2 *
2^-8 * (|A||B|)_ij`` with bf16 blocks); the wrapper's launch count must
grow.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparse_matrix_tpu_torch.bench import corpus  # noqa: E402
from sparse_matrix_tpu_torch.formats.aligned import plan_aligned  # noqa: E402
from sparse_matrix_tpu_torch.formats.bcsr import BsrMatrix  # noqa: E402
from sparse_matrix_tpu_torch.formats.bell import plan_bell  # noqa: E402
from sparse_matrix_tpu_torch.formats.csr import CsrMatrix  # noqa: E402
from sparse_matrix_tpu_torch.formats.dia import try_dia_from_csr  # noqa: E402
from sparse_matrix_tpu_torch.formats.lanepack import plan_lanepack  # noqa: E402
from sparse_matrix_tpu_torch.formats.stripe import plan_stripe  # noqa: E402
from sparse_matrix_tpu_torch.ops import spgemm_block, spmm, spmv, spmv_bell, spmv_dia  # noqa: E402
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


@pytest.mark.parametrize("kind", ["dia", "aligned", "lanepack"])
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
        elif kind == "aligned":
            plan = plan_aligned(a)
            mv, x3 = spmm.aligned_matvec_multi(plan, 4, d), spmm.pack_rhs(B.to(d), a.cols)
            unpack = lambda y3: spmm.unpack_rhs(y3, a.rows)  # noqa: E731
        else:
            plan = plan_lanepack(a)
            mv = spmm.lanepack_matvec_multi(plan, 4, d)
            x3 = spmm.pack_rhs(B.to(d), a.cols, guard=plan.kw)
            unpack = lambda y3: spmm.unpack_rhs(y3, a.rows)  # noqa: E731
        res = cg_solve_multi(mv, x3, tol=1e-5, maxiter=2000, rhs_axis=1)
        out[d.type] = (res.iterations, unpack(res.x).double().cpu())
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 2
    assert torch.linalg.norm(out["cuda"][1] - out["cpu"][1]) <= 1e-4 * torch.linalg.norm(out["cpu"][1])


@pytest.mark.parametrize("k", [2, 8, 16])
@pytest.mark.parametrize("kw", [1, 4])
@pytest.mark.parametrize("pack", ["dense", "per_rb"])
def test_lanepack_spmm_kernel(dev, k, kw, pack):
    m = corpus.power_law_rows(np.random.default_rng(kw), 3000, 12)
    plan = plan_lanepack(m, kw=kw, pack=pack)
    arrs = spmv.lanepack_device_arrays(plan, dev)
    X_np = np.random.default_rng(k).standard_normal((m.cols, k)).astype(np.float32)
    X = torch.from_numpy(X_np).to(dev)
    x3 = spmm.pack_rhs(X, m.cols, guard=plan.kw)
    _run_multi("lanepack_spmm", m, X_np,
               lambda: spmm.unpack_rhs(spmm.spmm_lanepack_packed(plan, x3, device_arrays=arrs),
                                       m.rows),
               lambda: spmm.unpack_rhs(spmm._lanepack_spmm_torch(arrs, x3, cols=m.cols,
                                                                  kw=plan.kw), m.rows),
               lanepack=(plan,))


def test_aligned_spmm_spill_is_one_lanepack_spmm_launch(dev):
    from sparse_matrix_tpu_torch.native import kernels

    m = corpus.random_local(np.random.default_rng(2), 4096, 16, 1024)
    plan = plan_aligned(m)
    assert plan.spill is not None
    X = torch.ones((m.cols, 8), device=dev)
    before = dict(kernels.launch_counts)
    spmm.spmm_aligned(plan, X)
    torch.cuda.synchronize()
    got = {k: kernels.launch_counts[k] - before[k] for k in before}
    assert got["aligned_spmm"] == 1 and got["lanepack_spmm"] == 1 and got["lanepack"] == 0


BELL_MATRICES = {
    "randlocal": lambda: corpus.random_local(np.random.default_rng(2), 4096, 12, 300),
    "powerlaw_spill": lambda: corpus.power_law_rows(np.random.default_rng(0), 4096, 16),
}


def _bell_bf16_vals(m, plan):
    """``m``'s values as a bf16-plane BELL operator holds them: bf16-rounded
    where a plane slot holds the entry, f32 in the LanePack spill."""
    bias = 128 if plan.span == 128 else 0
    keys = []
    for li, d in enumerate(plan.ds):
        rb, ln = np.nonzero(plan.vals[li])
        pos = plan.lane[li][rb, ln].astype(np.int64) + bias
        col = (rb + d + (pos >> 7)) * 128 + (pos & 127)
        keys.append((rb * 128 + ln) * m.cols + col)
    held = np.isin(m.row_ids() * m.cols + m.indices.astype(np.int64), np.concatenate(keys))
    v = m.vals.astype(np.float32)
    vb = torch.from_numpy(v).to(torch.bfloat16).double().numpy()
    return np.where(held, vb, v.astype(np.float64))


@pytest.mark.parametrize("k", [2, 8, 16])
@pytest.mark.parametrize("span", [128, 256])
@pytest.mark.parametrize("vdt", [None, torch.bfloat16])
@pytest.mark.parametrize("name", list(BELL_MATRICES))
def test_bell_spmm_kernel(dev, name, span, vdt, k):
    m = BELL_MATRICES[name]()
    plan = plan_bell(m, span=span)
    assert min(plan.ds) < 0 < max(plan.ds)
    arrs = spmv_bell.bell_device_arrays(plan, dev, values_dtype=vdt)
    X_np = np.random.default_rng(k).standard_normal((m.cols, k)).astype(np.float32)
    X = torch.from_numpy(X_np).to(dev)
    vals = None if vdt is None else _bell_bf16_vals(m, plan)

    def plain():
        y3 = spmm._bell_spmm_torch(arrs["vals"], arrs["lane"], X, ds=plan.ds, modes=plan.modes,
                                   span=plan.span, cols=plan.cols)
        if plan.spill is not None:
            y3 = y3 + spmm._lanepack_spmm_torch(arrs["spill"], spmm.pack_rhs(X, m.cols),
                                                cols=m.cols, kw=plan.spill.kw)
        return spmm.unpack_rhs(y3, m.rows)

    _run_multi("bell_spmm", m, X_np, lambda: spmm.spmm_bell(plan, X, device_arrays=arrs), plain,
               vals=vals, lanepack=() if plan.spill is None else (plan.spill,))


def _with_empty_block_rows(rows, cols, seed):
    rng = np.random.default_rng(seed)
    r = rng.integers(0, rows - 96, 4000)
    r = np.where(r >= 64, r + 96, r)
    c = rng.integers(0, cols, 4000)
    return CsrMatrix.from_coo(rows, cols, r, c, rng.standard_normal(4000).astype(np.float32))


@pytest.mark.parametrize("f", [1, 130])
@pytest.mark.parametrize("bs", [32, 128])
def test_bcsr_spmm_kernel(dev, bs, f):
    m = _with_empty_block_rows(700, 650, bs)
    b = BsrMatrix.from_csr(m, bs)
    arrs = spmm.bcsr_device_arrays(b, dev)
    X_np = np.random.default_rng(f).standard_normal((m.cols, f)).astype(np.float32)
    X = torch.from_numpy(X_np).to(dev)

    def plain():
        fpad = -(-f // 128) * 128
        xf = torch.zeros((b.bcols * bs, fpad), device=dev)
        xf[: m.cols, :f] = X
        y = spmm._bcsr_torch(arrs, xf.reshape(b.bcols, bs, fpad), brows=b.brows)
        return y.reshape(-1, fpad)[: m.rows, :f]

    _run_multi("bcsr_spmm", m, X_np, lambda: spmm.spmm_bcsr(b, X, device_arrays=arrs), plain)
    assert int(torch.count_nonzero(spmm.spmm_bcsr(b, X, device_arrays=arrs)[64:160])) == 0


def _spgemm_bounded(a, b, c, *, bf16=False):
    assert spgemm_block.spgemm_err_over_bound(a, b, c, bf16=bf16) <= 1.0


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("bs", [32, 128])
def test_block_spgemm_kernel(dev, bs, storage):
    from sparse_matrix_tpu_torch.native import kernels

    u = corpus.random_uniform(np.random.default_rng(bs), 700, 0.01)
    u = CsrMatrix(u.rows, u.cols, u.vals.astype(np.float32), u.indices, u.offsets,
                  is_sorted=True)
    eng = spgemm_block.BlockSpgemm(u, u, device=dev, bs=bs, storage=storage)
    before = kernels.launch_counts["block_spgemm"]
    c_dev = eng.multiply_device()
    torch.cuda.synchronize()
    assert kernels.launch_counts["block_spgemm"] == before + 1
    c_plain = spgemm_block._block_numeric_torch(eng.a_blocks, eng.b_blocks, eng.pair_a,
                                                eng.pair_b, eng.pair_c,
                                                num_c=len(eng.c_keys), bs=bs)
    scale = float(c_plain.abs().max())
    assert float((c_dev - c_plain).abs().max()) <= 2e-5 * max(1.0, scale)
    _spgemm_bounded(u, u, eng.multiply(), bf16=storage == "bf16")
    _spgemm_bounded(u, u, spgemm_block.spgemm_block_device(u, u, device=dev, bs=bs))


def test_block_spgemm_empty_pairs_launches_nothing(dev):
    from sparse_matrix_tpu_torch.native import kernels

    a = CsrMatrix.from_coo(64, 64, [0, 5], [40, 41], np.ones(2, np.float32))
    b = CsrMatrix.from_coo(64, 64, [1, 2], [3, 4], np.ones(2, np.float32))
    before = kernels.launch_counts["block_spgemm"]
    assert spgemm_block.spgemm_block_device(a, b, device=dev, bs=32).nnz() == 0
    assert spgemm_block.BlockSpgemm(a, b, device=dev, bs=32).multiply().nnz() == 0
    assert kernels.launch_counts["block_spgemm"] == before


@pytest.mark.parametrize("force", ["bell", "lanepack", "hybrid"])
def test_matmat_on_card_matches_cpu(dev, force):
    from sparse_matrix_tpu_torch.ops.operator import SpmvOperator

    a = poisson_2d_csr(48, dtype=np.float32)
    if force == "hybrid":
        rng = np.random.default_rng(6)
        r = np.r_[a.row_ids(), rng.integers(0, a.rows, 300)]
        c = np.r_[a.indices.astype(np.int64), rng.integers(0, a.cols, 300)]
        a = CsrMatrix.from_coo(a.rows, a.cols, r, c,
                               np.r_[a.vals, rng.standard_normal(300).astype(np.float32)])
    X = torch.from_numpy(np.random.default_rng(7).standard_normal((a.cols, 8)).astype(np.float32))
    y_gpu = SpmvOperator(a, device=dev, force=force).matmat(X.to(dev)).cpu()
    y_cpu = SpmvOperator(a, device="cpu", force=force).matmat(X)
    assert torch.max(torch.abs(y_gpu - y_cpu)) <= 2e-5 * max(1.0, float(y_cpu.abs().max()))


def _f32(m):
    return CsrMatrix(m.rows, m.cols, m.vals.astype(np.float32), m.indices, m.offsets,
                     is_sorted=m.is_sorted)


def _expand_cases():
    """A padded plan (random uniform squared) and an unpadded one (64 x 1
    times 1 x 32: 2,048 products, two whole slabs)."""
    u = _f32(corpus.random_uniform(np.random.default_rng(11), 700, 0.01))
    rng = np.random.default_rng(12)
    col = CsrMatrix.from_coo(64, 1, np.arange(64), np.zeros(64, np.int64),
                             rng.standard_normal(64).astype(np.float32))
    row = CsrMatrix.from_coo(1, 32, np.zeros(32, np.int64), np.arange(32),
                             rng.standard_normal(32).astype(np.float32))
    return {"padded": (u, u), "unpadded": (col, row)}


@pytest.mark.parametrize("case", ["padded", "unpadded"])
def test_esc_expand_kernel(dev, case):
    from sparse_matrix_tpu_torch.native import kernels
    from sparse_matrix_tpu_torch.ops import esc_expand

    a, b = _expand_cases()[case]
    plan = esc_expand.plan_expand_kmajor(a, b)
    assert (plan.num_slabs * 1024 > plan.num_products) == (case == "padded")
    arrs = esc_expand.expand_device_arrays(plan, dev)
    lv = torch.from_numpy(a.vals[plan.perm_csc]).to(dev)
    rv = torch.from_numpy(b.vals).to(dev)
    before = kernels.launch_counts["esc_expand"]
    p = esc_expand.expand_products(plan, lv, rv, device_arrays=arrs)
    torch.cuda.synchronize()
    assert kernels.launch_counts["esc_expand"] == before + 1
    plain = esc_expand._expand_torch(lv, rv, arrs["lv_lane"], arrs["rv_lane"], arrs["lv_off"],
                                     arrs["rv_off"], num_products=plan.num_products)
    n = plan.num_products
    assert p.shape == plain.shape == (plan.num_slabs * 1024,)
    assert torch.equal(p[:n], plain[:n]) and not p[n:].any()
    cpu = esc_expand.expand_products(plan, lv.cpu(), rv.cpu())
    assert torch.equal(p.cpu(), cpu)
    with pytest.raises(ValueError, match="f32"):
        esc_expand.expand_products(plan, lv.double(), rv.double(), device_arrays=arrs)


@pytest.mark.parametrize("reduce", ["sort", "spmv"])
@pytest.mark.parametrize("engine", ["pallas", "xla"])
def test_esc_spgemm_on_card_matches_cpu(dev, engine, reduce):
    from sparse_matrix_tpu_torch.native import kernels
    from sparse_matrix_tpu_torch.ops.device_sorted import EscSpgemm

    u = _expand_cases()["padded"][0]
    before = kernels.launch_counts["esc_expand"]
    eng = EscSpgemm(u, u, device=dev, engine=engine, reduce=reduce)
    c = eng.multiply()
    assert (kernels.launch_counts["esc_expand"] > before) == (engine == "pallas")
    want = EscSpgemm(u, u, device="cpu", engine=engine, reduce=reduce).multiply()
    assert np.array_equal(c.offsets, want.offsets) and np.array_equal(c.indices, want.indices)
    _spgemm_bounded(u, u, c)
    nv = np.random.default_rng(13).standard_normal(u.nnz()).astype(np.float32)
    u2 = CsrMatrix(u.rows, u.cols, nv, u.indices, u.offsets, is_sorted=True)
    from sparse_matrix_tpu_torch.ops.device_sorted import padded_to_host

    _spgemm_bounded(u2, u, padded_to_host(eng.multiply_device(lhs_vals=torch.from_numpy(nv))))


def test_device_ops_on_card_match_host(dev):
    from sparse_matrix_tpu_torch.formats.device import DeviceCsr
    from sparse_matrix_tpu_torch.ops.device_sorted import add_device, padded_to_host, sub_device
    from sparse_matrix_tpu_torch.ops.device_sorted import transpose_device

    a = _f32(corpus.random_uniform(np.random.default_rng(14), 500, 0.02))
    b = _f32(corpus.random_uniform(np.random.default_rng(15), 500, 0.02))
    da, db = DeviceCsr.from_host(a, device=dev), DeviceCsr.from_host(b, device=dev)
    for got, want in ((transpose_device(da).to_host(), a.transpose()),
                      (padded_to_host(add_device(da, db)), a + b),
                      (padded_to_host(sub_device(da, db)), a - b)):
        for f in ("offsets", "indices", "vals"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f


def test_spgemm_auto_on_card_takes_band_convolution(dev, monkeypatch):
    from sparse_matrix_tpu_torch.ops import spgemm_dia
    from sparse_matrix_tpu_torch.utils import autotune

    monkeypatch.setitem(autotune.DEFAULTS, "device_call_sync_s", 0.0)
    called = []
    real = spgemm_dia.spgemm_dia

    def spy(a, b, *, device):
        called.append(device)
        return real(a, b, device=device)

    monkeypatch.setattr(spgemm_dia, "spgemm_dia", spy)
    a = poisson_2d_csr(64, dtype=np.float32)
    c = spgemm_block.spgemm_auto(a, a, device=dev)
    assert called and called[0].type == "cuda"
    _spgemm_bounded(a, a, c)
