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


def _held(kernel, m, x_np, dev, run, plain, **bound_kw):
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
    _held("dia", m, x_np, dev,
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

    _held("aligned", m, x_np, dev, lambda: spmv.spmv_aligned(plan, x, device_arrays=arrs),
         plain, lanepack=() if plan.spill is None else (plan.spill,))


@pytest.mark.parametrize("kw", [1, 2, 4])
@pytest.mark.parametrize("pack", ["dense", "per_rb"])
def test_lanepack_kernel(dev, kw, pack):
    m = corpus.power_law_rows(np.random.default_rng(kw), 3000, 12)
    plan = plan_lanepack(m, kw=kw, pack=pack)
    arrs = spmv.lanepack_device_arrays(plan, dev)
    x_np, x = _x(m, dev)
    _held("lanepack", m, x_np, dev,
         lambda: spmv.spmv_lanepack(plan, x, device_arrays=arrs),
         lambda: spmv._lanepack_torch(arrs, x, rows=plan.rows, cols=plan.cols, kw=plan.kw),
         lanepack=(plan,))


# the aligned and LanePack kernels own each row block's sum (one writer a
# row, csrc/segments.h): plans whose row blocks span several segments, at
# the default segment length and at 2 chunks a segment
SEGMENTED = {
    "poisson_aligned": lambda: (poisson_2d_csr(64, dtype=np.float32), "aligned"),
    "randlocal_aligned_spill": lambda: (
        corpus.random_local(np.random.default_rng(2), 4096, 16, 1024), "aligned"),
    "femlike_per_rb": lambda: (corpus.fem_like(np.random.default_rng(1), 64, 2), "per_rb"),
    "powerlaw_kw16": lambda: (corpus.power_law_rows(np.random.default_rng(3), 4096, 16), "kw16"),
}


def _segmented(name, dev):
    m, how = SEGMENTED[name]()
    if how == "aligned":
        plan = plan_aligned(m)
        arrs = spmv.aligned_device_arrays(plan, dev)

        def run(x):
            return spmv.spmv_aligned(plan, x, device_arrays=arrs)

        def plain(x):
            y = spmv._aligned_torch(arrs, x, rows=plan.rows, cols=plan.cols)
            if plan.spill is not None:
                y = y + spmv._lanepack_torch(arrs["spill"], x, rows=plan.rows,
                                             cols=plan.cols, kw=plan.spill.kw)
            return y

        scanned = () if plan.spill is None else (plan.spill,)
    else:
        plan = plan_lanepack(m, pack="per_rb") if how == "per_rb" else plan_lanepack(m, kw=16)

        def run(x):
            return spmv.spmv_lanepack(plan, x, device_arrays=arrs)

        def plain(x):
            return spmv._lanepack_torch(arrs, x, rows=plan.rows, cols=plan.cols, kw=plan.kw)

        arrs = spmv.lanepack_device_arrays(plan, dev)
        scanned = (plan,)
    return m, plan, arrs, run, plain, scanned


@pytest.mark.parametrize("g", [2, spmv.SEGMENT_CHUNKS])
@pytest.mark.parametrize("name", list(SEGMENTED))
def test_segmented_kernels_repeat_bitwise(dev, name, g, monkeypatch):
    """Two calls give equal bits; row blocks of more than g chunks (cut into
    several segments) are summed by their last warp; within the bound."""
    monkeypatch.setattr(spmv, "SEGMENT_CHUNKS", g)
    m, plan, arrs, run, plain, scanned = _segmented(name, dev)
    seg = arrs["segments"].cpu().numpy()
    assert seg[:, 3].max() >= 0  # some row block spans several segments
    x_np, x = _x(m, dev)
    kernel = "aligned" if name.endswith(("aligned", "spill")) else "lanepack"
    _held(kernel, m, x_np, dev, lambda: run(x), lambda: plain(x), lanepack=scanned)
    y1, y2 = run(x), run(x)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)
    for a in (arrs, arrs.get("spill", arrs)):
        assert torch.all(a["seg_tickets"] == 0)  # the last warps reset the tickets


@pytest.mark.parametrize("value", [float("inf"), float("nan")])
@pytest.mark.parametrize("name", ["poisson_aligned", "randlocal_aligned_spill", "femlike_per_rb"])
def test_segmented_kernels_nonfinite_x(dev, name, value, monkeypatch):
    """A non-finite x (at x[0], which the slab padding reads, and inside)
    gives the plain version's NaN and inf rows."""
    monkeypatch.setattr(spmv, "SEGMENT_CHUNKS", 2)
    m, plan, arrs, run, plain, _ = _segmented(name, dev)
    for where in (0, m.cols // 2 + 3):
        x_np, x = _x(m, dev)
        x[where] = value
        a, b = run(x).cpu().numpy(), plain(x).cpu().numpy()
        assert np.array_equal(np.isnan(a), np.isnan(b))
        assert np.array_equal(np.isposinf(a), np.isposinf(b))
        assert np.array_equal(np.isneginf(a), np.isneginf(b))
        assert not np.all(np.isfinite(b))


def test_bell_spill_adds_into_bell_rows(dev):
    """The BELL kernel writes y, the LanePack spill adds to it in add mode
    (rows >= rows untouched), one launch each."""
    from sparse_matrix_tpu_torch.native import kernels

    m = corpus.power_law_rows(np.random.default_rng(0), 4096, 16)
    plan = plan_bell(m)
    assert plan.spill is not None
    arrs = spmv_bell.bell_device_arrays(plan, dev)
    x_np, x = _x(m, dev)
    before = dict(kernels.launch_counts)

    def plain():
        y = spmv_bell._bell_torch(arrs["vals"], arrs["lane"], x, ds=plan.ds, modes=plan.modes,
                                  span=plan.span, rows=plan.rows, cols=plan.cols)
        return y + spmv._lanepack_torch(arrs["spill"], x, rows=plan.rows, cols=plan.cols,
                                        kw=plan.spill.kw)

    _held("bell", m, x_np, dev, lambda: spmv_bell.spmv_bell(plan, x, device_arrays=arrs),
         plain, lanepack=(plan.spill,))
    assert kernels.launch_counts["lanepack"] - before["lanepack"] == 1
    y1 = spmv_bell.spmv_bell(plan, x, device_arrays=arrs)
    assert torch.equal(y1, spmv_bell.spmv_bell(plan, x, device_arrays=arrs))


def test_segmented_store_writes_every_row(dev, monkeypatch):
    """Store mode writes every row of y, masked and empty row blocks 0, into
    a y full of NaN; add mode adds its result onto y bit for bit."""
    monkeypatch.setattr(spmv, "SEGMENT_CHUNKS", 2)
    rng = np.random.default_rng(7)
    mask = rng.random((700, 512)) < 0.03
    for rb in (0, 2, 4):
        mask[rb * 128: (rb + 1) * 128] = False
    r, c = np.nonzero(mask)
    m = CsrMatrix.from_coo(700, 512, r, c, rng.standard_normal(r.size).astype(np.float32))
    x_np, x = _x(m, dev)
    lp = plan_lanepack(m, pack="per_rb")
    al = plan_aligned(m)
    assert al.spill is not None
    for arrs, scanned in ((spmv.lanepack_device_arrays(lp, dev), (lp,)),
                          (spmv.aligned_device_arrays(al, dev), (al.spill,))):
        y = torch.full((700,), float("nan"), device=dev)
        arrs["launch"](x, y)
        if "spill" in arrs:
            arrs["spill"]["launch"](x, y, add=True)
        yk = y.double().cpu().numpy()
        for rb in (0, 2, 4):
            assert np.all(yk[rb * 128: (rb + 1) * 128] == 0)
        y64, bound = spmv.spmv_f64_bound(m, x_np, lanepack=scanned)
        assert np.all(np.abs(yk - y64) <= bound)
        y_store = torch.full((700,), float("nan"), device=dev)
        arrs["launch"](x, y_store)
        y_add = y.clone()
        arrs["launch"](x, y_add, add=True)
        assert torch.equal(y_add, y + y_store)


def test_segmented_kernels_empty_plan(dev):
    """A plan with no chunk: every row of y is written 0; add mode launches
    nothing it would need."""
    m = CsrMatrix.from_coo(300, 200, np.zeros(0, np.int64), np.zeros(0, np.int64),
                           np.zeros(0, np.float32))
    x = torch.ones(200, device=dev)
    for y in (spmv.spmv_lanepack(plan_lanepack(m), x), spmv.spmv_aligned(plan_aligned(m), x)):
        torch.cuda.synchronize()
        assert y.shape == (300,) and torch.all(y == 0)


def test_segmented_kernels_refuse_bad_x(dev):
    """x on the CPU, of another dtype, or of another length is refused
    before anything launches; so is a misaligned y."""
    from sparse_matrix_tpu_torch.native import kernels

    m = poisson_2d_csr(32, dtype=np.float32)
    for plan, build in ((plan_aligned(m), spmv.aligned_device_arrays),
                        (plan_lanepack(m), spmv.lanepack_device_arrays)):
        rec = build(plan, dev)["launch"]
        y = torch.empty(m.rows, device=dev)
        before = dict(kernels.launch_counts)
        with pytest.raises(ValueError, match="is on cpu"):
            rec(torch.zeros(m.cols), y)
        with pytest.raises(TypeError, match="dtype"):
            rec(torch.zeros(m.cols, dtype=torch.float64, device=dev), y)
        with pytest.raises(ValueError, match="elements"):
            rec(torch.zeros(m.cols + 1, device=dev), y)
        with pytest.raises(ValueError, match="16-byte aligned"):
            rec(torch.zeros(m.cols, device=dev), torch.empty(m.rows + 1, device=dev)[1:])
        assert kernels.launch_counts == before
    with pytest.raises(TypeError, match="dtype"):
        spmv.spmv_aligned(plan_aligned(m), torch.zeros(m.cols, dtype=torch.float64, device=dev))


def test_device_arrays_without_record_are_checked_at_first_call(dev):
    m = poisson_2d_csr(32, dtype=np.float32)
    plan = plan_lanepack(m)
    arrs = spmv.lanepack_device_arrays(plan, dev)
    bare = {k: v for k, v in arrs.items() if k not in ("launch", "segments", "rb_seg")}
    x_np, x = _x(m, dev)
    y = spmv.spmv_lanepack(plan, x, device_arrays=bare)
    assert "launch" in bare and torch.equal(y, spmv.spmv_lanepack(plan, x, device_arrays=arrs))


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

    _held("bell", m, x_np, dev, lambda: spmv_bell.spmv_bell(plan, x, device_arrays=arrs),
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

    _held("stripe", m, x_np, dev, lambda: spmv.spmv_stripe(plan, x, device_arrays=arrs),
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


# the stripe kernel owns each stripe's rows (one thread block a segment,
# csrc/spmv_stripe.cu): plans of each shape the main path runs, a partial
# last stripe and 16 levels (two level groups)
STRIPED = {
    "randlocal_scan_L2_kw2": lambda: (
        corpus.random_local(np.random.default_rng(1), 4096, 16, 1024), "scan", 2, 2),
    "powerlaw_scan_L8_kw16": lambda: (
        corpus.power_law_rows(np.random.default_rng(3), 4096, 16), "scan", 8, 16),
    "powerlaw_select_spill": lambda: (
        corpus.power_law_rows(np.random.default_rng(4), 3000, 12), "select", 4, 2),
    "partial_scan_L4": lambda: (
        corpus.random_local(np.random.default_rng(5), 700, 12, 6000), "scan", 4, 2),
    "levels16": lambda: (corpus.power_law_rows(np.random.default_rng(7), 4096, 8), "scan", 16, 1),
}


def _striped(name, dev):
    m, mode, levels, kw = STRIPED[name]()
    plan = plan_stripe(m, mode=mode, levels=levels, kw=kw)
    arrs = spmv.stripe_device_arrays(plan, dev)

    def plain(x):
        y, p, a = None, plan, arrs
        while p is not None:
            yp = spmv._stripe_torch(a, x, rows=p.rows, cols=p.cols, lvl=p.levels, kw=p.kw,
                                    scan=p.mode == "scan")
            y = yp if y is None else y + yp
            p, a = p.spill, a.get("spill")
        return y

    return m, plan, arrs, plain


def _stripe_records(plan, arrs):
    while plan is not None:
        yield arrs
        plan, arrs = plan.spill, arrs.get("spill")


def _segment_slabs(monkeypatch, g):
    """Stripe segments of at most g slabs for every plan (None: the default)."""
    if g is not None:
        monkeypatch.setattr(spmv, "stripe_segment_slabs", lambda levels: g)


@pytest.mark.parametrize("g", [1, 2, None])
@pytest.mark.parametrize("name", list(STRIPED))
def test_stripe_kernel_repeat_bitwise(dev, name, g, monkeypatch):
    """Two calls give equal bits; stripes of more than g slabs (cut into
    several segments) are summed by their last block, which resets the
    tickets; within the bound."""
    _segment_slabs(monkeypatch, g)
    m, plan, arrs, plain = _striped(name, dev)
    if g == 1:
        assert arrs["segments"][:, 3].max() >= 0  # some stripe spans several segments
    x_np, x = _x(m, dev)
    run = lambda: spmv.spmv_stripe(plan, x, device_arrays=arrs)  # noqa: E731
    _held("stripe", m, x_np, dev, run, lambda: plain(x), stripe=(plan,))
    y1, y2 = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)
    for a in _stripe_records(plan, arrs):
        assert torch.all(a["seg_tickets"] == 0)


def test_stripe_kernel_store_and_add_modes(dev, monkeypatch):
    """Store mode writes every row into a y full of NaN (masked row blocks
    and empty stripes 0); add mode adds its result onto y bit for bit; the
    spill chain adds in add mode, one launch a sub-plan."""
    from sparse_matrix_tpu_torch.native import kernels

    _segment_slabs(monkeypatch, 1)
    rng = np.random.default_rng(7)
    mask = rng.random((1000, 512)) < 0.03
    for rb in (0, 2, 3):
        mask[rb * 128: (rb + 1) * 128] = False
    r, c = np.nonzero(mask)
    m = CsrMatrix.from_coo(1000, 512, r, c, rng.standard_normal(r.size).astype(np.float32))
    x_np, x = _x(m, dev)
    for mode in ("scan", "select"):
        plan = plan_stripe(m, mode=mode, levels=2, kw=1)
        arrs = spmv.stripe_device_arrays(plan, dev)
        recs = [a["launch"] for a in _stripe_records(plan, arrs)]
        y = torch.full((1000,), float("nan"), device=dev)
        before = kernels.launch_counts["stripe"]
        recs[0](x, y)
        for rec in recs[1:]:
            rec(x, y, add=True)
        assert kernels.launch_counts["stripe"] - before == len(recs)
        yk = y.double().cpu().numpy()
        for rb in (0, 2, 3):
            assert np.all(yk[rb * 128: (rb + 1) * 128] == 0)
        y64, bound = spmv.spmv_f64_bound(m, x_np, stripe=(plan,))
        assert np.all(np.abs(yk - y64) <= bound)
        y_store = torch.full((1000,), float("nan"), device=dev)
        recs[0](x, y_store)
        y_add = y.clone()
        recs[0](x, y_add, add=True)
        assert torch.equal(y_add, y + y_store)


@pytest.mark.parametrize("value", [float("inf"), float("nan")])
@pytest.mark.parametrize("name", ["randlocal_scan_L2_kw2", "powerlaw_select_spill"])
def test_stripe_kernel_nonfinite_x(dev, name, value, monkeypatch):
    """A non-finite x (at x[0], which padding chunks read, and inside) gives
    the plain version's NaN and inf rows: every pair adds its gather, a
    run or not, and padding chunks of other stripes reach stripe 0."""
    _segment_slabs(monkeypatch, 2)
    m, plan, arrs, plain = _striped(name, dev)
    for where in (0, m.cols // 2 + 3):
        x_np, x = _x(m, dev)
        x[where] = value
        a = spmv.spmv_stripe(plan, x, device_arrays=arrs).cpu().numpy()
        b = plain(x).cpu().numpy()
        assert np.array_equal(np.isnan(a), np.isnan(b))
        assert np.array_equal(np.isposinf(a), np.isposinf(b))
        assert np.array_equal(np.isneginf(a), np.isneginf(b))
        assert not np.all(np.isfinite(b))


@pytest.mark.parametrize("span", [128, 256])
@pytest.mark.parametrize("vdt", [None, torch.bfloat16])
def test_bell_kernel_repeat_bitwise_odd_rows(dev, span, vdt):
    """rows % 4 != 0 (Poisson 33^2, 1089 rows): the kernel writes every row
    of a NaN-filled y, two calls give equal bits, within the bound (bf16
    planes against their rounded values); add mode is refused (BELL only
    writes y; its spill adds)."""
    m = poisson_2d_csr(33, dtype=np.float32)
    assert m.rows % 4 == 1
    plan = plan_bell(m, span=span)
    arrs = spmv_bell.bell_device_arrays(plan, dev, values_dtype=vdt)
    x_np, x = _x(m, dev)
    vals = None if vdt is None else torch.from_numpy(m.vals).to(vdt).double().numpy()
    y = torch.full((m.rows,), float("nan"), device=dev)
    arrs["launch"](x, y)
    y64, bound = spmv.spmv_f64_bound(m, x_np, vals=vals)
    assert np.all(np.abs(y.double().cpu().numpy() - y64) <= bound)
    y_add = y.clone()
    with pytest.raises(RuntimeError, match="bell kernel launch failed"):
        arrs["launch"](x, y_add, add=True)
    assert torch.equal(y_add, y)
    y1 = spmv_bell.spmv_bell(plan, x, device_arrays=arrs)
    assert torch.equal(y1, spmv_bell.spmv_bell(plan, x, device_arrays=arrs))
    assert torch.equal(y1, y)


def test_bell_and_stripe_records_refuse_bad_y(dev):
    """A misaligned y, a y of another length and a CPU x are refused before
    anything launches."""
    from sparse_matrix_tpu_torch.native import kernels

    m = poisson_2d_csr(32, dtype=np.float32)
    recs = [spmv_bell.bell_device_arrays(plan_bell(m), dev)["launch"],
            spmv.stripe_device_arrays(plan_stripe(m, mode="scan", levels=2, kw=1), dev)["launch"]]
    before = dict(kernels.launch_counts)
    for rec in recs:
        x = torch.zeros(m.cols, device=dev)
        with pytest.raises(ValueError, match="16-byte aligned"):
            rec(x, torch.empty(m.rows + 1, device=dev)[1:])
        with pytest.raises(ValueError, match="elements"):
            rec(x, torch.empty(m.rows + 4, device=dev))
        with pytest.raises(ValueError, match="is on cpu"):
            rec(torch.zeros(m.cols), torch.empty(m.rows, device=dev))
    assert kernels.launch_counts == before


def _held_multi(kernel, m, X_np, run, plain, **bound_kw):
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
    _held_multi("dia_spmm", m, X_np,
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

    _held_multi("aligned_spmm", m, X_np,
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
    _held_multi("lanepack_spmm", m, X_np,
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


def _masked_aligned_case():
    """An aligned plan with no spill whose row blocks 0, 2 and 4 hold no
    entry (700 x 512, five bands)."""
    rng = np.random.default_rng(7)
    r = np.repeat(np.arange(700), 5)
    c = r + np.tile([-130, -1, 0, 1, 130], 700)
    keep = (c >= 0) & (c < 512) & ~np.isin(r // 128, [0, 2, 4])
    m = CsrMatrix.from_coo(700, 512, r[keep], c[keep],
                           rng.standard_normal(int(keep.sum())).astype(np.float32))
    plan = plan_aligned(m)
    assert plan.spill is None
    return m, plan


def _aligned_spmm_call(plan, arrs, X, layout):
    """``spmm_aligned`` (row-major) or ``spmm_aligned_packed`` unpacked."""
    if layout == "rowmajor":
        return spmm.spmm_aligned(plan, X, device_arrays=arrs)
    return spmm.unpack_rhs(spmm.spmm_aligned_packed(plan, spmm.pack_rhs(X, plan.cols),
                                                    device_arrays=arrs), plan.rows)


@pytest.mark.parametrize("k", list(range(1, 21)))
@pytest.mark.parametrize("layout", ["packed", "rowmajor"])
def test_aligned_spmm_kernel_store_and_add_modes(dev, layout, k, monkeypatch):
    """Store mode writes every row of a NaN-filled Y (empty row blocks 0;
    packed: the row blocks past r128 zeroed) with the bits of the
    segment-order plain version; two calls give equal bits; add mode adds
    the same result onto Y bit for bit and leaves those row blocks alone;
    one launch a 16 columns."""
    from sparse_matrix_tpu_torch.native import kernels

    monkeypatch.setattr(spmv, "SEGMENT_CHUNKS", 2)
    m, plan = _masked_aligned_case()
    arrs = spmv.aligned_device_arrays(plan, dev)
    rec = arrs["spmm_launch"]
    rng = np.random.default_rng(k)
    X = torch.from_numpy(rng.standard_normal((512, k)).astype(np.float32)).to(dev)
    packed = layout == "packed"
    x = spmm.pack_rhs(X, 512) if packed else X
    shape = (plan.r128 + 3, k, 128) if packed else (700, k)
    y = torch.full(shape, float("nan"), device=dev)
    before = kernels.launch_counts["aligned_spmm"]
    rec(x, y, packed=packed)
    assert kernels.launch_counts["aligned_spmm"] - before == -(-k // 16)
    y2 = torch.full(shape, float("nan"), device=dev)
    rec(x, y2, packed=packed)
    torch.cuda.synchronize()
    assert torch.equal(y, y2)
    got = spmm.unpack_rhs(y, 700) if packed else y
    if packed:
        assert int(torch.count_nonzero(y[plan.r128:])) == 0
    for rb in (0, 2, 4):
        assert torch.all(got[rb * 128: (rb + 1) * 128] == 0)
    want = spmv._segments_torch("aligned", arrs, X, rows=700, cols=512)
    assert torch.equal(got, want)
    assert torch.all(arrs["spmm_tickets"] == 0)
    y0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    y_add = y0.clone()
    rec(x, y_add, packed=packed, add=True)
    if packed:
        assert torch.equal(y_add[: plan.r128], y0[: plan.r128] + y[: plan.r128])
        assert torch.equal(y_add[plan.r128:], y0[plan.r128:])
    else:
        assert torch.equal(y_add, y0 + y)


@pytest.mark.parametrize("k", [1, 3, 8, 16, 20])
@pytest.mark.parametrize("layout", ["packed", "rowmajor"])
@pytest.mark.parametrize("g", [1, 2, spmv.SEGMENT_CHUNKS])
def test_aligned_spmm_kernel_equals_segment_order_bitwise(dev, g, layout, k, monkeypatch):
    """With no spill the aligned SpMM kernel equals ``_segments_torch`` on
    the (cols, K) block bit for bit, row blocks cut into segments of g
    chunks or whole, every call; each column within the f64 bound."""
    monkeypatch.setattr(spmv, "SEGMENT_CHUNKS", g)
    m = poisson_2d_csr(64, dtype=np.float32)
    plan = plan_aligned(m)
    assert plan.spill is None
    arrs = spmv.aligned_device_arrays(plan, dev)
    if g <= 2:
        assert int(arrs["segments"][:, 3].max()) >= 0
    X_np = np.random.default_rng(k).standard_normal((m.cols, k)).astype(np.float32)
    X = torch.from_numpy(X_np).to(dev)
    want = spmv._segments_torch("aligned", arrs, X, rows=m.rows, cols=m.cols)
    _held_multi("aligned_spmm", m, X_np, lambda: _aligned_spmm_call(plan, arrs, X, layout),
               lambda: want)
    y1, y2 = _aligned_spmm_call(plan, arrs, X, layout), _aligned_spmm_call(plan, arrs, X, layout)
    torch.cuda.synchronize()
    assert torch.equal(y1, want) and torch.equal(y1, y2)


@pytest.mark.parametrize("value", [float("inf"), float("nan")])
@pytest.mark.parametrize("layout", ["packed", "rowmajor"])
def test_aligned_spmm_kernel_nonfinite_x(dev, layout, value, monkeypatch):
    """A non-finite X (at X[0, q], which slab padding reads, and inside)
    gives the segment-order plain version's NaN and inf entries."""
    monkeypatch.setattr(spmv, "SEGMENT_CHUNKS", 2)
    m, plan = _masked_aligned_case()
    arrs = spmv.aligned_device_arrays(plan, dev)
    for where in (0, 300):
        X = torch.from_numpy(np.random.default_rng(5).standard_normal((512, 4))
                             .astype(np.float32)).to(dev)
        X[where, 1] = value
        a = _aligned_spmm_call(plan, arrs, X, layout).cpu().numpy()
        b = spmv._segments_torch("aligned", arrs, X, rows=700, cols=512).cpu().numpy()
        np.testing.assert_array_equal(a, b)
        assert not np.all(np.isfinite(b))


def test_aligned_spmm_record_refuses_bad_inputs(dev):
    """The aligned SpMM launch record refuses x on the CPU, another dtype,
    shapes that do not fit (packed: too few row blocks of y) and a
    misaligned y before anything launches."""
    from sparse_matrix_tpu_torch.native import kernels

    m = poisson_2d_csr(32, dtype=np.float32)
    rec = spmv.aligned_device_arrays(plan_aligned(m), dev)["spmm_launch"]
    X = torch.zeros((m.cols, 4), device=dev)
    Y = torch.empty((m.rows, 4), device=dev)
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="is on cpu"):
        rec(X.cpu(), Y)
    with pytest.raises(TypeError, match="dtype"):
        rec(X.double(), Y)
    with pytest.raises(ValueError, match="do not fit"):
        rec(X[1:], Y)
    with pytest.raises(ValueError, match="16-byte aligned"):
        rec(X, _misaligned(Y))
    with pytest.raises(ValueError, match="do not fit"):
        rec(spmm.pack_rhs(X, m.cols), torch.empty((1, 4, 128), device=dev), packed=True)
    assert kernels.launch_counts == before


def test_aligned_matmat_multi_rhs_cg_on_card_matches_cpu(dev):
    """Aligned multi-RHS CG through ``SpmvOperator.matmat`` (B6 at K = 8 on
    X and Y row-major): iterations within 2 of the CPU's, X within 1e-4."""
    from sparse_matrix_tpu_torch.ops.operator import SpmvOperator
    from sparse_matrix_tpu_torch.solvers.cg import cg_solve_multi

    a = poisson_2d_csr(48, dtype=np.float32)
    B = torch.from_numpy(np.random.default_rng(9).standard_normal((a.rows, 8))
                         .astype(np.float32))
    out = {}
    for d in (dev, torch.device("cpu")):
        op = SpmvOperator(a, device=d, force="aligned")
        res = cg_solve_multi(op.matmat, B.to(d), tol=1e-5, maxiter=2000, rhs_axis=-1)
        out[d.type] = (res.iterations, res.x.double().cpu())
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 2
    assert torch.linalg.norm(out["cuda"][1] - out["cpu"][1]) <= 1e-4 * torch.linalg.norm(out["cpu"][1])


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

    _held_multi("bell_spmm", m, X_np, lambda: spmm.spmm_bell(plan, X, device_arrays=arrs), plain,
               vals=vals, lanepack=() if plan.spill is None else (plan.spill,))


def _lanepack_spmm_plain(plan, arrs, X):
    """``_lanepack_spmm_torch`` on X (cols, K), unpacked to (rows, K)."""
    y3 = spmm._lanepack_spmm_torch(arrs, spmm.pack_rhs(X, plan.cols, guard=0), cols=plan.cols,
                                   kw=plan.kw)
    return spmm.unpack_rhs(y3, plan.rows)


@pytest.mark.parametrize("k", [1, 3, 8, 16, 20])
@pytest.mark.parametrize("layout", ["packed", "rowmajor"])
@pytest.mark.parametrize("g", [2, spmv.SEGMENT_CHUNKS])
def test_lanepack_spmm_kernel_segments_repeat_bitwise(dev, g, layout, k, monkeypatch):
    """Row blocks cut into segments of g chunks are summed by their last
    warp (tickets back at 0); two calls give equal bits; each column within
    the bound; one launch a 16 columns."""
    from sparse_matrix_tpu_torch.native import kernels

    monkeypatch.setattr(spmv, "SEGMENT_CHUNKS", g)
    m = corpus.power_law_rows(np.random.default_rng(1), 3000, 12)
    plan = plan_lanepack(m, kw=4)
    assert spmm.lanepack_spmm_uses_kernel(plan, k)
    arrs = spmv.lanepack_device_arrays(plan, dev)
    if g == 2:
        assert int(arrs["segments"][:, 3].max()) >= 0
    X_np = np.random.default_rng(k).standard_normal((m.cols, k)).astype(np.float32)
    X = torch.from_numpy(X_np).to(dev)
    x3 = spmm.pack_rhs(X, m.cols, guard=plan.kw)

    def run():
        if layout == "packed":
            return spmm.unpack_rhs(spmm.spmm_lanepack_packed(plan, x3, device_arrays=arrs),
                                   m.rows)
        return spmm.spmm_lanepack(plan, X, device_arrays=arrs)

    before = kernels.launch_counts["lanepack_spmm"]
    _held_multi("lanepack_spmm", m, X_np, run, lambda: _lanepack_spmm_plain(plan, arrs, X),
               lanepack=(plan,))
    assert kernels.launch_counts["lanepack_spmm"] - before == -(-k // 16)
    y1, y2 = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(y1, y2)
    assert torch.all(arrs["spmm_tickets"] == 0)


@pytest.mark.parametrize("layout", ["packed", "rowmajor"])
def test_lanepack_spmm_kernel_store_and_add_modes(dev, layout, monkeypatch):
    """Store mode writes every row of a NaN-filled y (empty row blocks 0;
    packed: the row blocks past r128 zeroed); add mode adds the same
    result onto y bit for bit and leaves those row blocks alone."""
    monkeypatch.setattr(spmv, "SEGMENT_CHUNKS", 2)
    rng = np.random.default_rng(7)
    mask = rng.random((700, 512)) < 0.03
    for rb in (0, 2, 4):
        mask[rb * 128: (rb + 1) * 128] = False
    r, c = np.nonzero(mask)
    m = CsrMatrix.from_coo(700, 512, r, c, rng.standard_normal(r.size).astype(np.float32))
    plan = plan_lanepack(m, pack="per_rb")
    arrs = spmv.lanepack_device_arrays(plan, dev)
    rec = arrs["spmm_launch"]
    X_np = rng.standard_normal((512, 8)).astype(np.float32)
    X = torch.from_numpy(X_np).to(dev)
    packed = layout == "packed"
    x = spmm.pack_rhs(X, 512, guard=0) if packed else X
    shape = (plan.r128 + 3, 8, 128) if packed else (700, 8)
    y = torch.full(shape, float("nan"), device=dev)
    rec(x, y, packed=packed)
    got = spmm.unpack_rhs(y, 700) if packed else y
    if packed:
        assert int(torch.count_nonzero(y[plan.r128:])) == 0
    for rb in (0, 2, 4):
        assert torch.all(got[rb * 128: (rb + 1) * 128] == 0)
    for q in range(8):
        y64, bound = spmv.spmv_f64_bound(m, X_np[:, q], lanepack=(plan,))
        assert np.all(np.abs(got[:, q].double().cpu().numpy() - y64) <= bound)
    y0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)
    y_add = y0.clone()
    rec(x, y_add, packed=packed, add=True)
    if packed:
        assert torch.equal(y_add[: plan.r128], y0[: plan.r128] + y[: plan.r128])
        assert torch.equal(y_add[plan.r128:], y0[plan.r128:])
    else:
        assert torch.equal(y_add, y0 + y)


@pytest.mark.parametrize("value", [float("inf"), float("nan")])
@pytest.mark.parametrize("layout", ["packed", "rowmajor"])
def test_lanepack_spmm_kernel_nonfinite_x(dev, layout, value, monkeypatch):
    """A non-finite X (at X[0, q], which slab padding reads, and inside)
    gives the plain version's NaN and inf entries, column by column."""
    monkeypatch.setattr(spmv, "SEGMENT_CHUNKS", 2)
    m = corpus.fem_like(np.random.default_rng(1), 48, 2)
    m = CsrMatrix(m.rows, m.cols, m.vals.astype(np.float32), m.indices, m.offsets,
                  is_sorted=m.is_sorted)
    plan = plan_lanepack(m, pack="per_rb")
    arrs = spmv.lanepack_device_arrays(plan, dev)
    for where in (0, m.cols // 2 + 3):
        X = torch.from_numpy(np.random.default_rng(5).standard_normal((m.cols, 4))
                             .astype(np.float32)).to(dev)
        X[where, 1] = value
        if layout == "packed":
            a = spmm.unpack_rhs(spmm.spmm_lanepack_packed(
                plan, spmm.pack_rhs(X, m.cols, guard=plan.kw), device_arrays=arrs), m.rows)
        else:
            a = spmm.spmm_lanepack(plan, X, device_arrays=arrs)
        a, b = a.cpu().numpy(), _lanepack_spmm_plain(plan, arrs, X).cpu().numpy()
        assert np.array_equal(np.isnan(a), np.isnan(b))
        assert np.array_equal(np.isposinf(a), np.isposinf(b))
        assert np.array_equal(np.isneginf(a), np.isneginf(b))
        assert not np.all(np.isfinite(b))


@pytest.mark.parametrize("k", [2, 3, 6, 8, 16])
@pytest.mark.parametrize("span", [128, 256])
@pytest.mark.parametrize("vdt", [None, torch.bfloat16])
def test_bell_spmm_kernel_equals_plain_bitwise(dev, vdt, span, k):
    """With no spill the BELL SpMM kernel rounds each product and sum as
    the plain version does, in layer order: equal bits, every call (K
    that takes 16-, 8- and 4-byte loads)."""
    from sparse_matrix_tpu_torch.native import kernels

    m = BELL_MATRICES["randlocal"]()
    plan = plan_bell(m, span=span)
    assert plan.spill is None
    arrs = spmv_bell.bell_device_arrays(plan, dev, values_dtype=vdt)
    X = torch.from_numpy(np.random.default_rng(k).standard_normal((m.cols, k))
                         .astype(np.float32)).to(dev)
    before = kernels.launch_counts["bell_spmm"]
    y1 = spmm.spmm_bell(plan, X, device_arrays=arrs)
    y2 = spmm.spmm_bell(plan, X, device_arrays=arrs)
    plain = spmm.unpack_rhs(spmm._bell_spmm_torch(arrs["vals"], arrs["lane"], X, ds=plan.ds,
                                                  modes=plan.modes, span=plan.span,
                                                  cols=plan.cols), m.rows)
    torch.cuda.synchronize()
    assert kernels.launch_counts["bell_spmm"] - before == 2
    assert y1.shape == (m.rows, k) and torch.equal(y1, plain) and torch.equal(y1, y2)


def test_bell_spmm_spill_is_one_lanepack_spmm_launch_in_add_mode(dev):
    from sparse_matrix_tpu_torch.native import kernels

    m = BELL_MATRICES["powerlaw_spill"]()
    plan = plan_bell(m)
    assert plan.spill is not None
    arrs = spmv_bell.bell_device_arrays(plan, dev)
    X = torch.from_numpy(np.random.default_rng(3).standard_normal((m.cols, 8))
                         .astype(np.float32)).to(dev)
    before = dict(kernels.launch_counts)
    y = spmm.spmm_bell(plan, X, device_arrays=arrs)
    torch.cuda.synchronize()
    got = {key: kernels.launch_counts[key] - before[key] for key in before}
    assert got["bell_spmm"] == 1 and got["lanepack_spmm"] == 1 and got["lanepack"] == 0
    y_bell = torch.empty_like(y)
    arrs["spmm_launch"](X, y_bell)
    y_spill = torch.empty_like(y)
    arrs["spill"]["spmm_launch"](X, y_spill)
    assert torch.equal(y, y_bell + y_spill)
    assert torch.equal(y, spmm.spmm_bell(plan, X, device_arrays=arrs))


def test_bell_matmat_multi_rhs_cg_on_card_matches_cpu(dev):
    """BELL multi-RHS CG through ``SpmvOperator.matmat`` (B8 at K = 8, X and
    Y row-major): iterations within 2 of the CPU's, X within 1e-4."""
    from sparse_matrix_tpu_torch.ops.operator import SpmvOperator
    from sparse_matrix_tpu_torch.solvers.cg import cg_solve_multi

    a = poisson_2d_csr(48, dtype=np.float32)
    B = torch.from_numpy(np.random.default_rng(8).standard_normal((a.rows, 8))
                         .astype(np.float32))
    out = {}
    for d in (dev, torch.device("cpu")):
        op = SpmvOperator(a, device=d, force="bell")
        res = cg_solve_multi(op.matmat, B.to(d), tol=1e-5, maxiter=2000, rhs_axis=-1)
        out[d.type] = (res.iterations, res.x.double().cpu())
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 2
    assert torch.linalg.norm(out["cuda"][1] - out["cpu"][1]) <= 1e-4 * torch.linalg.norm(out["cpu"][1])


def test_spmm_records_refuse_bad_inputs(dev):
    """The SpMM launch records refuse x on the CPU, another dtype, shapes
    that do not fit, a misaligned y, and (BELL) K > 16, add mode and the
    packed layout, before anything launches."""
    from sparse_matrix_tpu_torch.native import kernels

    m = poisson_2d_csr(32, dtype=np.float32)
    lp = spmv.lanepack_device_arrays(plan_lanepack(m), dev)["spmm_launch"]
    bl = spmv_bell.bell_device_arrays(plan_bell(m), dev)["spmm_launch"]
    X = torch.zeros((m.cols, 4), device=dev)
    Y = torch.empty((m.rows, 4), device=dev)
    before = dict(kernels.launch_counts)
    for rec in (lp, bl):
        with pytest.raises(ValueError, match="is on cpu"):
            rec(X.cpu(), Y)
        with pytest.raises(TypeError, match="dtype"):
            rec(X.double(), Y)
        with pytest.raises(ValueError, match="do not fit"):
            rec(X[1:], Y)
        with pytest.raises(ValueError, match="16-byte aligned"):
            rec(X, _misaligned(Y))
    with pytest.raises(ValueError, match="do not fit"):
        lp(spmm.pack_rhs(X, m.cols), torch.empty((1, 4, 128), device=dev), packed=True)
    with pytest.raises(ValueError, match="1 <= K <= 16"):
        bl(torch.zeros((m.cols, 17), device=dev), torch.empty((m.rows, 17), device=dev))
    with pytest.raises(ValueError, match="only writes y"):
        bl(X, Y, add=True)
    with pytest.raises(ValueError, match="do not fit"):
        bl(spmm.pack_rhs(X, m.cols), torch.empty((m.rows // 128, 4, 128), device=dev),
           packed=True)
    assert kernels.launch_counts == before


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

    _held_multi("bcsr_spmm", m, X_np, lambda: spmm.spmm_bcsr(b, X, device_arrays=arrs), plain)
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


# The FP64 tensor-core tiles of B10 and B11 over their live-depth streams:
# every product of f32 or bf16 operands is exact in f64 and C is rounded
# once, so the kernels agree with their float64 plain versions within 1 f32
# ulp per entry (the two f64 sums differ only in order), with NaN exactly
# where the plain version has one, and a B11 entry of n products is within
# 1/(n + 2) <= 1/3 of its float32 bound (0.34 below).


def _within_ulp(got, want):
    got, want = got.float().cpu().numpy(), want.float().cpu().numpy()
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = (got == want) | (np.abs(got.astype(np.float64) - want) <= np.spacing(np.abs(want)))
    assert ok[~np.isnan(want)].all()


def _block_case(fill, bs):
    if fill == "dense":  # 4 dense blocks at bs 128 (256^2), 46 at bs 32
        return corpus.dense_block_tridiagonal(np.random.default_rng(bs),
                                              256 if bs == 128 else 512, bs)
    u = corpus.random_uniform(np.random.default_rng(bs + 1), 700, 0.01)
    return CsrMatrix(u.rows, u.cols, u.vals.astype(np.float32), u.indices, u.offsets,
                     is_sorted=True)


def _bf16_rounded(m):
    v = torch.from_numpy(m.vals.astype(np.float32)).to(torch.bfloat16).float().numpy()
    return CsrMatrix(m.rows, m.cols, v, m.indices, m.offsets, is_sorted=True)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("bs", [32, 128])
@pytest.mark.parametrize("fill", ["sparse", "dense"])
def test_block_spgemm_kernel_fp64_exact(dev, fill, bs, storage):
    from sparse_matrix_tpu_torch.native import kernels

    m = _block_case(fill, bs)
    eng = spgemm_block.BlockSpgemm(m, m, device=dev, bs=bs, storage=storage)
    live = eng.live_flops() / (2.0 * eng.num_pairs * bs ** 3)
    assert live == 1.0 if fill == "dense" else live < 1.0
    before = kernels.launch_counts["block_spgemm"]
    c_dev = eng.multiply_device()
    torch.cuda.synchronize()
    assert kernels.launch_counts["block_spgemm"] == before + 1
    c_plain = spgemm_block._block_numeric_torch(eng.a_blocks, eng.b_blocks, eng.pair_a,
                                                eng.pair_b, eng.pair_c,
                                                num_c=len(eng.c_keys), bs=bs)
    _within_ulp(c_dev, c_plain)
    c = eng.multiply()
    held = _bf16_rounded(m) if storage == "bf16" else m
    assert spgemm_block.spgemm_err_over_bound(held, held, c) <= 0.34
    _spgemm_bounded(m, m, c, bf16=storage == "bf16")


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_block_spgemm_kernel_nonfinite(dev, storage):
    u = _block_case("sparse", 128)
    vals = u.vals.copy()
    rng = np.random.default_rng(3)
    at = rng.choice(vals.size, 12, replace=False)
    vals[at[:4]], vals[at[4:8]], vals[at[8:]] = np.inf, -np.inf, np.nan
    m = CsrMatrix(u.rows, u.cols, vals, u.indices, u.offsets, is_sorted=True)
    eng = spgemm_block.BlockSpgemm(m, m, device=dev, bs=128, storage=storage)
    c_dev = eng.multiply_device()
    c_plain = spgemm_block._block_numeric_torch(eng.a_blocks, eng.b_blocks, eng.pair_a,
                                                eng.pair_b, eng.pair_c,
                                                num_c=len(eng.c_keys), bs=128)
    assert bool(torch.isnan(c_plain).any())
    _within_ulp(c_dev, c_plain)
    assert torch.equal(torch.isinf(c_dev), torch.isinf(c_plain))


@pytest.mark.parametrize("flag", ["finite", "forced_full", "nonfinite"])
@pytest.mark.parametrize("bs", [32, 128])
@pytest.mark.parametrize("fill", ["sparse", "dense"])
def test_bcsr_spmm_kernel_fp64_exact(dev, fill, bs, flag):
    from sparse_matrix_tpu_torch.native import kernels

    m = _with_empty_block_rows(700, 650, bs) if fill == "sparse" else _block_case("dense", bs)
    b = BsrMatrix.from_csr(m, bs)
    arrs = spmm.bcsr_device_arrays(b, dev)
    X_np = np.random.default_rng(bs).standard_normal((m.cols, 130)).astype(np.float32)
    if flag == "nonfinite":
        # an inf in an x row that an all-zero block column faces (any row when
        # every column is live) and a NaN elsewhere
        dead = torch.nonzero(~(arrs["blocks_t"] != 0).any(-1))
        p, k = (int(v) for v in dead[0]) if len(dead) else (0, 0)
        row = min(int(arrs["block_cols"][p]) * bs + k, m.cols - 1)
        X_np[row, 3], X_np[m.cols // 2, 70] = np.inf, np.nan
    xf = torch.zeros((b.bcols * bs, 256), device=dev)
    xf[: m.cols, :130] = torch.from_numpy(X_np).to(dev)
    plain = spmm._bcsr_torch(arrs, xf.reshape(b.bcols, bs, 256), brows=b.brows)
    y = torch.empty((b.brows * bs, 256), device=dev)
    before = kernels.launch_counts["bcsr_spmm"]
    x_sum = xf.sum()  # finite exactly when every element is, at these values
    assert bool(torch.isfinite(x_sum)) == (flag != "nonfinite")
    if flag == "forced_full":
        x_sum = torch.full((), np.inf, device=dev)
    arrs["launch"](x_sum, xf, y)
    torch.cuda.synchronize()
    assert kernels.launch_counts["bcsr_spmm"] == before + 1
    _within_ulp(y, plain.reshape(b.brows * bs, 256))
    if flag == "nonfinite":
        assert bool(torch.isnan(y).any())
        return
    Y = spmm.spmm_bcsr(b, torch.from_numpy(X_np).to(dev), device_arrays=arrs)
    Yk = Y.double().cpu().numpy()
    for q in range(0, 130, 13):
        y64, bound = spmv.spmv_f64_bound(m, X_np[:, q])
        assert np.all(np.abs(Yk[:, q] - y64) <= bound)


def _misaligned(t):
    """A copy of ``t`` in a view 4 bytes past an allocation's start."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:].view(t.shape)
    assert out.data_ptr() % 16 and out.is_contiguous()
    return out.copy_(t)


def test_block_kernels_refuse_misaligned_operands(dev):
    # the tile's 16-byte cp.async copies fault off a 16-byte boundary (and
    # poison the context): the wrappers raise instead, and spmm_bcsr copies
    # such an X into an aligned buffer
    from sparse_matrix_tpu_torch.native import kernels

    m = _block_case("dense", 32)
    b = BsrMatrix.from_csr(m, 32)
    arrs = spmm.bcsr_device_arrays(b, dev)
    X = torch.from_numpy(np.random.default_rng(5).standard_normal((m.cols, 128))
                         .astype(np.float32)).to(dev)
    xm = _misaligned(X)
    y = torch.empty((b.brows * 32, 128), device=dev)
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="16-byte aligned"):
        arrs["launch"](xm.sum(), xm, y)
    eng = spgemm_block.BlockSpgemm(m, m, device=dev, bs=32)
    with pytest.raises(ValueError, match="16-byte aligned"):
        kernels.prepare_block_spgemm(eng.a_blocks_t, _misaligned(eng.b_blocks),
                                     eng.depth_stream, eng.depth_offsets, num_c=len(eng.c_keys))
    assert kernels.launch_counts == before
    _within_ulp(spmm.spmm_bcsr(b, xm, device_arrays=arrs),
                spmm.spmm_bcsr(b, X, device_arrays=arrs))
    torch.cuda.synchronize()


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
    """A padded plan (random uniform squared), an unpadded one (64 x 1 times
    1 x 32: 2,048 products, two whole slabs), and the segment schedule's
    edge cases: one k over three tiles (64 x 1 times 1 x 96), 2,048 ks of
    one product in one tile (the identity squared), one entry a column
    (lk = 1) and a row (rk = 1), and an lhs column of 3,000 entries (wider
    than the kernel stages: read from device memory)."""
    u = _f32(corpus.random_uniform(np.random.default_rng(11), 700, 0.01))
    rng = np.random.default_rng(12)

    def coo(rows, cols, r, c):
        return CsrMatrix.from_coo(rows, cols, np.asarray(r), np.asarray(c),
                                  rng.standard_normal(len(r)).astype(np.float32))

    col = coo(64, 1, np.arange(64), np.zeros(64, np.int64))
    row = coo(1, 32, np.zeros(32, np.int64), np.arange(32))
    n = 300
    return {
        "padded": (u, u),
        "unpadded": (col, row),
        "multi_tile_k": (col, coo(1, 96, np.zeros(96, np.int64), np.arange(96))),
        "tiny_ks": (coo(2048, 2048, np.arange(2048), np.arange(2048)),) * 2,
        "lk1_rk1": (coo(n, n, rng.permutation(n), np.arange(n)),
                    coo(n, n, np.arange(n), rng.permutation(n))),
        "wide_window": (coo(3000, 3, np.arange(3000), np.zeros(3000, np.int64)),
                        coo(3, 5, [0, 0, 1, 2, 2], [1, 4, 0, 2, 3])),
    }


@pytest.mark.parametrize("case", ["padded", "unpadded", "multi_tile_k", "tiny_ks", "lk1_rk1",
                                  "wide_window"])
def test_esc_expand_kernel(dev, case):
    """B12 on the plan's segments: bit-equal to both plain versions (the
    lanes' and the segment schedule's) on the real slots, 0 on the padding,
    equal bits on two calls, one launch a call, and fresh CSR-order lhs
    values read through the plan's permutation."""
    from sparse_matrix_tpu_torch.native import kernels
    from sparse_matrix_tpu_torch.ops import esc_expand

    a, b = _expand_cases()[case]
    plan = esc_expand.plan_expand_kmajor(a, b)
    assert (plan.num_slabs * 1024 > plan.num_products) == (case in ("padded", "lk1_rk1",
                                                                    "wide_window"))
    arrs = esc_expand.expand_segment_arrays(plan, dev)
    lanes = esc_expand.expand_device_arrays(plan, dev)
    lv = torch.from_numpy(a.vals[plan.perm_csc]).to(dev)
    rv = torch.from_numpy(b.vals).to(dev)
    before = kernels.launch_counts["esc_expand"]
    p = esc_expand.expand_products(plan, lv, rv, device_arrays=arrs)
    torch.cuda.synchronize()
    assert kernels.launch_counts["esc_expand"] == before + 1
    n, slots = plan.num_products, plan.num_slabs * 1024
    plain = esc_expand._expand_torch(lv, rv, lanes["lv_lane"], lanes["rv_lane"],
                                     lanes["lv_off"], lanes["rv_off"], num_products=n)
    seg = esc_expand._expand_segments_torch(lv, rv, arrs["segments"], num_products=n,
                                            num_slots=slots)
    assert p.shape == plain.shape == (slots,)
    assert torch.equal(p[:n], plain[:n]) and torch.equal(p, seg) and not p[n:].any()
    assert torch.equal(p, esc_expand.expand_products(plan, lv, rv, device_arrays=arrs))
    assert torch.equal(p.cpu(), esc_expand.expand_products(plan, lv.cpu(), rv.cpu()))
    fresh = torch.from_numpy(np.random.default_rng(13).standard_normal(a.nnz())
                             .astype(np.float32)).to(dev)
    got = esc_expand.expand_products(plan, fresh, rv, device_arrays=arrs, csr_order=True)
    want = esc_expand._expand_segments_torch(fresh, rv, arrs["segments"], num_products=n,
                                             num_slots=slots, perm=arrs["perm"])
    assert torch.equal(got, want)
    with pytest.raises(TypeError, match="dtype"):
        esc_expand.expand_products(plan, lv.double(), rv.double(), device_arrays=arrs)
    with pytest.raises(ValueError, match="segments"):
        esc_expand.expand_products(plan, lv, rv, device_arrays=lanes)


def test_esc_records_refuse_bad_inputs(dev):
    from sparse_matrix_tpu_torch.native import kernels
    from sparse_matrix_tpu_torch.ops import esc_expand
    from sparse_matrix_tpu_torch.ops.device_sorted import plan_sort_reduce

    a, b = _expand_cases()["padded"]
    plan = esc_expand.plan_expand_kmajor(a, b)
    arrs = esc_expand.expand_segment_arrays(plan, dev)
    rec = arrs["launch"]
    lv = torch.from_numpy(a.vals[plan.perm_csc]).to(dev)
    rv = torch.from_numpy(b.vals).to(dev)
    p = torch.empty(plan.num_slabs * 1024, device=dev)
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="elements"):
        rec(lv[:-1], rv, p)
    with pytest.raises(ValueError, match="elements"):
        rec(lv, rv, p[:-1024])
    with pytest.raises(ValueError, match="contiguous"):
        rec(lv, rv, torch.empty(2 * p.numel(), device=dev)[::2])
    big = torch.empty(max(lv.numel(), p.numel()), device=dev)
    with pytest.raises(ValueError, match="alias"):
        rec(big[:lv.numel()], rv, big[:p.numel()])
    with pytest.raises(ValueError, match="is on cpu"):
        rec(lv.cpu(), rv, p)
    with pytest.raises(ValueError, match="disagree"):
        kernels.prepare_esc_expand(arrs["segments"], arrs["tiles"][:-1], arrs["perm"],
                                   num_products=plan.num_products,
                                   num_slots=plan.num_slabs * 1024, n_lv=a.nnz(), n_rv=b.nnz())
    with pytest.raises(ValueError, match="2\\^30"):
        kernels.prepare_esc_expand(arrs["segments"], arrs["tiles"].new_zeros((1 << 19) + 1, 8),
                                   arrs["perm"], num_products=plan.num_products,
                                   num_slots=(1 << 30) + 8, n_lv=a.nnz(), n_rv=b.nnz())
    with pytest.raises(ValueError, match="aligned"):
        rec(lv, rv, torch.empty(p.numel() + 1, device=dev)[1:])
    runs = plan_sort_reduce(torch.from_numpy(plan.out_key).to(dev), a.rows, b.cols,
                            padded=True)
    with pytest.raises(ValueError, match="elements"):
        runs["launch"](p[:-1], torch.empty_like(p))
    with pytest.raises(ValueError, match="alias"):
        runs["launch"](p, p)
    with pytest.raises(TypeError, match="dtype"):
        runs["launch"](p.double(), torch.empty_like(p))
    with pytest.raises(ValueError, match="runs summed"):
        kernels.prepare_esc_run_sum(runs["order"], runs["run_off"],
                                    num_summed=runs["run_off"].numel())
    assert kernels.launch_counts == before


@pytest.mark.parametrize("case", ["padded", "unpadded", "multi_tile_k", "tiny_ks", "lk1_rk1",
                                  "wide_window"])
def test_esc_run_sum_kernel(dev, case):
    """The run sums planned once: bit-equal to the plain version on the
    CPU (sequential adds in sorted order), equal bits on two calls, zero
    past the summed runs; signed zeros and inf/NaN products included."""
    from sparse_matrix_tpu_torch.native import kernels
    from sparse_matrix_tpu_torch.ops import esc_expand
    from sparse_matrix_tpu_torch.ops.device_sorted import _sum_runs_torch, plan_sort_reduce

    a, b = _expand_cases()[case]
    plan = esc_expand.plan_expand_kmajor(a, b)
    padded = plan.num_slabs * 1024 > plan.num_products
    runs = plan_sort_reduce(torch.from_numpy(plan.out_key).to(dev), a.rows, b.cols,
                            padded=padded)
    cpu = plan_sort_reduce(torch.from_numpy(plan.out_key), a.rows, b.cols, padded=padded)
    for k in ("order", "run_off", "row", "col", "nnz"):
        assert torch.equal(runs[k].cpu(), cpu[k]), k
    p = esc_expand.expand_products(plan, torch.from_numpy(a.vals[plan.perm_csc]).to(dev),
                                   torch.from_numpy(b.vals).to(dev))
    n = plan.num_products
    q = p.clone()
    q[: min(n, 3)] = -0.0
    if n > 6:
        q[3] = float("inf")
        q[5] = float("nan")
    for prods in (p, q):
        before = kernels.launch_counts["esc_run_sum"]
        v1, v2 = torch.empty_like(prods), torch.empty_like(prods)
        runs["launch"](prods, v1)
        runs["launch"](prods, v2)
        torch.cuda.synchronize()
        assert kernels.launch_counts["esc_run_sum"] == before + 2
        want = _sum_runs_torch(prods.cpu(), cpu["order"], cpu["run_off"])
        got = v1.cpu()
        assert torch.equal(got.isnan(), want.isnan())
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
        assert torch.equal(torch.signbit(got), torch.signbit(want))
        assert torch.equal(v1.isnan(), v2.isnan())
        assert torch.equal(torch.nan_to_num(v1), torch.nan_to_num(v2))
        assert not v1[runs["num_summed"]:].any()


@pytest.mark.parametrize("case", ["padded", "multi_tile_k", "lk1_rk1", "wide_window"])
def test_esc_spgemm_sort_repeats_bitwise(dev, case, monkeypatch):
    """``EscSpgemm(reduce="sort").multiply_device`` on the card: no
    ``torch.sort`` a call, equal bits on two calls, the CPU engine's
    pattern and values within the SpGEMM bound against float64, and the
    same for a re-multiply with fresh values."""
    from sparse_matrix_tpu_torch.native import kernels
    from sparse_matrix_tpu_torch.ops.device_sorted import EscSpgemm, padded_to_host

    a, b = _expand_cases()[case]
    eng = EscSpgemm(a, b, device=dev, reduce="sort")
    assert "lv_lane" not in eng._expand_arrs and "launch" in eng._runs

    def no_sort(*args, **kw):
        raise AssertionError("torch.sort called in multiply_device")

    before = dict(kernels.launch_counts)
    monkeypatch.setattr(torch, "sort", no_sort)
    c1, c2 = eng.multiply_device(), eng.multiply_device()
    monkeypatch.undo()
    torch.cuda.synchronize()
    assert kernels.launch_counts["esc_expand"] == before["esc_expand"] + 2
    assert kernels.launch_counts["esc_run_sum"] == before["esc_run_sum"] + 2
    assert torch.equal(c1.val, c2.val) and int(c1.nnz) == int(c2.nnz)
    c = padded_to_host(c1)
    want = EscSpgemm(a, b, device="cpu", reduce="sort").multiply()
    assert np.array_equal(c.offsets, want.offsets) and np.array_equal(c.indices, want.indices)
    _spgemm_bounded(a, b, c)
    rng = np.random.default_rng(14)
    nl = rng.standard_normal(a.nnz()).astype(np.float32)
    nr = rng.standard_normal(b.nnz()).astype(np.float32)
    a2 = CsrMatrix(a.rows, a.cols, nl, a.indices, a.offsets, is_sorted=a.is_sorted)
    b2 = CsrMatrix(b.rows, b.cols, nr, b.indices, b.offsets, is_sorted=b.is_sorted)
    f1 = eng.multiply_device(lhs_vals=torch.from_numpy(nl).to(dev), rhs_vals=nr)
    f2 = eng.multiply_device(lhs_vals=nl, rhs_vals=torch.from_numpy(nr).to(dev))
    assert torch.equal(f1.val, f2.val)
    _spgemm_bounded(a2, b2, padded_to_host(f1))


@pytest.mark.parametrize("force", ["dia", "hybrid", "aligned", "lanepack", "bell", "stripe"])
def test_float64_operator_refused_at_construction(dev, force):
    """A float64 operator of a kernel-backed format other than DIA is
    refused when it is made on the card, with the format and the card
    named (hybrid too: its residual runs an f32 kernel); the CPU still runs
    it. A float64 DIA operator runs on the card through the f64 DIA kernel
    and matches the CPU within a few f64 roundoffs of each row's |A||x|
    (fused multiply-adds; 5 entries a row), and is refused with bf16
    planes."""
    from sparse_matrix_tpu_torch.native import kernels
    from sparse_matrix_tpu_torch.ops.operator import SpmvOperator

    a = poisson_2d_csr(48, dtype=np.float64)
    if force == "hybrid":
        rng = np.random.default_rng(6)
        r = np.r_[a.row_ids(), rng.integers(0, a.rows, 300)]
        c = np.r_[a.indices.astype(np.int64), rng.integers(0, a.cols, 300)]
        a = CsrMatrix.from_coo(a.rows, a.cols, r, c, np.r_[a.vals, rng.standard_normal(300)])
    name = torch.cuda.get_device_name(dev)
    op = SpmvOperator(a, device="cpu", dtype=torch.float64, force=force)
    assert op.format == force and op(torch.ones(a.cols, dtype=torch.float64)).dtype == torch.float64
    if force == "dia":
        x = torch.from_numpy(np.random.default_rng(6).standard_normal(a.cols))
        card = SpmvOperator(a, device=dev, dtype=torch.float64, force=force)
        before = kernels.launch_counts["dia"]
        y = card(x.to(dev))
        torch.cuda.synchronize()
        assert kernels.launch_counts["dia"] == before + 1 and y.dtype == torch.float64
        bound = 8 * 2.0 ** -53 * SpmvOperator(_abs_csr(a), device="cpu", dtype=torch.float64,
                                              force=force)(x.abs())
        assert bool(((y.cpu() - op(x)).abs() <= bound).all())
        with pytest.raises(TypeError, match=f"float64 dia plans .*{name}"):
            SpmvOperator(a, device=dev, dtype=torch.float64, force=force,
                         values_dtype=torch.bfloat16)
        return
    with pytest.raises(TypeError, match=f"float64 {force} plans .*{name}"):
        SpmvOperator(a, device=dev, dtype=torch.float64, force=force)


def test_float64_ell_operator_runs_on_card(dev):
    from sparse_matrix_tpu_torch.ops.operator import SpmvOperator

    a = corpus.random_uniform(np.random.default_rng(15), 500, 0.02)
    a = CsrMatrix(a.rows, a.cols, a.vals.astype(np.float64), a.indices, a.offsets, is_sorted=True)
    x = torch.from_numpy(np.random.default_rng(16).standard_normal(a.cols))
    op = SpmvOperator(a, device=dev, dtype=torch.float64, force="ell")
    assert op.format == "ell"
    y = op(x.to(dev)).cpu()
    want = SpmvOperator(a, device="cpu", dtype=torch.float64, force="ell")(x)
    assert y.dtype == torch.float64 and torch.allclose(y, want, rtol=1e-13, atol=1e-13)


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


def _trisweep_case(case):
    """A triangular factor: L or L^T of Poisson 48^2's IC(0), or L or U of
    the ILU(0) of a dominant fem-like matrix (1,600 rows, 10 bands)."""
    from sparse_matrix_tpu_torch.solvers import ilu

    if case.startswith("poisson"):
        lc = ilu.ic0(poisson_2d_csr(48, dtype=np.float32))
        return lc if case == "poisson_L" else lc.transpose()
    m = corpus.with_dominant_diagonal(_f32(corpus.fem_like(np.random.default_rng(16), 40, 2)))
    f = ilu.ilu0(m)
    return f.l if case == "fem_L" else f.u


def _trisweep_inputs(t, dev, seed=17):
    """(plan, b, dinv) of the fused solve on ``t`` on ``dev``."""
    from sparse_matrix_tpu_torch.solvers.ilu import TriangularJacobi

    sj = TriangularJacobi(t, device=dev, fused=True)
    assert sj._fused is not None
    b = torch.from_numpy(np.random.default_rng(seed).standard_normal(t.rows).astype(np.float32))
    return sj._fused, b.to(dev), sj.dinv


@pytest.mark.parametrize("sweeps", [0, 1, 4, 7])
@pytest.mark.parametrize("case", ["poisson_L", "poisson_LT", "fem_L", "fem_U"])
def test_trisweep_kernel(dev, case, sweeps):
    """Bit-equal to the plain version on the card and to the CPU, one
    launch per solve, within the float64 running bound."""
    from sparse_matrix_tpu_torch.native import kernels
    from sparse_matrix_tpu_torch.ops import trisweep as tw

    plan, b, dinv = _trisweep_inputs(_trisweep_case(case), dev)
    before = kernels.launch_counts["trisweep"]
    y = tw.trisweep(plan, b, dinv, sweeps=sweeps)
    torch.cuda.synchronize()
    assert kernels.launch_counts["trisweep"] == before + 1
    plain = tw._trisweep_torch(plan.data, b, dinv, offsets=plan.offsets, rows=plan.rows,
                               sweeps=sweeps)
    assert torch.equal(y, plain)
    cpu = tw._trisweep_torch(plan.data.cpu(), b.cpu(), dinv.cpu(), offsets=plan.offsets,
                             rows=plan.rows, sweeps=sweeps)
    assert torch.equal(y.cpu(), cpu)
    x64, bound = tw.trisweep_f64_bound(plan, b, dinv, sweeps=sweeps)
    assert bool(((y.double() - x64).abs() <= bound).all())


def test_trisweep_kernel_exact_after_depth_sweeps(dev):
    """Nilpotency on Poisson 64^2's IC(0) factor: depth(L) - 1 = 126 sweeps
    reproduce the exact host solve (rtol 2e-4, atol 2e-5, as
    tests/test_ilu.py)."""
    from sparse_matrix_tpu_torch.ops import trisweep as tw
    from sparse_matrix_tpu_torch.solvers import ilu

    lc = ilu.ic0(poisson_2d_csr(64, dtype=np.float32))
    plan, b, dinv = _trisweep_inputs(lc, dev)
    x = tw.trisweep(plan, b, dinv, sweeps=126).cpu().numpy()
    want = ilu.trisolve_host(lc, b.cpu().numpy().astype(np.float64), lower=True)
    np.testing.assert_allclose(x, want, rtol=2e-4, atol=2e-5)


def test_trisweep_kernel_zero_rhs(dev):
    from sparse_matrix_tpu_torch.ops import trisweep as tw

    plan, b, dinv = _trisweep_inputs(_trisweep_case("fem_U"), dev)
    y = tw.trisweep(plan, torch.zeros_like(b), dinv, sweeps=4)
    assert y.shape == b.shape and not bool(y.any())


@pytest.mark.parametrize("chunk_rows", [32, 64, 512, None])
@pytest.mark.parametrize("case", ["poisson_L", "poisson_LT", "fem_L", "fem_U"])
def test_trisweep_kernel_chunk_sizes(dev, case, chunk_rows):
    """At chunk sizes below and above the factor's reach (Poisson 48^2:
    48; fem: 43), with a ragged last chunk, and at the default: bit-equal
    to the plain version at every sweep count of test_trisweep_kernel,
    two solves giving equal bits, the ticket back at 0."""
    from sparse_matrix_tpu_torch.ops import trisweep as tw

    t = _trisweep_case(case)
    plan0, b, dinv = _trisweep_inputs(t, dev)
    plan = tw.TrisweepPlan(plan0.offsets, plan0.data.cpu().numpy(), plan0.rows, device=dev,
                           chunk_rows=chunk_rows)
    assert chunk_rows is None or plan.chunk_rows == chunk_rows
    for sweeps in (0, 1, 4, 7):
        y1 = tw.trisweep(plan, b, dinv, sweeps=sweeps)
        y2 = tw.trisweep(plan, b, dinv, sweeps=sweeps)
        plain = tw._trisweep_torch(plan.data, b, dinv, offsets=plan.offsets, rows=plan.rows,
                                   sweeps=sweeps)
        torch.cuda.synchronize()
        assert torch.equal(y1, plain) and torch.equal(y1, y2), sweeps
    assert int(plan._state[0]) == 0


@pytest.mark.parametrize("chunk_rows", [4096, None])
def test_trisweep_kernel_long_reach_reads_neighbours_from_l2(dev, chunk_rows):
    """A reach past the rows the kernel stages (offsets -9000, -3, -1 on
    30,000 rows): the neighbours' rows come from their slots in L2, from
    one chunk back or, in chunks of 4096 rows, from three; bit-equal to
    the plain version at 0 to 4 sweeps."""
    from sparse_matrix_tpu_torch.ops import trisweep as tw

    rng = np.random.default_rng(21)
    rows, offsets = 30_000, (-9000, -3, -1)
    data = rng.uniform(-0.3, 0.3, (3, rows)).astype(np.float32)
    plan = tw.TrisweepPlan(offsets, data, rows, device=dev, chunk_rows=chunk_rows)
    assert plan.halo == 0
    b = torch.from_numpy(rng.standard_normal(rows).astype(np.float32)).to(dev)
    dinv = torch.from_numpy(rng.uniform(0.5, 1.0, rows).astype(np.float32)).to(dev)
    for sweeps in range(5):
        y = tw.trisweep(plan, b, dinv, sweeps=sweeps)
        plain = tw._trisweep_torch(plan.data, b, dinv, offsets=offsets, rows=rows, sweeps=sweeps)
        torch.cuda.synchronize()
        assert torch.equal(y, plain), sweeps


def test_trisweep_kernel_deep_sweeps_many_chunks(dev):
    """126 sweeps on Poisson 64^2's IC(0) L in chunks of 64 rows (its
    reach): 64 chunks hand 126 levels down the rows; bit-equal to the
    plain version and equal to the exact host solve."""
    from sparse_matrix_tpu_torch.ops import trisweep as tw
    from sparse_matrix_tpu_torch.solvers import ilu

    lc = ilu.ic0(poisson_2d_csr(64, dtype=np.float32))
    plan0, b, dinv = _trisweep_inputs(lc, dev)
    plan = tw.TrisweepPlan(plan0.offsets, plan0.data.cpu().numpy(), plan0.rows, device=dev,
                           chunk_rows=64)
    y = tw.trisweep(plan, b, dinv, sweeps=126)
    plain = tw._trisweep_torch(plan.data, b, dinv, offsets=plan.offsets, rows=plan.rows,
                               sweeps=126)
    torch.cuda.synchronize()
    assert torch.equal(y, plain)
    want = ilu.trisolve_host(lc, b.cpu().numpy().astype(np.float64), lower=True)
    np.testing.assert_allclose(y.cpu().numpy(), want, rtol=2e-4, atol=2e-5)


def test_trisweep_kernel_back_to_back_solves(dev):
    """1,000 solves back to back, alternating two plans (L in chunks of 32
    rows, U in chunks of 64), with nothing reset between them: every
    result equals its plain version bit for bit; each plan's ticket ends
    at 0 and its epoch counts its launches."""
    from sparse_matrix_tpu_torch.ops import trisweep as tw

    plans = []
    for case, t_rows in (("poisson_L", 32), ("fem_U", 64)):
        plan0, b, dinv = _trisweep_inputs(_trisweep_case(case), dev)
        plan = tw.TrisweepPlan(plan0.offsets, plan0.data.cpu().numpy(), plan0.rows,
                               device=dev, chunk_rows=t_rows)
        want = tw._trisweep_torch(plan.data, b, dinv, offsets=plan.offsets, rows=plan.rows,
                                  sweeps=4)
        plans.append((plan, b, dinv, want))
    bad = torch.zeros((), dtype=torch.int64, device=dev)
    for i in range(1000):
        plan, b, dinv, want = plans[i % 2]
        bad += (tw.trisweep(plan, b, dinv, sweeps=4) != want).sum()
    torch.cuda.synchronize()
    assert int(bad) == 0
    for plan, *_ in plans:
        assert plan._state.tolist() == [0, 500]


def test_trisweep_record_refuses_bad_inputs(dev):
    """The trisweep launch record refuses b on the CPU, another dtype, a
    wrong length, y aliasing b, and more sweeps than its scratch holds;
    the wrapper makes a larger record instead."""
    from sparse_matrix_tpu_torch.native import kernels
    from sparse_matrix_tpu_torch.ops import trisweep as tw

    plan0, b, dinv = _trisweep_inputs(_trisweep_case("poisson_L"), dev)
    plan = tw.TrisweepPlan(plan0.offsets, plan0.data.cpu().numpy(), plan0.rows, device=dev,
                           chunk_rows=64)
    rec = plan._record(2)
    y = torch.empty_like(b)
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="is on cpu"):
        rec(b.cpu(), dinv, y, 2)
    with pytest.raises(TypeError, match="dtype"):
        rec(b.double(), dinv, y, 2)
    with pytest.raises(ValueError, match="elements"):
        rec(b[1:], dinv, y, 2)
    with pytest.raises(ValueError, match="alias"):
        rec(b, dinv, b, 2)
    with pytest.raises(ValueError, match="sweeps"):
        rec(b, dinv, y, 3)
    assert kernels.launch_counts == before
    y3 = tw.trisweep(plan, b, dinv, sweeps=3)
    assert plan.launch is not rec and plan.launch.levels == 3
    assert torch.equal(y3, tw._trisweep_torch(plan.data, b, dinv, offsets=plan.offsets,
                                              rows=plan.rows, sweeps=3))


@pytest.mark.parametrize("solver", ["ic_pcg", "bicgstab", "gmres"])
def test_ilu_solvers_on_card_match_cpu(dev, solver):
    """The ILU path on the card against the CPU run: iterations within +-2,
    ``|x_gpu - x_cpu| <= 1e-4 |x_cpu|`` (the DIA SpMV kernel may round
    differently from the plain version)."""
    from sparse_matrix_tpu_torch.native import kernels
    from sparse_matrix_tpu_torch.ops.operator import SpmvOperator
    from sparse_matrix_tpu_torch.solvers import bicgstab, cg, gmres, ilu

    if solver == "ic_pcg":
        a = poisson_2d_csr(48, dtype=np.float32)
        make = ilu.ic_preconditioner
    else:
        a = corpus.with_dominant_diagonal(_f32(corpus.fem_like(np.random.default_rng(16), 40, 2)))
        make = ilu.ilu_preconditioner
    b = torch.from_numpy(np.random.default_rng(18).standard_normal(a.rows).astype(np.float32))
    out = {}
    for d in (dev, "cpu"):
        op = SpmvOperator(a, device=d)
        m_inv = make(a, device=d, sweeps=3, fused=True)
        before = kernels.launch_counts["trisweep"]
        if solver == "ic_pcg":
            res = cg.pcg_solve(op, b.to(d), m_inv, tol=1e-5, maxiter=2000)
        elif solver == "bicgstab":
            res = bicgstab.bicgstab_solve(op, b.to(d), m_inv=m_inv, tol=1e-6, maxiter=500)
        else:
            res = gmres.gmres_solve(op, b.to(d), m_inv=m_inv, restart=10, tol=1e-6,
                                    maxiter=500)
        assert (kernels.launch_counts["trisweep"] > before) == (d == dev)
        out[str(d)] = res
    gpu, cpu = out[str(dev)], out["cpu"]
    assert abs(gpu.iterations - cpu.iterations) <= 2
    x, xc = gpu.x.cpu().double(), cpu.x.double()
    assert float(torch.linalg.norm(x - xc)) <= 1e-4 * float(torch.linalg.norm(xc))


def _poisson_cond(n: int) -> float:
    """cond_2 of the n^2 five-point Laplacian."""
    h = np.pi / (2 * (n + 1))
    return float(np.sin(n * h) ** 2 / np.sin(h) ** 2)


def test_amg_pcg_on_card(dev):
    """AMG-PCG on Poisson 256^2 on the card: converged to tol, the true
    residual within eps * cond(A) * |b|, the DIA kernel launched (level
    0), in far fewer iterations than plain CG needs."""
    from sparse_matrix_tpu_torch.native import kernels
    from sparse_matrix_tpu_torch.solvers import amg

    a = poisson_2d_csr(256, dtype=np.float32)
    b_np = np.random.default_rng(20).standard_normal(a.rows).astype(np.float32)
    hier = amg.amg_setup(a, device=dev)
    assert hier.levels[0].a_op.format == "dia" and hier.levels[0].dinv.is_cuda
    before = kernels.launch_counts["dia"]
    res = amg.amg_pcg_solve(a, torch.from_numpy(b_np).to(dev), tol=1e-5, maxiter=100,
                            hierarchy=hier)
    assert kernels.launch_counts["dia"] > before
    bnorm = float(np.linalg.norm(b_np.astype(np.float64)))
    assert float(res.residual_norm) <= 1e-5 * bnorm * (1 + 1e-6)
    assert res.iterations <= 30
    x = res.x.cpu().numpy()
    ax, _ = spmv.spmv_f64_bound(a, x)
    assert np.linalg.norm(b_np - ax) <= np.finfo(np.float32).eps * _poisson_cond(256) * bnorm


@pytest.mark.parametrize("k", [None, 8])
def test_amg_vcycle_on_card_matches_cpu(dev, k):
    """The V-cycle of one coarsening planned on the card and on the CPU:
    within 1e-5 normwise (the kernels may round differently from the
    plain versions)."""
    from sparse_matrix_tpu_torch.solvers import amg

    a = poisson_2d_csr(128, dtype=np.float32)
    coarsening = amg.amg_coarsen(a, device="cpu")
    shape = (a.rows,) if k is None else (a.rows, k)
    r = torch.from_numpy(np.random.default_rng(21).standard_normal(shape).astype(np.float32))
    out = {}
    for d in (dev, "cpu"):
        for smoother in ("jacobi", "chebyshev"):
            hier = amg.amg_setup(a, device=d, smoother=smoother, coarsening=coarsening)
            out[str(d), smoother] = hier.vcycle(r.to(d)).cpu().double()
    for smoother in ("jacobi", "chebyshev"):
        g, c = out[str(dev), smoother], out["cpu", smoother]
        assert float(torch.linalg.norm(g - c)) <= 1e-5 * float(torch.linalg.norm(c))


def test_amg_refuses_tf32(dev):
    from sparse_matrix_tpu_torch.solvers import amg

    a = poisson_2d_csr(32, dtype=np.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            amg.amg_setup(a, device=dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        hier = amg.amg_setup(a, device=dev, coarse_size=100)
        r = torch.ones(a.rows, device=dev)
        hier.vcycle(r)
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            hier.vcycle(r)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def test_amg_float64_refused_on_card(dev):
    """A float64 hierarchy on the card raises the operator's TypeError
    (ROADMAP C19), also with bf16 planes asked for (only their ValueError
    is caught)."""
    from sparse_matrix_tpu_torch.solvers import amg

    a = poisson_2d_csr(32, dtype=np.float32)
    for kw in ({}, {"values_dtype": torch.bfloat16}):
        with pytest.raises(TypeError, match="float64"):
            amg.amg_setup(a, device=dev, dtype=torch.float64, **kw)


def _amg_graph_case(dev, n, smoother):
    """A hierarchy on Poisson n^2 on the card and four residual vectors."""
    from sparse_matrix_tpu_torch.solvers import amg

    torch.backends.cuda.matmul.allow_tf32 = False
    a = poisson_2d_csr(n, dtype=np.float32)
    hier = amg.amg_setup(a, device=dev, smoother=smoother)
    rs = torch.from_numpy(np.random.default_rng(23).standard_normal((4, a.rows))
                          .astype(np.float32)).to(dev)
    return a, hier, rs


def _launched(fn):
    """``fn()`` with the spans on: its result, the kernel launches it
    counted (``kernels.launch_counts``, once the device is done) and the
    V-cycle replays it made (``spmx.amg.graph`` spans)."""
    from sparse_matrix_tpu_torch.native import kernels
    from sparse_matrix_tpu_torch.utils import profiling

    profiling.take()
    before = dict(kernels.launch_counts)
    profiling.enable()
    try:
        out = fn()
    finally:
        profiling.disable()
    torch.cuda.synchronize()
    grown = {k: kernels.launch_counts[k] - before[k] for k in before}
    return out, grown, sum(s.name == "spmx.amg.graph" for s in profiling.take())


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
@pytest.mark.parametrize("n", [128, 256])
def test_amg_graph_replay_equals_eager_vcycle(dev, n, smoother):
    """``M^-1`` on a residual vector on the card replays the V-cycle
    captured as one CUDA graph: bit-equal to the eager ``hier.vcycle`` over
    several residuals; one ``spmx.amg.graph`` span a replay, and each
    replay counts the eager V-cycle's kernel launches (the capture counts
    none); each answer the caller's own, unchanged by the next call; eager
    applies of every level's operators between replays (their scratch and
    tickets used in stream order) change no bit."""
    _a, hier, rs = _amg_graph_case(dev, n, smoother)
    m_inv = hier.preconditioner()
    first = m_inv(rs[0])  # captures, then replays
    graph = hier._graph
    assert graph is not None and graph.static_out.data_ptr() != first.data_ptr()
    kept = first.clone()
    _, eager, replays = _launched(lambda: hier.vcycle(rs[0]))
    assert replays == 0 and sum(eager.values()) > 0
    assert graph.launches == {k: v for k, v in eager.items() if v}
    rest, grown, replays = _launched(lambda: [m_inv(r) for r in rs[1:]])
    assert replays == len(rs) - 1
    assert grown == {k: (len(rs) - 1) * v for k, v in eager.items()}
    outs = [first] + rest
    assert torch.equal(first, kept)
    for r, got in zip(rs, outs):
        assert torch.equal(got, hier.vcycle(r))
    for r, want in zip(rs, outs):
        for lv in hier.levels:
            for op in (lv.a_op, lv.p_op, lv.pt_op):
                op(torch.ones(op.cols, device=dev))
        assert torch.equal(m_inv(r), want)
    assert hier._graph is graph


@pytest.mark.parametrize("smoother,knob", [("jacobi", "nu"), ("chebyshev", "cheb_degree")])
def test_amg_graph_refuses_tf32_and_recaptures(dev, smoother, knob):
    """The graph path refuses TF32 on every call, not only at capture, and
    launches nothing then; a change to the smoother's sweep count
    recaptures, and the new graph equals the eager V-cycle."""
    from sparse_matrix_tpu_torch.native import kernels

    _a, hier, rs = _amg_graph_case(dev, 128, smoother)
    m_inv = hier.preconditioner()
    old = m_inv(rs[0])
    graph = hier._graph
    before = dict(kernels.launch_counts)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            m_inv(rs[0])
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    assert kernels.launch_counts == before
    setattr(hier, knob, getattr(hier, knob) + 1)
    new = m_inv(rs[0])
    assert hier._graph is not graph and hier._graph.key != graph.key
    assert torch.equal(new, hier.vcycle(rs[0])) and not torch.equal(new, old)
    assert torch.equal(m_inv(rs[1]), hier.vcycle(rs[1]))


@pytest.mark.parametrize("smoother", ["jacobi", "chebyshev"])
@pytest.mark.parametrize("n", [128, 256])
def test_amg_pcg_graph_equals_eager_pcg(dev, n, smoother):
    """``amg_pcg_solve`` on a vector (the graph path) takes the iterations,
    gives the bits and counts the kernel launches of a PCG driven by the
    eager ``hier.vcycle``, with one replay an ``M^-1``."""
    from sparse_matrix_tpu_torch.solvers import amg, cg

    a, hier, rs = _amg_graph_case(dev, n, smoother)
    hier.preconditioner()(rs[1])  # the capture
    res, grown, replays = _launched(
        lambda: amg.amg_pcg_solve(a, rs[0], tol=1e-5, maxiter=100, hierarchy=hier))
    eager, grown_eager, _ = _launched(
        lambda: cg.pcg_solve(hier.levels[0].a_op, rs[0], hier.vcycle, tol=1e-5, maxiter=100))
    assert replays == res.iterations + 1
    assert res.iterations == eager.iterations and res.iterations <= 30
    assert torch.equal(res.x, eager.x)
    assert grown == grown_eager


def _kernels_in(events, name):
    """The device kernels launched inside the ranges ``name`` of a Chrome
    trace, counted by kernel name (the launching runtime call, found by its
    correlation id, lies in one of the ranges; a graph's kernels share its
    launch's id)."""
    import bisect
    from collections import Counter

    launch, ops, iv = {}, [], []
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, args = ev.get("cat", ""), ev.get("args") or {}
        if cat == "kernel":
            ops.append((args.get("correlation"), ev.get("name")))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch[args["correlation"]] = float(ev["ts"])
        elif cat == "user_annotation" and ev.get("name") == name:
            iv.append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
    iv.sort()
    starts = [s for s, _ in iv]
    out = Counter()
    for corr, kname in ops:
        t = launch.get(corr)
        i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
        if i >= 0 and t <= iv[i][1]:
            out[kname] += 1
    return dict(out)


def test_spans_hold_their_device_work(dev, tmp_path):
    """AMG-PCG and an ESC refresh on the card under ``profiling.trace``: the
    Chrome trace holds the program's spans on the clock of the kernels they
    launched (each level's span of an eager V-cycle holds the device time
    of the levels below it, each replay's ``spmx.amg.graph`` the eager
    V-cycle's kernels, each stopping-test read a device-to-host copy), and
    the spans launch nothing and change no bit."""
    import json

    from sparse_matrix_tpu_torch.bench.amg_times import _device_ms_in
    from sparse_matrix_tpu_torch.native import kernels
    from sparse_matrix_tpu_torch.ops.device_sorted import EscSpgemm
    from sparse_matrix_tpu_torch.solvers import amg
    from sparse_matrix_tpu_torch.utils import profiling

    torch.backends.cuda.matmul.allow_tf32 = False
    a = poisson_2d_csr(128, dtype=np.float32)
    hier = amg.amg_setup(a, device=dev, coarse_size=100)
    eng = EscSpgemm(a, a, device=dev, reduce="sort")
    b = torch.from_numpy(np.random.default_rng(22).standard_normal(a.rows)
                         .astype(np.float32)).to(dev)

    def solve_and_refresh():
        before = dict(kernels.launch_counts)
        res = amg.amg_pcg_solve(a, b, tol=1e-5, maxiter=100, hierarchy=hier)
        c = eng.multiply_device()
        torch.cuda.synchronize()
        grown = {k: v - before.get(k, 0) for k, v in kernels.launch_counts.items()}
        return res, c, grown

    solve_and_refresh()  # the first M^-1 on a vector captures the V-cycle's graph
    res_off, c_off, grown_off = solve_and_refresh()
    path = tmp_path / "spans.json"
    with profiling.trace(path):
        res_on, c_on, grown_on = solve_and_refresh()
        hier.vcycle(b)  # the eager V-cycle, whose level spans amg_times.py reads
    assert profiling.take() == []  # spans were off: the trace alone holds them
    assert grown_on == grown_off and res_on.iterations == res_off.iterations
    assert torch.equal(res_on.x, res_off.x) and torch.equal(c_on.val, c_off.val)
    data = json.loads(path.read_text())
    events = data["traceEvents"] if isinstance(data, dict) else data
    names = [e.get("name") for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    assert names.count("spmx.esc.multiply") == 1
    assert names.count("spmx.amg.graph") == res_on.iterations + 1
    nlev = len(hier.levels)
    assert nlev >= 2
    levels = [f"spmx.amg.level{i}" for i in range(nlev)] + ["spmx.amg.coarse"]
    assert all(names.count(n) == 1 for n in levels)  # the replays open no level span
    ms = _device_ms_in(events, levels + ["spmx.amg.graph", "spmx.krylov.sync",
                                         "spmx.esc.expand", "spmx.esc.reduce",
                                         "spmx.esc.multiply"])
    for upper, lower in zip(levels, levels[1:]):
        assert ms[upper] > ms[lower] > 0
    # each replay holds the eager V-cycle's kernels (and the copies in and out)
    graph_kernels = _kernels_in(events, "spmx.amg.graph")
    vcycle_kernels = _kernels_in(events, "spmx.amg.level0")
    assert graph_kernels == {k: (res_on.iterations + 1) * v for k, v in vcycle_kernels.items()}
    assert ms["spmx.amg.graph"] > ms["spmx.amg.level0"] > 0
    assert ms["spmx.krylov.sync"] > 0  # the reads' device-to-host copies
    assert ms["spmx.esc.expand"] > 0 and ms["spmx.esc.reduce"] > 0
    assert ms["spmx.esc.multiply"] == pytest.approx(ms["spmx.esc.expand"]
                                                    + ms["spmx.esc.reduce"])


# -- HPCG: the float64 DIA kernel, the SymGS kernel, the "symgs" hierarchy --------


def _abs_csr(a):
    return CsrMatrix(a.rows, a.cols, np.abs(a.vals), a.indices, a.offsets, is_sorted=a.is_sorted)


def _hpcg_rhs(grid, dev, seed):
    """``A u`` of a seeded standard normal u on the 27-point grid, f64."""
    from sparse_matrix_tpu_torch.reference import hpcg as ref

    nx, ny, nz = grid
    u = torch.from_numpy(np.random.default_rng(seed).standard_normal(nx * ny * nz)).to(dev)
    return ref.apply_a(u.reshape(nz, ny, nx)).reshape(-1)


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("grid", [(16, 16, 16), (24, 16, 8), (13, 13, 13)])
def test_dia_f64_kernel_on_hpcg(dev, grid):
    """The f64 DIA kernel on HPCG's 27-point operator (the dispatch takes
    DIA): within 32 f64 roundoffs of each row's |A||x| of the CPU's plain
    f64 result (27 products a row, fused multiply-adds), and the same bits
    on a second call; a float64 ``matmat`` of two columns raises the DIA
    SpMM kernel's ``TypeError``."""
    from sparse_matrix_tpu_torch.native import kernels
    from sparse_matrix_tpu_torch.ops.operator import SpmvOperator
    from sparse_matrix_tpu_torch.solvers.hpcg import hpcg_problem

    a, _ = hpcg_problem(*grid)
    op = SpmvOperator(a, device=dev, dtype=torch.float64)
    assert op.format == "dia" and op.part("dia").arrays["data"].dtype == torch.float64
    x = torch.from_numpy(np.random.default_rng(31).standard_normal(a.cols))
    before = kernels.launch_counts["dia"]
    y = op(x.to(dev))
    torch.cuda.synchronize()
    assert kernels.launch_counts["dia"] == before + 1
    want = SpmvOperator(a, device="cpu", dtype=torch.float64)(x)
    bound = 32 * 2.0 ** -53 * SpmvOperator(_abs_csr(a), device="cpu", dtype=torch.float64)(x.abs())
    assert bool(((y.cpu() - want).abs() <= bound).all())
    assert torch.equal(op(x.to(dev)), y)
    # the DIA SpMM kernel has no f64 form: a float64 block is refused by it
    with pytest.raises(TypeError, match="dia_spmm"):
        op.matmat(torch.stack([x, 2 * x], dim=1).to(dev))


#: sha256 of the f32 DIA kernel's y on Poisson 256^2, x from default_rng(0)
#: standard normal in f32: the kernel's bits before its f64 form was added
#: to its source, read on an H100 80GB HBM3
F32_DIA_BITS = "2652efbca09ea190e76ff1a5b572d83a8d5eedd594bfb1809f817c41e6bd1919"


def test_dia_f32_bits_unchanged(dev):
    """The f32 DIA kernel gives the bits it gave before the f64 form was
    added to its source (the Poisson cells run it)."""
    import hashlib

    m = poisson_2d_csr(256, dtype=np.float32)
    dia = try_dia_from_csr(m)
    arrs = spmv_dia.dia_device_arrays(dia, dev)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(m.cols).astype(np.float32))
    y = spmv_dia.spmv_dia(dia, x.to(dev), device_arrays=arrs).cpu().numpy()
    assert hashlib.sha256(y.tobytes()).hexdigest() == F32_DIA_BITS


#: sha256 of x and the launch counts of two solves, read on an H100 80GB
#: HBM3 before B1, B9, B10, B11 and the Krylov kernels moved onto launch
#: records: CG to 1e-5 on Poisson 256^2 (the dispatched DIA operator, b
#: standard normal from default_rng(0)) and an HPCG set on its 16^3 grid
#: (4 levels, 50 iterations, FP64, HPCG's b); the set's SymGS launches are
#: one a step since the colour passes share one launch (its x the same bits)
SOLVE_BITS = {
    "cg_poisson256": ("0a4e4bb1791f77eab8a944aec5fc7226dde01edfb87468ae144c5bada28568e2",
                      {"dia": 548, "krylov_dot": 548, "cg_update": 547, "p_update": 547}),
    "hpcg16": ("21297fefefa502ddb5e99ba3f7dbe4c4f508562cd56af995b2e1d3d45a4241e7",
               {"dia": 207, "symgs": 364, "krylov_dot": 102, "cg_update": 50,
                "p_update": 50}),
}


@pytest.mark.parametrize("case", list(SOLVE_BITS))
def test_solve_bits_unchanged(dev, case):
    """A CG solve and an HPCG set give the bits and launch counts they gave
    before the launch path was shared."""
    import hashlib

    from sparse_matrix_tpu_torch.native import kernels
    from sparse_matrix_tpu_torch.ops.operator import SpmvOperator
    from sparse_matrix_tpu_torch.reference import hpcg as ref
    from sparse_matrix_tpu_torch.solvers import amg, cg
    from sparse_matrix_tpu_torch.solvers.hpcg import hpcg_hierarchy

    if case == "cg_poisson256":
        m = poisson_2d_csr(256, dtype=np.float32)
        op = SpmvOperator(m, device=dev)
        b = torch.from_numpy(np.random.default_rng(0).standard_normal(m.rows)
                             .astype(np.float32)).to(dev)
        kernels.reset_launch_counts()
        x = cg.cg_solve(op, b, tol=1e-5).x
    else:
        hier = hpcg_hierarchy(16, 16, 16, device=dev, dtype=torch.float64, levels=4)
        b = ref.hpcg_rhs(16, 16, 16, dtype=torch.float64, device=dev)
        kernels.reset_launch_counts()
        x = amg.amg_pcg_solve(hier.levels[0].a_op, b, hierarchy=hier, tol=0.0, maxiter=50).x
    torch.cuda.synchronize()
    counts = {k: v for k, v in kernels.launch_counts.items() if v}
    assert (hashlib.sha256(x.cpu().numpy().tobytes()).hexdigest(), counts) == SOLVE_BITS[case]


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("grid", [(24, 16, 8), (13, 13, 13), (104, 104, 104)])
def test_symgs_kernel_matches_plain(dev, dtype, grid):
    """One SymGS step of the kernel (all 16 colour passes in one launch;
    at 104^3 a pass has more chunks than the card holds blocks, so the
    ticket order matters) against the plain version on the CPU and the
    reference's grid SymGS on the card: within 1e-13 (f64) or 1e-5 (f32)
    normwise, the sums taken in other orders; the bits of the step as one
    launch a colour pass (``by_pass``); the same bits on a second call and
    on three replays of the step captured in a CUDA graph, from the same
    x0 and r (the ticket and the pass counts reset themselves); x updated
    in place."""
    from sparse_matrix_tpu_torch.native import kernels
    from sparse_matrix_tpu_torch.ops.symgs import SymgsPlan, parity_colors
    from sparse_matrix_tpu_torch.reference import hpcg as ref
    from sparse_matrix_tpu_torch.solvers.hpcg import hpcg_problem

    nx, ny, nz = grid
    a, _ = hpcg_problem(*grid)
    dia = try_dia_from_csr(a, dtype=np.float64)
    colors = parity_colors(*grid)
    rng = np.random.default_rng(32)
    x0 = torch.from_numpy(rng.standard_normal(a.rows)).to(dtype)
    r = torch.from_numpy(rng.standard_normal(a.rows)).to(dtype)
    card = SymgsPlan(dia, colors, device=dev, dtype=dtype)
    before = kernels.launch_counts["symgs"]
    x = x0.to(dev)
    out = card.step(x, r.to(dev))
    torch.cuda.synchronize()
    assert out is x and kernels.launch_counts["symgs"] - before == 1
    by_pass = x0.to(dev)
    card.launch.by_pass(r.to(dev), by_pass)
    assert kernels.launch_counts["symgs"] - before == 1 + 16
    assert torch.equal(by_pass, x)
    plain = SymgsPlan(dia, colors, device="cpu", dtype=dtype).step(x0.clone(), r)
    grid_ref = ref.symgs(x0.to(dev).reshape(nz, ny, nx), r.to(dev).reshape(nz, ny, nx))
    tol = 1e-13 if dtype == torch.float64 else 1e-5
    assert _rel(x.cpu().double(), plain.double()) < tol
    assert _rel(x.double(), grid_ref.reshape(-1).double()) < tol
    again = card.step(x0.to(dev), r.to(dev))
    assert torch.equal(again, x)
    xg, rg = x0.to(dev), r.to(dev)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        card.step(x0.to(dev), rg)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        card.step(xg, rg)
    for _ in range(3):
        xg.copy_(x0.to(dev))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(xg, x)


@pytest.mark.parametrize("grid", [(16, 16, 16), (32, 32, 32)])
def test_hpcg_graph_replay_equals_eager_vcycle(dev, grid):
    """The ``"symgs"`` hierarchy's ``M^-1`` replays its V-cycle as one CUDA
    graph, bit-equal to the eager ``vcycle`` over several residuals; an
    eager V-cycle launches 7 SymGS steps (one launch each, its 16 colour
    passes inside) and each replay counts the same; both within 1e-13 of
    the reference's V-cycle."""
    from sparse_matrix_tpu_torch.reference import hpcg as ref
    from sparse_matrix_tpu_torch.solvers.hpcg import hpcg_hierarchy

    nx, ny, nz = grid
    h = hpcg_hierarchy(*grid, device=dev)
    rs = [_hpcg_rhs(grid, dev, s) for s in range(4)]
    m_inv = h.preconditioner()
    first = m_inv(rs[0])
    graph = h._graph
    assert graph is not None
    _, eager, replays = _launched(lambda: h.vcycle(rs[0]))
    assert replays == 0 and eager["symgs"] == 7 and eager["dia"] == 3
    assert graph.launches == {k: v for k, v in eager.items() if v}
    rest, grown, replays = _launched(lambda: [m_inv(r) for r in rs[1:]])
    assert replays == len(rs) - 1
    assert grown == {k: (len(rs) - 1) * v for k, v in eager.items()}
    for r, got in zip(rs, [first] + rest):
        assert torch.equal(got, h.vcycle(r))
        assert _rel(got, ref.vcycle(r.reshape(nz, ny, nx), 4).reshape(-1)) < 1e-13


def test_hpcg_set_on_card_matches_reference(dev):
    """A set of 50 iterations at tol 0 through ``amg_pcg_solve`` on 32^3:
    51 graph replays (PCG's first M^-1 and one an iteration), the f64 DIA
    kernel for the outer matvec and every level's residual, the SymGS
    kernel for every step; x within 1e-12 of the reference's set on the
    card (both converge to f64 roundoff at this size)."""
    from sparse_matrix_tpu_torch.reference import hpcg as ref
    from sparse_matrix_tpu_torch.solvers import amg
    from sparse_matrix_tpu_torch.solvers.hpcg import hpcg_hierarchy, hpcg_problem

    grid = (32, 32, 32)
    a, _ = hpcg_problem(*grid)
    h = hpcg_hierarchy(*grid, device=dev)
    b = _hpcg_rhs(grid, dev, 40)
    h.preconditioner()(b)  # the capture, whose warm-up V-cycle runs eagerly
    res, grown, replays = _launched(
        lambda: amg.amg_pcg_solve(a, b, hierarchy=h, tol=0.0, maxiter=50))
    assert res.iterations == 50 and replays == 51 and res.x.dtype == torch.float64
    assert grown["symgs"] == 51 * 7 and grown["dia"] == 51 * 3 + 51
    want = ref.cg_set(b, *grid, levels=4, maxiter=50)
    assert want.iterations == 50 and _rel(res.x, want.x) < 1e-12


def _krylov_depth(ks, n):
    """The most roundings a sum of the Krylov kernels' reductions passes
    through: a thread's chain of fused multiply-adds (n over the grid's
    threads, plus a 16-byte piece), two block trees of 8 levels and the
    last block's walk over the partials."""
    threads = ks.blocks * 256
    return -(-n // threads) + 4 + 16 + -(-ks.blocks // 256)


def _dot_err_ok(got, u, v, depth):
    """|got - u.v| within depth roundoffs of sum |u_i v_i| (u.v and the
    sum taken in float64)."""
    eps = torch.finfo(got.dtype).eps / 2
    uv = u.double() * v.double()
    return abs(float(got) - float(uv.sum())) <= depth * eps * float(uv.abs().sum()) + 1e-300


@pytest.mark.parametrize("n", [1, 1001, 4_194_304])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_krylov_kernels_match_plain(dev, dtype, n):
    """The fused Krylov kernels (``krylov_dot``, ``cg_update``,
    ``p_update``) against their plain PyTorch versions on the card: each
    update within 4 roundoffs of ``|x| + |alpha p|`` (a fused multiply-add
    against a product and a sum rounded apart), each inner product within
    its depth's roundoffs of the float64 sum; the same bits on two calls,
    one launch counted each. At n = 1001, 16-byte misaligned vectors (the
    element-at-a-time loop) give the aligned updates' bits."""
    from sparse_matrix_tpu_torch.native import kernels

    rng = np.random.default_rng(n)

    def vec():
        return torch.from_numpy(rng.standard_normal(n)).to(dev, dtype)

    x, r, p, ap, z = (vec() for _ in range(5))
    num, den = (torch.tensor(v, dtype=dtype, device=dev) for v in (0.7, 1.3))
    ks = kernels.KrylovScratch(x)
    depth = _krylov_depth(ks, n)
    eps = torch.finfo(dtype).eps / 2
    before = dict(kernels.launch_counts)

    got = [ks.dot(r, p, 4).clone() for _ in range(2)]
    assert torch.equal(got[0], got[1]) and _dot_err_ok(got[0], r, p, depth)
    assert _dot_err_ok(torch.dot(r, p), r, p, depth)

    def update(xs, rs_, ps, aps):
        return ks.cg_update(xs, rs_, ps, aps, num, den, 1).clone(), xs, rs_

    runs = [update(x.clone(), r.clone(), p, ap) for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*runs))
    rr, xk, rk = runs[0]
    alpha = num / den
    xp, rp = x + alpha * p, r - alpha * ap
    assert torch.all((xk - xp).abs() <= 4 * eps * (x.abs() + (alpha * p).abs()))
    assert torch.all((rk - rp).abs() <= 4 * eps * (r.abs() + (alpha * ap).abs()))
    assert _dot_err_ok(rr, rk, rk, depth)

    pk = [p.clone() for _ in range(2)]
    for q in pk:
        ks.p_update(q, z, den, num)
    beta = den / num
    assert torch.equal(pk[0], pk[1])
    assert torch.all((pk[0] - (z + beta * p)).abs() <= 4 * eps * (z.abs() + (beta * p).abs()))
    torch.cuda.synchronize()
    grown = {k: kernels.launch_counts[k] - before[k] for k in ("krylov_dot", "cg_update",
                                                               "p_update")}
    assert grown == {"krylov_dot": 2, "cg_update": 2, "p_update": 2}

    if n == 1001:  # views one element into their buffers: off 16 bytes
        def off(t):
            buf = torch.empty(n + 1, dtype=dtype, device=dev)
            buf[1:] = t
            return buf[1:]

        xo, ro, po, apo, zo = (off(t) for t in (x, r, p, ap, z))
        rro = ks.cg_update(xo, ro, po, apo, num, den, 1)
        assert torch.equal(xo, xk) and torch.equal(ro, rk) and _dot_err_ok(rro, rk, rk, depth)
        ks.p_update(po, zo, den, num)
        assert torch.equal(po, pk[0])
        assert _dot_err_ok(ks.dot(ro, po, 4), ro, po, depth)


def test_krylov_refuses_aliases_and_dtypes(dev):
    from sparse_matrix_tpu_torch.native import kernels

    x, r, p, ap = (torch.ones(64, device=dev) for _ in range(4))
    s = torch.ones((), device=dev)
    ks = kernels.KrylovScratch(x)
    with pytest.raises(ValueError, match="distinct"):
        ks.cg_update(x, r, r, ap, s, s, 0)
    with pytest.raises(ValueError, match="neither num nor den"):
        ks.cg_update(x, r, p, ap, ks.slots[0], s, 0)
    with pytest.raises(ValueError, match="alias"):
        ks.p_update(p, p, s, s)
    with pytest.raises(ValueError, match="contiguous"):
        ks.dot(torch.ones(128, device=dev)[::2], x, 0)
    with pytest.raises(ValueError, match="contiguous"):
        ks.dot(x.double(), x, 0)
    with pytest.raises(TypeError, match="float32 and float64"):
        kernels.KrylovScratch(x.half())


def _hpcg_case(dev_or_cpu, grid=(32, 32, 32)):
    from sparse_matrix_tpu_torch.solvers.hpcg import hpcg_hierarchy

    return hpcg_hierarchy(*grid, device=dev_or_cpu)


@pytest.mark.parametrize("kind", ["cg", "pcg_jacobi", "pcg_hpcg32"])
def test_krylov_solves_on_card_match_cpu(dev, kind):
    """``cg_solve`` and ``pcg_solve`` on the card (the fused kernels) take
    the CPU's iterations within +-2 and reach its x within 1e-4 (f32) or
    1e-7 (f64, HPCG 32^3 through ``amg_pcg_solve`` to 1e-10: two x at that
    residual differ by at most 2e-10 cond(A), cond about 150); the caller's b and x0
    are not written; a solve of k iterations launches k ``cg_update`` and k
    ``p_update``, and k + 1 (CG) or 2 k + 2 (PCG) ``krylov_dot``."""
    from sparse_matrix_tpu_torch.native import kernels
    from sparse_matrix_tpu_torch.ops.operator import SpmvOperator
    from sparse_matrix_tpu_torch.solvers import amg, cg
    from sparse_matrix_tpu_torch.solvers.hpcg import hpcg_problem

    if kind == "pcg_hpcg32":
        a, _ = hpcg_problem(32, 32, 32)
        b = _hpcg_rhs((32, 32, 32), "cpu", 41)
        x0 = None
        hiers = {"cpu": _hpcg_case("cpu"), str(dev): _hpcg_case(dev)}

        def solve(d, bd, x0d):
            return amg.amg_pcg_solve(a, bd, hierarchy=hiers[str(d)], tol=1e-10, maxiter=100)
        close = 1e-7
    else:
        a = poisson_2d_csr(48, dtype=np.float32)
        rng = np.random.default_rng(42)
        b = torch.from_numpy(rng.standard_normal(a.rows).astype(np.float32))
        x0 = torch.from_numpy(rng.standard_normal(a.rows).astype(np.float32))

        def solve(d, bd, x0d):
            op = SpmvOperator(a, device=d)
            if kind == "cg":
                return cg.cg_solve(op, bd, x0d, tol=1e-5, maxiter=1000)
            return cg.pcg_solve(op, bd, cg.jacobi_preconditioner(a, d), x0d, tol=1e-5,
                                maxiter=1000)
        close = 1e-4
    res_cpu = solve("cpu", b, x0)
    bd = b.to(dev)
    x0d = None if x0 is None else x0.to(dev)
    kept = [t.clone() for t in (bd, x0d) if t is not None]
    before = dict(kernels.launch_counts)
    res = solve(dev, bd, x0d)
    torch.cuda.synchronize()
    grown = {k: kernels.launch_counts[k] - before[k] for k in before}
    assert all(torch.equal(t, k) for t, k in zip((bd, x0d), kept))
    k = res.iterations
    assert abs(k - res_cpu.iterations) <= 2 and k > 0
    assert _rel(res.x.cpu().double(), res_cpu.x.double()) <= close
    dots = k + 1 if kind == "cg" else 2 * k + 2
    assert (grown["cg_update"], grown["p_update"], grown["krylov_dot"]) == (k, k, dots)
    # the residual norm is the solve's own, not a scratch slot a later solve writes
    kept_norm = res.residual_norm.clone()
    solve(dev, bd, x0d)
    assert torch.equal(res.residual_norm, kept_norm)


@pytest.mark.parametrize("kind", ["cg", "pcg"])
def test_krylov_step_launches_no_torch_kernel(dev, tmp_path, kind):
    """Inside ``_cg_step`` and ``_pcg_step`` on the card (an identity
    ``M^-1``, so that z is r) run only the DIA kernel and the three fused
    Krylov kernels: no PyTorch elementwise kernel, no cuBLAS dot (profiler
    kernel names)."""
    import json

    from sparse_matrix_tpu_torch.ops.operator import SpmvOperator
    from sparse_matrix_tpu_torch.solvers import cg

    a = poisson_2d_csr(64, dtype=np.float32)
    op = SpmvOperator(a, device=dev)
    assert op.format == "dia"
    b = torch.from_numpy(np.random.default_rng(43).standard_normal(a.rows)
                         .astype(np.float32)).to(dev)

    def step(state):
        if kind == "cg":
            return cg._cg_step(op, *state)
        return cg._pcg_step(op, lambda v: v, *state)[:4]

    state = step((torch.zeros_like(b), b.clone(), b.clone(), torch.dot(b, b)))  # the scratch
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        # one step outside the counted ranges: late in a long process the
        # profiler can miss the device record of a profile's first kernel,
        # though it records the kernel's cudaLaunchKernel
        state = step(state)
        torch.cuda.synchronize()
        for _ in range(3):
            with torch.profiler.record_function("krylov.step"):
                state = step(state)
        torch.cuda.synchronize()
    path = tmp_path / "step.json"
    prof.export_chrome_trace(str(path))
    names = _kernels_in(json.loads(path.read_text())["traceEvents"], "krylov.step")
    kinds = {next((k for k in ("dia_kernel", "krylov_dot_kernel", "cg_update_kernel",
                               "p_update_kernel") if k in name), name): c
             for name, c in names.items()}
    want = {"dia_kernel": 3, "krylov_dot_kernel": 3 if kind == "cg" else 6,
            "cg_update_kernel": 3, "p_update_kernel": 3}
    assert kinds == want, names
