"""Port parity: aligned, LanePack and ELL SpMV (sparse_matrix_tpu_torch/ops/spmv.py).

The same COO input is planned by each package's own planners (array-equal
plans: tests/test_torch_formats.py) and goes to the JAX package's
``spmv_aligned`` / ``spmv_lanepack`` / ``spmv_ell_xla`` (their CPU branches)
and to the port's CPU path (the plain versions of the CUDA kernels).
Tolerances:

* port vs JAX, both f32: ``max|dy| <= 2e-5 * max(1, max|y|)``;
* port vs float64 (``spmv_f64_bound``): aligned and ELL
  ``(nnz_row + 1) * u * (|A||x|)_i``; LanePack, and aligned plans with a
  LanePack spill, ``(2*128 + nnz_row) * u * ((|A||x|)_i + P_i)`` with P_i the
  mass of the chunks holding row i's runs (u = 2^-24).
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sparse_matrix_tpu.formats import aligned as ref_aligned  # noqa: E402
from sparse_matrix_tpu.formats import csr as ref_csr  # noqa: E402
from sparse_matrix_tpu.formats import lanepack as ref_lanepack  # noqa: E402
from sparse_matrix_tpu.ops import spmv as ref  # noqa: E402
from sparse_matrix_tpu.utils import autotune  # noqa: E402
from sparse_matrix_tpu_torch.formats.aligned import plan_aligned  # noqa: E402
from sparse_matrix_tpu_torch.formats.csr import CsrMatrix  # noqa: E402
from sparse_matrix_tpu_torch.formats.lanepack import plan_lanepack  # noqa: E402
from sparse_matrix_tpu_torch.ops import spmv  # noqa: E402
from sparse_matrix_tpu_torch.solvers.poisson import poisson_2d_csr  # noqa: E402
from sparse_matrix_tpu_torch.utils import autotune as port_autotune  # noqa: E402


def _ref(m):
    """The reference's CsrMatrix over the same arrays."""
    return ref_csr.CsrMatrix(m.rows, m.cols, m.vals, m.indices, m.offsets,
                             is_sorted=m.is_sorted)


def _rand_csr(rng, rows, cols, density, *, empty_row_blocks=()):
    mask = rng.random((rows, cols)) < density
    for rb in empty_row_blocks:
        mask[rb * 128 : (rb + 1) * 128] = False
    r, c = np.nonzero(mask)
    v = rng.standard_normal(len(r)).astype(np.float32)
    return CsrMatrix.from_coo(rows, cols, r, c, v)


def _agree(y, y_ref):
    y_ref = np.asarray(y_ref)
    assert y.shape == y_ref.shape and y.dtype == np.float32
    assert np.max(np.abs(y - y_ref), initial=0.0) <= 2e-5 * max(
        1.0, float(np.max(np.abs(y_ref), initial=0.0))
    )


def _bounded(m, x, y, lanepack=()):
    y64, bound = spmv.spmv_f64_bound(m, x, lanepack=lanepack)
    assert np.all(np.abs(y - y64) <= bound)


def _x(seed, n):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def test_aligned_no_spill_poisson():
    m = poisson_2d_csr(64, dtype=np.float32)
    plan = plan_aligned(m)
    assert plan.spill is None
    x = _x(1, m.cols)
    y = spmv.spmv_aligned(plan, torch.from_numpy(x)).numpy()
    _agree(y, ref.spmv_aligned(ref_aligned.plan_aligned(_ref(m)), jnp.asarray(x)))
    _bounded(m, x, y)


@pytest.fixture
def aligned_spills(monkeypatch, tmp_path):
    # the autotune override of tests/test_tpu_kernels.py: a huge aligned
    # slab cost makes plan_aligned spill its low-fill chunks to LanePack
    # (the reference reads it from a cache file, the port from DEFAULTS)
    p = tmp_path / "autotune.json"
    p.write_text(json.dumps({"lanepack_aligned_slab_ns": 1e6}))
    monkeypatch.setenv("SPMX_AUTOTUNE_CACHE", str(p))
    monkeypatch.setitem(port_autotune.DEFAULTS, "lanepack_aligned_slab_ns", 1e6)
    autotune.reset_cache()
    yield
    autotune.reset_cache()


def test_aligned_with_lanepack_spill(aligned_spills):
    rng = np.random.default_rng(16)
    m = _rand_csr(rng, 512, 512, 0.03)
    plan = plan_aligned(m, spill_k=32)
    assert plan.spill is not None
    x = _x(2, m.cols)
    arrs = spmv.aligned_device_arrays(plan, "cpu")
    assert "spill" in arrs
    y = spmv.spmv_aligned(plan, torch.from_numpy(x), device_arrays=arrs).numpy()
    ref_plan = ref_aligned.plan_aligned(_ref(m), spill_k=32)
    assert ref_plan.spill is not None
    _agree(y, ref.spmv_aligned(ref_plan, jnp.asarray(x)))
    _bounded(m, x, y, lanepack=(plan.spill,))


@pytest.mark.parametrize("kw", [1, 2, 4])
@pytest.mark.parametrize("pack", ["dense", "per_rb"])
def test_lanepack_kw_and_pack(kw, pack):
    rng = np.random.default_rng(42 + kw)
    m = _rand_csr(rng, 512, 700, 0.02)
    plan = plan_lanepack(m, kw=kw, pack=pack)
    assert (plan.kw, plan.pack) == (kw, pack)
    x = _x(3, m.cols)
    y = spmv.spmv_lanepack(plan, torch.from_numpy(x)).numpy()
    ref_plan = ref_lanepack.plan_lanepack(_ref(m), kw=kw, pack=pack)
    _agree(y, ref.spmv_lanepack(ref_plan, jnp.asarray(x)))
    _bounded(m, x, y, lanepack=(plan,))


def test_lanepack_empty_row_blocks():
    rng = np.random.default_rng(7)
    m = _rand_csr(rng, 640, 512, 0.03, empty_row_blocks=(0, 2, 4))
    plan = plan_lanepack(m)
    assert plan.rb_mask.tolist() == [0, 1, 0, 1, 0]
    x = _x(4, m.cols)
    y = spmv.spmv_lanepack(plan, torch.from_numpy(x)).numpy()
    assert np.all(y[:128] == 0) and np.all(y[256:384] == 0) and np.all(y[512:] == 0)
    _agree(y, ref.spmv_lanepack(ref_lanepack.plan_lanepack(_ref(m)), jnp.asarray(x)))
    _bounded(m, x, y, lanepack=(plan,))


def test_lanepack_wide_rectangular():
    rng = np.random.default_rng(8)
    m = _rand_csr(rng, 200, 5000, 0.004)
    plan = plan_lanepack(m)
    x = _x(5, m.cols)
    y = spmv.spmv_lanepack(plan, torch.from_numpy(x)).numpy()
    assert y.shape == (200,)
    _agree(y, ref.spmv_lanepack(ref_lanepack.plan_lanepack(_ref(m)), jnp.asarray(x)))
    _bounded(m, x, y, lanepack=(plan,))


def test_lanepack_refuses_silent_downcast():
    m = poisson_2d_csr(8, dtype=np.float32)
    plan = plan_lanepack(m)
    x = torch.zeros(m.cols, dtype=torch.float64)
    with pytest.raises(TypeError, match="precision loss"):
        spmv.spmv_lanepack(plan, x)
    assert spmv.spmv_lanepack(plan, x, allow_downcast=True).dtype == torch.float32


def test_ell_plain():
    rng = np.random.default_rng(9)
    m = _rand_csr(rng, 300, 260, 0.05)
    ev, ec = spmv.ell_from_csr(m)
    rv, rc = ref.ell_from_csr(_ref(m))
    assert np.array_equal(ev, rv) and np.array_equal(ec, rc)
    x = _x(6, m.cols)
    y = spmv.spmv_ell(torch.from_numpy(ev), torch.from_numpy(ec), torch.from_numpy(x)).numpy()
    _agree(y, ref.spmv_ell_xla(jnp.asarray(ev), jnp.asarray(ec), jnp.asarray(x)))
    _bounded(m, x, y)


def test_ell_with_coo_spill():
    rng = np.random.default_rng(10)
    m = _rand_csr(rng, 300, 300, 0.01)
    # one heavy row: it keeps max_width entries in ELL, the rest spill
    r = np.r_[m.row_ids(), np.full(200, 7)]
    c = np.r_[m.indices.astype(np.int64), rng.choice(300, 200, replace=False)]
    v = np.r_[m.vals, rng.standard_normal(200).astype(np.float32)]
    m = CsrMatrix.from_coo(300, 300, r, c, v)
    parts = spmv.ell_spill_from_csr(m)
    ref_parts = ref.ell_spill_from_csr(_ref(m))
    for a, b in zip(parts, ref_parts):
        assert np.array_equal(a, b)
    assert len(parts[2]) > 0
    x = _x(11, m.cols)
    y = spmv.spmv_ell_spill(*(torch.from_numpy(a) for a in parts), torch.from_numpy(x)).numpy()
    _agree(y, ref.spmv_ell_spill_xla(*(jnp.asarray(a) for a in parts), jnp.asarray(x)))
    _bounded(m, x, y)


def test_spmv_oracle_matches_f64_product():
    m = poisson_2d_csr(6, dtype=np.float32)
    x = _x(12, m.cols)
    y64, _ = spmv.spmv_f64_bound(m, x)
    assert np.allclose(spmv.spmv_oracle(m, x), y64, rtol=1e-6, atol=1e-6)
    assert np.array_equal(spmv.spmv_oracle(m, x), ref.spmv_oracle(_ref(m), x))
