"""Port parity: BELL SpMV (sparse_matrix_tpu_torch/ops/spmv_bell.py).

The reference's ``plan_bell`` plan goes to the JAX package's ``spmv_bell``
(its CPU interpret branch) and the port's ``plan_bell`` plan of the same
matrix to the port's CPU path (the plain version of the CUDA kernel, plus
the LanePack plain version on the spill). Tolerances:

* port vs JAX, both f32: ``max|dy| <= 2e-5 * max(1, max|y|)``;
* port vs float64: ``(nnz_row + 1) * u * (|A||x|)_i`` (u = 2^-24), the
  LanePack form ``(2*128 + nnz_row) * u * ((|A||x|)_i + P_i)`` when the plan
  spills, and the oracle from the bf16-rounded values for bf16 planes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sparse_matrix_tpu.formats import bell as ref_bell  # noqa: E402
from sparse_matrix_tpu.formats import csr as ref_csr  # noqa: E402
from sparse_matrix_tpu.ops.spmv_bell import bell_device_arrays as ref_arrays  # noqa: E402
from sparse_matrix_tpu.ops.spmv_bell import spmv_bell as ref_spmv_bell  # noqa: E402
from sparse_matrix_tpu_torch.bench.corpus import fem_like  # noqa: E402
from sparse_matrix_tpu_torch.formats.bell import plan_bell  # noqa: E402
from sparse_matrix_tpu_torch.formats.csr import CsrMatrix  # noqa: E402
from sparse_matrix_tpu_torch.ops.spmv import spmv_f64_bound  # noqa: E402
from sparse_matrix_tpu_torch.ops.spmv_bell import (  # noqa: E402
    bell_device_arrays,
    spmv_bell,
)
from sparse_matrix_tpu_torch.solvers.poisson import poisson_2d_csr  # noqa: E402


def _check(m, plan, x, values_dtype=None):
    arrs = bell_device_arrays(plan, "cpu", values_dtype=values_dtype)
    y = spmv_bell(plan, torch.from_numpy(x), device_arrays=arrs).numpy()
    ref_plan = ref_bell.plan_bell(
        ref_csr.CsrMatrix(m.rows, m.cols, m.vals, m.indices, m.offsets, is_sorted=m.is_sorted),
        span=plan.span)
    ref_kw, vals = {}, None
    if values_dtype is not None:
        ref_kw["device_arrays"] = ref_arrays(ref_plan, values_dtype=jnp.bfloat16)
        vals = torch.from_numpy(m.vals.astype(np.float32)).to(values_dtype).double().numpy()
    y_ref = np.asarray(ref_spmv_bell(ref_plan, jnp.asarray(x), **ref_kw))
    assert y.shape == (m.rows,) and y.dtype == np.float32
    assert np.max(np.abs(y - y_ref)) <= 2e-5 * max(1.0, float(np.max(np.abs(y_ref))))
    lanepack = () if plan.spill is None else (plan.spill,)
    y64, bound = spmv_f64_bound(m, x, vals=vals, lanepack=lanepack)
    assert np.all(np.abs(y - y64) <= bound)


def _x(seed, n):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def test_bell_span128_poisson():
    m = poisson_2d_csr(64, dtype=np.float32)
    plan = plan_bell(m, span=128)
    assert plan.span == 128 and plan.lane.dtype == np.int8 and plan.spill is None
    _check(m, plan, _x(1, m.cols))


def test_bell_span256_femlike():
    m = fem_like(np.random.default_rng(0), 48, 2)
    plan = plan_bell(m, span=256)
    assert plan.span == 256 and plan.lane.dtype == np.int16
    _check(m, plan, _x(2, m.cols))


def test_bell_with_lanepack_spill():
    a = poisson_2d_csr(96, dtype=np.float32)
    rng = np.random.default_rng(3)
    # a few far-off entries make sparse layers that the planner spills (at
    # this height a whole kept layer plane costs more than one spill slab)
    r = np.r_[a.row_ids(), rng.integers(0, a.rows, 40)]
    c = np.r_[a.indices.astype(np.int64), rng.integers(0, a.cols, 40)]
    v = np.r_[a.vals, rng.standard_normal(40).astype(np.float32)]
    m = CsrMatrix.from_coo(a.rows, a.cols, r, c, v)
    plan = plan_bell(m)
    assert plan.spill is not None and plan.num_layers > 0
    arrs = bell_device_arrays(plan, "cpu")
    assert "spill" in arrs
    _check(m, plan, _x(4, m.cols))


def test_bell_bf16_planes():
    m = fem_like(np.random.default_rng(5), 40, 1)
    plan = plan_bell(m)
    arrs = bell_device_arrays(plan, "cpu", values_dtype=torch.bfloat16)
    assert arrs["vals"].dtype == torch.bfloat16 and arrs["ds"].dtype == torch.int32
    _check(m, plan, _x(6, m.cols), values_dtype=torch.bfloat16)


def test_bell_rectangular():
    rng = np.random.default_rng(7)
    rows, cols = 300, 700
    r = np.repeat(np.arange(rows), 4)
    c = np.clip(2 * r + rng.integers(-20, 21, len(r)), 0, cols - 1)
    m = CsrMatrix.from_coo(rows, cols, r, c, rng.standard_normal(len(r)).astype(np.float32))
    plan = plan_bell(m)
    _check(m, plan, _x(8, cols))
