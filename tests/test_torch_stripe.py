"""Port parity: the stripe SpMV (sparse_matrix_tpu_torch/ops/spmv.py,
``spmv_stripe``) and stripe operators.

The port's plan goes to the port's CPU path (the plain version of the
CUDA kernel, on the plan and its spill) and the reference's plan of the
same matrix to the JAX package's ``spmv_stripe`` (its CPU branch,
``_stripe_reference``). Tolerances:

* port vs JAX, both f32: ``max|dy| <= 2e-5 * max(1, max|y|)``;
* port vs float64 (``spmv_f64_bound(..., stripe=(plan,))``): rows with a
  run in a scan-mode chunk ``(2*128 + nnz_row) * u * ((|A||x|)_i + P_i)``,
  P_i the mass of the chunks holding those runs; select-mode rows
  ``(nnz_row + 1) * u * (|A||x|)_i`` (u = 2^-24).

A stripe plan file written by either package loads into the other and
applies within the same bounds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sparse_matrix_tpu.formats import csr as ref_csr  # noqa: E402
from sparse_matrix_tpu.formats import stripe as ref_stripe  # noqa: E402
from sparse_matrix_tpu.ops import operator as ref_op  # noqa: E402
from sparse_matrix_tpu.ops import spmv as ref_spmv  # noqa: E402
from sparse_matrix_tpu_torch.bench import corpus  # noqa: E402
from sparse_matrix_tpu_torch.formats.csr import CsrMatrix  # noqa: E402
from sparse_matrix_tpu_torch.formats.stripe import plan_stripe  # noqa: E402
from sparse_matrix_tpu_torch.ops import spmv  # noqa: E402
from sparse_matrix_tpu_torch.ops.operator import (  # noqa: E402
    SpmvOperator,
    load_operator_plan,
    save_operator_plan,
)
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


def _bounded(m, x, y, plan):
    y64, bound = spmv.spmv_f64_bound(m, x, stripe=(plan,))
    assert np.all(np.abs(y - y64) <= bound)


def _x(seed, n):
    return np.random.default_rng(seed).standard_normal(n).astype(np.float32)


def _skew(seed, n=3000):
    return corpus.power_law_rows(np.random.default_rng(seed), n, 12)


@pytest.mark.parametrize("mode,levels,kw", [
    ("scan", 1, 1), ("scan", 2, 2), ("scan", 4, 16), ("scan", 8, 4),
    ("select", 1, 1), ("select", 2, 2), ("select", 4, 16), ("select", 8, 8),
])
def test_stripe_matches_reference(mode, levels, kw):
    m = _skew(levels + kw)
    plan = plan_stripe(m, mode=mode, levels=levels, kw=kw)
    if mode == "select":
        assert plan.spill is not None  # the row skew collides in every config
    x = _x(1, m.cols)
    y = spmv.spmv_stripe(plan, torch.from_numpy(x)).numpy()
    ref_plan = ref_stripe.plan_stripe(_ref(m), mode=mode, levels=levels, kw=kw)
    _agree(y, ref_spmv.spmv_stripe(ref_plan, jnp.asarray(x)))
    _bounded(m, x, y, plan)


def test_stripe_wide_rectangular_and_partial_stripe():
    rng = np.random.default_rng(2)
    rows, cols = 700, 6000  # 700 rows: the last stripe of L=4 is partial
    r = rng.integers(0, rows, 9000)
    c = rng.integers(0, cols, 9000)
    m = CsrMatrix.from_coo(rows, cols, r, c, rng.standard_normal(9000).astype(np.float32))
    for mode in ("scan", "select"):
        plan = plan_stripe(m, mode=mode, levels=4, kw=2)
        assert plan.r128_padded == 8
        x = _x(3, cols)
        y = spmv.spmv_stripe(plan, torch.from_numpy(x)).numpy()
        assert y.shape == (rows,)
        ref_plan = ref_stripe.plan_stripe(_ref(m), mode=mode, levels=4, kw=2)
        _agree(y, ref_spmv.spmv_stripe(ref_plan, jnp.asarray(x)))
        _bounded(m, x, y, plan)


def test_stripe_empty_row_blocks_are_zero():
    rng = np.random.default_rng(4)
    r = rng.integers(0, 128, 3000) + 256  # rows 256..383 only
    c = rng.integers(0, 1000, 3000)
    m = CsrMatrix.from_coo(640, 1000, r, c, rng.standard_normal(3000).astype(np.float32))
    plan = plan_stripe(m, mode="scan", levels=2, kw=1)
    y = spmv.spmv_stripe(plan, torch.from_numpy(_x(5, 1000))).numpy()
    assert np.all(y[:256] == 0) and np.all(y[384:] == 0)


def test_stripe_empty_plan():
    m = CsrMatrix.from_coo(300, 300, np.zeros(0, np.int64), np.zeros(0, np.int64),
                           np.zeros(0, np.float32))
    plan = plan_stripe(m, mode="select", levels=2, kw=1)
    assert plan.num_slabs == 0
    y = spmv.spmv_stripe(plan, torch.ones(300))
    assert y.shape == (300,) and int(torch.count_nonzero(y)) == 0


def test_stripe_device_arrays_layout():
    m = _skew(6)
    plan = plan_stripe(m, mode="scan", levels=4, kw=2)
    arrs = spmv.stripe_device_arrays(plan, "cpu")
    chunks = plan.num_slabs * 8
    assert arrs["vals"].shape == (chunks, 128) and arrs["lane"].dtype == torch.int16
    assert arrs["ends"].shape == (plan.num_slabs, 4, 8, 128)
    assert arrs["starts"].dtype == torch.int8 and arrs["stripe_rb"].dtype == torch.int32
    assert arrs["col_off"].shape == (chunks,)


def test_stripe_f64_bound_select_rows_keep_plain_bound():
    m = _skew(7)
    plan = plan_stripe(m, mode="select", levels=2, kw=1)
    x = _x(8, m.cols)
    _, plain = spmv.spmv_f64_bound(m, x)
    _, bound = spmv.spmv_f64_bound(m, x, stripe=(plan,))
    # rows with no run in the scan-mode spill keep the plain bound exactly
    _, ran = spmv._stripe_run_mass(plan.spill, x.astype(np.float64))
    assert ran.any() and not ran.all()
    assert np.array_equal(bound[~ran], plain[~ran]) and np.all(bound[ran] >= plain[ran])


@pytest.mark.parametrize("force", [None, "stripe"])
def test_stripe_operator_matches_reference(force):
    m = corpus.power_law_rows(np.random.default_rng(0), 1 << 13, 16)
    ref = ref_op.SpmvOperator(_ref(m), force=force)
    op = SpmvOperator(m, device="cpu", force=force)
    assert op.format == ref.format == "stripe"
    st, ref_st = op.part("stripe").plan, ref._stripe
    assert (st.mode, st.levels, st.kw) == (ref_st.mode, ref_st.levels, ref_st.kw)
    assert op.bytes_per_apply() == ref.bytes_per_apply()
    x = _x(9, m.cols)
    y = op(torch.from_numpy(x)).numpy()
    _agree(y, ref(jnp.asarray(x)))
    _bounded(m, x, y, st)


def test_stripe_refuses_bf16_values():
    m = corpus.power_law_rows(np.random.default_rng(0), 1 << 12, 16)
    with pytest.raises(ValueError, match="values_dtype"):
        SpmvOperator(m, device="cpu", force="stripe", values_dtype=torch.bfloat16)


@pytest.mark.parametrize("mode", ["scan", "select"])
def test_stripe_plan_files_cross_load(tmp_path, mode):
    m = corpus.power_law_rows(np.random.default_rng(1), 1 << 12, 16)
    x = _x(10, m.cols)
    ref = ref_op.SpmvOperator(_ref(m), force="stripe")
    # pin the mode: the reference's operator accepts a plan of either mode
    ref._set_stripe(_ref(m), np.float32, cfg=(mode, 2, 2))
    assert ref._stripe.mode == mode and (ref._stripe.spill is not None) == (mode == "select")
    y_ref = np.asarray(ref(jnp.asarray(x)))
    # the reference's file, read by the port
    ref_op.save_operator_plan(ref, str(tmp_path / "ref.npz"))
    op = load_operator_plan(str(tmp_path / "ref.npz"), "cpu")
    assert op.format == "stripe" and op.part("stripe").plan.mode == mode
    y = op(torch.from_numpy(x)).numpy()
    _agree(y, y_ref)
    _bounded(m, x, y, op.part("stripe").plan)
    # the port's file, read by the reference
    save_operator_plan(op, str(tmp_path / "port.npz"))
    back = ref_op.load_operator_plan(str(tmp_path / "port.npz"))
    assert back.format == "stripe"
    _agree(np.asarray(back(jnp.asarray(x))), y_ref)


def test_stripe_not_chosen_for_banded():
    m = poisson_2d_csr(32, dtype=np.float32)
    assert SpmvOperator(m, device="cpu").format == "dia"
    op = SpmvOperator(m, device="cpu", force="stripe")
    x = _x(11, m.cols)
    y = op(torch.from_numpy(x)).numpy()
    _bounded(m, x, y, op.part("stripe").plan)
