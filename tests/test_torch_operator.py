"""Port parity: SpmvOperator dispatch, applies and plan files
(sparse_matrix_tpu_torch/ops/operator.py).

* The port's automatic and forced format choice equals the reference's
  ``SpmvOperator(m).format`` (stripe: tests/test_torch_stripe.py).
* Applies agree with the reference operator: ``max|dy| <= 2e-5 *
  max(1, max|y|)`` (both f32).
* A plan file written by one package and read by the other computes the
  same y within that bound.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sparse_matrix_tpu.bench import corpus as ref_corpus  # noqa: E402
from sparse_matrix_tpu.formats import csr as ref_csr  # noqa: E402
from sparse_matrix_tpu.ops import operator as ref_op  # noqa: E402
from sparse_matrix_tpu_torch.bench import corpus  # noqa: E402
from sparse_matrix_tpu_torch.formats.csr import CsrMatrix  # noqa: E402
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


def _with_random_entries(a, extra, seed):
    rng = np.random.default_rng(seed)
    r = np.r_[a.row_ids(), rng.integers(0, a.rows, extra)]
    c = np.r_[a.indices.astype(np.int64), rng.integers(0, a.cols, extra)]
    v = np.r_[a.vals, rng.standard_normal(extra).astype(np.float32)]
    return CsrMatrix.from_coo(a.rows, a.cols, r, c, v)


def _hyper_sparse():
    rng = np.random.default_rng(2)
    n, k = 1_500_000, 500_001
    return CsrMatrix.from_coo(
        n, n, rng.integers(0, n, k), rng.integers(0, n, k),
        rng.standard_normal(k).astype(np.float32),
    )


MATRICES = {
    "poisson64": lambda: poisson_2d_csr(64, dtype=np.float32),
    "femlike48": lambda: corpus.fem_like(np.random.default_rng(0), 48, 2),
    "hybrid32": lambda: _with_random_entries(poisson_2d_csr(32, dtype=np.float32), 300, 1),
    "hyper_sparse": _hyper_sparse,
}


def _agree(y, y_ref):
    y, y_ref = np.asarray(y), np.asarray(y_ref)
    assert y.shape == y_ref.shape
    assert np.max(np.abs(y - y_ref)) <= 2e-5 * max(1.0, float(np.max(np.abs(y_ref))))


def _x(m, seed=0):
    return np.random.default_rng(seed).standard_normal(m.cols).astype(np.float32)


@pytest.mark.parametrize("name,expected", [
    ("poisson64", "dia"),
    ("femlike48", "dia"),
    ("hybrid32", "hybrid"),
    ("hyper_sparse", "ell"),
])
def test_auto_format_matches_reference(name, expected):
    m = MATRICES[name]()
    ref = ref_op.SpmvOperator(_ref(m))
    op = SpmvOperator(m, device="cpu")
    assert ref.format == op.format == expected
    x = _x(m)
    _agree(op(torch.from_numpy(x)).numpy(), ref(jnp.asarray(x)))
    assert op.bytes_per_apply() == ref.bytes_per_apply()


@pytest.mark.parametrize("force,name", [
    ("dia", "poisson64"),
    ("aligned", "poisson64"),
    ("bell", "poisson64"),
    ("lanepack", "poisson64"),
    ("ell", "poisson64"),
    ("hybrid", "hybrid32"),
])
def test_forced_format_matches_reference(force, name):
    m = MATRICES[name]()
    ref = ref_op.SpmvOperator(_ref(m), force=force)
    op = SpmvOperator(m, device="cpu", force=force)
    assert op.format == ref.format
    x = _x(m, 1)
    _agree(op(torch.from_numpy(x)).numpy(), ref(jnp.asarray(x)))


def test_bf16_values_only_on_streaming_formats():
    m = poisson_2d_csr(16, dtype=np.float32)
    assert SpmvOperator(m, device="cpu", values_dtype=torch.bfloat16).format == "dia"
    assert SpmvOperator(m, device="cpu", force="bell", values_dtype=torch.bfloat16).format == "bell"
    with pytest.raises(ValueError, match="values_dtype"):
        SpmvOperator(m, device="cpu", force="lanepack", values_dtype=torch.bfloat16)


@pytest.mark.parametrize("force,name", [
    (None, "poisson64"),
    ("aligned", "poisson64"),
    ("bell", "femlike48"),
    ("lanepack", "femlike48"),
    ("ell", "poisson64"),
    (None, "hybrid32"),
])
def test_plan_files_cross_load(tmp_path, force, name):
    m = MATRICES[name]()
    x = _x(m, 2)
    ref = ref_op.SpmvOperator(_ref(m), force=force)
    y_ref = np.asarray(ref(jnp.asarray(x)))
    # the reference's file, read by the port
    ref_op.save_operator_plan(ref, str(tmp_path / "ref.npz"))
    op = load_operator_plan(str(tmp_path / "ref.npz"), "cpu")
    assert op.format == ref.format
    _agree(op(torch.from_numpy(x)).numpy(), y_ref)
    # the port's file, read by the reference and by the port
    save_operator_plan(op, str(tmp_path / "port.npz"))
    back = ref_op.load_operator_plan(str(tmp_path / "port.npz"))
    assert back.format == ref.format
    _agree(np.asarray(back(jnp.asarray(x))), y_ref)
    _agree(load_operator_plan(str(tmp_path / "port.npz"), "cpu")(torch.from_numpy(x)).numpy(), y_ref)


def test_load_refuses_split_plans(tmp_path):
    np.savez(tmp_path / "split.npz", format="rowsplit", rows=1, cols=1, nnz=0,
             split_kind="row", split_bounds=np.array([0, 1]))
    with pytest.raises(NotImplementedError, match="split"):
        load_operator_plan(str(tmp_path / "split.npz"), "cpu")


def test_operator_refuses_x_on_another_device():
    op = SpmvOperator(poisson_2d_csr(8, dtype=np.float32), device="cpu")
    with pytest.raises(ValueError, match="x is on meta"):
        op(torch.zeros(64, device="meta"))


@pytest.mark.parametrize("gen,args", [
    ("fem_like", (24, 2)),
    ("random_local", (2048, 8, 300)),
    ("power_law_rows", (2048, 16)),
])
def test_bench_generators_match_reference(gen, args):
    ref_gen = getattr(ref_corpus, "_" + gen)
    a = getattr(corpus, gen)(np.random.default_rng(5), *args)
    b = ref_gen(np.random.default_rng(5), *args)
    assert (a.rows, a.cols) == (b.rows, b.cols)
    for f in ("offsets", "indices", "vals"):
        assert np.array_equal(getattr(a, f), getattr(b, f))
