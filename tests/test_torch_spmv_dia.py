"""Port parity: DIA SpMV (sparse_matrix_tpu_torch/ops/spmv_dia.py).

The port's CPU path (the plain version of the CUDA kernel) on the port's
DIA plan against the JAX package's ``_spmv_dia_jit`` on the reference's
plan of the same matrix, and against a float64 CSR product. Tolerances:

* port vs JAX, both f32: ``max|dy| <= 2e-5 * max(1, max|y|)`` (the bound of
  tests/test_tpu_kernels.py);
* port vs float64: ``|y - y64|_i <= (nnz_row + 1) * 2^-24 * (|A||x|)_i``,
  with the oracle built from the bf16-rounded values for bf16 planes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sparse_matrix_tpu.formats import csr as ref_csr  # noqa: E402
from sparse_matrix_tpu.formats import dia as ref_dia  # noqa: E402
from sparse_matrix_tpu.ops.spmv_dia import _spmv_dia_jit  # noqa: E402
from sparse_matrix_tpu_torch.formats.csr import CsrMatrix  # noqa: E402
from sparse_matrix_tpu_torch.formats.dia import try_dia_from_csr  # noqa: E402
from sparse_matrix_tpu_torch.ops.spmv import spmv_f64_bound  # noqa: E402
from sparse_matrix_tpu_torch.ops.spmv_dia import (  # noqa: E402
    _spmv_dia_torch,
    dia_device_arrays,
    spmv_dia,
)
from sparse_matrix_tpu_torch.solvers.poisson import poisson_2d_csr  # noqa: E402


def _banded_rect(rows, cols, offsets, seed):
    rng = np.random.default_rng(seed)
    r, c = [], []
    for off in offsets:
        i = np.arange(rows)
        keep = (i + off >= 0) & (i + off < cols)
        r.append(i[keep])
        c.append(i[keep] + off)
    r, c = np.concatenate(r), np.concatenate(c)
    v = rng.standard_normal(len(r)).astype(np.float32)
    return CsrMatrix.from_coo(rows, cols, r, c, v)


def _check(m, dia, x, values_dtype=None):
    arrs = dia_device_arrays(dia, "cpu", values_dtype=values_dtype)
    y = spmv_dia(dia, torch.from_numpy(x), device_arrays=arrs).numpy()
    ref_plan = ref_dia.try_dia_from_csr(ref_csr.CsrMatrix(
        m.rows, m.cols, m.vals, m.indices, m.offsets, is_sorted=m.is_sorted))
    data = jnp.asarray(ref_plan.data)
    vals = None
    if values_dtype is not None:
        data = data.astype(jnp.bfloat16)
        vals = torch.from_numpy(m.vals.astype(np.float32)).to(values_dtype).double().numpy()
    y_ref = np.asarray(
        _spmv_dia_jit(data, jnp.asarray(x), offsets=ref_plan.offsets, rows=ref_plan.rows,
                      cols=ref_plan.cols)
    )
    assert y.shape == (m.rows,) and y.dtype == np.float32
    assert np.max(np.abs(y - y_ref)) <= 2e-5 * max(1.0, float(np.max(np.abs(y_ref))))
    y64, bound = spmv_f64_bound(m, x, vals=vals)
    assert np.all(np.abs(y - y64) <= bound)
    return y


def test_dia_poisson():
    m = poisson_2d_csr(48, dtype=np.float32)
    dia = try_dia_from_csr(m)
    assert dia is not None and dia.nbands == 5
    x = np.random.default_rng(1).standard_normal(m.cols).astype(np.float32)
    _check(m, dia, x)


@pytest.mark.parametrize("rows,cols,offsets", [
    (300, 420, (-3, 0, 5, 40, 200)),
    (500, 260, (-250, -7, 0, 1, 9)),
])
def test_dia_rectangular(rows, cols, offsets):
    m = _banded_rect(rows, cols, offsets, seed=rows)
    dia = try_dia_from_csr(m)
    assert dia is not None and (dia.rows, dia.cols) == (rows, cols)
    x = np.random.default_rng(2).standard_normal(cols).astype(np.float32)
    _check(m, dia, x)


def test_dia_bf16_planes():
    m = _banded_rect(1024, 1024, (-64, -1, 0, 1, 64), seed=3)
    dia = try_dia_from_csr(m)
    x = np.random.default_rng(4).standard_normal(m.cols).astype(np.float32)
    arrs = dia_device_arrays(dia, "cpu", values_dtype=torch.bfloat16)
    assert arrs["data"].dtype == torch.bfloat16 and arrs["offsets"].dtype == torch.int32
    _check(m, dia, x, values_dtype=torch.bfloat16)


def test_dia_plain_version_is_the_cpu_path():
    m = poisson_2d_csr(16, dtype=np.float32)
    dia = try_dia_from_csr(m)
    arrs = dia_device_arrays(dia, "cpu")
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(m.cols).astype(np.float32))
    y = spmv_dia(dia, x, device_arrays=arrs)
    y_plain = _spmv_dia_torch(arrs["data"], x, offsets=dia.offsets, rows=dia.rows, cols=dia.cols)
    assert torch.equal(y, y_plain)
