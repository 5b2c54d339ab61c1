"""DIA SpMV and SpMM: ``y[i] = sum_b data[b, i] * x[i + off_b]``.

Counterpart of ``sparse_matrix_tpu/ops/spmv_dia.py``. On CUDA every SpMV
goes through the streaming DIA kernel (``csrc/spmv_dia.cu``) and every
multi-RHS apply of 2 to 16 columns through the DIA SpMM kernel
(``csrc/spmm_dia.cu``), which reads the band planes once for all columns;
the reference's 48 MB gate between its XLA forms and its Pallas kernels,
and the kernels' square-only, rows >= 65536 conditions, were VMEM walls of
the TPU and have no counterpart here. On the CPU the plain versions
:func:`_spmv_dia_torch` and :func:`_spmm_dia_torch` run.

The multi-RHS layout is the reference's packed one: K columns as
``(lo + ceil(n/128) + hi, K, 128)`` with ``x[j, k]`` at ``[lo + j//128, k,
j % 128]`` and ``lo``/``hi`` zero guard rows (:func:`dia_pack_rhs`). Its
body is not rounded up to the reference's 256-row steps.
"""

from __future__ import annotations

import torch

from ..device import on_cuda
from ..formats.dia import DiaMatrix

__all__ = [
    "dia_device_arrays",
    "spmv_dia",
    "spmm_dia_stream",
    "dia_pack_rhs",
    "dia_unpack_rhs",
    "dia_matvec_multi",
]

LANES = 128
MAX_K = 16  # columns per SpMM kernel call


def dia_device_arrays(m: DiaMatrix, device, values_dtype=None) -> dict:
    """Band planes ``data`` ``(nb, rows)`` and ``offsets`` (int32) on
    ``device``. ``values_dtype=torch.bfloat16`` stores the planes
    half-width; applies widen them and sum in f32."""
    data = torch.from_numpy(m.data).to(device)
    if values_dtype is not None:
        data = data.to(values_dtype)
    offsets = torch.tensor(m.offsets, dtype=torch.int32, device=device)
    return dict(data=data.contiguous(), offsets=offsets)


def _spmv_dia_torch(data, x, *, offsets: tuple, rows: int, cols: int):
    """Plain PyTorch DIA apply: the counterpart of ``_spmv_dia_jit`` (one
    shifted slice of a zero-padded x per band, summed in plan order)."""
    lo = -min(0, min(offsets))
    hi = max(0, max(offsets)) + max(rows, cols)
    xpad = torch.zeros(lo + hi, dtype=x.dtype, device=x.device)
    xpad[lo : lo + x.shape[0]] = x
    if data.dtype != x.dtype:  # bf16 value planes: widen, f32 accumulate
        data = data.to(x.dtype)
    y = torch.zeros(rows, dtype=x.dtype, device=x.device)
    for b, off in enumerate(offsets):
        y = y + data[b] * xpad[lo + off : lo + off + rows]
    return y


def spmv_dia(m: DiaMatrix, x: torch.Tensor, *, device_arrays=None):
    """``y = A @ x`` for a DIA operator: the CUDA kernel for a CUDA ``x``,
    the plain version for a CPU ``x``."""
    arrs = device_arrays if device_arrays is not None else dia_device_arrays(m, x.device)
    if on_cuda(x):
        from ..native.kernels import launch_dia

        y = torch.empty(m.rows, dtype=x.dtype, device=x.device)
        launch_dia(arrs["data"], arrs["offsets"], x.contiguous(), y,
                   rows=m.rows, cols=m.cols)
        return y
    return _spmv_dia_torch(arrs["data"], x, offsets=m.offsets, rows=m.rows, cols=m.cols)


# ---------------------------------------------------------------------------
# multi-RHS: K columns in one pass over the bands
# ---------------------------------------------------------------------------


def _spmm_dia_torch(data, x, *, offsets: tuple, rows: int):
    """Plain PyTorch DIA SpMM of ``x`` (cols, K): the counterpart of the
    reference's ``_spmm_dia_jit`` (one shifted slice of a zero-padded x
    per band, summed in plan order)."""
    lo = -min(0, min(offsets))
    hi = max(0, max(offsets)) + max(rows, x.shape[0])
    xpad = torch.zeros((lo + hi, x.shape[1]), dtype=x.dtype, device=x.device)
    xpad[lo : lo + x.shape[0]] = x
    if data.dtype != x.dtype:  # bf16 value planes: widen, f32 accumulate
        data = data.to(x.dtype)
    y = torch.zeros((rows, x.shape[1]), dtype=x.dtype, device=x.device)
    for b, off in enumerate(offsets):
        y = y + data[b][:, None] * xpad[lo + off : lo + off + rows]
    return y


def _dia_stream_geom(offsets: tuple):
    """Guard rows ``(lo, hi)`` of the packed layout (the reference's,
    without its rounding to 8-row tiles)."""
    return -min(0, min(offsets)) // LANES + 1, max(0, max(offsets)) // LANES + 2


def _pack(x, n: int, lo: int, hi: int):
    """(n, K) -> (lo + ceil(n/128) + hi, K, 128), zeros elsewhere."""
    k = x.shape[1]
    n128 = -(-n // LANES)
    x3 = torch.zeros((lo + n128 + hi, k, LANES), dtype=x.dtype, device=x.device)
    body = torch.zeros((n128 * LANES, k), dtype=x.dtype, device=x.device)
    body[: x.shape[0]] = x
    x3[lo : lo + n128] = body.reshape(n128, LANES, k).transpose(1, 2)
    return x3


def _unpack(x3, n: int, lo: int):
    """(lo + ceil(n/128) + hi, K, 128) -> (n, K)."""
    body = x3[lo : lo + -(-n // LANES)]
    return body.transpose(1, 2).reshape(-1, x3.shape[1])[:n]


def _spmm_dia_packed(m: DiaMatrix, data, offsets_t, x3, *, lo: int, hi: int):
    """Packed ``x3`` (cols layout) -> packed ``y3`` (rows layout, guard
    rows zero): the SpMM kernel for a CUDA ``x3``, the plain version for a
    CPU one."""
    r128 = -(-m.rows // LANES)
    if on_cuda(x3):
        from ..native.kernels import launch_dia_spmm

        y3 = torch.empty((lo + r128 + hi, x3.shape[1], LANES), dtype=x3.dtype,
                         device=x3.device)
        launch_dia_spmm(data, offsets_t, x3.contiguous(), y3, rows=m.rows, cols=m.cols,
                        x_lo=lo, y_lo=lo)
        return y3
    x = _unpack(x3, m.cols, lo)
    y = _spmm_dia_torch(data, x, offsets=m.offsets, rows=m.rows)
    return _pack(y, m.rows, lo, hi)


def _check_k(k: int, name: str):
    if not 2 <= k <= MAX_K:
        raise ValueError(f"{name}: K must be in [2, {MAX_K}], got {k}")


def spmm_dia_stream(m: DiaMatrix, x, *, device_arrays=None):
    """``Y = A @ X`` for ``X`` of shape (cols, K), 2 <= K <= 16, through
    the DIA SpMM kernel (CUDA ``X``: band planes read once for all K) or
    its plain version (CPU ``X``); pays one pack and one unpack."""
    _check_k(int(x.shape[1]), "spmm_dia_stream")
    arrs = device_arrays if device_arrays is not None else dia_device_arrays(m, x.device)
    lo, hi = _dia_stream_geom(m.offsets)
    x3 = _pack(x, m.cols, lo, hi)
    y3 = _spmm_dia_packed(m, arrs["data"], arrs["offsets"], x3, lo=lo, hi=hi)
    return _unpack(y3, m.rows, lo)


def dia_pack_rhs(m: DiaMatrix, x):
    """(rows, K) -> the packed layout ``(lo + r128 + hi, K, 128)`` of a
    square operator, zero guard rows; see :func:`dia_matvec_multi`."""
    lo, hi = _dia_stream_geom(m.offsets)
    return _pack(x, m.rows, lo, hi)


def dia_unpack_rhs(m: DiaMatrix, x3):
    """Packed ``(lo + r128 + hi, K, 128)`` -> (rows, K)."""
    lo, _hi = _dia_stream_geom(m.offsets)
    return _unpack(x3, m.rows, lo)


def dia_matvec_multi(m: DiaMatrix, k: int, device, *, device_arrays=None, values_dtype=None):
    """Packed-layout multi-RHS matvec of a square DIA operator: maps
    ``(lo + r128 + hi, K, 128)`` to the same shape with zero guard rows,
    for ``cg_solve_multi(..., rhs_axis=1)``. Iterates stay packed, so the
    (rows, K) <-> packed relayouts are paid once per solve. Every CUDA
    apply is one DIA SpMM kernel launch."""
    if m.rows != m.cols:
        raise ValueError("packed multi-RHS matvec needs a square operator")
    _check_k(k, "dia_matvec_multi")
    arrs = (device_arrays if device_arrays is not None
            else dia_device_arrays(m, device, values_dtype=values_dtype))
    lo, hi = _dia_stream_geom(m.offsets)

    def mv(x3):
        return _spmm_dia_packed(m, arrs["data"], arrs["offsets"], x3, lo=lo, hi=hi)

    return mv
