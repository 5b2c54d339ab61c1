"""DIA SpMV: ``y[i] = sum_b data[b, i] * x[i + off_b]``.

Counterpart of ``sparse_matrix_tpu/ops/spmv_dia.py``. On CUDA every apply
goes through the streaming DIA kernel (``csrc/spmv_dia.cu``); the
reference's 48 MB gate between its XLA form and its Pallas kernel, and the
kernel's square-only, rows >= 65536 condition, were VMEM walls of the TPU
and have no counterpart here. On the CPU the plain version
:func:`_spmv_dia_torch` runs.
"""

from __future__ import annotations

import torch

from sparse_matrix_tpu.formats.dia import DiaMatrix

from ..device import on_cuda

__all__ = ["dia_device_arrays", "spmv_dia"]


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
