"""BELL (blocked-ELL layers) SpMV.

Counterpart of ``sparse_matrix_tpu/ops/spmv_bell.py``: a ``BellPlan``
(``formats/bell.py``) goes to the device as its
``(L, r128, 128)`` value and lane planes; a CUDA ``x`` launches the BELL
kernel (``csrc/spmv_bell.cu``) and then the LanePack kernel on the spill
sub-plan, a CPU ``x`` takes the plain version :func:`_bell_torch`. The
``pick_br`` row padding of the reference is a TPU block size and is not
carried over.
"""

from __future__ import annotations

import torch

from ..device import on_cuda
from ..formats.bell import BellPlan
from ..formats.lanepack import LANES
from .spmv import _cast_x, _lanepack_cuda, _lanepack_torch, _t, lanepack_device_arrays

__all__ = ["bell_device_arrays", "spmv_bell"]


def bell_device_arrays(plan: BellPlan, device, values_dtype=None) -> dict:
    """Value planes (``values_dtype``, default the plan's), lane planes
    (int8 at span 128, int16 at 256), per-layer bases ``ds`` (int32) and
    the spill sub-plan's LanePack arrays. ``values_dtype=torch.bfloat16``
    halves the value stream; the spill keeps f32 values. Slots the plan did
    not fill keep its pad convention: value 0, lane pointing at index 0 of
    the layer's first used 128-half."""
    vals = _t(plan.vals, device)
    if values_dtype is not None:
        vals = vals.to(values_dtype).contiguous()
    arrs = dict(
        vals=vals,
        lane=_t(plan.lane, device),
        ds=torch.tensor(plan.ds, dtype=torch.int32, device=device),
    )
    if plan.spill is not None:
        arrs["spill"] = lanepack_device_arrays(plan.spill, device)
    return arrs


def _bell_torch(vals, lane, x, *, ds: tuple, modes: tuple, span: int, rows: int, cols: int):
    """Plain PyTorch BELL apply: the counterpart of the interpret branch of
    ``_spmv_bell_jit`` (per layer, static slices of a zero-padded 2-D x and
    in-row lane gathers merged by 128-half, then one multiply-add)."""
    r128 = vals.shape[1]
    c128 = -(-cols // LANES)
    nh = span // 128 + 1  # 128-halves per layer window
    lo = max(0, -min(ds)) if ds else 0
    total = max(lo + r128 + max(max(ds, default=0) + nh - 1, 0), lo + c128)
    xflat = torch.zeros(c128 * LANES, dtype=x.dtype, device=x.device)
    xflat[: x.shape[0]] = x
    x2d = torch.zeros(total, LANES, dtype=x.dtype, device=x.device)
    x2d[lo : lo + c128] = xflat.reshape(c128, LANES)
    bias = LANES if span == 128 else 0  # int8 lanes store pos - 128
    y2 = torch.zeros(r128, LANES, dtype=x.dtype, device=x.device)
    for li, (d, mask) in enumerate(zip(ds, modes)):
        pos = lane[li].to(torch.int32) + bias
        idx = torch.bitwise_and(pos, 127).long()
        half = torch.bitwise_right_shift(pos, 7)
        xg = None
        for h in range(nh):
            if not (mask >> h) & 1:
                continue
            a = x2d[lo + d + h : lo + d + h + r128]
            g = torch.gather(a, 1, idx)
            xg = g if xg is None else torch.where(half == h, g, xg)
        y2 = y2 + vals[li].to(x.dtype) * xg
    return y2.reshape(-1)[:rows]


def spmv_bell(plan: BellPlan, x, *, device_arrays=None, allow_downcast=False):
    """``y = A @ x`` through the BELL kernel (+ the LanePack kernel on the
    spill sub-plan) for a CUDA ``x``, or their plain versions for a CPU
    ``x``."""
    x = _cast_x(x, plan.dtype, allow_downcast)
    arrs = device_arrays if device_arrays is not None else bell_device_arrays(plan, x.device)
    spill = plan.spill
    bias = LANES if plan.span == 128 else 0
    if on_cuda(x):
        from ..native.kernels import launch_bell

        x = x.contiguous()
        # the BELL kernel writes rows [0, rows); the spill kernel adds into
        # them (it writes only lanes where a row's run ends, all < rows)
        y = torch.empty(plan.r128 * LANES, dtype=x.dtype, device=x.device)
        launch_bell(arrs["vals"], arrs["lane"], arrs["ds"], x, y[: plan.rows],
                    bias=bias, rows=plan.rows)
        if spill is not None:
            _lanepack_cuda(arrs["spill"], x, y)
        return y[: plan.rows]
    if plan.num_layers:
        y = _bell_torch(arrs["vals"], arrs["lane"], x, ds=plan.ds, modes=plan.modes,
                        span=plan.span, rows=plan.rows, cols=plan.cols)
    else:
        y = torch.zeros(plan.rows, dtype=x.dtype, device=x.device)
    if spill is not None:
        y = y + _lanepack_torch(arrs["spill"], x, rows=plan.rows, cols=plan.cols, kw=spill.kw)
    return y
