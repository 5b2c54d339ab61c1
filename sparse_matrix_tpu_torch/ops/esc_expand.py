"""The ESC SpGEMM's k-major expansion: every intermediate product ``lv *
rv`` of ``C = A @ B`` in a host-planned order.

Counterpart of ``sparse_matrix_tpu/ops/esc_expand.py``. The plan
(:func:`plan_expand_kmajor`, numpy) orders the products k-major: for each
contraction index k, the rhs row-k entries major and the lhs column-k
entries minor. Each chunk of 128 consecutive products then reads both
operands from one short window: the lhs values stored CSC-permuted, the
rhs values in CSR order. A product slot holds its operand's position
inside the chunk's window as an int16 lane; the chunk holds the window's
first 128-value row. The packed output key ``row * cols + col`` is plan
data too. On CUDA tensors the expansion is the ESC expansion kernel
(``csrc/esc_expand.cu``); on CPU tensors the plain :func:`_expand_torch`.

Two of the reference's capability gates are gone, both TPU limits:

* the packed key is **int64** here. The reference requires ``(rows + 1)
  * cols < 2^31`` because the TPU sorts no int64 keys; the card does;
* the ``_MAX_KW = 64`` window cap was a VMEM budget. The kernel reads its
  operands from device memory, bounds-checked, so only the int16 lane
  range limits a window (``kw * 128 <= 32767``).

So products the reference sends to its gather engine (the bench's
262k-row classes squared, dense lhs columns) take the expansion here.
Where the reference returns a plan, the port's arrays are equal to it.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import on_cuda
from ..formats.csr import CsrMatrix
from ..formats.lanepack import LANES, SUBLANES

__all__ = ["ExpandPlan", "plan_expand_kmajor", "expand_device_arrays", "expand_products"]

_MAX_LANE = int(np.iinfo(np.int16).max)  # lanes are int16


class ExpandPlan(NamedTuple):
    """k-major expansion plan: ``S`` slabs of (8, 128) product slots.

    ``lv_lane``/``rv_lane`` (S, 8, 128) int16: each operand's position in
    its chunk's window; ``lv_off``/``rv_off`` (S*8,) int32: each chunk's
    first window row of the operands viewed as (*, 128); ``out_key``
    (S*8*128,) int64 ``row * cols + col``, the sentinel ``rows * cols``
    on padding slots; ``perm_csc``: the lhs CSR-to-CSC value permutation.
    """

    rows: int
    cols: int
    num_products: int
    kw_lv: int
    kw_rv: int
    lv_lane: np.ndarray
    rv_lane: np.ndarray
    lv_off: np.ndarray
    rv_off: np.ndarray
    out_key: np.ndarray
    perm_csc: np.ndarray

    @property
    def num_slabs(self) -> int:
        return int(self.lv_lane.shape[0])


def plan_expand_kmajor(lhs: CsrMatrix, rhs: CsrMatrix):
    """The k-major expansion plan, or None when the product has no scalar
    products or a window outgrows the int16 lanes."""
    if lhs.cols != rhs.rows:
        raise ValueError("LHS cols != RHS rows")
    rows, cols = lhs.rows, rhs.cols

    # lhs in CSC order: entries sorted by (col, row)
    lr = lhs.row_ids().astype(np.int64)
    lc = lhs.indices.astype(np.int64)
    perm_csc = np.lexsort((lr, lc))
    lr_s = lr[perm_csc]

    # per-k segments: lhs CSC [la, la+lk), rhs CSR [ra, ra+rk)
    k_space = lhs.cols
    lk = np.bincount(lc[perm_csc], minlength=k_space)
    del lr, lc
    la = np.zeros(k_space, dtype=np.int64)
    np.cumsum(lk[:-1], out=la[1:])
    rk = np.diff(rhs.offsets).astype(np.int64)
    ra = rhs.offsets[:-1].astype(np.int64)

    nk = lk * rk
    n = int(nk.sum())
    if n == 0:
        return None
    start = np.zeros(k_space, dtype=np.int64)
    np.cumsum(nk[:-1], out=start[1:])
    ks = np.nonzero(nk)[0]
    k_of = np.repeat(ks, nk[ks])
    within = np.arange(n, dtype=np.int64) - start[k_of]
    lkk = lk[k_of]
    e_of = ra[k_of] + within // lkk  # rhs entry position (rhs-entry major)
    a_of = la[k_of] + within % lkk  # lhs CSC position
    del k_of, within, lkk

    out_key = lr_s[a_of] * cols + rhs.indices.astype(np.int64)[e_of]
    del lr_s

    # 128 consecutive products per chunk; each chunk's operand windows start
    # at the 128-row of its smallest position
    num_chunks = -(-n // LANES)
    heads = np.arange(num_chunks, dtype=np.int64) * LANES

    def windows(pos):
        lo = np.minimum.reduceat(pos, heads) >> 7
        lo_of = np.repeat(lo, LANES)[:n]
        lane = pos - (lo_of << 7)
        kw = int(np.max(lane) // LANES + 1)
        return lo.astype(np.int32), lane, kw

    lv_off_c, lv_lane_f, kw_lv = windows(a_of)
    del a_of
    rv_off_c, rv_lane_f, kw_rv = windows(e_of)
    del e_of
    if max(kw_lv, kw_rv) * LANES > _MAX_LANE:
        return None

    num_slabs = -(-num_chunks // SUBLANES)
    slots = num_slabs * SUBLANES * LANES
    lv_lane = np.zeros((num_slabs, SUBLANES, LANES), dtype=np.int16)
    rv_lane = np.zeros((num_slabs, SUBLANES, LANES), dtype=np.int16)
    lv_lane.reshape(-1)[:n] = lv_lane_f
    rv_lane.reshape(-1)[:n] = rv_lane_f
    del lv_lane_f, rv_lane_f
    lv_off = np.zeros(num_slabs * SUBLANES, dtype=np.int32)
    rv_off = np.zeros(num_slabs * SUBLANES, dtype=np.int32)
    lv_off[:num_chunks] = lv_off_c
    rv_off[:num_chunks] = rv_off_c

    key_pad = np.full(slots, rows * cols, dtype=np.int64)
    key_pad[:n] = out_key
    return ExpandPlan(
        rows=rows, cols=cols, num_products=n, kw_lv=kw_lv, kw_rv=kw_rv,
        lv_lane=lv_lane, rv_lane=rv_lane, lv_off=lv_off, rv_off=rv_off,
        out_key=key_pad, perm_csc=perm_csc.astype(np.int64),
    )


def expand_device_arrays(plan: ExpandPlan, device) -> dict:
    """The plan's lane and window arrays on ``device``, reusable across
    calls (no padding to the reference's B-slab grid steps)."""
    from .spmv import _t

    return dict(lv_lane=_t(plan.lv_lane, device), rv_lane=_t(plan.rv_lane, device),
                lv_off=_t(plan.lv_off, device), rv_off=_t(plan.rv_off, device))


def _expand_torch(lv, rv, lv_lane, rv_lane, lv_off, rv_off, *, num_products: int):
    """Plain PyTorch expansion: the counterpart of the reference's
    interpret branch. Its window slice plus lane gather reads operand
    position ``off * 128 + lane``, so this gathers there directly, with
    zero past the end of an operand (the reference's zero window padding).
    Slots past ``num_products`` get 0 (the reference leaves a product of
    lane-0 operands there)."""

    def gather(x, off, lane):
        pos = (off.long().repeat_interleave(LANES) * LANES + lane.reshape(-1).long())
        inside = pos < x.shape[0]
        return torch.where(inside, x[torch.where(inside, pos, 0)],
                           torch.zeros((), dtype=x.dtype, device=x.device))

    p = gather(lv, lv_off, lv_lane) * gather(rv, rv_off, rv_lane)
    p[num_products:] = 0
    return p


def expand_products(plan: ExpandPlan, lv_csc, rv, *, device_arrays=None):
    """All intermediate products in plan order, ``(S * 1024,)``, zero on
    the padding slots.

    ``lv_csc``: the lhs values already CSC-permuted (``vals[plan.perm_csc]``);
    ``rv``: the rhs values in CSR order; both on one device.
    ``device_arrays``: :func:`expand_device_arrays` on that device (built
    here when None). CUDA tensors go through the expansion kernel, which
    takes f32 only; CPU tensors through :func:`_expand_torch`.
    """
    arrs = device_arrays if device_arrays is not None else expand_device_arrays(
        plan, lv_csc.device)
    if not on_cuda(lv_csc):
        return _expand_torch(lv_csc, rv, arrs["lv_lane"], arrs["rv_lane"], arrs["lv_off"],
                             arrs["rv_off"], num_products=plan.num_products)
    from ..native.kernels import launch_esc_expand

    p = torch.empty(plan.num_slabs * SUBLANES * LANES, dtype=lv_csc.dtype,
                    device=lv_csc.device)
    launch_esc_expand(lv_csc.contiguous(), rv.contiguous(), arrs["lv_lane"], arrs["rv_lane"],
                      arrs["lv_off"], arrs["rv_off"], p, num_products=plan.num_products)
    return p
