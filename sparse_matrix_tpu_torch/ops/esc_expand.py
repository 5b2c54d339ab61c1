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
data too.

The plan also keeps its per-k **segments** (``ExpandPlan.segments``: each
k's first slot, lhs CSC start and length, rhs CSR start), and
:func:`expand_tiles` cuts the slots into tiles of ``ESC_TILE`` with the
operand windows each reads. The ESC expansion kernel
(``csrc/esc_expand.cu``) walks those segments and reads no per-slot
array: its device arrays are :func:`expand_segment_arrays` (with a
:class:`~..native.kernels.PreparedExpand` launch record on CUDA), and
:func:`_expand_segments_torch` is the plain version of that schedule. The
int16 lanes stay in the plan for :func:`expand_device_arrays` and the
plain :func:`_expand_torch`, the reference's form. On CUDA tensors
:func:`expand_products` launches the kernel; on CPU tensors it runs
:func:`_expand_segments_torch`.

Two of the reference's capability gates are gone, both TPU limits:

* the packed key is **int64** here. The reference requires ``(rows + 1)
  * cols < 2^31`` because the TPU sorts no int64 keys; the card does;
* the ``_MAX_KW = 64`` window cap was a VMEM budget. The kernel stages a
  tile's windows in shared memory where they fit and reads device memory
  where they do not, so only the plan's int16 lanes, kept in the
  reference's form, limit a window (``kw * 128 <= 32767``).

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

__all__ = ["ExpandPlan", "plan_expand_kmajor", "expand_tiles", "expand_device_arrays",
           "expand_segment_arrays", "expand_products"]

_MAX_LANE = int(np.iinfo(np.int16).max)  # lanes are int16


class ExpandPlan(NamedTuple):
    """k-major expansion plan: ``S`` slabs of (8, 128) product slots.

    ``lv_lane``/``rv_lane`` (S, 8, 128) int16: each operand's position in
    its chunk's window; ``lv_off``/``rv_off`` (S*8,) int32: each chunk's
    first window row of the operands viewed as (*, 128); ``out_key``
    (S*8*128,) int64 ``row * cols + col``, the sentinel ``rows * cols``
    on padding slots; ``perm_csc``: the lhs CSR-to-CSC value permutation;
    ``segments`` (G + 1, 4) int64: per k with ``lk * rk > 0``, in k order,
    its first slot, ``lk``, ``la`` (lhs CSC start) and ``ra`` (rhs CSR
    start), slot ``start + r * lk + l`` being ``lv_csc[la + l] * rv[ra +
    r]``; row G is the sentinel ``(num_products, 1, 0, 0)``; ``rhs_nnz``:
    the rhs values the plan reads from.
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
    segments: np.ndarray
    rhs_nnz: int

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
    segments = np.empty((ks.size + 1, 4), dtype=np.int64)
    segments[:-1] = np.stack([start[ks], lk[ks], la[ks], ra[ks]], axis=1)
    segments[-1] = (n, 1, 0, 0)
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
        out_key=key_pad, perm_csc=perm_csc.astype(np.int64), segments=segments,
        rhs_nnz=rhs.nnz(),
    )


def expand_tiles(plan: ExpandPlan, tile: int = None) -> np.ndarray:
    """``(ceil(slots / tile), 8)`` int64 rows ``(first segment, a_lo, a_hi,
    e_lo, e_hi, last segment, 0, 0)``, one a tile of ``tile`` slots (default
    the kernel's ``ESC_TILE``): the segments holding the tile's first and
    last real slot and the lhs CSC positions ``[a_lo, a_hi)`` and rhs
    positions ``[e_lo, e_hi)`` its real slots read. A tile of padding only
    gets the sentinel segment and empty windows. Where a tile holds one row of a segment in
    part, the lhs window is that part of the column."""
    from ..native.kernels import ESC_TILE

    tile = ESC_TILE if tile is None else tile
    seg, n = plan.segments, plan.num_products
    g = seg.shape[0] - 1
    slots = plan.num_slabs * SUBLANES * LANES
    out = np.zeros((-(-slots // tile), 8), dtype=np.int64)
    out[:, 0] = g
    t0 = np.arange(out.shape[0], dtype=np.int64) * tile
    live = t0 < n
    t0 = t0[live]
    t1 = np.minimum(t0 + tile, n)  # past the tile's last real slot
    start, lk, la, ra = seg[:, 0], seg[:, 1], seg[:, 2], seg[:, 3]
    jf = np.searchsorted(start, t0, side="right") - 1
    jl = np.searchsorted(start, t1 - 1, side="right") - 1
    # the first segment's part: offsets [w0, wf) of it, rows r0 .. rf
    w0 = t0 - start[jf]
    wf = np.minimum(t1, start[jf + 1]) - start[jf]
    r0, rf = w0 // lk[jf], (wf - 1) // lk[jf]
    a_lo = la[jf] + np.where(r0 == rf, w0 % lk[jf], 0)
    # the last segment's part: offsets [wb, w1), rows rb .. rl
    wb = np.where(jl == jf, w0, 0)
    w1 = t1 - start[jl]
    rb, rl = wb // lk[jl], (w1 - 1) // lk[jl]
    a_hi = la[jl] + np.where(rb == rl, (w1 - 1) % lk[jl] + 1, lk[jl])
    out[live, 0] = jf
    out[live, 1] = a_lo
    out[live, 2] = a_hi
    out[live, 3] = ra[jf] + r0
    out[live, 4] = ra[jl] + rl + 1
    out[live, 5] = jl
    return out


def expand_device_arrays(plan: ExpandPlan, device) -> dict:
    """The plan's lane and window arrays on ``device``, reusable across
    calls (no padding to the reference's B-slab grid steps)."""
    from .spmv import _t

    return dict(lv_lane=_t(plan.lv_lane, device), rv_lane=_t(plan.rv_lane, device),
                lv_off=_t(plan.lv_off, device), rv_off=_t(plan.rv_off, device))


def expand_segment_arrays(plan: ExpandPlan, device) -> dict:
    """The plan's segment descriptors on ``device``, what the expansion
    kernel reads (no per-slot array): ``segments`` ``(G + 1, 4)``,
    ``tiles`` (:func:`expand_tiles`) and ``perm`` (``perm_csc``) as int32,
    and on CUDA ``launch``, a :class:`~..native.kernels.PreparedExpand`
    checked once here, called as ``launch(lv, rv, p, csr_order=False)``."""
    from .spmv import _t

    dev = torch.device(device)
    arrs = dict(segments=_t(plan.segments.astype(np.int32), dev),
                tiles=_t(expand_tiles(plan).astype(np.int32), dev),
                perm=_t(plan.perm_csc.astype(np.int32), dev))
    if dev.type == "cuda":
        from ..native.kernels import prepare_esc_expand

        arrs["launch"] = prepare_esc_expand(
            arrs["segments"], arrs["tiles"], arrs["perm"], num_products=plan.num_products,
            num_slots=plan.num_slabs * SUBLANES * LANES, n_lv=plan.perm_csc.size,
            n_rv=plan.rhs_nnz)
    return arrs


def _segment_positions(segments, num_products: int):
    """The lhs CSC position ``a`` and rhs position ``e`` of every real slot
    of a segment plan (``segments`` (G + 1, 4), any integer type): the
    kernel's schedule written out per slot."""
    seg = segments.long()
    s = torch.arange(num_products, dtype=torch.int64, device=seg.device)
    j = torch.searchsorted(seg[:, 0].contiguous(), s, right=True) - 1
    g = seg[j]
    w = s - g[:, 0]
    return g[:, 2] + w % g[:, 1], g[:, 3] + w // g[:, 1]


def _expand_segments_torch(lv, rv, segments, *, num_products: int, num_slots: int, perm=None):
    """Plain PyTorch version of the segment schedule: slot ``start + r * lk
    + l`` of segment ``(start, lk, la, ra)`` gets ``lv[la + l] * rv[ra +
    r]`` (``lv[perm[la + l]]`` with ``perm``: lv in CSR order), one f32
    multiply; the padding slots past ``num_products`` get 0."""
    a, e = _segment_positions(segments, num_products)
    if perm is not None:
        a = perm.long()[a]
    p = torch.zeros(num_slots, dtype=lv.dtype, device=lv.device)
    p[:num_products] = lv[a] * rv[e]
    return p


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


def expand_products(plan: ExpandPlan, lv_csc, rv, *, device_arrays=None,
                    csr_order: bool = False):
    """All intermediate products in plan order, ``(S * 1024,)``, zero on
    the padding slots.

    ``lv_csc``: the lhs values CSC-permuted (``vals[plan.perm_csc]``), or
    in CSR order with ``csr_order`` (read through ``perm_csc``, no
    separate gather); ``rv``: the rhs values in CSR order; both on one
    device. ``device_arrays``: :func:`expand_segment_arrays` on that device
    (built here when None). CUDA tensors go through the expansion kernel's
    launch record, which takes f32 only; CPU tensors through
    :func:`_expand_segments_torch`.
    """
    arrs = (device_arrays if device_arrays is not None
            else expand_segment_arrays(plan, lv_csc.device))
    cuda = on_cuda(lv_csc)
    if "segments" not in arrs or (cuda and "launch" not in arrs):
        raise ValueError("expand_products: the expansion reads the plan's segments; pass "
                         "expand_segment_arrays(plan, device)")
    num_slots = plan.num_slabs * SUBLANES * LANES
    if cuda:
        p = torch.empty(num_slots, dtype=lv_csc.dtype, device=lv_csc.device)
        arrs["launch"](lv_csc, rv, p, csr_order=csr_order)
        return p
    return _expand_segments_torch(lv_csc, rv, arrs["segments"], num_products=plan.num_products,
                                  num_slots=num_slots, perm=arrs["perm"] if csr_order else None)
