"""General SpMV paths: the LanePack, aligned and stripe kernels and the ELL
gather.

Counterpart of ``sparse_matrix_tpu/ops/spmv.py``. The host plans come from
the port's planners (``formats/``), array-equal to the reference's:

* :func:`spmv_lanepack` — the segmented-reduce kernel
  (``csrc/spmv_lanepack.cu``) over a ``LanePackPlan``;
* :func:`spmv_aligned` — the destination-aligned kernel
  (``csrc/spmv_aligned.cu``), which writes y, plus the LanePack kernel on
  the plan's spill sub-plan in add mode;
* :func:`spmv_stripe` — the multi-level stripe kernel
  (``csrc/spmv_stripe.cu``), which writes y, over a ``StripePlan`` and,
  through the same kernel in add mode, its scan-mode spill sub-plan;
* :func:`spmv_ell` / :func:`spmv_ell_spill` — padded-ELL gathers in plain
  PyTorch on every device (the reference computes ELL in XLA, not Pallas);
* :func:`spmv_oracle` — the host CSR row loop, the test oracle, and
  :func:`spmv_f64_bound` — a float64 product with the per-row float32
  error bound that the tests and ``chip_smoke.py`` hold the kernels to.

A CUDA ``x`` launches the kernels; a CPU ``x`` takes the plain versions
:func:`_lanepack_torch`, :func:`_aligned_torch` and :func:`_stripe_torch`.

The aligned and LanePack kernels give each row block's sum one owner: the
device arrays carry the plan's chunks cut into segments
(:func:`chunk_segments`: at most ``SEGMENT_CHUNKS`` consecutive chunks of
one row block each, in plan order), one warp a segment, and a launch
record (``native.kernels.PreparedLaunch``) made when the arrays are built,
so that a call checks only x and y. :func:`_segments_torch` evaluates a
plan over its segments on any device, in the kernels' order. The stripe
kernel does the same for each stripe's rows (:func:`stripe_segments`: at
most ``stripe_segment_slabs(L)`` consecutive slabs of one stripe a
segment, one thread block each; :func:`_stripe_segments_torch`).
The TPU-only limits of the reference are not carried over: its SMEM and
VMEM raises, the B-slab padding of ``_pick_b``, the SMEM slab segmentation
of aligned plans, and the ``rb_a``/``rb_b``/``split`` two-target packing
(the kernels target rows through ``chunk_rb`` and ``stripe_rb``, as the
reference's own CPU path does).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import on_cuda
from ..formats.csr import CsrMatrix
from ..formats.lanepack import LANES, SUBLANES, LanePackPlan
from ..native import kernels

__all__ = [
    "lanepack_device_arrays",
    "spmv_lanepack",
    "aligned_device_arrays",
    "spmv_aligned",
    "stripe_segments",
    "stripe_device_arrays",
    "spmv_stripe",
    "ell_from_csr",
    "ell_spill_from_csr",
    "spmv_ell",
    "spmv_ell_spill",
    "spmv_f64_bound",
    "spmv_oracle",
]

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float64): torch.float64,
}


def _t(a: np.ndarray, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def _cast_x(x, plan_dtype, allow_downcast: bool) -> torch.Tensor:
    """Cast ``x`` to the plan's dtype, refusing silent precision loss (a
    float64 vector reaching a float32 plan raises unless
    ``allow_downcast``)."""
    out = _TORCH_DTYPES[np.dtype(plan_dtype)]
    if isinstance(x, torch.Tensor) and x.dtype == out:
        return x
    x = torch.as_tensor(x)
    if (
        not allow_downcast
        and x.dtype.is_floating_point
        and x.dtype.itemsize > out.itemsize
    ):
        raise TypeError(
            f"x has dtype {x.dtype} but the plan is {out}: refusing the "
            "silent precision loss. Build the operator with "
            f"dtype={x.dtype}, cast x yourself, or pass allow_downcast=True."
        )
    return x.to(out)


# ---------------------------------------------------------------------------
# Segments: row-block ownership in the aligned and LanePack kernels
# ---------------------------------------------------------------------------


#: the most chunks one segment holds: a warp's work in the aligned and
#: LanePack kernels (csrc/segments.h; at most 32, one window base a lane);
#: a row block of more chunks is cut into several segments, whose sums its
#: last warp adds in order
SEGMENT_CHUNKS = 32


def _kept_chunks(chunk_rb, col_off, rb_mask, slot_arrays) -> np.ndarray:
    """The chunks a kernel must visit: all but slab padding. A padding
    chunk (row block 0, window 0, every slot array zero) adds ``0 * x[0]``
    to each row of row block 0 (exactly what ``_aligned_torch`` and
    ``_lanepack_torch`` add for it: zero, or NaN for a non-finite
    ``x[0]``), so one of them stands for all, and none where row block 0
    is masked."""
    pad = (chunk_rb == 0) & (col_off == 0)
    cand = np.nonzero(pad)[0]
    for a in slot_arrays:
        pad[cand] &= ~np.any(a[cand] != 0, axis=1)
    keep = ~pad
    if pad.any() and rb_mask.size and rb_mask[0] > 0:
        keep[int(np.argmax(pad))] = True
    return keep


def chunk_segments(chunk_rb, keep, r128: int, g: int = SEGMENT_CHUNKS):
    """Cut the kept chunks into segments, each a run of at most ``g``
    consecutive chunks of one row block in plan order, sorted by row block
    (a row block with no chunk gets one empty segment). Returns
    ``(segments, rb_seg, slots)``: ``segments`` (S, 4) int32 rows (row
    block, first chunk, chunk count, scratch slot), the slot -1 for a row
    block's only segment and else numbered in segment order; ``rb_seg``
    (r128 + 1,) int32, row block r's segments being ``rb_seg[r] ..
    rb_seg[r + 1]``; ``slots`` the scratch slots used."""
    if not 1 <= g <= 32:
        raise ValueError(f"segment length {g} must be in [1, 32]")
    idx = np.nonzero(keep)[0]
    rb = chunk_rb[idx].astype(np.int64)
    order = np.argsort(rb, kind="stable")
    idx, rb = idx[order], rb[order]
    brk = np.ones(idx.size, bool)
    brk[1:] = (rb[1:] != rb[:-1]) | (idx[1:] != idx[:-1] + 1)
    run_start = np.nonzero(brk)[0]
    pos = np.arange(idx.size) - run_start[np.cumsum(brk) - 1]
    heads = np.nonzero(pos % g == 0)[0]
    empty = np.setdiff1d(np.arange(r128), rb[heads])
    seg_rb = np.concatenate([rb[heads], empty])
    first = np.concatenate([idx[heads], np.zeros(empty.size, np.int64)])
    count = np.concatenate([np.diff(np.append(heads, idx.size)), np.zeros(empty.size, np.int64)])
    order = np.argsort(seg_rb, kind="stable")
    seg_rb, first, count = seg_rb[order], first[order], count[order]
    rb_seg = np.zeros(r128 + 1, np.int64)
    np.cumsum(np.bincount(seg_rb, minlength=r128), out=rb_seg[1:])
    multi = np.diff(rb_seg)[seg_rb] > 1
    slot = np.full(seg_rb.size, -1, np.int64)
    slot[multi] = np.arange(int(multi.sum()))
    segments = np.stack([seg_rb, first, count, slot], axis=1).astype(np.int32)
    return segments, rb_seg.astype(np.int32), int(multi.sum())


def _segment_arrays(kind: str, plan, device) -> dict:
    """``segments``, ``rb_seg`` (on ``device``) and ``seg_slots`` of an
    aligned (``kind="aligned"``) or LanePack plan."""
    chunks = plan.num_slabs * SUBLANES
    names = ("vals", "lane") + (("ends", "starts") if kind == "lanepack" else ())
    slot_arrays = [getattr(plan, n).reshape(chunks, LANES) for n in names]
    keep = _kept_chunks(plan.chunk_rb[:chunks], plan.col_off[:chunks], plan.rb_mask,
                        slot_arrays)
    segments, rb_seg, slots = chunk_segments(plan.chunk_rb[:chunks], keep, plan.r128,
                                             SEGMENT_CHUNKS)
    return dict(segments=_t(segments, device), rb_seg=_t(rb_seg, device),
                seg_slots=slots)


def _prepare_segment_launch(kind: str, arrs: dict, plan) -> kernels.PreparedLaunch:
    """The aligned or LanePack kernel's launch record on ``arrs``: its
    scratch slots (``seg_scratch``) and zeroed tickets (``seg_tickets``)
    are allocated here, every array checked once."""
    dev = arrs["vals"].device
    if "segments" not in arrs:
        arrs.update(_segment_arrays(kind, plan, dev))
    arrs["seg_scratch"] = torch.empty((arrs["seg_slots"], LANES), dtype=torch.float32,
                                      device=dev)
    arrs["seg_tickets"] = torch.zeros(plan.r128, dtype=torch.int32, device=dev)
    common = dict(col_off=arrs["col_off"], segments=arrs["segments"], rb_seg=arrs["rb_seg"],
                  scratch=arrs["seg_scratch"], tickets=arrs["seg_tickets"], cols=plan.cols,
                  rows=plan.rows)
    if kind == "aligned":
        return kernels.prepare_aligned(arrs["vals"], arrs["lane"], **common)
    return kernels.prepare_lanepack(arrs["vals"], arrs["lane"], arrs["ends"], arrs["starts"],
                                    **common)


def _prepare_aligned(arrs: dict, plan) -> kernels.PreparedLaunch:
    return _prepare_segment_launch("aligned", arrs, plan)


def _prepare_lanepack(arrs: dict, plan) -> kernels.PreparedLaunch:
    return _prepare_segment_launch("lanepack", arrs, plan)


def _prepare_segment_spmm(kind: str, arrs: dict, plan) -> kernels.PreparedSpmm:
    """The aligned or LanePack SpMM kernel's launch record on the plan's
    ``arrs``: the segments of the SpMV kernel, with scratch slots 16
    columns wide (``spmm_scratch``) and two zeroed tickets a row block
    (``spmm_tickets``) of its own, every array checked once."""
    dev = arrs["vals"].device
    if "segments" not in arrs:
        arrs.update(_segment_arrays(kind, plan, dev))
    arrs["spmm_scratch"] = torch.empty((arrs["seg_slots"], kernels.LANEPACK_SPMM_COLS * LANES),
                                       dtype=torch.float32, device=dev)
    arrs["spmm_tickets"] = torch.zeros(kernels.LANEPACK_SPMM_GROUPS * plan.r128,
                                       dtype=torch.int32, device=dev)
    common = dict(col_off=arrs["col_off"], segments=arrs["segments"], rb_seg=arrs["rb_seg"],
                  scratch=arrs["spmm_scratch"], tickets=arrs["spmm_tickets"], cols=plan.cols,
                  rows=plan.rows)
    if kind == "aligned":
        return kernels.prepare_aligned_spmm(arrs["vals"], arrs["lane"], **common)
    return kernels.prepare_lanepack_spmm(arrs["vals"], arrs["lane"], arrs["ends"],
                                         arrs["starts"], **common)


def _prepare_aligned_spmm(arrs: dict, plan) -> kernels.PreparedSpmm:
    return _prepare_segment_spmm("aligned", arrs, plan)


def _prepare_lanepack_spmm(arrs: dict, plan) -> kernels.PreparedSpmm:
    return _prepare_segment_spmm("lanepack", arrs, plan)


def _launch_record(prepare, arrs: dict, plan, key: str = "launch"):
    """``arrs[key]`` (``"launch"``: the SpMV kernel's record,
    ``"spmm_launch"``: the SpMM kernel's), made by ``prepare(arrs, plan)``
    (and the arrays checked) at the first call where the caller built the
    dict without it."""
    rec = arrs.get(key)
    if rec is None:
        rec = arrs[key] = prepare(arrs, plan)
    return rec


def _segments_torch(kind: str, arrs, x, *, rows: int, cols: int, kw: int = 1):
    """Plain PyTorch evaluation of an aligned (``kind="aligned"``) or
    LanePack plan over its segment arrays, in the kernels' order: per
    chunk the 128 row contributions (the products, or the run differences
    of the chunk's prefix sum), added chunk by chunk within each segment,
    then segment by segment within each row block; rows past ``rows``
    dropped. ``x`` is a vector (the SpMV kernels' order) or a (cols, K)
    block, whose columns each take their own scan and sum (the aligned and
    LanePack SpMM kernels' order; the aligned SpMM kernel gives these bits);
    the result is (rows,) or (rows, K). The CPU tests hold it to
    ``_aligned_torch``, ``_lanepack_torch``, ``ops.spmm._aligned_spmm_torch``
    and ``ops.spmm._lanepack_spmm_torch``; no call path uses it."""
    vals = arrs["vals"]
    co = arrs["col_off"].long()
    c128 = -(-cols // LANES)
    win = kw if kind == "lanepack" else 1
    xm = x.reshape(x.shape[0], -1)
    k = xm.shape[1]
    xpad = torch.zeros(((c128 + win) * LANES, k), dtype=x.dtype, device=x.device)
    xpad[: x.shape[0]] = xm
    x3 = xpad.reshape(c128 + win, LANES, k)
    chunks = vals.shape[0]
    xw = x3[co[:chunks, None] + torch.arange(win, device=x.device)[None, :]]
    lane = arrs["lane"].long()[:, :, None].expand(-1, -1, k)
    p = vals[:, :, None] * torch.gather(xw.reshape(chunks, win * LANES, k), 1, lane)
    if kind == "lanepack":
        c = torch.cumsum(p, dim=1)
        ends = arrs["ends"].long()[:, :, None].expand(-1, -1, k)
        starts = arrs["starts"].long()[:, :, None].expand(-1, -1, k)
        p = torch.gather(c, 1, ends) - torch.where(
            starts < 0, 0.0, torch.gather(c, 1, starts.clamp(min=0)))
    seg = arrs["segments"].long()
    first, count = seg[:, 1], seg[:, 2]
    acc = torch.zeros(seg.shape[0], LANES, k, dtype=vals.dtype, device=x.device)
    for j in range(int(count.max()) if seg.shape[0] else 0):
        live = count > j
        acc[live] += p[first[live] + j]
    rb_seg = arrs["rb_seg"].long()
    nseg = rb_seg[1:] - rb_seg[:-1]
    y3 = torch.zeros(nseg.shape[0], LANES, k, dtype=vals.dtype, device=x.device)
    for j in range(int(nseg.max()) if nseg.numel() else 0):
        live = nseg > j
        y3[live] += acc[rb_seg[:-1][live] + j]
    y = y3.reshape(-1, k)[:rows]
    return y if x.dim() == 2 else y[:, 0]


# ---------------------------------------------------------------------------
# LanePack
# ---------------------------------------------------------------------------


def lanepack_device_arrays(plan: LanePackPlan, device) -> dict:
    """A LanePack plan's slot and chunk arrays on ``device``, flattened to
    128-slot chunks: ``vals`` (f32), ``lane`` (int16), ``ends``/``starts``
    (int8), ``col_off``/``chunk_rb`` (int32, one per chunk), ``rb_mask``;
    its segments (``segments``, ``rb_seg``, ``seg_slots``; see
    :func:`chunk_segments`) and, on CUDA, ``launch``: the SpMV kernel's
    launch record, every array checked, with the ``seg_scratch`` slots and
    ``seg_tickets`` it owns, and ``spmm_launch``: the SpMM kernel's
    (``native.kernels.PreparedSpmm``), with its ``spmm_scratch`` and
    ``spmm_tickets`` (one launch at a time for each)."""
    chunks = plan.num_slabs * plan.vals.shape[1]
    arrs = dict(
        vals=_t(plan.vals.reshape(chunks, LANES), device),
        lane=_t(plan.lane.reshape(chunks, LANES), device),
        ends=_t(plan.ends.reshape(chunks, LANES), device),
        starts=_t(plan.starts.reshape(chunks, LANES), device),
        col_off=_t(plan.col_off[:chunks].astype(np.int32), device),
        chunk_rb=_t(plan.chunk_rb[:chunks].astype(np.int32), device),
        rb_mask=_t(plan.rb_mask, device),
        **_segment_arrays("lanepack", plan, device),
    )
    if arrs["vals"].is_cuda:
        arrs["launch"] = _prepare_lanepack(arrs, plan)
        arrs["spmm_launch"] = _prepare_lanepack_spmm(arrs, plan)
    return arrs


def _lanepack_torch(arrs, x, *, rows: int, cols: int, kw: int):
    """Plain PyTorch evaluation of a LanePack plan: the counterpart of
    ``_lanepack_reference`` (window gather, product, cumsum, run-boundary
    differences, scatter-add by chunk row block, empty blocks masked)."""
    vals = arrs["vals"]
    lane = arrs["lane"].long()
    ends = arrs["ends"].long()
    starts = arrs["starts"].long()
    co = arrs["col_off"].long()
    c128 = -(-cols // LANES)
    xpad = torch.zeros((c128 + kw) * LANES, dtype=x.dtype, device=x.device)
    xpad[: x.shape[0]] = x
    x2d = xpad.reshape(c128 + kw, LANES)
    win = x2d[co[:, None] + torch.arange(kw, device=x.device)[None, :]]
    xg = torch.gather(win.reshape(co.shape[0], kw * LANES), 1, lane)
    c = torch.cumsum(vals * xg, dim=1)
    g_end = torch.gather(c, 1, ends)
    g_start = torch.where(
        starts < 0, 0.0, torch.gather(c, 1, starts.clamp(min=0))
    )
    r128 = arrs["rb_mask"].shape[0]
    y2d = torch.zeros(r128, LANES, dtype=vals.dtype, device=x.device)
    y2d.index_add_(0, arrs["chunk_rb"].long(), g_end - g_start)
    y2d = torch.where(arrs["rb_mask"][:, None] > 0, y2d, 0.0)
    return y2d.reshape(-1)[:rows]


def spmv_lanepack(plan: LanePackPlan, x, *, device_arrays=None, allow_downcast=False):
    """``y = A @ x`` through the LanePack kernel (CUDA ``x``: it writes
    every row of a fresh y) or its plain version (CPU ``x``)."""
    x = _cast_x(x, plan.dtype, allow_downcast)
    arrs = device_arrays if device_arrays is not None else lanepack_device_arrays(plan, x.device)
    if on_cuda(x):
        y = torch.empty(plan.rows, dtype=x.dtype, device=x.device)
        _launch_record(_prepare_lanepack, arrs, plan)(x.contiguous(), y)
        return y
    return _lanepack_torch(arrs, x, rows=plan.rows, cols=plan.cols, kw=plan.kw)


# ---------------------------------------------------------------------------
# Aligned (destination-aligned slots; formats/aligned.py)
# ---------------------------------------------------------------------------


def aligned_device_arrays(plan, device) -> dict:
    """An ``AlignedPlan``'s arrays on ``device`` (``vals`` f32 and ``lane``
    int8 as ``(chunks, 128)``, ``col_off``/``chunk_rb`` int32, ``rb_mask``),
    its segments and, on CUDA, the launch records of the SpMV and SpMM
    kernels (``launch``, ``spmm_launch``, as :func:`lanepack_device_arrays`),
    plus ``spill``: the LanePack sub-plan's arrays when the plan has one."""
    chunks = plan.num_slabs * plan.vals.shape[1]
    arrs = dict(
        vals=_t(plan.vals.reshape(chunks, LANES), device),
        lane=_t(plan.lane.reshape(chunks, LANES), device),
        col_off=_t(plan.col_off[:chunks].astype(np.int32), device),
        chunk_rb=_t(plan.chunk_rb[:chunks].astype(np.int32), device),
        rb_mask=_t(plan.rb_mask, device),
        **_segment_arrays("aligned", plan, device),
    )
    if arrs["vals"].is_cuda:
        arrs["launch"] = _prepare_aligned(arrs, plan)
        arrs["spmm_launch"] = _prepare_aligned_spmm(arrs, plan)
    if plan.spill is not None:
        arrs["spill"] = lanepack_device_arrays(plan.spill, device)
    return arrs


def _aligned_torch(arrs, x, *, rows: int, cols: int):
    """Plain PyTorch evaluation of an aligned plan: the counterpart of
    ``_aligned_reference`` (per-chunk products scatter-added by chunk row
    block, empty blocks masked)."""
    vals = arrs["vals"]
    c128 = -(-cols // LANES)
    xpad = torch.zeros((c128 + 1) * LANES, dtype=x.dtype, device=x.device)
    xpad[: x.shape[0]] = x
    xw = xpad.reshape(c128 + 1, LANES)[arrs["col_off"].long()]
    p = vals * torch.gather(xw, 1, arrs["lane"].long())
    r128 = arrs["rb_mask"].shape[0]
    y2d = torch.zeros(r128, LANES, dtype=vals.dtype, device=x.device)
    y2d.index_add_(0, arrs["chunk_rb"].long(), p)
    y2d = torch.where(arrs["rb_mask"][:, None] > 0, y2d, 0.0)
    return y2d.reshape(-1)[:rows]


def spmv_aligned(plan, x, *, device_arrays=None, allow_downcast=False):
    """``y = A @ x`` through the aligned kernel, which writes every row of
    a fresh y, and the LanePack kernel on the spill sub-plan in add mode
    (CUDA ``x``), or through their plain versions (CPU ``x``)."""
    x = _cast_x(x, plan.dtype, allow_downcast)
    arrs = device_arrays if device_arrays is not None else aligned_device_arrays(plan, x.device)
    spill = plan.spill
    if on_cuda(x):
        x = x.contiguous()
        y = torch.empty(plan.rows, dtype=x.dtype, device=x.device)
        _launch_record(_prepare_aligned, arrs, plan)(x, y)
        if spill is not None:
            _launch_record(_prepare_lanepack, arrs["spill"], spill)(x, y, add=True)
        return y
    y = _aligned_torch(arrs, x, rows=plan.rows, cols=plan.cols)
    if spill is not None:
        y = y + _lanepack_torch(arrs["spill"], x, rows=plan.rows, cols=plan.cols, kw=spill.kw)
    return y


# ---------------------------------------------------------------------------
# Stripe (multi-level destinations; formats/stripe.py)
# ---------------------------------------------------------------------------


def _stripe_chain(plan):
    """The plan and its spill sub-plans, outermost first."""
    while plan is not None:
        yield plan
        plan = plan.spill


def stripe_segment_slabs(levels: int) -> int:
    """The most slabs one segment of a plan of ``levels`` levels holds, a
    thread block's work in the stripe kernel (csrc/spmv_stripe.cu; a stripe
    of more slabs is cut into several segments, whose sums its last block
    adds in order): 8 for at most 2 levels, 4 above, the faster of 2, 4 and
    8 on each of the main path's plans, randlocal scan(2,2) and powerlaw
    scan(8,16), on an H100 (PERF.md §6)."""
    return 8 if levels <= 2 else 4


def stripe_segments(plan):
    """Cut each stripe's slabs into segments of at most ``g`` =
    :func:`stripe_segment_slabs` of the plan's levels consecutive slabs, in
    plan order, sorted by stripe (a stripe of the rows with no slab gets
    one empty segment).
    Returns ``(segments, stripe_seg, slots)``: ``segments`` (S, 4) int32
    rows (stripe, first slab, slab count, scratch slot), the slot -1 for a
    stripe's only segment and else numbered in segment order;
    ``stripe_seg`` (stripes + 1,) int32, stripe k's segments being
    ``stripe_seg[k] .. stripe_seg[k + 1]``; ``slots`` the scratch slots
    used. Raises unless the slabs of each stripe are consecutive
    (``stripe_rb`` non-decreasing), which the kernel's one owner a stripe
    needs."""
    g = stripe_segment_slabs(plan.levels)
    if not 1 <= g <= 32:
        raise ValueError(f"segment length {g} must be in [1, 32]")
    lvl = plan.levels
    stripes = -(-plan.rows // (lvl * LANES))
    slab_stripe = plan.stripe_rb[: plan.num_slabs].astype(np.int64) // lvl
    if np.any(np.diff(slab_stripe) < 0) or (slab_stripe.size and (
            slab_stripe[0] < 0 or slab_stripe[-1] >= stripes)):
        raise ValueError("stripe plan: the slabs of a stripe must be consecutive, in stripe "
                         "order (stripe_rb non-decreasing, within the rows)")
    cnt = np.bincount(slab_stripe, minlength=stripes)
    lo = np.zeros(stripes, np.int64)
    np.cumsum(cnt[:-1], out=lo[1:])
    nseg = np.maximum(1, -(-cnt // g))
    stripe_seg = np.zeros(stripes + 1, np.int64)
    np.cumsum(nseg, out=stripe_seg[1:])
    seg_stripe = np.repeat(np.arange(stripes), nseg)
    k = np.arange(seg_stripe.size) - stripe_seg[:-1][seg_stripe]
    count = np.minimum(cnt[seg_stripe] - k * g, g)
    first = np.where(count > 0, lo[seg_stripe] + k * g, 0)
    multi = nseg[seg_stripe] > 1
    slot = np.full(seg_stripe.size, -1, np.int64)
    slot[multi] = np.arange(int(multi.sum()))
    segments = np.stack([seg_stripe, first, count, slot], axis=1).astype(np.int32)
    return segments, stripe_seg.astype(np.int32), int(multi.sum())


def _stripe_segment_arrays(plan, device) -> dict:
    """``segments``, ``stripe_seg`` (on ``device``), ``seg_slots`` and
    ``foreign_pad`` (whether a slab of a stripe other than 0 holds padding
    chunks, which the plain version scatters into stripe 0) of a stripe
    plan."""
    segments, stripe_seg, slots = stripe_segments(plan)
    chunks = plan.num_slabs * SUBLANES
    slab_stripe = plan.stripe_rb[: plan.num_slabs].astype(np.int64) // plan.levels
    foreign = np.repeat(slab_stripe, SUBLANES) != plan.chunk_stripe[:chunks]
    return dict(segments=_t(segments, device), stripe_seg=_t(stripe_seg, device),
                seg_slots=slots, foreign_pad=bool(foreign.any()))


def _prepare_stripe(arrs: dict, plan) -> kernels.PreparedLaunch:
    dev = arrs["vals"].device
    if "segments" not in arrs:
        arrs.update(_stripe_segment_arrays(plan, dev))
    lvl = plan.levels
    stripes = arrs["stripe_seg"].numel() - 1
    groups = -(-lvl // kernels.STRIPE_GROUP_LEVELS)
    arrs["seg_scratch"] = torch.empty((arrs["seg_slots"], lvl * LANES), dtype=torch.float32,
                                      device=dev)
    arrs["seg_tickets"] = torch.zeros(stripes * groups, dtype=torch.int32, device=dev)
    return kernels.prepare_stripe(
        arrs["vals"], arrs["lane"], arrs["ends"], arrs.get("starts"), arrs["col_off"],
        arrs["chunk_stripe"], arrs["rb_mask"], arrs["segments"], arrs["stripe_seg"],
        arrs["seg_scratch"], arrs["seg_tickets"], levels=lvl, cols=plan.cols, rows=plan.rows,
        foreign_pad=arrs["foreign_pad"])


def stripe_device_arrays(plan, device) -> dict:
    """A ``StripePlan``'s arrays on ``device``: ``vals`` (f32) and ``lane``
    (int8 or int16) as ``(chunks, 128)``; ``ends`` and, in scan mode,
    ``starts`` (int8) in the plan's ``(S, L, 8, 128)`` layout;
    ``stripe_rb`` (S,), ``col_off``/``chunk_stripe`` (chunks,) int32;
    ``rb_mask``; its segments (``segments``, ``stripe_seg``,
    ``seg_slots``, ``foreign_pad``; see :func:`stripe_segments`) and, on
    CUDA, ``launch``: the kernel's launch record, every array checked, with
    the ``seg_scratch`` slots and ``seg_tickets`` it owns (one launch at a
    time); ``spill``: the spill sub-plan's arrays."""
    chunks = plan.num_slabs * plan.vals.shape[1]
    arrs = dict(
        vals=_t(plan.vals.reshape(chunks, LANES), device),
        lane=_t(plan.lane.reshape(chunks, LANES), device),
        ends=_t(plan.ends, device),
        stripe_rb=_t(plan.stripe_rb[: plan.num_slabs].astype(np.int32), device),
        col_off=_t(plan.col_off[:chunks].astype(np.int32), device),
        chunk_stripe=_t(plan.chunk_stripe[:chunks].astype(np.int32), device),
        rb_mask=_t(plan.rb_mask, device),
        **_stripe_segment_arrays(plan, device),
    )
    if plan.starts is not None:
        arrs["starts"] = _t(plan.starts, device)
    if arrs["vals"].is_cuda:
        arrs["launch"] = _prepare_stripe(arrs, plan)
    if plan.spill is not None:
        arrs["spill"] = stripe_device_arrays(plan.spill, device)
    return arrs


def _stripe_gathers(arrs, x, *, cols: int, lvl: int, kw: int, scan: bool, own=None):
    """Per chunk and level the 128 gathers of one stripe plan, ``(chunks,
    L, 128)``: the run differences of the chunk's prefix sum (scan mode) or
    the selected products (select mode); a chunk where ``own`` is False
    gathers from zero products."""
    vals = arrs["vals"]
    s8 = vals.shape[0]
    lane = arrs["lane"].long()
    # (S, L, 8, 128) -> per chunk (S*8, L*128)
    ends = arrs["ends"].transpose(1, 2).reshape(s8, lvl * LANES).long()
    co = arrs["col_off"].long()
    c128 = -(-cols // LANES)
    xpad = torch.zeros((c128 + kw) * LANES, dtype=x.dtype, device=x.device)
    xpad[: x.shape[0]] = x
    x2d = xpad.reshape(c128 + kw, LANES)
    win = x2d[co[:, None] + torch.arange(kw, device=x.device)[None, :]].reshape(s8, kw * LANES)
    p = vals * torch.gather(win, 1, lane)
    if own is not None:
        p = torch.where(own[:, None], p, 0.0)
    if not scan:
        return torch.gather(p, 1, ends).reshape(s8, lvl, LANES)
    starts = arrs["starts"].transpose(1, 2).reshape(s8, lvl * LANES).long()
    c = torch.cumsum(p, dim=1)
    g = torch.gather(c, 1, ends) - torch.where(
        starts < 0, 0.0, torch.gather(c, 1, starts.clamp(min=0)))
    return g.reshape(s8, lvl, LANES)


def _stripe_torch(arrs, x, *, rows: int, cols: int, lvl: int, kw: int, scan: bool):
    """Plain PyTorch evaluation of one stripe plan (not its spill): the
    counterpart of ``_stripe_reference`` (window gather, product, cumsum in
    scan mode, per-level boundary gathers scatter-added at
    ``chunk_stripe * L + level``, empty blocks masked)."""
    g = _stripe_gathers(arrs, x, cols=cols, lvl=lvl, kw=kw, scan=scan)
    r128p = arrs["rb_mask"].shape[0]
    y2d = torch.zeros(r128p, LANES, dtype=arrs["vals"].dtype, device=x.device)
    rb0 = arrs["chunk_stripe"].long() * lvl
    for lv in range(lvl):
        y2d.index_add_(0, rb0 + lv, g[:, lv])
    y2d = torch.where(arrs["rb_mask"][:, None] > 0, y2d, 0.0)
    return y2d.reshape(-1)[:rows]


def _stripe_segments_torch(arrs, x, *, rows: int, cols: int, lvl: int, kw: int, scan: bool):
    """Plain PyTorch evaluation of one stripe plan (not its spill) over its
    segment arrays, in the kernel's order: per chunk the ``L * 128``
    gathers (zero for a slab's padding chunks of another stripe), added
    chunk by chunk within each segment, then segment by segment within each
    stripe, ``0 * x[0]`` on stripe 0 where ``foreign_pad``, masked row
    blocks 0; rows past ``rows`` dropped. The CPU tests hold it to
    :func:`_stripe_torch` and the JAX package; no call path uses it."""
    slab_stripe = arrs["stripe_rb"].long() // lvl
    own = arrs["chunk_stripe"].long() == slab_stripe.repeat_interleave(SUBLANES)
    g = _stripe_gathers(arrs, x, cols=cols, lvl=lvl, kw=kw, scan=scan, own=own)
    g = g.reshape(g.shape[0], lvl * LANES)
    seg = arrs["segments"].long()
    first, count = seg[:, 1] * SUBLANES, seg[:, 2] * SUBLANES
    acc = torch.zeros(seg.shape[0], lvl * LANES, dtype=g.dtype, device=x.device)
    for k in range(int(count.max()) if seg.shape[0] else 0):
        live = count > k
        acc[live] += g[first[live] + k]
    stripe_seg = arrs["stripe_seg"].long()
    nseg = stripe_seg[1:] - stripe_seg[:-1]
    y2d = torch.zeros(nseg.shape[0], lvl * LANES, dtype=g.dtype, device=x.device)
    for k in range(int(nseg.max()) if nseg.numel() else 0):
        live = nseg > k
        y2d[live] += acc[stripe_seg[:-1][live] + k]
    if arrs["foreign_pad"] and y2d.shape[0]:
        y2d[0] += 0.0 * (x[0] if cols > 0 else 0.0)
    y2d = y2d.reshape(-1, LANES)
    y2d = torch.where(arrs["rb_mask"][: y2d.shape[0], None] > 0, y2d, 0.0)
    return y2d.reshape(-1)[:rows]


def spmv_stripe(plan, x, *, device_arrays=None, allow_downcast=False):
    """``y = A @ x`` through the stripe kernel, which writes every row of a
    fresh y, and the same kernel in add mode on each spill sub-plan (CUDA
    ``x``; a plan with no slab launches nothing), or through the plain
    version (CPU ``x``). The reference's SMEM and VMEM refusals are not
    carried over: the kernel reads its indices and x from device memory."""
    x = _cast_x(x, plan.dtype, allow_downcast)
    arrs = device_arrays if device_arrays is not None else stripe_device_arrays(plan, x.device)
    if on_cuda(x):
        if plan.num_slabs == 0:  # no entry, so no spill either
            return torch.zeros(plan.rows, dtype=x.dtype, device=x.device)
        x = x.contiguous()
        y = torch.empty(plan.rows, dtype=x.dtype, device=x.device)
        _launch_record(_prepare_stripe, arrs, plan)(x, y)
        sp, sp_arrs = plan.spill, arrs.get("spill")
        while sp is not None:
            _launch_record(_prepare_stripe, sp_arrs, sp)(x, y, add=True)
            sp, sp_arrs = sp.spill, sp_arrs.get("spill")
        return y
    y = _stripe_torch(arrs, x, rows=plan.rows, cols=plan.cols, lvl=plan.levels,
                      kw=plan.kw, scan=plan.mode == "scan")
    if plan.spill is not None:
        y = y + spmv_stripe(plan.spill, x, device_arrays=arrs["spill"])
    return y


# ---------------------------------------------------------------------------
# ELL gather (plain PyTorch on every device)
# ---------------------------------------------------------------------------


def ell_from_csr(m: CsrMatrix, *, dtype=np.float32) -> Tuple[np.ndarray, np.ndarray]:
    """Pad rows to the max row length: (rows, W) vals + col indices.
    Pad slots point at column 0 with value 0."""
    row_nnz = np.diff(m.offsets)
    w = max(1, int(row_nnz.max())) if m.nnz() else 1
    ell_vals = np.zeros((m.rows, w), dtype=dtype)
    ell_cols = np.zeros((m.rows, w), dtype=np.int32)
    r = m.row_ids()
    k = np.arange(m.nnz()) - m.offsets[:-1].astype(np.int64)[r]
    ell_vals[r, k] = m.vals.astype(dtype)
    ell_cols[r, k] = m.indices.astype(np.int32)
    return ell_vals, ell_cols


def ell_spill_from_csr(m: CsrMatrix, *, dtype=np.float32, max_width: int = None):
    """Width-capped ELL + COO spill: rows keep their first ``max_width``
    entries in the ELL part and the tail of outlier rows spills to COO
    triplets. ``max_width=None`` takes twice the 99th-percentile row length.

    Returns ``(ell_vals, ell_cols, spill_rows, spill_cols, spill_vals)``.
    """
    row_nnz = np.diff(m.offsets)
    w_full = max(1, int(row_nnz.max())) if m.nnz() else 1
    if max_width is None:
        q = int(np.quantile(row_nnz, 0.99)) if m.nnz() else 1
        max_width = max(1, 2 * max(1, q))
    w = max(1, min(w_full, int(max_width)))
    r = m.row_ids()
    k = np.arange(m.nnz(), dtype=np.int64) - m.offsets[:-1].astype(np.int64)[r]
    in_ell = k < w
    ell_vals = np.zeros((m.rows, w), dtype=dtype)
    ell_cols = np.zeros((m.rows, w), dtype=np.int32)
    ell_vals[r[in_ell], k[in_ell]] = m.vals[in_ell].astype(dtype)
    ell_cols[r[in_ell], k[in_ell]] = m.indices[in_ell].astype(np.int32)
    sp = ~in_ell
    return (
        ell_vals,
        ell_cols,
        r[sp].astype(np.int32),
        m.indices[sp].astype(np.int32),
        m.vals[sp].astype(dtype),
    )


def spmv_ell(ell_vals, ell_cols, x):
    """``y = A @ x`` from the padded-ELL view: gather + row reduce."""
    return torch.sum(ell_vals * x[ell_cols.long()], dim=1)


def spmv_ell_spill(ell_vals, ell_cols, spill_rows, spill_cols, spill_vals, x):
    """Width-capped ELL SpMV + scatter-add of the (small) COO spill."""
    y = spmv_ell(ell_vals, ell_cols, x)
    return y.index_add(0, spill_rows.long(), spill_vals * x[spill_cols.long()])


U_F32 = 2.0 ** -24  # unit roundoff of float32


def _chunk_mass(vals, lane, col_off, cols: int, x: np.ndarray) -> np.ndarray:
    """Per chunk: the absolute mass ``sum |p|`` of its 128 products."""
    chunks = col_off.shape[0]
    v = vals.reshape(chunks, LANES).astype(np.float64)
    j = col_off[:, None].astype(np.int64) * LANES + lane.reshape(chunks, LANES)
    xg = np.where(j < cols, x[np.minimum(j, cols - 1)], 0.0)
    return np.abs(v * xg).sum(axis=1)


def _mass_by_run(row, chunk, run, mass, rows: int):
    """(per row: the summed mass of the chunks holding its runs, per row:
    whether it has a run). ``row``, ``chunk`` and ``run`` are per
    (chunk slot, destination) arrays of one shape."""
    n = max(rows, int(row.max()) + 1 if row.size else 0)
    per = np.bincount(row[run], weights=mass[chunk[run]], minlength=n)
    ran = np.bincount(row[run], minlength=n) > 0
    return per[:rows], ran[:rows]


def _lanepack_run_mass(plan: LanePackPlan, x: np.ndarray):
    chunks = plan.num_slabs * plan.vals.shape[1]
    mass = _chunk_mass(plan.vals, plan.lane, plan.col_off[:chunks], plan.cols, x)
    run = ((plan.ends != 0) | (plan.starts != 0)).reshape(chunks, LANES)
    row = plan.chunk_rb[:chunks, None].astype(np.int64) * LANES + np.arange(LANES)
    chunk = np.broadcast_to(np.arange(chunks)[:, None], run.shape)
    return _mass_by_run(row, chunk, run, mass, plan.rows)


def _stripe_run_mass(plan, x: np.ndarray):
    """The scan-mode counterpart of :func:`_lanepack_run_mass`: a level's
    run at (slab, level, sub, lane) is row ``(stripe_rb + level)*128 +
    lane``, summed from chunk ``slab*8 + sub``."""
    s, lvl = plan.num_slabs, plan.levels
    chunks = s * SUBLANES
    mass = _chunk_mass(plan.vals, plan.lane, plan.col_off[:chunks], plan.cols, x)
    run = (plan.ends != 0) | (plan.starts != 0)  # (S, L, 8, 128)
    rb = plan.stripe_rb[:s, None].astype(np.int64) + np.arange(lvl)  # (S, L)
    row = rb[:, :, None, None] * LANES + np.arange(LANES)[None, None, None, :]
    row = np.broadcast_to(row, run.shape)
    chunk = np.arange(chunks).reshape(s, 1, SUBLANES, 1)
    chunk = np.broadcast_to(chunk, run.shape)
    return _mass_by_run(row, chunk, run, mass, plan.rows)


def spmv_f64_bound(m: CsrMatrix, x, *, vals=None, lanepack=(), stripe=()):
    """``(y_f64, bound)``: the float64 CSR product ``A @ x`` and a per-row
    bound on the error of a float32 evaluation of it.

    A row summed from plain products has the bound ``(nnz_row + 1) * u *
    (|A||x|)_i`` (u = 2^-24): a sum of nnz_row rounded products in any
    order, which covers DIA, aligned, BELL and stripe in select mode, with
    or without atomics. ``lanepack`` lists the LanePack plans (or spill
    sub-plans) and ``stripe`` the stripe plans (with their spills) that
    take part; a row with a run in a prefix-summed chunk (every LanePack
    chunk, stripe chunks in scan mode) gets ``(2*128 + nnz_row) * u *
    ((|A||x|)_i + P_i)``, P_i being the mass of the chunks that hold its
    runs: a run sum is a difference of two prefix sums of its chunk, so
    its rounding error scales with that mass, not with the row's own
    products (ROADMAP.md C8). ``vals`` replaces the matrix values (e.g.
    their bf16 rounding, for bf16 value planes)."""
    x = np.asarray(x, dtype=np.float64)
    v = (m.vals if vals is None else vals).astype(np.float64)
    r = m.row_ids()
    prod = v * x[m.indices.astype(np.int64)]
    y = np.bincount(r, weights=prod, minlength=m.rows)
    mag = np.bincount(r, weights=np.abs(prod), minlength=m.rows)
    nnz_row = np.diff(m.offsets).astype(np.float64)
    plain = (nnz_row + 1) * U_F32 * mag
    scanned = [_lanepack_run_mass(p, x) for p in lanepack]
    scanned += [_stripe_run_mass(p, x) for s in stripe for p in _stripe_chain(s)
                if p.mode == "scan"]
    if not scanned:
        return y, plain
    mass = sum(ms for ms, _ in scanned)
    ran = np.logical_or.reduce([r_ for _, r_ in scanned])
    return y, np.where(ran, (2 * LANES + nnz_row) * U_F32 * (mag + mass), plain)


def spmv_oracle(m: CsrMatrix, x: np.ndarray) -> np.ndarray:
    """Host CSR row-loop oracle (float64 accumulation for float dtypes)."""
    y = np.zeros(m.rows, dtype=np.result_type(m.vals.dtype, x.dtype))
    for i in range(m.rows):
        lo, hi = int(m.offsets[i]), int(m.offsets[i + 1])
        acc = np.float64(0) if np.issubdtype(y.dtype, np.floating) else y.dtype.type(0)
        for kk in range(lo, hi):
            acc += m.vals[kk] * x[int(m.indices[kk])]
        y[i] = acc
    return y
