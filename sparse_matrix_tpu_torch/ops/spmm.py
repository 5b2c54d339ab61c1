"""SpMM: sparse matrix times a block of K dense columns (``A @ X``).

Counterpart of ``sparse_matrix_tpu/ops/spmm.py``. The packed multi-RHS
layout ``(c128 + guard, K, 128)`` (:func:`pack_rhs`) is kept where the
reference's callers hold it (the ``*_packed`` and ``*_matvec_multi``
entry points, ``cg_solve_multi(..., rhs_axis=1)``); the others take X
``(cols, K)`` and return Y ``(rows, K)``:

* :func:`spmm_aligned_packed`, :func:`aligned_matvec_multi` (packed) and
  :func:`spmm_aligned` (row-major X and Y, no relayout) — the aligned SpMM
  kernel (``csrc/spmm_aligned.cu``) on an ``AlignedPlan``, through the
  launch record of its device arrays (``spmm_launch``): one warp owns each
  row-block segment, Y from ``torch.empty``, no atomics; the plan's
  LanePack spill goes through the LanePack SpMM kernel in add mode, one
  launch for up to 16 columns;
* :func:`spmm_lanepack_packed`, :func:`lanepack_matvec_multi` (packed)
  and :func:`spmm_lanepack` (row-major X and Y, no relayout) — the
  LanePack SpMM kernel (``csrc/spmm_lanepack.cu``) on a ``LanePackPlan``,
  through the launch record of its device arrays (``spmm_launch``): one
  warp owns each row-block segment, Y from ``torch.empty``, no atomics;
  ``spmm_lanepack`` loops over columns through the SpMV kernel where the
  reference does (:func:`lanepack_spmm_uses_kernel`);
* :func:`spmm_bell` — the BELL SpMM kernel (``csrc/spmm_bell.cu``) on a
  ``BellPlan`` for 2 <= K <= 16 (:func:`bell_spmm_viable`), row-major X
  and Y through its launch record, plus the LanePack SpMM kernel on its
  spill in add mode;
* :func:`spmm_bcsr` — the BCSR SpMM kernel (``csrc/spmm_bcsr.cu``) on a
  ``BsrMatrix``: the stored blocks' products over the A-side live-depth
  stream of :func:`bcsr_depth_stream`, on the FP64 tensor cores;
* :func:`spmm_ell` — the padded-ELL gather, in plain PyTorch on every
  device (the reference leaves it to XLA).

A CUDA tensor launches the kernels; a CPU one takes the plain versions
:func:`_aligned_spmm_torch`, :func:`_lanepack_spmm_torch`,
:func:`_bell_spmm_torch` and :func:`_bcsr_torch`. The reference's TPU
limits are not carried over: its SMEM and VMEM refusals, its B-slab step
sizes and the K padding to multiples of 8 (sublane tiling).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import on_cuda
from ..native.kernels import BLOCK_TILE
from .spmv import (_launch_record, _prepare_aligned_spmm, _prepare_lanepack_spmm, _t,
                   aligned_device_arrays, lanepack_device_arrays, spmv_lanepack)

__all__ = [
    "pack_rhs",
    "unpack_rhs",
    "spmm_aligned_packed",
    "aligned_matvec_multi",
    "spmm_aligned",
    "spmm_lanepack_packed",
    "lanepack_matvec_multi",
    "spmm_lanepack",
    "lanepack_spmm_uses_kernel",
    "spmm_bell",
    "bell_spmm_viable",
    "tile_ranges",
    "tile_occupancy",
    "bcsr_depth_stream",
    "bcsr_live_flops",
    "bcsr_device_arrays",
    "spmm_bcsr",
    "spmm_ell",
]

LANES = 128


def pack_rhs(x, cols: int, guard: int = 1):
    """(cols, K) -> packed ``(c128 + guard, K, 128)``, zero padded; the one
    relayout per solve."""
    k = x.shape[1]
    c128 = -(-cols // LANES)
    xpad = torch.zeros((c128 * LANES, k), dtype=x.dtype, device=x.device)
    xpad[: x.shape[0]] = x
    x3 = xpad.reshape(c128, LANES, k).transpose(1, 2)
    return torch.cat([x3, torch.zeros((guard, k, LANES), dtype=x.dtype, device=x.device)])


def unpack_rhs(y3, rows: int):
    """Packed ``(r128[+pad], K, 128)`` -> (rows, K)."""
    return y3.transpose(1, 2).reshape(-1, y3.shape[1])[:rows]


def _check_x3(x3, cols: int, guard: int):
    """``x3`` packed float32 with at least ``c128 + guard`` window rows."""
    need = -(-cols // LANES) + guard
    if x3.dim() != 3 or x3.shape[2] != LANES or x3.shape[0] < need:
        raise ValueError(f"x3 must be packed (>= {need}, K, 128), got {tuple(x3.shape)}")
    if x3.dtype != torch.float32:
        raise TypeError(f"x3 has dtype {x3.dtype}, the plan is float32")
    return x3.contiguous()


# ---------------------------------------------------------------------------
# LanePack SpMM
# ---------------------------------------------------------------------------


def _lanepack_spmm_torch(arrs, x3, *, cols: int, kw: int):
    """Plain PyTorch LanePack SpMM, packed layout: the counterpart of
    ``_lanepack_spmm_reference`` (per chunk one ``kw``-row x window for all
    K, lane gather, product, cumsum over the chunk, run-boundary
    differences scatter-added by chunk row block, empty blocks masked).
    Reads x as zero past ``cols``, as the kernel does, so ``x3`` needs no
    guard rows. Returns (r128, K, 128)."""
    vals = arrs["vals"]
    n, k = vals.shape[0], x3.shape[1]
    c128 = -(-cols // LANES)
    xw = torch.cat([x3[:c128], x3.new_zeros((kw, k, LANES))])
    co = arrs["col_off"].long()
    win = xw[co[:, None] + torch.arange(kw, device=x3.device)[None, :]]  # (n, kw, K, 128)
    win = win.transpose(1, 2).reshape(n, k, kw * LANES)
    lane = arrs["lane"].long()
    inside = (co[:, None] * LANES + lane < cols)[:, None, :]
    xg = torch.gather(win, 2, lane[:, None, :].expand(-1, k, -1))
    c = torch.cumsum(vals[:, None, :] * torch.where(inside, xg, 0.0), dim=2)
    ends = arrs["ends"].long()[:, None, :].expand(-1, k, -1)
    starts = arrs["starts"].long()[:, None, :].expand(-1, k, -1)
    g_start = torch.where(starts < 0, 0.0, torch.gather(c, 2, starts.clamp(min=0)))
    contrib = torch.gather(c, 2, ends) - g_start
    r128 = arrs["rb_mask"].shape[0]
    y = torch.zeros((r128, k, LANES), dtype=vals.dtype, device=x3.device)
    y.index_add_(0, arrs["chunk_rb"].long(), contrib)
    return torch.where(arrs["rb_mask"][:, None, None] > 0, y, 0.0)


def _lanepack_spmm_into(plan, arrs, x, y, *, packed: bool, add: bool = False) -> None:
    """``y = A @ x``, or ``y += A @ x`` with ``add``, for a LanePack plan
    and its arrays: x and y packed (``(>= c128, K, 128)`` and ``(>= r128, K,
    128)``; x reads past ``cols`` give zero) or row-major ``(cols, K)`` and
    ``(rows, K)``. CUDA: the LanePack SpMM kernel through the arrays'
    launch record; store mode writes every row of y and, packed, zeros on
    y's row blocks past r128. CPU: the plain version."""
    if on_cuda(x):
        _launch_record(_prepare_lanepack_spmm, arrs, plan, key="spmm_launch")(
            x, y, packed=packed, add=add)
        return
    x3 = x if packed else pack_rhs(x, plan.cols, guard=0)
    y3 = _lanepack_spmm_torch(arrs, x3, cols=plan.cols, kw=plan.kw)
    if not packed:
        y3 = unpack_rhs(y3, plan.rows)
    elif not add:
        y[y3.shape[0]:] = 0
    out = y[: y3.shape[0]]
    if add:
        out += y3
    else:
        out.copy_(y3)


def spmm_lanepack_packed(plan, x3, *, device_arrays=None):
    """``Y = A @ X`` on a ``LanePackPlan``, packed layout in and out:
    ``x3`` is (c128 + guard, K, 128) for any guard (``pack_rhs`` with
    ``guard=plan.kw`` gives the reference's), the result (r128, K, 128),
    allocated with ``torch.empty`` and written whole."""
    x3 = _check_x3(x3, plan.cols, 0)
    arrs = device_arrays if device_arrays is not None else lanepack_device_arrays(plan, x3.device)
    y3 = torch.empty((plan.r128, x3.shape[1], LANES), dtype=x3.dtype, device=x3.device)
    _lanepack_spmm_into(plan, arrs, x3, y3, packed=True)
    return y3


def lanepack_matvec_multi(plan, k: int, device, *, device_arrays=None):
    """Packed-layout multi-RHS matvec of a square LanePack plan: maps
    (c128 + kw, K, 128) to the same shape (guard rows zero, written by the
    kernel), for ``cg_solve_multi(..., rhs_axis=1)``. Device arrays are
    built once."""
    if plan.rows != plan.cols:
        raise ValueError("packed multi-RHS matvec needs a square operator")
    arrs = device_arrays if device_arrays is not None else lanepack_device_arrays(plan, device)

    def mv(x3):
        x3 = _check_x3(x3, plan.cols, plan.kw)
        if x3.shape[1] != k:
            raise ValueError(f"x3 has {x3.shape[1]} columns, the matvec was built for {k}")
        y3 = torch.empty_like(x3)
        _lanepack_spmm_into(plan, arrs, x3, y3, packed=True)
        return y3

    return mv


# the reference's kernel-vs-loop rule for LanePack matmat (measured on its
# TPU, kept so that the port routes as the reference does)
_LP_SPMM_MIN_K = 8
_LP_SPMM_LOOP_MIN_SLABS = 512


def lanepack_spmm_uses_kernel(plan, k: int) -> bool:
    """True where the reference's LanePack matmat runs its packed SpMM
    kernel (K >= 8, or a plan under 512 slabs) instead of a column loop."""
    return k >= _LP_SPMM_MIN_K or plan.num_slabs < _LP_SPMM_LOOP_MIN_SLABS


def _check_x(x, cols: int):
    """``x`` a float32 (cols, K) block; returned contiguous."""
    if x.dim() != 2 or x.shape[0] != cols:
        raise ValueError(f"x must be ({cols}, K), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x has dtype {x.dtype}, the plan is float32")
    return x.contiguous()


def spmm_lanepack(plan, x, *, device_arrays=None):
    """``Y = A @ X`` for ``X`` (cols, K) on a ``LanePackPlan``: the
    LanePack SpMM kernel on X and Y as they are, row-major (no packing),
    where :func:`lanepack_spmm_uses_kernel`, else a column loop through
    the LanePack SpMV kernel. The exact K is passed (no padding to
    multiples of 8)."""
    arrs = device_arrays if device_arrays is not None else lanepack_device_arrays(plan, x.device)
    k = int(x.shape[1])
    if not lanepack_spmm_uses_kernel(plan, k):
        return torch.stack([spmv_lanepack(plan, x[:, j], device_arrays=arrs) for j in range(k)],
                           dim=1)
    x = _check_x(x, plan.cols)
    y = torch.empty((plan.rows, k), dtype=x.dtype, device=x.device)
    _lanepack_spmm_into(plan, arrs, x, y, packed=False)
    return y


# ---------------------------------------------------------------------------
# Aligned SpMM
# ---------------------------------------------------------------------------


def _aligned_spmm_torch(arrs, x3, *, rows: int):
    """Plain PyTorch aligned SpMM, packed layout: the counterpart of
    ``_aligned_spmm_reference`` (per chunk one x window for all K, lane
    gather, products scatter-added by chunk row block, empty blocks
    masked). Returns (r128, K, 128)."""
    vals = arrs["vals"]
    k = x3.shape[1]
    lane = arrs["lane"].long()[:, None, :].expand(-1, k, -1)
    xw = x3[arrs["col_off"].long()]  # (chunks, K, 128)
    p = vals[:, None, :] * torch.gather(xw, 2, lane)
    r128 = arrs["rb_mask"].shape[0]
    y = torch.zeros((r128, k, LANES), dtype=vals.dtype, device=x3.device)
    y.index_add_(0, arrs["chunk_rb"].long(), p)
    return torch.where(arrs["rb_mask"][:, None, None] > 0, y, 0.0)


def _spmm_aligned_into(plan, arrs, x, y, *, packed: bool) -> None:
    """``y = A @ x`` for an aligned plan and its arrays: x and y packed
    (``(>= c128 + 1, K, 128)`` and ``(>= r128, K, 128)``) or row-major
    ``(cols, K)`` and ``(rows, K)``. CUDA: the aligned SpMM kernel through
    the arrays' launch record, which writes every row of y (packed: and
    zeros on y's row blocks past r128); CPU: the plain version. The
    LanePack spill then adds through the LanePack SpMM kernel, one launch
    for up to 16 columns (its x-window reads past ``cols`` give zero)."""
    if on_cuda(x):
        _launch_record(_prepare_aligned_spmm, arrs, plan, key="spmm_launch")(x, y, packed=packed)
    else:
        y3 = _aligned_spmm_torch(arrs, x if packed else pack_rhs(x, plan.cols), rows=plan.rows)
        if packed:
            y[: plan.r128] = y3
            y[plan.r128:] = 0
        else:
            y.copy_(unpack_rhs(y3, plan.rows))
    if plan.spill is not None:
        _lanepack_spmm_into(plan.spill, arrs["spill"], x, y, packed=packed, add=True)


def spmm_aligned_packed(plan, x3, *, device_arrays=None):
    """``Y = A @ X`` on an ``AlignedPlan``, packed layout in and out:
    ``x3`` is (c128 + 1, K, 128), the result (r128, K, 128), allocated with
    ``torch.empty`` and written whole."""
    x3 = _check_x3(x3, plan.cols, 1)
    arrs = device_arrays if device_arrays is not None else aligned_device_arrays(plan, x3.device)
    y3 = torch.empty((plan.r128, x3.shape[1], LANES), dtype=x3.dtype, device=x3.device)
    _spmm_aligned_into(plan, arrs, x3, y3, packed=True)
    return y3


def aligned_matvec_multi(plan, k: int, device, *, device_arrays=None):
    """Packed-layout multi-RHS matvec of a square aligned plan: maps
    (c128 + 1, K, 128) to the same shape (guard row zero, written by the
    kernel), for ``cg_solve_multi(..., rhs_axis=1)``. Device arrays are
    built once."""
    if plan.rows != plan.cols:
        raise ValueError("packed multi-RHS matvec needs a square operator")
    arrs = device_arrays if device_arrays is not None else aligned_device_arrays(plan, device)

    def mv(x3):
        x3 = _check_x3(x3, plan.cols, 1)
        if x3.shape[1] != k:
            raise ValueError(f"x3 has {x3.shape[1]} columns, the matvec was built for {k}")
        y3 = torch.empty_like(x3)
        _spmm_aligned_into(plan, arrs, x3, y3, packed=True)
        return y3

    return mv


def spmm_aligned(plan, x, *, device_arrays=None):
    """``Y = A @ X`` for ``X`` (cols, K) through the aligned SpMM kernel on X
    and Y as they are, row-major (no packing on the card), and the
    LanePack SpMM kernel on the spill in add mode."""
    x = _check_x(x, plan.cols)
    arrs = device_arrays if device_arrays is not None else aligned_device_arrays(plan, x.device)
    y = torch.empty((plan.rows, int(x.shape[1])), dtype=x.dtype, device=x.device)
    _spmm_aligned_into(plan, arrs, x, y, packed=False)
    return y


# ---------------------------------------------------------------------------
# BELL SpMM
# ---------------------------------------------------------------------------


def bell_spmm_viable(plan, k: int) -> bool:
    """The BELL SpMM kernel's gate: 2 <= K <= 16 (its register
    accumulators). The reference also refuses plans whose resident x and
    slot planes overflow its VMEM budget (``_bell_spmm_pick_br``); the
    H100 kernel reads both from device memory and has no such wall."""
    return 2 <= k <= 16


def _bell_spmm_x3(x, *, cols: int, lo: int, hi: int):
    """(cols, K) -> packed ``(lo + c128 + hi, K, 128)``, zero rows around."""
    x3 = pack_rhs(x, cols, guard=hi)
    return torch.cat([x3.new_zeros((lo, x.shape[1], LANES)), x3])


def _bell_spmm_torch(vals, lane, x, *, ds: tuple, modes: tuple, span: int, cols: int):
    """Plain PyTorch BELL SpMM: the counterpart of the interpret branch of
    ``_spmm_bell_jit`` (per layer and used 128-half, a static slice of the
    zero-padded packed x, a batched lane gather, halves merged by the
    slot's half, one multiply-add). Returns the packed (r128, K, 128)."""
    r128 = vals.shape[1]
    k = x.shape[1]
    c128 = -(-cols // LANES)
    nh = span // 128 + 1
    lo = max(0, -min(ds))
    total = max(lo + r128 + max(max(ds) + nh - 1, 0), lo + c128)
    x3 = _bell_spmm_x3(x, cols=cols, lo=lo, hi=total - lo - c128)
    bias = LANES if span == 128 else 0  # int8 lanes store pos - 128
    y3 = torch.zeros((r128, k, LANES), dtype=x.dtype, device=x.device)
    for li, (d, mask) in enumerate(zip(ds, modes)):
        pos = lane[li].to(torch.int32) + bias
        idx = torch.bitwise_and(pos, 127).long()[:, None, :].expand(-1, k, -1)
        half = torch.bitwise_right_shift(pos, 7)[:, None, :]
        xg = None
        for h in range(nh):
            if not (mask >> h) & 1:
                continue
            g = torch.gather(x3[lo + d + h : lo + d + h + r128], 2, idx)
            xg = g if xg is None else torch.where(half == h, g, xg)
        y3 = y3 + vals[li].to(x.dtype)[:, None, :] * xg
    return y3


def spmm_bell(plan, x, *, device_arrays=None):
    """``Y = A @ X`` for ``X`` (cols, K) on a ``BellPlan``: one pass over
    the slot planes for all K columns through the BELL SpMM kernel, which
    reads X and writes Y (rows, K) as they are, row-major, then the
    LanePack SpMM kernel adds the spill sub-plan onto Y (CUDA); or their
    plain versions (CPU). bf16 value planes are widened and accumulated
    in f32."""
    from .spmv_bell import _prepare_bell_spmm, bell_device_arrays

    k = int(x.shape[1]) if x.dim() == 2 else 0
    if not bell_spmm_viable(plan, k):
        raise ValueError(f"spmm_bell takes 2 <= K <= 16 columns, got K={k}: chunk K or "
                         "loop over columns with spmv_bell")
    x = _check_x(x, plan.cols)
    arrs = device_arrays if device_arrays is not None else bell_device_arrays(plan, x.device)
    if on_cuda(x):
        y = torch.empty((plan.rows, k), dtype=x.dtype, device=x.device)
        _launch_record(_prepare_bell_spmm, arrs, plan, key="spmm_launch")(x, y)
        if plan.spill is not None:
            _lanepack_spmm_into(plan.spill, arrs["spill"], x, y, packed=False, add=True)
        return y
    if plan.num_layers:
        y3 = _bell_spmm_torch(arrs["vals"], arrs["lane"], x, ds=plan.ds, modes=plan.modes,
                              span=plan.span, cols=plan.cols)
    else:
        y3 = torch.zeros((plan.r128, k, LANES), dtype=x.dtype, device=x.device)
    if plan.spill is not None:
        y3 = y3 + _lanepack_spmm_torch(arrs["spill"], pack_rhs(x, plan.cols), cols=plan.cols,
                                       kw=plan.spill.kw)
    return unpack_rhs(y3, plan.rows)


# ---------------------------------------------------------------------------
# BCSR SpMM
# ---------------------------------------------------------------------------

# the BCSR kernel's column tile: X and Y are padded to a multiple of it
BCSR_COL_TILE = 128


def tile_ranges(bs: int) -> list:
    """The ``[lo, hi)`` ranges of a block's BLOCK_TILE-wide output tiles."""
    return [(t, min(t + BLOCK_TILE, bs)) for t in range(0, bs, BLOCK_TILE)]


def tile_occupancy(blocks: torch.Tensor):
    """``(nonzero, nonfinite)``, each ``(n, bs, tiles)`` bool: whether row
    k of block i holds a nonzero value (an inf or NaN is one), and whether
    it holds an inf or NaN, within each output tile's columns
    (:func:`tile_ranges`)."""
    ranges = tile_ranges(blocks.shape[-1])
    return (torch.stack([(blocks[..., a:b] != 0).any(-1) for a, b in ranges], -1),
            torch.stack([~torch.isfinite(blocks[..., a:b]).all(-1) for a, b in ranges], -1))


def _segment_offsets(segment: torch.Tensor, segments: int) -> torch.Tensor:
    """(segments + 1,) int32 offsets of the rows of each segment id in the
    sorted ``segment``."""
    off = torch.zeros(segments + 1, dtype=torch.int64, device=segment.device)
    off[1:] = torch.cumsum(torch.bincount(segment, minlength=segments), 0)
    return off.to(torch.int32)


def bcsr_depth_stream(blocks_t, block_cols, block_offsets):
    """The A-side live-depth stream of the BCSR SpMM kernel, built on the
    blocks' device from their stored values.

    A block row's depth is its stored blocks' columns laid end to end. For
    each block row and each output tile of its rows (:data:`BLOCK_TILE`),
    in block order and then column order, the stream keeps the rows ``(p *
    bs + k, block_cols[p] * bs + k)`` of the transposed blocks
    ``blocks_t`` (viewed as ``(nnzb * bs, bs)``) and of X for every column
    k of block p that holds a nonzero (an inf or NaN is one) in the tile's
    rows. X arrives with each call, so the kernel takes this stream only
    when X is finite (``0 * inf`` is NaN), and else every column of every
    block.

    Returns ``(stream, offsets)``: ``(L, 2)`` int32 row pairs and
    ``(brows * tiles + 1,)`` int32 offsets of the rows of each (block row,
    row tile), tiles = ``len(tile_ranges(bs))``.
    """
    bs = blocks_t.shape[-1]
    tiles = len(tile_ranges(bs))
    brows = block_offsets.numel() - 1
    live, _ = tile_occupancy(blocks_t)
    p, k, tm = torch.nonzero(live, as_tuple=True)  # row-major: block, column, tile
    brow = torch.repeat_interleave(torch.arange(brows, device=live.device),
                                   torch.diff(block_offsets.long()))
    segment, order = torch.sort(brow[p] * tiles + tm, stable=True)
    p, k = p[order], k[order]
    stream = torch.stack((p * bs + k, block_cols.long()[p] * bs + k), 1).to(torch.int32)
    return stream, _segment_offsets(segment, brows * tiles)


def bcsr_live_flops(arrs, f: int) -> float:
    """The work the BCSR kernel does over its live stream (``arrs`` from
    :func:`bcsr_device_arrays`) on F columns: ``2 * m * F`` flops per
    stream row of an m-row tile."""
    ext = [hi - lo for lo, hi in tile_ranges(arrs["blocks_t"].shape[-1])]
    rows = arrs["stream_offsets"].diff().long().reshape(-1, len(ext)).sum(0).tolist()
    return 2.0 * f * sum(r * e for r, e in zip(rows, ext))


def bcsr_device_arrays(m, device) -> dict:
    """A ``BsrMatrix``'s arrays on ``device``: ``blocks_t`` (nnzb, bs, bs)
    f32, the blocks transposed (the kernel's operand) and ``blocks`` its
    row-major view; ``block_cols`` and ``block_offsets`` int32;
    ``block_rows`` (int64, one per block, for the plain version); the
    live-depth stream ``stream``/``stream_offsets``
    (:func:`bcsr_depth_stream`) and, on CUDA, ``launch``: the BCSR SpMM
    kernel's launch record (``native.kernels.prepare_bcsr_spmm``)."""
    if m.nnzb >= 1 << 31:
        raise ValueError(f"{m.nnzb} blocks: the kernel indexes blocks with int32")
    blocks_t = _t(m.blocks.astype(np.float32, copy=False), device).transpose(1, 2).contiguous()
    arrs = dict(
        blocks_t=blocks_t,
        blocks=blocks_t.transpose(1, 2),
        block_cols=_t(m.block_cols.astype(np.int32), device),
        block_offsets=_t(m.block_offsets.astype(np.int32), device),
        block_rows=_t(m.block_rows_expanded(), device),
    )
    arrs["stream"], arrs["stream_offsets"] = bcsr_depth_stream(
        blocks_t, arrs["block_cols"], arrs["block_offsets"])
    if blocks_t.is_cuda:
        arrs["launch"] = _prepare_bcsr(arrs, m)
    return arrs


def _prepare_bcsr(arrs, m):
    from ..native.kernels import prepare_bcsr_spmm

    return prepare_bcsr_spmm(arrs["blocks_t"], arrs["block_cols"], arrs["block_offsets"],
                             arrs["stream"], arrs["stream_offsets"])


def _bcsr_torch(arrs, x3, *, brows: int):
    """Plain PyTorch BCSR SpMM: the counterpart of the reference's CPU
    branch (one batched dense block product per stored block,
    scatter-added by block row; block rows with no block stay zero), in
    float64 and rounded to f32 once, as the kernel does. ``x3`` is (bcols,
    bs, F); returns (brows, bs, F)."""
    prods = torch.einsum("pij,pjk->pik", arrs["blocks"].double(),
                         x3[arrs["block_cols"].long()].double())
    y = torch.zeros((brows,) + tuple(x3.shape[1:]), dtype=torch.float64, device=x3.device)
    return y.index_add_(0, arrs["block_rows"], prods).float()


def _bcsr_stream_torch(arrs, xf, *, brows: int, x_finite: bool):
    """Plain evaluation of the kernel's depth walk on ``xf`` (bcols * bs,
    F): the live stream when ``x_finite`` (row tile t of block row br sums
    ``outer(A^T row, X row)`` over its segment's rows, restricted to the
    tile's rows), else every column of every block for all rows; in
    float64, rounded to f32 once. Returns (brows * bs, F). The tests hold
    the stream to :func:`_bcsr_torch` with it; the main path never calls
    it."""
    blocks_t = arrs["blocks_t"]
    nnzb, bs = blocks_t.shape[0], blocks_t.shape[-1]
    dev = xf.device
    if x_finite:
        rows, offsets = arrs["stream"].long(), arrs["stream_offsets"].long()
        ranges = tile_ranges(bs)
    else:
        ia = torch.arange(nnzb * bs, device=dev)
        rows = torch.stack((ia, arrs["block_cols"].long()[ia // bs] * bs + ia % bs), 1)
        offsets = arrs["block_offsets"].long() * bs
        ranges = [(0, bs)]
    segment = torch.repeat_interleave(torch.arange(offsets.numel() - 1, device=dev),
                                      torch.diff(offsets))
    a_rows = blocks_t.reshape(-1, bs).double()
    y = torch.zeros((brows, bs, xf.shape[1]), dtype=torch.float64, device=dev)
    step = max(1, (1 << 22) // (bs * xf.shape[1]))  # 32 MB of outer products a step
    for t, (lo, hi) in enumerate(ranges):
        sel = segment % len(ranges) == t
        r, owner = rows[sel], segment[sel] // len(ranges)
        out = y[:, lo:hi]
        for s in range(0, r.shape[0], step):
            rr = r[s:s + step]
            out.index_add_(0, owner[s:s + step],
                           a_rows[rr[:, 0], lo:hi][:, :, None] * xf[rr[:, 1]].double()[:, None, :])
    return y.reshape(brows * bs, -1).float()


def _kernel_x(m, x):
    """X as the BCSR kernel reads it: ``(bcols * bs, F rounded up to``
    :data:`BCSR_COL_TILE` ``)``, contiguous, its data 16-byte aligned (the
    kernel copies it in 16-byte pieces). X itself when it already is that,
    else a zero-padded copy."""
    f = int(x.shape[1])
    fpad = max(BCSR_COL_TILE, -(-f // BCSR_COL_TILE) * BCSR_COL_TILE)
    if x.shape == (m.bcols * m.bs, fpad) and x.is_contiguous() and x.data_ptr() % 16 == 0:
        return x
    xf = torch.zeros((m.bcols * m.bs, fpad), dtype=x.dtype, device=x.device)
    xf[: m.cols, :f] = x
    return xf


def spmm_bcsr(m, x, *, device_arrays=None):
    """``Y = A @ X`` for a ``BsrMatrix`` and ``X`` (cols, F) float32: the
    BCSR SpMM kernel (CUDA) or its plain version (CPU), summed in float64
    and rounded to f32 once (no TF32). X is padded to (bcols * bs, F
    rounded up to :data:`BCSR_COL_TILE`) unless it already has that shape
    (:func:`_kernel_x`); block rows with no block give zeros. On CUDA one
    device reduction, the sum of X, tells the kernel whether X is finite
    (its depth skip holds only then), with no host read."""
    if x.dim() != 2 or x.shape[0] != m.cols:
        raise ValueError(f"x must be ({m.cols}, F), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x has dtype {x.dtype}, the blocks are float32")
    arrs = device_arrays if device_arrays is not None else bcsr_device_arrays(m, x.device)
    f = int(x.shape[1])
    xf = _kernel_x(m, x)
    fpad = xf.shape[1]
    if on_cuda(x):
        y = torch.empty((m.brows * m.bs, fpad), dtype=x.dtype, device=x.device)
        _launch_record(_prepare_bcsr, arrs, m)(xf.sum(), xf, y)
    else:
        y = _bcsr_torch(arrs, xf.reshape(m.bcols, m.bs, fpad), brows=m.brows)
        y = y.reshape(m.brows * m.bs, fpad)
    return y[: m.rows, :f]


def spmm_ell(ell_vals, ell_cols, x):
    """``Y = A @ X`` from the padded-ELL view: one row gather of X per
    slot, reused across the K columns."""
    return torch.einsum("rw,rwk->rk", ell_vals, x[ell_cols.long()])
