"""SpMM: sparse matrix times a block of K dense columns (``A @ X``).

Counterpart of ``sparse_matrix_tpu/ops/spmm.py``. The general formats keep
the right-hand sides in the packed layout ``(c128 + guard, K, 128)``
(:func:`pack_rhs`), in which one x-window load of a chunk serves all K
columns:

* :func:`spmm_aligned_packed`, :func:`aligned_matvec_multi`,
  :func:`spmm_aligned` — the aligned SpMM kernel (``csrc/spmm_aligned.cu``)
  on an ``AlignedPlan``; the plan's LanePack spill goes through the
  LanePack SpMM kernel, one launch for all K columns;
* :func:`spmm_lanepack_packed`, :func:`lanepack_matvec_multi`,
  :func:`spmm_lanepack` — the LanePack SpMM kernel
  (``csrc/spmm_lanepack.cu``) on a ``LanePackPlan``; ``spmm_lanepack``
  loops over columns through the SpMV kernel where the reference does
  (:func:`lanepack_spmm_uses_kernel`);
* :func:`spmm_bell` — the BELL SpMM kernel (``csrc/spmm_bell.cu``) on a
  ``BellPlan`` for 2 <= K <= 16 (:func:`bell_spmm_viable`), plus the
  LanePack SpMM kernel on its spill;
* :func:`spmm_bcsr` — the BCSR SpMM kernel (``csrc/spmm_bcsr.cu``) on a
  ``BsrMatrix``: one dense block product per stored block;
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
from .spmv import _t, aligned_device_arrays, lanepack_device_arrays, spmv_lanepack

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


def _lanepack_spmm_into(arrs, x3, y3, *, cols: int, kw: int) -> None:
    """``y3[:r128] += A @ x3`` for a LanePack plan's arrays, through the
    LanePack SpMM kernel (CUDA) or its plain version (CPU). ``x3`` needs
    only ``c128`` window rows: reads past ``cols`` give zero."""
    if on_cuda(x3):
        from ..native.kernels import launch_lanepack_spmm

        launch_lanepack_spmm(arrs["vals"], arrs["lane"], arrs["ends"], arrs["starts"],
                             arrs["col_off"], arrs["chunk_rb"], x3, y3, cols=cols)
    else:
        y = _lanepack_spmm_torch(arrs, x3, cols=cols, kw=kw)
        y3[: y.shape[0]] += y


def spmm_lanepack_packed(plan, x3, *, device_arrays=None):
    """``Y = A @ X`` on a ``LanePackPlan``, packed layout in and out:
    ``x3`` is (c128 + guard, K, 128) for any guard (``pack_rhs`` with
    ``guard=plan.kw`` gives the reference's), the result (r128, K, 128)."""
    x3 = _check_x3(x3, plan.cols, 0)
    arrs = device_arrays if device_arrays is not None else lanepack_device_arrays(plan, x3.device)
    y3 = torch.zeros((plan.r128, x3.shape[1], LANES), dtype=x3.dtype, device=x3.device)
    _lanepack_spmm_into(arrs, x3, y3, cols=plan.cols, kw=plan.kw)
    return y3


def lanepack_matvec_multi(plan, k: int, device, *, device_arrays=None):
    """Packed-layout multi-RHS matvec of a square LanePack plan: maps
    (c128 + kw, K, 128) to the same shape (guard rows zero), for
    ``cg_solve_multi(..., rhs_axis=1)``. Device arrays are built once."""
    if plan.rows != plan.cols:
        raise ValueError("packed multi-RHS matvec needs a square operator")
    arrs = device_arrays if device_arrays is not None else lanepack_device_arrays(plan, device)

    def mv(x3):
        x3 = _check_x3(x3, plan.cols, plan.kw)
        if x3.shape[1] != k:
            raise ValueError(f"x3 has {x3.shape[1]} columns, the matvec was built for {k}")
        y3 = torch.zeros_like(x3)
        _lanepack_spmm_into(arrs, x3, y3, cols=plan.cols, kw=plan.kw)
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


def spmm_lanepack(plan, x, *, device_arrays=None):
    """``Y = A @ X`` for ``X`` (cols, K) on a ``LanePackPlan``: the packed
    LanePack SpMM kernel where :func:`lanepack_spmm_uses_kernel`, else a
    column loop through the LanePack SpMV kernel. The exact K is passed
    (no padding to multiples of 8)."""
    arrs = device_arrays if device_arrays is not None else lanepack_device_arrays(plan, x.device)
    k = int(x.shape[1])
    if not lanepack_spmm_uses_kernel(plan, k):
        return torch.stack([spmv_lanepack(plan, x[:, j], device_arrays=arrs) for j in range(k)],
                           dim=1)
    y3 = spmm_lanepack_packed(plan, pack_rhs(x, plan.cols, guard=plan.kw), device_arrays=arrs)
    return unpack_rhs(y3, plan.rows)


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


def _spmm_aligned_into(plan, arrs, x3, y3) -> None:
    """``y3[:r128] += A @ x3`` (packed); ``y3`` zeroed by the caller. The
    LanePack spill runs through the LanePack SpMM kernel, one launch for
    all K columns; its x-window reads past ``cols`` give zero, so the
    aligned layout's single guard row is enough."""
    if on_cuda(x3):
        from ..native.kernels import launch_aligned_spmm

        launch_aligned_spmm(arrs["vals"], arrs["lane"], arrs["col_off"], arrs["chunk_rb"],
                            x3, y3, cols=plan.cols)
    else:
        y3[: plan.r128] += _aligned_spmm_torch(arrs, x3, rows=plan.rows)
    if plan.spill is not None:
        _lanepack_spmm_into(arrs["spill"], x3, y3, cols=plan.cols, kw=plan.spill.kw)


def spmm_aligned_packed(plan, x3, *, device_arrays=None):
    """``Y = A @ X`` on an ``AlignedPlan``, packed layout in and out:
    ``x3`` is (c128 + 1, K, 128), the result (r128, K, 128)."""
    x3 = _check_x3(x3, plan.cols, 1)
    arrs = device_arrays if device_arrays is not None else aligned_device_arrays(plan, x3.device)
    y3 = torch.zeros((plan.r128, x3.shape[1], LANES), dtype=x3.dtype, device=x3.device)
    _spmm_aligned_into(plan, arrs, x3, y3)
    return y3


def aligned_matvec_multi(plan, k: int, device, *, device_arrays=None):
    """Packed-layout multi-RHS matvec of a square aligned plan: maps
    (c128 + 1, K, 128) to the same shape (guard row zero), for
    ``cg_solve_multi(..., rhs_axis=1)``. Device arrays are built once."""
    if plan.rows != plan.cols:
        raise ValueError("packed multi-RHS matvec needs a square operator")
    arrs = device_arrays if device_arrays is not None else aligned_device_arrays(plan, device)

    def mv(x3):
        x3 = _check_x3(x3, plan.cols, 1)
        if x3.shape[1] != k:
            raise ValueError(f"x3 has {x3.shape[1]} columns, the matvec was built for {k}")
        y3 = torch.zeros_like(x3)
        _spmm_aligned_into(plan, arrs, x3, y3)
        return y3

    return mv


def spmm_aligned(plan, x, *, device_arrays=None):
    """``Y = A @ X`` for ``X`` (cols, K) through the aligned SpMM kernel;
    one relayout each way."""
    y3 = spmm_aligned_packed(plan, pack_rhs(x, plan.cols), device_arrays=device_arrays)
    return unpack_rhs(y3, plan.rows)


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
    the slot planes for all K columns through the BELL SpMM kernel, plus
    the LanePack SpMM kernel on the spill sub-plan, both into one packed
    y. bf16 value planes are widened and accumulated in f32."""
    from .spmv_bell import bell_device_arrays

    k = int(x.shape[1])
    if not bell_spmm_viable(plan, k):
        raise ValueError(f"spmm_bell takes 2 <= K <= 16 columns, got K={k}: chunk K or "
                         "loop over columns with spmv_bell")
    if x.dtype != torch.float32:
        raise TypeError(f"x has dtype {x.dtype}, the plan is float32")
    arrs = device_arrays if device_arrays is not None else bell_device_arrays(plan, x.device)
    x3 = pack_rhs(x, plan.cols)
    if on_cuda(x):
        from ..native.kernels import launch_bell_spmm

        y3 = torch.empty((plan.r128, k, LANES), dtype=x.dtype, device=x.device)
        launch_bell_spmm(arrs["vals"], arrs["lane"], arrs["ds"], x3, y3,
                         bias=LANES if plan.span == 128 else 0, cols=plan.cols)
    elif plan.num_layers:
        y3 = _bell_spmm_torch(arrs["vals"], arrs["lane"], x, ds=plan.ds, modes=plan.modes,
                              span=plan.span, cols=plan.cols)
    else:
        y3 = torch.zeros((plan.r128, k, LANES), dtype=x.dtype, device=x.device)
    if plan.spill is not None:
        _lanepack_spmm_into(arrs["spill"], x3, y3, cols=plan.cols, kw=plan.spill.kw)
    return unpack_rhs(y3, plan.rows)


# ---------------------------------------------------------------------------
# BCSR SpMM
# ---------------------------------------------------------------------------

# the BCSR kernel's column tile: X and Y are padded to a multiple of it
BCSR_COL_TILE = 128


def bcsr_device_arrays(m, device) -> dict:
    """A ``BsrMatrix``'s arrays on ``device``: ``blocks`` (nnzb, bs, bs)
    f32, ``block_cols`` and ``block_offsets`` int32, ``block_rows``
    (int64, one per block, for the plain version)."""
    if m.nnzb >= 1 << 31:
        raise ValueError(f"{m.nnzb} blocks: the kernel indexes blocks with int32")
    return dict(
        blocks=_t(m.blocks.astype(np.float32, copy=False), device),
        block_cols=_t(m.block_cols.astype(np.int32), device),
        block_offsets=_t(m.block_offsets.astype(np.int32), device),
        block_rows=_t(m.block_rows_expanded(), device),
    )


def _bcsr_torch(arrs, x3, *, brows: int):
    """Plain PyTorch BCSR SpMM: the counterpart of the reference's CPU
    branch (one batched block product per stored block, scatter-added by
    block row; block rows with no block stay zero). ``x3`` is
    (bcols, bs, F); returns (brows, bs, F)."""
    blocks = arrs["blocks"]
    prods = torch.einsum("pij,pjk->pik", blocks, x3[arrs["block_cols"].long()])
    y = torch.zeros((brows,) + tuple(x3.shape[1:]), dtype=blocks.dtype, device=x3.device)
    return y.index_add_(0, arrs["block_rows"], prods)


def spmm_bcsr(m, x, *, device_arrays=None):
    """``Y = A @ X`` for a ``BsrMatrix`` and ``X`` (cols, F) float32: the
    BCSR SpMM kernel (CUDA) or its plain version (CPU), in FP32 (no TF32).
    X is padded to (bcols * bs, F rounded up to :data:`BCSR_COL_TILE`);
    block rows with no block give zeros."""
    if x.dim() != 2 or x.shape[0] != m.cols:
        raise ValueError(f"x must be ({m.cols}, F), got {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"x has dtype {x.dtype}, the blocks are float32")
    arrs = device_arrays if device_arrays is not None else bcsr_device_arrays(m, x.device)
    f = int(x.shape[1])
    fpad = max(BCSR_COL_TILE, -(-f // BCSR_COL_TILE) * BCSR_COL_TILE)
    xf = torch.zeros((m.bcols * m.bs, fpad), dtype=x.dtype, device=x.device)
    xf[: m.cols, :f] = x
    if on_cuda(x):
        from ..native.kernels import launch_bcsr_spmm

        y = torch.empty((m.brows * m.bs, fpad), dtype=x.dtype, device=x.device)
        launch_bcsr_spmm(arrs["blocks"], arrs["block_cols"], arrs["block_offsets"], xf, y)
    else:
        y = _bcsr_torch(arrs, xf.reshape(m.bcols, m.bs, fpad), brows=m.brows)
        y = y.reshape(m.brows * m.bs, fpad)
    return y[: m.rows, :f]


def spmm_ell(ell_vals, ell_cols, x):
    """``Y = A @ X`` from the padded-ELL view: one row gather of X per
    slot, reused across the K columns."""
    return torch.einsum("rw,rwk->rk", ell_vals, x[ell_cols.long()])
