"""SpMM: sparse matrix times a block of K dense columns (``A @ X``).

Counterpart of ``sparse_matrix_tpu/ops/spmm.py``:

* :func:`spmm_aligned_packed`, :func:`aligned_matvec_multi` and
  :func:`spmm_aligned` — the aligned SpMM kernel (``csrc/spmm_aligned.cu``)
  on an ``AlignedPlan``, in the packed layout ``(c128 + 1, K, 128)``
  (:func:`pack_rhs`) that keeps one x-window load per chunk for all K
  columns; a plan's LanePack spill runs column by column through the
  LanePack SpMV kernel, as in the reference;
* :func:`spmm_ell` — the padded-ELL gather, in plain PyTorch on every
  device (the reference leaves it to XLA);
* :func:`bell_spmm_viable` and :func:`lanepack_spmm_uses_kernel` — the
  reference's gates for its packed BELL and LanePack SpMM kernels (B7, B8
  in ROADMAP.md), not ported yet: ``SpmvOperator.matmat`` raises where
  they would run.

A CUDA ``x3`` launches the kernels; a CPU one takes the plain version
:func:`_aligned_spmm_torch`.
"""

from __future__ import annotations

import torch

from ..device import on_cuda
from .spmv import _lanepack_cuda, _lanepack_torch, aligned_device_arrays

__all__ = [
    "pack_rhs",
    "unpack_rhs",
    "spmm_aligned_packed",
    "aligned_matvec_multi",
    "spmm_aligned",
    "spmm_ell",
    "bell_spmm_viable",
    "lanepack_spmm_uses_kernel",
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


def _add_spill(plan, arrs, x3, y3) -> None:
    """Add the LanePack spill sub-plan's product, column by column through
    the LanePack kernel (CUDA) or its plain version (CPU), into the first
    r128 rows of ``y3``."""
    spill = plan.spill
    r128 = plan.r128
    for q in range(x3.shape[1]):
        xq = x3[:, q, :].reshape(-1)[: plan.cols].contiguous()
        yq = torch.zeros(r128 * LANES, dtype=x3.dtype, device=x3.device)
        if on_cuda(x3):
            _lanepack_cuda(arrs["spill"], xq, yq)
        else:
            yq[: plan.rows] = _lanepack_torch(arrs["spill"], xq, rows=plan.rows,
                                              cols=plan.cols, kw=spill.kw)
        y3[:r128, q, :] += yq.reshape(r128, LANES)


def _spmm_aligned_into(plan, arrs, x3, y3) -> None:
    """``y3[:r128] += A @ x3`` (packed); ``y3`` zeroed by the caller."""
    if on_cuda(x3):
        from ..native.kernels import launch_aligned_spmm

        launch_aligned_spmm(arrs["vals"], arrs["lane"], arrs["col_off"], arrs["chunk_rb"],
                            x3, y3, cols=plan.cols)
    else:
        y3[: plan.r128] += _aligned_spmm_torch(arrs, x3, rows=plan.rows)
    if plan.spill is not None:
        _add_spill(plan, arrs, x3, y3)


def _check_x3(plan, x3):
    if x3.dim() != 3 or x3.shape[2] != LANES or x3.shape[0] < plan.c128 + 1:
        raise ValueError(
            f"x3 must be packed (c128 + 1, K, 128) = ({plan.c128 + 1}, K, 128), "
            f"got {tuple(x3.shape)}"
        )
    if x3.dtype != torch.float32:
        raise TypeError(f"x3 has dtype {x3.dtype}, the plan is float32")
    return x3.contiguous()


def spmm_aligned_packed(plan, x3, *, device_arrays=None):
    """``Y = A @ X`` on an ``AlignedPlan``, packed layout in and out:
    ``x3`` is (c128 + 1, K, 128), the result (r128, K, 128)."""
    x3 = _check_x3(plan, x3)
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
        x3 = _check_x3(plan, x3)
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


def spmm_ell(ell_vals, ell_cols, x):
    """``Y = A @ X`` from the padded-ELL view: one row gather of X per
    slot, reused across the K columns."""
    return torch.einsum("rw,rwk->rk", ell_vals, x[ell_cols.long()])


# the reference's dispatch gates for its packed LanePack and BELL SpMM
# kernels (sparse_matrix_tpu/ops/spmm.py), copied so that matmat raises
# exactly where the reference would launch them
_LP_SPMM_MIN_K = 8
_LP_SPMM_LOOP_MIN_SLABS = 512


def lanepack_spmm_uses_kernel(plan, k: int) -> bool:
    """True where the reference's LanePack matmat runs its packed SpMM
    kernel (K >= 8, or a plan under 512 slabs) instead of a column loop."""
    return k >= _LP_SPMM_MIN_K or plan.num_slabs < _LP_SPMM_LOOP_MIN_SLABS


def bell_spmm_viable(plan, k: int) -> bool:
    """The reference's BELL SpMM kernel gate: 2 <= K <= 16 and its VMEM
    working set fits."""
    return 2 <= k <= 16 and _bell_spmm_pick_br(plan, k, 512) >= 32


def _bell_spmm_pick_br(plan, k: int, br0: int) -> int:
    """The reference kernel's step height for its VMEM budget, or 0."""
    from ..formats.bell import _BELL_VMEM_BUDGET

    c128 = -(-plan.cols // LANES)
    x3_bytes = (c128 + 16) * k * LANES * 4
    sb = plan.vals.dtype.itemsize + plan.lane.dtype.itemsize
    nh = plan.span // 128 + 1
    n_off = len({
        d + h
        for d, mask in zip(plan.ds, plan.modes)
        for h in range(nh)
        if (mask >> h) & 1
    }) or 1
    per_br = 2 * max(plan.num_layers, 1) * LANES * sb + (2 * n_off + 6) * k * LANES * 4
    br = br0
    while br >= 32 and x3_bytes + br * per_br > _BELL_VMEM_BUDGET:
        br //= 2
    return br if br >= 32 else 0
