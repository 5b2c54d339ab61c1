"""General SpMV paths: the LanePack and aligned kernels and the ELL gather.

Counterpart of ``sparse_matrix_tpu/ops/spmv.py``. The host plans are the
reference's own (``sparse_matrix_tpu.formats.lanepack`` / ``.aligned``);
only the device side is rebuilt:

* :func:`spmv_lanepack` — the segmented-reduce kernel
  (``csrc/spmv_lanepack.cu``) over a ``LanePackPlan``;
* :func:`spmv_aligned` — the destination-aligned kernel
  (``csrc/spmv_aligned.cu``), plus the LanePack kernel on the plan's spill
  sub-plan, both accumulating into one y;
* :func:`spmv_ell` / :func:`spmv_ell_spill` — padded-ELL gathers in plain
  PyTorch on every device (the reference computes ELL in XLA, not Pallas);
* :func:`spmv_oracle` — the host CSR row loop, the test oracle, and
  :func:`spmv_f64_bound` — a float64 product with the per-row float32
  error bound that the tests and ``chip_smoke.py`` hold the kernels to.

A CUDA ``x`` launches the kernels; a CPU ``x`` takes the plain versions
:func:`_lanepack_torch` and :func:`_aligned_torch`. The TPU-only limits of
the reference are not carried over: its SMEM and VMEM raises, the B-slab
padding of ``_pick_b``, the SMEM slab segmentation of aligned plans, and
the ``rb_a``/``rb_b``/``split`` two-target packing (the kernels target rows
through ``chunk_rb``, as the reference's own CPU path does).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from sparse_matrix_tpu.formats.csr import CsrMatrix
from sparse_matrix_tpu.formats.lanepack import LANES, LanePackPlan

from ..device import on_cuda

__all__ = [
    "lanepack_device_arrays",
    "spmv_lanepack",
    "aligned_device_arrays",
    "spmv_aligned",
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
    x = torch.as_tensor(x)
    out = _TORCH_DTYPES[np.dtype(plan_dtype)]
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
# LanePack
# ---------------------------------------------------------------------------


def lanepack_device_arrays(plan: LanePackPlan, device) -> dict:
    """A LanePack plan's slot and chunk arrays on ``device``, flattened to
    128-slot chunks: ``vals`` (f32), ``lane`` (int16), ``ends``/``starts``
    (int8), ``col_off``/``chunk_rb`` (int32, one per chunk), ``rb_mask``."""
    chunks = plan.num_slabs * plan.vals.shape[1]
    return dict(
        vals=_t(plan.vals.reshape(chunks, LANES), device),
        lane=_t(plan.lane.reshape(chunks, LANES), device),
        ends=_t(plan.ends.reshape(chunks, LANES), device),
        starts=_t(plan.starts.reshape(chunks, LANES), device),
        col_off=_t(plan.col_off[:chunks].astype(np.int32), device),
        chunk_rb=_t(plan.chunk_rb[:chunks].astype(np.int32), device),
        rb_mask=_t(plan.rb_mask, device),
    )


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


def _lanepack_cuda(arrs, x, y) -> None:
    from ..native.kernels import launch_lanepack

    launch_lanepack(arrs["vals"], arrs["lane"], arrs["ends"], arrs["starts"],
                    arrs["col_off"], arrs["chunk_rb"], x, y)


def spmv_lanepack(plan: LanePackPlan, x, *, device_arrays=None, allow_downcast=False):
    """``y = A @ x`` through the LanePack kernel (CUDA ``x``) or its plain
    version (CPU ``x``)."""
    x = _cast_x(x, plan.dtype, allow_downcast)
    arrs = device_arrays if device_arrays is not None else lanepack_device_arrays(plan, x.device)
    if on_cuda(x):
        y = torch.zeros(plan.r128 * LANES, dtype=x.dtype, device=x.device)
        _lanepack_cuda(arrs, x.contiguous(), y)
        return y[: plan.rows]
    return _lanepack_torch(arrs, x, rows=plan.rows, cols=plan.cols, kw=plan.kw)


# ---------------------------------------------------------------------------
# Aligned (destination-aligned slots; formats/aligned.py)
# ---------------------------------------------------------------------------


def aligned_device_arrays(plan, device) -> dict:
    """An ``AlignedPlan``'s arrays on ``device`` (``vals`` f32 and ``lane``
    int8 as ``(chunks, 128)``, ``col_off``/``chunk_rb`` int32, ``rb_mask``),
    plus ``spill``: the LanePack sub-plan's arrays when the plan has one."""
    chunks = plan.num_slabs * plan.vals.shape[1]
    arrs = dict(
        vals=_t(plan.vals.reshape(chunks, LANES), device),
        lane=_t(plan.lane.reshape(chunks, LANES), device),
        col_off=_t(plan.col_off[:chunks].astype(np.int32), device),
        chunk_rb=_t(plan.chunk_rb[:chunks].astype(np.int32), device),
        rb_mask=_t(plan.rb_mask, device),
    )
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
    """``y = A @ x`` through the aligned kernel plus the LanePack kernel on
    the spill sub-plan (CUDA ``x``: both accumulate into one y), or through
    their plain versions (CPU ``x``)."""
    x = _cast_x(x, plan.dtype, allow_downcast)
    arrs = device_arrays if device_arrays is not None else aligned_device_arrays(plan, x.device)
    spill = plan.spill
    if on_cuda(x):
        from ..native.kernels import launch_aligned

        x = x.contiguous()
        y = torch.zeros(plan.r128 * LANES, dtype=x.dtype, device=x.device)
        launch_aligned(arrs["vals"], arrs["lane"], arrs["col_off"], arrs["chunk_rb"], x, y)
        if spill is not None:
            _lanepack_cuda(arrs["spill"], x, y)
        return y[: plan.rows]
    y = _aligned_torch(arrs, x, rows=plan.rows, cols=plan.cols)
    if spill is not None:
        y = y + _lanepack_torch(arrs["spill"], x, rows=plan.rows, cols=plan.cols, kw=spill.kw)
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


def _lanepack_run_mass(plan: LanePackPlan, x: np.ndarray) -> np.ndarray:
    """Per row: the absolute mass ``sum |p|`` of every chunk in which the
    row has a run. A run's sum is a difference of two prefix sums of its
    chunk, so its rounding error scales with that mass, not with the row's
    own products."""
    chunks = plan.num_slabs * plan.vals.shape[1]
    vals = plan.vals.reshape(chunks, LANES).astype(np.float64)
    j = plan.col_off[:chunks, None].astype(np.int64) * LANES + plan.lane.reshape(
        chunks, LANES
    )
    xg = np.where(j < plan.cols, x[np.minimum(j, plan.cols - 1)], 0.0)
    mass = np.abs(vals * xg).sum(axis=1)
    ends = plan.ends.reshape(chunks, LANES)
    starts = plan.starts.reshape(chunks, LANES)
    run = (ends != 0) | (starts != 0)
    row = plan.chunk_rb[:chunks, None].astype(np.int64) * LANES + np.arange(LANES)
    per = np.bincount(
        row[run], weights=np.broadcast_to(mass[:, None], run.shape)[run],
        minlength=plan.r128 * LANES,
    )
    return per[: plan.rows]


def spmv_f64_bound(m: CsrMatrix, x, *, vals=None, lanepack=()):
    """``(y_f64, bound)``: the float64 CSR product ``A @ x`` and a per-row
    bound on the error of a float32 evaluation of it.

    Without LanePack parts the bound is ``(nnz_row + 1) * u * (|A||x|)_i``
    (u = 2^-24): a sum of nnz_row rounded products in any order, which
    covers DIA, aligned and BELL, with or without atomics. ``lanepack``
    lists the LanePack plans (or spill sub-plans) that take part; then it is
    ``(2*128 + nnz_row) * u * ((|A||x|)_i + P_i)``, P_i being the mass of the
    chunks that hold row i's runs (see :func:`_lanepack_run_mass`): the run
    sums are prefix-sum differences, scanned in another order than the
    reference's. ``vals`` replaces the matrix values (e.g. their bf16
    rounding, for bf16 value planes)."""
    x = np.asarray(x, dtype=np.float64)
    v = (m.vals if vals is None else vals).astype(np.float64)
    r = m.row_ids()
    prod = v * x[m.indices.astype(np.int64)]
    y = np.bincount(r, weights=prod, minlength=m.rows)
    mag = np.bincount(r, weights=np.abs(prod), minlength=m.rows)
    nnz_row = np.diff(m.offsets).astype(np.float64)
    if not lanepack:
        return y, (nnz_row + 1) * U_F32 * mag
    mass = sum(_lanepack_run_mass(p, x) for p in lanepack)
    return y, (2 * LANES + nnz_row) * U_F32 * (mag + mass)


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
