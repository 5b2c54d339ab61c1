"""General SpMV paths: the LanePack, aligned and stripe kernels and the ELL
gather.

Counterpart of ``sparse_matrix_tpu/ops/spmv.py``. The host plans come from
the port's planners (``formats/``), array-equal to the reference's:

* :func:`spmv_lanepack` — the segmented-reduce kernel
  (``csrc/spmv_lanepack.cu``) over a ``LanePackPlan``;
* :func:`spmv_aligned` — the destination-aligned kernel
  (``csrc/spmv_aligned.cu``), plus the LanePack kernel on the plan's spill
  sub-plan, both accumulating into one y;
* :func:`spmv_stripe` — the multi-level stripe kernel
  (``csrc/spmv_stripe.cu``) over a ``StripePlan`` and, through the same
  kernel, its scan-mode spill sub-plan;
* :func:`spmv_ell` / :func:`spmv_ell_spill` — padded-ELL gathers in plain
  PyTorch on every device (the reference computes ELL in XLA, not Pallas);
* :func:`spmv_oracle` — the host CSR row loop, the test oracle, and
  :func:`spmv_f64_bound` — a float64 product with the per-row float32
  error bound that the tests and ``chip_smoke.py`` hold the kernels to.

A CUDA ``x`` launches the kernels; a CPU ``x`` takes the plain versions
:func:`_lanepack_torch`, :func:`_aligned_torch` and :func:`_stripe_torch`.
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

__all__ = [
    "lanepack_device_arrays",
    "spmv_lanepack",
    "aligned_device_arrays",
    "spmv_aligned",
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
# Stripe (multi-level destinations; formats/stripe.py)
# ---------------------------------------------------------------------------


def _stripe_chain(plan):
    """The plan and its spill sub-plans, outermost first."""
    while plan is not None:
        yield plan
        plan = plan.spill


def stripe_device_arrays(plan, device) -> dict:
    """A ``StripePlan``'s arrays on ``device``: ``vals`` (f32) and ``lane``
    (int8 or int16) as ``(chunks, 128)``; ``ends`` and, in scan mode,
    ``starts`` (int8) in the plan's ``(S, L, 8, 128)`` layout;
    ``stripe_rb`` (S,), ``col_off``/``chunk_stripe`` (chunks,) int32;
    ``rb_mask``; ``spill``: the spill sub-plan's arrays."""
    chunks = plan.num_slabs * plan.vals.shape[1]
    arrs = dict(
        vals=_t(plan.vals.reshape(chunks, LANES), device),
        lane=_t(plan.lane.reshape(chunks, LANES), device),
        ends=_t(plan.ends, device),
        stripe_rb=_t(plan.stripe_rb[: plan.num_slabs].astype(np.int32), device),
        col_off=_t(plan.col_off[:chunks].astype(np.int32), device),
        chunk_stripe=_t(plan.chunk_stripe[:chunks].astype(np.int32), device),
        rb_mask=_t(plan.rb_mask, device),
    )
    if plan.starts is not None:
        arrs["starts"] = _t(plan.starts, device)
    if plan.spill is not None:
        arrs["spill"] = stripe_device_arrays(plan.spill, device)
    return arrs


def _stripe_torch(arrs, x, *, rows: int, cols: int, lvl: int, kw: int, scan: bool):
    """Plain PyTorch evaluation of one stripe plan (not its spill): the
    counterpart of ``_stripe_reference`` (window gather, product, cumsum in
    scan mode, per-level boundary gathers scatter-added at
    ``chunk_stripe * L + level``, empty blocks masked)."""
    vals = arrs["vals"]
    s8 = vals.shape[0]
    lane = arrs["lane"].long()
    # (S, L, 8, 128) -> per chunk (S*8, L, 128)
    ends = arrs["ends"].transpose(1, 2).reshape(s8, lvl, LANES).long()
    co = arrs["col_off"].long()
    c128 = -(-cols // LANES)
    xpad = torch.zeros((c128 + kw) * LANES, dtype=x.dtype, device=x.device)
    xpad[: x.shape[0]] = x
    x2d = xpad.reshape(c128 + kw, LANES)
    win = x2d[co[:, None] + torch.arange(kw, device=x.device)[None, :]].reshape(s8, kw * LANES)
    p = vals * torch.gather(win, 1, lane)
    if scan:
        starts = arrs["starts"].transpose(1, 2).reshape(s8, lvl, LANES).long()
        c = torch.cumsum(p, dim=1)
    r128p = arrs["rb_mask"].shape[0]
    y2d = torch.zeros(r128p, LANES, dtype=vals.dtype, device=x.device)
    rb0 = arrs["chunk_stripe"].long() * lvl
    for lv in range(lvl):
        e = ends[:, lv]
        if scan:
            s = starts[:, lv]
            g = torch.gather(c, 1, e) - torch.where(
                s < 0, 0.0, torch.gather(c, 1, s.clamp(min=0))
            )
        else:
            g = torch.gather(p, 1, e)
        y2d.index_add_(0, rb0 + lv, g)
    y2d = torch.where(arrs["rb_mask"][:, None] > 0, y2d, 0.0)
    return y2d.reshape(-1)[:rows]


def _stripe_cuda(plan, arrs, x, y) -> None:
    """Launch the stripe kernel for ``plan`` and each spill sub-plan, all
    adding into ``y`` (an empty plan launches nothing)."""
    from ..native.kernels import launch_stripe

    launch_stripe(arrs["vals"], arrs["lane"], arrs["ends"], arrs.get("starts"),
                  arrs["stripe_rb"], arrs["col_off"], x, y, levels=plan.levels)
    if plan.spill is not None:
        _stripe_cuda(plan.spill, arrs["spill"], x, y)


def spmv_stripe(plan, x, *, device_arrays=None, allow_downcast=False):
    """``y = A @ x`` through the stripe kernel on the plan and its spill
    sub-plan (CUDA ``x``: one y for all), or through the plain version
    (CPU ``x``). The reference's SMEM and VMEM refusals are not carried
    over: the kernel reads its indices and x from device memory."""
    x = _cast_x(x, plan.dtype, allow_downcast)
    arrs = device_arrays if device_arrays is not None else stripe_device_arrays(plan, x.device)
    if on_cuda(x):
        r128p = max(p.r128_padded for p in _stripe_chain(plan))
        y = torch.zeros(r128p * LANES, dtype=x.dtype, device=x.device)
        _stripe_cuda(plan, arrs, x.contiguous(), y)
        return y[: plan.rows]
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


def _run_mass(row, chunk, run, mass, rows: int):
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
    return _run_mass(row, chunk, run, mass, plan.rows)


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
    return _run_mass(row, chunk, run, mass, plan.rows)


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
