"""CSR-row SpMV for rows of any length: the CSR as given, its work balanced
by the merge path (Merrill and Garland, SC'16), its columns cut into
stripes whose slice of x fits the device's L2.

No counterpart in the JAX package: its dispatch sends skewed matrices to
the slab formats (stripe, aligned), which pad a graph whose row lengths
span five orders of magnitude to many times its CSR (PERF.md §6). Here the
operator streams the CSR itself: int64 row offsets, the uint32 columns
(kept as int32 bits on the device) and the values, and no host array
larger than the offsets is built.

The plan (:func:`merge_path`, on the device that holds the offsets) cuts
the merge path of the row ends and the entries, ``rows + nnz`` items,
into tiles of ``CSR_THREADS * CSR_ITEMS`` items: ``coords``, the path's
(rows, entries) point at each tile start, and ``splits``, the rows that
a tile ends after earlier tiles began them, each with the first of those
tiles. On CUDA the kernel (``csrc/spmv_csr.cu``) runs a block a tile and
a second pass over the split rows; on the CPU :func:`_csr_merge_torch`
adds in the same order, so the two give the same bits.

Column stripes (CSR segmenting: Zhang et al., "Making caches work for
graph analytics", IEEE BigData 2017). Where x is larger than a share of
the device's L2 (:func:`stripe_width`), a gather of x past L2 costs a
sector of device memory for 4 bytes. The plan then cuts the columns into
equal stripes and lays the CSR out again stripe by stripe, each stripe a
CSR of its own with its own merge path; the kernel runs the stripes in
order, so the gathers of one stripe fall in an L2-sized slice of x.
Stripe 0 keeps every row and stores y; each later stripe keeps only the
rows with entries in it (``row_ids``) and adds to them. A CPU device, and
an x that fits the share, keep one stripe: the CSR as given.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import on_cuda
from ..formats.csr import CsrMatrix
from ..native.kernels import CSR_ITEMS, CSR_THREADS
from .spmv import _launch_record

__all__ = ["plan_csr_rows", "merge_path", "stripe_width", "csr_device_arrays", "spmv_csr",
           "TILE"]

#: merge-path items a tile
TILE = CSR_THREADS * CSR_ITEMS

#: one stripe's slice of x may take at most 1 / STRIPE_L2_DIV of the L2
STRIPE_L2_DIV = 3

#: the entries a pass of the stripe build takes (whole rows)
STRIPE_PASS_ENTRIES = 1 << 26


def plan_csr_rows(m: CsrMatrix, dtype) -> CsrMatrix:
    """``m`` with its values in ``dtype`` (no array copied where they are):
    the host plan of the format is the CSR itself."""
    if m.vals.dtype == np.dtype(dtype):
        return m
    return CsrMatrix(m.rows, m.cols, m.vals.astype(dtype), m.indices, m.offsets,
                     is_sorted=m.is_sorted)


def stripe_width(ncols: int, itemsize: int, l2_bytes: int) -> int:
    """The columns a stripe spans for an x of ``ncols`` entries of
    ``itemsize`` bytes on a device of ``l2_bytes`` of L2: all of them (one
    stripe) where x fits ``l2_bytes / STRIPE_L2_DIV``, else those of the
    fewest equal stripes whose slices fit, rounded up to whole 32-column
    (128-byte) lines. The stripes are ``[s * width, (s + 1) * width)``."""
    need = ncols * itemsize * STRIPE_L2_DIV
    if need <= l2_bytes:
        return max(ncols, 1)
    stripes = -(-need // l2_bytes)
    return -(-ncols // (32 * stripes)) * 32


def merge_path(offsets: torch.Tensor):
    """``(coords, splits)`` of the CSR with row ``offsets`` (int64, on the
    device that will run it): ``coords`` (tiles + 1, 2) int64, the merge
    path's (rows ended, entries taken) point at item ``tile * TILE`` (the
    last at ``rows + nnz``); ``splits`` (S, 3) int64 rows (row, first tile,
    ending tile) of each row that a tile ``b`` ends and tile ``b - 1``
    already took entries of, ``first`` the earliest tile that ends in the
    row. Row ``i``'s end lies at item ``offsets[i + 1] + i``: the path's
    point at item ``d`` has rows ``#{i: offsets[i + 1] + i < d}``."""
    dev = offsets.device
    rows = offsets.numel() - 1
    total = rows + int(offsets[-1])
    tiles = -(-total // TILE)
    diag = torch.arange(tiles + 1, dtype=torch.int64, device=dev) * TILE
    diag[-1] = total
    ri = torch.searchsorted(offsets[1:] + torch.arange(rows, dtype=torch.int64, device=dev),
                            diag)
    coords = torch.stack([ri, diag - ri], 1).contiguous()
    r = ri[1:tiles]
    sel = (ri[2:] > r) & (diag[1:tiles] - r > offsets[r])
    r, tile = r[sel], torch.arange(1, max(tiles, 1), dtype=torch.int64, device=dev)[sel]
    splits = torch.stack([r, torch.searchsorted(ri[1:], r), tile], 1).contiguous()
    return coords, splits


def csr_device_arrays(plan: CsrMatrix, device, *, _stripe_cols=None) -> dict:
    """The plan on ``device``: ``stripes``, its column stripes in the order
    the kernel runs them, and, on CUDA, ``launch``: the kernel's launch
    record (``native.kernels.prepare_csr``). A stripe is a dict of its CSR
    (``offsets`` int64, ``cols`` int32 with the uint32 bits, ``vals``), its
    merge path (``coords``, ``splits``), ``carry`` (tiles,) scratch and
    ``row_ids``: y's row of each of its rows (int32), or None for stripe 0,
    whose rows are y's. The stripe width is :func:`stripe_width` of the
    device's L2 (one stripe, the CSR as given, on a CPU device);
    ``_stripe_cols`` sets it (tests only)."""
    offsets = torch.from_numpy(np.ascontiguousarray(plan.offsets)).to(device)
    cols = torch.from_numpy(np.ascontiguousarray(plan.indices).view(np.int32)).to(device)
    vals = torch.from_numpy(np.ascontiguousarray(plan.vals)).to(device)
    width = _stripe_cols
    if width is None:
        width = max(plan.cols, 1)
        if offsets.is_cuda:
            l2 = torch.cuda.get_device_properties(offsets.device).L2_cache_size
            width = stripe_width(plan.cols, vals.element_size(), l2)
    if width >= plan.cols:
        layout = [(offsets, cols, vals, None)]
    else:
        layout = _stripe_layout(offsets, cols, vals, plan.cols, int(width))
    del offsets, cols, vals  # the CSR as given goes once its stripes exist
    arrs = {"stripes": tuple(_stripe(*part) for part in layout)}
    if arrs["stripes"][0]["offsets"].is_cuda:
        arrs["launch"] = _prepare_csr(arrs, plan)
    return arrs


def _stripe(offsets, cols, vals, row_ids) -> dict:
    coords, splits = merge_path(offsets)
    carry = torch.empty(coords.shape[0] - 1, dtype=vals.dtype, device=vals.device)
    return dict(offsets=offsets, cols=cols, vals=vals, coords=coords, splits=splits,
                carry=carry, row_ids=row_ids)


def _stripe_layout(offsets, cols, vals, ncols: int, width: int):
    """The CSR cut into the column stripes ``[s * width, (s + 1) * width)``:
    per stripe ``(offsets, cols, vals, row_ids)``, its entries in row
    order (views of one stripe-major array each), stripe 0 over every row
    with no ``row_ids``, each later stripe over the rows with entries in
    it. A row's columns are sorted, so its entries of one stripe are one
    run and the layout is a stable partition by stripe: two passes over
    whole rows of about ``STRIPE_PASS_ENTRIES`` entries, the first
    counting each row's entries by stripe, the second moving each entry to
    its place."""
    dev = offsets.device
    rows = offsets.numel() - 1
    if rows >= 1 << 31:
        raise ValueError(f"spmv_csr: {rows} rows; a stripe's row ids are int32")
    n_st = -(-ncols // width)
    cuts = torch.arange(STRIPE_PASS_ENTRIES, max(cols.numel(), STRIPE_PASS_ENTRIES),
                        STRIPE_PASS_ENTRIES, dtype=torch.int64, device=dev)
    bounds = sorted({0, rows, *torch.searchsorted(offsets, cuts).tolist()})
    passes = [(r0, r1, *offsets[[r0, r1]].tolist()) for r0, r1 in zip(bounds, bounds[1:])]

    def stripe_of(r0, r1, e0, e1):
        """each entry's row (from r0) and stripe"""
        local = torch.repeat_interleave(torch.arange(r1 - r0, device=dev),
                                        torch.diff(offsets[r0:r1 + 1]), output_size=e1 - e0)
        return local, (cols[e0:e1].long() & 0xFFFFFFFF) // width

    # count[s, r]: row r's entries in stripe s (stripe-major, so that the
    # sums over rows scan the inner dimension)
    count = torch.empty((n_st, rows), dtype=torch.int32, device=dev)
    for r0, r1, e0, e1 in passes:
        local, st = stripe_of(r0, r1, e0, e1)
        count[:, r0:r1] = torch.bincount(st * (r1 - r0) + local,
                                         minlength=n_st * (r1 - r0)).view(n_st, r1 - r0)
    total = count.sum(1, dtype=torch.int64)
    base = torch.cumsum(total, 0) - total
    cols_s, vals_s = torch.empty_like(cols), torch.empty_like(vals)
    seen = base.clone()
    for r0, r1, e0, e1 in passes:
        c = count[:, r0:r1].long()
        # entry e of row r in stripe s goes to base[s] + (the stripe's
        # entries in rows before r) + (e - offsets[r] - the row's entries
        # in stripes before s)
        shift = (seen[:, None] + torch.cumsum(c, 1) - c) - (torch.cumsum(c, 0) - c) \
            - offsets[None, r0:r1]
        seen += c.sum(1)
        local, st = stripe_of(r0, r1, e0, e1)
        dest = shift.view(-1)[st * (r1 - r0) + local] + torch.arange(e0, e1, device=dev)
        del local, st
        cols_s.index_copy_(0, dest, cols[e0:e1])
        vals_s.index_copy_(0, dest, vals[e0:e1])
    layout = []
    for s, (e0, n) in enumerate(zip(base.tolist(), total.tolist())):
        lens = count[s]
        row_ids = None
        if s:
            row_ids = torch.nonzero(lens).flatten()
            lens = lens[row_ids]
            row_ids = row_ids.to(torch.int32)
        off = torch.zeros(lens.numel() + 1, dtype=torch.int64, device=dev)
        off[1:] = torch.cumsum(lens, 0, dtype=torch.int64)
        layout.append((off, cols_s[e0:e0 + n], vals_s[e0:e0 + n], row_ids))
    return layout


def _prepare_csr(arrs, plan: CsrMatrix):
    from ..native.kernels import prepare_csr

    return prepare_csr(arrs["stripes"], rows=plan.rows, ncols=plan.cols)


def csr_stream_bytes(arrs) -> int:
    """Device bytes an apply streams: each stripe's CSR, row ids and path,
    and its carries written once and read once (x and y not counted)."""
    return sum(sum(int(st[k].nbytes) for k in ("offsets", "cols", "vals", "coords", "splits"))
               + (0 if st["row_ids"] is None else int(st["row_ids"].nbytes))
               + 2 * int(st["carry"].nbytes) for st in arrs["stripes"])


def spmv_csr(plan: CsrMatrix, x: torch.Tensor, *, device_arrays=None) -> torch.Tensor:
    """``y = A @ x``: the kernel for a CUDA ``x``, the plain version for a
    CPU ``x``."""
    arrs = device_arrays if device_arrays is not None else csr_device_arrays(plan, x.device)
    if on_cuda(x):
        y = torch.empty(plan.rows, dtype=x.dtype, device=x.device)
        _launch_record(_prepare_csr, arrs, plan)(x.contiguous(), y)
        return y
    return _csr_merge_torch(arrs, x)


def _csr_merge_torch(arrs, x: torch.Tensor, tiles_per_pass=None) -> torch.Tensor:
    """Plain PyTorch apply in the kernel's order: the stripes in turn,
    stripe 0 storing every row of y and each later stripe adding to its
    rows (:func:`_stripe_merge_torch`), ``tiles_per_pass`` tiles at a time
    (all at once by default; the bits are the same either way, and a graph
    of a billion entries fits on the card only in passes)."""
    first = arrs["stripes"][0]
    y = torch.zeros(first["offsets"].numel() - 1,
                    dtype=torch.result_type(first["vals"], x), device=x.device)
    for st in arrs["stripes"]:
        _stripe_merge_torch(st, x, y, tiles_per_pass)
    return y


def _stripe_merge_torch(st, x: torch.Tensor, y, tiles_per_pass) -> None:
    """One stripe into ``y``, as its two launches do. Thread ``g`` of the
    grid (tile ``g // CSR_THREADS``) walks the path's items ``[g, g + 1) *
    CSR_ITEMS``: it sums each run of one row's products in order from 0,
    stores the sum at the row's end, and carries out the sum of the row it
    ends in. Per tile a segmented Hillis-Steele scan of the carries, keyed
    by that row, adds the threads before to the first row a thread ends;
    the tile's last scan value is its carry. The rows a tile ends go to y
    (stored by stripe 0, added to y by a later stripe); then each split row
    adds the carries of its earlier tiles as a warp does, 32 lanes, each a
    stride in order from 0, then the shuffle tree, to its row of y."""
    off, splits, row_ids = st["offsets"], st["splits"], st["row_ids"]
    dev = x.device
    rows, tiles = off.numel() - 1, st["coords"].shape[0] - 1
    ys = torch.zeros(rows, dtype=y.dtype, device=dev)
    carry = torch.zeros(tiles, dtype=y.dtype, device=dev)
    step = tiles if tiles_per_pass is None else int(tiles_per_pass)
    for t0 in range(0, tiles, max(step, 1)):
        t1 = min(tiles, t0 + step)
        _tiles_torch(st, x, t0, t1, ys, carry)
    if row_ids is None:
        y.copy_(ys)
    else:
        row_ids = row_ids.long()
        y[row_ids] = y[row_ids] + ys
    if splits.shape[0]:
        row, lo, hi = splits.unbind(1)
        lanes = torch.arange(32, dtype=torch.int64, device=dev)
        lane = torch.zeros((row.numel(), 32), dtype=y.dtype, device=dev)
        for step in range(0, int((hi - lo).max()), 32):
            k = lo[:, None] + step + lanes
            ok = k < hi[:, None]
            lane = lane + torch.where(ok, carry[k.clamp(max=tiles - 1)], 0.0)
        for w in (16, 8, 4, 2, 1):
            lane = torch.cat([lane[:, :w] + lane[:, w:2 * w], lane[:, w:]], 1)
        if row_ids is not None:
            row = row_ids[row]
        y[row] = lane[:, 0] + y[row]


def _tiles_torch(arrs, x, t0: int, t1: int, y, carry):
    """The first pass of tiles ``[t0, t1)``: ``y`` of the rows that end in
    them, before the carries of earlier tiles, and ``carry`` of each.
    Rows ``[r0, r1)`` end there; its entries ``[e0, e1)`` belong to rows
    ``r0`` to ``r1``, the last one still open at the range's end."""
    off, cols, vals, coords = (arrs[k] for k in ("offsets", "cols", "vals", "coords"))
    dev = x.device
    rows, total = off.numel() - 1, int(coords[-1].sum())
    (r0, e0), (r1, e1) = coords[t0].tolist(), coords[t1].tolist()
    nnz, grid, g0 = e1 - e0, (t1 - t0) * CSR_THREADS, t0 * CSR_THREADS
    ar = torch.arange(r0, min(r1 + 1, rows), dtype=torch.int64, device=dev)
    row_of = torch.repeat_interleave(
        ar, off[ar + 1].clamp(e0, e1) - off[ar].clamp(e0, e1), output_size=nnz)
    prod = vals[e0:e1] * x[cols[e0:e1].long()]
    g_ent = (row_of + torch.arange(e0, e1, dtype=torch.int64, device=dev)) // CSR_ITEMS
    ends = off[ar + 1] + ar
    g_end = ends // CSR_ITEMS
    # the runs of one row's entries within one thread, summed in order
    head = torch.ones(nnz, dtype=torch.bool, device=dev)
    head[1:] = (g_ent[1:] != g_ent[:-1]) | (row_of[1:] != row_of[:-1])
    first = torch.nonzero(head).flatten()
    length = torch.diff(first, append=torch.tensor([nnz], device=dev))
    run = torch.zeros(first.numel(), dtype=prod.dtype, device=dev)
    for k in range(CSR_ITEMS):
        m = length > k
        run[m] = run[m] + prod[first[m] + k]
    run_g, run_r = g_ent[first], row_of[first] - r0
    stored = run_g == g_end[run_r]
    y_loc = torch.zeros(r1 - r0, dtype=prod.dtype, device=dev)
    y_loc[run_r[stored]] = run[stored]
    scan = torch.zeros(grid, dtype=prod.dtype, device=dev)
    scan[run_g[~stored] - g0] = run[~stored]
    # each thread's start row; the row it ends in is the next thread's
    items = (torch.arange(g0, g0 + grid + 1, dtype=torch.int64, device=dev)
             * CSR_ITEMS).clamp_(max=total)
    start = r0 + torch.searchsorted(ends, items)
    key = start[1:].view(t1 - t0, CSR_THREADS)
    scan = scan.view(t1 - t0, CSR_THREADS)
    s = 1
    while s < CSR_THREADS:
        nxt = scan.clone()
        nxt[:, s:] = torch.where(key[:, s:] == key[:, :-s], scan[:, :-s] + scan[:, s:],
                                 scan[:, s:])
        scan, s = nxt, 2 * s
    carry[t0:t1], scan = scan[:, -1], scan.reshape(grid)
    g_end, ar = g_end[:r1 - r0] - g0, ar[:r1 - r0]
    fix = (g_end % CSR_THREADS > 0) & (start[g_end] == ar)
    y_loc[fix] = scan[g_end[fix] - 1] + y_loc[fix]
    y[r0:r1] = y_loc
