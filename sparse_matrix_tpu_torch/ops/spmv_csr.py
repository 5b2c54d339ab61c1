"""CSR-row SpMV for rows of any length: the CSR as given, its work balanced
by the merge path (Merrill and Garland, SC'16).

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
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import on_cuda
from ..formats.csr import CsrMatrix
from ..native.kernels import CSR_ITEMS, CSR_THREADS
from .spmv import _launch_record

__all__ = ["plan_csr_rows", "merge_path", "csr_device_arrays", "spmv_csr", "TILE"]

#: merge-path items a tile
TILE = CSR_THREADS * CSR_ITEMS


def plan_csr_rows(m: CsrMatrix, dtype) -> CsrMatrix:
    """``m`` with its values in ``dtype`` (no array copied where they are):
    the host plan of the format is the CSR itself."""
    if m.vals.dtype == np.dtype(dtype):
        return m
    return CsrMatrix(m.rows, m.cols, m.vals.astype(dtype), m.indices, m.offsets,
                     is_sorted=m.is_sorted)


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
    r, tile = r[sel], torch.arange(1, tiles, dtype=torch.int64, device=dev)[sel]
    splits = torch.stack([r, torch.searchsorted(ri[1:], r), tile], 1).contiguous()
    return coords, splits


def csr_device_arrays(plan: CsrMatrix, device) -> dict:
    """The plan's CSR on ``device`` (``offsets`` int64, ``cols`` int32 with
    the uint32 bits, ``vals``), its merge path (``coords``, ``splits``),
    ``carry`` (tiles,) scratch and, on CUDA, ``launch``: the kernel's
    launch record (``native.kernels.prepare_csr``)."""
    offsets = torch.from_numpy(np.ascontiguousarray(plan.offsets)).to(device)
    cols = torch.from_numpy(np.ascontiguousarray(plan.indices).view(np.int32)).to(device)
    vals = torch.from_numpy(np.ascontiguousarray(plan.vals)).to(device)
    coords, splits = merge_path(offsets)
    carry = torch.empty(coords.shape[0] - 1, dtype=vals.dtype, device=device)
    arrs = dict(offsets=offsets, cols=cols, vals=vals, coords=coords, splits=splits,
                carry=carry)
    if offsets.is_cuda:
        arrs["launch"] = _prepare_csr(arrs, plan)
    return arrs


def _prepare_csr(arrs, plan: CsrMatrix):
    from ..native.kernels import prepare_csr

    return prepare_csr(arrs["offsets"], arrs["cols"], arrs["vals"], arrs["coords"],
                       arrs["splits"], arrs["carry"], rows=plan.rows, ncols=plan.cols)


def csr_stream_bytes(arrs) -> int:
    """Device bytes an apply streams: the CSR, the path and the carries,
    written once and read once (x and y not counted)."""
    return sum(int(arrs[k].nbytes) for k in ("offsets", "cols", "vals", "coords", "splits")) \
        + 2 * int(arrs["carry"].nbytes)


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
    """Plain PyTorch apply in the kernel's order, ``tiles_per_pass`` tiles
    at a time (all at once by default; the bits are the same either way,
    and a graph of a billion entries fits on the card only in passes).
    Thread ``g`` of the grid (tile ``g // CSR_THREADS``) walks the path's
    items ``[g, g + 1) * CSR_ITEMS``: it sums each run of one row's
    products in order from 0, stores the sum at the row's end, and carries
    out the sum of the row it ends in. Per tile a segmented Hillis-Steele
    scan of the carries, keyed by that row, adds the threads before to the
    first row a thread ends; the tile's last scan value is its carry, and
    each split row adds the carries of its earlier tiles as a warp does:
    32 lanes, each a stride in order from 0, then the shuffle tree."""
    off, splits = arrs["offsets"], arrs["splits"]
    dev = x.device
    rows, tiles = off.numel() - 1, arrs["coords"].shape[0] - 1
    y = torch.zeros(rows, dtype=torch.result_type(arrs["vals"], x), device=dev)
    carry = torch.zeros(tiles, dtype=y.dtype, device=dev)
    step = tiles if tiles_per_pass is None else int(tiles_per_pass)
    for t0 in range(0, tiles, max(step, 1)):
        t1 = min(tiles, t0 + step)
        _tiles_torch(arrs, x, t0, t1, y, carry)
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
        y[row] = lane[:, 0] + y[row]
    return y


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
