"""Aligned LanePack: destination-aligned slot packing for SpMV.

Counterpart of ``sparse_matrix_tpu/formats/aligned.py`` (its numpy
branches). Each product sits at slot lane ``row % 128`` of a chunk keyed by
(row block, 128-column window, layer), so a product is already a per-row
contribution: no prefix sum, no run boundaries. Chunks with fewer than
``spill_k`` entries may spill to a general LanePack sub-plan when the
reference's cost model says that is faster.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .csr import CsrMatrix
from .lanepack import LANES, SUBLANES, LanePackPlan, plan_lanepack

__all__ = ["AlignedPlan", "plan_aligned"]

# aligned chunks with fewer slots than this may go to the general sub-plan
SPILL_K = 32


@dataclass(frozen=True)
class AlignedPlan:
    """Host aligned plan (+ optional general spill sub-plan): ``vals``
    (S,8,128), ``lane`` (S,8,128) int8 (x position in the 128-column
    window), ``col_off``/``chunk_rb`` (S*8,) int32 per chunk, the reference
    kernel's ``rb_a``/``rb_b``/``split`` (S,), ``rb_mask`` (r128,)."""

    rows: int
    cols: int
    vals: np.ndarray
    lane: np.ndarray
    col_off: np.ndarray
    chunk_rb: np.ndarray
    rb_a: np.ndarray
    rb_b: np.ndarray
    split: np.ndarray
    rb_mask: np.ndarray
    nnz: int
    dtype: np.dtype
    spill: Optional[LanePackPlan]

    @property
    def num_slabs(self) -> int:
        return int(self.vals.shape[0])

    @property
    def r128(self) -> int:
        return -(-self.rows // LANES)

    @property
    def c128(self) -> int:
        return -(-self.cols // LANES)

    def slot_bytes(self) -> int:
        b = int(self.vals.nbytes + self.lane.nbytes)
        if self.spill is not None:
            b += self.spill.slot_bytes()
        return b


def _chunk_keys(m: CsrMatrix):
    """Per-entry (row-sorted) chunk keys ``(rb*wtot + w)*128 + layer`` plus
    the entry order and the sorted rows and columns."""
    nnz = m.nnz()
    r = m.row_ids().astype(np.int64)
    c = m.indices.astype(np.int64)
    if m.is_sorted:
        order = np.arange(nnz)  # already (row, col)-sorted
    else:
        order = np.lexsort((c, r))
        r, c = r[order], c[order]
    w = c // LANES
    new_rw = np.r_[True, (r[1:] != r[:-1]) | (w[1:] != w[:-1])] if nnz else np.zeros(0, bool)
    start_rw = np.maximum.accumulate(np.where(new_rw, np.arange(nnz), 0))
    layer = np.arange(nnz) - start_rw
    # layer < 128 (a 128-column window holds at most 128 distinct columns)
    wtot = m.cols // LANES + 2
    ck = (r // LANES * wtot + w) * 128 + layer
    return order, r, c, ck


def _chunk_sorted(m: CsrMatrix):
    """``(perm, ck, wtot)``: chunk-sorted order over the original entry
    indices and the sorted keys."""
    nnz = m.nnz()
    wtot = m.cols // LANES + 2
    if nnz == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.uint64), wtot
    order, _r, _c, ck = _chunk_keys(m)
    p = np.argsort(ck, kind="stable")
    return order[p], ck[p].astype(np.uint64), wtot


def _spill_sub_slabs(key_rbw: np.ndarray, counts: np.ndarray, wtot: int) -> int:
    """Slab count of the kw=1 LanePack plan of the spilled chunks, from
    chunk-level stats (equal to ``_count_slabs`` on the spilled entries)."""
    if len(key_rbw) == 0:
        return 0
    new_g = np.r_[True, key_rbw[1:] != key_rbw[:-1]]
    gidx = np.nonzero(new_g)[0]
    sizes = np.add.reduceat(counts, gidx)
    chunks_per_group = -(-sizes // LANES)
    grb = key_rbw[gidx] // wtot
    rb_head = np.r_[True, grb[1:] != grb[:-1]]
    rb_tot = np.add.reduceat(chunks_per_group, np.nonzero(rb_head)[0])
    return int(np.sum(-(-rb_tot // SUBLANES)))


def plan_aligned(m: CsrMatrix, *, dtype=np.float32, spill_k: int = SPILL_K) -> AlignedPlan:
    """Build the aligned plan in O(nnz log nnz) vectorized numpy. Low-fill
    chunks spill to a LanePack sub-plan only when the reference's per-slab
    cost model says the split plan is faster."""
    from ..utils import autotune

    rows, cols, nnz = m.rows, m.cols, m.nnz()
    perm, ck, wtot = _chunk_sorted(m)
    if nnz:
        new_chunk = np.r_[True, ck[1:] != ck[:-1]]
        heads_all = np.nonzero(new_chunk)[0]
        cnt = np.diff(np.append(heads_all, nnz))
    else:
        heads_all = np.zeros(0, np.int64)
        cnt = np.zeros(0, np.int64)

    # keep/split decision from chunk-level stats only
    small = cnt < spill_k
    spill_plan = None
    do_split = False
    if nnz and small.any():
        key_rbw_all = ck[heads_all] // 128
        sub_slabs = _spill_sub_slabs(key_rbw_all[small].astype(np.int64), cnt[small], wtot)
        ali_ns = autotune.get("lanepack_aligned_slab_ns")
        gen_ns = autotune.get("lanepack_dense_slab_ns")
        cost_all = -(-len(cnt) // SUBLANES) * ali_ns
        cost_split = -(-int((~small).sum()) // SUBLANES) * ali_ns + sub_slabs * gen_ns
        do_split = cost_split < cost_all

    row_of = m.row_ids()
    if do_split:
        spill_mask = np.repeat(small, cnt)  # per entry, chunk-sorted order
        sp_idx = np.sort(perm[spill_mask])  # spilled entries, CSR order
        rr, vv = row_of[sp_idx], m.vals[sp_idx].astype(dtype)
        offs = np.zeros(rows + 1, np.int64)
        offs[1:] = np.bincount(rr, minlength=offs.shape[0] - 1)
        np.cumsum(offs, out=offs)
        sub = CsrMatrix(rows, cols, vv, m.indices[sp_idx], offs, is_sorted=m.is_sorted)
        spill_plan = plan_lanepack(sub, dtype=dtype)
        kept_idx = perm[~spill_mask]  # chunk-sorted order, original indices
        ck = ck[~spill_mask]
        kn = len(kept_idx)
        new_chunk = np.r_[True, ck[1:] != ck[:-1]] if kn else np.zeros(0, bool)
        head = np.nonzero(new_chunk)[0]
        head_key = (ck[head] // 128).astype(np.int64)  # (rb*wtot + w)
    else:
        kept_idx = perm
        kn = nnz
        head = heads_all
        head_key = (
            key_rbw_all.astype(np.int64)
            if nnz and small.any()
            else (ck[head] // 128).astype(np.int64)
        )
    head_rb = head_key // wtot
    head_w = head_key % wtot
    num_chunks = len(head)

    # two-target slab packing (at most two row blocks per slab, as in
    # plan_lanepack), as a position state machine over row blocks
    rb_change = np.r_[True, head_rb[1:] != head_rb[:-1]] if num_chunks else np.zeros(0, bool)
    counts = (
        np.diff(np.append(np.nonzero(rb_change)[0], num_chunks))
        if num_chunks
        else np.zeros(0, np.int64)
    )
    uniq_rbs = head_rb[rb_change] if num_chunks else np.zeros(0, np.int64)

    pos0 = np.zeros(len(counts), np.int64)
    pos = 0  # global sublane position, pads included
    nrb = 1  # row blocks in the currently open slab
    for i, cnt_i in enumerate(counts):
        cur = pos % SUBLANES
        if cur != 0 and nrb == 2:
            pos += SUBLANES - cur  # slab already holds two rbs: close (pad)
            cur = 0
        pos0[i] = pos
        entered_shared = cur != 0
        pos += int(cnt_i)
        if pos % SUBLANES == 0:
            nrb = 1
        else:
            nrb = 2 if entered_shared and cnt_i < SUBLANES - cur else 1

    if num_chunks:
        gpos = np.repeat(pos0, counts) + (
            np.arange(num_chunks) - np.repeat(np.cumsum(counts) - counts, counts)
        )
        chunk_slab = gpos // SUBLANES
        chunk_sub = gpos % SUBLANES
        chunk_rb_of = np.repeat(uniq_rbs, counts)
        s = int(gpos[-1] // SUBLANES) + 1
        uslab, first = np.unique(chunk_slab, return_index=True)
        last = np.r_[first[1:] - 1, num_chunks - 1]
        rb_a_full = np.zeros(s, np.int64)
        rb_b_full = np.zeros(s, np.int64)
        rb_a_full[uslab] = chunk_rb_of[first]
        rb_b_full[uslab] = chunk_rb_of[last]
        split_full = np.full(s, SUBLANES, np.int64)
        two = rb_a_full[chunk_slab] != chunk_rb_of
        np.minimum.at(split_full, chunk_slab[two], chunk_sub[two])
        meta = np.stack([rb_a_full, rb_b_full, split_full], axis=1)
    else:
        chunk_slab = np.zeros(0, np.int64)
        chunk_sub = np.zeros(0, np.int64)
        meta = np.zeros((0, 3), np.int64)
        s = 0

    vals_s = np.zeros((s, SUBLANES, LANES), dtype)
    lane_s = np.zeros((s, SUBLANES, LANES), np.int8)
    col_off = np.zeros(max(s, 1) * SUBLANES, np.int32)
    chunk_rb = np.zeros(max(s, 1) * SUBLANES, np.int32)
    ma = np.asarray(meta, np.int32) if s else np.zeros((0, 3), np.int32)
    rb_a = np.zeros(max(s, 1), np.int32)
    rb_b = np.zeros(max(s, 1), np.int32)
    split = np.full(max(s, 1), SUBLANES, np.int32)
    if s:
        rb_a[:s], rb_b[:s], split[:s] = ma[:, 0], ma[:, 1], ma[:, 2]
    if kn:
        chunk_id = np.cumsum(new_chunk) - 1
        so, su = chunk_slab[chunk_id], chunk_sub[chunk_id]
        dst = row_of[kept_idx] % LANES
        vals_s[so, su, dst] = m.vals[kept_idx].astype(dtype)
        lane_s[so, su, dst] = (m.indices[kept_idx].astype(np.int64) % LANES).astype(np.int8)
        col_off[chunk_slab * SUBLANES + chunk_sub] = head_w.astype(np.int32)
        chunk_rb[chunk_slab * SUBLANES + chunk_sub] = head_rb.astype(np.int32)

    r128 = -(-rows // LANES)
    rb_mask = np.zeros(r128, dtype)
    if kn:
        rb_mask[np.unique(head_rb)] = 1
    if spill_plan is not None:
        rb_mask = np.maximum(rb_mask, spill_plan.rb_mask)

    return AlignedPlan(
        rows=rows,
        cols=cols,
        vals=vals_s,
        lane=lane_s,
        col_off=col_off,
        chunk_rb=chunk_rb,
        rb_a=rb_a,
        rb_b=rb_b,
        split=split,
        rb_mask=rb_mask,
        nnz=nnz,
        dtype=np.dtype(dtype),
        spill=spill_plan,
    )
