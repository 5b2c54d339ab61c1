"""LanePack: the general segmented-reduce SpMV plan.

Counterpart of ``sparse_matrix_tpu/formats/lanepack.py`` (its numpy
branches). Columns are split into ``KW*128``-wide windows and rows into
128-row blocks; every nonzero becomes a slot of an ``(8, 128)`` slab. A slab
row ("chunk") holds up to 128 products that share one column window and one
row block, sorted by destination lane; ``lane`` (int16) is the product's x
position in its window, and ``ends``/``starts`` (int8) are the run
boundaries of each destination lane in the chunk's prefix sum. ``KW`` and
the slab packing ("dense": at most two row blocks per slab; "per_rb": one)
are picked by the reference's cost model.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np

from .csr import CsrMatrix, sample_row_bands

__all__ = ["LanePackPlan", "plan_lanepack", "LANES", "SUBLANES", "SLOTS"]

SUBLANES = 8
LANES = 128
SLOTS = SUBLANES * LANES


def _cost_constants():
    from ..utils import autotune

    return (
        autotune.get("lanepack_fixed_ns"),
        autotune.get("lanepack_kw_ns"),
        autotune.get("lanepack_dense_slab_ns"),
        autotune.get("lanepack_per_rb_slab_ns"),
    )


@dataclass(frozen=True)
class LanePackPlan:
    """Host plan of numpy arrays: ``S`` slabs of ``vals`` (S,8,128),
    ``lane`` (S,8,128) int16, ``ends``/``starts`` (S,8,128) int8 (starts
    may be -1); ``rb_a``/``rb_b``/``split`` (S,) the reference kernel's
    two-target packing; ``chunk_rb``/``col_off`` (S*8,) int32 per chunk;
    ``rb_mask`` (r128,) nonzero where a row block has entries."""

    rows: int
    cols: int
    kw: int
    pack: str  # "dense" or "per_rb"
    vals: np.ndarray
    lane: np.ndarray
    ends: np.ndarray
    starts: np.ndarray
    rb_a: np.ndarray
    rb_b: np.ndarray
    split: np.ndarray
    chunk_rb: np.ndarray
    col_off: np.ndarray
    rb_mask: np.ndarray
    nnz: int
    dtype: np.dtype

    @property
    def num_slabs(self) -> int:
        return int(self.vals.shape[0])

    @property
    def r128(self) -> int:
        return -(-self.rows // LANES)

    def slot_bytes(self) -> int:
        """Bytes of slab arrays streamed per SpMV."""
        return int(
            self.vals.nbytes + self.lane.nbytes + self.ends.nbytes + self.starts.nbytes
        )


def _count_slabs(m: CsrMatrix, kw: int) -> int:
    """Slab count for a candidate window width (no packing); memoized per
    (matrix, kw)."""
    memo = m._cache.setdefault("count_slabs", {})
    hit = memo.get(kw)
    if hit is not None:
        return hit
    r = m.row_ids()
    c = m.indices.astype(np.int64)
    rb = r // LANES
    w = c // (kw * LANES)
    keys = rb * (m.cols // (kw * LANES) + 2) + w
    keys = np.sort(keys)
    if len(keys) == 0:
        memo[kw] = 0
        return 0
    head = np.r_[True, keys[1:] != keys[:-1]]
    sizes = np.diff(np.append(np.nonzero(head)[0], len(keys)))
    chunks_per_group = -(-sizes // LANES)
    grb = (keys[head] // (m.cols // (kw * LANES) + 2)).astype(np.int64)
    order = np.argsort(grb, kind="stable")
    grb = grb[order]
    cg = chunks_per_group[order]
    rb_head = np.r_[True, grb[1:] != grb[:-1]]
    rb_tot = np.add.reduceat(cg, np.nonzero(rb_head)[0])
    out = int(np.sum(-(-rb_tot // SUBLANES)))
    memo[kw] = out
    return out


def plan_lanepack(
    m: CsrMatrix,
    *,
    dtype=np.float32,
    kw: Optional[int] = None,
    kw_candidates: Sequence[int] = (1, 2, 4, 8, 16),
    pack: str = "auto",
) -> LanePackPlan:
    """Plan SpMV for ``m`` in O(nnz log nnz) vectorized numpy. ``kw=None``
    and ``pack="auto"`` take the cost-model choice."""
    rows, cols = m.rows, m.cols
    nnz = m.nnz()

    c_fixed, c_kw, c_dense, c_per_rb = _cost_constants()
    if kw is None:
        # kw selection needs slab-count ratios only: sampled row bands
        # suffice on multi-M-nnz inputs
        mm, mscale = m, 1.0
        if nnz > 1_500_000:
            mm, mscale = sample_row_bands(m)
        best, best_cost = 1, float("inf")
        for cand in kw_candidates:
            if cand * LANES > cols + LANES:
                break
            s = _count_slabs(mm, cand) * mscale
            cost = s * (c_fixed + c_kw * cand)
            if cost < best_cost:
                best, best_cost = cand, cost
        kw = best

    wtot = cols // (kw * LANES) + 2
    r = m.row_ids()
    c = m.indices.astype(np.int64)
    v = m.vals.astype(dtype)

    rb0 = r // LANES
    dst = (r % LANES).astype(np.int64)
    w0 = c // (kw * LANES)
    lane = (c % (kw * LANES)).astype(np.int64)

    perm = np.lexsort((dst, w0, rb0))
    dst, lane, v = dst[perm], lane[perm], v[perm]
    gk = (rb0 * wtot + w0)[perm]

    new_group = np.empty(nnz, dtype=bool)
    if nnz:
        new_group[0] = True
        new_group[1:] = gk[1:] != gk[:-1]
        group_start = np.maximum.accumulate(np.where(new_group, np.arange(nnz), 0))
        pos = (np.arange(nnz) - group_start) % LANES
        is_chunk_head = pos == 0
        heads = np.nonzero(is_chunk_head)[0]
        head_rb = gk[heads] // wtot
        head_w = gk[heads] % wtot
    else:
        pos = np.zeros(0, np.int64)
        is_chunk_head = np.zeros(0, bool)
        head_rb = np.zeros(0, np.int64)
        head_w = np.zeros(0, np.int64)
    num_chunks = len(head_rb)

    if pack == "auto":
        # per_rb saves the two-target split, dense saves slab padding: pick
        # fewer estimated ns
        rb_change0 = np.r_[True, head_rb[1:] != head_rb[:-1]] if num_chunks else np.zeros(0, bool)
        counts0 = (
            np.diff(np.append(np.nonzero(rb_change0)[0], num_chunks))
            if num_chunks
            else np.zeros(0, np.int64)
        )
        slabs_per_rb = int(np.sum(-(-counts0 // SUBLANES)))
        slabs_dense = -(-num_chunks // SUBLANES)
        pack = "per_rb" if slabs_per_rb * c_per_rb < slabs_dense * c_dense else "dense"
        # the reference's VMEM gate on per_rb plans, kept so the choice
        # stays equal to the reference's
        if pack == "per_rb" and 32 * m.rows + 4 * m.cols > 88 * 1024 * 1024:
            pack = "dense"

    # pack chunks into slabs, at most TWO row blocks per slab ("dense"; a
    # slab is padded early when a third would enter) or one ("per_rb")
    rb_change = np.empty(num_chunks, dtype=bool)
    if num_chunks:
        rb_change[0] = True
        rb_change[1:] = head_rb[1:] != head_rb[:-1]
    counts = (
        np.diff(np.append(np.nonzero(rb_change)[0], num_chunks))
        if num_chunks
        else np.zeros(0, np.int64)
    )
    uniq_rbs = head_rb[rb_change] if num_chunks else np.zeros(0, np.int64)

    chunk_slab = np.zeros(num_chunks, dtype=np.int64)
    chunk_sublane = np.zeros(num_chunks, dtype=np.int64)
    slab_meta: list = []  # (rb_a, rb_b, split)
    cur_fill = 0  # sublanes used in the open slab (0 => no open slab)
    k = 0
    for rbi, cnt in zip(uniq_rbs, counts):
        cnt = int(cnt)
        placed = 0
        if pack == "per_rb" and cur_fill != 0:
            cur_fill = 0  # close the slab at every row-block boundary
        while placed < cnt:
            if cur_fill == 0:
                slab_meta.append([rbi, rbi, SUBLANES])
            elif slab_meta[-1][1] != rbi:
                if slab_meta[-1][0] != slab_meta[-1][1]:
                    # already two row blocks: close (pad) and open fresh
                    cur_fill = 0
                    slab_meta.append([rbi, rbi, SUBLANES])
                else:
                    # second row block enters: record the split point
                    slab_meta[-1][1] = rbi
                    slab_meta[-1][2] = cur_fill
            take = min(cnt - placed, SUBLANES - cur_fill)
            sl = len(slab_meta) - 1
            chunk_slab[k : k + take] = sl
            chunk_sublane[k : k + take] = np.arange(cur_fill, cur_fill + take)
            k += take
            placed += take
            cur_fill = (cur_fill + take) % SUBLANES
    num_slabs = len(slab_meta)

    vals_s = np.zeros((num_slabs, SUBLANES, LANES), dtype=dtype)
    lane_s = np.zeros((num_slabs, SUBLANES, LANES), dtype=np.int16)
    ends_s = np.zeros((num_slabs, SUBLANES, LANES), dtype=np.int8)
    starts_s = np.zeros((num_slabs, SUBLANES, LANES), dtype=np.int8)
    col_off = np.zeros(max(num_slabs, 1) * SUBLANES, dtype=np.int32)
    meta = (
        np.asarray(slab_meta, dtype=np.int32).reshape(num_slabs, 3)
        if num_slabs
        else np.zeros((0, 3), np.int32)
    )
    rb_a = np.zeros(max(num_slabs, 1), dtype=np.int32)
    rb_b = np.zeros(max(num_slabs, 1), dtype=np.int32)
    split = np.full(max(num_slabs, 1), SUBLANES, dtype=np.int32)
    if num_slabs:
        rb_a[:num_slabs] = meta[:, 0]
        rb_b[:num_slabs] = meta[:, 1]
        split[:num_slabs] = meta[:, 2]
    chunk_rb = np.zeros(max(num_slabs, 1) * SUBLANES, dtype=np.int32)

    if nnz:
        col_off[chunk_slab * SUBLANES + chunk_sublane] = (head_w * kw).astype(np.int32)
        chunk_rb[chunk_slab * SUBLANES + chunk_sublane] = head_rb.astype(np.int32)

        chunk_id = np.cumsum(is_chunk_head) - 1
        slab_of = chunk_slab[chunk_id]
        sub_of = chunk_sublane[chunk_id]
        vals_s[slab_of, sub_of, pos] = v
        lane_s[slab_of, sub_of, pos] = lane.astype(np.int16)

        run_head = np.empty(nnz, dtype=bool)
        run_head[0] = True
        run_head[1:] = (dst[1:] != dst[:-1]) | (chunk_id[1:] != chunk_id[:-1])
        run_tail = np.r_[run_head[1:], True]
        h = np.nonzero(run_head)[0]
        t = np.nonzero(run_tail)[0]
        starts_s[slab_of[h], sub_of[h], dst[h]] = (pos[h] - 1).astype(np.int8)
        ends_s[slab_of[h], sub_of[h], dst[h]] = pos[t].astype(np.int8)

    r128 = -(-rows // LANES)
    rb_mask = np.zeros(r128, dtype=dtype)
    if nnz:
        rb_mask[np.unique(head_rb)] = 1

    return LanePackPlan(
        rows=rows,
        cols=cols,
        kw=kw,
        pack=pack,
        vals=vals_s,
        lane=lane_s,
        ends=ends_s,
        starts=starts_s,
        rb_a=rb_a,
        rb_b=rb_b,
        split=split,
        chunk_rb=chunk_rb,
        col_off=col_off,
        rb_mask=rb_mask,
        nnz=nnz,
        dtype=np.dtype(dtype),
    )
