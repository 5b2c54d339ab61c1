"""Stripe: the multi-level destination format for scattered SpMV.

Counterpart of ``sparse_matrix_tpu/formats/stripe.py`` (its numpy body;
the reference's native assembly is not copied). A chunk of 128 slots spans
``L`` row blocks (a stripe of ``L*128`` rows) while reading one column
window; within a stripe, (row % 128, (row % (L*128)) // 128) = (destination
lane, level) is unique per row, so per-level boundary gathers place every
row's sum. Two modes:

* ``scan`` — entries sorted by (stripe, window, row, col); a row's run in a
  chunk sums as ``incl[end] - incl[start]`` of the chunk's prefix sum
  (``starts = -1``: the run opens at slot 0; ``ends = starts = 0``: no run).
* ``select`` — entries sorted by (stripe, window, col); each chunk reads x
  from its own minimum column block, at most one entry per (lane, level)
  per chunk, so a level's value is ``p[ends]`` (slot 0 is a reserved zero).
  Same-row collisions and entries past the plan-wide gather width spill to
  a scan-mode stripe sub-plan.

Eight chunks of one stripe form a slab. The cost model and its choices are
the reference's, faults included (ROADMAP.md C1, C2), so that the port
picks what the reference picks.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np

from .csr import CsrMatrix, sample_row_bands
from .lanepack import LANES, SUBLANES

__all__ = ["StripePlan", "plan_stripe"]


@dataclass(frozen=True)
class StripePlan:
    """Host plan: ``S`` slabs of ``vals`` (S,8,128); ``lane`` (S,8,128)
    int8 (``kw == 1``) or int16 (column minus the chunk's window base);
    ``ends`` (S,L,8,128) int8; ``starts`` (S,L,8,128) int8 in scan mode,
    None in select mode; ``stripe_rb`` (S,) int32 first destination row
    block (stripe * L); ``col_off`` (S*8,) int32 window base per chunk (in
    128-column blocks); ``chunk_stripe`` (S*8,) int32; ``rb_mask``
    (r128_padded,); ``spill`` a scan-mode StripePlan or None."""

    rows: int
    cols: int
    levels: int
    kw: int
    mode: str  # "scan" | "select"
    vals: np.ndarray
    lane: np.ndarray
    ends: np.ndarray
    starts: Optional[np.ndarray]
    stripe_rb: np.ndarray
    col_off: np.ndarray
    chunk_stripe: np.ndarray
    rb_mask: np.ndarray
    nnz: int
    dtype: np.dtype
    spill: object = None  # Optional[StripePlan]

    @property
    def num_slabs(self) -> int:
        return int(self.vals.shape[0])

    @property
    def r128_padded(self) -> int:
        """Row blocks padded to whole stripes."""
        h = self.levels * LANES
        return -(-self.rows // h) * self.levels

    def slot_bytes(self) -> int:
        """Bytes of slab arrays streamed per SpMV, spill included."""
        b = int(self.vals.nbytes + self.lane.nbytes + self.ends.nbytes)
        if self.starts is not None:
            b += int(self.starts.nbytes)
        if self.spill is not None:
            b += self.spill.slot_bytes()
        return b


def _stripe_counts(m: CsrMatrix, levels: int, kw: int, cap: int) -> Tuple[int, int]:
    """(slabs, groups) for a candidate (L, KW) at chunk capacity ``cap``
    (128 scan / 127 select); memoized."""
    memo = m._cache.setdefault("count_stripe_slabs", {})
    hit = memo.get((levels, kw, cap))
    if hit is not None:
        return hit
    h = levels * LANES
    r = m.row_ids()
    w = m.indices.astype(np.int64) // (kw * LANES)
    wtot = m.cols // (kw * LANES) + 2
    keys = np.sort((r // h) * wtot + w)
    if len(keys) == 0:
        memo[(levels, kw, cap)] = (0, 0)
        return (0, 0)
    head = np.r_[True, keys[1:] != keys[:-1]]
    sizes = np.diff(np.append(np.nonzero(head)[0], len(keys)))
    chunks_per_group = -(-sizes // cap)
    grp_stripe = (keys[head] // wtot).astype(np.int64)
    order = np.argsort(grp_stripe, kind="stable")
    cg = chunks_per_group[order]
    gs = grp_stripe[order]
    s_head = np.r_[True, gs[1:] != gs[:-1]]
    per_stripe = np.add.reduceat(cg, np.nonzero(s_head)[0])
    out = (int(np.sum(-(-per_stripe // SUBLANES))), int(len(sizes)))
    memo[(levels, kw, cap)] = out
    return out


def _select_spill_stats(m: CsrMatrix, levels: int, kw: int) -> Tuple[float, int, float]:
    """(spill fraction, plan gather width kw_g, modelled spill ns) of a
    select-mode candidate, on sampled row bands above 300k nnz; memoized.
    The spill (collisions and gather-width overflow) is priced with the
    scan model on its own slab counts."""
    memo = m._cache.setdefault("stripe_spill_stats", {})
    hit = memo.get((levels, kw))
    if hit is not None:
        return hit
    nnz = m.nnz()
    if nnz == 0:
        memo[(levels, kw)] = (0.0, 1, 0.0)
        return memo[(levels, kw)]
    if nnz > 300_000:
        sub, _ = sample_row_bands(m, target_nnz=300_000)
        if sub is not m:
            m, nnz = sub, sub.nnz()
    h = levels * LANES
    r = m.row_ids().astype(np.int64)
    c = m.indices.astype(np.int64)
    w = c // (kw * LANES)
    stripe = r // h
    wtot = m.cols // (kw * LANES) + 2
    gk = stripe * wtot + w
    order = np.lexsort((r, c, gk))
    gks = gk[order]
    cs = c[order]
    new_group = np.r_[True, gks[1:] != gks[:-1]]
    group_start = np.maximum.accumulate(np.where(new_group, np.arange(nnz), 0))
    chunk = group_start * 64 + (np.arange(nnz) - group_start) // (LANES - 1)
    ch_head = np.r_[True, chunk[1:] != chunk[:-1]]
    heads = np.flatnonzero(ch_head)
    cmin = np.minimum.reduceat(cs, heads) >> 7
    spans = np.maximum.reduceat(cs, heads) // LANES - cmin + 1
    kw_cap = max(1, int(np.percentile(spans, 90)))
    kw_g = int(min(int(spans.max()), kw_cap))
    cid = np.cumsum(ch_head) - 1
    spill_mask = (cs - (cmin[cid] << 7)) >= kw_cap * LANES
    rs = r[order]
    o2 = np.lexsort((rs, chunk))
    dup = (chunk[o2][1:] == chunk[o2][:-1]) & (rs[o2][1:] == rs[o2][:-1])
    spill_mask[o2[1:][dup]] = True
    n_sp = int(np.count_nonzero(spill_mask))
    spill_ns = 0.0
    if n_sp:
        from ..utils import autotune

        c0 = autotune.get("stripe_fixed_ns")
        ck = autotune.get("stripe_kw_ns")
        cl = autotune.get("stripe_lvl_ns")
        sp_r, sp_c = rs[spill_mask], cs[spill_mask]
        best = None
        for sl_ in (4, 8):
            for sk_ in (4, 8, 16):
                if sk_ > 1 and (sk_ // 2) * LANES > m.cols + LANES:
                    continue
                hh = sl_ * LANES
                ww = sk_ * LANES
                wt = m.cols // ww + 2
                keys = np.sort((sp_r // hh) * wt + sp_c // ww)
                hd = np.r_[True, keys[1:] != keys[:-1]]
                sizes = np.diff(np.append(np.flatnonzero(hd), n_sp))
                slabs_sp = float(np.sum(-(-sizes // LANES))) / SUBLANES + 1
                t = slabs_sp * (c0 + ck * sk_ + cl * sl_)
                if best is None or t < best:
                    best = t
        spill_ns = best if best is not None else 0.0
    out = (n_sp / nnz, kw_g, spill_ns)
    memo[(levels, kw)] = out
    return out


def _cost_constants():
    from ..utils import autotune

    return (
        autotune.get("stripe_fixed_ns"),
        autotune.get("stripe_kw_ns"),
        autotune.get("stripe_lvl_ns"),
        autotune.get("stripe_sel_fixed_ns"),
        autotune.get("stripe_sel_kw_ns"),
        autotune.get("stripe_sel_lvl_ns"),
    )


def _mode_cost(m: CsrMatrix, mode: str, lc: int, kc: int, nnz: int,
               consts, best: Optional[float] = None) -> float:
    """Modelled apply ns of (mode, L, KW); ``best`` prunes select
    candidates whose spill-free base already loses. (Above 300k nnz the
    spill term comes from a 300k sample and is added unscaled: ROADMAP.md
    C1, kept so that the choice equals the reference's.)"""
    c0, ck, cl, s0, sk, sl = consts
    if mode == "scan":
        slabs, _ = _stripe_counts(m, lc, kc, 128)
        return slabs * (c0 + ck * kc + cl * lc)
    slabs, groups = _stripe_counts(m, lc, kc, 127)
    if slabs == 0:
        return 0.0
    if best is not None and slabs * (s0 + sk + sl * lc) >= best:
        return float("inf")
    frac, kw_g, spill_ns = _select_spill_stats(m, lc, kc)
    base = slabs * (s0 + sk * kw_g + sl * lc)
    if best is not None and base >= best:
        return float("inf")
    return base + spill_ns


def plan_stripe(
    m: CsrMatrix,
    *,
    dtype=np.float32,
    levels: Optional[int] = None,
    kw: Optional[int] = None,
    mode: str = "auto",
    level_candidates: Sequence[int] = (1, 2, 4, 8),
    kw_candidates: Sequence[int] = (1, 2, 4, 8, 16),
) -> StripePlan:
    """Plan SpMV for ``m`` in O(nnz log nnz) vectorized numpy. ``levels``
    (L), ``kw`` and ``mode`` default to the cost-model argmin over the
    candidate grid."""
    rows, cols = m.rows, m.cols
    nnz = m.nnz()

    consts = _cost_constants()
    if levels is None or kw is None or mode == "auto":
        mm, mscale = m, 1.0
        if nnz > 1_500_000:
            mm, mscale = sample_row_bands(m)
        best, best_cost = ("scan", 1, 1), float("inf")
        for mc in (("scan", "select") if mode == "auto" else (mode,)):
            for lc in (level_candidates if levels is None else (levels,)):
                if lc > 1 and (lc // 2) * LANES >= rows + LANES:
                    continue
                for kc in (kw_candidates if kw is None else (kw,)):
                    if kc > 1 and (kc // 2) * LANES > cols + LANES:
                        continue
                    cost = _mode_cost(mm, mc, lc, kc, mm.nnz(), consts, best=best_cost / mscale)
                    cost *= mscale
                    if cost < best_cost:
                        best, best_cost = (mc, lc, kc), cost
        mode_f = best[0] if mode == "auto" else mode
        levels = best[1] if levels is None else levels
        kw = best[2] if kw is None else kw
    else:
        mode_f = mode
    lvl = int(levels)
    kwi = int(kw)
    h = lvl * LANES
    wsz = kwi * LANES

    r = m.row_ids().astype(np.int64)
    c = m.indices.astype(np.int64)
    v = m.vals.astype(dtype)

    stripe = r // h
    w = c // wsz

    if mode_f == "scan":
        perm = np.lexsort((c, r, w, stripe))
        cap = LANES
    else:
        perm = np.lexsort((r, c, w, stripe))
        cap = LANES - 1
    r, w, v, c_s = r[perm], w[perm], v[perm], c[perm]
    stripe = stripe[perm]
    wtot = cols // wsz + 2
    gk = stripe * wtot + w

    spill_mask = np.zeros(nnz, dtype=bool)
    if nnz:
        new_group = np.empty(nnz, dtype=bool)
        new_group[0] = True
        new_group[1:] = gk[1:] != gk[:-1]
        group_start = np.maximum.accumulate(np.where(new_group, np.arange(nnz), 0))
        pos_in_group = np.arange(nnz) - group_start
        pos = pos_in_group % cap
        if mode_f == "select":
            pos = pos + 1  # slot 0 reserved zero (empty-gather target)
        is_chunk_head = (pos_in_group % cap) == 0
        heads = np.nonzero(is_chunk_head)[0]
        head_stripe = stripe[heads]
        head_w = w[heads]
    else:
        pos = np.zeros(0, np.int64)
        is_chunk_head = np.zeros(0, bool)
        heads = np.zeros(0, np.int64)
        head_stripe = np.zeros(0, np.int64)
        head_w = np.zeros(0, np.int64)
    num_chunks = len(heads)

    # pack chunks 8 per slab within each stripe (a slab never straddles a
    # stripe)
    if num_chunks:
        s_change = np.r_[True, head_stripe[1:] != head_stripe[:-1]]
        chunk_in_stripe = np.arange(num_chunks) - np.maximum.accumulate(
            np.where(s_change, np.arange(num_chunks), 0))
        s_idx = np.nonzero(s_change)[0]
        cnt = np.diff(np.append(s_idx, num_chunks))
        slabs_per = -(-cnt // SUBLANES)
        base = np.zeros(len(cnt), dtype=np.int64)
        np.cumsum(slabs_per[:-1], out=base[1:])
        stripe_slab_base = np.repeat(base, cnt)
        chunk_slab = stripe_slab_base + chunk_in_stripe // SUBLANES
        chunk_sub = chunk_in_stripe % SUBLANES
        num_slabs = int(np.sum(slabs_per))
    else:
        chunk_slab = np.zeros(0, np.int64)
        chunk_sub = np.zeros(0, np.int64)
        num_slabs = 0

    # select mode: each chunk's window starts at its own minimum column
    # block; the plan-wide gather width kw_g is capped at the 90th
    # percentile chunk span and the entries past it spill
    chunk_id = np.cumsum(is_chunk_head) - 1 if nnz else np.zeros(0, np.int64)
    if nnz and mode_f == "select":
        chunk_min_c = np.minimum.reduceat(c_s, heads) >> 7
        chunk_max_c = np.maximum.reduceat(c_s, heads)
        spans = (chunk_max_c // LANES - chunk_min_c + 1).astype(np.int64)
        kw_cap = max(1, int(np.percentile(spans, 90)))
        lane_vals = c_s - (chunk_min_c[chunk_id] << 7)
        over = lane_vals >= kw_cap * LANES
        spill_mask |= over
        kw_g = int(min(np.max(spans), kw_cap))
        chunk_w_off = chunk_min_c.astype(np.int32)
        # collisions: one entry per (lane, level) per chunk; same-row
        # repeats within a chunk spill
        order2 = np.lexsort((r, chunk_id))
        ci2, r2 = chunk_id[order2], r[order2]
        dup2 = np.r_[False, (ci2[1:] == ci2[:-1]) & (r2[1:] == r2[:-1])]
        spill_mask[order2[dup2]] = True
    else:
        kw_g = kwi
        lane_vals = c_s - (head_w[chunk_id] * wsz if nnz else 0)
        chunk_w_off = (head_w * kwi).astype(np.int32) if nnz else head_w

    lane_dtype = np.int8 if kw_g == 1 else np.int16
    vals_s = np.zeros((num_slabs, SUBLANES, LANES), dtype=dtype)
    lane_s = np.zeros((num_slabs, SUBLANES, LANES), dtype=lane_dtype)
    ends_s = np.zeros((num_slabs, lvl, SUBLANES, LANES), dtype=np.int8)
    starts_s = (
        np.zeros((num_slabs, lvl, SUBLANES, LANES), dtype=np.int8)
        if mode_f == "scan" else None
    )
    col_off = np.zeros(max(num_slabs, 1) * SUBLANES, dtype=np.int32)
    chunk_stripe = np.zeros(max(num_slabs, 1) * SUBLANES, dtype=np.int32)
    stripe_rb = np.zeros(max(num_slabs, 1), dtype=np.int32)

    if nnz:
        ci = chunk_slab * SUBLANES + chunk_sub
        col_off[ci] = chunk_w_off
        chunk_stripe[ci] = head_stripe.astype(np.int32)
        stripe_rb[chunk_slab] = (head_stripe * lvl).astype(np.int32)

        keep = ~spill_mask
        slab_of = chunk_slab[chunk_id]
        sub_of = chunk_sub[chunk_id]
        vals_s[slab_of[keep], sub_of[keep], pos[keep]] = v[keep]
        lane_s[slab_of[keep], sub_of[keep], pos[keep]] = lane_vals[keep].astype(lane_dtype)

        dst = (r % LANES).astype(np.int64)
        lev = ((r % h) // LANES).astype(np.int64)
        if mode_f == "scan":
            run_head = np.empty(nnz, dtype=bool)
            run_head[0] = True
            run_head[1:] = (r[1:] != r[:-1]) | (chunk_id[1:] != chunk_id[:-1])
            run_tail = np.r_[run_head[1:], True]
            hh = np.nonzero(run_head)[0]
            tt = np.nonzero(run_tail)[0]
            starts_s[slab_of[hh], lev[hh], sub_of[hh], dst[hh]] = (pos[hh] - 1).astype(np.int8)
            ends_s[slab_of[tt], lev[tt], sub_of[tt], dst[tt]] = pos[tt].astype(np.int8)
        else:
            ends_s[slab_of[keep], lev[keep], sub_of[keep], dst[keep]] = pos[keep].astype(np.int8)

    spill_plan = None
    if spill_mask.any():
        # the spill is scatter-class too: a scan-mode stripe plan (scan mode
        # never spills, so the recursion is one level deep)
        sp_idx = np.nonzero(spill_mask)[0]
        sp = CsrMatrix.from_coo(rows, cols, r[sp_idx], c_s[sp_idx], v[sp_idx],
                                sum_duplicates=False)
        spill_plan = plan_stripe(sp, dtype=dtype, mode="scan")

    rb_mask = np.zeros(max(-(-rows // h) * lvl, 1), dtype=dtype)
    if nnz:
        rb_used = np.unique(r // LANES)
        rb_mask[rb_used] = 1

    return StripePlan(
        rows=rows,
        cols=cols,
        levels=lvl,
        kw=int(kw_g),
        mode=mode_f,
        vals=vals_s,
        lane=lane_s,
        ends=ends_s,
        starts=starts_s,
        stripe_rb=stripe_rb,
        col_off=col_off,
        chunk_stripe=chunk_stripe,
        rb_mask=rb_mask,
        nnz=nnz,
        dtype=np.dtype(dtype),
        spill=spill_plan,
    )
