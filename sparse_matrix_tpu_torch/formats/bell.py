"""BELL: blocked-ELL layers with static window offsets.

Counterpart of ``sparse_matrix_tpu/formats/bell.py``. An entry ``(r, c, v)``
lives in row block ``r // 128`` at lane ``r % 128``; its element offset
``c - r`` is bucketed greedily into buckets of span <= ``span`` (128 or
256), and entries group into layers ``(bucket base, k)`` — the k-th entry
of (bucket, row). A layer is one ``(r128, 128)`` value plane plus a plane
of in-window positions (int8 storing ``pos - 128`` at span 128, int16
storing ``pos`` at 256). Sparse layers stay or spill to a LanePack
sub-plan by the reference's cost model; the cost and BR constants below
are the reference's (its TPU block sizes), kept so that the choices match.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np

from .csr import CsrMatrix, sample_row_bands
from .lanepack import LANES, SLOTS, LanePackPlan, plan_lanepack

__all__ = ["BellPlan", "plan_bell", "estimate_bell"]

# cap on kept layers
MAX_LAYERS = 48
# widest kept window span (in 128-column windows)
MAX_DSPAN = 4096
# the reference kernel's VMEM budget and step heights, inputs of its cost
# model (pick_br)
_BELL_VMEM_BUDGET = 72 * 1024 * 1024
_BR_CANDIDATES = (512, 256, 128, 64, 32)
# candidate bucket spans: 128 -> int8 lanes, 256 -> int16 lanes
_SPANS = (128, 256)


def _slot_bytes_per(span: int, dtype=np.float32) -> int:
    return np.dtype(dtype).itemsize + (1 if span == 128 else 2)


def pick_br(L: int, dmax: int, slot_bytes: int = 5) -> int:
    """The reference kernel's rows-per-grid-step for ``L`` layers."""
    for br in _BR_CANDIDATES:
        per_step = (
            L * br * LANES * slot_bytes
            + (br + max(dmax, 0) + 8) * LANES * 4
            + br * LANES * 4
        )
        if 2 * per_step <= _BELL_VMEM_BUDGET:
            return br
    return _BR_CANDIDATES[-1]


def bell_chunk_ns(br: int, dspan: int = 0) -> float:
    """Modelled per-(layer, 128-row-block) kernel cost: c0 + c1*(128/br)
    (floored) plus a linear window-span penalty."""
    from ..utils import autotune

    c0 = autotune.get("bell_chunk_c0_ns")
    c1 = autotune.get("bell_chunk_c1_ns")
    c2 = autotune.get("bell_chunk_dspan_ns")
    return max(0.5, c0 + c1 * (128.0 / max(br, 1))) + c2 * max(dspan, 0)


@dataclass(frozen=True)
class BellPlan:
    """Host BELL plan (+ optional general spill sub-plan)."""

    rows: int
    cols: int
    ds: Tuple[int, ...]  # per-layer bucket bases, len L
    vals: np.ndarray  # (L, r128, 128)
    lane: np.ndarray  # (L, r128, 128): int8 pos-128 (span 128) / int16 pos
    modes: Tuple[int, ...]  # per-layer bitmask of used 128-halves
    span: int  # 128 or 256
    nnz: int
    dtype: np.dtype
    spill: Optional[LanePackPlan]

    @property
    def num_layers(self) -> int:
        return len(self.ds)

    @property
    def r128(self) -> int:
        return -(-self.rows // LANES)

    def slot_bytes(self) -> int:
        b = int(self.vals.nbytes + self.lane.nbytes)
        if self.spill is not None:
            b += self.spill.slot_bytes()
        return b


def _bucket_bases(uo: np.ndarray, span: int) -> np.ndarray:
    """Greedy bucketing of sorted distinct element offsets: a bucket with
    base ``b = o_first >> 7`` holds every o <= 128*b + span."""
    bases = np.empty(len(uo), np.int64)
    limit = None
    cur = 0
    for i, v in enumerate(uo):
        if limit is None or v > limit:
            cur = int(v) >> 7
            limit = 128 * cur + span
        bases[i] = cur
    return bases


def _layer_keys(m: CsrMatrix, span: int):
    """Per-entry (bucket base, layer-within-(bucket, row)) keys in
    (b, r, c) order."""
    nnz = m.nnz()
    r = m.row_ids().astype(np.int64)
    c = m.indices.astype(np.int64)
    o = c - r
    uo = np.unique(o)
    bases = _bucket_bases(uo, span)
    d = bases[np.searchsorted(uo, o)]
    order = np.lexsort((c, r, d))
    d_s, r_s, c_s = d[order], r[order], c[order]
    if nnz:
        new = np.r_[True, (d_s[1:] != d_s[:-1]) | (r_s[1:] != r_s[:-1])]
        start = np.maximum.accumulate(np.where(new, np.arange(nnz), 0))
        k = np.arange(nnz) - start
        kmax = int(k.max()) + 1
        dmin = int(d_s.min())
        lkey = (d_s - dmin) * kmax + k
    else:
        k = np.zeros(0, np.int64)
        kmax, dmin = 1, 0
        lkey = np.zeros(0, np.int64)
    return order, d_s, r_s, c_s, k, lkey, kmax, dmin


def _spill_decision(lkey, r_s, r128: int, *, max_layers: int, count_scale: float = 1.0):
    """Per-layer keep/spill by modelled cost. Returns (kept lkey values
    sorted, per-entry spill mask)."""
    from ..utils import autotune

    if len(lkey) == 0:
        return np.zeros(0, np.int64), np.zeros(0, bool)
    uniq, inv, cnt = np.unique(lkey, return_inverse=True, return_counts=True)
    rb = r_s // LANES
    pair = inv.astype(np.int64) * r128 + rb
    upair = np.unique(pair)
    nrb = np.bincount((upair // r128).astype(np.int64), minlength=len(uniq))

    bell_ns = bell_chunk_ns(pick_br(min(len(uniq), max_layers), 4))
    dense_ns = autotune.get("lanepack_dense_slab_ns")
    cost_keep = r128 * bell_ns
    slabs_est = np.maximum(-(-(cnt * count_scale) // SLOTS), -(-(nrb * count_scale) // 2))
    spill_layer = slabs_est * dense_ns < cost_keep

    keep_idx = np.nonzero(~spill_layer)[0]
    if len(keep_idx) > max_layers:
        # force-spill the smallest kept layers beyond the cap
        order = np.argsort(cnt[keep_idx], kind="stable")
        drop = keep_idx[order[: len(keep_idx) - max_layers]]
        spill_layer[drop] = True
    spill_mask = spill_layer[inv]
    return uniq[~spill_layer], spill_mask


def _sampled_reject(m: CsrMatrix) -> bool:
    """O(100k) pre-filter: sampled window offsets with a huge span or far
    more distinct values than MAX_LAYERS reject for certain."""
    nnz = m.nnz()
    if nnz <= 1_000_000:
        return False
    idx = np.linspace(0, nnz - 1, 100_000).astype(np.int64)
    r = m.row_ids()[idx].astype(np.int64)
    c = m.indices[idx].astype(np.int64)
    d = (c - r) >> 7
    if int(d.max() - d.min() + 1) > MAX_DSPAN:
        return True
    return len(np.unique(d)) > 4 * MAX_LAYERS


def _span_stats(kept, spill_nnz: int, kmax: int, dmin: int, r128: int, span: int):
    """Cost and viability of one span candidate (shared by the estimate
    and plan_bell's span pick)."""
    from ..utils import autotune

    layers = len(kept)
    if layers:
        kd = kept // kmax + dmin
        dspan = int(kd.max() - kd.min() + 1)
        dmax = int(kd.max())
    else:
        dspan, dmax = 0, 0
    sb = _slot_bytes_per(span)
    br = pick_br(max(layers, 1), dmax, sb)
    cost = (
        layers * r128 * bell_chunk_ns(br, dspan) * (sb / 5.0)
        + -(-spill_nnz // SLOTS) * autotune.get("lanepack_dense_slab_ns")
    )
    viable = layers > 0 and dspan <= MAX_DSPAN
    return layers, dspan, br, float(cost), viable


def _estimate_for_span(m: CsrMatrix, span: int, *, max_layers: int,
                       r128: Optional[int] = None, total_nnz: Optional[int] = None):
    """Estimate for one span; on a sampled sub-matrix ``r128`` and
    ``total_nnz`` carry the full operator's sizes."""
    nnz = m.nnz()
    scale = 1.0 if total_nnz is None else total_nnz / max(1, nnz)
    r128 = r128 if r128 is not None else -(-m.rows // LANES)
    _, d_s, r_s, _, _, lkey, kmax, dmin = _layer_keys(m, span)
    kept, spill_mask = _spill_decision(lkey, r_s, r128, max_layers=max_layers, count_scale=scale)
    layers, dspan, br, cost, viable = _span_stats(
        kept, int(spill_mask.sum() * scale), kmax, dmin, r128, span
    )
    kept_nnz = int((~spill_mask).sum() * scale)
    return dict(
        layers=layers,
        kept_nnz=kept_nnz,
        spill_nnz=int(nnz * scale) - kept_nnz,
        cost_ns=cost,
        dspan=dspan,
        br=br,
        span=span,
        viable=viable,
    )


def estimate_bell(m: CsrMatrix, *, max_layers: int = MAX_LAYERS):
    """Dispatch estimate without the slot arrays: dict of kept layers,
    kept and spilled nnz, modelled cost (ns), window span, viability; the
    cheaper of the two spans. Memoized per matrix."""
    nnz = m.nnz()
    if nnz == 0:
        return dict(layers=0, kept_nnz=0, spill_nnz=0, cost_ns=0.0, dspan=0,
                    br=0, span=_SPANS[0], viable=True)
    memo = m._cache.setdefault("estimate_bell", {})
    hit = memo.get(max_layers)
    if hit is not None:
        return hit
    if _sampled_reject(m):
        out = dict(layers=0, kept_nnz=0, spill_nnz=nnz, cost_ns=float("inf"),
                   dspan=0, br=0, span=_SPANS[0], viable=False)
        memo[max_layers] = out
        return out
    sub, r128o, tot = m, None, None
    if nnz > 800_000:
        sub, _ = sample_row_bands(m, 400_000)
        r128o = -(-m.rows // LANES)
        tot = nnz
    best = None
    for span in _SPANS:
        est = _estimate_for_span(sub, span, max_layers=max_layers, r128=r128o, total_nnz=tot)
        if best is None or (est["viable"] and est["cost_ns"] < best["cost_ns"]):
            best = est
    memo[max_layers] = best
    return best


def plan_bell(m: CsrMatrix, *, dtype=np.float32, max_layers: int = MAX_LAYERS,
              span: Optional[int] = None) -> BellPlan:
    """Build the BELL plan in O(nnz log nnz); both spans are priced on the
    full matrix's layer keys and the cheaper one is built (``span=``
    forces one)."""
    rows, cols, nnz = m.rows, m.cols, m.nnz()
    r128 = -(-rows // LANES)
    if nnz == 0:
        return BellPlan(rows=rows, cols=cols, ds=(), vals=np.zeros((0, r128, LANES), dtype),
                        lane=np.zeros((0, r128, LANES), np.int8), modes=(), span=_SPANS[0],
                        nnz=0, dtype=np.dtype(dtype), spill=None)

    if span is None:
        best = None
        for cand in _SPANS:
            keys = _layer_keys(m, cand)
            kept_c, mask_c = _spill_decision(keys[5], keys[2], r128, max_layers=max_layers)
            _, _, _, cost, viable = _span_stats(
                kept_c, int(mask_c.sum()), keys[6], keys[7], r128, cand
            )
            # inviable candidates only win against other inviable ones
            key = (not viable, cost)
            if best is None or key < best[0]:
                best = (key, cand, keys, kept_c, mask_c)
        _, span, keys, kept, spill_mask = best
        order, d_s, r_s, c_s, k, lkey, kmax, dmin = keys
    else:
        order, d_s, r_s, c_s, k, lkey, kmax, dmin = _layer_keys(m, span)
        kept, spill_mask = _spill_decision(lkey, r_s, r128, max_layers=max_layers)
    v_s = m.vals[order].astype(dtype)

    spill_plan = None
    if spill_mask.any():
        rr, cc, vv = r_s[spill_mask], c_s[spill_mask], v_s[spill_mask]
        # entries arrive in (d, r, c) order; CSR wants (r, c)
        so = np.lexsort((cc, rr))
        rr, cc, vv = rr[so], cc[so], vv[so]
        offs = np.zeros(rows + 1, np.int64)
        offs[1:] = np.bincount(rr, minlength=rows)
        np.cumsum(offs, out=offs)
        sub = CsrMatrix(rows, cols, vv, cc.astype(np.uint32), offs, is_sorted=True)
        spill_plan = plan_lanepack(sub, dtype=dtype)

    keep = ~spill_mask
    lk, r_k, c_k, v_k, d_k = lkey[keep], r_s[keep], c_s[keep], v_s[keep], d_s[keep]
    # kept layer keys -> dense layer indices (same-b layers adjacent)
    li = np.searchsorted(kept, lk)
    ds = tuple(int(x // kmax + dmin) for x in kept)

    L = len(ds)
    lane_dt = np.int8 if span == 128 else np.int16
    vals = np.zeros((L, r128, LANES), dtype)
    lane = np.zeros((L, r128, LANES), lane_dt)
    masks = [0] * L
    if len(li):
        rb = r_k // LANES
        rl = r_k % LANES
        pos = c_k - LANES * (rb + d_k)  # in [0, span + 127]
        written = np.zeros((L, r128, LANES), bool)
        vals[li, rb, rl] = v_k
        stored = pos - LANES if span == 128 else pos
        lane[li, rb, rl] = stored.astype(lane_dt)
        written[li, rb, rl] = True
        mask_arr = np.zeros(L, np.int64)
        np.bitwise_or.at(mask_arr, li, 1 << (pos >> 7))
        # padded slots point at index 0 of the layer's first used half
        for i in range(L):
            h0 = 0
            mi = int(mask_arr[i])
            while mi and not (mi >> h0) & 1:
                h0 += 1
            pad = LANES * h0 - (LANES if span == 128 else 0)
            lane[i][~written[i]] = lane_dt(pad)
        masks = [int(x) for x in mask_arr]

    return BellPlan(rows=rows, cols=cols, ds=ds, vals=vals, lane=lane, modes=tuple(masks),
                    span=span, nnz=nnz, dtype=np.dtype(dtype), spill=spill_plan)
