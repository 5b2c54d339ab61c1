"""Planned SpMV operator with automatic format selection.

Counterpart of ``sparse_matrix_tpu/ops/operator.py``. The dispatch below is
the reference's decision code over the port's copies of its estimators
(``estimate_bell``, ``_count_slabs``, ``_chunk_keys``,
``sample_row_bands``, ``stripe._mode_cost``, ``autotune.get``), so the
port's automatic choice equals the reference's ``SpmvOperator(m).format``
for ``dia``, ``hybrid``, ``aligned``, ``lanepack``, ``bell``, ``stripe``
and ``ell``, and its stripe plan the reference's ``(mode, L, KW)``.

:meth:`SpmvOperator.matmat` runs every format, through the SpMM kernels
where the reference runs its packed SpMM kernels.

Not ported: **row and column splits** — the reference shards operators
past its VMEM caps (``_VMEM_X_LIMIT``, ``_ROWS_SPLIT_LIMIT``) and
row-splits LanePack plans past its 1 MB SMEM budget. The H100 kernels have
neither wall, so the port plans such a matrix unsplit, in the format its
shards would take: a banded matrix goes to DIA as in the reference, an
SMEM-bound LanePack winner is planned as one LanePack plan, and the rest
runs the regular dispatch.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..device import require_device
from ..formats.aligned import AlignedPlan, _chunk_keys, plan_aligned
from ..formats.bell import BellPlan, estimate_bell, plan_bell
from ..formats.csr import CsrMatrix, sample_row_bands
from ..formats.dia import DiaMatrix, try_dia_from_csr
from ..formats.lanepack import LanePackPlan, _count_slabs, plan_lanepack
from ..formats.lanepack import _cost_constants as _lanepack_cost_constants
from ..formats.stripe import StripePlan, _mode_cost, _stripe_counts, plan_stripe
from ..formats.stripe import _cost_constants as _stripe_cost_constants
from ..utils import autotune
from .spmv import _TORCH_DTYPES, _t

__all__ = [
    "SpmvOperator",
    "split_bands",
    "save_operator_plan",
    "load_operator_plan",
]

# a diagonal goes to the DIA part when at least this fraction of its slots
# hold nonzeros (the HYB-style split threshold)
BAND_FILL_THRESHOLD = 0.5
MIN_BAND_NNZ_FRACTION = 0.3  # hybrid only pays if bands cover enough nnz

_NP_DTYPES = {v: k for k, v in _TORCH_DTYPES.items()}


def split_bands(
    m: CsrMatrix, *, fill_threshold: float = BAND_FILL_THRESHOLD
) -> tuple:
    """Split into (banded part, residual part) by per-diagonal fill:
    well-filled diagonals go to index-free DIA, stragglers to a general
    format. Returns (dense_band_csr, residual_csr); either may be empty."""
    r = m.row_ids()
    c = m.indices.astype(np.int64)
    offs = c - r
    shift = m.rows - 1
    span = m.rows + m.cols - 1
    counts_d = np.bincount(offs + shift, minlength=span)
    uniq = np.nonzero(counts_d)[0]
    counts = counts_d[uniq]
    uniq = uniq - shift
    band_len = np.minimum(m.rows, m.cols - uniq.clip(min=0)) - np.maximum(0, -uniq).clip(min=0)
    band_len = np.maximum(band_len, 1)
    good_mask = np.zeros(span, dtype=bool)
    good_mask[uniq[counts >= fill_threshold * band_len] + shift] = True
    in_band = good_mask[offs + shift]

    def subset(mask):
        offsets = np.zeros(m.rows + 1, dtype=m.offsets.dtype)
        offsets[1:] = np.bincount(r[mask], minlength=m.rows)
        np.cumsum(offsets, out=offsets)
        return CsrMatrix(
            m.rows, m.cols, m.vals[mask], m.indices[mask], offsets, is_sorted=m.is_sorted
        )

    return subset(in_band), subset(~in_band)


class SpmvOperator:
    """``op = SpmvOperator(csr, device="cuda"); y = op(x)`` — planned SpMV.

    Formats, picked by structure as in the reference: ``dia`` (banded),
    ``hybrid`` (well-filled diagonals in DIA + residual in LanePack or ELL),
    ``aligned``, ``bell``, ``stripe``, ``lanepack`` and ``ell``. ``force``
    names one of them. ``values_dtype=torch.bfloat16`` stores the DIA band or BELL value
    planes half-width (the other formats raise); applies widen to ``dtype``
    before they accumulate. The host plan is built once; its arrays live on
    ``device`` and ``__call__`` takes an ``x`` on that device.
    """

    # above this nnz the dispatch cost estimators run on sampled row bands
    _SAMPLED_COSTS_NNZ = 500_000

    def __init__(self, m: CsrMatrix, *, device, dtype=torch.float32,
                 force: Optional[str] = None, values_dtype=None):
        if dtype not in _NP_DTYPES:
            raise TypeError(f"dtype must be one of {list(_NP_DTYPES)}, got {dtype}")
        self.device = require_device(device)
        self.dtype = dtype
        self._values_dtype = values_dtype
        self.rows, self.cols = m.rows, m.cols
        self.nnz = m.nnz()
        self._dia = None
        self._plan = None
        self._aligned = None
        self._bell = None
        self._stripe = None
        self._ell = None
        self._ell_spill = None
        self._dispatch(m, _NP_DTYPES[dtype], force)

    def _dispatch(self, m: CsrMatrix, dtype, force):
        if force == "stripe":
            # the reference plans a forced stripe operator on plan_stripe's
            # own grid (L = 1 included)
            self._set_stripe(m, dtype)
            return

        if force == "aligned":
            self._set_aligned(m, dtype)
            return

        if force == "bell":
            self._set_bell(m, dtype)
            return

        if force in (None, "dia"):
            dia = try_dia_from_csr(m, dtype=dtype)
            if dia is not None:
                self.format = "dia"
                self._set_dia(dia)
                return
            if force == "dia":
                raise ValueError("matrix is not band-structured enough for DIA")

        if force in (None, "hybrid") and (
            force == "hybrid" or self._hybrid_plausible(m)
        ):
            banded, residual = split_bands(m)
            if (
                banded.nnz() >= MIN_BAND_NNZ_FRACTION * max(1, m.nnz())
                and residual.nnz() > 0
            ):
                dia = try_dia_from_csr(banded, dtype=dtype, min_fill=0.0)
                if dia is not None:
                    self.format = "hybrid"
                    self._set_dia(dia)
                    # residual may itself be hyper-sparse: route it by the
                    # same LanePack-vs-ELL guard as the reference
                    if self._lanepack_viable(residual):
                        self._set_plan(residual, dtype)
                    else:
                        self._set_ell(residual, dtype)
                    return
            if force == "hybrid":
                raise ValueError("no useful band/residual split")

        if force in (None, "ell"):
            # hyper-sparse guard: when LanePack packing would be
            # pathologically empty and padded ELL is compact, price ELL
            # against the kernels (the reference's rule, its constants)
            plan_est = self._estimate_lanepack_bytes(m)
            row_max = int(np.diff(m.offsets).max()) if m.nnz() else 1
            ell_bytes = m.rows * max(1, row_max) * 8
            if force == "ell":
                self._set_ell(m, dtype)
                return
            if plan_est > 4 * m.nnz() * 8 and ell_bytes < plan_est / 2:
                if plan_est > 1 << 29:
                    self._set_ell(m, dtype)
                    return
                t_aligned, t_gen, _ = self._general_costs(m)
                t_lp = (
                    t_gen
                    if t_gen is not None and self._lanepack_viable(m)
                    else float("inf")
                )
                ell_ns = m.rows * max(1, row_max) * autotune.get("ell_gather_ns")
                if ell_ns <= min(t_aligned, t_lp):
                    self._set_ell(m, dtype)
                    return
            if not self._lanepack_viable(m):
                # the reference's branch for LanePack plans past its 1 MB
                # SMEM budget
                est = estimate_bell(m)
                bell_ok = est["viable"] and est["spill_nnz"] <= est["kept_nnz"]
                t_aligned, t_gen, slabs = self._general_costs(m)
                t_bell = est["cost_ns"] if bell_ok else float("inf")
                t_stripe, stripe_ok, scfg = self._stripe_cost_and_viable(m)
                if stripe_ok and t_stripe < min(
                    t_aligned, t_bell,
                    t_gen if t_gen is not None else float("inf"),
                ):
                    self._set_stripe(m, dtype, cfg=scfg)
                    return
                if (
                    t_gen is not None
                    and slabs is not None
                    and t_gen < 0.7 * min(t_aligned, t_bell)
                ):
                    nsplit = int(np.ceil(slabs * 44.0 * 1.3 / 800_000)) + 1
                    if 2 <= nsplit <= 64 and m.rows >= 256 * nsplit:
                        # the reference row-splits here so each shard's
                        # LanePack plan fits SMEM; the port has no SMEM
                        # budget and plans the LanePack winner whole
                        self._set_plan(m, dtype)
                        return
                if bell_ok:
                    self._set_bell(m, dtype)
                    return
                if m.nnz() > 0:
                    self._set_aligned(m, dtype)
                    return
                self._set_ell(m, dtype)
                return

        # BELL vs aligned vs general LanePack by estimated kernel time; an
        # explicit force="lanepack" bypasses the comparison
        if force is None:
            choice = self._general_choice(m)
            if choice == "stripe":
                # the counts are memoized: this recovers the grid argmin so
                # plan_stripe skips its own grid
                _t, _ok, scfg = self._stripe_cost_and_viable(m)
                self._set_stripe(m, dtype, cfg=scfg)
                return
            if choice == "bell":
                self._set_bell(m, dtype)
                return
            if choice == "aligned":
                self._set_aligned(m, dtype)
                return

        self._set_plan(m, dtype)

    # -- dispatch estimators (the reference's, unchanged) -------------------

    @staticmethod
    def _general_costs(m: CsrMatrix):
        """(t_aligned, t_lanepack, lanepack_slabs) estimated kernel ns for
        the aligned and general LanePack families plus the best-kw slab
        count; counts come from sampled row bands on large matrices."""
        scale = 1.0
        mm = m
        if m.nnz() > SpmvOperator._SAMPLED_COSTS_NNZ:
            mm, scale = sample_row_bands(m)
        _, _, _, ck = _chunk_keys(mm)
        chunks = int(len(np.unique(ck))) * scale
        if mm.nnz():
            rbs = mm.row_ids() // 128
            heads = np.nonzero(np.r_[True, rbs[1:] != rbs[:-1]])[0]
            cc = mm.indices.astype(np.int64)
            ws_bytes = 4.0 * float(
                np.median(
                    np.maximum.reduceat(cc, heads)
                    - np.minimum.reduceat(cc, heads)
                    + 1
                )
            )
        else:
            ws_bytes = 1.0
        lo, hi = autotune.get("aligned_chunk_floor_lo_ns"), autotune.get(
            "aligned_chunk_floor_hi_ns"
        )
        frac = min(1.0, max(0.0, (np.log2(max(ws_bytes, 1.0)) - 15.0) / 5.0))
        t_aligned = max(
            (chunks / 8.0) * autotune.get("aligned_slab_base_ns")
            + m.nnz() * autotune.get("aligned_slab_per_entry_ns"),
            chunks * (lo + (hi - lo) * frac),
        )
        c_fixed, c_kw, _, _ = _lanepack_cost_constants()
        t_gen = None
        gen_slabs = None
        for kw in (1, 2, 4, 8, 16):
            if kw * 128 > m.cols + 128:
                break
            s = _count_slabs(mm, kw) * scale
            t = s * (c_fixed + c_kw * kw)
            if t_gen is None or t < t_gen:
                t_gen, gen_slabs = t, s
        return t_aligned, t_gen, gen_slabs

    @staticmethod
    def _stripe_cost_and_viable(m: CsrMatrix):
        """(best stripe ns, viable, (mode, L, KW) argmin) over the
        reference's pricing grid (L in (2, 4, 8) only, ROADMAP.md C2), with
        sampled counts on large matrices; "viable" is the reference's SMEM
        budget, a dispatch input here."""
        mm, scale = SpmvOperator._sampled_for_counts(m)
        consts = _stripe_cost_constants()
        best, best_slabs, best_cfg = None, None, None
        for mode in ("scan", "select"):
            for lc in (2, 4, 8):
                if (lc // 2) * 128 >= m.rows + 128:
                    continue
                for kc in (1, 2, 4, 8, 16):
                    if kc > 1 and (kc // 2) * 128 > m.cols + 128:
                        continue
                    t = _mode_cost(
                        mm, mode, lc, kc, mm.nnz(), consts,
                        best=None if best is None else best / scale,
                    ) * scale
                    if best is None or t < best:
                        best = t
                        best_cfg = (mode, lc, kc)
                        best_slabs = _stripe_counts(
                            mm, lc, kc, 128 if mode == "scan" else 127,
                        )[0] * scale
        if best is None:
            return float("inf"), False, None
        viable = best_slabs is not None and best_slabs * 36 < 800_000
        return best, viable, best_cfg

    @staticmethod
    def _general_choice(m: CsrMatrix) -> str:
        """Pick the general-path family by estimated kernel time: ``bell``,
        ``aligned``, ``stripe`` or ``lanepack``."""
        if m.nnz() == 0:
            return "lanepack"
        est = estimate_bell(m)
        bell_ok = est["viable"] and est["spill_nnz"] <= est["kept_nnz"]
        t_bell = est["cost_ns"] if bell_ok else float("inf")
        t_aligned, t_gen, _slabs = SpmvOperator._general_costs(m)
        t_stripe, stripe_ok, _scfg = SpmvOperator._stripe_cost_and_viable(m)
        t_gen_f = t_gen if t_gen is not None else float("inf")
        if stripe_ok and t_stripe < 0.9 * min(t_bell, t_aligned, t_gen_f):
            return "stripe"
        if t_bell < t_aligned and (t_gen is None or t_bell < t_gen):
            return "bell"
        if t_gen is None or t_aligned < t_gen:
            return "aligned"
        return "lanepack"

    @staticmethod
    def _hybrid_plausible(m: CsrMatrix) -> bool:
        """Sampled pre-filter for the hybrid split probe: the nnz fraction
        on well-filled diagonals of a row-band sample."""
        if m.nnz() <= SpmvOperator._SAMPLED_COSTS_NNZ:
            return True
        sub, _ = sample_row_bands(m)
        so = sub.indices.astype(np.int64) - sub.row_ids()
        _, counts = np.unique(so, return_counts=True)
        good = counts >= BAND_FILL_THRESHOLD * 0.5 * sub.rows
        frac = counts[good].sum() / max(1, sub.nnz())
        return frac >= 0.5 * MIN_BAND_NNZ_FRACTION

    @staticmethod
    def _sampled_for_counts(m: CsrMatrix):
        """(sub, scale) for slab-count estimates: sampled row bands above
        the cost cap."""
        if m.nnz() > SpmvOperator._SAMPLED_COSTS_NNZ:
            return sample_row_bands(m)
        return m, 1.0

    @staticmethod
    def _lanepack_viable(m: CsrMatrix) -> bool:
        """The reference's SMEM budget test for LanePack plans (a dispatch
        input here: it decides formats, not whether the kernel can run)."""
        mm, scale = SpmvOperator._sampled_for_counts(m)
        slabs = min(
            (
                _count_slabs(mm, kw) * scale
                for kw in (1, 2, 4, 8, 16)
                if kw * 128 <= m.cols + 128
            ),
            default=0,
        )
        return slabs * 8 * 4 + slabs * 3 * 4 < 800_000

    @staticmethod
    def _estimate_lanepack_bytes(m: CsrMatrix) -> int:
        mm, scale = SpmvOperator._sampled_for_counts(m)
        best = None
        for kw in (1, 2, 4, 8, 16):
            if kw * 128 > m.cols + 128:
                break
            s = _count_slabs(mm, kw) * scale
            b = int(s) * 1024 * 8
            best = b if best is None else min(best, b)
        return best if best is not None else m.nnz() * 8

    # -- plan builders ------------------------------------------------------

    def _no_bf16(self, fmt: str):
        if self._values_dtype is not None:
            raise ValueError(
                f"values_dtype is only supported on the streaming formats "
                f"(dia, bell); dispatch chose {fmt!r} — force='dia' or "
                f"force='bell', or drop values_dtype"
            )

    def _set_ell(self, m, dtype):
        from .spmv import ell_from_csr, ell_spill_from_csr

        self._no_bf16("ell")
        # width guard: one dense row must not inflate the padded array to
        # rows x max_row_nnz — skewed matrices get a capped ELL + COO spill
        row_nnz = np.diff(m.offsets)
        w_full = max(1, int(row_nnz.max())) if m.nnz() else 1
        q99 = int(np.quantile(row_nnz, 0.99)) if m.nnz() else 1
        if w_full > 2 * max(1, 2 * q99):
            ev, ec, sr, sc, sv = ell_spill_from_csr(m, dtype=dtype)
            self._set_ell_arrays((ev, ec), (sr, sc, sv))
        else:
            self._set_ell_arrays(ell_from_csr(m, dtype=dtype), None)

    def _set_ell_arrays(self, ell, spill):
        if getattr(self, "format", None) != "hybrid":
            self.format = "ell"
        self._ell_host = (ell, spill)
        self._ell = tuple(_t(a, self.device) for a in ell)
        self._ell_spill = None if spill is None else tuple(_t(a, self.device) for a in spill)

    def _set_aligned(self, m, dtype):
        self._no_bf16("aligned")
        self._set_aligned_plan(plan_aligned(m, dtype=dtype))

    def _set_aligned_plan(self, plan):
        from .spmv import aligned_device_arrays

        self.format = "aligned"
        self._aligned = plan
        self._ali_arrs = aligned_device_arrays(plan, self.device)

    def _set_bell(self, m, dtype):
        self._set_bell_plan(plan_bell(m, dtype=dtype))

    def _set_bell_plan(self, plan):
        from .spmv_bell import bell_device_arrays

        self.format = "bell"
        self._bell = plan
        self._bell_arrs = bell_device_arrays(plan, self.device, values_dtype=self._values_dtype)

    def _set_stripe(self, m, dtype, cfg=None):
        self._no_bf16("stripe")
        if cfg is not None:
            mode, lvl, kw = cfg
            plan = plan_stripe(m, dtype=dtype, mode=mode, levels=lvl, kw=kw)
        else:
            plan = plan_stripe(m, dtype=dtype)
        self._set_stripe_plan(plan)

    def _set_stripe_plan(self, plan: StripePlan):
        from .spmv import stripe_device_arrays

        self.format = "stripe"
        self._stripe = plan
        self._stripe_arrs = stripe_device_arrays(plan, self.device)

    def _set_dia(self, dia: DiaMatrix):
        from .spmv_dia import dia_device_arrays

        self._dia = dia
        self._dia_arrs = dia_device_arrays(dia, self.device, values_dtype=self._values_dtype)

    def _set_plan(self, m, dtype):
        self._set_lanepack_plan(plan_lanepack(m, dtype=dtype))

    def _set_lanepack_plan(self, plan: LanePackPlan):
        from .spmv import lanepack_device_arrays

        # hybrid keeps its DIA part bf16-capable; the LanePack residual
        # stays f32 (it is the minority nnz by construction)
        if getattr(self, "format", None) != "hybrid":
            self._no_bf16("lanepack")
            self.format = "lanepack"
        self._plan = plan
        self._lp_arrs = lanepack_device_arrays(plan, self.device)

    # -- apply --------------------------------------------------------------

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device != self.device:
            raise ValueError(f"x is on {x.device}, the operator on {self.device}")
        y = None
        if self._bell is not None:
            from .spmv_bell import spmv_bell

            y = spmv_bell(self._bell, x, device_arrays=self._bell_arrs)
        if self._aligned is not None:
            from .spmv import spmv_aligned

            y = spmv_aligned(self._aligned, x, device_arrays=self._ali_arrs)
        if self._stripe is not None:
            from .spmv import spmv_stripe

            y = spmv_stripe(self._stripe, x, device_arrays=self._stripe_arrs)
        if self._dia is not None:
            from .spmv_dia import spmv_dia

            y = spmv_dia(self._dia, x, device_arrays=self._dia_arrs)
        if self._plan is not None:
            from .spmv import spmv_lanepack

            y2 = spmv_lanepack(self._plan, x, device_arrays=self._lp_arrs)
            y = y2 if y is None else y + y2
        if self._ell is not None:
            from .spmv import spmv_ell, spmv_ell_spill

            if self._ell_spill is not None:
                y3 = spmv_ell_spill(*self._ell, *self._ell_spill, x)
            else:
                y3 = spmv_ell(*self._ell, x)
            y = y3 if y is None else y + y3
        return y

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        """``Y = A @ X`` for ``X`` of shape (cols, K), routed as the
        reference routes it: DIA (and a hybrid's band part) through the DIA
        SpMM kernel, BELL at K >= 8 through the BELL SpMM kernel, both in
        balanced chunks of at most 16 columns (a DIA chunk of one through
        the SpMV kernel); BELL below K = 8 column by column through its
        SpMV kernel; aligned through the aligned SpMM kernel; LanePack (and
        a hybrid's LanePack part) through the LanePack SpMM kernel, or
        column by column through its SpMV kernel on large plans at K < 8
        (``lanepack_spmm_uses_kernel``); stripe column by column; ELL as a
        plain gather. Iterative multi-RHS solvers should use the packed
        layouts directly (``dia_matvec_multi``, ``aligned_matvec_multi``,
        ``lanepack_matvec_multi``) to skip the per-apply relayout."""
        if x.device != self.device:
            raise ValueError(f"x is on {x.device}, the operator on {self.device}")
        if x.dim() != 2 or x.shape[0] != self.cols:
            raise ValueError(f"x must be ({self.cols}, K), got {tuple(x.shape)}")
        if x.dtype != self.dtype:
            raise TypeError(f"x has dtype {x.dtype}, the operator {self.dtype}")
        k = int(x.shape[1])

        def columns(apply):
            return torch.stack([apply(x[:, j]) for j in range(k)], dim=1)

        def chunks16(apply):
            """``apply`` on balanced column chunks of at most 16."""
            nchunks = -(-k // 16)
            base, rem = divmod(k, nchunks)
            parts, j = [], 0
            for step in (base + (i < rem) for i in range(nchunks)):
                parts.append(apply(x[:, j:j + step]))
                j += step
            return torch.cat(parts, dim=1)

        y = None
        if self._bell is not None:
            if k >= 8:
                from .spmm import spmm_bell

                y = chunks16(lambda xs: spmm_bell(self._bell, xs, device_arrays=self._bell_arrs))
            else:
                from .spmv_bell import spmv_bell

                y = columns(lambda v: spmv_bell(self._bell, v, device_arrays=self._bell_arrs))
        if self._stripe is not None:
            from .spmv import spmv_stripe

            y = columns(lambda v: spmv_stripe(self._stripe, v, device_arrays=self._stripe_arrs))
        if self._dia is not None:
            from .spmv_dia import spmm_dia_stream, spmv_dia

            def dia_part(xs):
                if xs.shape[1] >= 2:
                    return spmm_dia_stream(self._dia, xs, device_arrays=self._dia_arrs)
                return spmv_dia(self._dia, xs[:, 0].contiguous(),
                                device_arrays=self._dia_arrs)[:, None]

            y = chunks16(dia_part)
        if self._aligned is not None:
            from .spmm import spmm_aligned

            y = spmm_aligned(self._aligned, x, device_arrays=self._ali_arrs)
        if self._plan is not None:
            from .spmm import spmm_lanepack

            y2 = spmm_lanepack(self._plan, x, device_arrays=self._lp_arrs)
            y = y2 if y is None else y + y2
        if self._ell is not None:
            from .spmm import spmm_ell

            y2 = spmm_ell(*self._ell, x)
            if self._ell_spill is not None:
                sr, sc, sv = self._ell_spill
                y2 = y2.index_add(0, sr.long(), sv[:, None] * x[sc.long()])
            y = y2 if y is None else y + y2
        return y

    def bytes_per_apply(self) -> int:
        """Device bytes of operator data streamed per SpMV (x and y not
        counted); bf16 value planes count at their stored width."""
        total = 0
        if self._ell is not None:
            total += sum(int(a.nbytes) for a in self._ell)
            if self._ell_spill is not None:
                total += sum(int(a.nbytes) for a in self._ell_spill)
        if self._dia is not None:
            total += int(self._dia_arrs["data"].nbytes)
        if self._plan is not None:
            total += self._plan.slot_bytes()
        if self._aligned is not None:
            total += self._aligned.slot_bytes()
        if self._stripe is not None:
            total += self._stripe.slot_bytes()
        if self._bell is not None:
            total += int(self._bell_arrs["vals"].nbytes + self._bell_arrs["lane"].nbytes)
            if self._bell.spill is not None:
                total += self._bell.spill.slot_bytes()
        return total


# ---------------------------------------------------------------------------
# plan files: the reference's npz layout (save_operator_plan there)
# ---------------------------------------------------------------------------


def _lanepack_payload(pl, prefix: str) -> dict:
    return {
        prefix + "kw": pl.kw, prefix + "pack": pl.pack, prefix + "rows": pl.rows,
        prefix + "cols": pl.cols, prefix + "nnz": pl.nnz, prefix + "vals": pl.vals,
        prefix + "lane": pl.lane, prefix + "ends": pl.ends, prefix + "starts": pl.starts,
        prefix + "rb_a": pl.rb_a, prefix + "rb_b": pl.rb_b, prefix + "split": pl.split,
        prefix + "chunk_rb": pl.chunk_rb, prefix + "col_off": pl.col_off,
        prefix + "rb_mask": pl.rb_mask,
    }


def _lanepack_from_payload(z, prefix: str) -> LanePackPlan:
    return LanePackPlan(
        rows=int(z[prefix + "rows"]), cols=int(z[prefix + "cols"]),
        kw=int(z[prefix + "kw"]), pack=str(z[prefix + "pack"]),
        vals=z[prefix + "vals"], lane=z[prefix + "lane"], ends=z[prefix + "ends"],
        starts=z[prefix + "starts"], rb_a=z[prefix + "rb_a"], rb_b=z[prefix + "rb_b"],
        split=z[prefix + "split"], chunk_rb=z[prefix + "chunk_rb"],
        col_off=z[prefix + "col_off"], rb_mask=z[prefix + "rb_mask"],
        nnz=int(z[prefix + "nnz"]), dtype=z[prefix + "vals"].dtype,
    )


def _stripe_payload(st, prefix: str, payload: dict) -> None:
    payload.update({
        prefix + "vals": st.vals, prefix + "lane": st.lane, prefix + "ends": st.ends,
        prefix + "rb": st.stripe_rb, prefix + "col_off": st.col_off,
        prefix + "chunk_stripe": st.chunk_stripe, prefix + "rb_mask": st.rb_mask,
        prefix + "nnz": st.nnz, prefix + "levels": st.levels, prefix + "kw": st.kw,
        prefix + "mode": st.mode, prefix + "rows": st.rows, prefix + "cols": st.cols,
    })
    if st.starts is not None:
        payload[prefix + "starts"] = st.starts
    if st.spill is not None:  # a scan-mode spill: one level deep
        _stripe_payload(st.spill, prefix + "sp_", payload)


def _stripe_from_payload(z, prefix: str) -> StripePlan:
    return StripePlan(
        rows=int(z[prefix + "rows"]), cols=int(z[prefix + "cols"]),
        levels=int(z[prefix + "levels"]), kw=int(z[prefix + "kw"]),
        mode=str(z[prefix + "mode"]),
        vals=z[prefix + "vals"], lane=z[prefix + "lane"], ends=z[prefix + "ends"],
        starts=z[prefix + "starts"] if prefix + "starts" in z else None,
        stripe_rb=z[prefix + "rb"], col_off=z[prefix + "col_off"],
        chunk_stripe=z[prefix + "chunk_stripe"], rb_mask=z[prefix + "rb_mask"],
        nnz=int(z[prefix + "nnz"]), dtype=z[prefix + "vals"].dtype,
        spill=_stripe_from_payload(z, prefix + "sp_") if prefix + "sp_vals" in z else None,
    )


def save_operator_plan(op: SpmvOperator, path: str) -> None:
    """Persist a planned operator as the npz that the reference's
    ``save_operator_plan`` writes, so either package can load it."""
    payload = {"format": op.format, "rows": op.rows, "cols": op.cols, "nnz": op.nnz}
    if op._aligned is not None:
        al = op._aligned
        payload.update({
            "ali_vals": al.vals, "ali_lane": al.lane, "ali_col_off": al.col_off,
            "ali_chunk_rb": al.chunk_rb, "ali_rb_a": al.rb_a, "ali_rb_b": al.rb_b,
            "ali_split": al.split, "ali_rb_mask": al.rb_mask, "ali_nnz": al.nnz,
        })
        if al.spill is not None:
            payload.update(_lanepack_payload(al.spill, "alisp_"))
    if op._dia is not None:
        payload.update({
            "dia_data": op._dia.data,
            "dia_offsets": np.asarray(op._dia.offsets, np.int64),
            "dia_rows": op._dia.rows, "dia_cols": op._dia.cols,
        })
    if op._bell is not None:
        bl = op._bell
        payload.update({
            "bell_ds": np.asarray(bl.ds, np.int64),
            "bell_modes": np.asarray(bl.modes, np.int64),
            "bell_vals": bl.vals, "bell_lane": bl.lane,
            "bell_nnz": bl.nnz, "bell_span": bl.span,
            "bell_ver": 3,  # the reference's window-assignment version
        })
        if bl.spill is not None:
            payload.update(_lanepack_payload(bl.spill, "bellsp_"))
    if op._stripe is not None:
        _stripe_payload(op._stripe, "stripe_", payload)
    if op._plan is not None:
        payload.update(_lanepack_payload(op._plan, "lp_"))
    if op._ell is not None:
        (ev, ec), spill = op._ell_host
        payload["ell_vals"], payload["ell_cols"] = ev, ec
        if spill is not None:
            payload.update({
                "ell_spill_rows": spill[0], "ell_spill_cols": spill[1],
                "ell_spill_vals": spill[2],
            })
    np.savez_compressed(path, **payload)


def load_operator_plan(path: str, device) -> SpmvOperator:
    """Rebuild an operator on ``device`` from a plan file written by either
    package's ``save_operator_plan`` (keys ``format``, ``dia_*``,
    ``ali_*``, ``alisp_*``, ``lp_*``, ``bell_*``, ``bellsp_*``,
    ``stripe_*``, ``stripe_sp_*``, ``ell_*``). Split plans raise
    ``NotImplementedError``."""
    with np.load(path, allow_pickle=False) as z:
        if "split_kind" in z:
            raise NotImplementedError(
                "row/column-split plans are not ported (the H100 kernels "
                "have no VMEM or SMEM walls); re-plan the matrix unsplit"
            )
        op = SpmvOperator.__new__(SpmvOperator)
        op.device = require_device(device)
        op._values_dtype = None
        op.format = str(z["format"])
        op.rows, op.cols, op.nnz = int(z["rows"]), int(z["cols"]), int(z["nnz"])
        op._dia = op._plan = op._aligned = op._bell = op._stripe = None
        op._ell = op._ell_spill = None
        dtypes = []
        if "dia_data" in z:
            op._set_dia(DiaMatrix(
                int(z["dia_rows"]), int(z["dia_cols"]), z["dia_data"],
                tuple(int(o) for o in z["dia_offsets"]),
            ))
            dtypes.append(z["dia_data"].dtype)
        if "ali_vals" in z:
            spill = _lanepack_from_payload(z, "alisp_") if "alisp_vals" in z else None
            op._set_aligned_plan(AlignedPlan(
                rows=op.rows, cols=op.cols, vals=z["ali_vals"], lane=z["ali_lane"],
                col_off=z["ali_col_off"], chunk_rb=z["ali_chunk_rb"],
                rb_a=z["ali_rb_a"], rb_b=z["ali_rb_b"], split=z["ali_split"],
                rb_mask=z["ali_rb_mask"], nnz=int(z["ali_nnz"]),
                dtype=z["ali_vals"].dtype, spill=spill,
            ))
            dtypes.append(z["ali_vals"].dtype)
        if "bell_vals" in z:
            if int(z.get("bell_ver", 1)) != 3:
                raise ValueError(
                    "BELL plan was saved with an incompatible (pre-v3) window "
                    "assignment; re-plan the operator and save again"
                )
            spill = _lanepack_from_payload(z, "bellsp_") if "bellsp_vals" in z else None
            op._set_bell_plan(BellPlan(
                rows=op.rows, cols=op.cols,
                ds=tuple(int(d) for d in z["bell_ds"]),
                vals=z["bell_vals"], lane=z["bell_lane"],
                modes=tuple(int(mo) for mo in z["bell_modes"]),
                span=int(z["bell_span"]), nnz=int(z["bell_nnz"]),
                dtype=z["bell_vals"].dtype, spill=spill,
            ))
            dtypes.append(z["bell_vals"].dtype)
        if "stripe_vals" in z:
            op._set_stripe_plan(_stripe_from_payload(z, "stripe_"))
            dtypes.append(z["stripe_vals"].dtype)
        if "lp_vals" in z:
            op._set_lanepack_plan(_lanepack_from_payload(z, "lp_"))
            dtypes.append(z["lp_vals"].dtype)
        if "ell_vals" in z:
            spill = (
                (z["ell_spill_rows"], z["ell_spill_cols"], z["ell_spill_vals"])
                if "ell_spill_rows" in z
                else None
            )
            op._set_ell_arrays((z["ell_vals"], z["ell_cols"]), spill)
            dtypes.append(z["ell_vals"].dtype)
        # the builders above name the format; the file's own word is final
        op.format = str(z["format"])
        op.dtype = _TORCH_DTYPES[np.dtype(dtypes[0])] if dtypes else torch.float32
    return op
