"""Planned SpMV operator with automatic format selection.

Counterpart of ``sparse_matrix_tpu/ops/operator.py``. The dispatch below is
the reference's decision code over the port's copies of its estimators
(``estimate_bell``, ``_count_slabs``, ``_chunk_keys``,
``sample_row_bands``, ``stripe._mode_cost``, ``autotune.get``), so the
port's automatic choice equals the reference's ``SpmvOperator(m).format``
for ``dia``, ``hybrid``, ``aligned``, ``lanepack``, ``bell``, ``stripe``
and ``ell``, and its stripe plan the reference's ``(mode, L, KW)``.

One branch is the port's own and runs first: a matrix of the skew class
(:func:`skewed_rows`, read from the row offsets alone: power-law graphs
such as GAP's Kronecker graphs) goes to ``csr``, the CSR-row format of
``ops/spmv_csr.py``, which streams the CSR as given. The reference has no
such format; where the test does not fire, the dispatch is the reference's.

:meth:`SpmvOperator.matmat` runs every format, through the SpMM kernels
where the reference runs its packed SpMM kernels.

Not ported: **row and column splits** — the reference shards operators
past its VMEM caps (``_VMEM_X_LIMIT``, ``_ROWS_SPLIT_LIMIT``) and
row-splits LanePack plans past its 1 MB SMEM budget. The H100 kernels have
neither wall, so the port plans such a matrix unsplit, in the format its
shards would take: a banded matrix goes to DIA as in the reference, an
SMEM-bound LanePack winner is planned as one LanePack plan, and the rest
runs the regular dispatch.

**float64 on the card.** The reference runs float64 plans through XLA on
the CPU (its TPU has no f64 ALU), and so does the port on
``device="cpu"``. On a CUDA device DIA runs float64 too: the DIA SpMV
kernel has an f64 form (f64 planes, x, y and sum, the H100's FP64 units);
the DIA SpMM kernel has none, so a float64 DIA ``matmat`` of more than
one column raises its ``TypeError``. Every other kernel takes f32 values
(or bf16 planes), so a float64 operator whose apply would reach one of
them (hybrid, whose residual runs LanePack or ELL beside its DIA part,
aligned, LanePack, BELL, stripe), or a float64 DIA operator with bf16
planes, is refused at construction with one ``TypeError`` naming
float64, the format and the card; ELL, which runs as plain PyTorch
gathers, runs float64 there too.
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
from ..utils.profiling import span
from .spmm import spmm_aligned, spmm_bell, spmm_ell, spmm_lanepack
from .spmv import (
    _TORCH_DTYPES,
    _t,
    aligned_device_arrays,
    ell_from_csr,
    ell_spill_from_csr,
    lanepack_device_arrays,
    spmv_aligned,
    spmv_ell,
    spmv_ell_spill,
    spmv_lanepack,
    spmv_stripe,
    stripe_device_arrays,
)
from .spmv_bell import bell_device_arrays, spmv_bell
from .spmv_csr import csr_device_arrays, csr_stream_bytes, plan_csr_rows, spmv_csr
from .spmv_dia import dia_device_arrays, spmm_dia_stream, spmv_dia

__all__ = [
    "SpmvOperator",
    "split_bands",
    "skewed_rows",
    "save_operator_plan",
    "load_operator_plan",
]

# a diagonal goes to the DIA part when at least this fraction of its slots
# hold nonzeros (the HYB-style split threshold)
BAND_FILL_THRESHOLD = 0.5
MIN_BAND_NNZ_FRACTION = 0.3  # hybrid only pays if bands cover enough nnz

_NP_DTYPES = {v: k for k, v in _TORCH_DTYPES.items()}

# the skew class (skewed_rows): the longest row at least SKEW_MAX_OVER_MEAN
# times the mean, and at least SKEW_LONG_SHARE of the entries in long rows,
# rows longer than SKEW_LONG_FACTOR times the mean and SKEW_LONG_MIN
SKEW_MAX_OVER_MEAN = 16
SKEW_LONG_FACTOR = 4
SKEW_LONG_MIN = 64
SKEW_LONG_SHARE = 0.35


def skewed_rows(offsets: np.ndarray) -> bool:
    """Whether the row lengths ``diff(offsets)`` are of the skew class,
    which the dispatch sends to the CSR-row format before any other probe.

    Measured shares of the entries in long rows, with the longest row over
    the mean (12 seeds each; PERF.md §4): GAP's Kronecker graphs (A = .57,
    B = C = .19, edgefactor 16, undirected) 0.41-0.42 at scale 10 (22x),
    0.39-0.42 at 11, 0.59 at 12 (55x), 0.53-0.54 at 13, 0.59-0.61 at 14
    (138x), 0.52 at 18 (870x); the bench corpus's Pareto rows
    (``power_law_rows``, alpha 1.5, mean length 8 to 16), which the
    reference sends to stripe, at most 0.31 at 200 to 65,536 rows; stencils, FEM-like, random
    local, HPCG's 27-point operator and AMG's levels have no long row. A
    hyper-sparse matrix (mean below one) has no row past SKEW_LONG_MIN."""
    lens = np.diff(offsets)
    nnz = int(offsets[-1])
    if nnz == 0:
        return False
    mean = nnz / lens.size
    if int(lens.max()) < SKEW_MAX_OVER_MEAN * mean:
        return False
    long_rows = lens > max(SKEW_LONG_FACTOR * mean, SKEW_LONG_MIN)
    return int(lens[long_rows].sum()) >= SKEW_LONG_SHARE * nnz


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
    ``aligned``, ``bell``, ``stripe``, ``lanepack`` and ``ell``; and, ahead
    of them, ``csr`` for the skew class (:func:`skewed_rows`). ``force``
    names one of them. ``values_dtype=torch.bfloat16`` stores the DIA band or BELL value
    planes half-width (the other formats raise); applies widen to ``dtype``
    before they accumulate. The host plan is built once; its arrays live on
    ``device`` and ``__call__`` takes an ``x`` on that device. The plan and
    its upload are the span ``spmx.plan.operator``. The operator holds
    ``format`` and ``parts``, one planned part a format (two for a hybrid,
    whose applies add), each read through :meth:`part`.
    """

    # above this nnz the dispatch cost estimators run on sampled row bands
    _SAMPLED_COSTS_NNZ = 500_000

    def __init__(self, m: CsrMatrix, *, device, dtype=torch.float32,
                 force: Optional[str] = None, values_dtype=None):
        if dtype not in _NP_DTYPES:
            raise TypeError(f"dtype must be one of {list(_NP_DTYPES)}, got {dtype}")
        with span("spmx.plan.operator"):
            self.device = require_device(device)
            self.dtype = dtype
            self.rows, self.cols = m.rows, m.cols
            self.nnz = m.nnz()
            self.format, plans = self._dispatch(m, _NP_DTYPES[dtype], force)
            self.parts = self._upload(plans, values_dtype)

    def _dispatch(self, m: CsrMatrix, dtype, force):
        """The format and its ``(part class, host plan)`` pairs."""
        if force == "stripe":
            # the reference plans a forced stripe operator on plan_stripe's
            # own grid (L = 1 included)
            return "stripe", ((_StripePart, plan_stripe(m, dtype=dtype)),)

        if force == "aligned":
            return "aligned", ((_AlignedPart, plan_aligned(m, dtype=dtype)),)

        if force == "bell":
            return "bell", ((_BellPart, plan_bell(m, dtype=dtype)),)

        if force == "csr" or (force is None and skewed_rows(m.offsets)):
            return "csr", ((_CsrPart, plan_csr_rows(m, dtype)),)

        if force in (None, "dia"):
            dia = try_dia_from_csr(m, dtype=dtype)
            if dia is not None:
                return "dia", ((_DiaPart, dia),)
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
                    # residual may itself be hyper-sparse: route it by the
                    # same LanePack-vs-ELL guard as the reference
                    if self._lanepack_viable(residual):
                        rest = (_LanePackPart, plan_lanepack(residual, dtype=dtype))
                    else:
                        rest = (_EllPart, _plan_ell(residual, dtype))
                    return "hybrid", ((_DiaPart, dia), rest)
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
                return "ell", ((_EllPart, _plan_ell(m, dtype)),)
            if plan_est > 4 * m.nnz() * 8 and ell_bytes < plan_est / 2:
                if plan_est > 1 << 29:
                    return "ell", ((_EllPart, _plan_ell(m, dtype)),)
                t_aligned, t_gen, _ = self._general_costs(m)
                t_lp = (
                    t_gen
                    if t_gen is not None and self._lanepack_viable(m)
                    else float("inf")
                )
                ell_ns = m.rows * max(1, row_max) * autotune.get("ell_gather_ns")
                if ell_ns <= min(t_aligned, t_lp):
                    return "ell", ((_EllPart, _plan_ell(m, dtype)),)
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
                    return "stripe", ((_StripePart, _plan_stripe(m, dtype, scfg)),)
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
                        return "lanepack", ((_LanePackPart, plan_lanepack(m, dtype=dtype)),)
                if bell_ok:
                    return "bell", ((_BellPart, plan_bell(m, dtype=dtype)),)
                if m.nnz() > 0:
                    return "aligned", ((_AlignedPart, plan_aligned(m, dtype=dtype)),)
                return "ell", ((_EllPart, _plan_ell(m, dtype)),)

        # BELL vs aligned vs general LanePack by estimated kernel time; an
        # explicit force="lanepack" bypasses the comparison
        if force is None:
            choice = self._general_choice(m)
            if choice == "stripe":
                # the counts are memoized: this recovers the grid argmin so
                # plan_stripe skips its own grid
                _t, _ok, scfg = self._stripe_cost_and_viable(m)
                return "stripe", ((_StripePart, _plan_stripe(m, dtype, scfg)),)
            if choice == "bell":
                return "bell", ((_BellPart, plan_bell(m, dtype=dtype)),)
            if choice == "aligned":
                return "aligned", ((_AlignedPart, plan_aligned(m, dtype=dtype)),)

        return "lanepack", ((_LanePackPart, plan_lanepack(m, dtype=dtype)),)

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

    # -- parts --------------------------------------------------------------

    def _upload(self, plans, values_dtype) -> tuple:
        """The parts of ``plans``, ``(part class, host plan)`` pairs, on the
        operator's device. Refused: ``values_dtype`` (bf16 planes) on a
        part that does not stream them (only DIA and BELL do; a hybrid's
        LanePack residual stays f32, it is the minority nnz by
        construction), and float64 values of a kernel-backed part other
        than DIA, or of DIA with bf16 planes, on a CUDA device (see the
        module docstring); ELL and the CPU path take them."""
        parts = []
        for cls, plan in plans:
            if (values_dtype is not None and not cls.bf16
                    and not (self.format == "hybrid" and cls is _LanePackPart)):
                raise ValueError(
                    f"values_dtype is only supported on the streaming formats "
                    f"(dia, bell); dispatch chose {cls.fmt!r} — force='dia' or "
                    f"force='bell', or drop values_dtype"
                )
            if (self.device.type == "cuda" and self.dtype == torch.float64
                    and cls is not _EllPart and (self.format != "dia" or values_dtype is not None)):
                raise TypeError(
                    f"SpmvOperator: float64 {self.format} plans have no kernel on {self.device} "
                    f"({torch.cuda.get_device_name(self.device)}): of the CUDA kernels only DIA "
                    "takes float64 values, with float64 planes; plan float32, force='dia' or "
                    "'ell', or use device='cpu' for float64"
                )
            parts.append(cls(plan, self.device, values_dtype))
        return tuple(parts)

    def part(self, fmt: str):
        """The part of format ``fmt`` (``"dia"``, ``"aligned"``,
        ``"lanepack"``, ``"bell"``, ``"stripe"``, ``"ell"`` or ``"csr"``),
        or None. A part carries ``plan``, its host plan, and ``arrays``,
        its device arrays."""
        return next((p for p in self.parts if p.fmt == fmt), None)

    # -- apply --------------------------------------------------------------

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if x.device != self.device:
            raise ValueError(f"x is on {x.device}, the operator on {self.device}")
        y = self.parts[0].apply(x)
        for p in self.parts[1:]:
            y = y + p.apply(x)
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
        (``lanepack_spmm_uses_kernel``); stripe and csr column by column;
        ELL as a plain gather. Iterative multi-RHS solvers should use the packed
        layouts directly (``dia_matvec_multi``, ``aligned_matvec_multi``,
        ``lanepack_matvec_multi``) to skip the per-apply relayout."""
        if x.device != self.device:
            raise ValueError(f"x is on {x.device}, the operator on {self.device}")
        if x.dim() != 2 or x.shape[0] != self.cols:
            raise ValueError(f"x must be ({self.cols}, K), got {tuple(x.shape)}")
        if x.dtype != self.dtype:
            raise TypeError(f"x has dtype {x.dtype}, the operator {self.dtype}")
        y = self.parts[0].matmat(x)
        for p in self.parts[1:]:
            y = y + p.matmat(x)
        return y

    def bytes_per_apply(self) -> int:
        """Device bytes of operator data streamed per SpMV (x and y not
        counted); bf16 value planes count at their stored width."""
        return sum(p.nbytes() for p in self.parts)


# ---------------------------------------------------------------------------
# parts: one planned format each
# ---------------------------------------------------------------------------


def _columns(apply, x):
    """``apply`` on each column of X, stacked as the columns of Y."""
    return torch.stack([apply(x[:, j]) for j in range(x.shape[1])], dim=1)


def _chunks16(apply, x):
    """``apply`` on balanced column chunks of X of at most 16 (on X itself
    when K <= 16)."""
    k = int(x.shape[1])
    if k <= 16:
        return apply(x)
    nchunks = -(-k // 16)
    base, rem = divmod(k, nchunks)
    parts, j = [], 0
    for step in (base + (i < rem) for i in range(nchunks)):
        parts.append(apply(x[:, j:j + step]))
        j += step
    return torch.cat(parts, dim=1)


def _plan_ell(m: CsrMatrix, dtype):
    """An ELL part's host arrays ``((vals, cols), spill)``. Width guard: one
    dense row must not inflate the padded array to rows x max_row_nnz, so a
    skewed matrix gets a capped ELL and a COO spill ``(rows, cols, vals)``;
    else ``spill`` is None."""
    row_nnz = np.diff(m.offsets)
    w_full = max(1, int(row_nnz.max())) if m.nnz() else 1
    q99 = int(np.quantile(row_nnz, 0.99)) if m.nnz() else 1
    if w_full > 2 * max(1, 2 * q99):
        ev, ec, sr, sc, sv = ell_spill_from_csr(m, dtype=dtype)
        return (ev, ec), (sr, sc, sv)
    return ell_from_csr(m, dtype=dtype), None


def _plan_stripe(m: CsrMatrix, dtype, cfg) -> StripePlan:
    mode, lvl, kw = cfg
    return plan_stripe(m, dtype=dtype, mode=mode, levels=lvl, kw=kw)


class _Part:
    """One planned format of an :class:`SpmvOperator`: ``plan``, its host
    plan, and ``arrays``, its arrays on the operator's device
    (``device_arrays(plan, device)``). ``apply(x)`` and ``matmat(X)`` run
    it, ``nbytes()`` is its share of ``bytes_per_apply``, and
    ``payload()`` its keys in a plan file, from which ``load(z)`` reads
    its plan back (``key`` marks it there)."""

    fmt = key = ""
    bf16 = False  # streams bf16 value planes (``values_dtype``)

    def __init__(self, plan, device, values_dtype=None):
        self.plan = plan
        kw = {"values_dtype": values_dtype} if self.bf16 else {}
        self.arrays = self.device_arrays(plan, device, **kw)

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return self.spmv(self.plan, x, device_arrays=self.arrays)

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        return _columns(self.apply, x)

    def nbytes(self) -> int:
        return self.plan.slot_bytes()


class _DiaPart(_Part):
    fmt, key, bf16 = "dia", "dia_data", True
    device_arrays, spmv = staticmethod(dia_device_arrays), staticmethod(spmv_dia)

    def matmat(self, x):
        def chunk(xs):
            if xs.shape[1] >= 2:
                return spmm_dia_stream(self.plan, xs, device_arrays=self.arrays)
            return self.apply(xs[:, 0].contiguous())[:, None]

        return _chunks16(chunk, x)

    def nbytes(self):
        return int(self.arrays["data"].nbytes)

    def payload(self):
        d = self.plan
        return {"dia_data": d.data, "dia_offsets": np.asarray(d.offsets, np.int64),
                "dia_rows": d.rows, "dia_cols": d.cols}

    @staticmethod
    def load(z):
        return DiaMatrix(int(z["dia_rows"]), int(z["dia_cols"]), z["dia_data"],
                         tuple(int(o) for o in z["dia_offsets"]))


class _AlignedPart(_Part):
    fmt, key = "aligned", "ali_vals"
    device_arrays, spmv = staticmethod(aligned_device_arrays), staticmethod(spmv_aligned)

    def matmat(self, x):
        return spmm_aligned(self.plan, x, device_arrays=self.arrays)

    def payload(self):
        al = self.plan
        out = {"ali_vals": al.vals, "ali_lane": al.lane, "ali_col_off": al.col_off,
               "ali_chunk_rb": al.chunk_rb, "ali_rb_a": al.rb_a, "ali_rb_b": al.rb_b,
               "ali_split": al.split, "ali_rb_mask": al.rb_mask, "ali_nnz": al.nnz}
        if al.spill is not None:
            out.update(_lanepack_payload(al.spill, "alisp_"))
        return out

    @staticmethod
    def load(z):
        return AlignedPlan(
            rows=int(z["rows"]), cols=int(z["cols"]), vals=z["ali_vals"], lane=z["ali_lane"],
            col_off=z["ali_col_off"], chunk_rb=z["ali_chunk_rb"], rb_a=z["ali_rb_a"],
            rb_b=z["ali_rb_b"], split=z["ali_split"], rb_mask=z["ali_rb_mask"],
            nnz=int(z["ali_nnz"]), dtype=z["ali_vals"].dtype,
            spill=_lanepack_from_payload(z, "alisp_") if "alisp_vals" in z else None,
        )


class _LanePackPart(_Part):
    fmt, key = "lanepack", "lp_vals"
    device_arrays, spmv = staticmethod(lanepack_device_arrays), staticmethod(spmv_lanepack)

    def matmat(self, x):
        return spmm_lanepack(self.plan, x, device_arrays=self.arrays)

    def payload(self):
        return _lanepack_payload(self.plan, "lp_")

    @staticmethod
    def load(z):
        return _lanepack_from_payload(z, "lp_")


class _BellPart(_Part):
    fmt, key, bf16 = "bell", "bell_vals", True
    device_arrays, spmv = staticmethod(bell_device_arrays), staticmethod(spmv_bell)

    def matmat(self, x):
        if x.shape[1] >= 8:
            return _chunks16(lambda xs: spmm_bell(self.plan, xs, device_arrays=self.arrays), x)
        return _columns(self.apply, x)

    def nbytes(self):
        spill = self.plan.spill
        return (int(self.arrays["vals"].nbytes + self.arrays["lane"].nbytes)
                + (0 if spill is None else spill.slot_bytes()))

    def payload(self):
        bl = self.plan
        out = {"bell_ds": np.asarray(bl.ds, np.int64), "bell_modes": np.asarray(bl.modes, np.int64),
               "bell_vals": bl.vals, "bell_lane": bl.lane, "bell_nnz": bl.nnz,
               "bell_span": bl.span,
               "bell_ver": 3}  # the reference's window-assignment version
        if bl.spill is not None:
            out.update(_lanepack_payload(bl.spill, "bellsp_"))
        return out

    @staticmethod
    def load(z):
        if int(z.get("bell_ver", 1)) != 3:
            raise ValueError(
                "BELL plan was saved with an incompatible (pre-v3) window "
                "assignment; re-plan the operator and save again"
            )
        return BellPlan(
            rows=int(z["rows"]), cols=int(z["cols"]), ds=tuple(int(d) for d in z["bell_ds"]),
            vals=z["bell_vals"], lane=z["bell_lane"],
            modes=tuple(int(mo) for mo in z["bell_modes"]), span=int(z["bell_span"]),
            nnz=int(z["bell_nnz"]), dtype=z["bell_vals"].dtype,
            spill=_lanepack_from_payload(z, "bellsp_") if "bellsp_vals" in z else None,
        )


class _StripePart(_Part):
    fmt, key = "stripe", "stripe_vals"
    device_arrays, spmv = staticmethod(stripe_device_arrays), staticmethod(spmv_stripe)

    def payload(self):
        return _stripe_payload(self.plan, "stripe_")

    @staticmethod
    def load(z):
        return _stripe_from_payload(z, "stripe_")


class _CsrPart(_Part):
    """CSR-row: ``plan`` is the ``CsrMatrix`` as given (values in the
    operator's dtype), ``arrays`` its column stripes, each a CSR and its
    merge path, on the device (``ops/spmv_csr.py``); the plan file holds
    the CSR as given, and the stripes are derived again on the device."""

    fmt, key = "csr", "csr_vals"
    device_arrays, spmv = staticmethod(csr_device_arrays), staticmethod(spmv_csr)

    @property
    def stripes(self) -> int:
        """The column stripes the device's L2 asked for (1 on a CPU)."""
        return len(self.arrays["stripes"])

    def nbytes(self):
        return csr_stream_bytes(self.arrays)

    def payload(self):
        c = self.plan
        return {"csr_offsets": c.offsets, "csr_indices": c.indices, "csr_vals": c.vals}

    @staticmethod
    def load(z):
        offsets = z["csr_offsets"]
        return CsrMatrix(len(offsets) - 1, int(z["cols"]), z["csr_vals"], z["csr_indices"],
                         offsets, is_sorted=True)


class _EllPart(_Part):
    """ELL: ``plan`` is ``((vals, cols), spill)`` on the host (``spill``,
    the COO ``(rows, cols, vals)`` of a width-capped ELL, or None) and
    ``arrays`` the same on the device; it runs as plain PyTorch
    gathers."""

    fmt, key = "ell", "ell_vals"

    @staticmethod
    def device_arrays(plan, device):
        ell, spill = plan
        return (tuple(_t(a, device) for a in ell),
                None if spill is None else tuple(_t(a, device) for a in spill))

    def apply(self, x):
        ell, spill = self.arrays
        return spmv_ell(*ell, x) if spill is None else spmv_ell_spill(*ell, *spill, x)

    def matmat(self, x):
        ell, spill = self.arrays
        y = spmm_ell(*ell, x)
        if spill is not None:
            sr, sc, sv = spill
            y = y.index_add(0, sr.long(), sv[:, None] * x[sc.long()])
        return y

    def nbytes(self):
        return sum(int(a.nbytes) for arrs in self.arrays if arrs is not None for a in arrs)

    def payload(self):
        (ev, ec), spill = self.plan
        out = {"ell_vals": ev, "ell_cols": ec}
        if spill is not None:
            out.update(ell_spill_rows=spill[0], ell_spill_cols=spill[1], ell_spill_vals=spill[2])
        return out

    @staticmethod
    def load(z):
        spill = None
        if "ell_spill_rows" in z:
            spill = (z["ell_spill_rows"], z["ell_spill_cols"], z["ell_spill_vals"])
        return (z["ell_vals"], z["ell_cols"]), spill


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


def _stripe_payload(st, prefix: str) -> dict:
    payload = {
        prefix + "vals": st.vals, prefix + "lane": st.lane, prefix + "ends": st.ends,
        prefix + "rb": st.stripe_rb, prefix + "col_off": st.col_off,
        prefix + "chunk_stripe": st.chunk_stripe, prefix + "rb_mask": st.rb_mask,
        prefix + "nnz": st.nnz, prefix + "levels": st.levels, prefix + "kw": st.kw,
        prefix + "mode": st.mode, prefix + "rows": st.rows, prefix + "cols": st.cols,
    }
    if st.starts is not None:
        payload[prefix + "starts"] = st.starts
    if st.spill is not None:  # a scan-mode spill: one level deep
        payload.update(_stripe_payload(st.spill, prefix + "sp_"))
    return payload


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
    for p in op.parts:
        payload.update(p.payload())
    np.savez_compressed(path, **payload)


#: the part classes in the order a plan file's parts are read (a hybrid's
#: DIA part first)
_PARTS = (_DiaPart, _AlignedPart, _BellPart, _StripePart, _LanePackPart, _EllPart, _CsrPart)


def load_operator_plan(path: str, device) -> SpmvOperator:
    """Rebuild an operator on ``device`` from a plan file written by either
    package's ``save_operator_plan`` (keys ``format``, ``dia_*``,
    ``ali_*``, ``alisp_*``, ``lp_*``, ``bell_*``, ``bellsp_*``,
    ``stripe_*``, ``stripe_sp_*``, ``ell_*``; the port's own ``csr_*``). Split plans raise
    ``NotImplementedError``."""
    with np.load(path, allow_pickle=False) as npz:
        if "split_kind" in npz:
            raise NotImplementedError(
                "row/column-split plans are not ported (the H100 kernels "
                "have no VMEM or SMEM walls); re-plan the matrix unsplit"
            )
        z = dict(npz)
    op = SpmvOperator.__new__(SpmvOperator)
    op.device = require_device(device)
    op.format = str(z["format"])
    op.rows, op.cols, op.nnz = int(z["rows"]), int(z["cols"]), int(z["nnz"])
    plans = tuple((cls, cls.load(z)) for cls in _PARTS if cls.key in z)
    op.dtype = _TORCH_DTYPES[np.dtype(z[plans[0][0].key].dtype)] if plans else torch.float32
    op.parts = op._upload(plans, None)
    return op
