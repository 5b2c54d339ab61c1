"""Sort-based device sparse ops: transpose, add/sub, ESC SpGEMM.

Counterpart of ``sparse_matrix_tpu/ops/device_sorted.py``. Every
structural op is a key sort and a run reduce:

    int64 key sort -> run heads -> segmented sum per run -> compaction

The reference sorts two int32 keys (or one packed int32 key) because the
TPU sorts no int64 keys; the card does, so the port has one path: the
packed int64 key ``row * cols + col``. The sort is ``torch.sort``
(stable) and each run is summed on its own with ``index_add_`` into its
run slot, never as a difference of a global prefix sum (cross-run
cancellation would lose precision). On the card those sums are atomic,
so their order, and the last bits of a run of three or more values, may
change from run to run; a sum of two values is exact in either order.

Results are :class:`PaddedCoo`: capacity = the number of entries in
(products, or both operands' entries), ``nnz`` a device scalar, entries
past ``nnz`` on the sentinel row ``rows`` with zero values. The symbolic
phase (:func:`expand_plan`, :func:`~.esc_expand.plan_expand_kmajor`)
runs on the host, the numeric phase on the device.

:class:`EscSpgemm` is the amortised ESC engine: its expansion is the ESC
expansion kernel (``csrc/esc_expand.cu``, through
:mod:`.esc_expand`) on CUDA tensors, its reduction the packed-key sort
(``reduce="sort"``) or the selection-matrix SpMV of
:class:`~.spgemm_spmv.ReduceSpmv` (``reduce="spmv"``). Its packed keys are
plan data, so the sort reduction is planned once on the device
(:func:`plan_sort_reduce`: the stable key order, the runs, each run's row
and column, nnz) and a multiply sums each run in sorted order: the run-sum
kernel (``csrc/esc_run_sum.cu``) on the card, the same bits on every call,
and on the CPU :func:`_sum_runs_torch`, which equals the per-call sort
(:func:`_packed_reduce_presort`, still the gather engine's) bit for bit.
The reference's ``as_pytree``/``params=`` (jit arguments) are not ported:
there is no jit to feed.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import require_device
from ..formats.csr import INDEX_DTYPE, OFFSET_DTYPE, CsrMatrix
from ..formats.device import DeviceCsr
from ..utils.profiling import span
from .spmv import _TORCH_DTYPES, _t

__all__ = [
    "PaddedCoo",
    "padded_to_host",
    "transpose_device",
    "add_device",
    "sub_device",
    "expand_plan",
    "plan_sort_reduce",
    "EscSpgemm",
    "spgemm_esc_device",
]


class PaddedCoo(NamedTuple):
    """Row-sorted COO with a fixed capacity and a device-side nnz.

    Entries beyond ``nnz`` have ``row == rows`` (the sentinel) and zero
    values.
    """

    row: torch.Tensor  # (cap,) int32, sorted; sentinel = rows
    col: torch.Tensor  # (cap,) int32
    val: torch.Tensor  # (cap,)
    nnz: torch.Tensor  # () int32
    rows: int
    cols: int


def padded_to_host(p: PaddedCoo) -> CsrMatrix:
    """The exact host CSR (sorted) of a device result: one scalar read of
    ``nnz``, then only the live prefix is copied back."""
    n = int(p.nnz)
    row = p.row[:n].cpu().numpy()
    offsets = np.zeros(p.rows + 1, dtype=OFFSET_DTYPE)
    np.cumsum(np.bincount(row, minlength=p.rows), out=offsets[1:])
    return CsrMatrix(p.rows, p.cols, p.val[:n].cpu().numpy(),
                     p.col[:n].cpu().numpy().astype(INDEX_DTYPE), offsets, is_sorted=True)


def _packed_run_reduce(key, val, rows: int, cols: int):
    """Combine equal keys of sorted packed ``row * cols + col`` keys: one
    run per distinct key, its values summed on their own into the run's
    slot. Returns ``(row, col, val, nnz)`` of capacity ``key.numel()``;
    slots past ``nnz`` hold the sentinel row ``rows``, column 0 and 0."""
    n = key.shape[0]
    dev = key.device
    if n == 0:
        return (torch.zeros(0, dtype=torch.int32, device=dev),
                torch.zeros(0, dtype=torch.int32, device=dev), val,
                torch.zeros((), dtype=torch.int32, device=dev))
    head = torch.ones(n, dtype=torch.bool, device=dev)
    head[1:] = key[1:] != key[:-1]
    run = torch.cumsum(head, 0) - 1
    ukey = torch.full((n,), rows * cols, dtype=torch.int64, device=dev)
    ukey[run] = key  # every member of a run writes the same key
    total = torch.zeros(n, dtype=val.dtype, device=dev)
    total.index_add_(0, run, val)
    return ((ukey // cols).to(torch.int32), (ukey % cols).to(torch.int32), total,
            head.sum(dtype=torch.int32))


def _packed_reduce_presort(key, p, rows: int, cols: int):
    """Stable sort of (packed key, products) by key, then the run reduce:
    the back half of the expansion-kernel ESC engine (the key is plan
    data)."""
    k_s, order = torch.sort(key, stable=True)
    return _packed_run_reduce(k_s, p[order], rows, cols)


def plan_sort_reduce(key, rows: int, cols: int, *, padded: bool) -> dict:
    """The sort reduction of fixed packed keys ``key`` (``(cap,)`` int64
    ``row * cols + col`` on the device; with ``padded``, the last run is
    the padding slots' sentinel ``rows * cols``), computed once: ``order``
    (cap,) int32, the stable key order (position -> slot); ``run_off``
    (runs + 1,) int32, each run's first position and the end; ``row`` and
    ``col`` (cap,) int32, each run's entry, then the sentinel row ``rows``
    and column 0; ``nnz`` () int32, the runs less the sentinel's;
    ``num_summed``, the same as an int. On CUDA also ``launch``, the
    run-sum kernel's :class:`~..native.kernels.PreparedRunSum`."""
    cap, dev = key.shape[0], key.device
    k_s, order = torch.sort(key, stable=True)
    head = torch.ones(cap, dtype=torch.bool, device=dev)
    head[1:] = k_s[1:] != k_s[:-1]
    first = torch.nonzero(head).flatten()
    runs = first.numel()
    ukey = k_s[first]
    row = torch.full((cap,), rows, dtype=torch.int32, device=dev)
    col = torch.zeros(cap, dtype=torch.int32, device=dev)
    row[:runs] = (ukey // cols).to(torch.int32)
    col[:runs] = (ukey % cols).to(torch.int32)
    num_summed = runs - int(padded)
    out = dict(order=order.to(torch.int32),
               run_off=torch.cat([first, first.new_tensor([cap])]).to(torch.int32),
               row=row, col=col, num_summed=num_summed,
               nnz=torch.tensor(num_summed, dtype=torch.int32, device=dev))
    if dev.type == "cuda":
        from ..native.kernels import prepare_esc_run_sum

        out["launch"] = prepare_esc_run_sum(out["order"], out["run_off"], num_summed=num_summed)
    return out


def _sum_runs_torch(p, order, run_off):
    """Plain version of the run sums: run r's products ``p[order[i]]``, i in
    ``[run_off[r], run_off[r + 1])``, added into a zero in that order (the
    CPU's ``index_add_`` is sequential), every run summed. The same adds as
    :func:`_packed_reduce_presort` on the same keys."""
    cap = order.shape[0]
    lens = (run_off[1:] - run_off[:-1]).long()
    run = torch.repeat_interleave(torch.arange(lens.numel(), device=p.device), lens,
                                  output_size=cap)
    total = torch.zeros(cap, dtype=p.dtype, device=p.device)
    total.index_add_(0, run, p[order.long()])
    return total


def _offsets_from_sorted_rows(row, rows: int):
    return torch.searchsorted(row, torch.arange(rows + 1, dtype=row.dtype,
                                                device=row.device)).to(torch.int32)


# ---------------------------------------------------------------------------
# transpose
# ---------------------------------------------------------------------------


def transpose_device(a: DeviceCsr) -> DeviceCsr:
    """Transpose by one (col, row) key sort; the rows of the result are
    sorted, as the host ``CsrMatrix.transpose`` gives them."""
    key = a.indices.long() * a.rows + a.row_ids.long()
    k_s, order = torch.sort(key, stable=True)
    new_row = (k_s // a.rows).to(torch.int32)
    return DeviceCsr(
        vals=a.vals[order],
        indices=(k_s % a.rows).to(torch.int32),
        offsets=_offsets_from_sorted_rows(new_row, a.cols),
        row_ids=new_row,
        rows=a.cols,
        cols=a.rows,
        is_sorted=True,
    )


# ---------------------------------------------------------------------------
# union merge (add/sub)
# ---------------------------------------------------------------------------


def _merge(a: DeviceCsr, b: DeviceCsr, sign: int) -> PaddedCoo:
    if (a.rows, a.cols) != (b.rows, b.cols):
        raise ValueError("matrices must have identical dimensions")
    row = torch.cat([a.row_ids, b.row_ids]).long()
    col = torch.cat([a.indices, b.indices]).long()
    val = torch.cat([a.vals, b.vals if sign > 0 else -b.vals])
    k_s, order = torch.sort(row * a.cols + col, stable=True)
    r, c, v, nnz = _packed_run_reduce(k_s, val[order], a.rows, a.cols)
    return PaddedCoo(r, c, v, nnz, a.rows, a.cols)


def add_device(a: DeviceCsr, b: DeviceCsr) -> PaddedCoo:
    """Union add keeping cancellation zeros explicit (the host
    ``CsrMatrix.__add__``'s semantics)."""
    return _merge(a, b, +1)


def sub_device(a: DeviceCsr, b: DeviceCsr) -> PaddedCoo:
    return _merge(a, b, -1)


# ---------------------------------------------------------------------------
# ESC SpGEMM
# ---------------------------------------------------------------------------


def expand_plan(lhs: CsrMatrix, rhs: CsrMatrix) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Host symbolic phase of the gather engine: for every intermediate
    product in lhs-CSR order, its lhs entry ``src``, its rhs entry ``q``
    and its output row (int32 each)."""
    from .spgemm_host import _expand_index

    src, q = _expand_index(lhs, rhs)
    out_r = lhs.row_ids()[src]
    return src.astype(np.int32), q.astype(np.int32), out_r.astype(np.int32)


def _esc_impl(lhs_vals, rhs_vals, rhs_indices, src, q, out_r, *, rows: int, cols: int):
    """The gather engine: gather the products, sort by packed key, run
    reduce."""
    qi = q.long()
    key = out_r.long() * cols + rhs_indices[qi].long()
    return _packed_reduce_presort(key, lhs_vals[src.long()] * rhs_vals[qi], rows, cols)


class EscSpgemm:
    """Amortised ESC SpGEMM: the expansion plan and the operand values
    live on ``device``, reusable across multiplies of the same patterns.

    ``engine="auto"`` or ``"pallas"`` (the reference's name for its
    expansion-kernel engine) plans the k-major expansion
    (:mod:`.esc_expand`): the ESC expansion kernel on the card, then the
    packed-key sort or the SpMV reduction. ``engine="xla"`` (or a plan the
    int16 lanes cannot hold) takes the gather engine: gathered products,
    key sort, run reduce. ``"pallas"`` raises where no expansion plan
    exists, as the reference's does (an empty product among them).

    ``reduce="spmv"`` reduces the product stream through the fixed-pattern
    selection-matrix SpMV (:class:`~.spgemm_spmv.ReduceSpmv`, planned by
    ``SpmvOperator``; ``reduce_force`` pins its format); ``"sort"`` keeps
    the packed-key sort; ``"auto"`` tries the SpMV reduction, takes the
    sort where the selection operator cannot be built (``ValueError``),
    and keeps the sort when plan-time values are not finite (the SpMV
    formats read zero-weight window slots, and ``0 * inf = NaN``).

    With the expansion kernel the sort reduction is planned at
    construction (:func:`plan_sort_reduce`, one ``torch.sort`` on the
    device): a multiply is the expansion and one run-sum pass, no sort,
    and its ``row``, ``col`` and ``nnz`` are the plan's tensors, the same
    on every call (read-only). On CUDA the engine keeps the segment
    descriptors of the expansion (:func:`~.esc_expand.expand_segment_arrays`),
    not the plan's int16 lanes.

    ``multiply_device(lhs_vals=, rhs_vals=)`` takes fresh values with the
    same patterns (CSR order) and re-multiplies without re-planning; the
    kernel reads fresh lhs values through the plan's CSC permutation.

    The construction (host plan and upload) is the span ``spmx.plan.esc``.
    """

    def __init__(self, lhs: CsrMatrix, rhs: CsrMatrix, *, device, dtype=np.float32,
                 engine: str = "auto", reduce: str = "auto", reduce_force=None):
        with span("spmx.plan.esc"):
            self._build(lhs, rhs, device, dtype, engine, reduce, reduce_force)

    def _build(self, lhs, rhs, device, dtype, engine, reduce, reduce_force):
        if lhs.cols != rhs.rows:
            raise ValueError("LHS cols != RHS rows")
        if engine not in ("auto", "pallas", "xla"):
            raise ValueError(f"engine must be 'auto', 'pallas' or 'xla', got {engine!r}")
        if reduce not in ("auto", "spmv", "sort"):
            raise ValueError(f"reduce must be 'auto', 'spmv' or 'sort', got {reduce!r}")
        self.device = require_device(device)
        self._dtype = _TORCH_DTYPES[np.dtype(dtype)]
        self.rows, self.cols = lhs.rows, rhs.cols
        self.rhs_vals = self._up(rhs.vals.astype(dtype))
        self._xplan = None
        self._rspmv = None
        if engine in ("auto", "pallas"):
            from .esc_expand import expand_segment_arrays, plan_expand_kmajor

            xp = plan_expand_kmajor(lhs, rhs)
            if xp is not None:
                self._xplan = xp
                self.num_products = xp.num_products
                self.lhs_vals_csc = self._up(lhs.vals[xp.perm_csc].astype(dtype))
                self._expand_arrs = expand_segment_arrays(xp, self.device)
                self._padded = xp.num_slabs * 1024 > xp.num_products
                if reduce == "auto" and not (np.isfinite(lhs.vals).all()
                                             and np.isfinite(rhs.vals).all()):
                    reduce = "sort"
                if reduce in ("auto", "spmv"):
                    from .spgemm_spmv import ReduceSpmv

                    try:
                        self._rspmv = ReduceSpmv(xp.out_key, xp.num_products, self.rows,
                                                 self.cols, device=self.device,
                                                 force=reduce_force, dtype=dtype)
                    except ValueError:
                        if reduce == "spmv":
                            raise
                if self._rspmv is None:  # the packed keys' order, planned once
                    self._runs = plan_sort_reduce(self._up(xp.out_key), self.rows,
                                                  self.cols, padded=self._padded)
            elif engine == "pallas":
                raise ValueError("expansion kernel unavailable: the product has no scalar "
                                 "products, or an operand window exceeds the int16 lanes")
        if self._xplan is None:
            src, q, out_r = expand_plan(lhs, rhs)
            self.num_products = len(src)
            self.src = self._up(src)
            self.q = self._up(q)
            self.out_r = self._up(out_r)
            self.lhs_vals = self._up(lhs.vals.astype(dtype))
            self.rhs_indices = self._up(rhs.indices.astype(np.int32))

    def _up(self, a: np.ndarray) -> torch.Tensor:
        return _t(a, self.device)

    def _vals(self, v) -> torch.Tensor:
        return torch.as_tensor(v, dtype=self._dtype, device=self.device).contiguous()

    @property
    def engine(self) -> str:
        return "pallas" if self._xplan is not None else "xla_gather"

    def multiply_device(self, lhs_vals=None, rhs_vals=None) -> PaddedCoo:
        """``C = A @ B`` as row-sorted :class:`PaddedCoo` on the device,
        with fresh same-pattern values where given (CSR order). The call is
        the span ``spmx.esc.multiply``; with the expansion kernel, the
        expansion and the reduction are its children ``spmx.esc.expand``
        and ``spmx.esc.reduce``."""
        with span("spmx.esc.multiply"):
            rv = self.rhs_vals if rhs_vals is None else self._vals(rhs_vals)
            if self._xplan is not None:
                from .esc_expand import expand_products

                fresh = lhs_vals is not None
                lv = self._vals(lhs_vals) if fresh else self.lhs_vals_csc
                with span("spmx.esc.expand"):
                    p = expand_products(self._xplan, lv, rv, device_arrays=self._expand_arrs,
                                        csr_order=fresh)
                with span("spmx.esc.reduce"):
                    if self._rspmv is not None:
                        return self._rspmv.reduce(p)
                    runs = self._runs
                    if "launch" in runs:
                        val = torch.empty_like(p)
                        runs["launch"](p, val)
                    else:
                        val = _sum_runs_torch(p, runs["order"], runs["run_off"])
                return PaddedCoo(runs["row"], runs["col"], val, runs["nnz"], self.rows,
                                 self.cols)
            lv = self.lhs_vals if lhs_vals is None else self._vals(lhs_vals)
            row, col, val, nnz = _esc_impl(lv, rv, self.rhs_indices, self.src, self.q,
                                           self.out_r, rows=self.rows, cols=self.cols)
            return PaddedCoo(row, col, val, nnz, self.rows, self.cols)

    def multiply(self) -> CsrMatrix:
        return padded_to_host(self.multiply_device())


def spgemm_esc_device(lhs: DeviceCsr, rhs: DeviceCsr, plan=None, host_pair=None, *,
                      device) -> PaddedCoo:
    """The gather engine on device operands: ``plan`` from
    :func:`expand_plan` (host symbolic phase), derived from ``host_pair``
    = (lhs_host, rhs_host) when absent; its arrays go to ``device``, where
    the operands must lie."""
    dev = require_device(device)
    if lhs.vals.device != dev or rhs.vals.device != dev:
        raise ValueError(f"operands on {lhs.vals.device} / {rhs.vals.device}, expected {dev}")
    if plan is None:
        if host_pair is None:
            raise ValueError("need plan or host_pair")
        plan = expand_plan(*host_pair)
    if lhs.cols != rhs.rows:
        raise ValueError("LHS cols != RHS rows")
    src, q, out_r = (_t(a, dev) for a in plan)
    row, col, val, nnz = _esc_impl(lhs.vals, rhs.vals, rhs.indices, src, q, out_r,
                                   rows=lhs.rows, cols=rhs.cols)
    return PaddedCoo(row, col, val, nnz, lhs.rows, rhs.cols)
