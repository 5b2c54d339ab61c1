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
:class:`~.spgemm_spmv.ReduceSpmv` (``reduce="spmv"``). The reference's
``as_pytree``/``params=`` (jit arguments) are not ported: there is no jit
to feed.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import require_device
from ..formats.csr import INDEX_DTYPE, OFFSET_DTYPE, CsrMatrix
from ..formats.device import DeviceCsr
from .spmv import _TORCH_DTYPES, _t

__all__ = [
    "PaddedCoo",
    "padded_to_host",
    "transpose_device",
    "add_device",
    "sub_device",
    "expand_plan",
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

    ``multiply_device(lhs_vals=, rhs_vals=)`` takes fresh values with the
    same patterns (CSR order) and re-multiplies without re-planning.
    """

    def __init__(self, lhs: CsrMatrix, rhs: CsrMatrix, *, device, dtype=np.float32,
                 engine: str = "auto", reduce: str = "auto", reduce_force=None):
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
            from .esc_expand import expand_device_arrays, plan_expand_kmajor

            xp = plan_expand_kmajor(lhs, rhs)
            if xp is not None:
                self._xplan = xp
                self.num_products = xp.num_products
                self.lhs_vals_csc = self._up(lhs.vals[xp.perm_csc].astype(dtype))
                self._expand_arrs = expand_device_arrays(xp, self.device)
                self._lhs_perm = self._up(xp.perm_csc)
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
                if self._rspmv is None:  # the sort reduction sorts the packed keys
                    self.out_key = self._up(xp.out_key)
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
        return torch.as_tensor(v, dtype=self._dtype, device=self.device)

    @property
    def engine(self) -> str:
        return "pallas" if self._xplan is not None else "xla_gather"

    def multiply_device(self, lhs_vals=None, rhs_vals=None) -> PaddedCoo:
        """``C = A @ B`` as row-sorted :class:`PaddedCoo` on the device,
        with fresh same-pattern values where given (CSR order)."""
        rv = self.rhs_vals if rhs_vals is None else self._vals(rhs_vals)
        if self._xplan is not None:
            from .esc_expand import expand_products

            lv = (self.lhs_vals_csc if lhs_vals is None
                  else self._vals(lhs_vals)[self._lhs_perm])
            p = expand_products(self._xplan, lv, rv, device_arrays=self._expand_arrs)
            if self._rspmv is not None:
                return self._rspmv.reduce(p)
            row, col, val, nnz = _packed_reduce_presort(self.out_key, p, self.rows, self.cols)
            if self._padded:
                nnz = nnz - 1  # the sentinel-keyed run of the padding slots
            return PaddedCoo(row, col, val, nnz, self.rows, self.cols)
        lv = self.lhs_vals if lhs_vals is None else self._vals(lhs_vals)
        row, col, val, nnz = _esc_impl(lv, rv, self.rhs_indices, self.src, self.q, self.out_r,
                                       rows=self.rows, cols=self.cols)
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
