"""Block-dense SpGEMM: ``C = A @ B`` as a stream of dense block products.

Counterpart of ``sparse_matrix_tpu/ops/spgemm_block.py``:

* **symbolic phase** (host, numpy): :func:`block_pairs_plan` lists every
  (A block, B block) pair that contributes to a C block, sorted by C block
  (array-equal to the reference's);
* **numeric phase** (device): ``C[c] += A[a] @ B[b]`` per pair through the
  block SpGEMM kernel (``csrc/spgemm_block.cu``) on CUDA tensors, the plain
  :func:`_block_numeric_torch` on CPU ones. FP32 throughout, no TF32
  (ROADMAP.md C5); bf16 block storage is widened, products accumulate in
  f32;
* C comes back as dense blocks, sparsified on the device by
  :func:`_sparsify_blocks` (exact zeros, cancellation zeros among them,
  are dropped, as in the reference); only the live prefix is read back;
* :func:`spgemm_err_over_bound` — the float64 oracle of a product with
  its per-entry float32 error bound, which the tests and ``chip_smoke.py``
  hold the engine to.

* :func:`spgemm_cost_estimates` and :func:`spgemm_auto` — the SpGEMM
  dispatch behind ``CsrMatrix.__matmul__``: host hash engine, band
  convolution, dense-block engine, one dense matmul or the ESC engine, by
  the reference's rules and cost model (its v5e constants,
  ``utils/autotune.py``).

The reference's 64K-pair call segmentation (a TPU SMEM limit) and its
``precision`` argument are not carried over.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import default_device, on_cuda, require_device
from ..formats.bcsr import BLOCK_SIZE, BsrMatrix
from ..formats.csr import CsrMatrix, sample_row_bands
from .device_sorted import PaddedCoo, padded_to_host
from .spmv import U_F32, _t

__all__ = [
    "block_pairs_plan",
    "spgemm_block_pad_device",
    "spgemm_block_device",
    "BlockSpgemm",
    "spgemm_dense",
    "spgemm_err_over_bound",
    "spgemm_cost_estimates",
    "spgemm_auto_engine",
    "spgemm_auto",
]

# pairs per step of the plain numeric phase: the gathered operands of all
# pairs at once would not fit (262,144 pairs of 64 KB blocks are 17 GB)
_TORCH_PAIR_CHUNK = 4096


def block_pairs_plan(a: BsrMatrix, b: BsrMatrix) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host symbolic phase at block granularity.

    Returns (pair_a, pair_b, pair_c, c_block_keys): for each contributing
    pair p, C block ``pair_c[p]`` accumulates ``A.blocks[pair_a[p]] @
    B.blocks[pair_b[p]]``. Pairs are sorted by C block, and within a C
    block by B block (the f32 sum order); ``c_block_keys`` are the
    distinct C blocks as ``brow * bcols + bcol``.
    """
    a_brows = a.block_rows_expanded()
    a_bcols = a.block_cols.astype(np.int64)
    reps = np.diff(b.block_offsets)[a_bcols]
    total = int(reps.sum())
    src = np.repeat(np.arange(a.nnzb, dtype=np.int64), reps)
    starts = np.zeros(a.nnzb + 1, dtype=np.int64)
    np.cumsum(reps, out=starts[1:])
    within = np.arange(total, dtype=np.int64) - starts[src]
    q = b.block_offsets[a_bcols[src]] + within  # B block index
    c_key = a_brows[src] * b.bcols + b.block_cols.astype(np.int64)[q]
    order = np.lexsort((q, c_key))
    src, q, c_key = src[order], q[order], c_key[order]
    uniq, inv = np.unique(c_key, return_inverse=True)
    return (
        src.astype(np.int32),
        q.astype(np.int32),
        inv.astype(np.int32),
        uniq.astype(np.int64),
    )


def _pair_segments(pair_c: torch.Tensor, num_c: int) -> torch.Tensor:
    """(num_c + 1,) int32 offsets of each C block's pairs (``pair_c`` is
    sorted): the kernel's per-block loop bounds."""
    seg = torch.zeros(num_c + 1, dtype=torch.int64, device=pair_c.device)
    seg[1:] = torch.cumsum(torch.bincount(pair_c.long(), minlength=num_c), 0)
    return seg.to(torch.int32)


def _block_numeric_torch(a_blocks, b_blocks, pair_a, pair_b, pair_c, *, num_c: int, bs: int):
    """Plain PyTorch numeric phase: the counterpart of the reference's CPU
    branch (gathered block products, einsum in f32, scatter-added into C),
    ``_TORCH_PAIR_CHUNK`` pairs at a time in pair order."""
    c = torch.zeros((num_c, bs, bs), dtype=torch.float32, device=a_blocks.device)
    for s in range(0, pair_a.shape[0], _TORCH_PAIR_CHUNK):
        sl = slice(s, s + _TORCH_PAIR_CHUNK)
        prods = torch.einsum("pij,pjk->pik", a_blocks[pair_a[sl].long()].float(),
                             b_blocks[pair_b[sl].long()].float())
        c.index_add_(0, pair_c[sl].long(), prods)
    return c


def _block_numeric(a_blocks, b_blocks, pair_a, pair_b, pair_c, *, num_c: int, bs: int,
                   seg=None):
    """Dense C blocks (num_c, bs, bs) f32: the block SpGEMM kernel on CUDA
    tensors (``seg``: :func:`_pair_segments`, computed when None), the
    plain version on CPU ones."""
    if not on_cuda(a_blocks):
        return _block_numeric_torch(a_blocks, b_blocks, pair_a, pair_b, pair_c,
                                    num_c=num_c, bs=bs)
    from ..native.kernels import launch_block_spgemm

    if seg is None:
        seg = _pair_segments(pair_c, num_c)
    c = torch.empty((num_c, bs, bs), dtype=torch.float32, device=a_blocks.device)
    launch_block_spgemm(a_blocks, b_blocks, pair_a, pair_b, seg, c)
    return c


def _sparsify_blocks(c_blocks, c_brows, c_bcols, *, rows: int, cols: int, bs: int):
    """Dense C blocks to row-sorted padded COO on the device: the
    counterpart of ``_sparsify_blocks_jit``. Zero slots, and slots past
    ``rows`` or ``cols``, get the sentinel row ``rows``; one int64 key
    ``row * width + col`` (``width`` the padded column count) sorts them
    to the tail, the order of the reference's two-key sort. Returns
    ``(row, col, val, nnz)``."""
    dev = c_blocks.device
    ar = torch.arange(bs, device=dev)
    r = c_brows.long()[:, None, None] * bs + ar[None, :, None]
    c = c_bcols.long()[:, None, None] * bs + ar[None, None, :]
    v = c_blocks.reshape(-1)
    r = r.expand(-1, -1, bs).reshape(-1)
    c = c.expand(-1, bs, -1).reshape(-1)
    live = (v != 0) & (r < rows) & (c < cols)
    width = -(-cols // bs) * bs
    key = torch.where(live, r, rows) * width + c
    key, order = torch.sort(key)
    return ((key // width).to(torch.int32), (key % width).to(torch.int32), v[order],
            live.sum(dtype=torch.int32))


def spgemm_block_pad_device(lhs: CsrMatrix, rhs: CsrMatrix, *, device, bs: int = BLOCK_SIZE):
    """``C = A @ B`` through the block SpGEMM kernel, as a device-resident
    row-sorted :class:`~.device_sorted.PaddedCoo` (no host sparsify
    pass). Blocks are f32."""
    eng = BlockSpgemm(lhs, rhs, device=device, bs=bs)
    return eng.multiply_coo(eng.multiply_device())


def spgemm_block_device(lhs: CsrMatrix, rhs: CsrMatrix, *, device,
                        bs: int = BLOCK_SIZE) -> CsrMatrix:
    """``C = A @ B`` through the block SpGEMM kernel; host CSR in and out,
    exact zeros dropped. The sparsify pass runs on the device; only the
    live prefix of its sorted result is read back."""
    return padded_to_host(spgemm_block_pad_device(lhs, rhs, device=device, bs=bs))


class BlockSpgemm:
    """Block SpGEMM with its blocks and pair plan kept on ``device``,
    reusable across repeated multiplies of the same operands.

    ``storage="bf16"`` keeps the A and B blocks in bfloat16, halving their
    bytes, at bf16 operand precision (each product of two bf16 values is
    exact in f32); C accumulates in f32 either way. ``storage="f32"`` keeps
    f32 operands.
    """

    def __init__(self, lhs: CsrMatrix, rhs: CsrMatrix, *, device, bs: int = BLOCK_SIZE,
                 storage: str = "f32"):
        if lhs.cols != rhs.rows:
            raise ValueError("LHS cols != RHS rows")
        if storage not in ("f32", "bf16"):
            raise ValueError(f"storage must be 'f32' or 'bf16', got {storage!r}")
        self.device = require_device(device)
        self.bs = bs
        self.rows, self.cols = lhs.rows, rhs.cols
        a = BsrMatrix.from_csr(lhs, bs)
        b = BsrMatrix.from_csr(rhs, bs)
        pair_a, pair_b, pair_c, self.c_keys = block_pairs_plan(a, b)
        self.num_pairs = len(pair_a)
        block_dtype = torch.bfloat16 if storage == "bf16" else torch.float32
        self.a_blocks = _t(a.blocks, self.device).to(block_dtype)
        self.b_blocks = _t(b.blocks, self.device).to(block_dtype)
        self.pair_a = _t(pair_a, self.device)
        self.pair_b = _t(pair_b, self.device)
        self.pair_c = _t(pair_c, self.device)
        self.pair_seg = _pair_segments(self.pair_c, len(self.c_keys))
        bcols_c = -(-rhs.cols // bs)
        self.c_brows = _t((self.c_keys // bcols_c).astype(np.int32), self.device)
        self.c_bcols = _t((self.c_keys % bcols_c).astype(np.int32), self.device)

    def multiply_device(self) -> torch.Tensor:
        """The numeric phase: dense C blocks (num_c, bs, bs) f32 on the
        device, in ``c_keys`` order."""
        return _block_numeric(self.a_blocks, self.b_blocks, self.pair_a, self.pair_b,
                              self.pair_c, num_c=len(self.c_keys), bs=self.bs,
                              seg=self.pair_seg)

    def multiply_coo(self, c_blocks: torch.Tensor) -> PaddedCoo:
        """Dense C blocks (``multiply_device``) as row-sorted padded COO on
        the device, exact zeros sent to the tail."""
        r, c, v, nnz = _sparsify_blocks(c_blocks, self.c_brows, self.c_bcols,
                                        rows=self.rows, cols=self.cols, bs=self.bs)
        return PaddedCoo(r, c, v, nnz, self.rows, self.cols)

    def multiply(self) -> CsrMatrix:
        """``C = A @ B`` as host CSR: the numeric phase, the device sparsify
        and a readback of the live prefix."""
        return padded_to_host(self.multiply_coo(self.multiply_device()))


U_BF16 = 2.0 ** -8  # unit roundoff of bfloat16


def spgemm_err_over_bound(lhs: CsrMatrix, rhs: CsrMatrix, c: CsrMatrix, *,
                          bf16: bool = False) -> float:
    """The largest ``|c - C| / bound`` over the union of the patterns of
    ``c`` and of the structural product, where C is the float64 product of
    the float32 operands (one expanded product per ``lhs`` entry and
    ``rhs`` row entry, summed) and ``bound = (n_ij + 2) * u * (|A||B|)_ij``
    for an entry of n_ij products (u = 2^-24), plus ``2 * 2^-8 *
    (|A||B|)_ij`` for bf16 operands. An entry of ``c`` outside the
    structural pattern gives ``inf``; a float32 evaluation passes at <= 1.
    """
    from .spgemm_host import _expand_index

    src, q = _expand_index(lhs, rhs)
    prod = (lhs.vals.astype(np.float32).astype(np.float64)[src]
            * rhs.vals.astype(np.float32).astype(np.float64)[q])
    keys, inv = np.unique(lhs.row_ids()[src] * rhs.cols + rhs.indices.astype(np.int64)[q],
                          return_inverse=True)
    c64 = np.bincount(inv, weights=prod, minlength=keys.size)
    mag = np.bincount(inv, weights=np.abs(prod), minlength=keys.size)
    n = np.bincount(inv, minlength=keys.size)
    bound = ((n + 2) * U_F32 + (2 * U_BF16 if bf16 else 0.0)) * mag
    got_keys = c.row_ids() * c.cols + c.indices.astype(np.int64)
    pos = np.searchsorted(keys, got_keys)
    if np.any(pos >= keys.size) or np.any(keys[np.minimum(pos, keys.size - 1)] != got_keys):
        return float("inf")
    got = np.zeros(keys.size)
    got[pos] = c.vals.astype(np.float64)
    err = np.abs(got - c64)
    if np.any(err[bound == 0] > 0):
        return float("inf")
    return float(np.max(err / np.where(bound == 0, 1.0, bound), initial=0.0))


def spgemm_dense(lhs: CsrMatrix, rhs: CsrMatrix, *, device) -> CsrMatrix:
    """Densify, one f32 ``torch.matmul`` on ``device``, sparsify on the
    host: the counterpart of ``spgemm_dense_xla`` (a plain dense product
    outside any kernel). It refuses to run while TF32 matmuls are allowed
    (ROADMAP.md C5)."""
    if lhs.cols != rhs.rows:
        raise ValueError("LHS cols != RHS rows")
    dev = require_device(device)
    if dev.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("spgemm_dense runs in FP32: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")
    a = _t(lhs.to_dense().astype(np.float32), dev)
    b = _t(rhs.to_dense().astype(np.float32), dev)
    c = torch.matmul(a, b).cpu().numpy()
    r, cc = np.nonzero(c)
    return CsrMatrix.from_coo(lhs.rows, rhs.cols, r, cc, c[r, cc], sum_duplicates=False)


def _host_rate() -> float:
    """The host engine's products per second: the per-core constant times
    the cores, as the reference prices its native engine."""
    from ..utils import autotune

    return autotune.get("spgemm_host_products_per_s") * max(1, os.cpu_count() or 1)


def spgemm_cost_estimates(lhs: CsrMatrix, rhs: CsrMatrix, *,
                          products: Optional[float] = None) -> dict:
    """Estimated end-to-end seconds of each SpGEMM engine on this input,
    ``{"host", "mxu", "dense", "esc"}`` (the reference's model and
    constants). ``products`` (``flops_per_row(lhs, rhs).sum()``) may be
    passed in when the caller has it."""
    from ..utils import autotune
    from .spgemm_host import flops_per_row

    bs = BLOCK_SIZE

    def _blocks(m: CsrMatrix) -> float:
        # distinct (row block, col block) count, on sampled row bands
        # above 1.5M entries
        mm, scale = m, 1.0
        if m.nnz() > 1_500_000:
            mm, scale = sample_row_bands(m)
        bc = -(-mm.cols // bs)
        keys = mm.row_ids() // bs * bc + mm.indices.astype(np.int64) // bs
        return len(np.unique(keys)) * scale

    a_blocks = _blocks(lhs)
    b_blocks = _blocks(rhs)
    bcols_b = -(-rhs.cols // bs)
    brows_b = -(-rhs.rows // bs)
    pair_est = a_blocks * max(1.0, b_blocks / max(1, brows_b))
    c_blocks_est = min(-(-lhs.rows // bs) * bcols_b, pair_est)

    host_touch = autotune.get("spgemm_host_touch_s_per_byte")
    mxu_pair = autotune.get("spgemm_mxu_pair_s")
    dense_rate = autotune.get("spgemm_dense_mac_per_s")
    esc_rate = autotune.get("spgemm_esc_products_per_s")
    # every device engine pays the one-shot sync and the first-call compile
    dev_fixed = autotune.get("device_call_sync_s") + autotune.get("device_oneshot_compile_s")
    if products is None:
        products = float(flops_per_row(lhs, rhs).sum())
    return {
        "host": products / _host_rate(),
        "mxu": pair_est * mxu_pair + c_blocks_est * bs * bs * 4 * host_touch + dev_fixed,
        "dense": (
            lhs.rows * lhs.cols * rhs.cols * 2 / dense_rate
            + (lhs.rows * lhs.cols + rhs.rows * rhs.cols + lhs.rows * rhs.cols) * 4 * host_touch
            + dev_fixed
        ),
        # host plan build (3 index streams) + device rate + fixed
        "esc": products * 12 * host_touch + products / esc_rate + dev_fixed,
    }


def spgemm_auto_engine(lhs: CsrMatrix, rhs: CsrMatrix, *, device=None) -> str:
    """The engine :func:`spgemm_auto` takes for this product on ``device``
    (``None``: the default device): ``"host"``, ``"dia"`` (band
    convolution), ``"dense"``, ``"esc"`` or ``"mxu"`` (the dense-block
    engine), by the reference's rules in its order: tiny products on the
    host; banded x banded through band convolution; on a CPU device the
    host engine (the reference's test for a TPU backend); products below
    the device floor (sync plus one-shot compile) on the host; else the
    cheapest of :func:`spgemm_cost_estimates`.

    The reference first sends an rhs with at most one entry per row to its
    native column-relabel engine; the port has no native runtime and falls
    through, as the reference does without its library (the values agree
    within the float32 bound; the pattern may differ by cancellation
    zeros).
    """
    dev = default_device() if device is None else require_device(device)
    return _choose_engine(lhs, rhs, dev)[0]


def _choose_engine(lhs: CsrMatrix, rhs: CsrMatrix, dev: torch.device):
    """``(engine, (dia_lhs, dia_rhs))`` for :func:`spgemm_auto_engine`; the
    DIA forms are the band engine's operands (None for other engines)."""
    from ..formats.dia import try_dia_from_csr
    from ..utils import autotune
    from .spgemm_host import flops_per_row

    # dims first: the estimators gather rhs row counts through lhs columns
    if lhs.cols != rhs.rows:
        raise ValueError("LHS cols != RHS rows")
    # tiny products: every device engine pays at least the one-shot sync
    products = float(flops_per_row(lhs, rhs).sum())
    if products / _host_rate() <= autotune.get("device_call_sync_s"):
        return "host", None
    # banded x banded: band convolution is the closed-form product
    da = try_dia_from_csr(lhs)
    if da is not None:
        db = try_dia_from_csr(rhs)
        if db is not None and da.nbands * db.nbands <= 4096:
            return "dia", (da, db)
    if dev.type == "cpu":
        return "host", None
    # below the device floor the block estimators are not worth their host time
    dev_floor = autotune.get("device_call_sync_s") + autotune.get("device_oneshot_compile_s")
    if products / _host_rate() <= dev_floor:
        return "host", None
    costs = spgemm_cost_estimates(lhs, rhs, products=products)
    return min(costs, key=costs.get), None


def spgemm_auto(lhs: CsrMatrix, rhs: CsrMatrix, *, output_sorted: bool = True,
                device=None) -> CsrMatrix:
    """``C = A @ B`` through the engine :func:`spgemm_auto_engine` picks:
    :func:`~.spgemm_host.spgemm_hash_host`,
    :func:`~.spgemm_dia.spgemm_dia`, :func:`spgemm_dense`,
    ``EscSpgemm(reduce="sort")`` or :func:`spgemm_block_device`, on
    ``device`` (``None``: :func:`~..device.default_device`)."""
    from .spgemm_host import spgemm_hash_host

    dev = default_device() if device is None else require_device(device)
    engine, dia_pair = _choose_engine(lhs, rhs, dev)
    if engine == "host":
        return spgemm_hash_host(lhs, rhs, output_sorted=output_sorted)
    if engine == "dia":
        from .spgemm_dia import spgemm_dia

        out = spgemm_dia(*dia_pair, device=dev).to_csr()
    elif engine == "dense":
        out = spgemm_dense(lhs, rhs, device=dev)
    elif engine == "esc":
        from .device_sorted import EscSpgemm

        # one-shot: the SpMV-reduce plan costs host time only re-multiplies recover
        out = EscSpgemm(lhs, rhs, device=dev, reduce="sort").multiply()
    else:
        out = spgemm_block_device(lhs, rhs, device=dev)
    return CsrMatrix(out.rows, out.cols, out.vals, out.indices, out.offsets,
                     is_sorted=output_sorted)
