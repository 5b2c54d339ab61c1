"""Fused banded triangular Jacobi sweeps: every sweep of a solve in one launch.

Counterpart of ``sparse_matrix_tpu/ops/trisweep.py``. For a triangular
``T = D + N`` with strictly triangular, banded ``N`` in DIA form,
``x_0 = dinv * b`` and ``x_{k+1} = dinv * (b - N x_k)``, ``sweeps`` times
(the Chow-Patel approximate triangular solve of
``solvers/ilu.py::TriangularJacobi``; ``D^{-1} N`` is nilpotent, so
``sweeps >= depth(T) - 1`` is exact). On CUDA the kernel
``csrc/trisweep.cu`` runs every sweep in one ordinary launch, one thread
block a chunk of rows, each chunk's band planes, b and dinv read from
device memory once; on the CPU the plain version :func:`_trisweep_torch`,
the reference's ``_trisweep_xla`` shift algebra, runs.
:func:`_trisweep_chunks_torch` evaluates the kernel's chunk schedule (the
tests hold it to the plain version bit for bit; no call path uses it).

Not ported: the reference's VMEM cap (``_TRISWEEP_VMEM_BYTES``, 56 MB of
resident working set, which refuses Poisson 2048^2) and its ``r128``
padding of the planes to (8, 128) tiles. Both are walls of the TPU. The
``rows < 128`` gate stays. The kernel needs N's offsets all of one sign,
as N is in every factor ``TriangularJacobi`` builds (the strict part of a
triangular matrix): :func:`plan_trisweep` gives no plan for offsets of
mixed sign, which the reference would sweep (ROADMAP C18).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import on_cuda, require_device

__all__ = ["TrisweepPlan", "plan_trisweep", "trisweep", "trisweep_chunk_rows",
           "trisweep_halo", "trisweep_smem_bytes", "trisweep_f64_bound"]

_U32 = 2.0 ** -24  # unit roundoff of float32

#: the shared memory of one block of the trisweep kernel at the default
#: chunk size: two blocks of 512 threads share an H100 SM (228 KB)
TRISWEEP_SMEM_BYTES = 113 * 1024

#: the most neighbour rows (N's reach) the kernel stages in shared memory
#: each level; a factor of a longer reach reads them from L2
TRISWEEP_MAX_HALO = 8192


def trisweep_halo(offsets) -> int:
    """The neighbour rows the kernel stages each level: N's reach (max
    |offset|) up to :data:`TRISWEEP_MAX_HALO`, else 0."""
    reach = max((abs(int(o)) for o in offsets), default=0)
    return reach if reach <= TRISWEEP_MAX_HALO else 0


def trisweep_smem_bytes(nb: int, chunk_rows: int, halo: int = 0) -> int:
    """Shared memory of one block of the trisweep kernel: the offsets
    (padded to 4), a row the ``nb`` planes, b, dinv and two levels, and the
    ``halo`` staged neighbour rows."""
    return (nb + 4) * chunk_rows * 4 + -(-nb // 4) * 16 + halo * 4


def trisweep_chunk_rows(nb: int, rows: int, halo: int = 0):
    """The kernel's default rows a chunk for ``nb`` bands and ``halo``
    staged rows: the largest power of two in [32, 65536] whose shared
    memory (:func:`trisweep_smem_bytes`) fits :data:`TRISWEEP_SMEM_BYTES`,
    no larger than ``rows`` rounded up to a power of two; None when not
    even 32 rows fit."""
    t = 1 << 16
    while t >= 32 and trisweep_smem_bytes(nb, t, halo) > TRISWEEP_SMEM_BYTES:
        t >>= 1
    if t < 32:
        return None
    return max(32, min(t, 1 << max(0, int(rows) - 1).bit_length()))


class TrisweepPlan:
    """Static plan: the DIA offsets of the strict part ``N`` (all negative,
    or all positive) and its band planes ``data`` ``(nb, rows)`` on
    ``device``, in the dtype of the host DIA data (float32 for the kernel),
    with the kernel's ``chunk_rows`` (default :func:`trisweep_chunk_rows`).
    On CUDA the plan owns the kernel's launch record, made at the first
    solve and again when a solve takes more sweeps than its scratch holds:
    one solve at a time per plan."""

    def __init__(self, offsets: tuple, data: np.ndarray, rows: int, *, device,
                 chunk_rows=None):
        self.offsets = tuple(int(o) for o in offsets)
        self.rows = int(rows)
        if data.shape != (len(self.offsets), self.rows):
            raise ValueError("trisweep plan: data must be (len(offsets), rows)")
        if not (all(o < 0 for o in self.offsets) or all(o > 0 for o in self.offsets)):
            raise ValueError("trisweep plan: N's offsets must all be of one sign")
        self.halo = trisweep_halo(self.offsets)
        self.chunk_rows = (trisweep_chunk_rows(len(self.offsets), self.rows, self.halo)
                           if chunk_rows is None else int(chunk_rows))
        if self.chunk_rows is None:
            raise ValueError(f"trisweep plan: {len(self.offsets)} bands do not fit a chunk")
        self.device = require_device(device)
        self.data = torch.from_numpy(np.ascontiguousarray(data)).to(self.device)
        self.offsets_t = torch.tensor(self.offsets, dtype=torch.int32, device=self.device)
        self.launch = None
        self._state = None

    def _record(self, sweeps: int):
        """The launch record for a solve of ``sweeps`` sweeps: the plan's,
        made anew with scratch and flags for ``sweeps`` levels when the
        current one holds fewer (the ticket and epoch ``state`` is kept)."""
        from ..native import kernels

        rec = self.launch
        if rec is not None and (not rec.publishes or sweeps <= rec.levels):
            return rec
        dev, t = self.device, self.chunk_rows
        chunks = -(-self.rows // t)
        tail = min(max((abs(o) for o in self.offsets), default=0), t)
        levels = max(int(sweeps), 1) if chunks > 1 and tail > 0 else 0
        if self._state is None:
            self._state = torch.zeros(2, dtype=torch.int32, device=dev)
        scratch = torch.empty(chunks * levels * tail, dtype=torch.float32, device=dev)
        flags = torch.zeros(chunks * levels, dtype=torch.int32, device=dev)
        self.launch = kernels.prepare_trisweep(self.data, self.offsets_t, scratch, flags,
                                               self._state, offsets=self.offsets,
                                               rows=self.rows, chunk_rows=t, levels=levels,
                                               halo=self.halo)
        return self.launch


def plan_trisweep(dia, rows: int, *, device, chunk_rows=None):
    """A :class:`TrisweepPlan` from a ``DiaMatrix`` of the STRICT part N on
    ``device``, or None when the fused solve does not apply: ``rows <
    128`` (the reference's gate), offsets of both signs (not the strict
    part of a triangular factor), or more bands than a chunk of 32 rows
    holds."""
    offsets = tuple(int(o) for o in dia.offsets)
    if rows < 128 or not (all(o < 0 for o in offsets) or all(o > 0 for o in offsets)):
        return None
    if chunk_rows is None and trisweep_chunk_rows(len(offsets), rows,
                                                  trisweep_halo(offsets)) is None:
        return None
    return TrisweepPlan(offsets, np.asarray(dia.data), rows, device=device,
                        chunk_rows=chunk_rows)


def _apply_n(data, x, *, offsets: tuple, rows: int):
    """``N x`` by shifted slices of a zero-padded x, bands summed in plan
    order (x reads as zero outside ``[0, rows)``)."""
    lo = -min(0, min(offsets, default=0))
    hi = max(0, max(offsets, default=0))
    xpad = torch.zeros(lo + rows + hi, dtype=x.dtype, device=x.device)
    xpad[lo : lo + rows] = x
    acc = torch.zeros(rows, dtype=x.dtype, device=x.device)
    for bnd, off in enumerate(offsets):
        acc = acc + data[bnd] * xpad[lo + off : lo + off + rows]
    return acc


def _trisweep_torch(data, b, dinv, *, offsets: tuple, rows: int, sweeps: int):
    """Plain PyTorch version: the counterpart of the reference's
    ``_trisweep_xla`` (every product, sum, difference and scaling its own
    rounded operation, as in the kernel)."""
    x = dinv * b
    for _ in range(sweeps):
        x = dinv * (b - _apply_n(data, x, offsets=offsets, rows=rows))
    return x


def _trisweep_chunks_torch(plan, b, dinv, sweeps: int, chunk_rows: int):
    """The sweeps evaluated in the kernel's schedule: chunks of
    ``chunk_rows`` rows in ticket order (ascending for negative offsets,
    descending for positive ones), each running every level on its own
    rows and reading its neighbours' rows of level k only from the slots
    they published (the ``min(reach, chunk_rows)`` rows next to it, for
    levels below ``sweeps``), with every product, sum, difference and
    scaling rounded as in :func:`_trisweep_torch`. A read of a slot no
    earlier chunk published raises. The CPU tests hold it to
    :func:`_trisweep_torch` bit for bit; no call path uses it."""
    offsets, rows, data = plan.offsets, plan.rows, plan.data
    t = int(chunk_rows)
    chunks = -(-rows // t)
    reach = max((abs(o) for o in offsets), default=0)
    upper = any(o > 0 for o in offsets)
    tail = min(reach, t)
    slots = {}  # (chunk, level) -> (first row, published rows)
    y = torch.empty_like(b)
    for ticket in range(chunks):
        c = chunks - 1 - ticket if upper else ticket
        c0 = c * t
        n = min(t, rows - c0)
        lo, hi = (c0, c0 + min(tail, n)) if upper else (c0 + t - tail, c0 + t)
        publish = tail > 0 and (c > 0 if upper else c < chunks - 1)
        bb, dd = b[c0:c0 + n], dinv[c0:c0 + n]
        x = dd * bb
        for k in range(sweeps + 1):
            if k > 0:
                # level k - 1 of rows [c0 - reach, c0 + n + reach): own rows,
                # neighbours' published rows, zero outside [0, rows)
                ext = torch.zeros(n + 2 * reach, dtype=b.dtype, device=b.device)
                have = torch.zeros(n + 2 * reach, dtype=torch.bool, device=b.device)
                ext[reach:reach + n] = x
                have[reach:reach + n] = True
                producers = (range(c + 1, min(chunks, (c0 + n + reach - 1) // t + 1)) if upper
                             else range(max(0, (c0 - reach) // t), c))
                for cc in producers:
                    first, vals = slots[cc, k - 1]
                    a, z = max(first, c0 - reach), min(first + vals.numel(), c0 + n + reach)
                    if a < z:
                        ext[a - c0 + reach:z - c0 + reach] = vals[a - first:z - first]
                        have[a - c0 + reach:z - c0 + reach] = True
                outside = torch.arange(c0 - reach, c0 + n + reach, device=b.device)
                have |= (outside < 0) | (outside >= rows)
                acc = torch.zeros(n, dtype=b.dtype, device=b.device)
                for bnd, off in enumerate(offsets):
                    if not bool(have[reach + off:reach + off + n].all()):
                        raise AssertionError(f"chunk {c} reads rows of level {k - 1} no chunk "
                                             "published")
                    acc = acc + data[bnd, c0:c0 + n] * ext[reach + off:reach + off + n]
                x = dd * (bb - acc)
            if publish and k < sweeps:
                slots[c, k] = (lo, x[lo - c0:hi - c0].clone())
        y[c0:c0 + n] = x
    return y


def trisweep(plan: TrisweepPlan, b: torch.Tensor, dinv: torch.Tensor, *, sweeps: int):
    """``x_sweeps`` for ``b`` and ``dinv`` ``(rows,)`` on the plan's device:
    one launch of the fused kernel for CUDA tensors (float32), the plain
    version for CPU tensors. The two are equal bit for bit.

    Accuracy, against the same sweeps in exact arithmetic on the same
    float32 inputs (:func:`trisweep_f64_bound` computes it), componentwise
    and away from underflow::

        |x^_s - x_s| <= E_s,  E_0 = g |D^-1| |b|,
        E_{k+1} = |D^-1| |N| E_k + g |D^-1| (|b| + |N| |x^_k|),

    ``g = gamma_{nb+2} = (nb + 2) u / (1 - (nb + 2) u)``, ``u = 2^-24``,
    ``x^_k`` the computed iterates: each sweep rounds a sum of ``nb``
    products, one difference and one scaling, and the error of earlier
    sweeps passes through ``D^-1 N``.
    """
    sweeps = int(sweeps)
    if sweeps < 0:
        raise ValueError("trisweep: sweeps must be >= 0")
    if b.shape != (plan.rows,) or dinv.shape != (plan.rows,):
        raise ValueError(f"trisweep: b and dinv must be ({plan.rows},)")
    if b.device != plan.device or dinv.device != plan.device:
        raise ValueError(f"trisweep: b and dinv must be on {plan.device}")
    if on_cuda(b):
        y = torch.empty_like(b)
        plan._record(sweeps)(b.contiguous(), dinv.contiguous(), y, sweeps)
        return y
    return _trisweep_torch(plan.data, b, dinv, offsets=plan.offsets, rows=plan.rows,
                           sweeps=sweeps)


def trisweep_f64_bound(plan: TrisweepPlan, b: torch.Tensor, dinv: torch.Tensor, *,
                       sweeps: int):
    """``(x64, bound)``: the sweeps of :func:`trisweep` in float64 on the
    same inputs, and the componentwise bound of its docstring on the float32
    result, both float64 tensors on the plan's device. The bound is raised
    by a factor ``1 + 2^-20`` for the float64 reference's own rounding."""
    offsets, rows = plan.offsets, plan.rows
    data64 = plan.data.double()
    abs_n = data64.abs()
    b64, dinv64 = b.double(), dinv.double()
    abs_b, abs_dinv = b64.abs(), dinv64.abs()
    nb2 = (len(offsets) + 2) * _U32
    g = nb2 / (1.0 - nb2)
    x64 = dinv64 * b64
    xh = dinv * b
    bound = g * abs_dinv * abs_b
    for _ in range(sweeps):
        n_xh = _apply_n(abs_n, xh.double().abs(), offsets=offsets, rows=rows)
        bound = (abs_dinv * _apply_n(abs_n, bound, offsets=offsets, rows=rows)
                 + g * abs_dinv * (abs_b + n_xh))
        x64 = dinv64 * (b64 - _apply_n(data64, x64, offsets=offsets, rows=rows))
        xh = dinv * (b - _apply_n(plan.data, xh, offsets=offsets, rows=rows))
    return x64, bound * (1.0 + 2.0 ** -20)
