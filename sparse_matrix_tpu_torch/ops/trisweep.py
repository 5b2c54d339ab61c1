"""Fused banded triangular Jacobi sweeps: every sweep of a solve in one launch.

Counterpart of ``sparse_matrix_tpu/ops/trisweep.py``. For a triangular
``T = D + N`` with strictly triangular, banded ``N`` in DIA form,
``x_0 = dinv * b`` and ``x_{k+1} = dinv * (b - N x_k)``, ``sweeps`` times
(the Chow-Patel approximate triangular solve of
``solvers/ilu.py::TriangularJacobi``; ``D^{-1} N`` is nilpotent, so
``sweeps >= depth(T) - 1`` is exact). On CUDA the kernel
``csrc/trisweep.cu`` runs every sweep in one cooperative launch; on the
CPU the plain version :func:`_trisweep_torch`, the reference's
``_trisweep_xla`` shift algebra, runs.

Not ported: the reference's VMEM cap (``_TRISWEEP_VMEM_BYTES``, 56 MB of
resident working set, which refuses Poisson 2048^2) and its ``r128``
padding of the planes to (8, 128) tiles. Both are walls of the TPU; the
H100 kernel keeps x in device memory. The ``rows < 128`` gate stays.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import on_cuda, require_device

__all__ = ["TrisweepPlan", "plan_trisweep", "trisweep", "trisweep_f64_bound"]

_U32 = 2.0 ** -24  # unit roundoff of float32


class TrisweepPlan:
    """Static plan: the DIA offsets of the strict part ``N`` and its band
    planes ``data`` ``(nb, rows)`` on ``device``, in the dtype of the host
    DIA data (float32 for the kernel)."""

    def __init__(self, offsets: tuple, data: np.ndarray, rows: int, *, device):
        self.offsets = tuple(int(o) for o in offsets)
        self.rows = int(rows)
        if data.shape != (len(self.offsets), self.rows):
            raise ValueError("trisweep plan: data must be (len(offsets), rows)")
        self.device = require_device(device)
        self.data = torch.from_numpy(np.ascontiguousarray(data)).to(self.device)
        self.offsets_t = torch.tensor(self.offsets, dtype=torch.int32, device=self.device)


def plan_trisweep(dia, rows: int, *, device):
    """A :class:`TrisweepPlan` from a ``DiaMatrix`` of the STRICT part N on
    ``device``, or None when the fused solve does not apply (``rows <
    128``, the reference's gate)."""
    if rows < 128:
        return None
    return TrisweepPlan(dia.offsets, np.asarray(dia.data), rows, device=device)


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
        from ..native.kernels import launch_trisweep

        y = torch.empty_like(b)
        launch_trisweep(plan.data, plan.offsets_t, b.contiguous(), dinv.contiguous(),
                        torch.empty_like(b), y, sweeps=sweeps)
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
