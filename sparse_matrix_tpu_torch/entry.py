"""``entry(device)``: one CG step through the aligned kernel.

Counterpart of ``__graft_entry__.entry()``: the aligned plan of the 4096-row
Poisson operator (n = 64) and a CG step (SpMV + axpys + dots) over it, with
the same seeded right-hand side. On a CUDA device the SpMV launches the
aligned kernel; on the CPU it runs the kernel's plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import require_device
from .formats.aligned import plan_aligned
from .ops.spmv import aligned_device_arrays, spmv_aligned
from .solvers.poisson import poisson_2d_csr

__all__ = ["entry"]


def entry(device):
    """Return ``(cg_step, example_args)``: ``cg_step(x, p, r, rs)`` performs
    one CG iteration and returns the new ``(x, p, r, rs)``; the example
    arguments are the CG start state for a seeded right-hand side."""
    dev = require_device(device)
    n = 64  # 4096-row Poisson operator
    a = poisson_2d_csr(n, dtype=np.float32)
    plan = plan_aligned(a)
    if plan.spill is not None:  # Poisson: the cost gate keeps everything aligned
        raise RuntimeError("the Poisson aligned plan unexpectedly spilled")
    arrs = aligned_device_arrays(plan, dev)

    def cg_step(x, p, r, rs):
        ap = spmv_aligned(plan, p, device_arrays=arrs)
        alpha = rs / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        return x, p, r, rs_new

    rng = np.random.default_rng(0)
    bvec = torch.from_numpy(rng.standard_normal(a.rows).astype(np.float32)).to(dev)
    x0 = torch.zeros(a.rows, dtype=torch.float32, device=dev)
    rs0 = torch.dot(bvec, bvec)
    return cg_step, (x0, bvec, bvec, rs0)
