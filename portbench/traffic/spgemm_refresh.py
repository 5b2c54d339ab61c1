"""Traffic kind ``spgemm_refresh``: a caller re-multiplying a fixed
sparsity pattern with fresh values, ``C = A B`` with C left on the device,
waiting for each product.

``EscSpgemm(A, B, reduce=...)`` is planned once in set-up (``plan_s``).
Request i is ``multiply_device(lhs_vals=v, rhs_vals=v)``, the square of
the configuration's matrix, with v entry ``i % pool`` of a pool of value
vectors drawn once on the device from the seed (float32 standard normal,
CSR order).

Cell parameters: ``reduce``, ``pool``, ``check_samples``,
``trace_requests``, ``control`` (the plain product's ``dtype``). Each
sampled product is held, over C's whole pattern, to the float64 plain
product: ``limits.pattern`` (entries off the reference's pattern, 0) and
``limits.err_over_bound`` (the worst ``|c - c_ref| / ((n_ij + 2) u
(|A||B|)_ij)``, u the float32 unit roundoff).
"""

from __future__ import annotations

from typing import NamedTuple

from portbench import reference
from portbench.roofline import spgemm_refresh_work
from portbench.tracing import ranged


class Product(NamedTuple):
    row: object
    col: object
    val: object
    nnz: object
    j: int
    iterations: None = None
    failed: bool = False


class Traffic:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.params
        self._ranges = False
        self._c_nnz = None
        self._products = None

    def setup(self):
        import numpy as np
        from sparse_matrix_tpu_torch.formats.csr import CsrMatrix
        from sparse_matrix_tpu_torch.ops.device_sorted import EscSpgemm

        ctx = self.ctx
        m = ctx.matrix
        a = CsrMatrix(m.rows, m.cols, m.vals.astype(np.dtype(ctx.config["dtype"])), m.indices,
                      m.offsets,
                      is_sorted=True)
        self.eng = ctx.plan("esc_plan", lambda: EscSpgemm(a, a, device=ctx.device,
                                                          reduce=self.p["reduce"]))
        self._products = int(self.eng.num_products)
        self.pool = self._pool()

    def _given(self):
        import numpy as np

        return self.ctx.matrix.astype(np.dtype(self.ctx.config["dtype"]))

    def _pool(self):
        torch, ctx = self.ctx.torch, self.ctx
        return torch.randn((int(self.p["pool"]), ctx.matrix.nnz()), generator=ctx.generator(),
                           device=ctx.device, dtype=torch.float32)

    def set_ranges(self, on: bool):
        self._ranges = bool(on)

    def request(self, i: int) -> Product:
        j = i % int(self.p["pool"])
        v = self.pool[j]
        mult = self.eng.multiply_device
        if self._ranges:
            mult = ranged(mult, "portbench.multiply")
        c = mult(lhs_vals=v, rhs_vals=v)
        return Product(c.row, c.col, c.val, c.nnz, j)

    def release(self):
        self.eng = self.pool = None

    def _pattern(self):
        a = reference.upload(self._given(), self.ctx.device, self.ctx.torch.float64)
        return a, reference.product_pattern(a, a)

    def check(self, samples):
        a, pat = self._pattern()
        self._c_nnz = int(pat.keys.numel())
        pool = self._pool()
        off, worst = 0, 0.0
        for _i, c in samples:
            v = pool[c.j]
            ref, mag = reference.product_values(pat, v, v, self.ctx.torch.float64)
            o, e = reference.product_error(pat, c.row, c.col, c.val, int(c.nnz), ref, mag)
            off, worst = max(off, o), max(worst, e)
        lim = self.ctx.workload["limits"]
        return {"pattern": {"value": off, "limit": int(lim["pattern"])},
                "err_over_bound": {"value": worst, "limit": float(lim["err_over_bound"])}}

    def control(self, count: int):
        """Plain products in the control's dtype, in the program's place,
        for the first ``count`` pool entries."""
        torch = self.ctx.torch
        dtype = getattr(torch, self.ctx.workload["control"]["dtype"])
        a, pat = self._pattern()
        pool = self._pool()
        n = pat.keys.numel()
        row = (pat.keys // pat.cols).to(torch.int32)
        col = (pat.keys % pat.cols).to(torch.int32)
        out = []
        for j in range(min(count, pool.shape[0])):
            val, _ = reference.product_values(pat, pool[j], pool[j], dtype)
            out.append((j, Product(row, col, val, n, j)))
        return out

    def work(self):
        m = self.ctx.matrix
        nbytes, flops = spgemm_refresh_work(m.rows, m.cols, m.nnz(), self._c_nnz,
                                            self._products)
        return {"spgemm_bytes": nbytes, "spgemm_flops": flops}
