"""Traffic kind ``pagerank``: a caller ranking the vertices of one graph,
one whole PageRank after another, each waited for (GAP's ``pr`` kernel,
``pr_spmv.cc``'s ``PageRankPull``, run on one card).

Set-up plans the dispatched ``SpmvOperator`` of the graph's adjacency
(unit float32 values; no ``force``) and its degrees. A request is
``pagerank(op, degrees, damping, tol, maxiter)`` from uniform scores, the
operator inside the benchmark's range ``portbench.matvec`` when ranges are
on, so each pull reads there.

Cell parameters (``workloads/<cell>.json``, ``params``): ``damping``,
``tol``, ``maxiter`` (GAP's 0.85, 1e-4, 20); ``check_samples``,
``trace_requests``, ``warm_requests``: see ``harness.py``; ``control``:
the ``dtype`` in which the plain reference answers in the program's place.

Each sampled answer is compared with the plain reference
(``reference_pagerank.py``) in float64 on the same graph, with GAP's
stopping rule, held to ``limits``: ``iterations``, how far the answer's
count lies from the reference's; ``l1_error``, ``||s - s_ref||_1 /
||s_ref||_1``; ``hub_error``, the worst relative error over the ``HUBS``
vertices of highest degree, whose rows are the longest. A sound answer
runs the reference's count (the limit of ``iterations`` is 0), so the two
are compared after the same iterations; an answer that stops early or late
is compared with the reference's scores all the same.
"""

from __future__ import annotations

import json
import math
import sys

import numpy as np

from portbench import reference_pagerank as ref
from portbench.pagerank_work import pull_work
from portbench.roofline import csr_bytes
from portbench.tracing import ranged
from portbench.traffic.solve_loop import Answer

#: the vertices of highest degree whose scores ``hub_error`` reads
HUBS = 1024


def _finite(v: float) -> float:
    """``v``, or inf where it is not a number (so it fails every limit)."""
    return v if not math.isnan(v) else math.inf


class Traffic:
    def __init__(self, ctx):
        self.ctx = ctx
        self.p = ctx.params
        self._ranges = False

    # -- set-up --------------------------------------------------------------

    def setup(self):
        import sparse_matrix_tpu_torch.solvers.pagerank as pagerank
        from sparse_matrix_tpu_torch.formats.csr import CsrMatrix
        from sparse_matrix_tpu_torch.ops.operator import SpmvOperator

        ctx = self.ctx
        torch, dev, m = ctx.torch, ctx.device, ctx.matrix
        a = CsrMatrix(m.rows, m.cols, m.vals.astype(np.float32, copy=False), m.indices,
                      m.offsets, is_sorted=True)
        self.op = ctx.plan("operator", lambda: SpmvOperator(a, device=dev))
        self.degrees = ctx.plan("degrees", lambda: torch.diff(torch.from_numpy(m.offsets).to(dev)))
        self.pr = pagerank
        print(json.dumps({"operator": {"format": self.op.format,
                                       "bytes_per_apply": self.op.bytes_per_apply(),
                                       "csr_with_values_bytes": csr_bytes(m.rows, m.cols, m.nnz(),
                                                                          4)}}),
              file=sys.stderr, flush=True)

    def set_ranges(self, on: bool):
        self._ranges = bool(on)

    def _kw(self):
        return {k: self.p[k] for k in ("damping", "tol", "maxiter")}

    # -- requests ------------------------------------------------------------

    def request(self, i: int) -> Answer:
        op = ranged(self.op, "portbench.matvec") if self._ranges else self.op
        res = self.pr.pagerank(op, self.degrees, **self._kw())
        return Answer(res.scores, 0, int(res.iterations), False)

    def release(self):
        """Free the program's state; the sampled answers stay."""
        self.op = self.degrees = self.pr = None

    # -- comparison ----------------------------------------------------------

    def _graph(self):
        """The graph's offsets and columns on the device."""
        torch, m, dev = self.ctx.torch, self.ctx.matrix, self.ctx.device
        return (torch.from_numpy(m.offsets).to(dev),
                torch.from_numpy(np.ascontiguousarray(m.indices).view(np.int32)).to(dev))

    def _hubs(self):
        deg = np.diff(self.ctx.matrix.offsets)
        k = min(HUBS, deg.size)
        return self.ctx.torch.from_numpy(np.argpartition(-deg, k - 1)[:k]).to(self.ctx.device)

    def check(self, samples):
        """The worst of each comparison over the sampled answers, against
        the reference in float64."""
        torch = self.ctx.torch
        offsets, cols = self._graph()
        own = ref.pagerank(offsets, cols, dtype=torch.float64, **self._kw())
        s_ref, hubs = own.scores, self._hubs()
        worst = {"iterations": 0.0, "l1_error": 0.0, "hub_error": 0.0}
        for _i, ans in samples:
            s = ans.x.to(device=s_ref.device, dtype=torch.float64)
            got = {"iterations": float(abs(int(ans.iterations) - own.iterations)),
                   "l1_error": float((s - s_ref).abs().sum() / s_ref.abs().sum()),
                   "hub_error": float(((s[hubs] - s_ref[hubs]).abs() / s_ref[hubs].abs()).max())}
            for k, v in got.items():
                worst[k] = max(worst[k], _finite(v))
        lim = self.ctx.workload["limits"]
        return {k: {"value": v, "limit": float(lim[k])} for k, v in worst.items()}

    def control(self, count: int):
        """Answers of the plain reference in the control's dtype, put in
        the program's place, ``count`` of them (every request is the same
        ranking)."""
        torch = self.ctx.torch
        dtype = getattr(torch, self.ctx.workload["control"]["dtype"])
        offsets, cols = self._graph()
        res = ref.pagerank(offsets, cols, dtype=dtype, **self._kw())
        return [(j, Answer(res.scores, 0, res.iterations, False)) for j in range(count)]

    def work(self):
        """A pull's least work (``pagerank_work.pull_work``: no values) under
        the outer matvec's keys, which ``spmv_roofline.solve`` reads."""
        m = self.ctx.matrix
        nbytes, flops = pull_work(m.rows, m.nnz())
        return {"matvec_bytes": nbytes, "matvec_flops": flops}
