"""Smoothed-aggregation algebraic multigrid (AMG) preconditioner.

Counterpart of ``sparse_matrix_tpu/solvers/amg.py``:

* **Setup on the host**, once per operator: strength graph, greedy
  aggregation, tentative prolongator, one damped-Jacobi smoothing step of
  it and the Galerkin products ``P^T A P``. The sweeps run in the port's
  host library (``native/src/spmx_host.cpp`` through ``native/host.py``,
  copied from the reference's native runtime) and the products through
  :func:`~..ops.spgemm_block.spgemm_auto` (its host engine is the same
  library's hash engine), so every level's aggregates, prolongator,
  operator, inverse diagonal and Gershgorin bound equal the reference's
  bit for bit. The numpy and Python versions below (:func:`_strength_numpy`,
  :func:`_aggregate_pass_python`, :func:`_jacobi_smoother_numpy`,
  :func:`_scale_rows_numpy`, :func:`_colmap_smoothed_python`) are the
  plain versions the tests hold the library to; each has the signature of
  the binding it stands for, and nothing falls back to them.
* **The V-cycle on the device**: every level's ``A``, ``P`` and ``P^T`` is
  a planned :class:`~..ops.operator.SpmvOperator` (automatic format
  dispatch, the reference's formats), symmetric smoothing (weighted Jacobi
  or Chebyshev, identical pre and post), restriction by ``P^T``, and the
  coarsest solve one dense ``coarse_inv @ r`` (a float64 pseudo-inverse
  from the host, cast to ``dtype``; one FP32 ``torch.matmul``, refused while
  TF32 matmuls are allowed, ROADMAP.md C5). :meth:`AmgHierarchy.vcycle`
  runs eagerly: each level's applies and vector updates are launched from
  Python. The ``M^-1`` of :meth:`AmgHierarchy.preconditioner` replays that
  V-cycle as one CUDA graph on a residual vector on the card (captured at
  its first such call), so PCG's host launches one graph an iteration
  instead of its ~100 small kernels; PCG reads one scalar to the host an
  iteration.
* **Geometric hierarchies** (``solvers/hpcg.py``): an :class:`AmgHierarchy`
  may also be built from levels made elsewhere. Its smoother ``"symgs"``
  runs multicolour symmetric Gauss-Seidel (``ops/symgs.py``) on levels
  that carry a :class:`~..ops.symgs.SymgsPlan`, and its coarsest level may
  be smoothed from zero (``coarse_level``) instead of solved by
  ``coarse_inv``.

Not ported: ``AmgHierarchy.as_pytree``, ``vcycle_p`` and ``_smooth_p`` (jit
arguments; the port runs eagerly).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..formats.csr import CsrMatrix
from ..native import host, kernels
from ..utils.profiling import span

__all__ = [
    "AmgHierarchy",
    "AmgLevel",
    "aggregate_strong",
    "amg_coarsen",
    "save_amg_coarsening",
    "load_amg_coarsening",
    "amg_preconditioner",
    "amg_pcg_solve",
    "amg_setup",
    "strength_graph",
    "tentative_prolongator",
]


# -- setup: strength, aggregation, prolongator (host) ------------------------


def strength_graph(a, theta: float = 0.08) -> Tuple[np.ndarray, np.ndarray]:
    """Strength-of-connection graph of a CSR matrix: edge (i, j), i != j,
    is strong when ``|a_ij| >= theta * sqrt(|a_ii| * |a_jj|)`` (a zero or
    missing diagonal replaced by the row's largest magnitude, or 1).
    Returns the strong adjacency in CSR form ``(offsets, indices)``, int64.
    Runs in the host library; a matrix with magnitudes past 1e150 (whose
    squared comparisons would overflow) takes the numpy sweep, as in the
    reference."""
    res = host.amg_strength_native(a.rows, a.offsets, a.indices, a.vals, theta)
    if res is not None:
        return res[2], res[3]
    so, si = _strength_numpy(a.rows, a.offsets, a.indices, a.vals, theta)[2:]
    return so, si


def _diag_of(a) -> np.ndarray:
    rids = a.row_ids().astype(np.int64)
    on_diag = a.indices.astype(np.int64) == rids
    d = np.zeros(a.rows, dtype=np.float64)
    d[rids[on_diag]] = a.vals[on_diag].astype(np.float64)
    return d


def _lambda_max_dinv_a(a, dinv: np.ndarray) -> float:
    """Gershgorin upper bound on rho(D^-1 A): max_i sum_j |a_ij| / |a_ii|
    (the plain form of the bound :func:`amg_coarsen` takes from the host
    library's absolute row sums)."""
    rids = a.row_ids().astype(np.int64)
    s = np.bincount(rids, weights=np.abs(a.vals.astype(np.float64)), minlength=a.rows)
    return float(np.max(s * np.abs(dinv))) if a.nnz() else 1.0


def _strength_numpy(rows, offsets, indices, vals, theta: float):
    """Plain version of :func:`~..native.host.amg_strength_native` (same
    signature and result): the reference's numpy strength sweep, the signed
    diagonal of :func:`_diag_of` and the absolute row sums of
    :func:`_lambda_max_dinv_a`."""
    a = CsrMatrix(rows, rows, vals, indices, offsets, is_sorted=False)
    n = a.rows
    rids = a.row_ids().astype(np.int64)
    cids = a.indices.astype(np.int64)
    absv = np.abs(a.vals.astype(np.float64))
    diag = np.zeros(n, dtype=np.float64)
    on_diag = cids == rids
    diag[rids[on_diag]] = absv[on_diag]
    # rows with a zero or missing diagonal: the row max keeps the threshold
    # meaningful instead of dividing by zero
    missing = diag == 0.0
    if missing.any():
        rowmax = np.zeros(n, dtype=np.float64)
        np.maximum.at(rowmax, rids, absv)
        diag[missing] = np.where(rowmax[missing] > 0, rowmax[missing], 1.0)
    keep = (~on_diag) & (absv >= theta * np.sqrt(diag[rids] * diag[cids]))
    offs = np.zeros(n + 1, dtype=np.int64)
    offs[1:] = np.bincount(rids[keep], minlength=n)
    np.cumsum(offs, out=offs)
    abssum = np.bincount(rids, weights=absv, minlength=n)
    return _diag_of(a), abssum, offs, cids[keep]


def aggregate_strong(n: int, s_offsets: np.ndarray, s_indices: np.ndarray
                     ) -> Tuple[np.ndarray, int]:
    """Greedy smoothed-aggregation node clustering, in the host library.

    Pass 1: a node whose strong neighbourhood is entirely unaggregated seeds
    a new aggregate of itself and its strong neighbours (natural order).
    Pass 2: leftover nodes attach to the smallest adjacent pass-1
    aggregate. Pass 3: remaining nodes and their free neighbours form
    their own aggregates; isolated nodes become singletons. Returns
    ``(agg_id[n], n_agg)`` with every node assigned."""
    agg = np.full(n, -1, dtype=np.int64)
    na = host.aggregate_pass_native(1, s_offsets, s_indices, agg)
    if (agg < 0).any():
        host.aggregate_pass_native(2, s_offsets, s_indices, agg)
    if (agg < 0).any():
        na = host.aggregate_pass_native(3, s_offsets, s_indices, agg, na)
    return agg, na


def _aggregate_pass_python(which: int, so, si, agg, na: int = 0) -> int:
    """Plain version of :func:`~..native.host.aggregate_pass_native` (same
    signature and result): the reference's Python loops for passes 1 and 3
    and its vectorized pass 2 (every decision reads the pass-1 state)."""
    n = len(agg)
    if which == 1:
        na = 0
        for i in range(n):
            if agg[i] >= 0:
                continue
            nb = si[so[i]:so[i + 1]]
            if nb.size and (agg[nb] >= 0).any():
                continue
            agg[nb] = na
            agg[i] = na
            na += 1
        return na
    if which == 2:
        un = agg < 0
        deg = np.diff(so)
        edge_src = np.repeat(np.arange(n, dtype=np.int64), deg)
        emask = un[edge_src] & (agg[si] >= 0)
        if not emask.any():
            return 0
        src, tgt_agg = edge_src[emask], agg[si[emask]]
        # deterministic pick: the smallest adjacent aggregate id
        choice = np.full(n, np.iinfo(np.int64).max, dtype=np.int64)
        np.minimum.at(choice, src, tgt_agg)
        attach = choice < np.iinfo(np.int64).max
        agg[attach] = choice[attach]
        return int(attach.sum())
    for i in np.flatnonzero(agg < 0):
        if agg[i] >= 0:
            continue
        nb = si[so[i]:so[i + 1]]
        grp = nb[agg[nb] < 0] if nb.size else nb
        agg[i] = na
        if grp.size:
            agg[grp] = na
        na += 1
    return na


def tentative_prolongator(agg: np.ndarray, n_agg: int, *, dtype=np.float64) -> CsrMatrix:
    """Piecewise-constant tentative prolongator ``P0`` (n x n_agg): column j
    is the indicator of aggregate j normalized to unit 2-norm, so
    ``P0^T P0 = I``."""
    n = agg.shape[0]
    counts = np.bincount(agg, minlength=n_agg).astype(np.float64)
    v = (1.0 / np.sqrt(counts[agg])).astype(dtype)
    # one entry per row, rows in order: built directly
    return CsrMatrix(n, int(n_agg), v, agg.astype(np.uint32),
                     np.arange(n + 1, dtype=np.int64), is_sorted=True)


def _jacobi_smoother_numpy(rows, offsets, indices, vals, ws):
    """Plain version of :func:`~..native.host.jacobi_smoother_native` (same
    signature and result): float64 ``-vals * ws[row]`` plus 1 at the
    diagonal, rounded once; False when a row has no explicit diagonal."""
    a = CsrMatrix(rows, rows, vals, indices, offsets, is_sorted=False)
    rids = a.row_ids()
    on_diag = a.indices.astype(np.int64) == rids
    if int(on_diag.sum()) != a.rows:
        return False
    v64 = -a.vals.astype(np.float64) * np.asarray(ws, np.float64)[rids]
    v64[on_diag] += 1.0
    return v64.astype(a.vals.dtype)


def _jacobi_smoother_matrix(a, ws: np.ndarray):
    """``S = I - diag(ws) @ A`` on A's pattern (host CSR sharing A's index
    arrays), or None when a row of A has no explicit diagonal."""
    vals = host.jacobi_smoother_native(a.rows, a.offsets, a.indices, a.vals,
                                       np.asarray(ws, np.float64))
    if vals is False:
        return None
    return CsrMatrix(a.rows, a.cols, vals, a.indices, a.offsets, is_sorted=a.is_sorted)


def _scale_rows_numpy(rows, offsets, vals, s) -> np.ndarray:
    """Plain version of :func:`~..native.host.scale_rows_native`."""
    rids = np.repeat(np.arange(rows, dtype=np.int64), np.diff(offsets))
    return (vals.astype(np.float64) * np.asarray(s, np.float64)[rids]).astype(vals.dtype)


def _scale_rows(a, s: np.ndarray) -> CsrMatrix:
    """Row-scaled copy ``diag(s) @ A`` (host CSR)."""
    vals = host.scale_rows_native(a.rows, a.offsets, a.vals, np.asarray(s, np.float64))
    return CsrMatrix(a.rows, a.cols, vals, a.indices.copy(), a.offsets.copy(),
                     is_sorted=a.is_sorted)


def _colmap_smoothed_python(a, ws, rhs):
    """Plain version of :func:`~..native.host.colmap_smoothed_native` (same
    signature and None rule), the reference's unfused route: the smoother
    matrix of :func:`_jacobi_smoother_numpy`, then the dict-loop product,
    column-sorted; a row without an explicit diagonal adds the identity's
    row of ``rhs`` as the library does."""
    from ..ops.spgemm_host import _spgemm_hash_python

    dtype = np.result_type(a.vals.dtype, rhs.vals.dtype)
    if (np.dtype(dtype) not in (np.dtype(np.float32), np.dtype(np.float64))
            or a.rows != a.cols or a.cols != rhs.rows
            or np.diff(rhs.offsets).max(initial=0) > 1):
        return None
    a = CsrMatrix(a.rows, a.cols, a.vals.astype(dtype), a.indices, a.offsets,
                  is_sorted=a.is_sorted)
    vals = _jacobi_smoother_numpy(a.rows, a.offsets, a.indices, a.vals, ws)
    if vals is False:
        # the identity's term of a row without a diagonal: an explicit 1
        # appended at the row's end, where the library adds it
        rids = a.row_ids()
        has = np.zeros(a.rows, dtype=bool)
        has[rids[a.indices.astype(np.int64) == rids]] = True
        extra = np.flatnonzero(~has)
        s64 = -a.vals.astype(np.float64) * np.asarray(ws, np.float64)[rids]
        s64[a.indices.astype(np.int64) == rids] += 1.0
        r = np.concatenate([rids, extra])
        c = np.concatenate([a.indices.astype(np.int64), extra])
        v = np.concatenate([s64.astype(dtype), np.ones(len(extra), dtype)])
        order = np.argsort(r, kind="stable")
        offsets = np.zeros(a.rows + 1, dtype=np.int64)
        np.cumsum(np.bincount(r, minlength=a.rows), out=offsets[1:])
        s_mat = CsrMatrix(a.rows, a.cols, v[order], c[order], offsets, is_sorted=False)
    else:
        s_mat = CsrMatrix(a.rows, a.cols, vals, a.indices, a.offsets, is_sorted=a.is_sorted)
    return _spgemm_hash_python(s_mat, rhs, output_sorted=True)


# -- the hierarchy (device) ----------------------------------------------------


def _apply(op, v):
    """A planned SpmvOperator on a vector (SpMV) or an (n, K) block (its
    ``matmat``: the SpMM kernels)."""
    return op(v) if v.dim() == 1 else op.matmat(v)


def _refuse_tf32(device: torch.device) -> None:
    """The coarse solve runs in FP32: raise while TF32 matmuls are allowed
    on a card (ROADMAP.md C5)."""
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the AMG coarse solve runs in FP32: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


def _coarse_solve(coarse_inv: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """``coarse_inv @ r`` in FP32 (:func:`_refuse_tf32`)."""
    _refuse_tf32(coarse_inv.device)
    return coarse_inv @ r


class _CapturedVcycle(NamedTuple):
    """One V-cycle of a hierarchy captured as a CUDA graph: ``graph``
    replays ``vcycle(static_in)`` into ``static_out``; ``key`` is what the
    capture read (:meth:`AmgHierarchy._graph_key`); ``launches`` the
    kernel launches a replay runs, by ``kernels.launch_counts`` key."""

    key: tuple
    graph: "torch.cuda.CUDAGraph"
    static_in: torch.Tensor
    static_out: torch.Tensor
    launches: Dict[str, int]


def _capture_vcycle(hier: "AmgHierarchy", r: torch.Tensor, key: tuple) -> _CapturedVcycle:
    """Capture ``hier.vcycle`` on a copy of ``r`` by ``torch.cuda.graphs``'
    rules: one eager V-cycle on a side stream first (it makes any launch
    record not yet made, and cuBLAS's state for the coarse product), then
    the capture. Every kernel of the V-cycle enqueues on PyTorch's current
    stream, which the capture swaps for its own, and allocates through
    PyTorch's allocator; nothing on its path reads the device, so the
    graph holds exactly the eager kernels in their order. The launches
    counted during the capture ran nothing: they are taken back, kept in
    ``launches``, and counted again by each replay."""
    with torch.cuda.device(r.device):
        static_in = r.clone(memory_format=torch.contiguous_format)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            hier.vcycle(static_in)
        torch.cuda.current_stream().wait_stream(side)
        before = dict(kernels.launch_counts)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            static_out = hier.vcycle(static_in)
    launches = {k: v - before[k] for k, v in kernels.launch_counts.items() if v != before[k]}
    for k, v in launches.items():
        kernels.launch_counts[k] -= v
    return _CapturedVcycle(key, graph, static_in, static_out, launches)


class AmgLevel(NamedTuple):
    a_op: Callable  # SpmvOperator for A_l
    p_op: Callable  # SpmvOperator for P_l  (n_l x n_{l+1}); None on a coarse_level
    pt_op: Callable  # SpmvOperator for P_l^T; None on a coarse_level
    dinv: torch.Tensor  # (n_l,) inverse diagonal, on the level's device; None for "symgs"
    lam: float  # Gershgorin bound on rho(D^-1 A_l) (Chebyshev smoother); None for "symgs"
    n: int
    nnz: int
    symgs: Optional[object] = None  # the level's SymgsPlan (smoother "symgs")


class AmgHierarchy:
    """Multigrid hierarchy on one device; :meth:`vcycle` applies ``M^-1``.

    The coarsest solve is ``coarse_inv @ r`` (a dense inverse) or, with
    ``coarse_inv`` None, ``nu`` smoothing steps from zero on
    ``coarse_level`` (HPCG's coarsest level). The smoother ``"symgs"``
    needs a :class:`~..ops.symgs.SymgsPlan` on every level it smooths, and
    reads no ``dinv``, ``lam``, ``omega`` or ``cheb_degree``; Jacobi
    (``omega``) and Chebyshev (``cheb_degree``, ``lam``) need ``dinv``."""

    def __init__(self, levels: List[AmgLevel], coarse_inv: Optional[torch.Tensor], *,
                 smoother: str, nu: int, omega: Optional[float] = None,
                 cheb_degree: Optional[int] = None, outer_a_op=None,
                 coarse_level: Optional[AmgLevel] = None):
        if (coarse_inv is None) == (coarse_level is None):
            raise ValueError("AmgHierarchy: give the coarse solve, coarse_inv or coarse_level")
        smoothed = levels + ([coarse_level] if coarse_level is not None else [])
        need = "symgs" if smoother == "symgs" else "dinv"
        if any(getattr(lv, need) is None for lv in smoothed):
            raise ValueError(f"AmgHierarchy: the smoother {smoother!r} needs "
                             f"{'a SymgsPlan' if need == 'symgs' else 'dinv'} on every level")
        self.levels = levels
        self.coarse_inv = coarse_inv  # (nc, nc) dense inverse, on the device, or None
        self.coarse_level = coarse_level
        held = coarse_inv if coarse_inv is not None else coarse_level.a_op
        self.device = held.device
        self.dtype = held.dtype
        self.smoother = smoother
        self.nu = nu
        self.omega = omega
        self.cheb_degree = cheb_degree
        # full-precision finest-level operator for the outer Krylov matvec
        # when the hierarchy itself runs half-width value planes
        self.outer_a_op = outer_a_op
        # omega rounded to the working dtype times dinv, in that order: the
        # reference's ``w * dinv`` of every Jacobi sweep, made once
        self._smoothed = smoothed
        self._wdinv = [torch.tensor(omega, dtype=lv.dinv.dtype, device=lv.dinv.device)
                       * lv.dinv for lv in smoothed] if smoother == "jacobi" else None
        self._spans = [f"spmx.amg.level{i}" for i in range(len(levels))]
        # rows of the finest level
        self._rows = smoothed[0].n if smoothed else coarse_inv.shape[0]
        self._graph: Optional[_CapturedVcycle] = None

    def _smooth(self, level: int, x, r):
        """nu sweeps toward ``A x = r`` starting from ``x`` (level
        ``len(levels)`` is the ``coarse_level``); Jacobi and Chebyshev
        broadcast over (n, K) residual blocks. ``"symgs"`` takes vectors
        and updates ``x`` in place (the V-cycle passes tensors of its own),
        each step the span ``spmx.amg.symgs``."""
        lv = self._smoothed[level]
        if self.smoother == "symgs":
            for _ in range(self.nu):
                with span("spmx.amg.symgs"):
                    x = lv.symgs.step(x, r)
            return x
        if self.smoother == "chebyshev":
            return _chebyshev_apply(lv, x, r, degree=self.cheb_degree, lam_max=lv.lam)
        wdinv = self._wdinv[level] if r.dim() == 1 else self._wdinv[level][:, None]
        for _ in range(self.nu):
            x = x + wdinv * (r - _apply(lv.a_op, x))
        return x

    def vcycle(self, r: torch.Tensor, level: int = 0) -> torch.Tensor:
        """One V-cycle applied to a residual: returns ``M^-1 r``. ``r`` may
        be a vector (n,) or a column block (n, K), which runs every level
        through the SpMM path. Each level's work, the levels below it
        included, is the span ``spmx.amg.level<l>``; the coarse solve is
        ``spmx.amg.coarse``."""
        if level == len(self.levels):
            with span("spmx.amg.coarse"):
                if self.coarse_inv is None:
                    return self._smooth(level, torch.zeros_like(r), r)
                return _coarse_solve(self.coarse_inv, r)
        with span(self._spans[level]):
            lv = self.levels[level]
            x = self._smooth(level, torch.zeros_like(r), r)
            d = r - _apply(lv.a_op, x)
            ec = self.vcycle(_apply(lv.pt_op, d), level + 1)
            x = x + _apply(lv.p_op, ec)
            return self._smooth(level, x, r)

    def preconditioner(self) -> Callable:
        """``M^-1`` for PCG (:meth:`_m_inv`)."""
        return self._m_inv

    def _m_inv(self, r: torch.Tensor) -> torch.Tensor:
        """``M^-1 r``: a residual vector on the hierarchy's CUDA device, of
        the finest level's size and dtype, replays the V-cycle as one CUDA
        graph (:meth:`_replay`); any other input (a CPU tensor, an (n, K)
        block, another shape) runs the eager :meth:`vcycle`. Either way
        the caller gets a tensor of its own."""
        if (r.is_cuda and r.dim() == 1 and r.shape[0] == self._rows and r.dtype == self.dtype
                and r.device == self.device):
            return self._replay(r)
        return self.vcycle(r)

    def _graph_key(self) -> tuple:
        """What a captured V-cycle read of the hierarchy's attributes: a
        change to any of it recaptures. (The input's shape, dtype and
        device are the hierarchy's on every replay; ``omega`` is fixed when
        the hierarchy is built, in ``_wdinv``.)"""
        return (self.smoother, self.nu, self.cheb_degree)

    def _replay(self, r: torch.Tensor) -> torch.Tensor:
        """One V-cycle by replaying the graph captured at the first call
        with this key (the span ``spmx.amg.graph``): ``r`` copied in, the
        graph launched, its output cloned, all on the current stream. Each
        replay adds the graph's kernel launches to ``kernels.launch_counts``."""
        _refuse_tf32(self.device)
        key = self._graph_key()
        if self._graph is None or self._graph.key != key:
            self._graph = None  # the old graph's memory goes back before the capture
            self._graph = _capture_vcycle(self, r, key)
        g = self._graph
        with span("spmx.amg.graph"):
            g.static_in.copy_(r)
            g.graph.replay()
            out = g.static_out.clone()
        for k, v in g.launches.items():
            kernels.launch_counts[k] += v
        return out

    def __repr__(self) -> str:  # pragma: no cover
        rows = ", ".join(f"{lv.n}({lv.nnz}nnz)" for lv in self.levels)
        coarse = (f"coarse {self.coarse_inv.shape[0]}" if self.coarse_inv is not None
                  else f"smoothed coarse {self.coarse_level.n}")
        return f"AmgHierarchy[{rows} -> {coarse}; {self.smoother} nu={self.nu}]"


def _chebyshev_apply(lv: AmgLevel, x, r, *, degree: int, lam_max: float):
    """Fixed-degree Chebyshev smoother on ``[lam_max/30, 1.1*lam_max]`` of
    ``D^-1 A`` (preconditioned Chebyshev iteration): a fixed polynomial in
    ``D^-1 A``, applied identically pre and post, hence symmetric."""
    hi = 1.1 * lam_max
    lo = lam_max / 30.0
    d = (hi + lo) / 2.0
    c = (hi - lo) / 2.0
    dinv = lv.dinv if r.dim() == 1 else lv.dinv[:, None]
    res = r - _apply(lv.a_op, x)
    p = None
    alpha = 0.0
    for i in range(degree):
        z = dinv * res
        if i == 0:
            p = z
            alpha = 1.0 / d
        else:
            beta = (c * alpha / 2.0) ** 2
            alpha = 1.0 / (d - beta / alpha)
            p = z + beta * p
        x = x + alpha * p
        if i + 1 < degree:
            res = r - _apply(lv.a_op, x)
    return x


class _Phases:
    """The set-up's phases: ``with phase(level, name) as info:`` runs a
    phase in the span ``spmx.plan.amg.<name>`` and, where it ends, calls
    ``on_phase(level, name, **info)``, so span and callback mark the same
    points."""

    def __init__(self, on_phase: Optional[Callable]):
        self.on_phase = on_phase

    @contextlib.contextmanager
    def __call__(self, level: int, name: str):
        info = {}
        with span("spmx.plan.amg." + name):
            yield info
        if self.on_phase is not None:
            self.on_phase(level, name, **info)


def amg_setup(
    a,
    *,
    device="cuda",
    theta: float = 0.08,
    smooth_prolongator: bool = True,
    max_levels: int = 12,
    coarse_size: int = 400,
    dtype=torch.float32,
    smoother: str = "jacobi",
    nu: int = 1,
    omega: float = 2.0 / 3.0,
    cheb_degree: int = 3,
    operator_force: Optional[str] = None,
    verbose: bool = False,
    coarsening=None,
    values_dtype=None,
    on_phase: Optional[Callable] = None,
) -> AmgHierarchy:
    """Build a smoothed-aggregation hierarchy for a symmetric M-matrix-like
    host ``CsrMatrix`` on ``device``.

    The host coarsening is :func:`amg_coarsen` (or ``coarsening``, a saved
    one from :func:`load_amg_coarsening`). Each level's ``A``, ``P`` and
    ``P^T`` is planned as a :class:`~..ops.operator.SpmvOperator` of
    ``dtype`` (automatic format; ``operator_force`` pins one).
    ``values_dtype=torch.bfloat16`` stores half-width value planes where
    the chosen format takes them (DIA, BELL) and plans the other operators
    in ``dtype`` (only their ``ValueError`` is caught: a float64 ``dtype``
    on the card raises its ``TypeError``), with a full-precision finest
    operator for the outer Krylov matvec (``outer_a_op``). ``on_phase``,
    a callable, is called at the end of each setup phase (the caller
    times them): :func:`amg_coarsen`'s, then ``on_phase(level, "plan",
    n=, nnz=, formats=)`` once a level's three operators are on the
    device, ``on_phase(levels, "pinv", coarse_n=)`` after the coarse
    pseudo-inverse and ``on_phase(levels, "upload")`` once it is on the
    device. Each phase is also the span ``spmx.plan.amg.<phase>``.
    """
    from ..device import require_device
    from ..ops.operator import _NP_DTYPES, SpmvOperator

    dev = require_device(device)
    if a.rows != a.cols:
        raise ValueError("AMG requires a square operator")
    _refuse_tf32(dev)
    np_dtype = _NP_DTYPES[dtype]
    phase = _Phases(on_phase)
    if coarsening is not None:
        host_levels, cur = coarsening
    else:
        host_levels, cur = amg_coarsen(a, theta=theta, smooth_prolongator=smooth_prolongator,
                                       max_levels=max_levels, coarse_size=coarse_size,
                                       device=dev, on_phase=on_phase)

    def _op(mat):
        # half-width planes where the format takes them; the V-cycle is a
        # preconditioner, so the other operators run full width
        if values_dtype is not None:
            try:
                return SpmvOperator(mat, device=dev, dtype=dtype, force=operator_force,
                                    values_dtype=values_dtype)
            except ValueError:
                pass
        return SpmvOperator(mat, device=dev, dtype=dtype, force=operator_force)

    levels: List[AmgLevel] = []
    for li, (cur_l, p, dinv, lam) in enumerate(host_levels):
        with phase(li, "plan") as info:
            ops = (_op(cur_l), _op(p), _op(p.transpose()))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            info.update(n=cur_l.rows, nnz=cur_l.nnz(), formats=tuple(op.format for op in ops))
        levels.append(AmgLevel(a_op=ops[0], p_op=ops[1], pt_op=ops[2],
                               dinv=torch.from_numpy(dinv.astype(np_dtype)).to(dev),
                               lam=lam, n=cur_l.rows, nnz=cur_l.nnz()))
        if verbose:  # pragma: no cover
            print(f"amg level {li}: n={cur_l.rows} nnz={cur_l.nnz()} (P nnz={p.nnz()}), "
                  f"fmt={ops[0].format}/{ops[1].format}/{ops[2].format}")

    with phase(len(levels), "pinv") as info:
        pinv = np.linalg.pinv(cur.to_dense().astype(np.float64)).astype(np_dtype)
        info["coarse_n"] = cur.rows
    with phase(len(levels), "upload"):
        coarse_inv = torch.from_numpy(pinv).to(dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    outer = None
    if values_dtype is not None and host_levels:
        # the full-precision finest operator for the outer Krylov matvec
        outer = SpmvOperator(host_levels[0][0], device=dev, dtype=dtype, force=operator_force)
    return AmgHierarchy(levels, coarse_inv, smoother=smoother, nu=nu, omega=omega,
                        cheb_degree=cheb_degree, outer_a_op=outer)


def amg_coarsen(a, *, theta: float = 0.08, smooth_prolongator: bool = True,
                max_levels: int = 12, coarse_size: int = 400, device=None,
                on_phase: Optional[Callable] = None):
    """The host coarsening loop: ``(levels, coarse)``, each level
    ``(A_l, P_l, dinv_l, lam_l)`` (host CSRs and numpy) and ``coarse`` the
    last operator, for a dense direct solve.

    Per level: strength graph and greedy aggregation, the normalized
    tentative ``P0``, then (``smooth_prolongator``) one damped-Jacobi step
    ``P = (I - omega_p D^-1 A) P0``, ``omega_p = 4/3 / lambda_max``, in one
    fused pass, and the Galerkin ``A_c = P^T A P`` through ``spgemm_auto``
    on ``device`` (``None``: the default device). It stops at
    ``coarse_size`` rows, ``max_levels`` levels, a level more than 10 %
    dense (at most 20,000 rows), or an aggregation that merges nothing.
    ``on_phase``, a callable, is called at the end of each phase of a
    level (the caller times them): ``on_phase(level, "strength_aggregate")``,
    ``on_phase(level, "smooth", p_nnz=)`` and, for each Galerkin product,
    ``on_phase(level, "galerkin", engine=, products=)``. Each phase is
    also the span ``spmx.plan.amg.<phase>``.
    """
    phase = _Phases(on_phase)
    levels = []
    cur = a
    while cur.rows > coarse_size and len(levels) < max_levels:
        # the density stop rule: Galerkin operators densify as they shrink,
        # and past 10 % a direct coarse solve is cheaper than more products
        if cur.nnz() > 0.1 * cur.rows * cur.rows and cur.rows <= 20_000:
            break
        level = len(levels)
        with phase(level, "strength_aggregate"):
            res = host.amg_strength_native(cur.rows, cur.offsets, cur.indices, cur.vals, theta)
            if res is None:
                res = _strength_numpy(cur.rows, cur.offsets, cur.indices, cur.vals, theta)
            dvec, abssum, so, si = res
            agg, n_agg = aggregate_strong(cur.rows, so, si)
        if n_agg >= cur.rows:  # no coarsening possible (e.g. diagonal A)
            break
        with phase(level, "smooth") as info:
            # P in A's value dtype, so every product stays on one engine
            p = tentative_prolongator(agg, n_agg, dtype=cur.vals.dtype)
            dinv = np.where(dvec != 0.0, 1.0 / np.where(dvec == 0.0, 1.0, dvec), 1.0)
            lam = float(np.max(abssum * np.abs(dinv))) if cur.nnz() else 1.0
            if smooth_prolongator:
                p = _smoothed_prolongator(cur, p, (4.0 / 3.0) / lam * dinv, device)
            info["p_nnz"] = p.nnz()
        levels.append((cur, p, dinv, lam))
        cur = _galerkin(p, cur, device, phase, level)
    return levels, cur


def _smoothed_prolongator(a, p0, ws: np.ndarray, device) -> CsrMatrix:
    """``(I - diag(ws) A) P0`` in one fused host pass where the library
    takes it, else through ``spgemm_auto``."""
    fused = host.colmap_smoothed_native(a, ws, p0)
    if fused is not None:
        return fused
    from ..ops.spgemm_block import spgemm_auto

    s_mat = _jacobi_smoother_matrix(a, ws)
    if s_mat is not None:
        return spgemm_auto(s_mat, p0, output_sorted=True, device=device)
    # rows without an explicit diagonal: the identity widens the pattern,
    # so subtract by union merge
    return p0 - spgemm_auto(_scale_rows(a, ws), p0, output_sorted=False, device=device)


def _galerkin(p, a, device, phase: _Phases, level: int):
    """Coarse operator ``P^T A P`` through ``spgemm_auto``, the last product
    sorted (level operators feed format planners that expect sorted CSR).
    Each product is one ``galerkin`` phase of level ``level``, with its
    engine and scalar products."""
    from ..ops.spgemm_block import spgemm_auto_with_engine

    def run(lhs, rhs, output_sorted):
        with phase(level, "galerkin") as info:
            out, engine = spgemm_auto_with_engine(lhs, rhs, output_sorted=output_sorted,
                                                  device=device)
            if phase.on_phase is not None:
                info.update(engine=engine,
                            products=int(host.flops_per_row_native(lhs, rhs).sum()))
        return out

    ap = run(a, p, False)
    return run(p.transpose(), ap, True)


def amg_preconditioner(a, **kw) -> Callable:
    """Setup and the ``M^-1`` closure for
    :func:`~sparse_matrix_tpu_torch.solvers.cg.pcg_solve`."""
    return amg_setup(a, **kw).preconditioner()


def amg_pcg_solve(a, b: torch.Tensor, *, tol: float = 1e-6, maxiter: int = 200,
                  hierarchy: Optional[AmgHierarchy] = None, **setup_kw):
    """PCG with an AMG V-cycle preconditioner, end to end.

    ``hierarchy`` reuses a prior :func:`amg_setup` (setup once, solve many);
    otherwise ``setup_kw`` go to :func:`amg_setup` (``device`` among them,
    default ``"cuda"``). ``b`` must lie on the hierarchy's device. A 2-D
    ``b`` (n, K) solves all K systems in one lockstep block PCG
    (:func:`~.cg.pcg_solve_multi` over the finest operator's ``matmat``),
    each iteration one block V-cycle and one SpMM over all columns."""
    from .cg import pcg_solve, pcg_solve_multi

    hier = hierarchy if hierarchy is not None else amg_setup(a, **setup_kw)
    if hier.outer_a_op is not None:
        op = hier.outer_a_op
    elif hier.levels:
        op = hier.levels[0].a_op
    else:
        # degenerate: the whole problem fit on the coarse level
        from ..ops.operator import SpmvOperator

        op = SpmvOperator(a, device=hier.device, dtype=hier.dtype)
    if b.dim() == 2:
        return pcg_solve_multi(op.matmat, b, hier.preconditioner(), tol=tol, maxiter=maxiter)
    return pcg_solve(op, b, hier.preconditioner(), tol=tol, maxiter=maxiter)


def save_amg_coarsening(path, levels, coarse) -> None:
    """Persist an :func:`amg_coarsen` result as npz, in the reference's
    layout: a later process skips strength, aggregation and every Galerkin
    product and only plans the device operators."""
    payload = {"n_levels": np.int64(len(levels))}

    def put(prefix, m):
        payload[prefix + "vals"] = m.vals
        payload[prefix + "indices"] = m.indices
        payload[prefix + "offsets"] = m.offsets
        payload[prefix + "shape"] = np.array([m.rows, m.cols], np.int64)

    for i, (a_l, p_l, dinv, lam) in enumerate(levels):
        put(f"l{i}_a_", a_l)
        put(f"l{i}_p_", p_l)
        payload[f"l{i}_dinv"] = dinv
        payload[f"l{i}_lam"] = np.float64(lam)
    put("coarse_", coarse)
    np.savez(path, **payload)


def load_amg_coarsening(path):
    """Inverse of :func:`save_amg_coarsening`: ``(levels, coarse)`` in
    :func:`amg_coarsen`'s form."""
    z = np.load(path)

    def get(prefix):
        rows, cols = (int(v) for v in z[prefix + "shape"])
        return CsrMatrix(rows, cols, z[prefix + "vals"], z[prefix + "indices"],
                         z[prefix + "offsets"], is_sorted=True)

    levels = []
    for i in range(int(z["n_levels"])):
        levels.append((get(f"l{i}_a_"), get(f"l{i}_p_"), z[f"l{i}_dinv"],
                       float(z[f"l{i}_lam"])))
    return levels, get("coarse_")
