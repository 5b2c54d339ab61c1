#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``sparse_matrix_tpu_torch``) on one
NVIDIA Hopper GPU.

    python3 chip_smoke.py [--c12]

``--c12`` adds the one-off timing of ROADMAP C12 (the aligned SpMM's old
per-column spill loop against its one LanePack SpMM launch).

Phases, each of which ends the run with an exception on failure:

1. Device and build: the card's name and power limit (nvidia-smi), its
   compute capability, the parallel nvcc build of ``csrc/*.cu`` and the
   g++ build of the host library (``native/src/spmx_host.cpp``).
2. Kernels: each CUDA kernel against its plain PyTorch version on the card
   and against a float64 oracle at the main path's shapes. The SpMV and
   SpMM kernels are held to the per-row float32 bound of
   ``spmv_f64_bound`` (column by column for the SpMM kernels), the block
   SpGEMM to ``(n_ij + 2) * u * (|A||B|)_ij`` per entry of the union of
   both patterns (``+ 2 * 2^-8 * (|A||B|)_ij`` for bf16 blocks). The two
   block kernels (B10, B11), which sum exact products in float64 on the
   FP64 tensor cores and round once, are also held within 1 f32 ulp of
   their float64 plain versions per entry, and B11 to err/bound <= 0.34
   against a float64 block oracle of its stored operands on the card
   (``block_err_over_bound``; 1/(n + 2) <= 1/3 in theory). The aligned,
   LanePack, BELL and stripe SpMV kernels (B2, B3, B4, B5; BELL on
   randlocal_262k with a LanePack spill in add mode, the select stripe
   plan with its scan-mode spill in add mode) and the aligned, LanePack
   and BELL SpMM kernels (B6 and B7, packed and, on Poisson 1024^2,
   row-major; B6 with no spill must also equal its segment-order plain
   version, ``_segments_torch``, bit for bit; B8, whose cases have no
   spill, its plain version) must give equal bits on two calls. Each case
   has CUDA-event times (median of 30 calls, 5 for the block SpGEMM) of
   the kernel through the wrapper a user calls (``ms``; for B1, B2, B3,
   B4, B5, B6, B7, B8, B9, B10, B12 and B13 also the bare launch,
   ``launch_ms``, and
   its device time with no host gaps, ``device_ms``, which the kernels
   line repeats for the first case), its
   plain version and
   one library call on the same inputs (``torch.sparse`` CSR times X, or
   CSR times CSR for the SpGEMM, with the dense ``torch.matmul`` beside
   it, and in its place past the products cuSPARSE can take; a yardstick
   used nowhere in the port),
   and the bound: the larger of the bytes the product must move
   over 3.35 TB/s (the matrix once in the smallest of its plain CSR and DIA
   forms and the kernel's plan, ``matrix_bytes``, and x and y once each;
   for the block SpGEMM A and B in their smallest plain forms, at the
   width of the stored blocks, and C's entries once) and the operations
   the product needs over the data sheet's peak for their type (2*nnz*K
   for the SpMV and SpMM kernels, the BCSR SpMM included; 2 per expanded
   scalar product for the block SpGEMM; 67 TFLOP/s of f32 on the CUDA
   cores, 989 TFLOP/s of bf16 tensor cores for bf16 blocks). The dense-
   block work the block kernels do (2*bs^2*F per stored block, 2*bs^3 per
   pair) is logged beside it as ``block_flops``, with the live-depth
   share of the kernels' streams (``live_share``: the work over their
   live-depth streams, 2*m*F per B10 stream row of an m-row tile and
   2*m*n per B11 stream row of an m x n tile, over the dense-block work)
   and the rate over that live work. Besides the main path's shapes, both
   run a dense-block case, the block-tridiagonal 16384^2 matrix of whole
   128 x 128 blocks (every depth row live), so the tile's dense rate is on
   record. TF32 must be off.
3. Main path, in nine parts, each with every launch count set to 0 just
   before it and read just after:
   a. slice 1: CG through ``SpmvOperator`` on Poisson 2048^2 (auto-
      dispatched to DIA), the same with bf16 band planes through
      ``cg_solve_ir``, CG on the aligned and the BELL formats, the
      ``entry()`` step;
   b. the bench's three 262k-row classes through ``SpmvOperator`` with no
      ``force`` (DIA, stripe scan(2,2), stripe scan(8,16), the reference's
      choices) and through forced LanePack operators;
   c. multi-RHS: ``SpmvOperator.matmat`` at K=8 on Poisson 2048^2 (DIA)
      and 1024^2 (aligned), and ``cg_solve_multi`` over the packed
      ``dia_matvec_multi`` (2048^2) and ``aligned_matvec_multi`` (1024^2)
      at K=8;
   d. general multi-RHS: ``matmat`` at K=8 on Poisson 1024^2 (forced
      LanePack, forced BELL) and randlocal_262k (forced LanePack, aligned
      with its LanePack spill), ``cg_solve_multi`` over the packed
      ``lanepack_matvec_multi`` (Poisson 1024^2) and over the BELL
      operator's ``matmat`` (Poisson 512^2), at K=8;
   e. block sparse: ``BlockSpgemm(U, U).multiply()`` for U uniform 8192^2
      at 0.2 % in f32 and bf16 block storage, ``spgemm_block_device`` and
      ``spmm_bcsr`` on the block-tridiagonal 65536^2 matrix;
   f. SpGEMM (slice 4): ``A @ A`` (``spgemm_auto`` on the card, the engine
      taken and its cost estimates logged) on Poisson 2048^2,
      femlike_262k and uniform 8192, with the time of every other engine
      that fits; ``EscSpgemm(reduce="sort")`` on femlike_262k and
      randlocal_262k with its phases (expansion, run sums; the sort
      reduction planned at construction), beside the per-call sort path
      of earlier slices (expansion, sort, run reduce), and a re-multiply
      with fresh values; ``EscSpgemm`` with the SpMV reduction
      and ``FixedSideSpgemm`` on uniform 8192; the hyper-sparse cell
      (uniform 16384 at 0.015 %): ``EscSpgemm`` against ``BlockSpgemm``
      against ``torch.sparse.mm``; ``transpose_device`` and ``add_device``
      on femlike_262k against the host forms.
   g. IC/ILU (slice 5): ``ic0`` of Poisson 2048^2 in the host library
      (seconds logged), ``pcg_solve`` with ``ic_preconditioner`` fused
      (the trisweep kernel) and in the loop form (DIA SpMVs) at sweeps 1,
      2 and 4, beside part a's plain CG; on femlike_262k made strictly
      diagonally dominant (``with_dominant_diagonal``), ``bicgstab_solve``
      and ``gmres_solve(restart=30)`` with and without the fused
      ``ilu_preconditioner``, and BiCGSTAB with ``ilut_preconditioner``.
   h. AMG: ``amg_setup`` on Poisson 2048^2 with the defaults
      (Jacobi, nu = 1, theta = 0.08, coarse 400), timed by phase
      (strength and aggregation, prolongator smoothing, each Galerkin
      product with its engine and products per second, the operator plans
      of each level, the coarse pseudo-inverse and its upload) and logged
      by level (n, nnz, P's nnz, the formats of A, P and P^T);
      ``amg_pcg_solve`` to 1e-5 on a vector beside parts a and g, then on
      a K=8 block; a save/load round trip of the 512^2 coarsening, whose
      reloaded hierarchy must take the same iterations.
   i. HPCG (HPCG 3.1's 104^3 local grid, float64): ``hpcg_hierarchy``
      (4 levels, each A on the f64 DIA kernel, SymGS plans) timed, then
      one set of ``amg_pcg_solve`` at tol 0 and 50 iterations on b = A 1
      after the set that captures the V-cycle's graph, held to the plain
      reference's set (``reference/hpcg.py``) on the card.
   Solves are checked for convergence and for their true residual (per
   column for the multi-RHS solves; the ILU solves within 10 tol |b|, the
   reference tests' acceptance), products against float64: SpGEMM
   results per entry of the union of both patterns (in part f from
   three scipy float64 products), SpMV reductions against the SpMV bound
   of their selection matrix as well (ROADMAP C14).
4. Launch counts: every kernel of a part must have run in that part.
5. The ESC expansion kernel on the plans part f built: bit-equal to its
   two plain versions (the lane form on the real slots, the segment
   schedule on every slot), on two calls and with CSR-order lhs values
   read through the permutation, with its times (beside the reference
   gather engine's expansion as the yardstick) and its bound; then, on
   the sort-reduction engines, the run-sum kernel (no TPU kernel: the
   sort reduction planned once) bit-equal to its plain version on the CPU
   and on two calls, beside one ``index_add_`` as the library call.
6. The trisweep kernel at sweeps = 4 on part g's factors (L and L^T of
   Poisson 2048^2's IC(0), L and U of femlike's ILU(0)): bit-equal to its
   plain version and on two calls, within the float64 running bound of
   ``trisweep_f64_bound``, with its times beside the loop form (the
   reference's default ``TriangularJacobi.__call__``: the yardstick, no
   single PyTorch call computes Jacobi sweeps), beside the exact solve of
   one ``torch.triangular_solve`` on the factor as a CSR tensor (a second
   yardstick, checked against the host solve) and its bound (the planes,
   b and dinv read once and y written once over 3.35 TB/s); and on
   Poisson 64^2, depth(L) - 1 = 126 sweeps equal to the exact host solve.
7. The SymGS kernel (no TPU kernel) on part i's four levels (104^3, 52^3,
   26^3, 13^3) in float64: one step, its colour passes in one launch,
   against its plain version (``_symgs_torch``) on the same inputs on the
   card, within ``symgs_f64_bound``, bit-equal to the step as one launch a
   colour pass and on two calls, with the device times of both forms, the
   plain version's and the bound (two sweep directions, each the level's
   matrix in its smallest plain form with 8-byte values, r read once and x
   read and written once, over 3.35 TB/s; no library call computes it);
   the finest level's f64 DIA SpMV against its plain version within 2 nb
   f64 roundoffs of |A||x|, beside ``torch.mv`` on the f64 CSR tensor.

The last two lines are the kernels' JSON record (each kernel with its
worst ``ms / library_ms`` over its cases, ``worst_library_factor``) and
the result line. The
script imports nothing of JAX or of the JAX package. Without a CUDA device
it exits with 1 and prints no result.
"""

from __future__ import annotations

import copy
import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

# kernel -> (source, the TPU kernel it replaces)
REPLACES = {
    "dia": ("sparse_matrix_tpu_torch/csrc/spmv_dia.cu",
            "sparse_matrix_tpu/ops/spmv_dia.py:83"),
    "aligned": ("sparse_matrix_tpu_torch/csrc/spmv_aligned.cu",
                "sparse_matrix_tpu/ops/spmv.py:348"),
    "lanepack": ("sparse_matrix_tpu_torch/csrc/spmv_lanepack.cu",
                 "sparse_matrix_tpu/ops/spmv.py:77"),
    "bell": ("sparse_matrix_tpu_torch/csrc/spmv_bell.cu",
             "sparse_matrix_tpu/ops/spmv_bell.py:80"),
    "stripe": ("sparse_matrix_tpu_torch/csrc/spmv_stripe.cu",
               "sparse_matrix_tpu/ops/spmv.py:568"),
    "dia_spmm": ("sparse_matrix_tpu_torch/csrc/spmm_dia.cu",
                 "sparse_matrix_tpu/ops/spmv_dia.py:215"),
    "aligned_spmm": ("sparse_matrix_tpu_torch/csrc/spmm_aligned.cu",
                     "sparse_matrix_tpu/ops/spmm.py:120"),
    "lanepack_spmm": ("sparse_matrix_tpu_torch/csrc/spmm_lanepack.cu",
                      "sparse_matrix_tpu/ops/spmm.py:343"),
    "bell_spmm": ("sparse_matrix_tpu_torch/csrc/spmm_bell.cu",
                  "sparse_matrix_tpu/ops/spmm.py:640"),
    "bcsr_spmm": ("sparse_matrix_tpu_torch/csrc/spmm_bcsr.cu",
                  "sparse_matrix_tpu/ops/spmm.py:61"),
    "block_spgemm": ("sparse_matrix_tpu_torch/csrc/spgemm_block.cu",
                     "sparse_matrix_tpu/ops/spgemm_block.py:72"),
    "esc_expand": ("sparse_matrix_tpu_torch/csrc/esc_expand.cu",
                   "sparse_matrix_tpu/ops/esc_expand.py:158"),
    # no TPU kernel: the reference's XLA run reduce of the sort reduction
    "esc_run_sum": ("sparse_matrix_tpu_torch/csrc/esc_run_sum.cu",
                    "sparse_matrix_tpu/ops/device_sorted.py:204"),
    "trisweep": ("sparse_matrix_tpu_torch/csrc/trisweep.cu",
                 "sparse_matrix_tpu/ops/trisweep.py:88"),
    # no TPU kernel: the JAX package has no Gauss-Seidel smoother
    "symgs": ("sparse_matrix_tpu_torch/csrc/symgs_dia.cu", "no TPU kernel"),
    # no TPU kernel: XLA fused the JAX package's CG updates in its while_loop
    "krylov_dot": ("sparse_matrix_tpu_torch/csrc/krylov_update.cu", "no TPU kernel"),
    "cg_update": ("sparse_matrix_tpu_torch/csrc/krylov_update.cu", "no TPU kernel"),
    "p_update": ("sparse_matrix_tpu_torch/csrc/krylov_update.cu", "no TPU kernel"),
}
# the kernels each part of the main path must launch
PARTS = {
    "slice1": ("dia", "aligned", "bell", "krylov_dot", "cg_update", "p_update"),
    "classes": ("stripe", "dia", "lanepack"),
    "multi_rhs": ("dia_spmm", "aligned_spmm"),
    "general_multi_rhs": ("lanepack_spmm", "bell_spmm"),
    "block_sparse": ("bcsr_spmm", "block_spgemm"),
    "spgemm": ("esc_expand", "esc_run_sum", "block_spgemm"),
    "ilu": ("trisweep", "dia"),
    # level 0's SpMV and the block V-cycle's DIA SpMM, then what the
    # dispatch picks below it on the card: aligned P and P^T, the hybrid
    # levels' LanePack residuals, the coarsest P as stripe, BELL at 512^2
    "amg": ("dia", "dia_spmm", "aligned", "aligned_spmm", "lanepack", "lanepack_spmm",
            "stripe", "bell", "cg_update", "p_update"),
    # HPCG 104^3: every level's A on the f64 DIA kernel, every smoothing
    # step on the SymGS kernel
    "hpcg": ("symgs", "dia", "cg_update", "p_update"),
}
SEED = 0
CG_TOL = 1e-5
# cg_solve_ir stops on the residual b - A x evaluated in f32, whose rounding
# floor at Poisson 2048^2 is about 2e-5 |b| (measured on the H100: 20000
# inner iterations ended at 2.2e-5); its target sits above that floor
IR_TOL = 1e-4
EPS_F32 = 2.0 ** -23
U_F32 = 2.0 ** -24  # unit roundoff of float32
K_RHS = 8
ILU_TOL = 1e-6  # the unsymmetric ILU solves of part g
TRISWEEP_SWEEPS = 4  # the kernel phase's sweep count (the reference's default)
# part i: HPCG 3.1's local grid (hpcg.dat), its multigrid levels and a set's
# iterations; a set is held to the plain reference's within the limits of
# the benchmark's hpcg104.mg_pcg cell (sound runs read 1e-15 and below)
HPCG_GRID = (104, 104, 104)
HPCG_LEVELS = 4
HPCG_ITERS = 50
HPCG_LIMIT = 1e-9
# AMG-PCG steps queued for their device time: a V-cycle launches about a
# hundred kernels, and the queue behind the hold takes about a thousand
AMG_STEP_CALLS = 4
# H100 SXM data sheet: HBM3 bandwidth, f32 and f64 (non-tensor-core) peaks
# and dense bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
F64_FLOP_PER_S = 34e12
BF16_TC_FLOP_PER_S = 989e12
# timed calls of a block SpGEMM case (tens of ms for the library at uniform 8192)
SPGEMM_REPS = 5
# B11 sums exact f64 products and rounds once: an entry of n products is
# within 1/(n + 2) <= 1/3 of its float32 bound
B11_ERR_LIMIT = 0.34
# products past which the host float64 SpGEMM oracle is not run (its
# expansion holds every product in memory)
HOST_ORACLE_PRODUCTS = 50_000_000
# products past which the torch.sparse.mm yardstick is not called: cuSPARSE's
# SpGEMM fails for want of resources on the dense-block case (2.4e9
# products); there the dense torch.matmul of the same operands, the same
# function, is the library time
LIBRARY_SPGEMM_PRODUCTS = 1_000_000_000
# device arrays each kernel reads, for its plan bytes (a "spill" entry
# recurses with the spill kernel's keys)
READS = {
    "dia": ("data", "offsets"),
    "aligned": ("vals", "lane", "col_off", "segments", "rb_seg"),
    "lanepack": ("vals", "lane", "ends", "starts", "col_off", "segments", "rb_seg"),
    "bell": ("vals", "lane", "ds"),
    "stripe": ("vals", "lane", "ends", "starts", "col_off", "chunk_stripe", "rb_mask",
               "segments", "stripe_seg"),
    "aligned_spmm": ("vals", "lane", "col_off", "segments", "rb_seg"),
    "lanepack_spmm": ("vals", "lane", "ends", "starts", "col_off", "segments", "rb_seg"),
    "bell_spmm": ("vals", "lane", "ds"),
}
SPILL_OF = {"aligned": "lanepack", "bell": "lanepack", "stripe": "stripe",
            "aligned_spmm": "lanepack_spmm", "bell_spmm": "lanepack_spmm"}


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, reps: int = 30, warmup: int = 10) -> float:
    """Median device time of one ``fn()`` in ms, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def device_ms_per_call(torch, fn, calls: int = 20) -> float:
    """Device time of one ``fn()`` with no host gaps, in ms: the stream is
    held by a sleep kernel while the host enqueues ``calls`` calls, so they
    then run back to back, and CUDA events time them."""
    fn()
    torch.cuda.synchronize()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(500_000_000)  # 0.25 s at 1.98 GHz
    s.record()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    enqueue = time.perf_counter() - t0
    e.record()
    torch.cuda.synchronize()
    if enqueue > 0.1:
        raise AssertionError(f"enqueue took {enqueue:.3f} s, longer than the hold")
    return s.elapsed_time(e) / calls


def poisson_cond(n: int) -> float:
    """cond_2 of the n^2 five-point Laplacian (its extreme eigenvalues are
    4 -+ 4 cos(pi / (n + 1)))."""
    c = math.cos(math.pi / (n + 1))
    return (4 + 4 * c) / (4 - 4 * c)


def plan_of(op, fmt: str):
    """The host plan of the operator's part of format ``fmt``, or None."""
    part = op.part(fmt)
    return None if part is None else part.plan


def arrays_bytes(kernel: str, arrs: dict) -> int:
    """Bytes of the device arrays ``kernel`` reads, its spill's included."""
    total = sum(arrs[k].numel() * arrs[k].element_size() for k in READS[kernel] if k in arrs)
    if "spill" in arrs:
        total += arrays_bytes(SPILL_OF[kernel], arrs["spill"])
    return total


def plain_form_bytes(m, value_bytes: int) -> int:
    """Bytes of ``m`` in the smaller of its two plain forms: CSR with the
    narrowest column index and row pointer, or DIA (a plane of ``rows``
    values and one offset per occupied diagonal). ``matrix_bytes`` of a
    check is the smaller of this and the kernel's own plan."""
    nnz = m.nnz()
    col_b = 1 if m.cols <= 1 << 8 else 2 if m.cols <= 1 << 16 else 4
    ptr_b = 4 if nnz < 1 << 31 else 8
    csr = nnz * (value_bytes + col_b) + (m.rows + 1) * ptr_b
    ndiag = np.unique(m.indices.astype(np.int64) - m.row_ids()).size
    return min(csr, ndiag * (m.rows * value_bytes + 4))


def library_csr(torch, m, dev):
    """The matrix as a ``torch.sparse`` CSR tensor on the card: the
    library yardstick (never called by the port)."""
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "sparse CSR support is in beta"
        return torch.sparse_csr_tensor(
            torch.from_numpy(m.offsets.astype(np.int64)),
            torch.from_numpy(m.indices.astype(np.int64)),
            torch.from_numpy(m.vals.astype(np.float32)),
            size=(m.rows, m.cols), check_invariants=False,
        ).to(dev)


class KernelChecks:
    """Phase 2: kernel vs plain version vs float64 oracle, with times,
    bound and library time."""

    def __init__(self, torch, dev):
        self.torch = torch
        self.dev = dev
        self.cases = {k: [] for k in REPLACES}
        self._csr = {}
        self._mbytes = {}

    def check(self, kernel, case, m, x_np, run_kernel, run_plain, *, plan_bytes,
              value_bytes=4, unpack=None, ulp_plain=False, launch=None, repeat_bits=False,
              equal_plain=False, **bound_kw):
        """``x_np`` is (cols,) or (cols, K); ``unpack`` maps a kernel or
        plain output to (rows,) or (rows, K); ``plan_bytes`` counts the
        bytes of the plan arrays one call of the kernel reads (x and y
        apart); ``value_bytes`` is the width of the matrix values it
        reads; ``ulp_plain`` holds the kernel within 1 f32 ulp of its
        plain version per entry (both sum in float64 and round once).
        ``ms`` times ``run_kernel``, the wrapper a user calls, the same
        span as the library call; ``launch``, when given, is the bare
        kernel launch on the inputs the wrapper prepares, timed beside it
        as ``launch_ms`` and, with no host gaps, ``device_ms``;
        ``repeat_bits`` demands equal bits from two more kernel calls,
        ``equal_plain`` the plain version's bits."""
        from sparse_matrix_tpu_torch.ops.spmv import spmv_f64_bound

        torch = self.torch
        unpack = unpack or (lambda y: y)
        k_out, p_out = unpack(run_kernel()), unpack(run_plain())
        torch.cuda.synchronize()
        if repeat_bits and not torch.equal(run_kernel(), run_kernel()):
            raise AssertionError(f"{kernel}/{case}: two calls on one input differ in their bits")
        if equal_plain and not torch.equal(k_out, p_out):
            raise AssertionError(f"{kernel}/{case}: the kernel and its plain version differ in "
                                 f"{int((k_out != p_out).sum())} entries")
        if ulp_plain and ulp_excess(k_out, p_out):
            raise AssertionError(f"{kernel}/{case}: {ulp_excess(k_out, p_out)} entries more "
                                 "than 1 ulp from the float64 plain version")
        yk = k_out.double().cpu().numpy()
        yp = p_out.double().cpu().numpy()
        del k_out, p_out
        xs = x_np if x_np.ndim == 2 else x_np[:, None]
        yk2 = yk if yk.ndim == 2 else yk[:, None]
        yp2 = yp if yp.ndim == 2 else yp[:, None]
        ratio = 0.0
        if not bound_kw and xs.shape[1] > 1:
            y64_all, bound_all = spmm_f64_bound(m, xs)
        for q in range(xs.shape[1]):
            if not bound_kw and xs.shape[1] > 1:
                y64, bound = y64_all[:, q], bound_all[:, q]
            else:
                y64, bound = spmv_f64_bound(m, xs[:, q], **bound_kw)
            err_k = np.abs(yk2[:, q] - y64)
            err_p = np.abs(yp2[:, q] - y64)
            if not (np.all(np.isfinite(yk2[:, q])) and np.all(err_k <= bound)):
                i = int(np.argmax(err_k - bound))
                raise AssertionError(
                    f"{kernel}/{case}: kernel off the f64 oracle at row {i}, column {q}: "
                    f"|err| {err_k[i]:.3e} > bound {bound[i]:.3e}"
                )
            if not np.all(err_p <= bound):
                i = int(np.argmax(err_p - bound))
                raise AssertionError(
                    f"{kernel}/{case}: plain version off the f64 oracle at row {i}, column {q}"
                )
            ratio = max(ratio, float(np.max(err_k / np.maximum(bound, 1e-300))))
        ms = cuda_ms(torch, run_kernel)
        extra = {}
        if launch is not None:
            extra = dict(launch_ms=cuda_ms(torch, launch),
                         device_ms=device_ms_per_call(torch, launch))
        plain_ms = cuda_ms(torch, run_plain)
        key = id(m)
        if key not in self._csr:
            self._csr[key] = library_csr(torch, m, self.dev)
        a = self._csr[key]
        xt = torch.from_numpy(x_np).to(self.dev)
        library_ms = cuda_ms(torch, (lambda: a @ xt) if x_np.ndim == 2 else (lambda: torch.mv(a, xt)))
        k = xs.shape[1]
        if (key, value_bytes) not in self._mbytes:
            self._mbytes[key, value_bytes] = plain_form_bytes(m, value_bytes)
        # the product's compulsory bytes: A once (in the smallest form at
        # hand, matrix_bytes), X read and Y written once
        matrix_bytes = min(self._mbytes[key, value_bytes], plan_bytes)
        nbytes = matrix_bytes + 4 * k * (m.rows + m.cols)
        flops = 2.0 * m.nnz() * k
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        row = dict(case=case, rows=m.rows, nnz=m.nnz(), k=k,
                   max_abs_err=float(np.max(np.abs(yk - yp))),
                   max_err_over_bound=ratio, ms=ms, plain_ms=plain_ms,
                   library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=int(nbytes), matrix_bytes=int(matrix_bytes),
                   plan_bytes=int(plan_bytes), flops=flops, **extra)
        if repeat_bits:
            row["bitwise_repeat"] = True
        if equal_plain:
            row["bitwise_plain"] = True
        self.cases[kernel].append(row)
        log(f"kernel {kernel:12s} {case:34s} rows={m.rows} nnz={m.nnz()} K={k} "
            f"max|k-plain|={row['max_abs_err']:.3e} max err/bound={ratio:.3f} "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({nbytes} bytes / 3.35 TB/s; matrix "
            f"{matrix_bytes}, plan arrays {plan_bytes} bytes; {flops:.4g} flop / 67 "
            f"TFLOP/s), "
            f"{m.nnz() * k / ms / 1e6:.2f} Gnnz/s"
            + ("" if launch is None else f"; bare launch {extra['launch_ms']:.4f} ms, its "
               f"device time with no host gaps {extra['device_ms']:.4f} ms"))


    def check_spgemm(self, case, lhs, rhs, eng, *, storage):
        """The block SpGEMM kernel of ``eng`` (a ``BlockSpgemm``) against
        its float64 plain version on the card (1 f32 ulp per entry) and
        against the float64 block oracle of its stored operands
        (``block_err_over_bound``, at most ``B11_ERR_LIMIT``); as host CSR
        against the float64 product of the f32 operands
        (``spgemm_err_over_bound``: ``B11_ERR_LIMIT`` for f32 blocks, 1 for
        bf16 ones, whose operands are rounded), where the host can expand
        the products. Times the kernel, the plain version,
        ``torch.sparse.mm`` of the two CSR tensors (the library time, up to
        ``LIBRARY_SPGEMM_PRODUCTS`` products) and the dense ``torch.matmul``
        (sizes to 16384; the library time past that count)."""
        from sparse_matrix_tpu_torch.ops import spgemm_block
        from sparse_matrix_tpu_torch.ops.device_sorted import padded_to_host

        torch = self.torch
        nc = len(eng.c_keys)

        def plain():
            return spgemm_block._block_numeric_torch(eng.a_blocks, eng.b_blocks, eng.pair_a,
                                                     eng.pair_b, eng.pair_c, num_c=nc,
                                                     bs=eng.bs)

        ck = eng.multiply_device()
        cp = plain()
        torch.cuda.synchronize()
        max_abs = float((ck - cp).abs().max())
        bad = ulp_excess(ck, cp)
        if bad:
            raise AssertionError(f"block_spgemm/{case}: {bad} entries more than 1 ulp from the "
                                 "float64 plain version")
        dev_ratio = block_err_over_bound(torch, eng, ck)
        if not dev_ratio <= B11_ERR_LIMIT:
            raise AssertionError(f"block_spgemm/{case}: err/bound {dev_ratio} against the "
                                 f"float64 block oracle, above {B11_ERR_LIMIT}")
        products = int(np.diff(rhs.offsets)[lhs.indices].sum())
        c = padded_to_host(eng.multiply_coo(ck))
        ratio = None
        if products <= HOST_ORACLE_PRODUCTS:
            limit = 1.0 if storage == "bf16" else B11_ERR_LIMIT
            ratio = spgemm_f64_check(lhs, rhs, c, bf16=storage == "bf16", tag=case, limit=limit)
            spgemm_f64_check(lhs, rhs, padded_to_host(eng.multiply_coo(cp)),
                             bf16=storage == "bf16", tag=case + " plain", limit=limit)
        del ck, cp
        ms = cuda_ms(torch, eng.multiply_device, reps=SPGEMM_REPS, warmup=2)
        device_ms = device_ms_per_call(torch, eng.multiply_device)
        plain_ms = cuda_ms(torch, plain, reps=SPGEMM_REPS, warmup=1)
        a_t = library_csr(torch, lhs, self.dev)
        b_t = library_csr(torch, rhs, self.dev)
        library_ms, library_call = None, "torch.sparse.mm"
        if products <= LIBRARY_SPGEMM_PRODUCTS:
            library_ms = cuda_ms(torch, lambda: torch.sparse.mm(a_t, b_t), reps=SPGEMM_REPS,
                                 warmup=2)
        dense_ms = None
        if max(lhs.rows, lhs.cols, rhs.cols) <= 16384:
            ad, bd = a_t.to_dense(), b_t.to_dense()
            dense_ms = cuda_ms(torch, lambda: torch.matmul(ad, bd), reps=SPGEMM_REPS, warmup=2)
            del ad, bd
        del a_t, b_t
        if products > LIBRARY_SPGEMM_PRODUCTS:
            library_ms, library_call = dense_ms, "torch.matmul (dense)"
        bs, pairs = eng.bs, eng.num_pairs
        # the product's own needs: A and B once in their smallest plain
        # forms (values at the stored width), C's entries written once; 2
        # flops per expanded scalar product
        vb = eng.a_blocks.element_size()
        nbytes = plain_form_bytes(lhs, vb) + plain_form_bytes(rhs, vb) + plain_form_bytes(c, 4)
        flops = 2.0 * products
        block_flops = 2.0 * pairs * bs ** 3
        live_rows = int(eng.depth_stream.shape[0])
        live_flops = eng.live_flops()
        rate = BF16_TC_FLOP_PER_S if storage == "bf16" else F32_FLOP_PER_S
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / rate * 1e3
        row = dict(case=case, rows=lhs.rows, nnz=lhs.nnz(), pairs=pairs, c_blocks=nc,
                   nnz_c=c.nnz(), storage=storage, max_abs_err=max_abs,
                   max_err_over_bound=ratio, max_err_over_bound_f64_blocks=dev_ratio, ms=ms,
                   device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms,
                   library_call=library_call, dense_matmul_ms=dense_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=int(nbytes), flops=flops, block_flops=block_flops,
                   live_rows=live_rows, live_share=live_flops / max(1.0, block_flops),
                   live_flops=live_flops)
        self.cases["block_spgemm"].append(row)
        host = ("not run (" + f"{products} products)" if ratio is None else f"{ratio:.3f}")
        log(f"kernel block_spgemm {case:34s} rows={lhs.rows} pairs={pairs} C blocks={nc} "
            f"nnz(C)={c.nnz()} {storage} max|k-plain|={max_abs:.3e} (within 1 ulp) "
            f"err/bound f64 blocks {dev_ratio:.3f}, host f64 product {host}; "
            f"kernel {ms:.4f} ms (device time with no host gaps {device_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, library ({library_call}) "
            f"{'not measured' if library_ms is None else f'{library_ms:.4f} ms'}, "
            f"dense matmul {'not measured' if dense_ms is None else f'{dense_ms:.4f} ms'}, "
            f"bound {row['bound_ms']:.4f} ms ({nbytes} bytes / 3.35 TB/s; {flops:.4g} flop "
            f"of {products} scalar products / {rate / 1e12:g} TFLOP/s); dense-block work "
            f"{block_flops:.4g} flop, live-depth stream {live_rows} rows, live work "
            f"{live_flops:.4g} flop (share {row['live_share']:.4f}), "
            f"{live_flops / ms / 1e9:.2f} TFLOP/s")


def block_err_over_bound(torch, eng, c_blocks) -> float:
    """The largest ``|c - C64| / ((n + 2) u |A||B|)`` over every entry of
    the dense C blocks ``c_blocks`` of ``eng`` (a ``BlockSpgemm``), with
    C64, ``|A||B|`` and the product counts n from float64 block products
    of the stored operands on the card (exact counts; for bf16 storage the
    oracle of the bf16 operands). An entry off a zero bound gives inf."""
    from sparse_matrix_tpu_torch.ops.spgemm_block import _TORCH_PAIR_CHUNK

    nc, bs = len(eng.c_keys), eng.bs
    c64, mag, cnt = (torch.zeros((nc, bs, bs), dtype=torch.float64, device=c_blocks.device)
                     for _ in range(3))
    for s in range(0, eng.num_pairs, _TORCH_PAIR_CHUNK):
        sl = slice(s, s + _TORCH_PAIR_CHUNK)
        a = eng.a_blocks[eng.pair_a[sl].long()].double()
        b = eng.b_blocks[eng.pair_b[sl].long()].double()
        q = eng.pair_c[sl].long()
        c64.index_add_(0, q, a @ b)
        mag.index_add_(0, q, a.abs() @ b.abs())
        cnt.index_add_(0, q, (a != 0).double() @ (b != 0).double())
        del a, b
    err = (c_blocks.double() - c64).abs()
    bound = (cnt + 2) * U_F32 * mag
    if bool((err[bound == 0] > 0).any()):
        return float("inf")
    return float((err / torch.where(bound == 0, 1.0, bound)).max()) if nc else 0.0


def ulp_excess(got, want) -> int:
    """Entries of ``got`` more than 1 f32 ulp from ``want`` (tensors of one
    shape), or NaN where ``want`` is not (or the reverse)."""
    g = got.float().cpu().numpy().astype(np.float64)
    w = want.float().cpu().numpy()
    nan_g, nan_w = np.isnan(g), np.isnan(w)
    close = (g == w) | (np.abs(g - w) <= np.spacing(np.abs(w)))
    return int(np.sum(nan_g != nan_w) + np.sum(~close & ~nan_w & ~nan_g))


def spmm_f64_bound(m, x):
    """``(Y64, bound)`` for every column of ``x`` (cols, K) at once: the
    float64 CSR product and the per-entry bound ``(nnz_row + 1) * u *
    (|A||x|)``, what ``spmv_f64_bound`` gives column by column for a plain
    row sum (scipy, one pass instead of K)."""
    import scipy.sparse as sp

    a = sp.csr_matrix((m.vals.astype(np.float64), m.indices.astype(np.int64),
                       m.offsets.astype(np.int64)), shape=(m.rows, m.cols))
    xd = x.astype(np.float64)
    bound = (np.diff(m.offsets)[:, None] + 1) * U_F32 * (abs(a) @ np.abs(xd))
    return a @ xd, bound


def spgemm_f64_check(lhs, rhs, c, *, bf16: bool, tag: str, limit: float = 1.0) -> float:
    """Hold the host CSR ``c`` to the float64 product, entry by entry on the
    union of both patterns (``spgemm_err_over_bound``, at most ``limit``);
    returns the largest error/bound."""
    from sparse_matrix_tpu_torch.ops.spgemm_block import spgemm_err_over_bound

    ratio = spgemm_err_over_bound(lhs, rhs, c, bf16=bf16)
    if not ratio <= limit:
        raise AssertionError(f"block_spgemm/{tag}: off the f64 oracle (max err/bound {ratio}, "
                             f"limit {limit})")
    return ratio


def phase_kernels(torch, dev, chk: KernelChecks, mats, ops, *, c12: bool):
    from sparse_matrix_tpu_torch.formats.aligned import plan_aligned
    from sparse_matrix_tpu_torch.formats.bell import plan_bell
    from sparse_matrix_tpu_torch.formats.dia import try_dia_from_csr
    from sparse_matrix_tpu_torch.formats.lanepack import plan_lanepack
    from sparse_matrix_tpu_torch.formats.stripe import plan_stripe
    from sparse_matrix_tpu_torch.ops import spmm, spmv, spmv_bell, spmv_dia

    rng = np.random.default_rng(SEED)

    def xvec(m):
        x_np = rng.standard_normal(m.cols).astype(np.float32)
        return x_np, torch.from_numpy(x_np).to(dev)

    def xblock(m):
        x_np = rng.standard_normal((m.cols, K_RHS)).astype(np.float32)
        return x_np, torch.from_numpy(x_np).to(dev)

    # DIA SpMV and SpMM: Poisson 2048^2, f32 and bf16 band planes
    a2 = mats["poisson2048"]
    dia = try_dia_from_csr(a2, dtype=np.float32)
    x_np, x = xvec(a2)
    xb_np, xb = xblock(a2)
    for tag, vdt in (("f32", None), ("bf16", torch.bfloat16)):
        arrs = spmv_dia.dia_device_arrays(dia, dev, values_dtype=vdt)
        vals = None
        if vdt is not None:  # oracle from the bf16-rounded values
            vals = torch.from_numpy(a2.vals.astype(np.float32)).to(vdt).double().numpy()
        # the bare launches: the device arrays' launch records
        y = torch.empty(dia.rows, device=dev)
        chk.check(
            "dia", f"poisson2048_{tag}", a2, x_np,
            lambda: spmv_dia.spmv_dia(dia, x, device_arrays=arrs),
            lambda: spmv_dia._spmv_dia_torch(arrs["data"], x, offsets=dia.offsets,
                                             rows=dia.rows, cols=dia.cols),
            plan_bytes=arrays_bytes("dia", arrs), vals=vals,
            value_bytes=arrs["data"].element_size(),
            launch=lambda arrs=arrs, y=y: arrs["launch"](x, y),
        )
        mv = spmv_dia.dia_matvec_multi(dia, K_RHS, dev, device_arrays=arrs)
        x3 = spmv_dia.dia_pack_rhs(dia, xb)
        mv(x3)  # makes the SpMM kernel's record, ``spmm_launch``
        chk.check(
            "dia_spmm", f"poisson2048_{tag}_K{K_RHS}", a2, xb_np,
            lambda: mv(x3),
            lambda: spmv_dia._spmm_dia_torch(arrs["data"], xb, offsets=dia.offsets,
                                             rows=dia.rows),
            plan_bytes=arrays_bytes("dia", arrs),
            value_bytes=arrs["data"].element_size(),
            unpack=lambda y: spmv_dia.dia_unpack_rhs(dia, y) if y.dim() == 3 else y,
            vals=vals,
            launch=lambda arrs=arrs, x3=x3, y3=torch.empty_like(x3): arrs["spmm_launch"](x3, y3),
        )
        del arrs, mv, x3

    # aligned SpMV and SpMM: Poisson 1024^2 (no spill), randlocal_262k
    # (LanePack spill)
    for name in ("poisson1024", "randlocal_262k"):
        m = mats[name]
        plan = plan_aligned(m)
        arrs = spmv.aligned_device_arrays(plan, dev)
        x_np, x = xvec(m)
        spill = () if plan.spill is None else (plan.spill,)

        def plain(plan=plan, arrs=arrs, x=x):
            y = spmv._aligned_torch(arrs, x, rows=plan.rows, cols=plan.cols)
            if plan.spill is not None:
                y = y + spmv._lanepack_torch(arrs["spill"], x, rows=plan.rows,
                                             cols=plan.cols, kw=plan.spill.kw)
            return y

        tag = name + ("_spill" if plan.spill is not None else "")

        def launch(arrs=arrs, x=x, y=torch.empty(plan.rows, device=dev)):
            arrs["launch"](x, y)
            if "spill" in arrs:
                arrs["spill"]["launch"](x, y, add=True)

        chk.check("aligned", tag, m, x_np,
                  lambda plan=plan, arrs=arrs, x=x: spmv.spmv_aligned(plan, x, device_arrays=arrs),
                  plain, plan_bytes=arrays_bytes("aligned", arrs),
                  lanepack=spill, launch=launch, repeat_bits=True)

        xb_np, xb = xblock(m)
        x3 = spmm.pack_rhs(xb, m.cols)
        mv = spmm.aligned_matvec_multi(plan, K_RHS, dev, device_arrays=arrs)

        def plain_mm(plan=plan, arrs=arrs, x3=x3):
            y3 = spmm._aligned_spmm_torch(arrs, x3, rows=plan.rows)
            if plan.spill is not None:
                y3 = y3 + spmm._lanepack_spmm_torch(arrs["spill"], x3, cols=plan.cols,
                                                    kw=plan.spill.kw)
            return y3

        def launch_mm(arrs=arrs, x=x3, y=torch.empty_like(x3), packed=True):
            arrs["spmm_launch"](x, y, packed=packed)
            if "spill" in arrs:
                arrs["spill"]["spmm_launch"](x, y, packed=packed, add=True)

        chk.check("aligned_spmm", f"{tag}_K{K_RHS}", m, xb_np,
                  lambda mv=mv, x3=x3: mv(x3), plain_mm,
                  plan_bytes=arrays_bytes("aligned_spmm", arrs),
                  unpack=lambda y, m=m: spmm.unpack_rhs(y, m.rows), lanepack=spill,
                  launch=launch_mm, repeat_bits=True)
        if plan.spill is None:
            # with no spill the kernel sums in the segment-order plain
            # version's order and rounding: equal bits, packed and row-major
            want = spmv._segments_torch("aligned", arrs, xb, rows=m.rows, cols=m.cols)
            if not (torch.equal(spmm.unpack_rhs(mv(x3), m.rows), want)
                    and torch.equal(spmm.spmm_aligned(plan, xb, device_arrays=arrs), want)):
                raise AssertionError(f"aligned_spmm/{tag}: the kernel and its segment-order "
                                     "plain version differ")
            chk.cases["aligned_spmm"][-1]["bitwise_segments"] = True
            log(f"kernel aligned_spmm {tag}_K{K_RHS}: equal to the segment-order plain version "
                "bit for bit, packed and row-major")
            # the row-major call (spmm_aligned, as matmat calls it): X and Y as
            # the caller holds them, no packing
            chk.check("aligned_spmm", f"{tag}_K{K_RHS}_rowmajor", m, xb_np,
                      lambda plan=plan, arrs=arrs, xb=xb: spmm.spmm_aligned(
                          plan, xb, device_arrays=arrs),
                      lambda plain_mm=plain_mm, m=m: spmm.unpack_rhs(plain_mm(), m.rows),
                      plan_bytes=arrays_bytes("aligned_spmm", arrs), lanepack=spill,
                      launch=lambda launch_mm=launch_mm, xb=xb, y=torch.empty(
                          (m.rows, K_RHS), device=dev): launch_mm(x=xb, y=y, packed=False),
                      repeat_bits=True)
        if c12 and plan.spill is not None:
            time_c12(torch, chk, plan, arrs, mv, x3)
        del arrs, mv, x3

    # stripe: the operator plans of randlocal (scan 2,2) and powerlaw (scan
    # 8,16), and a select-mode plan of randlocal with its scan-mode spill
    cases = [("randlocal_262k", plan_of(ops["randlocal_262k"], "stripe")),
             ("powerlaw_262k", plan_of(ops["powerlaw_262k"], "stripe"))]
    t0 = time.perf_counter()
    sel = plan_stripe(mats["randlocal_262k"], mode="select")
    log(f"plan randlocal_262k stripe select: L={sel.levels} kw_g={sel.kw} "
        f"slabs={sel.num_slabs} spill nnz={0 if sel.spill is None else sel.spill.nnz} "
        f"{time.perf_counter() - t0:.2f} s")
    cases.append(("randlocal_262k", sel))
    for name, plan in cases:
        m = mats[name]
        arrs = spmv.stripe_device_arrays(plan, dev)
        x_np, x = xvec(m)

        def plain(plan=plan, arrs=arrs, x=x):
            y, p, a = None, plan, arrs
            while p is not None:
                yp = spmv._stripe_torch(a, x, rows=p.rows, cols=p.cols, lvl=p.levels,
                                        kw=p.kw, scan=p.mode == "scan")
                y = yp if y is None else y + yp
                p, a = p.spill, a.get("spill")
            return y

        def launch(plan=plan, arrs=arrs, x=x, y=torch.empty(plan.rows, device=dev)):
            arrs["launch"](x, y)
            p, a = plan.spill, arrs.get("spill")
            while p is not None:
                a["launch"](x, y, add=True)
                p, a = p.spill, a.get("spill")

        chk.check("stripe", f"{name}_{plan.mode}_L{plan.levels}_kw{plan.kw}", m, x_np,
                  lambda plan=plan, arrs=arrs, x=x: spmv.spmv_stripe(plan, x, device_arrays=arrs),
                  plain, plan_bytes=arrays_bytes("stripe", arrs),
                  stripe=(plan,), launch=launch, repeat_bits=True)
        del arrs

    # LanePack: the bench's three classes, both packs
    for name in ("femlike_262k", "randlocal_262k", "powerlaw_262k"):
        m = mats[name]
        x_np, x = xvec(m)
        for pack in ("dense", "per_rb"):
            plan = plan_lanepack(m, pack=pack)
            arrs = spmv.lanepack_device_arrays(plan, dev)
            chk.check(
                "lanepack", f"{name}_{pack}_kw{plan.kw}", m, x_np,
                lambda plan=plan, arrs=arrs, x=x: spmv.spmv_lanepack(plan, x, device_arrays=arrs),
                lambda plan=plan, arrs=arrs, x=x: spmv._lanepack_torch(
                    arrs, x, rows=plan.rows, cols=plan.cols, kw=plan.kw),
                plan_bytes=arrays_bytes("lanepack", arrs), lanepack=(plan,),
                launch=lambda arrs=arrs, x=x, y=torch.empty(plan.rows, device=dev):
                    arrs["launch"](x, y),
                repeat_bits=True,
            )

    # BELL: Poisson 1024^2 forced (span 128, int8 lanes), femlike_262k
    # (span 256, int16 lanes) and randlocal_262k, whose LanePack spill adds
    # into the rows the BELL kernel wrote
    for name in ("poisson1024", "femlike_262k", "randlocal_262k"):
        m = mats[name]
        t0 = time.perf_counter()
        plan = plan_bell(m)
        log(f"plan {name} bell: span={plan.span} layers={plan.num_layers} spill nnz="
            f"{0 if plan.spill is None else plan.spill.nnz} {time.perf_counter() - t0:.2f} s")
        if name == "randlocal_262k" and plan.spill is None:
            raise AssertionError("the randlocal_262k BELL plan has no spill to add")
        arrs = spmv_bell.bell_device_arrays(plan, dev)
        x_np, x = xvec(m)

        def plain(plan=plan, arrs=arrs, x=x):
            y = spmv_bell._bell_torch(arrs["vals"], arrs["lane"], x, ds=plan.ds,
                                      modes=plan.modes, span=plan.span,
                                      rows=plan.rows, cols=plan.cols)
            if plan.spill is not None:
                y = y + spmv._lanepack_torch(arrs["spill"], x, rows=plan.rows,
                                             cols=plan.cols, kw=plan.spill.kw)
            return y

        tag = f"{name}_span{plan.span}" + ("" if plan.spill is None else "_spill")

        def launch(arrs=arrs, x=x, y=torch.empty(plan.rows, device=dev)):
            arrs["launch"](x, y)
            if "spill" in arrs:
                arrs["spill"]["launch"](x, y, add=True)

        chk.check("bell", tag, m, x_np,
                  lambda plan=plan, arrs=arrs, x=x: spmv_bell.spmv_bell(plan, x, device_arrays=arrs),
                  plain, plan_bytes=arrays_bytes("bell", arrs),
                  lanepack=() if plan.spill is None else (plan.spill,), launch=launch,
                  repeat_bits=True)
    chk._csr.clear()


def time_c12(torch, chk, plan, arrs, mv, x3):
    """ROADMAP C12 (``--c12``): the aligned SpMM with its LanePack spill run
    the old way (the aligned kernel, then per column a strided copy of x,
    one LanePack SpMV launch and one add into y3) against the packed matvec
    ``mv``, whose spill is one LanePack SpMM launch for all K columns;
    timed in turns (before, after, after, before) in this call."""
    r128, k = plan.r128, x3.shape[1]

    def before():
        y3 = torch.empty_like(x3)
        arrs["spmm_launch"](x3, y3, packed=True)
        for q in range(k):
            xq = x3[:, q, :].reshape(-1)[: plan.cols].contiguous()
            yq = torch.zeros(r128 * 128, dtype=x3.dtype, device=x3.device)
            arrs["spill"]["launch"](xq, yq[: plan.rows])
            y3[:r128, q, :] += yq.reshape(r128, 128)
        return y3

    yb, ya = before(), mv(x3)
    diff = float((yb - ya).abs().max()) / max(1.0, float(ya.abs().max()))
    if diff > 1e-5:
        raise AssertionError(f"C12: the column loop and the packed spill differ by {diff:.3e}")
    t = [cuda_ms(torch, before), cuda_ms(torch, lambda: mv(x3)),
         cuda_ms(torch, lambda: mv(x3)), cuda_ms(torch, before)]
    row = chk.cases["aligned_spmm"][-1]
    row["c12"] = dict(before_ms=[t[0], t[3]], after_ms=[t[1], t[2]], rel_diff=diff)
    log(f"C12 {row['case']}: spill column loop {t[0]:.4f} / {t[3]:.4f} ms, "
        f"one LanePack SpMM launch {t[1]:.4f} / {t[2]:.4f} ms (in turns); results differ "
        f"by {diff:.2e} of max|y|")


def aligned_spill_csr(m, plan):
    """The entries of ``m`` that an aligned plan leaves to its LanePack
    spill: those its aligned slots (the nonzero values) do not hold."""
    from sparse_matrix_tpu_torch.formats.csr import CsrMatrix

    chunks = plan.num_slabs * 8
    c, lane_pos = np.nonzero(plan.vals.reshape(chunks, 128))
    r_a = plan.chunk_rb[:chunks][c].astype(np.int64) * 128 + lane_pos
    c_a = (plan.col_off[:chunks][c].astype(np.int64) * 128
           + plan.lane.reshape(chunks, 128)[c, lane_pos].astype(np.int64))
    r = m.row_ids()
    keep = ~np.isin(r * m.cols + m.indices.astype(np.int64), r_a * m.cols + c_a)
    sub = CsrMatrix.from_coo(m.rows, m.cols, r[keep], m.indices[keep].astype(np.int64),
                             m.vals[keep])
    if sub.nnz() != plan.spill.nnz:
        raise AssertionError(f"spill CSR has {sub.nnz()} entries, the spill plan {plan.spill.nnz}")
    return sub


def phase_kernels_slice3(torch, dev, chk: KernelChecks, mats, ops):
    """Phase 2 for the LanePack SpMM (B7), BELL SpMM (B8), BCSR SpMM (B10)
    and block SpGEMM (B11) kernels."""
    from sparse_matrix_tpu_torch.formats.bcsr import BsrMatrix
    from sparse_matrix_tpu_torch.formats.bell import plan_bell
    from sparse_matrix_tpu_torch.formats.lanepack import plan_lanepack
    from sparse_matrix_tpu_torch.native import kernels
    from sparse_matrix_tpu_torch.ops import spmm, spmv
    from sparse_matrix_tpu_torch.ops.spgemm_block import BlockSpgemm

    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the block kernels are held to FP32")
    rng = np.random.default_rng(SEED + 3)

    def xblock(m, k=K_RHS):
        x_np = rng.standard_normal((m.cols, k)).astype(np.float32)
        return x_np, torch.from_numpy(x_np).to(dev)

    # B7: forced LanePack plans at K=8
    t0 = time.perf_counter()
    pl_plan = plan_lanepack(mats["powerlaw_262k"])
    log(f"plan powerlaw_262k lanepack: kw={pl_plan.kw} pack={pl_plan.pack} "
        f"{time.perf_counter() - t0:.2f} s")
    lp1, lp2 = (ops[k].part("lanepack") for k in ("poisson1024_lanepack",
                                                   "randlocal_262k_lanepack"))
    cases = [("poisson1024", lp1.plan, lp1.arrays), ("randlocal_262k", lp2.plan, lp2.arrays),
             ("powerlaw_262k", pl_plan, spmv.lanepack_device_arrays(pl_plan, dev))]
    for name, plan, arrs in cases:
        m = mats[name]
        x_np, x = xblock(m)
        x3 = spmm.pack_rhs(x, m.cols, guard=plan.kw)
        chk.check("lanepack_spmm", f"{name}_{plan.pack}_kw{plan.kw}_K{K_RHS}", m, x_np,
                  lambda plan=plan, arrs=arrs, x3=x3: spmm.spmm_lanepack_packed(
                      plan, x3, device_arrays=arrs),
                  lambda plan=plan, arrs=arrs, x3=x3: spmm._lanepack_spmm_torch(
                      arrs, x3, cols=plan.cols, kw=plan.kw),
                  plan_bytes=arrays_bytes("lanepack_spmm", arrs),
                  unpack=lambda y, m=m: spmm.unpack_rhs(y, m.rows), lanepack=(plan,),
                  launch=lambda arrs=arrs, x3=x3, y3=torch.empty((plan.r128, K_RHS, 128),
                                                                 device=dev):
                      arrs["spmm_launch"](x3, y3, packed=True),
                  repeat_bits=True)
        if name == "poisson1024":
            # the row-major call (spmm_lanepack, as matmat calls it): X and Y
            # as the caller holds them, no packing
            chk.check("lanepack_spmm", f"{name}_{plan.pack}_kw{plan.kw}_K{K_RHS}_rowmajor", m,
                      x_np,
                      lambda plan=plan, arrs=arrs, x=x: spmm.spmm_lanepack(
                          plan, x, device_arrays=arrs),
                      lambda plan=plan, arrs=arrs, x3=x3: spmm._lanepack_spmm_torch(
                          arrs, x3, cols=plan.cols, kw=plan.kw),
                      plan_bytes=arrays_bytes("lanepack_spmm", arrs),
                      unpack=lambda y, m=m: spmm.unpack_rhs(y, m.rows) if y.dim() == 3 else y,
                      lanepack=(plan,),
                      launch=lambda arrs=arrs, x=x, y=torch.empty((m.rows, K_RHS), device=dev):
                          arrs["spmm_launch"](x, y),
                      repeat_bits=True)
    del cases, arrs
    # ... and the spill of randlocal's aligned plan in the aligned layout (one
    # guard row: the kernel reads zeros past cols), the C12 path
    op = ops["randlocal_262k_aligned"]
    al = op.part("aligned")
    sp_plan, sp_arrs = al.plan.spill, al.arrays["spill"]
    sub = aligned_spill_csr(mats["randlocal_262k"], al.plan)
    x_np, x = xblock(sub)
    x3 = spmm.pack_rhs(x, sub.cols)
    chk.check("lanepack_spmm", f"randlocal_262k_aligned_spill_kw{sp_plan.kw}_K{K_RHS}", sub, x_np,
              lambda: spmm.spmm_lanepack_packed(sp_plan, x3, device_arrays=sp_arrs),
              lambda: spmm._lanepack_spmm_torch(sp_arrs, x3, cols=sp_plan.cols, kw=sp_plan.kw),
              plan_bytes=arrays_bytes("lanepack_spmm", sp_arrs),
              unpack=lambda y: spmm.unpack_rhs(y, sub.rows), lanepack=(sp_plan,),
              launch=lambda y3=torch.empty((sp_plan.r128, K_RHS, 128), device=dev):
                  sp_arrs["spmm_launch"](x3, y3, packed=True),
              repeat_bits=True)
    del sub, x3

    # B8: Poisson 1024^2 span 128 at K=8 and 16, femlike_262k span 256 at K=8
    t0 = time.perf_counter()
    fem_plan = plan_bell(mats["femlike_262k"])
    log(f"plan femlike_262k bell: span={fem_plan.span} layers={fem_plan.num_layers} "
        f"{time.perf_counter() - t0:.2f} s")
    from sparse_matrix_tpu_torch.ops.spmv_bell import bell_device_arrays

    pb = ops["poisson1024_bell"].part("bell")
    for name, plan, arrs, k in (("poisson1024", pb.plan, pb.arrays, 8),
                                ("poisson1024", pb.plan, pb.arrays, 16),
                                ("femlike_262k", fem_plan, bell_device_arrays(fem_plan, dev), 8)):
        m = mats[name]
        x_np, x = xblock(m, k)

        def plain(plan=plan, arrs=arrs, x=x):
            y3 = spmm._bell_spmm_torch(arrs["vals"], arrs["lane"], x, ds=plan.ds,
                                       modes=plan.modes, span=plan.span, cols=plan.cols)
            if plan.spill is not None:
                y3 = y3 + spmm._lanepack_spmm_torch(arrs["spill"], spmm.pack_rhs(x, plan.cols),
                                                    cols=plan.cols, kw=plan.spill.kw)
            return spmm.unpack_rhs(y3, plan.rows)

        def launch(plan=plan, arrs=arrs, x=x, y=torch.empty((m.rows, k), device=dev)):
            arrs["spmm_launch"](x, y)
            if plan.spill is not None:
                arrs["spill"]["spmm_launch"](x, y, add=True)

        # with no spill the kernel sums in the plain version's order and
        # rounding: equal bits
        chk.check("bell_spmm", f"{name}_span{plan.span}_K{k}", m, x_np,
                  lambda plan=plan, arrs=arrs, x=x: spmm.spmm_bell(plan, x, device_arrays=arrs),
                  plain, plan_bytes=arrays_bytes("bell_spmm", arrs),
                  lanepack=() if plan.spill is None else (plan.spill,), launch=launch,
                  repeat_bits=True, equal_plain=plan.spill is None)
    del fem_plan, arrs

    # B10: the block-tridiagonal 65536^2 matrix, the corpus's blocked_2k
    # size and the dense-block case, bs 128, X of 128 columns
    for name in ("blocked65536", "blocked2048", "dense16384"):
        m = mats[name]
        t0 = time.perf_counter()
        b = BsrMatrix.from_csr(m)
        log(f"plan {name} BsrMatrix.from_csr: nnzb={b.nnzb} empty block rows="
            f"{int(np.sum(np.diff(b.block_offsets) == 0))} {time.perf_counter() - t0:.2f} s")
        arrs = spmm.bcsr_device_arrays(b, dev)
        x_np, x = xblock(m, 128)

        def plain(b=b, arrs=arrs, x=x, m=m):
            xf = torch.zeros((b.bcols * b.bs, 128), device=dev)
            xf[: m.cols] = x
            y = spmm._bcsr_torch(arrs, xf.reshape(b.bcols, b.bs, 128), brows=b.brows)
            return y.reshape(-1, 128)[: m.rows]

        plan_bytes = sum(arrs[key].numel() * arrs[key].element_size()
                         for key in ("blocks_t", "block_cols", "block_offsets", "stream",
                                     "stream_offsets"))
        xf = torch.zeros((b.bcols * b.bs, 128), device=dev)
        xf[: m.cols] = x
        x_sum = xf.sum()
        y = torch.empty((b.brows * b.bs, 128), device=dev)

        def launch(arrs=arrs, xf=xf, x_sum=x_sum, y=y):
            arrs["launch"](x_sum, xf, y)

        chk.check("bcsr_spmm", f"{name}_bs{b.bs}_F128", m, x_np,
                  lambda b=b, arrs=arrs, x=x: spmm.spmm_bcsr(b, x, device_arrays=arrs), plain,
                  plan_bytes=plan_bytes, ulp_plain=True, launch=launch)
        row = chk.cases["bcsr_spmm"][-1]
        row["block_flops"] = 2.0 * b.nnzb * b.bs ** 2 * 128
        row["live_rows"] = int(arrs["stream"].shape[0])
        row["live_flops"] = spmm.bcsr_live_flops(arrs, 128)
        row["live_share"] = row["live_flops"] / row["block_flops"]
        log(f"kernel bcsr_spmm {row['case']}: within 1 ulp of the float64 plain version; "
            f"dense-block work {row['block_flops']:.4g} flop, "
            f"{row['block_flops'] / row['ms'] / 1e9:.2f} TFLOP/s; live-depth stream "
            f"{row['live_rows']} rows, live work {row['live_flops']:.4g} flop (share "
            f"{row['live_share']:.4f}), {row['live_flops'] / row['ms'] / 1e9:.2f} TFLOP/s; "
            f"grid {b.brows * -(-b.bs // kernels.BLOCK_TILE) * (128 // kernels.BLOCK_TILE)} "
            "thread blocks")
        del b, arrs, xf, y

    # B11: U @ U for uniform 8192^2 at 0.2 % in f32 and bf16 storage, the
    # block-tridiagonal 65536^2 matrix squared, uniform 2048^2 at 1 % squared,
    # and the dense-block case squared (every depth row live)
    for case, name, storage in (("uniform8192_f32", "uniform8192", "f32"),
                                ("uniform8192_bf16", "uniform8192", "bf16"),
                                ("blocked65536_f32", "blocked65536", "f32"),
                                ("uniform2048_f32", "uniform2048", "f32"),
                                ("dense16384_f32", "dense16384", "f32")):
        m = mats[name]
        t0 = time.perf_counter()
        eng = BlockSpgemm(m, m, device=dev, storage=storage)
        torch.cuda.synchronize()
        log(f"plan {case} BlockSpgemm: pairs={eng.num_pairs} C blocks={len(eng.c_keys)} "
            f"{time.perf_counter() - t0:.3f} s (block plan, upload and depth stream)")
        chk.check_spgemm(case, m, m, eng, storage=storage)
        del eng
        torch.cuda.empty_cache()
    chk._csr.clear()


def _report_solve(torch, tag, fmt, tol, iterations, rec, true_res, bound_true, wall, step,
                  calls=20):
    """Log iterations, residuals, wall and device ms per iteration and the
    host's share of the wall time (``rec``, ``true_res``, ``bound_true``
    relative to |b|, worst column for multi-RHS solves), and return them.
    ``step`` runs one iteration of the solver's own step function, without
    its host read; ``calls`` of them are queued for the device time (their
    launches must fit the card's launch queue behind the hold)."""
    dev_ms = device_ms_per_call(torch, step, calls=calls)
    it = max(iterations, 1)
    ms_it = wall * 1e3 / it
    log(f"main {tag}: format={fmt} tol={tol:g} iterations={iterations} "
        f"|r|/|b|={rec:.3e} true |b-Ax|/|b|={true_res:.3e} "
        f"(f32 bound eps*cond={bound_true:.3e}) wall {wall:.3f} s, "
        f"{ms_it:.4f} ms/iter, device {dev_ms:.4f} ms/iter, "
        f"host share {max(0.0, 1 - dev_ms / ms_it):.3f}")
    return dict(iterations=iterations, rec=rec, true_res=true_res, wall_s=wall,
                ms_per_iter=ms_it, device_ms_per_iter=dev_ms)


def solve_and_check(torch, dev, tag, a, n, solve, op, tol=CG_TOL, ir=False, precond=None,
                    calls=20):
    """Run ``solve(b)``, check convergence and the true residual, print
    iterations, ms/iteration and the host's share of the wall time; the
    device time is that of ``cg_solve``'s iteration over ``op`` (of
    ``cg_solve_ir``'s inner iteration where ``ir``, of ``pcg_solve``'s
    with ``precond``). Returns the result and the logged numbers."""
    from sparse_matrix_tpu_torch.ops.spmv import spmv_f64_bound
    from sparse_matrix_tpu_torch.solvers import cg

    rng = np.random.default_rng(SEED)
    b_np = rng.standard_normal(a.rows).astype(np.float32)
    b = torch.from_numpy(b_np).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = solve(b)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    bnorm = float(np.linalg.norm(b_np.astype(np.float64)))
    x_np = res.x.cpu().numpy()
    ax, _ = spmv_f64_bound(a, x_np)
    true_res = float(np.linalg.norm(b_np - ax))
    rec = float(res.residual_norm)
    bound_true = EPS_F32 * poisson_cond(n) * bnorm
    ok = (np.all(np.isfinite(x_np)) and rec <= tol * bnorm * (1 + 1e-6)
          and true_res <= bound_true)
    # device time of one iteration: the solver's step, with the host out of
    # the way (device_ms_per_call)
    if precond is not None:
        z = precond(b)
        state = (torch.zeros_like(b), b.clone(), z, torch.dot(b, z))

        def step():
            nonlocal state
            state = cg._pcg_step(op, precond, *state)[:4]
    else:
        step_fn = cg._ir_inner_step if ir else cg._cg_step
        state = (torch.zeros_like(b), b.clone(), b.clone(), torch.dot(b, b))

        def step():
            nonlocal state
            state = step_fn(op, *state)

    nums = _report_solve(torch, tag, op.format, tol, res.iterations, rec / bnorm,
                         true_res / bnorm, bound_true / bnorm, wall, step, calls=calls)
    if not ok:
        raise AssertionError(f"{tag}: CG did not converge within the bounds")
    return res, nums


def solve_multi_and_check(torch, dev, tag, fmt, a, n, mv, pack, unpack, rhs_axis=1):
    """``cg_solve_multi`` over a multi-RHS matvec at K = K_RHS, packed
    (``rhs_axis=1``) or on (n, K) columns (``rhs_axis=-1``): every column
    must reach tol and a true residual within eps * cond * |b_k|."""
    from sparse_matrix_tpu_torch.ops.spmv import spmv_f64_bound
    from sparse_matrix_tpu_torch.solvers import cg

    rng = np.random.default_rng(SEED)
    b_np = rng.standard_normal((a.rows, K_RHS)).astype(np.float32)
    b3 = pack(torch.from_numpy(b_np).to(dev))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = cg.cg_solve_multi(mv, b3, tol=CG_TOL, maxiter=20000, rhs_axis=rhs_axis)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    x_np = unpack(res.x).double().cpu().numpy()
    bnorm = np.linalg.norm(b_np.astype(np.float64), axis=0)
    rec = res.residual_norm.double().cpu().numpy() / bnorm
    ax = np.stack([spmv_f64_bound(a, x_np[:, q])[0] for q in range(K_RHS)], axis=1)
    true_res = np.linalg.norm(b_np - ax, axis=0) / bnorm
    bound_true = EPS_F32 * poisson_cond(n)
    ok = (np.all(np.isfinite(x_np)) and np.all(rec <= CG_TOL * (1 + 1e-6))
          and np.all(true_res <= bound_true))
    # device time of one iteration: cg_solve_multi's step (with the device
    # side of its stopping test), the host out of the way
    colsum, bc = cg._rhs_layout(b3, rhs_axis)
    tol2 = cg._tol2_t(CG_TOL, colsum(b3, b3))
    rs = colsum(b3, b3)
    state = (torch.zeros_like(b3), b3.clone(), b3.clone(), rs, rs > tol2)

    def step():
        nonlocal state
        x, r, p, rs, live = state
        live.any()
        state = cg._cg_multi_step(mv, colsum, bc, tol2, live, x, r, p, rs)

    _report_solve(torch, tag, fmt, CG_TOL, res.iterations, float(rec.max()),
                  float(true_res.max()), bound_true, wall, step)
    if not ok:
        raise AssertionError(f"{tag}: multi-RHS CG did not converge within the bounds "
                             f"(|r|/|b| {rec}, true {true_res})")


def part_slice1(torch, dev, mats, ops, state):
    from sparse_matrix_tpu_torch.entry import entry
    from sparse_matrix_tpu_torch.ops.operator import SpmvOperator
    from sparse_matrix_tpu_torch.solvers.cg import cg_solve, cg_solve_ir

    a2 = mats["poisson2048"]
    op = ops["poisson2048"]
    _, state["cg_poisson2048"] = solve_and_check(
        torch, dev, "cg poisson2048 dia f32", a2, 2048,
        lambda b: cg_solve(op, b, tol=CG_TOL, maxiter=20000), op)

    op_lo = SpmvOperator(a2, device=dev, values_dtype=torch.bfloat16)
    if op_lo.format != "dia":
        raise AssertionError(f"bf16 operator dispatched to {op_lo.format}")
    solve_and_check(torch, dev, "cg_ir poisson2048 dia bf16", a2, 2048,
                    # the inner cap must let the bf16 inner CG reach its 1e-2
                    # target at this grid size (the default 200 stalls it)
                    lambda b: cg_solve_ir(op, op_lo, b, tol=IR_TOL, maxiter=20000,
                                          inner_maxiter=5000),
                    op_lo, tol=IR_TOL, ir=True)
    del op_lo

    a1 = mats["poisson1024"]
    op_a = ops["poisson1024_aligned"]
    solve_and_check(torch, dev, "cg poisson1024 aligned", a1, 1024,
                    lambda b: cg_solve(op_a, b, tol=CG_TOL, maxiter=10000), op_a)

    a5 = mats["poisson512"]
    op_b = SpmvOperator(a5, device=dev, force="bell")
    solve_and_check(torch, dev, "cg poisson512 bell", a5, 512,
                    lambda b: cg_solve(op_b, b, tol=CG_TOL, maxiter=10000), op_b)

    step, args = entry(dev)
    x1, p1, r1, rs1 = step(*args)
    step_cpu, args_cpu = entry("cpu")
    rs_cpu = float(step_cpu(*args_cpu)[3])
    if not (math.isfinite(float(rs1)) and abs(float(rs1) - rs_cpu) <= 1e-5 * rs_cpu):
        raise AssertionError(f"entry step: rs {float(rs1)} vs plain {rs_cpu}")
    log(f"main entry step: rs {float(rs1):.6f} (plain on the CPU {rs_cpu:.6f})")


def _class_apply(torch, dev, name, m, op, x_np, **bound_kw):
    from sparse_matrix_tpu_torch.ops.spmv import spmv_f64_bound

    x = torch.from_numpy(x_np).to(dev)
    for _ in range(10):
        y = op(x)
    y64, bound = spmv_f64_bound(m, x_np, **bound_kw)
    if not np.all(np.abs(y.cpu().numpy() - y64) <= bound):
        raise AssertionError(f"{name}: {op.format} operator off the f64 oracle")
    return cuda_ms(torch, lambda: op(x))


def part_classes(torch, dev, mats, ops):
    from sparse_matrix_tpu_torch.ops.operator import SpmvOperator

    rng = np.random.default_rng(SEED)
    # the bench's class rows through automatic dispatch (the operators
    # were planned before the kernel phase; their plan times are logged)
    for name in ("femlike_262k", "randlocal_262k", "powerlaw_262k"):
        m = mats[name]
        op = ops[name]
        x_np = rng.standard_normal(m.cols).astype(np.float32)
        st = plan_of(op, "stripe")
        ms = _class_apply(torch, dev, name, m, op, x_np,
                          stripe=() if st is None else (st,))
        cfg = "" if st is None else f" {st.mode}(L={st.levels}, KW={st.kw})"
        log(f"main class {name}: format={op.format}{cfg} {ms:.4f} ms/apply, "
            f"{m.nnz() / ms / 1e6:.2f} Gnnz/s")
    # and through forced LanePack operators (the general fallback)
    for name in ("femlike_262k", "randlocal_262k", "powerlaw_262k"):
        m = mats[name]
        opc = SpmvOperator(m, device=dev, force="lanepack")
        x_np = rng.standard_normal(m.cols).astype(np.float32)
        lp = plan_of(opc, "lanepack")
        ms = _class_apply(torch, dev, name, m, opc, x_np, lanepack=(lp,))
        log(f"main class {name} forced: format={opc.format} kw={lp.kw} "
            f"pack={lp.pack} {ms:.4f} ms/apply, {m.nnz() / ms / 1e6:.2f} Gnnz/s")


def part_multi_rhs(torch, dev, mats, ops):
    from sparse_matrix_tpu_torch.ops import spmm, spmv_dia
    from sparse_matrix_tpu_torch.ops.spmv import spmv_f64_bound

    rng = np.random.default_rng(SEED)
    for name, opname in (("poisson2048", "poisson2048"), ("poisson1024", "poisson1024_aligned")):
        m, op = mats[name], ops[opname]
        x_np = rng.standard_normal((m.cols, K_RHS)).astype(np.float32)
        x = torch.from_numpy(x_np).to(dev)
        y = op.matmat(x).double().cpu().numpy()
        for q in range(K_RHS):
            y64, bound = spmv_f64_bound(m, x_np[:, q])
            if not np.all(np.abs(y[:, q] - y64) <= bound):
                raise AssertionError(f"{name}: matmat column {q} off the f64 oracle")
        ms = cuda_ms(torch, lambda: op.matmat(x), reps=10, warmup=3)
        log(f"main matmat {name}: format={op.format} K={K_RHS} {ms:.4f} ms "
            f"(packing included), {m.nnz() * K_RHS / ms / 1e6:.2f} Gnnz/s")

    a2 = mats["poisson2048"]
    part = ops["poisson2048"].part("dia")
    dia = part.plan
    solve_multi_and_check(
        torch, dev, f"cg_multi poisson2048 dia K={K_RHS}", "dia packed", a2, 2048,
        spmv_dia.dia_matvec_multi(dia, K_RHS, dev, device_arrays=part.arrays),
        lambda b: spmv_dia.dia_pack_rhs(dia, b), lambda x3: spmv_dia.dia_unpack_rhs(dia, x3))
    a1 = mats["poisson1024"]
    al = ops["poisson1024_aligned"].part("aligned")
    solve_multi_and_check(
        torch, dev, f"cg_multi poisson1024 aligned K={K_RHS}", "aligned packed", a1, 1024,
        spmm.aligned_matvec_multi(al.plan, K_RHS, dev, device_arrays=al.arrays),
        lambda b: spmm.pack_rhs(b, a1.cols), lambda x3: spmm.unpack_rhs(x3, a1.rows))


def _matmat_check(torch, dev, name, m, op, rng, **bound_kw):
    """``op.matmat`` at K = K_RHS, column by column within the f64 bound;
    logs its time (packing included)."""
    from sparse_matrix_tpu_torch.ops.spmv import spmv_f64_bound

    x_np = rng.standard_normal((m.cols, K_RHS)).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)
    y = op.matmat(x).double().cpu().numpy()
    for q in range(K_RHS):
        y64, bound = spmv_f64_bound(m, x_np[:, q], **bound_kw)
        if not np.all(np.abs(y[:, q] - y64) <= bound):
            raise AssertionError(f"{name}: {op.format} matmat column {q} off the f64 oracle")
    ms = cuda_ms(torch, lambda: op.matmat(x), reps=10, warmup=3)
    log(f"main matmat {name}: format={op.format} K={K_RHS} {ms:.4f} ms "
        f"(packing included), {m.nnz() * K_RHS / ms / 1e6:.2f} Gnnz/s")


def part_general_multi_rhs(torch, dev, mats, ops):
    from sparse_matrix_tpu_torch.ops import spmm

    rng = np.random.default_rng(SEED + 4)
    for name, opname in (("poisson1024", "poisson1024_lanepack"),
                         ("poisson1024", "poisson1024_bell"),
                         ("randlocal_262k", "randlocal_262k_lanepack"),
                         ("randlocal_262k", "randlocal_262k_aligned")):
        op = ops[opname]
        lp = () if op.part("lanepack") is None else (plan_of(op, "lanepack"),)
        for fmt in ("aligned", "bell"):
            if op.part(fmt) is not None and plan_of(op, fmt).spill is not None:
                lp = (plan_of(op, fmt).spill,)
        _matmat_check(torch, dev, f"{name} {opname.split('_')[-1]}", mats[name], op, rng,
                      lanepack=lp)

    a1 = mats["poisson1024"]
    lp = ops["poisson1024_lanepack"].part("lanepack")
    kw = lp.plan.kw
    solve_multi_and_check(
        torch, dev, f"cg_multi poisson1024 lanepack K={K_RHS}", "lanepack packed", a1, 1024,
        spmm.lanepack_matvec_multi(lp.plan, K_RHS, dev, device_arrays=lp.arrays),
        lambda b: spmm.pack_rhs(b, a1.cols, guard=kw), lambda x3: spmm.unpack_rhs(x3, a1.rows))
    a5 = mats["poisson512"]
    solve_multi_and_check(
        torch, dev, f"cg_multi poisson512 bell matmat K={K_RHS}", "bell", a5, 512,
        ops["poisson512_bell"].matmat, lambda b: b, lambda x: x, rhs_axis=-1)


def part_block_sparse(torch, dev, mats, ops):
    from sparse_matrix_tpu_torch.formats.bcsr import BsrMatrix
    from sparse_matrix_tpu_torch.ops.device_sorted import padded_to_host
    from sparse_matrix_tpu_torch.ops.spgemm_block import (
        BlockSpgemm,
        block_pairs_plan,
        spgemm_block_device,
    )
    from sparse_matrix_tpu_torch.ops.spmm import spmm_bcsr
    from sparse_matrix_tpu_torch.ops.spmv import spmv_f64_bound

    u = mats["uniform8192"]
    t0 = time.perf_counter()
    ub = BsrMatrix.from_csr(u)
    t1 = time.perf_counter()
    pairs = block_pairs_plan(ub, ub)
    log(f"main plan uniform8192: BsrMatrix.from_csr {t1 - t0:.3f} s, block_pairs_plan "
        f"{time.perf_counter() - t1:.3f} s ({len(pairs[0])} pairs)")
    del ub, pairs
    for storage in ("f32", "bf16"):
        t0 = time.perf_counter()
        eng = BlockSpgemm(u, u, device=dev, storage=storage)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        c = eng.multiply()
        t2 = time.perf_counter()
        ratio = spgemm_f64_check(u, u, c, bf16=storage == "bf16", tag=f"main uniform8192 {storage}",
                                 limit=1.0 if storage == "bf16" else B11_ERR_LIMIT)
        # multiply() once more, itemized: numeric phase, device sparsify,
        # live-prefix readback and host CSR
        t3 = time.perf_counter()
        blocks = eng.multiply_device()
        torch.cuda.synchronize()
        t4 = time.perf_counter()
        p = eng.multiply_coo(blocks)
        torch.cuda.synchronize()
        t5 = time.perf_counter()
        padded_to_host(p)
        t6 = time.perf_counter()
        log(f"main BlockSpgemm uniform8192 {storage}: nnz(C)={c.nnz()} plan+upload "
            f"{t1 - t0:.3f} s, multiply {t2 - t1:.3f} s (again, itemized: numeric phase "
            f"{t4 - t3:.3f} s, device sparsify {t5 - t4:.3f} s, readback of {c.nnz()} "
            f"entries and host CSR {t6 - t5:.3f} s), max err/bound {ratio:.3f}")
        del eng, c, blocks, p
        torch.cuda.empty_cache()

    b = mats["blocked65536"]
    t0 = time.perf_counter()
    c = spgemm_block_device(b, b, device=dev)
    t1 = time.perf_counter()
    ratio = spgemm_f64_check(b, b, c, bf16=False, tag="main blocked65536", limit=B11_ERR_LIMIT)
    log(f"main spgemm_block_device blocked65536: nnz(C)={c.nnz()} {t1 - t0:.3f} s (plan, "
        f"kernel, device sparsify, live-prefix readback), max err/bound {ratio:.3f}")
    del c

    t0 = time.perf_counter()
    bb = BsrMatrix.from_csr(b)
    t1 = time.perf_counter()
    x_np = np.random.default_rng(SEED + 5).standard_normal((b.cols, 128)).astype(np.float32)
    x = torch.from_numpy(x_np).to(dev)
    y = spmm_bcsr(bb, x).double().cpu().numpy()
    t2 = time.perf_counter()
    for q in range(x_np.shape[1]):
        y64, bound = spmv_f64_bound(b, x_np[:, q])
        if not np.all(np.abs(y[:, q] - y64) <= bound):
            raise AssertionError(f"spmm_bcsr blocked65536: column {q} off the f64 oracle")
    log(f"main spmm_bcsr blocked65536 F=128: BsrMatrix.from_csr {t1 - t0:.3f} s, apply "
        f"(upload, kernel, readback) {t2 - t1:.3f} s")



class F64Product:
    """The float64 product of two float32 operands, for holding a SpGEMM
    result to it entry by entry on the union of both patterns with the
    bound ``(n_ij + 2) * u * (|A||B|)_ij``. ``C64``, ``|A||B|`` and the
    product counts ``n_ij`` come from three ``scipy.sparse`` float64
    products (the structural pattern is that of ``n_ij``: scipy drops the
    exact zeros of ``C64``, the counts are never zero)."""

    def __init__(self, lhs, rhs):
        import scipy.sparse as sp

        def s(m, v):
            return sp.csr_matrix((v, m.indices.astype(np.int64), m.offsets.astype(np.int64)),
                                 shape=(m.rows, m.cols))

        a = lhs.vals.astype(np.float32).astype(np.float64)
        b = rhs.vals.astype(np.float32).astype(np.float64)
        n = s(lhs, np.ones_like(a)) @ s(rhs, np.ones_like(b))
        self.cols = rhs.cols
        self.keys = self._keys(n)
        self.count = n.data
        self.c64 = self._on_keys(s(lhs, a) @ s(rhs, b))
        self.mag = self._on_keys(s(lhs, np.abs(a)) @ s(rhs, np.abs(b)))

    def _keys(self, mat):
        mat.sort_indices()
        return (np.repeat(np.arange(mat.shape[0], dtype=np.int64), np.diff(mat.indptr))
                * self.cols + mat.indices)

    def _on_keys(self, mat):
        out = np.zeros(self.keys.size)
        out[np.searchsorted(self.keys, self._keys(mat))] = mat.data
        return out

    def ratio(self, c) -> float:
        """The largest error / bound of host CSR ``c`` (inf for an entry
        outside the structural pattern)."""
        got_keys = c.row_ids() * c.cols + c.indices.astype(np.int64)
        got = np.zeros(self.keys.size)
        if got_keys.size == self.keys.size and np.array_equal(got_keys, self.keys):
            got[:] = c.vals
        else:
            pos = np.searchsorted(self.keys, got_keys)
            if np.any(pos >= self.keys.size) or np.any(
                    self.keys[np.minimum(pos, self.keys.size - 1)] != got_keys):
                return float("inf")
            got[pos] = c.vals
        bound = (self.count + 2) * U_F32 * self.mag
        err = np.abs(got - self.c64)
        if np.any(err[bound == 0] > 0):
            return float("inf")
        return float(np.max(err / np.where(bound == 0, 1.0, bound), initial=0.0))

    def check(self, c, tag: str) -> float:
        ratio = self.ratio(c)
        if not ratio <= 1.0:
            raise AssertionError(f"{tag}: off the f64 oracle (max err/bound {ratio})")
        return ratio


def _with_vals(m, vals):
    from sparse_matrix_tpu_torch.formats.csr import CsrMatrix

    return CsrMatrix(m.rows, m.cols, vals, m.indices, m.offsets, is_sorted=m.is_sorted)


def _f32(m):
    return _with_vals(m, m.vals.astype(np.float32))


def _timed(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def block_bytes_estimate(m, bs=128) -> int:
    """Bytes of the dense f32 blocks of ``m`` at block size ``bs``."""
    keys = m.row_ids() // bs * (-(-m.cols // bs)) + m.indices.astype(np.int64) // bs
    return int(np.unique(keys).size) * bs * bs * 4


def time_engines(torch, dev, name, m, oracle, skip=()):
    """Host seconds of each SpGEMM engine that fits this product (the data
    for an H100 calibration of spgemm_auto), each result checked: the host
    library's hash engine once, band convolution where banded, the dense matmul to 16384
    rows, the dense-block engine to 4 GB of blocks, the ESC sort engine."""
    from sparse_matrix_tpu_torch.formats.dia import try_dia_from_csr
    from sparse_matrix_tpu_torch.ops.device_sorted import EscSpgemm
    from sparse_matrix_tpu_torch.ops.spgemm_block import spgemm_block_device, spgemm_dense
    from sparse_matrix_tpu_torch.ops.spgemm_dia import spgemm_dia
    from sparse_matrix_tpu_torch.ops.spgemm_host import spgemm_hash_host

    products = int(np.diff(m.offsets)[m.indices].sum())
    engines = {"host": lambda: spgemm_hash_host(m, m)}
    d = try_dia_from_csr(m)
    if d is not None:
        engines["dia"] = lambda: spgemm_dia(d, d, device=dev).to_csr()
    if m.rows <= 16384:
        engines["dense"] = lambda: spgemm_dense(m, m, device=dev)
    if 2 * block_bytes_estimate(m) <= 4 << 30:
        engines["mxu"] = lambda: spgemm_block_device(m, m, device=dev)
    engines["esc"] = lambda: EscSpgemm(m, m, device=dev, reduce="sort").multiply()
    times = {}
    for eng, fn in engines.items():
        if eng in skip:
            continue
        c, t = _timed(torch, fn)
        ratio = oracle.check(c, f"{name} {eng}")
        times[eng] = t
        log(f"main engine {name} {eng}: {t:.3f} s (plan, upload, product, readback), "
            f"nnz(C)={c.nnz()}, {products / t / 1e6:.2f} Mprod/s, max err/bound {ratio:.3f}")
        del c
        torch.cuda.empty_cache()
    return times


def esc_phases(torch, eng):
    """CUDA-event ms of ``EscSpgemm.multiply_device`` with the sort
    reduction planned once, its device time with no host gaps, and its two
    launches (the expansion, B12, and the run sums), beside the per-call
    sort path of earlier slices on the same products (expansion, then
    ``_packed_reduce_presort``: key sort, gather by the sort order, run
    reduce), with that path's sort and gather-and-reduce alone."""
    from sparse_matrix_tpu_torch.ops.device_sorted import (
        _packed_reduce_presort,
        _packed_run_reduce,
    )
    from sparse_matrix_tpu_torch.ops.esc_expand import expand_products

    xp, runs = eng._xplan, eng._runs

    def expand():
        return expand_products(xp, eng.lhs_vals_csc, eng.rhs_vals,
                               device_arrays=eng._expand_arrs)

    p = expand()
    val = torch.empty_like(p)
    key = torch.from_numpy(xp.out_key).to(p.device)
    k_s, order = torch.sort(key, stable=True)
    out = dict(
        multiply_device_ms=cuda_ms(torch, eng.multiply_device, reps=10, warmup=2),
        multiply_device_device_ms=device_ms_per_call(torch, eng.multiply_device),
        expand_ms=cuda_ms(torch, expand, reps=10, warmup=2),
        run_sum_ms=cuda_ms(torch, lambda: runs["launch"](p, val), reps=10, warmup=2),
        old_multiply_ms=cuda_ms(torch, lambda: _packed_reduce_presort(key, expand(), eng.rows,
                                                                      eng.cols),
                                reps=10, warmup=2),
        old_sort_ms=cuda_ms(torch, lambda: torch.sort(key, stable=True), reps=10, warmup=2),
        old_reduce_ms=cuda_ms(torch, lambda: _packed_run_reduce(k_s, p[order], eng.rows,
                                                                eng.cols),
                              reps=10, warmup=2),
    )
    del p, val, key, k_s, order
    return out


def _check_reduction(engine, x, c, oracle, tag: str) -> float:
    """An SpMV reduction's host result ``c`` (``ReduceSpmv`` or
    ``FixedSideSpgemm`` applied to ``x``) within the SpMV bound of its
    selection matrix, and within the SpGEMM bound too unless that matrix
    runs a scan-mode or windowed format, whose sums carry their chunk's
    mass (ROADMAP C14). Returns the SpGEMM err/bound."""
    from sparse_matrix_tpu_torch.ops.spgemm_spmv import reduce_f64_bound

    y64, bound = reduce_f64_bound(engine, x)
    if not np.all(np.abs(c.vals - y64) <= bound):
        raise AssertionError(f"{tag}: off its SpMV bound")
    if engine.op.format in ("lanepack", "stripe", "bell"):
        return oracle.ratio(c)
    return oracle.check(c, tag)


def part_spgemm(torch, dev, mats, ops, state):
    """Part f: the SpGEMM dispatch and engines (slice 4). Keeps the ESC
    engines it built in ``state`` for the expansion kernel's checks."""
    from sparse_matrix_tpu_torch.formats.device import DeviceCsr
    from sparse_matrix_tpu_torch.ops.device_sorted import (
        EscSpgemm,
        add_device,
        padded_to_host,
        transpose_device,
    )
    from sparse_matrix_tpu_torch.ops.spgemm_block import (
        BlockSpgemm,
        spgemm_auto_engine,
        spgemm_cost_estimates,
    )
    from sparse_matrix_tpu_torch.ops.esc_expand import expand_products
    from sparse_matrix_tpu_torch.ops.spgemm_spmv import FixedSideSpgemm

    rng = np.random.default_rng(SEED + 6)
    esc = state.setdefault("esc", {})

    # 1. A @ A through CsrMatrix.__matmul__ -> spgemm_auto on the card
    for name in ("poisson2048", "femlike_262k", "uniform8192"):
        m = _f32(mats[name])
        t0 = time.perf_counter()
        oracle = F64Product(m, m)
        log(f"main oracle {name}: scipy float64 products {time.perf_counter() - t0:.2f} s")
        engine = spgemm_auto_engine(m, m)
        costs = spgemm_cost_estimates(m, m)
        c, t = _timed(torch, lambda: m @ m)
        ratio = oracle.check(c, f"{name} A @ A")
        log(f"main A @ A {name}: engine={engine} costs(s)={json.dumps(costs)} {t:.3f} s, "
            f"nnz(C)={c.nnz()}, max err/bound {ratio:.3f}")
        del c
        skip = {engine} | ({"esc"} if name == "femlike_262k" else set())  # esc: timed in 2
        times = time_engines(torch, dev, name, m, oracle, skip=skip)
        times[engine] = t
        state.setdefault("engine_s", {})[name] = dict(taken=engine, costs=costs, seconds=times)
        del oracle

    # 2. the ESC sort engine on the 262k classes, re-multiplied with fresh values
    for name in ("femlike_262k", "randlocal_262k"):
        m = _f32(mats[name])
        t0 = time.perf_counter()
        eng = EscSpgemm(m, m, device=dev, reduce="sort")
        torch.cuda.synchronize()
        plan_s = time.perf_counter() - t0
        c, mult_s = _timed(torch, eng.multiply)
        oracle = F64Product(m, m)
        ratio = oracle.check(c, f"{name} EscSpgemm")
        phases = esc_phases(torch, eng)
        a_t, b_t = library_csr(torch, m, dev), library_csr(torch, m, dev)
        lib_ms = cuda_ms(torch, lambda: torch.sparse.mm(a_t, b_t), reps=5, warmup=1)
        del a_t, b_t
        nv = rng.standard_normal(m.nnz()).astype(np.float32)
        c2 = padded_to_host(eng.multiply_device(lhs_vals=torch.from_numpy(nv).to(dev)))
        ratio2 = F64Product(_with_vals(m, nv), m).check(c2, f"{name} EscSpgemm re-multiply")
        log(f"main EscSpgemm {name} sort: products={eng.num_products} nnz(C)={c.nnz()} "
            f"plan {plan_s:.3f} s (host), multiply() {mult_s:.3f} s, "
            f"multiply_device {phases['multiply_device_ms']:.4f} ms (device "
            f"{phases['multiply_device_device_ms']:.4f}; expansion {phases['expand_ms']:.4f}, "
            f"run sums {phases['run_sum_ms']:.4f}); the per-call sort path "
            f"{phases['old_multiply_ms']:.4f} ms (sort {phases['old_sort_ms']:.4f}, gather and "
            f"run reduce {phases['old_reduce_ms']:.4f}); torch.sparse.mm {lib_ms:.4f} ms; "
            f"{eng.num_products / phases['multiply_device_ms'] / 1e6:.2f} Gprod/s; max "
            f"err/bound {ratio:.3f}, re-multiply with fresh lhs values {ratio2:.3f}")
        esc[name] = (m, eng)
        state.setdefault("esc_rows", []).append(dict(
            case=name, products=eng.num_products, nnz_c=c.nnz(), plan_s=plan_s,
            multiply_s=mult_s, library_ms=lib_ms, **phases))
        del c, c2, oracle
        torch.cuda.empty_cache()

    # 3. uniform 8192: the SpMV reduction (reduce="auto") and FixedSideSpgemm
    u = _f32(mats["uniform8192"])
    t0 = time.perf_counter()
    eng = EscSpgemm(u, u, device=dev)
    plan_s = time.perf_counter() - t0
    red = eng._rspmv
    if red is None:
        raise AssertionError("uniform8192: reduce='auto' did not take the SpMV reduction")
    p = expand_products(eng._xplan, eng.lhs_vals_csc, eng.rhs_vals,
                        device_arrays=eng._expand_arrs).cpu().numpy()
    oracle = F64Product(u, u)
    ratio = _check_reduction(red, p, eng.multiply(), oracle, "uniform8192 EscSpgemm spmv")
    ms = cuda_ms(torch, eng.multiply_device, reps=10, warmup=2)
    log(f"main EscSpgemm uniform8192 auto: reduce=spmv selection {red.op.format} "
        f"{red.selection.rows}x{red.selection.cols} nnz={red.selection.nnz()}, plan "
        f"{plan_s:.3f} s, multiply_device {ms:.4f} ms, within the SpMV bound; SpGEMM "
        f"err/bound {ratio:.3g} (C14)")
    esc["uniform8192"] = (u, eng)
    t0 = time.perf_counter()
    fs = FixedSideSpgemm(u, u, device=dev, fixed="lhs")
    plan_s = time.perf_counter() - t0
    ratio = _check_reduction(fs, u.vals, fs.multiply(), oracle, "uniform8192 FixedSideSpgemm")
    ms = cuda_ms(torch, fs.multiply_device, reps=10, warmup=2)
    log(f"main FixedSideSpgemm uniform8192 lhs: selection {fs.op.format} nnz="
        f"{fs.selection.nnz()}, plan {plan_s:.3f} s, multiply_device {ms:.4f} ms, within "
        f"the SpMV bound; SpGEMM err/bound {ratio:.3g}")
    del fs, p, oracle

    # 4. the hyper-sparse open cell: uniform 16384 at 0.015 %
    h = _f32(mats["uniform16384"])
    oracle = F64Product(h, h)
    t0 = time.perf_counter()
    eng = EscSpgemm(h, h, device=dev, reduce="sort")
    esc_plan = time.perf_counter() - t0
    c, esc_mult = _timed(torch, eng.multiply)
    ratio_e = oracle.check(c, "uniform16384 EscSpgemm")
    esc_ms = cuda_ms(torch, eng.multiply_device, reps=10, warmup=2)
    esc["uniform16384"] = (h, eng)
    t0 = time.perf_counter()
    blk = BlockSpgemm(h, h, device=dev)
    torch.cuda.synchronize()
    blk_plan = time.perf_counter() - t0
    cb, blk_mult = _timed(torch, blk.multiply)
    ratio_b = oracle.check(cb, "uniform16384 BlockSpgemm")
    blk_ms = cuda_ms(torch, blk.multiply_device, reps=2, warmup=1)
    a_t = library_csr(torch, h, dev)
    lib_ms = cuda_ms(torch, lambda: torch.sparse.mm(a_t, a_t), reps=10, warmup=2)
    cell = dict(products=eng.num_products, pairs=blk.num_pairs, nnz_c=c.nnz(),
                esc_plan_s=esc_plan, esc_multiply_s=esc_mult, esc_multiply_device_ms=esc_ms,
                block_plan_s=blk_plan, block_multiply_s=blk_mult,
                block_multiply_device_ms=blk_ms, library_ms=lib_ms)
    state["hyper_sparse"] = cell
    log(f"main open cell uniform16384 0.015%: products={eng.num_products} "
        f"pairs={blk.num_pairs} nnz(C)={c.nnz()}; EscSpgemm plan {esc_plan:.3f} s, "
        f"multiply() {esc_mult:.3f} s, multiply_device {esc_ms:.4f} ms (err/bound "
        f"{ratio_e:.3f}); BlockSpgemm plan {blk_plan:.3f} s, multiply() {blk_mult:.3f} s, "
        f"multiply_device {blk_ms:.4f} ms (err/bound {ratio_b:.3f}); torch.sparse.mm "
        f"{lib_ms:.4f} ms")
    del blk, cb, c, a_t, oracle
    torch.cuda.empty_cache()

    # 5. device transpose and add on femlike_262k, equal to the host forms
    m = _f32(mats["femlike_262k"])
    d = DeviceCsr.from_host(m, device=dev)
    dt = transpose_device(d)
    t_host = m.transpose()
    got_t = dt.to_host()
    s = padded_to_host(add_device(d, dt))
    want_s = m + t_host
    for tag, got, want in (("transpose_device", got_t, t_host), ("add_device", s, want_s)):
        for f in ("offsets", "indices", "vals"):
            if not np.array_equal(getattr(got, f), getattr(want, f)):
                raise AssertionError(f"femlike_262k {tag}: {f} differs from the host form")
    t_ms = cuda_ms(torch, lambda: transpose_device(d), reps=10, warmup=2)
    a_ms = cuda_ms(torch, lambda: add_device(d, dt), reps=10, warmup=2)
    log(f"main device ops femlike_262k: transpose_device {t_ms:.4f} ms, add_device "
        f"(A + A^T, nnz {s.nnz()}) {a_ms:.4f} ms, both equal to the host forms")


def phase_esc_kernel(torch, dev, chk, mats, state):
    """The ESC expansion kernel (B12) on the plans part f built (planned
    here where part f did not): bit-equal to both plain versions, the lane
    form ``_expand_torch`` (its int16 lanes uploaded here for this check
    only: the engine keeps none) on the real slots with zero padding, and
    the segment schedule ``_expand_segments_torch`` on every slot; equal
    bits on two calls and through the permutation with CSR-order lhs
    values. Times: the call through ``expand_products`` (``ms``), the bare
    launch through the engine's launch record and its device time with no
    host gaps (also with CSR-order lhs values), both plain versions and
    the reference gather engine's expansion (``lhs_vals[src] *
    rhs_vals[q]``, two torch gathers and a multiply: the yardstick, no
    single PyTorch call computes the expansion); the bound: A and B once
    in CSR (f32 values, int32 indices and offsets) and 4 bytes a product
    written, over 3.35 TB/s.

    Then, on the engines with the sort reduction, the run-sum kernel on
    the kernel's products: bit-equal to its plain version on the CPU
    (sequential adds in sorted order) and on two calls; times through the
    launch record (with val's allocation), its device time, the plain
    version on the card and, as the library call, one ``index_add_`` of
    the products into a zero vector by each slot's run (atomic, in no
    fixed order); the bound: the real products and their order read once,
    the run offsets, val written once, one add a product."""
    from sparse_matrix_tpu_torch.native.kernels import ESC_SEG_STAGE, ESC_STAGE
    from sparse_matrix_tpu_torch.ops.device_sorted import EscSpgemm, expand_plan
    from sparse_matrix_tpu_torch.ops.esc_expand import (
        _expand_segments_torch,
        _expand_torch,
        expand_device_arrays,
        expand_products,
    )

    for name in ("femlike_262k", "randlocal_262k", "uniform8192", "uniform16384"):
        if name in state["esc"]:
            m, eng = state["esc"][name]
        else:
            m = _f32(mats[name])
            eng = EscSpgemm(m, m, device=dev, reduce="sort")
        xp, arrs = eng._xplan, eng._expand_arrs
        lv, rv = eng.lhs_vals_csc, eng.rhs_vals
        n, slots = xp.num_products, xp.num_slabs * 1024
        lv_csr = torch.from_numpy(m.vals).to(dev)
        p_buf = torch.empty(slots, device=dev)
        lanes = expand_device_arrays(xp, dev)

        def kernel(xp=xp, arrs=arrs, lv=lv, rv=rv):
            return expand_products(xp, lv, rv, device_arrays=arrs)

        def launch(arrs=arrs, lv=lv, rv=rv, p=p_buf):
            arrs["launch"](lv, rv, p)

        def launch_csr(arrs=arrs, lv=lv_csr, rv=rv, p=p_buf):
            arrs["launch"](lv, rv, p, csr_order=True)

        def plain(lanes=lanes, lv=lv, rv=rv, n=n):
            return _expand_torch(lv, rv, lanes["lv_lane"], lanes["rv_lane"], lanes["lv_off"],
                                 lanes["rv_off"], num_products=n)

        def plain_segments(arrs=arrs, lv=lv, rv=rv, n=n, slots=slots):
            return _expand_segments_torch(lv, rv, arrs["segments"], num_products=n,
                                          num_slots=slots)

        pk, pk2, pp = kernel(), kernel(), plain()
        pf = expand_products(xp, lv_csr, rv, device_arrays=arrs, csr_order=True)
        torch.cuda.synchronize()
        if not (torch.equal(pk[:n], pp[:n]) and not bool(pk[n:].any())):
            raise AssertionError(f"esc_expand/{name}: kernel and plain version differ")
        del pp
        if not torch.equal(pk, plain_segments()):
            raise AssertionError(f"esc_expand/{name}: kernel and segment-order plain version "
                                 "differ")
        if not (torch.equal(pk, pk2) and torch.equal(pk, pf)):
            raise AssertionError(f"esc_expand/{name}: two calls, or CSR-order lhs values, give "
                                 "other bits")
        del pk2, pf
        ms = cuda_ms(torch, kernel)
        launch_ms = cuda_ms(torch, launch)
        device_ms = device_ms_per_call(torch, launch)
        csr_device_ms = device_ms_per_call(torch, launch_csr)
        plain_ms = cuda_ms(torch, plain)
        del lanes
        segments_ms = cuda_ms(torch, plain_segments)
        src, q, _ = expand_plan(m, m)
        src = torch.from_numpy(src).to(dev).long()
        q = torch.from_numpy(q).to(dev).long()
        yard_ms = cuda_ms(torch, lambda: lv_csr[src] * rv[q])
        del src, q
        nbytes = 2 * (m.nnz() * 8 + (m.rows + 1) * 4) + 4 * n
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n / F32_FLOP_PER_S * 1e3
        tiles = arrs["tiles"].cpu().numpy()
        # the tiles whose windows and segment starts the kernel stages
        staged = float(np.mean((tiles[:, 2] - tiles[:, 1] <= ESC_STAGE)
                               & (tiles[:, 4] - tiles[:, 3] <= ESC_STAGE)
                               & (tiles[:, 5] - tiles[:, 0] + 2 <= ESC_SEG_STAGE)))
        row = dict(case=name, rows=m.rows, nnz=m.nnz(), products=n, slabs=xp.num_slabs,
                   segments=int(arrs["segments"].shape[0] - 1), tiles=int(tiles.shape[0]),
                   staged_tile_share=staged, max_abs_err=0.0, ms=ms, launch_ms=launch_ms,
                   device_ms=device_ms, csr_order_device_ms=csr_device_ms, plain_ms=plain_ms,
                   plain_segments_ms=segments_ms, library_ms=None, yardstick_ms=yard_ms,
                   yardstick="the gather engine's expansion lhs_vals[src] * rhs_vals[q]: two "
                             "torch gathers and a multiply (no single PyTorch call)",
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=int(nbytes), flops=float(n), bitwise_plain=True, bitwise_repeat=True)
        chk.cases["esc_expand"].append(row)
        log(f"kernel esc_expand   {name:34s} rows={m.rows} nnz={m.nnz()} products={n} "
            f"segments={row['segments']} tiles={row['tiles']} (staged {staged:.3f}) bit-equal "
            f"to both plain versions and on two calls; kernel {ms:.4f} ms, bare launch "
            f"{launch_ms:.4f}, device {device_ms:.4f} (CSR-order lhs {csr_device_ms:.4f}), plain "
            f"{plain_ms:.4f}, segment-order plain {segments_ms:.4f}, gather yardstick "
            f"{yard_ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({nbytes} bytes / 3.35 TB/s), "
            f"{n / device_ms / 1e6:.2f} Gprod/s on the device")
        if eng._rspmv is None:
            check_run_sum(torch, chk, name, eng, pk)
        del pk, p_buf, lv_csr
    state["esc"].clear()
    torch.cuda.empty_cache()


def check_run_sum(torch, chk, name, eng, p):
    """The run-sum kernel of ``eng``'s planned sort reduction on the
    products ``p`` (see :func:`phase_esc_kernel`)."""
    from sparse_matrix_tpu_torch.ops.device_sorted import _sum_runs_torch

    runs = eng._runs
    order, run_off = runs["order"], runs["run_off"]
    cap, n, nnz = p.numel(), eng.num_products, runs["num_summed"]
    v1, v2 = torch.empty_like(p), torch.empty_like(p)
    runs["launch"](p, v1)
    runs["launch"](p, v2)
    want = _sum_runs_torch(p.cpu(), order.cpu(), run_off.cpu())
    torch.cuda.synchronize()
    if not (torch.equal(v1, v2) and torch.equal(v1.cpu(), want)):
        raise AssertionError(f"esc_run_sum/{name}: two calls or the plain version on the CPU "
                             "give other bits")
    lens = (run_off[1:] - run_off[:-1]).long()
    run_of_slot = torch.empty(cap, dtype=torch.int64, device=p.device)
    run_of_slot[order.long()] = torch.repeat_interleave(
        torch.arange(lens.numel(), device=p.device), lens, output_size=cap)
    lib = torch.zeros(cap, device=p.device).index_add_(0, run_of_slot, p)
    max_abs = float((lib - v1).abs().max())

    def call():
        val = torch.empty_like(p)
        runs["launch"](p, val)
        return val

    ms = cuda_ms(torch, call)
    device_ms = device_ms_per_call(torch, lambda: runs["launch"](p, v1))
    plain_ms = cuda_ms(torch, lambda: _sum_runs_torch(p, order, run_off))
    library_ms = cuda_ms(torch, lambda: torch.zeros(cap, device=p.device).index_add_(
        0, run_of_slot, p))
    nbytes = 8 * n + 4 * (nnz + 1) + 4 * cap
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = n / F32_FLOP_PER_S * 1e3
    row = dict(case=name, products=n, nnz_c=nnz, cap=cap, max_abs_err=0.0,
               max_abs_vs_library=max_abs, ms=ms,
               device_ms=device_ms, plain_ms=plain_ms, library_ms=library_ms,
               library_call="torch.zeros(cap).index_add_(0, run of each slot, p): atomic",
               bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=int(nbytes),
               flops=float(n), bitwise_plain=True, bitwise_repeat=True)
    chk.cases["esc_run_sum"].append(row)
    log(f"kernel esc_run_sum  {name:34s} products={n} nnz(C)={nnz} bit-equal to the plain "
        f"version on the CPU and on two calls, max|k-index_add_|={max_abs:.3e}; kernel "
        f"{ms:.4f} ms, device {device_ms:.4f}, plain {plain_ms:.4f}, library (index_add_) "
        f"{library_ms:.4f} ms, bound {row['bound_ms']:.4f} ms ({nbytes} bytes / 3.35 TB/s)")
    del v1, v2, want, lib, run_of_slot


def ilu_solve_and_check(torch, dev, tag, a, solve, *, setup_s=None):
    """Run ``solve(b)`` (an unsymmetric solver on part g's system): the
    recursive residual must reach ILU_TOL and the true residual, against
    the float64 product, lie within 10 ILU_TOL |b| (the reference tests'
    acceptance, tests/test_ilu.py:222); logs iterations, seconds and
    ms/iteration."""
    from sparse_matrix_tpu_torch.ops.spmv import spmv_f64_bound

    b_np = np.random.default_rng(SEED).standard_normal(a.rows).astype(np.float32)
    b = torch.from_numpy(b_np).to(dev)
    res, wall = _timed(torch, lambda: solve(b))
    x_np = res.x.double().cpu().numpy()
    bnorm = float(np.linalg.norm(b_np.astype(np.float64)))
    true_res = float(np.linalg.norm(b_np - spmv_f64_bound(a, x_np)[0])) / bnorm
    rec = float(res.residual_norm) / bnorm
    it = max(res.iterations, 1)
    log(f"main {tag}: iterations={res.iterations} |r|/|b|={rec:.3e} true |b-Ax|/|b|="
        f"{true_res:.3e} (limit {10 * ILU_TOL:g}) wall {wall:.3f} s, {wall * 1e3 / it:.4f} "
        f"ms/iter" + ("" if setup_s is None else f", preconditioner setup {setup_s:.3f} s"))
    if not (np.all(np.isfinite(x_np)) and rec <= ILU_TOL * (1 + 1e-6)
            and true_res <= 10 * ILU_TOL):
        raise AssertionError(f"{tag}: did not converge within the bounds")
    return dict(iterations=res.iterations, rec=rec, true_res=true_res, wall_s=wall,
                ms_per_iter=wall * 1e3 / it, setup_s=setup_s)


def part_ilu(torch, dev, mats, ops, state):
    """Part g: IC(0)-PCG on Poisson 2048^2 at sweeps 1, 2 and 4, fused and
    in the loop form, and the ILU-preconditioned BiCGSTAB and GMRES on the
    dominant femlike_262k system. Keeps the factors in ``state`` for the
    trisweep kernel's checks."""
    from sparse_matrix_tpu_torch.ops.operator import SpmvOperator
    from sparse_matrix_tpu_torch.solvers import bicgstab, gmres, ilu
    from sparse_matrix_tpu_torch.solvers.cg import pcg_solve

    a2 = mats["poisson2048"]
    op = ops["poisson2048"]
    t0 = time.perf_counter()
    lc = ilu.ic0(a2)
    ic_s = time.perf_counter() - t0
    log(f"main ic0 poisson2048: rows={a2.rows} nnz(L)={lc.nnz()} {ic_s:.3f} s (host library)")
    rec = state.setdefault("ilu", {"ic0_s": ic_s, "ic_pcg": []})
    base = state["cg_poisson2048"]
    for sweeps in (1, 2, 4):
        for fused in (True, None):
            form = "fused" if fused else "loop"
            t0 = time.perf_counter()
            m_inv = ilu.ic_preconditioner(a2, device=dev, sweeps=sweeps, fused=fused)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            _, nums = solve_and_check(
                torch, dev, f"ic_pcg poisson2048 sweeps={sweeps} {form}", a2, 2048,
                lambda b, m_inv=m_inv: pcg_solve(op, b, m_inv, tol=CG_TOL, maxiter=20000),
                op, precond=m_inv)
            nums.update(sweeps=sweeps, form=form, setup_s=setup_s)
            rec["ic_pcg"].append(nums)
            log(f"main ic_pcg poisson2048 sweeps={sweeps} {form}: preconditioner setup "
                f"{setup_s:.3f} s; against plain CG ({base['iterations']} iterations, "
                f"{base['wall_s']:.3f} s): iterations x{nums['iterations'] / base['iterations']:.3f}"
                f", wall x{nums['wall_s'] / base['wall_s']:.3f}, device ms/iter "
                f"x{nums['device_ms_per_iter'] / base['device_ms_per_iter']:.3f}")
            del m_inv
    state["ic_factor"] = lc

    fem = mats["femlike_dominant"]
    opf = SpmvOperator(fem, device=dev)
    t0 = time.perf_counter()
    f = ilu.ilu0(fem)
    ilu_s = time.perf_counter() - t0
    log(f"main ilu0 femlike_262k dominant: format={opf.format} nnz(L)={f.l.nnz()} "
        f"nnz(U)={f.u.nnz()} {ilu_s:.3f} s (host library)")
    rec["ilu0_s"] = ilu_s
    state["ilu_factors"] = f
    t0 = time.perf_counter()
    m_ilu = ilu.ilu_preconditioner(fem, device=dev, fused=True)
    torch.cuda.synchronize()
    ilu_setup = time.perf_counter() - t0
    runs = rec.setdefault("unsymmetric", {})
    for name, solve in (
        ("bicgstab", lambda b, m=None: bicgstab.bicgstab_solve(opf, b, tol=ILU_TOL,
                                                               maxiter=2000, m_inv=m)),
        ("gmres30", lambda b, m=None: gmres.gmres_solve(opf, b, restart=30, tol=ILU_TOL,
                                                        maxiter=6000, m_inv=m)),
    ):
        runs[name] = ilu_solve_and_check(torch, dev, f"{name} femlike_262k dominant", fem,
                                         solve)
        runs[name + "_ilu0_fused"] = ilu_solve_and_check(
            torch, dev, f"{name} + ilu_preconditioner(fused) femlike_262k dominant", fem,
            lambda b, solve=solve: solve(b, m_ilu), setup_s=ilu_setup)
    t0 = time.perf_counter()
    m_ilut = ilu.ilut_preconditioner(fem, device=dev)
    torch.cuda.synchronize()
    runs["bicgstab_ilut"] = ilu_solve_and_check(
        torch, dev, "bicgstab + ilut_preconditioner femlike_262k dominant", fem,
        lambda b: bicgstab.bicgstab_solve(opf, b, tol=ILU_TOL, maxiter=2000, m_inv=m_ilut),
        setup_s=time.perf_counter() - t0)
    del m_ilu, m_ilut
    torch.cuda.empty_cache()


def part_amg(torch, dev, mats, ops, state):
    """Part h: smoothed-aggregation AMG on Poisson 2048^2 (f32, the
    defaults: Jacobi, nu = 1, theta = 0.08, coarse_size 400). Setup timed by
    phase and level; AMG-PCG on a vector to tol, beside part a's CG and
    part g's IC(0)-PCG; a K = K_RHS block solve on the same hierarchy; a
    save/load round trip of the 512^2 coarsening."""
    import tempfile

    from sparse_matrix_tpu_torch.ops.spmv import spmv_f64_bound
    from sparse_matrix_tpu_torch.solvers import amg, cg

    a2 = mats["poisson2048"]
    phases = []  # (level, phase, seconds since the previous phase ended, info)
    clock = [time.perf_counter()]
    t0 = clock[0]

    def on_phase(level, name, **info):
        now = time.perf_counter()
        phases.append((level, name, now - clock[0], info))
        clock[0] = now

    hier = amg.amg_setup(a2, device=dev, on_phase=on_phase)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rec = state.setdefault("amg", {"setup_s": setup_s, "levels": []})
    phase_s = {}
    for _l, name, s, _i in phases:
        phase_s[name] = phase_s.get(name, 0.0) + s
    for li, lv in enumerate(hier.levels):
        mine = [(name, s, info) for lvl, name, s, info in phases if lvl == li]
        by = {name: s for name, s, _i in mine if name != "galerkin"}
        info = {name: i for name, _s, i in mine}
        gal = [(i["engine"], i["products"], s) for name, s, i in mine if name == "galerkin"]
        log(f"main amg level {li}: n={lv.n} nnz={lv.nnz} P nnz={info['smooth']['p_nnz']} "
            f"formats A/P/Pt={'/'.join(info['plan']['formats'])}; strength and aggregation "
            f"{by['strength_aggregate']:.3f} s, prolongator smoothing {by['smooth']:.3f} s, "
            "Galerkin " + "; ".join(f"{e} {n} products {s:.3f} s ({n / s / 1e6:.1f} Mprod/s)"
                                    for e, n, s in gal)
            + f"; operator plans {by['plan']:.3f} s")
        rec["levels"].append(dict(n=lv.n, nnz=lv.nnz, p_nnz=info["smooth"]["p_nnz"],
                                  formats=info["plan"]["formats"], galerkin=gal,
                                  **{f"{k}_s": v for k, v in by.items()}))
    coarse_n = hier.coarse_inv.shape[0]
    rec.update(phase_s=phase_s, coarse_n=coarse_n)
    log(f"main amg setup poisson2048: {len(hier.levels)} levels, coarse {coarse_n} rows, "
        f"{setup_s:.3f} s: " + ", ".join(f"{k} {v:.3f} s" for k, v in phase_s.items()))
    if hier.levels[0].a_op.format != "dia":
        raise AssertionError(f"AMG level 0 dispatched to {hier.levels[0].a_op.format}")

    op = hier.levels[0].a_op
    m_inv = hier.preconditioner()
    _, nums = solve_and_check(
        torch, dev, "amg_pcg poisson2048 jacobi", a2, 2048,
        lambda b: amg.amg_pcg_solve(a2, b, tol=CG_TOL, maxiter=200, hierarchy=hier),
        op, precond=m_inv, calls=AMG_STEP_CALLS)
    rec["pcg"] = nums
    base = state["cg_poisson2048"]
    ic = next(r for r in state["ilu"]["ic_pcg"] if r["sweeps"] == 4 and r["form"] == "fused")
    for tag, other in (("plain CG (part a)", base), ("IC(0)-PCG 4 sweeps fused (part g)", ic)):
        log(f"main amg_pcg poisson2048 against {tag} ({other['iterations']} iterations, "
            f"{other['wall_s']:.3f} s, {other['ms_per_iter']:.4f} ms/iter): iterations "
            f"x{nums['iterations'] / other['iterations']:.4f}, wall x"
            f"{nums['wall_s'] / other['wall_s']:.4f}, ms/iter "
            f"x{nums['ms_per_iter'] / other['ms_per_iter']:.3f}")
    if nums["iterations"] * 10 > base["iterations"]:
        raise AssertionError(f"AMG-PCG took {nums['iterations']} iterations against CG's "
                             f"{base['iterations']}")

    # the block solve: K_RHS columns through one block V-cycle an iteration
    rng = np.random.default_rng(SEED)
    b_np = rng.standard_normal((a2.rows, K_RHS)).astype(np.float32)
    bb = torch.from_numpy(b_np).to(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = amg.amg_pcg_solve(a2, bb, tol=CG_TOL, maxiter=200, hierarchy=hier)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    x_np = res.x.double().cpu().numpy()
    bnorm = np.linalg.norm(b_np.astype(np.float64), axis=0)
    rec_res = res.residual_norm.double().cpu().numpy() / bnorm
    ax = np.stack([spmv_f64_bound(a2, x_np[:, q])[0] for q in range(K_RHS)], axis=1)
    true_res = np.linalg.norm(b_np - ax, axis=0) / bnorm
    bound_true = EPS_F32 * poisson_cond(2048)
    colsum, bc = cg._rhs_layout(bb, -1)
    z = m_inv(bb)
    st = (torch.zeros_like(bb), bb.clone(), z, colsum(bb, z), colsum(bb, bb))
    live = torch.ones(K_RHS, dtype=torch.bool, device=dev)

    def step():
        nonlocal st
        st = cg._pcg_multi_step(op.matmat, m_inv, colsum, bc, live, *st)

    rec["block"] = _report_solve(torch, f"amg_pcg poisson2048 K={K_RHS} block", op.format,
                                 CG_TOL, res.iterations, float(rec_res.max()),
                                 float(true_res.max()), bound_true, wall, step,
                                 calls=AMG_STEP_CALLS)
    if not (np.all(np.isfinite(x_np)) and np.all(rec_res <= CG_TOL * (1 + 1e-6))
            and np.all(true_res <= bound_true)):
        raise AssertionError(f"AMG block PCG: |r|/|b| {rec_res}, true {true_res}")
    del hier, m_inv, op, st, z, bb, res
    torch.cuda.empty_cache()

    # save and load the 512^2 coarsening: the reloaded hierarchy solves alike
    a5 = mats["poisson512"]
    coarsening = amg.amg_coarsen(a5, device=dev)
    b5 = torch.from_numpy(np.random.default_rng(SEED).standard_normal(a5.rows)
                          .astype(np.float32)).to(dev)
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/coarsening512.npz"
        amg.save_amg_coarsening(path, *coarsening)
        loaded = amg.load_amg_coarsening(path)
    runs = []
    for c in (coarsening, loaded):
        h = amg.amg_setup(a5, device=dev, coarsening=c)
        runs.append(amg.amg_pcg_solve(a5, b5, tol=CG_TOL, maxiter=200, hierarchy=h))
    diff = float((runs[0].x - runs[1].x).abs().max())
    log(f"main amg save/load poisson512: {len(coarsening[0])} levels, iterations "
        f"{runs[0].iterations} (built) / {runs[1].iterations} (reloaded), max |x1 - x2| {diff:g}")
    if runs[0].iterations != runs[1].iterations:
        raise AssertionError("the reloaded AMG coarsening solves in other iterations")
    rec["save_load_512"] = dict(iterations=runs[0].iterations, max_abs_diff=diff)


def phase_trisweep_kernel(torch, dev, chk, state):
    """The trisweep kernel (B13) at TRISWEEP_SWEEPS sweeps on part g's
    factors: bit-equal to its plain version on the card, within the
    float64 running bound, timed beside the plain version and the loop
    form; then the nilpotency check on Poisson 64^2."""
    from sparse_matrix_tpu_torch.ops import trisweep as tw
    from sparse_matrix_tpu_torch.solvers import ilu
    from sparse_matrix_tpu_torch.solvers.poisson import poisson_2d_csr

    lc, f = state.pop("ic_factor"), state.pop("ilu_factors")
    rng = np.random.default_rng(SEED + 7)
    s = TRISWEEP_SWEEPS
    for case, t in (("poisson2048_L", lc), ("poisson2048_LT", lc.transpose()),
                    ("femlike_262k_L", f.l), ("femlike_262k_U", f.u)):
        sj = ilu.TriangularJacobi(t, device=dev, sweeps=s, fused=True)
        # the loop form of the same factor (its planned N and dinv), without
        # planning the operator again
        loop = copy.copy(sj)
        loop._fused = None
        plan, dinv = sj._fused, sj.dinv
        b = torch.from_numpy(rng.standard_normal(t.rows).astype(np.float32)).to(dev)

        def kernel(plan=plan, b=b, dinv=dinv):
            return tw.trisweep(plan, b, dinv, sweeps=s)

        def plain(plan=plan, b=b, dinv=dinv):
            return tw._trisweep_torch(plan.data, b, dinv, offsets=plan.offsets,
                                      rows=plan.rows, sweeps=s)

        rec, y_bare = plan._record(s), torch.empty_like(b)

        def launch(rec=rec, b=b, dinv=dinv, y=y_bare):
            rec(b, dinv, y, s)

        yk, yp = kernel(), plain()
        torch.cuda.synchronize()
        if not torch.equal(yk, yp):
            raise AssertionError(f"trisweep/{case}: kernel and plain version differ")
        if not torch.equal(kernel(), kernel()):
            raise AssertionError(f"trisweep/{case}: two calls on one input differ in their bits")
        x64, bound = tw.trisweep_f64_bound(plan, b, dinv, sweeps=s)
        err = (yk.double() - x64).abs()
        if not bool((err <= bound).all()):
            raise AssertionError(f"trisweep/{case}: off the float64 running bound")
        ratio = float((err / bound.clamp(min=1e-300)).max())
        del x64, bound, err
        ms = cuda_ms(torch, kernel)
        launch_ms, device_ms = cuda_ms(torch, launch), device_ms_per_call(torch, launch)
        plain_ms = cuda_ms(torch, plain)
        loop_ms = cuda_ms(torch, lambda loop=loop, b=b: loop(b))
        # the exact solve of T x = b by one library call (cuSPARSE through
        # torch.triangular_solve on a CSR tensor): a second yardstick
        upper = case.endswith(("_LT", "_U"))
        t_csr = library_csr(torch, t, dev)

        def exact(t_csr=t_csr, b=b, upper=upper):
            return torch.triangular_solve(b[:, None], t_csr, upper=upper).solution

        x_exact = exact()[:, 0].double().cpu().numpy()
        x_host = ilu.trisolve_host(t, b.double().cpu().numpy(), lower=not upper)
        exact_err = float(np.linalg.norm(x_exact - x_host) / np.linalg.norm(x_host))
        if not exact_err <= 1e-4:
            raise AssertionError(f"trisweep/{case}: the library's exact solve is off by "
                                 f"{exact_err:.3e}")
        exact_ms = cuda_ms(torch, exact, reps=10, warmup=2)
        del t_csr
        nb, rows = len(plan.offsets), plan.rows
        nbytes = nb * rows * 4 + nb * 4 + 3 * rows * 4
        flops = float((s * (2 * nb + 2) + 1) * rows)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / F32_FLOP_PER_S * 1e3
        row = dict(case=case, rows=rows, nb=nb, sweeps=s, chunk_rows=plan.chunk_rows,
                   max_abs_err=float((yk - yp).abs().max()), bitwise_plain=True,
                   bitwise_repeat=True, max_err_over_bound=ratio, ms=ms, launch_ms=launch_ms,
                   device_ms=device_ms, plain_ms=plain_ms, library_ms=None,
                   yardstick_ms=loop_ms,
                   yardstick="the loop form TriangularJacobi.__call__ (1 + sweeps DIA SpMV "
                             "launches and their elementwise updates; no single PyTorch call)",
                   exact_solve_ms=exact_ms, exact_solve_rel_err=exact_err,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=int(nbytes), flops=flops)
        chk.cases["trisweep"].append(row)
        log(f"kernel trisweep     {case:34s} rows={rows} nb={nb} sweeps={s} chunk_rows="
            f"{plan.chunk_rows} bit-equal to plain, equal bits on two calls, "
            f"max err/bound={ratio:.3f} kernel {ms:.4f} ms (bare launch {launch_ms:.4f} ms, its "
            f"device time with no host gaps {device_ms:.4f} ms), plain {plain_ms:.4f} ms, loop form "
            f"{loop_ms:.4f} ms, exact solve (torch.triangular_solve, CSR) {exact_ms:.4f} ms "
            f"(rel err {exact_err:.2e}), bound {row['bound_ms']:.4f} ms ({nbytes} bytes / 3.35 TB/s; "
            f"{flops:.4g} flop / 67 TFLOP/s), {ms / row['bound_ms']:.2f}x the bound")
        del sj, loop, yk, yp
    torch.cuda.empty_cache()

    # nilpotency: depth(L) - 1 sweeps are the exact solve
    l64 = ilu.ic0(poisson_2d_csr(64, dtype=np.float32))
    sj = ilu.TriangularJacobi(l64, device=dev, sweeps=2 * 64 - 2, fused=True)
    b_np = rng.standard_normal(l64.rows).astype(np.float32)
    x = sj(torch.from_numpy(b_np).to(dev)).cpu().numpy()
    np.testing.assert_allclose(x, ilu.trisolve_host(l64, b_np.astype(np.float64), lower=True),
                               rtol=2e-4, atol=2e-5)
    log(f"kernel trisweep     poisson64_L sweeps={sj.sweeps}: equal to the exact host solve "
        f"(rtol 2e-4, atol 2e-5)")


def part_hpcg(torch, dev, mats, ops, state):
    """Part i: one HPCG set on 104^3 in float64 (HPCG 3.1's local grid):
    ``hpcg_hierarchy`` (4 stencil-regenerated levels, every A on the f64
    DIA kernel, a SymGS plan a level), then ``amg_pcg_solve`` at tol 0 and
    50 iterations on HPCG's b = A 1 from x0 = 0, once to capture the
    V-cycle's graph and once timed; the set must run 50 iterations, take
    the graph, and lie within ``HPCG_LIMIT`` of the plain reference's
    float64 set on the card, in x and in ``||b - A x|| / ||b||``."""
    from sparse_matrix_tpu_torch.reference import hpcg as ref
    from sparse_matrix_tpu_torch.solvers import amg
    from sparse_matrix_tpu_torch.solvers.hpcg import hpcg_hierarchy

    nx, ny, nz = HPCG_GRID
    t0 = time.perf_counter()
    h = hpcg_hierarchy(nx, ny, nz, device=dev, levels=HPCG_LEVELS)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    ops_all = [lv.a_op for lv in h.levels] + [h.coarse_level.a_op]
    formats = [op.format for op in ops_all]
    if formats != ["dia"] * HPCG_LEVELS or h.dtype != torch.float64:
        raise AssertionError(f"HPCG levels dispatched to {formats} in {h.dtype}")
    b = ref.hpcg_rhs(nx, ny, nz, dtype=torch.float64, device=dev)
    a0 = h.levels[0].a_op

    def one_set():
        return amg.amg_pcg_solve(a0, b, hierarchy=h, tol=0.0, maxiter=HPCG_ITERS)

    one_set()  # the graph's capture
    torch.cuda.synchronize()
    if h._graph is None:
        raise AssertionError("the HPCG V-cycle took no CUDA graph")
    t0 = time.perf_counter()
    res = one_set()
    torch.cuda.synchronize()
    set_ms = (time.perf_counter() - t0) * 1e3
    want = ref.cg_set(b, nx, ny, nz, levels=HPCG_LEVELS, maxiter=HPCG_ITERS)

    def residual(x):
        r = b - ref.apply_a(x.reshape(nz, ny, nx)).reshape(-1)
        return float(r.norm() / b.norm())

    x_err = float((res.x - want.x).norm() / want.x.norm())
    res_got, res_ref = residual(res.x), residual(want.x)
    rec = dict(grid=list(HPCG_GRID), levels=HPCG_LEVELS, setup_s=setup_s, set_ms=set_ms,
               iterations=int(res.iterations), residual=res_got, ref_residual=res_ref,
               x_error=x_err)
    state["hpcg"] = rec
    log(f"main hpcg {nx}x{ny}x{nz} f64: setup {setup_s:.3f} s, one set of "
        f"{res.iterations} iterations {set_ms:.3f} ms (wall, one graph replay a V-cycle), "
        f"|b - A x|/|b| {res_got:.3e} (reference {res_ref:.3e}), |x - x_ref|/|x_ref| "
        f"{x_err:.3e}")
    if not (res.iterations == HPCG_ITERS and x_err <= HPCG_LIMIT
            and abs(res_got - res_ref) <= HPCG_LIMIT):
        raise AssertionError(f"HPCG set off the reference: {rec}")
    state["hpcg_hier"] = h


def _kernels_per_call(torch, fn, reps: int = 5) -> float:
    """Device kernels launched by one ``fn()``, counted in a profiler trace
    of ``reps`` calls."""
    import tempfile
    from pathlib import Path

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return sum(ev.get("cat") == "kernel" for ev in events) / reps


def phase_krylov_kernels(torch, dev, chk, ops, state):
    """The fused Krylov kernels (``csrc/krylov_update.cu``) at the main
    path's shapes, Poisson 2048^2 in f32 and HPCG 104^3 in f64 (part i's
    finest operator): each against its plain version, the eager PyTorch ops
    of the step before the kernels, on the same inputs (the updates within
    4 roundoffs of ``|x| + |alpha p|``, a fused multiply-add against a
    product and a sum rounded apart; each inner product within its depth's
    roundoffs of the float64 ``sum |u_i v_i|``), equal bits on two calls,
    with kernel, device and plain times and the bound (bytes at 3.35 TB/s).
    Then one CG step over the case's DIA operator, fused (``_cg_step``) and
    eager: device ms and kernels an iteration."""
    from sparse_matrix_tpu_torch.native.kernels import KrylovScratch
    from sparse_matrix_tpu_torch.solvers import cg

    def eager_step(matvec, x, r, p, rs):
        ap = matvec(p)
        alpha = rs / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        return x, r, r + (rs_new / rs) * p, rs_new

    for case, op, dtype in (("poisson2048_f32", ops["poisson2048"], torch.float32),
                            ("hpcg104_f64", state["hpcg_hier"].levels[0].a_op,
                             torch.float64)):
        n = op.rows
        rng = np.random.default_rng(SEED + 17)
        x, r, p, ap, z = (torch.from_numpy(rng.standard_normal(n)).to(dev, dtype)
                          for _ in range(5))
        num, den = (torch.tensor(v, dtype=dtype, device=dev) for v in (0.7, 1.3))
        ks = KrylovScratch(x)
        eps = torch.finfo(dtype).eps / 2
        depth = -(-n // (ks.blocks * 256)) + 20 + -(-ks.blocks // 256)

        def dot_off(got, u, v):
            uv = u.double() * v.double()
            return (abs(float(got) - float(uv.sum())) / (eps * float(uv.abs().sum())))

        def near(k, want, *terms):
            return bool(((k - want).abs() <= 4 * eps * sum(t.abs() for t in terms)).all())

        alpha, beta = num / den, den / num
        kd = [ks.dot(r, p, 4).clone() for _ in range(2)]
        xk, rk = x.clone(), r.clone()
        rr = ks.cg_update(xk, rk, p, ap, num, den, 1).clone()
        xk2, rk2 = x.clone(), r.clone()
        rr2 = ks.cg_update(xk2, rk2, p, ap, num, den, 1).clone()
        pk, pk2 = p.clone(), p.clone()
        ks.p_update(pk, z, den, num)
        ks.p_update(pk2, z, den, num)
        xp, rp, pp = x + alpha * p, r - alpha * ap, z + beta * p
        torch.cuda.synchronize()
        offs = dict(krylov_dot=max(dot_off(kd[0], r, p), dot_off(torch.dot(r, p), r, p)),
                    rr=dot_off(rr, rk, rk))
        if not (torch.equal(kd[0], kd[1]) and torch.equal(rr, rr2) and torch.equal(xk, xk2)
                and torch.equal(rk, rk2) and torch.equal(pk, pk2)):
            raise AssertionError(f"krylov/{case}: two calls on one input differ in their bits")
        if not (near(xk, xp, x, alpha * p) and near(rk, rp, r, alpha * ap)
                and near(pk, pp, z, beta * p) and max(offs.values()) <= depth):
            raise AssertionError(f"krylov/{case}: off the plain version ({offs} roundoffs of "
                                 f"sum |u v|, depth {depth})")
        errs = dict(krylov_dot=abs(float(kd[0]) - float(torch.dot(r, p))),
                    cg_update=max(float((xk - xp).abs().max()), float((rk - rp).abs().max())),
                    p_update=float((pk - pp).abs().max()))
        del xk2, rk2, pk2, xp, rp, pp

        xw, rw, pw = x.clone(), r.clone(), p.clone()

        def plain_update():
            a = num / den
            rn = rw - a * ap
            return xw + a * p, rn, torch.dot(rn, rn)

        work = dict(
            krylov_dot=(lambda: ks.dot(r, p, 4), lambda: torch.dot(r, p), 2),
            cg_update=(lambda: ks.cg_update(xw, rw, p, ap, num, den, 1), plain_update, 6),
            p_update=(lambda: ks.p_update(pw, z, num, den), lambda: z + (num / den) * pw, 3),
        )
        size = x.element_size()
        total = dict(ms=0.0, device_ms=0.0, plain_ms=0.0, bound_ms=0.0)
        for name, (kernel, plain, vectors) in work.items():
            nbytes = vectors * n * size
            row = dict(case=case, rows=n, blocks=ks.blocks, max_abs_err=errs[name],
                       bitwise_repeat=True, ms=cuda_ms(torch, kernel),
                       device_ms=device_ms_per_call(torch, kernel),
                       plain_ms=cuda_ms(torch, plain), bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
                       bound_by="bytes", bytes=nbytes, library_ms=None)
            if name == "krylov_dot":
                row["library_ms"] = row["plain_ms"]  # torch.dot, cuBLAS
            chk.cases[name].append(row)
            # a CG iteration's vector work is one of each: p.Ap, the x and r
            # update with r.r, the p update
            for key in total:
                total[key] += row[key]
            log(f"kernel {name:12s} {case} n={n} blocks={ks.blocks} equal bits on two calls, "
                f"max|k-plain|={errs[name]:.3e}; kernel {row['ms']:.4f} ms, device "
                f"{row['device_ms']:.4f} ms, plain (eager ops) {row['plain_ms']:.4f} ms, bound "
                f"{row['bound_ms']:.4f} ms ({nbytes} bytes / 3.35 TB/s), "
                f"{row['device_ms'] / row['bound_ms']:.2f}x the bound")
        log(f"krylov {case}: updates and dots an iteration, device {total['device_ms']:.4f} ms, "
            f"plain {total['plain_ms']:.4f} ms, bound {total['bound_ms']:.4f} ms "
            f"({100 * total['bound_ms'] / total['device_ms']:.1f} % of it); inner products off "
            f"the float64 sum by {offs} roundoffs of sum |u v| (depth {depth})")
        del xw, rw, pw, x, r, p, ap, z

        b = torch.from_numpy(rng.standard_normal(n)).to(dev, dtype)
        step_rec = {}
        for form, step_fn in (("fused", cg._cg_step), ("eager", eager_step)):
            st = [(torch.zeros_like(b), b.clone(), b.clone(), torch.dot(b, b))]

            def step(step_fn=step_fn, st=st):
                st[0] = step_fn(op, *st[0])

            step_rec[form] = dict(ms=cuda_ms(torch, step, reps=20, warmup=3),
                                  device_ms=device_ms_per_call(torch, step),
                                  kernels=_kernels_per_call(torch, step))
            del st
        # the kernels' times above are L2-warm where their vectors fit the
        # 50 MB L2; inside a step B1's 117 MB (Poisson) passes between them
        b1_ms = device_ms_per_call(torch, lambda: op(b))
        in_step = step_rec["fused"]["device_ms"] - b1_ms
        state.setdefault("krylov", {})[case] = dict(
            updates_and_dots=total, step=step_rec, b1_device_ms=b1_ms,
            updates_and_dots_in_step_ms=in_step)
        log(f"krylov {case}: one CG step fused {step_rec['fused']} / eager "
            f"{step_rec['eager']} (ms, device ms, kernels an iteration); B1 {b1_ms:.4f} ms, so "
            f"the updates and dots take {in_step:.4f} ms of the fused step's device time, "
            f"{100 * total['bound_ms'] / in_step:.1f} % of their bound")
        del b
        torch.cuda.empty_cache()


def phase_symgs_kernel(torch, dev, chk, state):
    """The SymGS kernel on part i's four levels (104^3, 52^3, 26^3, 13^3;
    f64, 8 colours): one step, its 16 colour passes in one launch, against
    the plain version (``_symgs_torch``) on the same inputs on the card,
    within ``symgs_f64_bound``, bit-equal to the same step as one launch a
    colour pass (``launch.by_pass``, the form before the one-launch kernel)
    and on two calls; each level's device time for both forms, its bound
    (two sweep directions of the level's bytes) and the plain version's
    time. Then the finest level's f64 DIA SpMV against its plain version
    within 2 * nb f64 roundoffs of each row's |A||x|, with its times and
    bound."""
    from sparse_matrix_tpu_torch.native import kernels
    from sparse_matrix_tpu_torch.ops.spmv_dia import _spmv_dia_torch
    from sparse_matrix_tpu_torch.ops.symgs import _color_pass, _symgs_torch, parity_colors
    from sparse_matrix_tpu_torch.solvers.hpcg import hpcg_problem

    def launched(fn):
        """fn's result and the SymGS launches it counted"""
        before = kernels.launch_counts["symgs"]
        out = fn()
        return out, kernels.launch_counts["symgs"] - before

    h = state.pop("hpcg_hier")
    nx, ny, nz = HPCG_GRID
    rng = np.random.default_rng(SEED + 16)
    for lvl, lv in enumerate([*h.levels, h.coarse_level]):
        grid = (nx >> lvl, ny >> lvl, nz >> lvl)
        plan, op = lv.symgs, lv.a_op
        m, _b = hpcg_problem(*grid)
        n, nnz = m.rows, m.nnz()
        data, offsets = op.part("dia").arrays["data"], op.part("dia").plan.offsets  # natural, f64
        nb, diag = len(offsets), offsets.index(0)
        order = np.argsort(parity_colors(*grid), kind="stable")
        passes = []
        for c in range(plan.colors):
            rows = torch.from_numpy(order[plan.color_start[c]:plan.color_start[c + 1]])
            passes.append(tuple(t.to(dev) for t in _color_pass(data, offsets, diag, rows)))
        x0 = torch.from_numpy(rng.standard_normal(n)).to(dev)
        r = torch.from_numpy(rng.standard_normal(n)).to(dev)
        case = "hpcg{}_f64".format(grid[0])

        def kernel():
            return plan.step(x0.clone(), r)

        def by_pass():
            x = x0.clone()
            plan.launch.by_pass(r, x)
            return x

        def plain():
            return _symgs_torch(passes, x0.clone(), r)

        (xk, launches), xp = launched(kernel), plain()
        xb, by_pass_launches = launched(by_pass)
        torch.cuda.synchronize()
        if launches != 1 or by_pass_launches != plan.launch.passes:
            raise AssertionError(f"symgs/{case}: a step counted {launches} launches (1 wanted) "
                                 f"and per pass {by_pass_launches} ({plan.launch.passes} "
                                 "wanted)")
        if not torch.equal(kernel(), xk):
            raise AssertionError(f"symgs/{case}: two calls on one input differ in their bits")
        if not torch.equal(xb, xk):
            raise AssertionError(f"symgs/{case}: one launch and one launch a pass differ in "
                                 "their bits")
        bound = symgs_f64_bound(torch, r, x0, xk, 2 * plan.colors, nb)
        err = float((xk - xp).abs().max())
        if not (bool(torch.isfinite(xk).all()) and err <= bound):
            raise AssertionError(f"symgs/{case}: max |kernel - plain| {err:.3e} > {bound:.3e}")
        x_bare = x0.clone()
        ms = cuda_ms(torch, kernel)
        device_ms = device_ms_per_call(torch, lambda: plan.launch(r, x_bare))
        by_pass_ms = device_ms_per_call(torch, lambda: plan.launch.by_pass(r, x_bare))
        plain_ms = cuda_ms(torch, plain, reps=10, warmup=2)
        # a step is two sweep directions, each the level's matrix in its
        # smallest plain form, r read once and x read and written once
        nbytes = 2 * (plain_form_bytes(m, 8) + 8 * n + 16 * n)
        flops = 2.0 * 2 * nnz
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F64_FLOP_PER_S * 1e3
        row = dict(case=case, rows=n, nnz=nnz, colors=plan.colors, launches=launches,
                   by_pass_launches=by_pass_launches, max_abs_err=err,
                   max_err_over_bound=err / bound, bitwise_repeat=True, equal_by_pass=True,
                   ms=ms, device_ms=device_ms, by_pass_device_ms=by_pass_ms,
                   device_over_by_pass=device_ms / by_pass_ms, plain_ms=plain_ms,
                   library_ms=None, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=int(nbytes),
                   flops=flops)
        chk.cases["symgs"].append(row)
        log(f"kernel symgs        {case} rows={n} colours={plan.colors} {launches} launch "
            f"(by pass: {by_pass_launches}), equal bits on two calls and to the per-pass form, "
            f"max|k-plain|={err:.3e} (bound {bound:.3e}); kernel {ms:.4f} ms, device "
            f"{device_ms:.4f} ms, per-pass device {by_pass_ms:.4f} ms "
            f"({device_ms / by_pass_ms:.3f}x), plain {plain_ms:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({nbytes} bytes / 3.35 TB/s; {flops:.4g} flop / 34 "
            f"TFLOP/s), {device_ms / row['bound_ms']:.2f}x the bound")
        del passes, xk, xp, xb, x_bare
    lv = h.levels[0]
    op = lv.a_op
    m, _b = hpcg_problem(nx, ny, nz)
    n, nnz = m.rows, m.nnz()
    data, offsets = op.part("dia").arrays["data"], op.part("dia").plan.offsets
    nb = len(offsets)

    # the f64 DIA SpMV on the finest level
    x = torch.from_numpy(rng.standard_normal(n)).to(dev)

    def dia_plain(d=data, v=x):
        return _spmv_dia_torch(d, v, offsets=offsets, rows=n, cols=n)

    yk, yp = op(x), dia_plain()
    torch.cuda.synchronize()
    if not torch.equal(op(x), yk):
        raise AssertionError("dia/hpcg104_f64: two calls on one input differ in their bits")
    absax = dia_plain(data.abs(), x.abs())
    excess = ((yk - yp).abs() - 2 * nb * 2.0 ** -53 * absax).max()
    err = float((yk - yp).abs().max())
    if not (bool(torch.isfinite(yk).all()) and float(excess) <= 0):
        raise AssertionError(f"dia/hpcg104_f64: off the plain version by more than {2 * nb} "
                             "f64 roundoffs of |A||x|")
    csr = torch.sparse_csr_tensor(
        torch.from_numpy(m.offsets.astype(np.int64)), torch.from_numpy(m.indices.astype(np.int64)),
        torch.from_numpy(m.vals), size=(n, n), check_invariants=False).to(dev)
    lib_err = float((torch.mv(csr, x) - yk).abs().max())
    ms = cuda_ms(torch, lambda: op(x))
    plain_ms = cuda_ms(torch, dia_plain)
    library_ms = cuda_ms(torch, lambda: torch.mv(csr, x))
    matrix_bytes = plain_form_bytes(m, 8)
    nbytes = matrix_bytes + 8 * 2 * n
    flops = 2.0 * nnz
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / F64_FLOP_PER_S * 1e3
    row = dict(case="hpcg104_f64", rows=n, nnz=nnz, k=1, max_abs_err=err,
               max_abs_vs_library=lib_err, bitwise_repeat=True, ms=ms, plain_ms=plain_ms,
               library_ms=library_ms, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations", bytes=int(nbytes),
               matrix_bytes=int(matrix_bytes), flops=flops)
    chk.cases["dia"].append(row)
    log(f"kernel dia          hpcg104_f64 rows={n} nnz={nnz} equal bits on two calls, "
        f"max|k-plain|={err:.3e} (within {2 * nb} f64 roundoffs of |A||x|), "
        f"max|k-library|={lib_err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library "
        f"(torch.sparse CSR f64) {library_ms:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({nbytes} bytes / 3.35 TB/s), {ms / row['bound_ms']:.2f}x the bound")
    del h, csr, yk, yp, absax
    torch.cuda.empty_cache()


def symgs_f64_bound(torch, r, x0, x1, passes: int, nb: int) -> float:
    """A bound on max |kernel - plain| of one SymGS step in float64 on a
    row-diagonally dominant operator with a diagonal of 26 (HPCG's): each
    of the ``passes`` colour passes sums ``nb`` terms in another order
    (at most ``nb`` roundoffs of ``|r| + |A_off||x|``, over the diagonal),
    and the errors of earlier passes come in weighted by |a_ij| / a_ii,
    whose row sum is at most 1, so they add; ``|A_off||x| / a_ii`` is at
    most the largest |x|, taken over the step's input and output, with a
    factor 2 for the values between."""
    xmax = max(float(x0.abs().max()), float(x1.abs().max()))
    scale = float(r.abs().max()) / 26.0 + 2 * xmax
    return passes * (nb + 1) * 2.0 ** -53 * scale


def plan_operators(dev, mats):
    """The main path's operators, planned on the host with their times;
    the three classes must take the reference's formats."""
    from sparse_matrix_tpu_torch.ops.operator import SpmvOperator

    expected = {
        "poisson2048": ("dia", None),
        "femlike_262k": ("dia", None),
        "randlocal_262k": ("stripe", ("scan", 2, 2)),
        "powerlaw_262k": ("stripe", ("scan", 8, 16)),
    }
    ops = {}
    for name, (fmt, cfg) in expected.items():
        t0 = time.perf_counter()
        op = SpmvOperator(mats[name], device=dev)
        st = plan_of(op, "stripe")
        got = None if st is None else (st.mode, st.levels, st.kw)
        log(f"plan {name} auto: format={op.format} stripe={got} "
            f"bytes/apply={op.bytes_per_apply()} {time.perf_counter() - t0:.2f} s")
        if (op.format, got) != (fmt, cfg):
            raise AssertionError(f"{name} dispatched to {op.format} {got}, expected {fmt} {cfg}")
        ops[name] = op
    for name, m, force in (("poisson1024_aligned", "poisson1024", "aligned"),
                           ("poisson1024_lanepack", "poisson1024", "lanepack"),
                           ("poisson1024_bell", "poisson1024", "bell"),
                           ("poisson512_bell", "poisson512", "bell"),
                           ("randlocal_262k_lanepack", "randlocal_262k", "lanepack"),
                           ("randlocal_262k_aligned", "randlocal_262k", "aligned")):
        t0 = time.perf_counter()
        ops[name] = SpmvOperator(mats[m], device=dev, force=force)
        log(f"plan {m} {force}: {time.perf_counter() - t0:.2f} s")
    return ops


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1

    from sparse_matrix_tpu_torch.bench.corpus import (
        bench_classes,
        blocked,
        dense_block_tridiagonal,
        random_uniform,
        with_dominant_diagonal,
    )
    from sparse_matrix_tpu_torch.device import require_device
    from sparse_matrix_tpu_torch.native import host, kernels
    from sparse_matrix_tpu_torch.native.build import build
    from sparse_matrix_tpu_torch.solvers.poisson import poisson_2d_csr

    t_start = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    dev = require_device("cuda")
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(dev)} "
        f"capability {torch.cuda.get_device_capability(dev)}")
    t0 = time.perf_counter()
    lib = build(verbose=True)
    log(f"build {lib}: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    lib = host.build()
    log(f"build {lib} (g++): {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    mats = {f"poisson{n}": poisson_2d_csr(n, dtype=np.float32) for n in (512, 1024, 2048)}
    for name, _tag, m in bench_classes(SEED):
        mats[name] = m
    # the block-sparse shapes: the corpus's uniform and blocked generators
    # (blocked_2k's density, and 65536 rows so that the card has real work)
    mats["uniform8192"] = random_uniform(np.random.default_rng(SEED), 8192, 0.002)
    mats["uniform2048"] = random_uniform(np.random.default_rng(SEED), 2048, 0.01)
    mats["blocked65536"] = blocked(np.random.default_rng(SEED), 65536, 64, 0.05)
    mats["blocked2048"] = blocked(np.random.default_rng(SEED), 2048, 64, 0.05)
    # the block kernels' dense-block case: 382 whole 128 x 128 blocks
    mats["dense16384"] = dense_block_tridiagonal(np.random.default_rng(SEED), 16384, 128)
    # the hyper-sparse SpGEMM cell
    mats["uniform16384"] = random_uniform(np.random.default_rng(SEED), 16384, 0.00015)
    # part g's unsymmetric system
    mats["femlike_dominant"] = _f32(with_dominant_diagonal(mats["femlike_262k"]))
    log(f"matrices: {time.perf_counter() - t0:.2f} s")
    ops = plan_operators(dev, mats)

    chk = KernelChecks(torch, dev)
    phase_kernels(torch, dev, chk, mats, ops, c12="--c12" in sys.argv[1:])
    phase_kernels_slice3(torch, dev, chk, mats, ops)

    counts = {k: 0 for k in REPLACES}
    state = {"esc": {}}
    for part, fn in (("slice1", lambda *a: part_slice1(*a, state)), ("classes", part_classes),
                     ("multi_rhs", part_multi_rhs),
                     ("general_multi_rhs", part_general_multi_rhs),
                     ("block_sparse", part_block_sparse),
                     ("spgemm", lambda *a: part_spgemm(*a, state)),
                     ("ilu", lambda *a: part_ilu(*a, state)),
                     ("amg", lambda *a: part_amg(*a, state)),
                     ("hpcg", lambda *a: part_hpcg(*a, state))):
        kernels.reset_launch_counts()
        fn(torch, dev, mats, ops)
        torch.cuda.synchronize()
        got = dict(kernels.launch_counts)
        log(f"launch counts ({part}): {got}")
        missing = [k for k in PARTS[part] if got[k] == 0]
        if missing:
            raise AssertionError(f"kernels never launched in part {part}: {missing}")
        for k, v in got.items():
            counts[k] += v
    log(f"launch counts (main path): {counts}")
    phase_esc_kernel(torch, dev, chk, mats, state)
    log(f"spgemm record: {json.dumps({k: state[k] for k in ('engine_s', 'esc_rows', 'hyper_sparse')})}")
    phase_trisweep_kernel(torch, dev, chk, state)
    phase_krylov_kernels(torch, dev, chk, ops, state)
    phase_symgs_kernel(torch, dev, chk, state)
    log(f"ilu record: {json.dumps(state['ilu'])}")
    log(f"amg record: {json.dumps(state['amg'])}")
    log(f"hpcg record: {json.dumps(state['hpcg'])}")
    log(f"krylov record: {json.dumps(state['krylov'])}")

    record = []
    for name, (src, rep) in REPLACES.items():
        cases = chk.cases[name]
        first = cases[0]
        # the worst ms / library_ms over the kernel's cases (None where no
        # library call computes its function)
        factors = [(c["ms"] / c["library_ms"], c["case"]) for c in cases if c.get("library_ms")]
        worst = max(factors, default=(None, None))
        record.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=counts[name],
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=first["ms"], plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
            bound_by=first["bound_by"], library_ms=first["library_ms"],
            worst_library_factor=worst[0], worst_library_case=worst[1],
            case=first["case"], cases=cases,
            **{key: first[key] for key in ("launch_ms", "device_ms") if key in first},
        ))
        if worst[0] is not None:
            log(f"kernel {name:12s} worst ms/library {worst[0]:.2f} ({worst[1]})")
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
