#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``sparse_matrix_tpu_torch``) on one
NVIDIA Hopper GPU.

    python3 chip_smoke.py [--c12]

``--c12`` adds the one-off timing of ROADMAP C12 (the aligned SpMM's old
per-column spill loop against its one LanePack SpMM launch).

Phases, each of which ends the run with an exception on failure:

1. Device and build: the card's name and power limit (nvidia-smi), its
   compute capability, and the parallel nvcc build of ``csrc/*.cu``.
2. Kernels: each CUDA kernel against its plain PyTorch version on the card
   and against a float64 oracle at the main path's shapes. The SpMV and
   SpMM kernels are held to the per-row float32 bound of
   ``spmv_f64_bound`` (column by column for the SpMM kernels), the block
   SpGEMM to ``(n_ij + 2) * u * (|A||B|)_ij`` per entry of the union of
   both patterns (``+ 2 * 2^-8 * (|A||B|)_ij`` for bf16 blocks). Each case
   has CUDA-event times (median of 30 calls, 5 for the block SpGEMM) of
   the kernel, its plain version and one library call on the same inputs
   (``torch.sparse`` CSR times X, or CSR times CSR for the SpGEMM, with the
   dense ``torch.matmul`` beside it; a yardstick used nowhere in the
   port), and the bound: the larger of the bytes the product must move
   over 3.35 TB/s (the matrix once in the smallest of its plain CSR and DIA
   forms and the kernel's plan, ``matrix_bytes``, and x and y once each;
   for the block SpGEMM A and B in their smallest plain forms, at the
   width of the stored blocks, and C's entries once) and the operations
   the product needs over the data sheet's peak for their type (2*nnz*K
   for the SpMV and SpMM kernels, the BCSR SpMM included; 2 per expanded
   scalar product for the block SpGEMM; 67 TFLOP/s of f32 on the CUDA
   cores, 989 TFLOP/s of bf16 tensor cores for bf16 blocks). The dense-
   block work the block kernels do (2*bs^2*F per stored block, 2*bs^3 per
   pair) is logged beside it as ``block_flops``. TF32 must be off.
3. Main path, in six parts, each with every launch count set to 0 just
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
      randlocal_262k with its phases (expansion, sort, run reduce) and a
      re-multiply with fresh values; ``EscSpgemm`` with the SpMV reduction
      and ``FixedSideSpgemm`` on uniform 8192; the hyper-sparse cell
      (uniform 16384 at 0.015 %): ``EscSpgemm`` against ``BlockSpgemm``
      against ``torch.sparse.mm``; ``transpose_device`` and ``add_device``
      on femlike_262k against the host forms.
   Solves are checked for convergence and for their true residual (per
   column for the multi-RHS solves), products against float64: SpGEMM
   results per entry of the union of both patterns (in part f from
   three scipy float64 products), SpMV reductions against the SpMV bound
   of their selection matrix as well (ROADMAP C14).
4. Launch counts: every kernel of a part must have run in that part.
5. The ESC expansion kernel against its plain version on the plans part
   f built, bit-equal on the real slots, with its times (beside the
   reference gather engine's expansion as the yardstick) and its bound.

The last two lines are the kernels' JSON record and the result line. The
script imports nothing of JAX or of the JAX package. Without a CUDA device
it exits with 1 and prints no result.
"""

from __future__ import annotations

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
}
# the kernels each part of the main path must launch
PARTS = {
    "slice1": ("dia", "aligned", "bell"),
    "classes": ("stripe", "dia", "lanepack"),
    "multi_rhs": ("dia_spmm", "aligned_spmm"),
    "general_multi_rhs": ("lanepack_spmm", "bell_spmm"),
    "block_sparse": ("bcsr_spmm", "block_spgemm"),
    "spgemm": ("esc_expand", "block_spgemm"),
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
# H100 SXM data sheet: HBM3 bandwidth, f32 (non-tensor-core) peak and dense
# bf16 tensor-core peak
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_TC_FLOP_PER_S = 989e12
# timed calls of a block SpGEMM case (tens of ms each at uniform 8192)
SPGEMM_REPS = 5
# device arrays each kernel reads, for its plan bytes (a "spill" entry
# recurses with the spill kernel's keys)
READS = {
    "dia": ("data", "offsets"),
    "aligned": ("vals", "lane", "col_off", "chunk_rb"),
    "lanepack": ("vals", "lane", "ends", "starts", "col_off", "chunk_rb"),
    "bell": ("vals", "lane", "ds"),
    "stripe": ("vals", "lane", "ends", "starts", "stripe_rb", "col_off"),
}
SPILL_OF = {"aligned": "lanepack", "bell": "lanepack", "stripe": "stripe"}


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
              value_bytes=4, unpack=None, **bound_kw):
        """``x_np`` is (cols,) or (cols, K); ``unpack`` maps a kernel or
        plain output to (rows,) or (rows, K); ``plan_bytes`` counts the
        bytes of the plan arrays one call of the kernel reads (x and y
        apart); ``value_bytes`` is the width of the matrix values it
        reads."""
        from sparse_matrix_tpu_torch.ops.spmv import spmv_f64_bound

        torch = self.torch
        unpack = unpack or (lambda y: y)
        yk = unpack(run_kernel()).double().cpu().numpy()
        yp = unpack(run_plain()).double().cpu().numpy()
        torch.cuda.synchronize()
        xs = x_np if x_np.ndim == 2 else x_np[:, None]
        yk2 = yk if yk.ndim == 2 else yk[:, None]
        yp2 = yp if yp.ndim == 2 else yp[:, None]
        ratio = 0.0
        for q in range(xs.shape[1]):
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
                   plan_bytes=int(plan_bytes), flops=flops)
        self.cases[kernel].append(row)
        log(f"kernel {kernel:12s} {case:34s} rows={m.rows} nnz={m.nnz()} K={k} "
            f"max|k-plain|={row['max_abs_err']:.3e} max err/bound={ratio:.3f} "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
            f"bound {row['bound_ms']:.4f} ms ({nbytes} bytes / 3.35 TB/s; matrix "
            f"{matrix_bytes}, plan arrays {plan_bytes} bytes; {flops:.4g} flop / 67 "
            f"TFLOP/s), "
            f"{m.nnz() * k / ms / 1e6:.2f} Gnnz/s")


    def check_spgemm(self, case, lhs, rhs, eng, *, storage):
        """The block SpGEMM kernel of ``eng`` (a ``BlockSpgemm``) against
        its plain version on the card and, as host CSR, against the float64
        product; times the kernel, the plain version, ``torch.sparse.mm`` of
        the two CSR tensors and the dense ``torch.matmul`` (sizes to 16384)."""
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
        c = padded_to_host(eng.multiply_coo(ck))
        ratio = spgemm_f64_check(lhs, rhs, c, bf16=storage == "bf16", tag=case)
        spgemm_f64_check(lhs, rhs, padded_to_host(eng.multiply_coo(cp)),
                         bf16=storage == "bf16", tag=case + " plain")
        del ck, cp
        ms = cuda_ms(torch, eng.multiply_device, reps=SPGEMM_REPS, warmup=2)
        plain_ms = cuda_ms(torch, plain, reps=SPGEMM_REPS, warmup=1)
        a_t = library_csr(torch, lhs, self.dev)
        b_t = library_csr(torch, rhs, self.dev)
        library_ms = cuda_ms(torch, lambda: torch.sparse.mm(a_t, b_t), reps=SPGEMM_REPS,
                             warmup=2)
        dense_ms = None
        if max(lhs.rows, lhs.cols, rhs.cols) <= 16384:
            ad, bd = a_t.to_dense(), b_t.to_dense()
            dense_ms = cuda_ms(torch, lambda: torch.matmul(ad, bd), reps=SPGEMM_REPS, warmup=2)
            del ad, bd
        del a_t, b_t
        bs, pairs = eng.bs, eng.num_pairs
        # the product's own needs: A and B once in their smallest plain
        # forms (values at the stored width), C's entries written once; 2
        # flops per expanded scalar product
        vb = eng.a_blocks.element_size()
        nbytes = plain_form_bytes(lhs, vb) + plain_form_bytes(rhs, vb) + plain_form_bytes(c, 4)
        products = int(np.diff(rhs.offsets)[lhs.indices].sum())
        flops = 2.0 * products
        block_flops = 2.0 * pairs * bs ** 3
        rate = BF16_TC_FLOP_PER_S if storage == "bf16" else F32_FLOP_PER_S
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / rate * 1e3
        row = dict(case=case, rows=lhs.rows, nnz=lhs.nnz(), pairs=pairs, c_blocks=nc,
                   nnz_c=c.nnz(), storage=storage, max_abs_err=max_abs,
                   max_err_over_bound=ratio, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   dense_matmul_ms=dense_ms, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=int(nbytes), flops=flops, block_flops=block_flops)
        self.cases["block_spgemm"].append(row)
        log(f"kernel block_spgemm {case:34s} rows={lhs.rows} pairs={pairs} C blocks={nc} "
            f"nnz(C)={c.nnz()} {storage} max|k-plain|={max_abs:.3e} max err/bound={ratio:.3f} "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, torch.sparse.mm {library_ms:.4f} ms, "
            f"dense matmul {'not measured' if dense_ms is None else f'{dense_ms:.4f} ms'}, "
            f"bound {row['bound_ms']:.4f} ms ({nbytes} bytes / 3.35 TB/s; {flops:.4g} flop "
            f"of {products} scalar products / {rate / 1e12:g} TFLOP/s); dense-block work "
            f"{block_flops:.4g} flop, {block_flops / ms / 1e9:.2f} TFLOP/s")


def spgemm_f64_check(lhs, rhs, c, *, bf16: bool, tag: str) -> float:
    """Hold the host CSR ``c`` to the float64 product, entry by entry on the
    union of both patterns (``spgemm_err_over_bound``); returns the largest
    error/bound."""
    from sparse_matrix_tpu_torch.ops.spgemm_block import spgemm_err_over_bound

    ratio = spgemm_err_over_bound(lhs, rhs, c, bf16=bf16)
    if not ratio <= 1.0:
        raise AssertionError(f"block_spgemm/{tag}: off the f64 oracle (max err/bound {ratio})")
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
        chk.check(
            "dia", f"poisson2048_{tag}", a2, x_np,
            lambda: spmv_dia.spmv_dia(dia, x, device_arrays=arrs),
            lambda: spmv_dia._spmv_dia_torch(arrs["data"], x, offsets=dia.offsets,
                                             rows=dia.rows, cols=dia.cols),
            plan_bytes=arrays_bytes("dia", arrs), vals=vals,
            value_bytes=arrs["data"].element_size(),
        )
        mv = spmv_dia.dia_matvec_multi(dia, K_RHS, dev, device_arrays=arrs)
        x3 = spmv_dia.dia_pack_rhs(dia, xb)
        chk.check(
            "dia_spmm", f"poisson2048_{tag}_K{K_RHS}", a2, xb_np,
            lambda: mv(x3),
            lambda: spmv_dia._spmm_dia_torch(arrs["data"], xb, offsets=dia.offsets,
                                             rows=dia.rows),
            plan_bytes=arrays_bytes("dia", arrs),
            value_bytes=arrs["data"].element_size(),
            unpack=lambda y: spmv_dia.dia_unpack_rhs(dia, y) if y.dim() == 3 else y,
            vals=vals,
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
        chk.check("aligned", tag, m, x_np,
                  lambda plan=plan, arrs=arrs, x=x: spmv.spmv_aligned(plan, x, device_arrays=arrs),
                  plain, plan_bytes=arrays_bytes("aligned", arrs),
                  lanepack=spill)

        xb_np, xb = xblock(m)
        x3 = spmm.pack_rhs(xb, m.cols)
        mv = spmm.aligned_matvec_multi(plan, K_RHS, dev, device_arrays=arrs)

        def plain_mm(plan=plan, arrs=arrs, x3=x3):
            y3 = spmm._aligned_spmm_torch(arrs, x3, rows=plan.rows)
            if plan.spill is not None:
                y3 = y3 + spmm._lanepack_spmm_torch(arrs["spill"], x3, cols=plan.cols,
                                                    kw=plan.spill.kw)
            return y3

        chk.check("aligned_spmm", f"{tag}_K{K_RHS}", m, xb_np,
                  lambda mv=mv, x3=x3: mv(x3), plain_mm,
                  plan_bytes=arrays_bytes("aligned", arrs),
                  unpack=lambda y, m=m: spmm.unpack_rhs(y, m.rows), lanepack=spill)
        if c12 and plan.spill is not None:
            time_c12(torch, chk, plan, arrs, mv, x3)
        del arrs, mv, x3

    # stripe: the operator plans of randlocal (scan 2,2) and powerlaw (scan
    # 8,16), and a select-mode plan of randlocal with its scan-mode spill
    cases = [("randlocal_262k", ops["randlocal_262k"]._stripe),
             ("powerlaw_262k", ops["powerlaw_262k"]._stripe)]
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

        chk.check("stripe", f"{name}_{plan.mode}_L{plan.levels}_kw{plan.kw}", m, x_np,
                  lambda plan=plan, arrs=arrs, x=x: spmv.spmv_stripe(plan, x, device_arrays=arrs),
                  plain, plan_bytes=arrays_bytes("stripe", arrs),
                  stripe=(plan,))
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
            )

    # BELL: Poisson 1024^2 forced (span 128, int8 lanes) and femlike_262k
    # (span 256, int16 lanes)
    for name in ("poisson1024", "femlike_262k"):
        m = mats[name]
        plan = plan_bell(m)
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

        chk.check("bell", f"{name}_span{plan.span}", m, x_np,
                  lambda plan=plan, arrs=arrs, x=x: spmv_bell.spmv_bell(plan, x, device_arrays=arrs),
                  plain, plan_bytes=arrays_bytes("bell", arrs),
                  lanepack=() if plan.spill is None else (plan.spill,))
    chk._csr.clear()


def time_c12(torch, chk, plan, arrs, mv, x3):
    """ROADMAP C12 (``--c12``): the aligned SpMM with its LanePack spill run
    the old way (the aligned kernel, then per column a strided copy of x,
    one LanePack SpMV launch and one add into y3) against the packed matvec
    ``mv``, whose spill is one LanePack SpMM launch for all K columns;
    timed in turns (before, after, after, before) in this call."""
    from sparse_matrix_tpu_torch.native.kernels import launch_aligned_spmm
    from sparse_matrix_tpu_torch.ops import spmv

    r128, k = plan.r128, x3.shape[1]

    def before():
        y3 = torch.zeros_like(x3)
        launch_aligned_spmm(arrs["vals"], arrs["lane"], arrs["col_off"], arrs["chunk_rb"],
                            x3, y3, cols=plan.cols)
        for q in range(k):
            xq = x3[:, q, :].reshape(-1)[: plan.cols].contiguous()
            yq = torch.zeros(r128 * 128, dtype=x3.dtype, device=x3.device)
            spmv._lanepack_cuda(arrs["spill"], xq, yq)
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
    cases = [("poisson1024", ops["poisson1024_lanepack"]._plan, ops["poisson1024_lanepack"]._lp_arrs),
             ("randlocal_262k", ops["randlocal_262k_lanepack"]._plan,
              ops["randlocal_262k_lanepack"]._lp_arrs),
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
                  plan_bytes=arrays_bytes("lanepack", arrs),
                  unpack=lambda y, m=m: spmm.unpack_rhs(y, m.rows), lanepack=(plan,))
    del cases, arrs
    # ... and the spill of randlocal's aligned plan in the aligned layout (one
    # guard row: the kernel reads zeros past cols), the C12 path
    op = ops["randlocal_262k_aligned"]
    sp_plan, sp_arrs = op._aligned.spill, op._ali_arrs["spill"]
    sub = aligned_spill_csr(mats["randlocal_262k"], op._aligned)
    x_np, x = xblock(sub)
    x3 = spmm.pack_rhs(x, sub.cols)
    chk.check("lanepack_spmm", f"randlocal_262k_aligned_spill_kw{sp_plan.kw}_K{K_RHS}", sub, x_np,
              lambda: spmm.spmm_lanepack_packed(sp_plan, x3, device_arrays=sp_arrs),
              lambda: spmm._lanepack_spmm_torch(sp_arrs, x3, cols=sp_plan.cols, kw=sp_plan.kw),
              plan_bytes=arrays_bytes("lanepack", sp_arrs),
              unpack=lambda y: spmm.unpack_rhs(y, sub.rows), lanepack=(sp_plan,))
    del sub, x3

    # B8: Poisson 1024^2 span 128 at K=8 and 16, femlike_262k span 256 at K=8
    t0 = time.perf_counter()
    fem_plan = plan_bell(mats["femlike_262k"])
    log(f"plan femlike_262k bell: span={fem_plan.span} layers={fem_plan.num_layers} "
        f"{time.perf_counter() - t0:.2f} s")
    from sparse_matrix_tpu_torch.ops.spmv_bell import bell_device_arrays

    pb = ops["poisson1024_bell"]
    for name, plan, arrs, k in (("poisson1024", pb._bell, pb._bell_arrs, 8),
                                ("poisson1024", pb._bell, pb._bell_arrs, 16),
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

        chk.check("bell_spmm", f"{name}_span{plan.span}_K{k}", m, x_np,
                  lambda plan=plan, arrs=arrs, x=x: spmm.spmm_bell(plan, x, device_arrays=arrs),
                  plain, plan_bytes=arrays_bytes("bell", arrs),
                  lanepack=() if plan.spill is None else (plan.spill,))
    del fem_plan, arrs

    # B10: the block-tridiagonal 65536^2 matrix and the corpus's blocked_2k
    # size, bs 128, X of 128 columns
    for name in ("blocked65536", "blocked2048"):
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
                         for key in ("blocks", "block_cols", "block_offsets"))
        chk.check("bcsr_spmm", f"{name}_bs{b.bs}_F128", m, x_np,
                  lambda b=b, arrs=arrs, x=x: spmm.spmm_bcsr(b, x, device_arrays=arrs), plain,
                  plan_bytes=plan_bytes)
        row = chk.cases["bcsr_spmm"][-1]
        row["block_flops"] = 2.0 * b.nnzb * b.bs ** 2 * 128
        log(f"kernel bcsr_spmm {row['case']}: dense-block work {row['block_flops']:.4g} "
            f"flop, {row['block_flops'] / row['ms'] / 1e9:.2f} TFLOP/s")
        del b, arrs

    # B11: U @ U for uniform 8192^2 at 0.2 % in f32 and bf16 storage, the
    # block-tridiagonal 65536^2 matrix squared, uniform 2048^2 at 1 % squared
    for case, name, storage in (("uniform8192_f32", "uniform8192", "f32"),
                                ("uniform8192_bf16", "uniform8192", "bf16"),
                                ("blocked65536_f32", "blocked65536", "f32"),
                                ("uniform2048_f32", "uniform2048", "f32")):
        m = mats[name]
        t0 = time.perf_counter()
        eng = BlockSpgemm(m, m, device=dev, storage=storage)
        torch.cuda.synchronize()
        log(f"plan {case} BlockSpgemm: pairs={eng.num_pairs} C blocks={len(eng.c_keys)} "
            f"{time.perf_counter() - t0:.2f} s")
        chk.check_spgemm(case, m, m, eng, storage=storage)
        del eng
        torch.cuda.empty_cache()
    chk._csr.clear()


def _report_solve(torch, tag, fmt, tol, iterations, rec, true_res, bound_true, wall, step):
    """Log iterations, residuals, wall and device ms per iteration and the
    host's share of the wall time (``rec``, ``true_res``, ``bound_true``
    relative to |b|, worst column for multi-RHS solves). ``step`` runs one
    iteration of the solver's own step function, without its host read."""
    dev_ms = device_ms_per_call(torch, step)
    it = max(iterations, 1)
    ms_it = wall * 1e3 / it
    log(f"main {tag}: format={fmt} tol={tol:g} iterations={iterations} "
        f"|r|/|b|={rec:.3e} true |b-Ax|/|b|={true_res:.3e} "
        f"(f32 bound eps*cond={bound_true:.3e}) wall {wall:.3f} s, "
        f"{ms_it:.4f} ms/iter, device {dev_ms:.4f} ms/iter, "
        f"host share {max(0.0, 1 - dev_ms / ms_it):.3f}")


def solve_and_check(torch, dev, tag, a, n, solve, op, tol=CG_TOL, ir=False):
    """Run ``solve(b)``, check convergence and the true residual, print
    iterations, ms/iteration and the host's share of the wall time; the
    device time is that of ``cg_solve``'s iteration over ``op`` (of
    ``cg_solve_ir``'s inner iteration where ``ir``)."""
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
    step_fn = cg._ir_inner_step if ir else cg._cg_step
    state = (torch.zeros_like(b), b.clone(), b.clone(), torch.dot(b, b))

    def step():
        nonlocal state
        state = step_fn(op, *state)

    _report_solve(torch, tag, op.format, tol, res.iterations, rec / bnorm, true_res / bnorm,
                  bound_true / bnorm, wall, step)
    if not ok:
        raise AssertionError(f"{tag}: CG did not converge within the bounds")
    return res


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


def part_slice1(torch, dev, mats, ops):
    from sparse_matrix_tpu_torch.entry import entry
    from sparse_matrix_tpu_torch.ops.operator import SpmvOperator
    from sparse_matrix_tpu_torch.solvers.cg import cg_solve, cg_solve_ir

    a2 = mats["poisson2048"]
    op = ops["poisson2048"]
    solve_and_check(torch, dev, "cg poisson2048 dia f32", a2, 2048,
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
        st = op._stripe
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
        ms = _class_apply(torch, dev, name, m, opc, x_np, lanepack=(opc._plan,))
        log(f"main class {name} forced: format={opc.format} kw={opc._plan.kw} "
            f"pack={opc._plan.pack} {ms:.4f} ms/apply, {m.nnz() / ms / 1e6:.2f} Gnnz/s")


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
    dia = ops["poisson2048"]._dia
    solve_multi_and_check(
        torch, dev, f"cg_multi poisson2048 dia K={K_RHS}", "dia packed", a2, 2048,
        spmv_dia.dia_matvec_multi(dia, K_RHS, dev, device_arrays=ops["poisson2048"]._dia_arrs),
        lambda b: spmv_dia.dia_pack_rhs(dia, b), lambda x3: spmv_dia.dia_unpack_rhs(dia, x3))
    a1 = mats["poisson1024"]
    op_a = ops["poisson1024_aligned"]
    solve_multi_and_check(
        torch, dev, f"cg_multi poisson1024 aligned K={K_RHS}", "aligned packed", a1, 1024,
        spmm.aligned_matvec_multi(op_a._aligned, K_RHS, dev, device_arrays=op_a._ali_arrs),
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
        lp = () if op._plan is None else (op._plan,)
        if op._aligned is not None and op._aligned.spill is not None:
            lp = (op._aligned.spill,)
        if op._bell is not None and op._bell.spill is not None:
            lp = (op._bell.spill,)
        _matmat_check(torch, dev, f"{name} {opname.split('_')[-1]}", mats[name], op, rng,
                      lanepack=lp)

    a1 = mats["poisson1024"]
    op_l = ops["poisson1024_lanepack"]
    kw = op_l._plan.kw
    solve_multi_and_check(
        torch, dev, f"cg_multi poisson1024 lanepack K={K_RHS}", "lanepack packed", a1, 1024,
        spmm.lanepack_matvec_multi(op_l._plan, K_RHS, dev, device_arrays=op_l._lp_arrs),
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
        ratio = spgemm_f64_check(u, u, c, bf16=storage == "bf16", tag=f"main uniform8192 {storage}")
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
    ratio = spgemm_f64_check(b, b, c, bf16=False, tag="main blocked65536")
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
    stand-in once, band convolution where banded, the dense matmul to 16384
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
    """CUDA-event ms of EscSpgemm.multiply_device and of its phases:
    expansion (the ESC expansion kernel), key sort, gather by the sort
    order and run reduce."""
    from sparse_matrix_tpu_torch.ops.device_sorted import _packed_run_reduce
    from sparse_matrix_tpu_torch.ops.esc_expand import expand_products

    xp = eng._xplan

    def expand():
        return expand_products(xp, eng.lhs_vals_csc, eng.rhs_vals,
                               device_arrays=eng._expand_arrs)

    p = expand()
    k_s, order = torch.sort(eng.out_key, stable=True)
    out = dict(
        multiply_device_ms=cuda_ms(torch, eng.multiply_device, reps=10, warmup=2),
        expand_ms=cuda_ms(torch, expand, reps=10, warmup=2),
        sort_ms=cuda_ms(torch, lambda: torch.sort(eng.out_key, stable=True), reps=10, warmup=2),
        reduce_ms=cuda_ms(torch, lambda: _packed_run_reduce(k_s, p[order], eng.rows, eng.cols),
                          reps=10, warmup=2),
    )
    del p, k_s, order
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
            f"multiply_device {phases['multiply_device_ms']:.4f} ms (expansion "
            f"{phases['expand_ms']:.4f}, sort {phases['sort_ms']:.4f}, gather and run reduce "
            f"{phases['reduce_ms']:.4f} ms), torch.sparse.mm {lib_ms:.4f} ms; "
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
    """The ESC expansion kernel (B12) against its plain version on the
    card, bit-equal on the real slots, on the plans part f built (planned
    here where part f did not): times of the kernel, the plain version
    and the reference gather engine's expansion (``lhs_vals[src] *
    rhs_vals[q]``, two torch gathers and a multiply: the yardstick, no
    single PyTorch call computes the expansion), and the bound: A and B
    once in CSR (f32 values, int32 indices and offsets) and 4 bytes per
    product written, over 3.35 TB/s."""
    from sparse_matrix_tpu_torch.ops.device_sorted import EscSpgemm, expand_plan
    from sparse_matrix_tpu_torch.ops.esc_expand import _expand_torch, expand_products

    for name in ("femlike_262k", "randlocal_262k", "uniform8192", "uniform16384"):
        if name in state["esc"]:
            m, eng = state["esc"][name]
        else:
            m = _f32(mats[name])
            eng = EscSpgemm(m, m, device=dev, reduce="sort")
        xp, arrs = eng._xplan, eng._expand_arrs
        lv, rv = eng.lhs_vals_csc, eng.rhs_vals
        n = xp.num_products

        def kernel(xp=xp, arrs=arrs, lv=lv, rv=rv):
            return expand_products(xp, lv, rv, device_arrays=arrs)

        def plain(xp=xp, arrs=arrs, lv=lv, rv=rv):
            return _expand_torch(lv, rv, arrs["lv_lane"], arrs["rv_lane"], arrs["lv_off"],
                                 arrs["rv_off"], num_products=xp.num_products)

        pk, pp = kernel(), plain()
        torch.cuda.synchronize()
        if not (torch.equal(pk[:n], pp[:n]) and not bool(pk[n:].any())):
            raise AssertionError(f"esc_expand/{name}: kernel and plain version differ")
        max_abs = float((pk - pp).abs().max())
        del pk, pp
        src, q, _ = expand_plan(m, m)
        src = torch.from_numpy(src).to(dev).long()
        q = torch.from_numpy(q).to(dev).long()
        lvals = torch.from_numpy(m.vals).to(dev)
        ms = cuda_ms(torch, kernel)
        plain_ms = cuda_ms(torch, plain)
        yard_ms = cuda_ms(torch, lambda: lvals[src] * rv[q])
        del src, q, lvals
        nbytes = 2 * (m.nnz() * 8 + (m.rows + 1) * 4) + 4 * n
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = n / F32_FLOP_PER_S * 1e3
        row = dict(case=name, rows=m.rows, nnz=m.nnz(), products=n, slabs=xp.num_slabs,
                   kw_lv=xp.kw_lv, kw_rv=xp.kw_rv, max_abs_err=max_abs, ms=ms,
                   plain_ms=plain_ms, library_ms=None, yardstick_ms=yard_ms,
                   yardstick="the gather engine's expansion lhs_vals[src] * rhs_vals[q]: two "
                             "torch gathers and a multiply (no single PyTorch call)",
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes >= t_ops else "operations",
                   bytes=int(nbytes), flops=float(n))
        chk.cases["esc_expand"].append(row)
        log(f"kernel esc_expand   {name:34s} rows={m.rows} nnz={m.nnz()} products={n} "
            f"kw={xp.kw_lv}/{xp.kw_rv} bit-equal to plain, kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, gather yardstick {yard_ms:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({nbytes} bytes / 3.35 TB/s), {n / ms / 1e6:.2f} "
            f"Gprod/s")
    state["esc"].clear()
    torch.cuda.empty_cache()


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
        st = op._stripe
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

    from sparse_matrix_tpu_torch.bench.corpus import bench_classes, blocked, random_uniform
    from sparse_matrix_tpu_torch.device import require_device
    from sparse_matrix_tpu_torch.native import kernels
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
    mats = {f"poisson{n}": poisson_2d_csr(n, dtype=np.float32) for n in (512, 1024, 2048)}
    for name, _tag, m in bench_classes(SEED):
        mats[name] = m
    # the block-sparse shapes: the corpus's uniform and blocked generators
    # (blocked_2k's density, and 65536 rows so that the card has real work)
    mats["uniform8192"] = random_uniform(np.random.default_rng(SEED), 8192, 0.002)
    mats["uniform2048"] = random_uniform(np.random.default_rng(SEED), 2048, 0.01)
    mats["blocked65536"] = blocked(np.random.default_rng(SEED), 65536, 64, 0.05)
    mats["blocked2048"] = blocked(np.random.default_rng(SEED), 2048, 64, 0.05)
    # the hyper-sparse SpGEMM cell
    mats["uniform16384"] = random_uniform(np.random.default_rng(SEED), 16384, 0.00015)
    log(f"matrices: {time.perf_counter() - t0:.2f} s")
    ops = plan_operators(dev, mats)

    chk = KernelChecks(torch, dev)
    phase_kernels(torch, dev, chk, mats, ops, c12="--c12" in sys.argv[1:])
    phase_kernels_slice3(torch, dev, chk, mats, ops)

    counts = {k: 0 for k in REPLACES}
    state = {"esc": {}}
    for part, fn in (("slice1", part_slice1), ("classes", part_classes),
                     ("multi_rhs", part_multi_rhs),
                     ("general_multi_rhs", part_general_multi_rhs),
                     ("block_sparse", part_block_sparse),
                     ("spgemm", lambda *a: part_spgemm(*a, state))):
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

    record = []
    for name, (src, rep) in REPLACES.items():
        cases = chk.cases[name]
        first = cases[0]
        record.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=counts[name],
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=first["ms"], plain_ms=first["plain_ms"], bound_ms=first["bound_ms"],
            bound_by=first["bound_by"], library_ms=first["library_ms"],
            case=first["case"], cases=cases,
        ))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
