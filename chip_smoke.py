#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``sparse_matrix_tpu_torch``) on one
NVIDIA Hopper GPU.

    python3 chip_smoke.py

Phases, each of which ends the run with an exception on failure:

1. Device and build: the card's name and power limit (nvidia-smi), its
   compute capability, and the nvcc build of ``csrc/*.cu``.
2. Kernels: each CUDA kernel against its plain PyTorch version on the card
   and against a float64 CSR product with the per-row float32 bound of
   ``spmv_f64_bound``, at the main path's shapes, with CUDA-event times
   (median of 30 applies) for both.
3. Main path, with every launch count set to 0 first: CG through
   ``SpmvOperator`` on Poisson 2048^2 (auto-dispatched to DIA), the same
   with bf16 band planes through ``cg_solve_ir``, CG on the aligned and the
   BELL formats, the ``entry()`` step, and the bench's three 262k-row
   classes through LanePack operators. Solves are checked for convergence
   and for their true residual.
4. Launch counts: every kernel must have run in phase 3.

The last two lines are the kernels' JSON record and the result line. The
script imports nothing of JAX. Without a CUDA device it exits with 1 and
prints no result.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np

REPLACES = {
    "dia": ("sparse_matrix_tpu_torch/csrc/spmv_dia.cu",
            "sparse_matrix_tpu/ops/spmv_dia.py:83"),
    "aligned": ("sparse_matrix_tpu_torch/csrc/spmv_aligned.cu",
                "sparse_matrix_tpu/ops/spmv.py:348"),
    "lanepack": ("sparse_matrix_tpu_torch/csrc/spmv_lanepack.cu",
                 "sparse_matrix_tpu/ops/spmv.py:77"),
    "bell": ("sparse_matrix_tpu_torch/csrc/spmv_bell.cu",
             "sparse_matrix_tpu/ops/spmv_bell.py:80"),
}
SEED = 0
CG_TOL = 1e-5
# cg_solve_ir stops on the residual b - A x evaluated in f32, whose rounding
# floor at Poisson 2048^2 is about 2e-5 |b| (measured on the H100: 20000
# inner iterations ended at 2.2e-5); its target sits above that floor
IR_TOL = 1e-4
EPS_F32 = 2.0 ** -23


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


class KernelChecks:
    """Phase 2: kernel vs plain version vs float64 oracle, with times."""

    def __init__(self, torch):
        self.torch = torch
        self.cases = {k: [] for k in REPLACES}

    def check(self, kernel, case, m, x_np, run_kernel, run_plain, **bound_kw):
        from sparse_matrix_tpu_torch.ops.spmv import spmv_f64_bound

        torch = self.torch
        y_k = run_kernel()
        y_p = run_plain()
        torch.cuda.synchronize()
        yk, yp = y_k.double().cpu().numpy(), y_p.double().cpu().numpy()
        y64, bound = spmv_f64_bound(m, x_np, **bound_kw)
        err_k = np.abs(yk - y64)
        err_p = np.abs(yp - y64)
        if not (np.all(np.isfinite(yk)) and np.all(err_k <= bound)):
            i = int(np.argmax(err_k - bound))
            raise AssertionError(
                f"{kernel}/{case}: kernel off the f64 oracle at row {i}: "
                f"|err| {err_k[i]:.3e} > bound {bound[i]:.3e}"
            )
        if not np.all(err_p <= bound):
            i = int(np.argmax(err_p - bound))
            raise AssertionError(
                f"{kernel}/{case}: plain version off the f64 oracle at row {i}"
            )
        ms = cuda_ms(torch, run_kernel)
        plain_ms = cuda_ms(torch, run_plain)
        row = dict(case=case, rows=m.rows, nnz=m.nnz(),
                   max_abs_err=float(np.max(np.abs(yk - yp))),
                   max_err_over_bound=float(np.max(err_k / np.maximum(bound, 1e-300))),
                   ms=ms, plain_ms=plain_ms)
        self.cases[kernel].append(row)
        log(f"kernel {kernel:8s} {case:28s} rows={m.rows} nnz={m.nnz()} "
            f"max|k-plain|={row['max_abs_err']:.3e} "
            f"max err/bound={row['max_err_over_bound']:.3f} "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"{m.nnz() / ms / 1e6:.2f} Gnnz/s")


def phase_kernels(torch, dev, chk: KernelChecks, mats):
    from sparse_matrix_tpu.formats.aligned import plan_aligned
    from sparse_matrix_tpu.formats.bell import plan_bell
    from sparse_matrix_tpu.formats.dia import try_dia_from_csr
    from sparse_matrix_tpu.formats.lanepack import plan_lanepack
    from sparse_matrix_tpu_torch.ops import spmv, spmv_bell, spmv_dia

    rng = np.random.default_rng(SEED)

    def xvec(m):
        x_np = rng.standard_normal(m.cols).astype(np.float32)
        return x_np, torch.from_numpy(x_np).to(dev)

    # DIA: Poisson 2048^2, f32 and bf16 band planes
    a2 = mats["poisson2048"]
    dia = try_dia_from_csr(a2, dtype=np.float32)
    x_np, x = xvec(a2)
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
            vals=vals,
        )

    # aligned: Poisson 1024^2 (no spill) and randlocal_262k (LanePack spill)
    for name in ("poisson1024", "randlocal_262k"):
        m = mats[name]
        plan = plan_aligned(m)
        arrs = spmv.aligned_device_arrays(plan, dev)
        x_np, x = xvec(m)

        def plain(plan=plan, arrs=arrs, x=x):
            y = spmv._aligned_torch(arrs, x, rows=plan.rows, cols=plan.cols)
            if plan.spill is not None:
                y = y + spmv._lanepack_torch(arrs["spill"], x, rows=plan.rows,
                                             cols=plan.cols, kw=plan.spill.kw)
            return y

        tag = name + ("_spill" if plan.spill is not None else "")
        chk.check("aligned", tag, m, x_np,
                  lambda plan=plan, arrs=arrs, x=x: spmv.spmv_aligned(plan, x, device_arrays=arrs),
                  plain, lanepack=() if plan.spill is None else (plan.spill,))

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
                lanepack=(plan,),
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
                  plain, lanepack=() if plan.spill is None else (plan.spill,))


def solve_and_check(torch, dev, tag, a, n, solve, op, tol=CG_TOL):
    """Run ``solve(b)``, check convergence and the true residual, print
    iterations, ms/iteration and the host's share of the wall time."""
    from sparse_matrix_tpu_torch.ops.spmv import spmv_f64_bound

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
    # device time of one CG iteration: the same step, with the host out of
    # the way (device_ms_per_call)
    p = b.clone()
    r = b.clone()
    x = torch.zeros_like(b)
    rs = torch.dot(r, r)

    def step():
        nonlocal x, p, r, rs
        ap = op(p)
        alpha = rs / torch.dot(p, ap)
        x = x + alpha * p
        r = r - alpha * ap
        rs_new = torch.dot(r, r)
        p = r + (rs_new / rs) * p
        rs = rs_new

    dev_ms = device_ms_per_call(torch, step)
    it = max(res.iterations, 1)
    ms_it = wall * 1e3 / it
    log(f"main {tag}: format={op.format} tol={tol:g} iterations={res.iterations} "
        f"|r|/|b|={rec / bnorm:.3e} true |b-Ax|/|b|={true_res / bnorm:.3e} "
        f"(f32 bound eps*cond={bound_true / bnorm:.3e}) wall {wall:.3f} s, "
        f"{ms_it:.4f} ms/iter, device {dev_ms:.4f} ms/iter, "
        f"host share {max(0.0, 1 - dev_ms / ms_it):.3f}")
    if not ok:
        raise AssertionError(f"{tag}: CG did not converge within the bounds")
    return res


def phase_main(torch, dev, mats):
    from sparse_matrix_tpu_torch.entry import entry
    from sparse_matrix_tpu_torch.ops.operator import SpmvOperator
    from sparse_matrix_tpu_torch.ops.spmv import spmv_f64_bound
    from sparse_matrix_tpu_torch.solvers.cg import cg_solve, cg_solve_ir

    a2 = mats["poisson2048"]
    t0 = time.perf_counter()
    op = SpmvOperator(a2, device=dev)
    log(f"plan poisson2048 auto: format={op.format} "
        f"bytes/apply={op.bytes_per_apply()} {time.perf_counter() - t0:.2f} s")
    if op.format != "dia":
        raise AssertionError(f"Poisson 2048^2 dispatched to {op.format}, expected dia")
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
                    op_lo, tol=IR_TOL)
    del op, op_lo

    a1 = mats["poisson1024"]
    op_a = SpmvOperator(a1, device=dev, force="aligned")
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

    # the bench's class rows; the reference dispatches randlocal and
    # powerlaw to stripe, which is not ported, so all three are forced to
    # the general LanePack format here
    rng = np.random.default_rng(SEED)
    for name in ("femlike_262k", "randlocal_262k", "powerlaw_262k"):
        m = mats[name]
        opc = SpmvOperator(m, device=dev, force="lanepack")
        x_np = rng.standard_normal(m.cols).astype(np.float32)
        x = torch.from_numpy(x_np).to(dev)
        for _ in range(10):
            y = opc(x)
        y64, bound = spmv_f64_bound(m, x_np, lanepack=(opc._plan,))
        if not np.all(np.abs(y.cpu().numpy() - y64) <= bound):
            raise AssertionError(f"{name}: LanePack operator off the f64 oracle")
        ms = cuda_ms(torch, lambda: opc(x))
        log(f"main class {name}: format={opc.format} kw={opc._plan.kw} "
            f"pack={opc._plan.pack} {ms:.4f} ms/apply, {m.nnz() / ms / 1e6:.2f} Gnnz/s")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 1

    from sparse_matrix_tpu_torch.bench.corpus import bench_classes
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
    log(f"matrices: {time.perf_counter() - t0:.2f} s")

    chk = KernelChecks(torch)
    phase_kernels(torch, dev, chk, mats)

    kernels.reset_launch_counts()
    phase_main(torch, dev, mats)
    torch.cuda.synchronize()
    counts = dict(kernels.launch_counts)
    log(f"launch counts (main path): {counts}")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: {missing}")

    record = []
    for name, (src, rep) in REPLACES.items():
        cases = chk.cases[name]
        record.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=counts[name],
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=cases[0]["ms"], plain_ms=cases[0]["plain_ms"],
            case=cases[0]["case"], cases=cases,
        ))
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": record}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
