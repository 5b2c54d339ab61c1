"""Times the SpMV kernels of one checkout of the port on the card: DIA
(B1), aligned (B2), LanePack (B3), BELL (B4) and stripe (B5), the DIA
(B9), aligned (B6), LanePack (B7) and BELL (B8) SpMM kernels and the
fused triangular sweeps (B13), so that two checkouts compare in one run:

    python3 sparse_matrix_tpu_torch/bench/spmv_times.py [--tree DIR]
        [--kinds dia,aligned,lanepack,bell,stripe,dia_spmm,aligned_spmm,lanepack_spmm,
                 bell_spmm,trisweep]

imports ``sparse_matrix_tpu_torch`` from the checkout at DIR (default: the
one holding this file) and prints one JSON line with, per case:

* ``ms``: ``spmv_aligned`` / ``spmv_lanepack`` / ``spmv_bell`` /
  ``spmv_stripe`` through the wrapper a user calls (device arrays built
  beforehand), median of 30;
* ``launch_ms``: the bare kernel launch(es) through the launch records of
  the device arrays (the first writes y, every spill adds), the host's
  launch path included, median of 30;
* ``device_ms``: the bare launches with no host gaps (20 calls enqueued
  behind a sleep kernel, timed together);
* ``library_ms``: ``torch.mv`` of the ``torch.sparse`` CSR tensor on the
  same x (a yardstick, used nowhere in the port);
* ``bitwise_repeat``: whether two wrapper calls on one x gave equal bits.

The cases: Poisson 2048^2 DIA (``spmv_dia``; the bare launch is the
device arrays' launch record) with f32 and bf16 band planes, and its DIA
SpMM at K = 8 through ``dia_matvec_multi`` (the bare launch its
``spmm_launch`` record); Poisson 1024^2 aligned; randlocal_262k aligned with its
LanePack spill; femlike_262k, randlocal_262k and powerlaw_262k LanePack
in the ``dense`` and ``per_rb`` packs (the planner's own ``kw``); BELL on
Poisson 1024^2 (span 128, f32 and bf16 value planes), femlike_262k (span
256) and randlocal_262k (span 128 with its LanePack spill); stripe
scan(2,2) on randlocal_262k and scan(8,16) on powerlaw_262k (the
operator's plans) and the select plan of randlocal_262k with its
scan-mode spill. The matrices are chip_smoke.py's, x from seed 0.

The SpMM cases, at K = 8 (X from seed 0): B7 through
``spmm_lanepack_packed`` on the forced LanePack plans of Poisson 1024^2
and randlocal_262k, on powerlaw_262k's kw16 plan and on the LanePack
spill of randlocal_262k's aligned plan (``library_ms`` of the whole
matrix there), and on Poisson 1024^2 through ``spmm_lanepack`` (X and Y
row-major, ``rowmajor``) and through ``pack_rhs``,
``spmm_lanepack_packed`` and ``unpack_rhs`` (``viapacked``); B8 through
``spmm_bell`` on Poisson 1024^2 (K = 8 and 16) and femlike_262k. Each
SpMM row adds ``call_device_ms``, the wrapper call's device time with no
host gaps.

B6, at K = 8: through ``spmm_aligned_packed`` (``packed``) and
``spmm_aligned`` (``rowmajor``) on Poisson 1024^2 and on randlocal_262k
with its LanePack spill, and on Poisson 1024^2 through ``pack_rhs``,
``spmm_aligned_packed`` and ``unpack_rhs`` (``viapacked``); the bare
launch adds the spill's LanePack SpMM in add mode, except in
randlocal's ``nospill`` row, whose bare launch is the aligned kernel
alone (packed).

B13, at 4 sweeps: ``trisweep`` on L and L^T of Poisson 2048^2's IC(0) and
on L and U of femlike_262k's ILU(0) (made diagonally dominant, as in
chip_smoke.py), each with ``equal_plain`` (bit-equal to
``_trisweep_torch``); on Poisson 2048^2's L also at 1024, 2048 and 8192
rows a chunk.

Design-search options: ``--sweeps 0,1,4`` times B13 at each sweep count
(default 4), ``--chunk-rows 1024,8192`` sets the extra chunk sizes of
Poisson 2048^2's L (default 1024,2048,8192), and ``--segment-chunks G``
plans every aligned and LanePack segment with at most G chunks (the
checkout's ``ops.spmv.SEGMENT_CHUNKS``, 32 by default).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import warnings

import numpy as np

KINDS = ("dia", "aligned", "lanepack", "bell", "stripe", "dia_spmm", "aligned_spmm",
         "lanepack_spmm", "bell_spmm", "trisweep")
TRISWEEP_SWEEPS = 4
K_RHS = 8


def _cuda_ms(torch, fn, reps: int = 30, warmup: int = 10) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        events.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def _device_ms(torch, fn, calls: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(500_000_000)  # about 0.25 s: the host enqueues meanwhile
    s.record()
    for _ in range(calls):
        fn()
    held = not s.query()  # the sleep still held the stream when the last call was enqueued
    e.record()
    torch.cuda.synchronize()
    if not held:
        raise AssertionError("the host enqueued the calls more slowly than the hold")
    return s.elapsed_time(e) / calls


def _chain(plan, arrs):
    """(plan, arrays) of a plan and its spill sub-plans, outermost first."""
    while plan is not None:
        yield plan, arrs
        plan, arrs = getattr(plan, "spill", None), arrs.get("spill")  # LanePack: no spill


def _bare_launch(torch, plan, arrs, x):
    """The bare launch(es) of one call through the launch records: the
    first writes y, every spill sub-plan's adds into it."""
    y = torch.empty(plan.rows, dtype=torch.float32, device=x.device)
    recs = [a["launch"] for _p, a in _chain(plan, arrs)]

    def run():
        recs[0](x, y)
        for rec in recs[1:]:
            rec(x, y, add=True)

    return run


def _dia_case(torch, kind, m, variant, dev):
    """(case name, wrapper call, bare launch, x, K) of a DIA case (B1, or
    B9 at K = 8) with ``variant`` f32 or bf16 band planes."""
    from sparse_matrix_tpu_torch.formats.dia import try_dia_from_csr
    from sparse_matrix_tpu_torch.ops import spmv_dia

    dia = try_dia_from_csr(m, dtype=np.float32)
    vdt = torch.bfloat16 if variant == "bf16" else None
    arrs = spmv_dia.dia_device_arrays(dia, dev, values_dtype=vdt)
    k = 1 if kind == "dia" else K_RHS
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((m.cols, k))
                         .astype(np.float32)).to(dev)
    if kind == "dia":
        x = x[:, 0].contiguous()
        y = torch.empty(m.rows, device=dev)
        return (f"poisson2048_{variant}", lambda: spmv_dia.spmv_dia(dia, x, device_arrays=arrs),
                lambda: arrs["launch"](x, y), x, k)
    mv = spmv_dia.dia_matvec_multi(dia, k, dev, device_arrays=arrs)
    x3 = spmv_dia.dia_pack_rhs(dia, x)
    y3 = torch.empty_like(x3)
    mv(x3)  # makes the SpMM kernel's record, ``spmm_launch``
    return (f"poisson2048_{variant}_K{k}", lambda: mv(x3),
            lambda: arrs["spmm_launch"](x3, y3), x, k)


def _spmm_case(torch, kind, name, variant, m, ops, dev):
    """(case name, wrapper call, bare launch) of an SpMM case."""
    from sparse_matrix_tpu_torch.formats.bell import plan_bell
    from sparse_matrix_tpu_torch.formats.lanepack import plan_lanepack
    from sparse_matrix_tpu_torch.ops import spmm, spmv, spmv_bell

    k = variant[1] if kind == "bell_spmm" else K_RHS
    X = torch.from_numpy(np.random.default_rng(0).standard_normal((m.cols, k))
                         .astype(np.float32)).to(dev)
    if kind == "bell_spmm":
        plan = plan_bell(m)
        arrs = spmv_bell.bell_device_arrays(plan, dev)
        case = f"{name}_span{plan.span}_K{k}" + ("_spill" if plan.spill is not None else "")
        y = torch.empty((plan.rows, k), device=dev)

        def bare():
            arrs["spmm_launch"](X, y)
            if plan.spill is not None:
                arrs["spill"]["spmm_launch"](X, y, add=True)
        return case, lambda: spmm.spmm_bell(plan, X, device_arrays=arrs), bare
    layout, spill = variant
    if spill:
        part = ops[name, "aligned"].part("aligned")
        plan, arrs = part.plan.spill, part.arrays["spill"]
        case, guard = f"{name}_aligned_spill_kw{plan.kw}_K{k}", 1
    else:
        part = ops[name, "lanepack"].part("lanepack") if (name, "lanepack") in ops else None
        plan, arrs = (part.plan, part.arrays) if part else (plan_lanepack(m), None)
        if arrs is None:
            arrs = spmv.lanepack_device_arrays(plan, dev)
        case, guard = f"{name}_{plan.pack}_kw{plan.kw}_K{k}_{layout}", plan.kw
    x3 = spmm.pack_rhs(X, plan.cols, guard=guard)
    if layout == "rowmajor":
        call = lambda: spmm.spmm_lanepack(plan, X, device_arrays=arrs)  # noqa: E731
    elif layout == "viapacked":
        call = lambda: spmm.unpack_rhs(spmm.spmm_lanepack_packed(  # noqa: E731
            plan, spmm.pack_rhs(X, plan.cols, guard=guard), device_arrays=arrs), plan.rows)
    else:
        call = lambda: spmm.spmm_lanepack_packed(plan, x3, device_arrays=arrs)  # noqa: E731
    y3 = torch.empty((plan.r128, k, 128), device=dev)
    y = torch.empty((plan.rows, k), device=dev)
    if layout == "rowmajor":
        def bare():
            arrs["spmm_launch"](X, y)
    else:
        def bare():
            arrs["spmm_launch"](x3, y3, packed=True)
    return case, call, bare


def _aligned_spmm_case(torch, name, layout, m, ops, dev):
    """(case name, wrapper call, bare launch) of an aligned SpMM case."""
    from sparse_matrix_tpu_torch.ops import spmm

    op = ops[name, "aligned"]
    plan, arrs = op.part("aligned").plan, op.part("aligned").arrays
    X = torch.from_numpy(np.random.default_rng(0).standard_normal((m.cols, K_RHS))
                         .astype(np.float32)).to(dev)
    x3 = spmm.pack_rhs(X, plan.cols)
    case = (f"{name}_K{K_RHS}_{layout}"
            + ("_spill" if plan.spill is not None and layout != "nospill" else ""))
    if layout == "rowmajor":
        call = lambda: spmm.spmm_aligned(plan, X, device_arrays=arrs)  # noqa: E731
    elif layout == "viapacked":
        call = lambda: spmm.unpack_rhs(spmm.spmm_aligned_packed(  # noqa: E731
            plan, spmm.pack_rhs(X, plan.cols), device_arrays=arrs), plan.rows)
    else:
        call = lambda: spmm.spmm_aligned_packed(plan, x3, device_arrays=arrs)  # noqa: E731
    y3 = torch.empty((plan.r128, K_RHS, 128), device=dev)
    y = torch.empty((plan.rows, K_RHS), device=dev)
    spill = arrs.get("spill")
    if layout == "nospill":  # the aligned kernel alone, without the spill's launch
        spill = None
    if layout == "rowmajor":
        def bare():
            arrs["spmm_launch"](X, y)
            if spill is not None:
                spill["spmm_launch"](X, y, add=True)
    else:
        def bare():
            arrs["spmm_launch"](x3, y3, packed=True)
            if spill is not None:
                spill["spmm_launch"](x3, y3, packed=True, add=True)
    return case, call, bare


def _trisweep_factors(dev):
    """{case: triangular factor}: L and L^T of Poisson 2048^2's IC(0), L and
    U of the dominant femlike_262k's ILU(0)."""
    from sparse_matrix_tpu_torch.bench.corpus import bench_classes, with_dominant_diagonal
    from sparse_matrix_tpu_torch.formats.csr import CsrMatrix
    from sparse_matrix_tpu_torch.solvers import ilu
    from sparse_matrix_tpu_torch.solvers.poisson import poisson_2d_csr

    lc = ilu.ic0(poisson_2d_csr(2048, dtype=np.float32))
    fem = next(m for name, _tag, m in bench_classes(0) if name == "femlike_262k")
    fem = with_dominant_diagonal(fem)
    fem = CsrMatrix(fem.rows, fem.cols, fem.vals.astype(np.float32), fem.indices, fem.offsets,
                    is_sorted=fem.is_sorted)
    f = ilu.ilu0(fem)
    return {"poisson2048_L": lc, "poisson2048_LT": lc.transpose(), "femlike_262k_L": f.l,
            "femlike_262k_U": f.u}


def _trisweep_case(torch, case, t, chunk_rows, dev, sweeps):
    """(case name, wrapper call, bare launch, plain version) of a trisweep
    case."""
    from sparse_matrix_tpu_torch.ops import trisweep as tw
    from sparse_matrix_tpu_torch.solvers.ilu import TriangularJacobi

    sj = TriangularJacobi(t, device=dev, sweeps=sweeps, fused=True)
    plan, dinv = sj._fused, sj.dinv
    if chunk_rows is not None:
        plan = tw.TrisweepPlan(plan.offsets, plan.data.cpu().numpy(), plan.rows, device=dev,
                               chunk_rows=chunk_rows)
    b = torch.from_numpy(np.random.default_rng(7).standard_normal(t.rows)
                         .astype(np.float32)).to(dev)
    s = sweeps
    y = torch.empty_like(b)
    rec = plan._record(s)

    def bare():
        rec(b, dinv, y, s)
    name = case + ("" if chunk_rows is None else f"_T{chunk_rows}") + f"_s{s}"
    return (name, lambda: tw.trisweep(plan, b, dinv, sweeps=s), bare,
            lambda: tw._trisweep_torch(plan.data, b, dinv, offsets=plan.offsets,
                                       rows=plan.rows, sweeps=s),
            dict(rows=plan.rows, nb=len(plan.offsets),
                 chunk_rows=plan.chunk_rows))


def _time_trisweep(torch, dev, out, sweeps_list, chunk_rows_list):
    for case, t in _trisweep_factors(dev).items():
        chunks = (None, *chunk_rows_list) if case == "poisson2048_L" else (None,)
        for sweeps, chunk_rows in ((s, c) for s in sweeps_list for c in chunks):
            name, call, bare, plain, info = _trisweep_case(torch, case, t, chunk_rows, dev,
                                                           sweeps)
            y1, y2, yp = call(), call(), plain()
            torch.cuda.synchronize()
            row = dict(kernel="trisweep", case=name, sweeps=sweeps, **info,
                       ms=_cuda_ms(torch, call), launch_ms=_cuda_ms(torch, bare),
                       device_ms=_device_ms(torch, bare), plain_ms=_cuda_ms(torch, plain),
                       bitwise_repeat=bool(torch.equal(y1, y2)),
                       equal_plain=bool(torch.equal(y1, yp)))
            out["cases"].append(row)
            print(f"trisweep {name}: {row['ms']:.4f} ms, launch {row['launch_ms']:.4f}, "
                  f"device {row['device_ms']:.4f}, plain {row['plain_ms']:.4f}, bitwise repeat "
                  f"{row['bitwise_repeat']}, equal plain {row['equal_plain']}", file=sys.stderr)
            del call, bare, plain, y1, y2, yp
            torch.cuda.empty_cache()


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(here)),
                    help="checkout whose sparse_matrix_tpu_torch is timed")
    ap.add_argument("--kinds", default=",".join(KINDS),
                    help="comma-separated kernels to time, of " + ", ".join(KINDS))
    ap.add_argument("--sweeps", default=str(TRISWEEP_SWEEPS),
                    help="comma-separated sweep counts of the trisweep cases")
    ap.add_argument("--chunk-rows", default="1024,2048,8192",
                    help="extra chunk sizes of the trisweep case on Poisson 2048^2's L")
    ap.add_argument("--segment-chunks", type=int, default=None,
                    help="the most chunks of an aligned or LanePack segment")
    args = ap.parse_args()
    kinds = args.kinds.split(",")
    if not set(kinds) <= set(KINDS):
        ap.error(f"--kinds takes {', '.join(KINDS)}")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("spmv_times: no CUDA device", file=sys.stderr)
        return 1
    import sparse_matrix_tpu_torch
    from sparse_matrix_tpu_torch.bench.corpus import bench_classes
    from sparse_matrix_tpu_torch.formats.aligned import plan_aligned
    from sparse_matrix_tpu_torch.formats.bell import plan_bell
    from sparse_matrix_tpu_torch.formats.lanepack import plan_lanepack
    from sparse_matrix_tpu_torch.formats.stripe import plan_stripe
    from sparse_matrix_tpu_torch.ops import spmv, spmv_bell
    from sparse_matrix_tpu_torch.solvers.poisson import poisson_2d_csr

    if not os.path.abspath(sparse_matrix_tpu_torch.__file__).startswith(tree + os.sep):
        raise AssertionError(f"imported {sparse_matrix_tpu_torch.__file__}, not from {tree}")
    if args.segment_chunks is not None:
        spmv.SEGMENT_CHUNKS = args.segment_chunks
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()

    mats = {"poisson1024": poisson_2d_csr(1024, dtype=np.float32),
            "poisson2048": poisson_2d_csr(2048, dtype=np.float32)}
    for name, _tag, m in bench_classes(0):
        mats[name] = m
    # (kernel, matrix, variant)
    cases = [(kind, "poisson2048", v) for kind in ("dia", "dia_spmm") for v in ("f32", "bf16")]
    cases += [("aligned", "poisson1024", None), ("aligned", "randlocal_262k", None)]
    cases += [("lanepack", name, pack)
              for name in ("femlike_262k", "randlocal_262k", "powerlaw_262k")
              for pack in ("dense", "per_rb")]
    cases += [("bell", "poisson1024", "f32"), ("bell", "poisson1024", "bf16"),
              ("bell", "femlike_262k", "f32"), ("bell", "randlocal_262k", "f32")]
    cases += [("stripe", "randlocal_262k", ("scan", 2, 2)),
              ("stripe", "powerlaw_262k", ("scan", 8, 16)),
              ("stripe", "randlocal_262k", ("select", None, None))]
    cases += [("lanepack_spmm", "poisson1024", ("packed", False)),
              ("lanepack_spmm", "poisson1024", ("rowmajor", False)),
              ("lanepack_spmm", "poisson1024", ("viapacked", False)),
              ("lanepack_spmm", "randlocal_262k", ("packed", False)),
              ("lanepack_spmm", "powerlaw_262k", ("packed", False)),
              ("lanepack_spmm", "randlocal_262k", ("packed", True))]
    cases += [("bell_spmm", "poisson1024", (None, 8)), ("bell_spmm", "poisson1024", (None, 16)),
              ("bell_spmm", "femlike_262k", (None, 8))]
    cases += [("aligned_spmm", "poisson1024", "packed"),
              ("aligned_spmm", "poisson1024", "rowmajor"),
              ("aligned_spmm", "poisson1024", "viapacked"),
              ("aligned_spmm", "randlocal_262k", "packed"),
              ("aligned_spmm", "randlocal_262k", "nospill"),
              ("aligned_spmm", "randlocal_262k", "rowmajor")]
    ops = {}
    if {"aligned_spmm", "lanepack_spmm", "bell_spmm"} & set(kinds):
        from sparse_matrix_tpu_torch.ops.operator import SpmvOperator

        # chip_smoke.py's forced operators
        for name, force in (("poisson1024", "lanepack"), ("randlocal_262k", "lanepack"),
                            ("randlocal_262k", "aligned"), ("poisson1024", "aligned")):
            ops[name, force] = SpmvOperator(mats[name], device=dev, force=force)
    out = dict(tree=tree, nvidia_smi=smi, torch=torch.__version__,
               segment_chunks=spmv.SEGMENT_CHUNKS, cases=[])
    for kind, name, variant in cases:
        if kind not in kinds:
            continue
        m = mats[name]
        if kind in ("dia", "dia_spmm"):
            case, call, launch, x, k = _dia_case(torch, kind, m, variant, dev)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # "sparse CSR support is in beta"
                a = torch.sparse_csr_tensor(
                    torch.from_numpy(m.offsets.astype(np.int64)),
                    torch.from_numpy(m.indices.astype(np.int64)),
                    torch.from_numpy(m.vals.astype(np.float32)), size=(m.rows, m.cols)).to(dev)
            library_ms = _cuda_ms(torch, (lambda a=a, x=x: torch.mv(a, x)) if k == 1
                                  else (lambda a=a, x=x: a @ x))
            y1, y2 = call(), call()
            torch.cuda.synchronize()
            row = dict(kernel=kind, case=case, rows=m.rows, nnz=m.nnz(), k=k,
                       ms=_cuda_ms(torch, call), launch_ms=_cuda_ms(torch, launch),
                       device_ms=_device_ms(torch, launch), library_ms=library_ms,
                       bitwise_repeat=bool(torch.equal(y1, y2)))
            out["cases"].append(row)
            print(f"{kind} {case}: {row['ms']:.4f} ms, launch {row['launch_ms']:.4f}, "
                  f"device {row['device_ms']:.4f}, library {library_ms:.4f}, "
                  f"bitwise repeat {row['bitwise_repeat']}", file=sys.stderr)
            del call, launch, y1, y2, a, x
            torch.cuda.empty_cache()
            continue
        if kind in ("aligned_spmm", "lanepack_spmm", "bell_spmm"):
            if kind == "aligned_spmm":
                case, call, launch = _aligned_spmm_case(torch, name, variant, m, ops, dev)
            else:
                case, call, launch = _spmm_case(torch, kind, name, variant, m, ops, dev)
            k = 16 if kind == "bell_spmm" and variant[1] == 16 else K_RHS
            X = torch.from_numpy(np.random.default_rng(0).standard_normal((m.cols, k))
                                 .astype(np.float32)).to(dev)
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # "sparse CSR support is in beta"
                a = torch.sparse_csr_tensor(
                    torch.from_numpy(m.offsets.astype(np.int64)),
                    torch.from_numpy(m.indices.astype(np.int64)),
                    torch.from_numpy(m.vals.astype(np.float32)), size=(m.rows, m.cols)).to(dev)
            library_ms = _cuda_ms(torch, lambda a=a, X=X: a @ X)
            y1, y2 = call(), call()
            torch.cuda.synchronize()
            row = dict(kernel=kind, case=case, rows=m.rows, nnz=m.nnz(), k=k,
                       ms=_cuda_ms(torch, call), call_device_ms=_device_ms(torch, call),
                       launch_ms=_cuda_ms(torch, launch), device_ms=_device_ms(torch, launch),
                       library_ms=library_ms, bitwise_repeat=bool(torch.equal(y1, y2)))
            out["cases"].append(row)
            print(f"{kind} {case} G{spmv.SEGMENT_CHUNKS}: {row['ms']:.4f} ms "
                  f"(device {row['call_device_ms']:.4f}), "
                  f"launch {row['launch_ms']:.4f}, "
                  f"device {row['device_ms']:.4f}, library {library_ms:.4f}, "
                  f"bitwise repeat {row['bitwise_repeat']}", file=sys.stderr)
            del call, launch, y1, y2, a, X
            torch.cuda.empty_cache()
            continue
        if kind == "aligned":
            plan = plan_aligned(m)
            wrapper, arrs = spmv.spmv_aligned, spmv.aligned_device_arrays(plan, dev)
            case = name + ("_spill" if plan.spill is not None else "")
        elif kind == "lanepack":
            plan = plan_lanepack(m, pack=variant)
            wrapper, arrs = spmv.spmv_lanepack, spmv.lanepack_device_arrays(plan, dev)
            case = f"{name}_{variant}_kw{plan.kw}"
        elif kind == "bell":
            plan = plan_bell(m)
            vdt = torch.bfloat16 if variant == "bf16" else None
            wrapper = spmv_bell.spmv_bell
            arrs = spmv_bell.bell_device_arrays(plan, dev, values_dtype=vdt)
            case = (f"{name}_span{plan.span}_{variant}"
                    + ("_spill" if plan.spill is not None else ""))
        else:
            mode, levels, kw = variant
            plan = plan_stripe(m, mode=mode, levels=levels, kw=kw)
            wrapper, arrs = spmv.spmv_stripe, spmv.stripe_device_arrays(plan, dev)
            case = (f"{name}_{plan.mode}_L{plan.levels}_kw{plan.kw}"
                    + ("_spill" if plan.spill is not None else ""))
        x_np = np.random.default_rng(0).standard_normal(m.cols).astype(np.float32)
        x = torch.from_numpy(x_np).to(dev)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # "sparse CSR support is in beta"
            a = torch.sparse_csr_tensor(
                torch.from_numpy(m.offsets.astype(np.int64)),
                torch.from_numpy(m.indices.astype(np.int64)),
                torch.from_numpy(m.vals.astype(np.float32)), size=(m.rows, m.cols)).to(dev)
        library_ms = _cuda_ms(torch, lambda a=a, x=x: torch.mv(a, x))

        def call(plan=plan, x=x, arrs=arrs, wrapper=wrapper):
            return wrapper(plan, x, device_arrays=arrs)

        y1, y2 = call(), call()
        torch.cuda.synchronize()
        launch = _bare_launch(torch, plan, arrs, x)
        row = dict(kernel=kind, case=case, rows=m.rows, nnz=m.nnz(), ms=_cuda_ms(torch, call),
                   launch_ms=_cuda_ms(torch, launch), device_ms=_device_ms(torch, launch),
                   library_ms=library_ms, bitwise_repeat=bool(torch.equal(y1, y2)))
        out["cases"].append(row)
        print(f"{kind} {case}: {row['ms']:.4f} ms, launch {row['launch_ms']:.4f}, "
              f"device {row['device_ms']:.4f}, library {library_ms:.4f}, "
              f"bitwise repeat {row['bitwise_repeat']}", file=sys.stderr)
        del arrs, y1, y2, launch
        del a, plan
        torch.cuda.empty_cache()
    if "trisweep" in kinds:
        _time_trisweep(torch, dev, out, [int(v) for v in args.sweeps.split(",")],
                       [int(v) for v in args.chunk_rows.split(",") if v])
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
