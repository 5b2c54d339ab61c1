"""Times the SpMV kernels of one checkout of the port on the card: aligned
(B2), LanePack (B3), BELL (B4) and stripe (B5), and the LanePack (B7)
and BELL (B8) SpMM kernels, so that two checkouts compare in one run:

    python3 sparse_matrix_tpu_torch/bench/spmv_times.py [--tree DIR]
        [--kinds aligned,lanepack,bell,stripe,lanepack_spmm,bell_spmm]

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

The cases: Poisson 1024^2 aligned; randlocal_262k aligned with its
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
host gaps. A checkout without the SpMM launch records (before
slice 9) has no row-major kernel: its bare launch is the zeroing of y3
and the packed kernel (for B8 also the packing of X), what one of its
kernel calls needs.
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

KINDS = ("aligned", "lanepack", "bell", "stripe", "lanepack_spmm", "bell_spmm")
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


def _spmm_case(torch, kind, name, variant, m, ops, dev):
    """(case name, wrapper call, bare launch) of an SpMM case."""
    from sparse_matrix_tpu_torch.formats.bell import plan_bell
    from sparse_matrix_tpu_torch.formats.lanepack import plan_lanepack
    from sparse_matrix_tpu_torch.native import kernels
    from sparse_matrix_tpu_torch.ops import spmm, spmv, spmv_bell

    k = variant[1] if kind == "bell_spmm" else K_RHS
    X = torch.from_numpy(np.random.default_rng(0).standard_normal((m.cols, k))
                         .astype(np.float32)).to(dev)
    if kind == "bell_spmm":
        plan = plan_bell(m)
        arrs = spmv_bell.bell_device_arrays(plan, dev)
        case = f"{name}_span{plan.span}_K{k}" + ("_spill" if plan.spill is not None else "")
        y = torch.empty((plan.rows, k), device=dev)
        if "spmm_launch" in arrs:
            def bare():
                arrs["spmm_launch"](X, y)
                if plan.spill is not None:
                    arrs["spill"]["spmm_launch"](X, y, add=True)
        else:
            def bare():
                x3 = spmm.pack_rhs(X, plan.cols)
                y3 = torch.empty((plan.r128, k, 128), device=dev)
                kernels.launch_bell_spmm(arrs["vals"], arrs["lane"], arrs["ds"], x3, y3,
                                         bias=128 if plan.span == 128 else 0, cols=plan.cols)
                if plan.spill is not None:
                    sp = arrs["spill"]
                    kernels.launch_lanepack_spmm(sp["vals"], sp["lane"], sp["ends"],
                                                 sp["starts"], sp["col_off"], sp["chunk_rb"],
                                                 x3, y3, cols=plan.cols)
        return case, lambda: spmm.spmm_bell(plan, X, device_arrays=arrs), bare
    layout, spill = variant
    if spill:
        plan = ops[name, "aligned"]._aligned.spill
        arrs = ops[name, "aligned"]._ali_arrs["spill"]
        case, guard = f"{name}_aligned_spill_kw{plan.kw}_K{k}", 1
    else:
        plan, arrs = ((ops[name, "lanepack"]._plan, ops[name, "lanepack"]._lp_arrs)
                      if (name, "lanepack") in ops else (plan_lanepack(m), None))
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
    if "spmm_launch" not in arrs:
        def bare():
            y3.zero_()
            kernels.launch_lanepack_spmm(arrs["vals"], arrs["lane"], arrs["ends"], arrs["starts"],
                                         arrs["col_off"], arrs["chunk_rb"], x3, y3,
                                         cols=plan.cols)
    elif layout == "rowmajor":
        def bare():
            arrs["spmm_launch"](X, y)
    else:
        def bare():
            arrs["spmm_launch"](x3, y3, packed=True)
    return case, call, bare


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(here)),
                    help="checkout whose sparse_matrix_tpu_torch is timed")
    ap.add_argument("--kinds", default=",".join(KINDS),
                    help="comma-separated kernels to time, of " + ", ".join(KINDS))
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
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()

    mats = {"poisson1024": poisson_2d_csr(1024, dtype=np.float32)}
    for name, _tag, m in bench_classes(0):
        mats[name] = m
    # (kernel, matrix, variant)
    cases = [("aligned", "poisson1024", None), ("aligned", "randlocal_262k", None)]
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
    ops = {}
    if {"lanepack_spmm", "bell_spmm"} & set(kinds):
        from sparse_matrix_tpu_torch.ops.operator import SpmvOperator

        # chip_smoke.py's forced operators
        for name, force in (("poisson1024", "lanepack"), ("randlocal_262k", "lanepack"),
                            ("randlocal_262k", "aligned")):
            ops[name, force] = SpmvOperator(mats[name], device=dev, force=force)
    out = dict(tree=tree, nvidia_smi=smi, torch=torch.__version__, cases=[])
    for kind, name, variant in cases:
        if kind not in kinds:
            continue
        m = mats[name]
        if kind in ("lanepack_spmm", "bell_spmm"):
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
            print(f"{kind} {case}: {row['ms']:.4f} ms (device {row['call_device_ms']:.4f}), "
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
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
