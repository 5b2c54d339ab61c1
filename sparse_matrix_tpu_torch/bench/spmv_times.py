"""Times the SpMV kernels of one checkout of the port on the card: aligned
(B2), LanePack (B3), BELL (B4) and stripe (B5), so that two checkouts
compare in one run:

    python3 sparse_matrix_tpu_torch/bench/spmv_times.py [--tree DIR]
        [--kinds aligned,lanepack,bell,stripe]

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

KINDS = ("aligned", "lanepack", "bell", "stripe")


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
    out = dict(tree=tree, nvidia_smi=smi, torch=torch.__version__, cases=[])
    for kind, name, variant in cases:
        if kind not in kinds:
            continue
        m = mats[name]
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
