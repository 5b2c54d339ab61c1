"""Times the aligned (B2) and LanePack (B3) SpMV of one checkout of the port
on the card, so that two checkouts compare in one run:

    python3 sparse_matrix_tpu_torch/bench/spmv_times.py [--tree DIR]

imports ``sparse_matrix_tpu_torch`` from the checkout at DIR (default: the
one holding this file) and prints one JSON line with, per case:

* ``ms``: ``spmv_aligned`` / ``spmv_lanepack`` through the wrapper a user
  calls (device arrays built beforehand), median of 30;
* ``launch_ms``: the bare kernel launch(es) on the prepared inputs, the
  host's launch path included, median of 30;
* ``device_ms``: the bare launches with no host gaps (20 calls enqueued
  behind a sleep kernel, timed together);
* ``library_ms``: ``torch.mv`` of the ``torch.sparse`` CSR tensor on the
  same x (a yardstick, used nowhere in the port);
* ``bitwise_repeat``: whether two wrapper calls on one x gave equal bits.

The cases: Poisson 1024^2 aligned; randlocal_262k aligned with its
LanePack spill; femlike_262k, randlocal_262k and powerlaw_262k LanePack
in the ``dense`` and ``per_rb`` packs (the planner's own ``kw``). The
matrices are chip_smoke.py's, x from seed 0.
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


def _bare_launch(torch, kernels, spmv, kind, arrs, x, rows, r128):
    """The bare launch(es) of one call: the prepared launch record where
    the checkout has one, else the ``launch_*`` functions into a y the
    caller zeroed once (the accumulating kernels of earlier checkouts)."""
    if "launch" in arrs:
        y = torch.empty(rows, dtype=torch.float32, device=x.device)
        rec, spill = arrs["launch"], arrs.get("spill", {}).get("launch")

        def run():
            rec(x, y)
            if spill is not None:
                spill(x, y, add=True)

        return run
    y = torch.zeros(r128 * 128, dtype=torch.float32, device=x.device)
    if kind == "aligned":
        def run():
            kernels.launch_aligned(arrs["vals"], arrs["lane"], arrs["col_off"],
                                   arrs["chunk_rb"], x, y)
            if "spill" in arrs:
                spmv._lanepack_cuda(arrs["spill"], x, y)
    else:
        def run():
            kernels.launch_lanepack(arrs["vals"], arrs["lane"], arrs["ends"], arrs["starts"],
                                    arrs["col_off"], arrs["chunk_rb"], x, y)
    return run


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(here)),
                    help="checkout whose sparse_matrix_tpu_torch is timed")
    args = ap.parse_args()
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("spmv_times: no CUDA device", file=sys.stderr)
        return 1
    import sparse_matrix_tpu_torch
    from sparse_matrix_tpu_torch.bench.corpus import bench_classes
    from sparse_matrix_tpu_torch.formats.aligned import plan_aligned
    from sparse_matrix_tpu_torch.formats.lanepack import plan_lanepack
    from sparse_matrix_tpu_torch.native import kernels
    from sparse_matrix_tpu_torch.ops import spmv
    from sparse_matrix_tpu_torch.solvers.poisson import poisson_2d_csr

    if not os.path.abspath(sparse_matrix_tpu_torch.__file__).startswith(tree + os.sep):
        raise AssertionError(f"imported {sparse_matrix_tpu_torch.__file__}, not from {tree}")
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()

    mats = {"poisson1024": poisson_2d_csr(1024, dtype=np.float32)}
    for name, _tag, m in bench_classes(0):
        mats[name] = m
    cases = [("aligned", "poisson1024", None), ("aligned", "randlocal_262k", None)]
    cases += [("lanepack", name, pack)
              for name in ("femlike_262k", "randlocal_262k", "powerlaw_262k")
              for pack in ("dense", "per_rb")]
    out = dict(tree=tree, nvidia_smi=smi, torch=torch.__version__, cases=[])
    for kind, name, pack in cases:
        m = mats[name]
        if kind == "aligned":
            plan = plan_aligned(m)
            wrapper, build = spmv.spmv_aligned, spmv.aligned_device_arrays
            case = name + ("_spill" if plan.spill is not None else "")
        else:
            plan = plan_lanepack(m, pack=pack)
            wrapper, build = spmv.spmv_lanepack, spmv.lanepack_device_arrays
            case = f"{name}_{pack}_kw{plan.kw}"
        x_np = np.random.default_rng(0).standard_normal(m.cols).astype(np.float32)
        x = torch.from_numpy(x_np).to(dev)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # "sparse CSR support is in beta"
            a = torch.sparse_csr_tensor(
                torch.from_numpy(m.offsets.astype(np.int64)),
                torch.from_numpy(m.indices.astype(np.int64)),
                torch.from_numpy(m.vals.astype(np.float32)), size=(m.rows, m.cols)).to(dev)
        library_ms = _cuda_ms(torch, lambda a=a, x=x: torch.mv(a, x))
        arrs = build(plan, dev)

        def call(plan=plan, x=x, arrs=arrs, wrapper=wrapper):
            return wrapper(plan, x, device_arrays=arrs)

        y1, y2 = call(), call()
        torch.cuda.synchronize()
        launch = _bare_launch(torch, kernels, spmv, kind, arrs, x, plan.rows, plan.r128)
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
