"""Times the ESC engine of one checkout of the port on the card, the
expansion kernel (B12) and ``EscSpgemm(reduce="sort").multiply_device``,
so that two checkouts compare in one run:

    python3 sparse_matrix_tpu_torch/bench/esc_times.py [--tree DIR]
        [--cases femlike_262k,randlocal_262k,uniform8192,uniform16384]

imports ``sparse_matrix_tpu_torch`` from the checkout at DIR (default: the
one holding this file) and prints one JSON line with, per case (each
matrix squared, f32, chip_smoke.py's matrices from seed 0):

* ``plan_s``: ``EscSpgemm(m, m, reduce="sort")`` between two CUDA events
  (the host planning, the upload and any planning on the card);
* ``expand_ms``: ``expand_products`` on the engine's device arrays, median
  of 30 CUDA-event-timed calls; ``expand_device_ms``: the bare kernel
  launch with no host gaps (20 calls enqueued behind a sleep kernel); the
  bare launch is the engine's launch record where the checkout has one,
  else ``launch_esc_expand`` on the lane arrays;
* ``multiply_ms`` and ``multiply_device_ms``: ``multiply_device`` the same
  two ways; ``bitwise_repeat``: two calls gave equal values;
* ``library_ms``: ``torch.sparse.mm`` of the CSR tensor by itself (a
  yardstick, used nowhere in the port).
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

CASES = ("femlike_262k", "randlocal_262k", "uniform8192", "uniform16384")


def _cuda_ms(torch, fn, reps: int = 30, warmup: int = 5) -> float:
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
    held = not s.query()
    e.record()
    torch.cuda.synchronize()
    if not held:
        raise AssertionError("the host enqueued the calls more slowly than the hold")
    return s.elapsed_time(e) / calls


def _matrices(names):
    from sparse_matrix_tpu_torch.bench.corpus import bench_classes, random_uniform
    from sparse_matrix_tpu_torch.formats.csr import CsrMatrix

    mats = {name: m for name, _tag, m in bench_classes(0) if name in names}
    if "uniform8192" in names:
        mats["uniform8192"] = random_uniform(np.random.default_rng(0), 8192, 0.002)
    if "uniform16384" in names:
        mats["uniform16384"] = random_uniform(np.random.default_rng(0), 16384, 0.00015)
    return {k: CsrMatrix(m.rows, m.cols, m.vals.astype(np.float32), m.indices, m.offsets,
                         is_sorted=m.is_sorted) for k, m in mats.items()}


def _bare_expand(torch, eng, p):
    """The expansion kernel's bare launch into ``p`` on the engine's
    arrays."""
    arrs, lv, rv = eng._expand_arrs, eng.lhs_vals_csc, eng.rhs_vals
    if "launch" in arrs:
        return lambda: arrs["launch"](lv, rv, p)
    from sparse_matrix_tpu_torch.native.kernels import launch_esc_expand

    n = eng._xplan.num_products
    return lambda: launch_esc_expand(lv, rv, arrs["lv_lane"], arrs["rv_lane"], arrs["lv_off"],
                                     arrs["rv_off"], p, num_products=n)


def main() -> int:
    here = os.path.dirname(os.path.abspath(__file__))
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(here)),
                    help="checkout whose sparse_matrix_tpu_torch is timed")
    ap.add_argument("--cases", default=",".join(CASES),
                    help="comma-separated matrices to square, of " + ", ".join(CASES))
    args = ap.parse_args()
    names = args.cases.split(",")
    if not set(names) <= set(CASES):
        ap.error(f"--cases takes {', '.join(CASES)}")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch

    if not torch.cuda.is_available():
        print("esc_times: no CUDA device", file=sys.stderr)
        return 1
    import sparse_matrix_tpu_torch
    from sparse_matrix_tpu_torch.ops.device_sorted import EscSpgemm
    from sparse_matrix_tpu_torch.ops.esc_expand import expand_products

    if not os.path.abspath(sparse_matrix_tpu_torch.__file__).startswith(tree + os.sep):
        raise AssertionError(f"imported {sparse_matrix_tpu_torch.__file__}, not from {tree}")
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    mats = _matrices(names)
    out = dict(tree=tree, nvidia_smi=smi, torch=torch.__version__, cases=[])
    for name in names:
        m = mats[name]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        eng = EscSpgemm(m, m, device=dev, reduce="sort")
        ev[1].record()
        torch.cuda.synchronize()
        plan_s = ev[0].elapsed_time(ev[1]) / 1e3
        xp = eng._xplan
        p = torch.empty(xp.num_slabs * 1024, device=dev)
        bare = _bare_expand(torch, eng, p)

        def expand(eng=eng, xp=xp):
            return expand_products(xp, eng.lhs_vals_csc, eng.rhs_vals,
                                   device_arrays=eng._expand_arrs)

        c1, c2 = eng.multiply_device(), eng.multiply_device()
        torch.cuda.synchronize()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # "sparse CSR support is in beta"
            a = torch.sparse_csr_tensor(
                torch.from_numpy(m.offsets.astype(np.int64)),
                torch.from_numpy(m.indices.astype(np.int64)),
                torch.from_numpy(m.vals), size=(m.rows, m.cols)).to(dev)
        row = dict(case=name, rows=m.rows, nnz=m.nnz(), products=eng.num_products,
                   nnz_c=int(c1.nnz), plan_s=plan_s, expand_ms=_cuda_ms(torch, expand),
                   expand_device_ms=_device_ms(torch, bare),
                   multiply_ms=_cuda_ms(torch, eng.multiply_device),
                   multiply_device_ms=_device_ms(torch, eng.multiply_device),
                   library_ms=_cuda_ms(torch, lambda a=a: torch.sparse.mm(a, a), reps=5),
                   bitwise_repeat=bool(torch.equal(c1.val, c2.val)))
        out["cases"].append(row)
        print(f"esc {name}: plan {plan_s:.3f} s, expand {row['expand_ms']:.4f} ms (device "
              f"{row['expand_device_ms']:.4f}), multiply_device {row['multiply_ms']:.4f} ms "
              f"(device {row['multiply_device_ms']:.4f}), torch.sparse.mm "
              f"{row['library_ms']:.4f} ms, bitwise repeat {row['bitwise_repeat']}",
              file=sys.stderr)
        del eng, p, bare, c1, c2, a
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
