"""Times the block-sparse path of one checkout of the port on the card, so
that two checkouts compare in one run:

    python3 sparse_matrix_tpu_torch/bench/block_times.py [--tree DIR]

imports ``sparse_matrix_tpu_torch`` from the checkout at DIR (default: the
one holding this file) and prints one JSON line:

* ``block_plan_s``: ``BlockSpgemm(m, m)`` construction (block plan, upload
  and whatever per-operand planning the checkout does), median of 3, for
  uniform 8192^2 at 0.2 % (f32) and uniform 16384^2 at 0.015 %;
* ``block_multiply_ms``: ``BlockSpgemm.multiply_device``, median of 5;
* ``bcsr_plan_s``: ``bcsr_device_arrays`` for the block-tridiagonal
  65536^2 matrix and blocked_2k (bs 128);
* ``bcsr_ms``: ``spmm_bcsr(b, X, device_arrays=...)`` at F = 128 through
  the wrapper a user calls, median of 30, beside ``bcsr_library_ms``,
  ``torch.sparse`` CSR @ X on the same inputs.

Times are CUDA events around each call, on an idle stream, so they hold
the host's work as well as the device's, as a caller sees them (the plan
seconds too). The matrices are chip_smoke.py's, from seed 0.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import warnings

import numpy as np


def _cuda_ms(torch, fn, reps: int, warmup: int) -> float:
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
        print("block_times: no CUDA device", file=sys.stderr)
        return 1
    import sparse_matrix_tpu_torch
    from sparse_matrix_tpu_torch.bench.corpus import blocked, random_uniform
    from sparse_matrix_tpu_torch.formats.bcsr import BsrMatrix
    from sparse_matrix_tpu_torch.formats.csr import CsrMatrix
    from sparse_matrix_tpu_torch.ops import spmm
    from sparse_matrix_tpu_torch.ops.spgemm_block import BlockSpgemm

    if not os.path.abspath(sparse_matrix_tpu_torch.__file__).startswith(tree + os.sep):
        raise AssertionError(f"imported {sparse_matrix_tpu_torch.__file__}, not from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")

    def f32(m):
        return CsrMatrix(m.rows, m.cols, m.vals.astype(np.float32), m.indices, m.offsets,
                         is_sorted=m.is_sorted)

    out = dict(tree=tree, device=torch.cuda.get_device_name(0), block_plan_s={},
               block_multiply_ms={}, bcsr_plan_s={}, bcsr_ms={}, bcsr_library_ms={})
    for name, m in (("uniform8192", f32(random_uniform(np.random.default_rng(0), 8192, 0.002))),
                    ("uniform16384",
                     f32(random_uniform(np.random.default_rng(0), 16384, 0.00015)))):
        BlockSpgemm(m, m, device=dev)  # warm the device and its allocator
        out["block_plan_s"][name] = _cuda_ms(
            torch, lambda m=m: BlockSpgemm(m, m, device=dev), 3, 0) / 1e3
        eng = BlockSpgemm(m, m, device=dev)
        out["block_multiply_ms"][name] = _cuda_ms(torch, eng.multiply_device, 5, 2)
        del eng
        torch.cuda.empty_cache()
    for name, m in (("blocked65536", blocked(np.random.default_rng(0), 65536, 64, 0.05)),
                    ("blocked2048", blocked(np.random.default_rng(0), 2048, 64, 0.05))):
        b = BsrMatrix.from_csr(m)
        out["bcsr_plan_s"][name] = _cuda_ms(
            torch, lambda b=b: spmm.bcsr_device_arrays(b, dev), 3, 1) / 1e3
        arrs = spmm.bcsr_device_arrays(b, dev)
        x_np = np.random.default_rng(1).standard_normal((m.cols, 128)).astype(np.float32)
        x = torch.from_numpy(x_np).to(dev)
        out["bcsr_ms"][name] = _cuda_ms(
            torch, lambda b=b, x=x, arrs=arrs: spmm.spmm_bcsr(b, x, device_arrays=arrs), 30, 10)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # "sparse CSR support is in beta"
            a = torch.sparse_csr_tensor(
                torch.from_numpy(m.offsets.astype(np.int64)),
                torch.from_numpy(m.indices.astype(np.int64)),
                torch.from_numpy(m.vals.astype(np.float32)), size=(m.rows, m.cols)).to(dev)
        out["bcsr_library_ms"][name] = _cuda_ms(torch, lambda a=a, x=x: a @ x, 30, 10)
        del arrs, a
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
