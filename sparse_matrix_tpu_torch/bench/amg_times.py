"""Where the time of an AMG V-cycle goes on the card:

    python3 sparse_matrix_tpu_torch/bench/amg_times.py [--n 2048] [--k 8]
        [--reps 4] [--top 12]

builds ``amg_setup`` on Poisson n^2 (f32, the defaults, on ``cuda``) and
prints one JSON line with the setup's seconds (``setup_s``, between two
CUDA events on an idle stream, so host time included), its levels and
formats and, for one V-cycle on a vector and on an (n, k) block:

* ``wall_ms``: ``reps`` V-cycles between two CUDA events, the first
  recorded on an idle stream (so the host's enqueue is in it), per
  V-cycle;
* ``device_ms``: ``reps`` V-cycles enqueued behind a sleep kernel, timed by
  CUDA events, per V-cycle (the device's time with no host gaps);
* ``host_share``: ``1 - device_ms / wall_ms``;
* ``kernels``: ``torch.profiler`` over ``reps`` V-cycles, the ``top``
  device kernels by total device time, each with its calls and device ms
  per V-cycle, and ``profiled_device_ms``, the sum over every kernel per
  V-cycle;
* ``by_level``: device ms per V-cycle of each level's own work
  (smoothing, residual, restriction, prolongation; the levels below
  excluded; the last entry the coarse solve), read from a profiler trace
  of ``reps`` V-cycles through the V-cycle's own spans
  (``spmx.amg.level<l>``, ``spmx.amg.coarse``; ``utils/profiling.py``):
  the device operations each level's span launched, less its lower
  levels'. The host's gaps are not in it.

The vector's ``graph`` row times the ``M^-1`` that PCG calls
(``hier.preconditioner()``), which replays the V-cycle captured as one
CUDA graph: its ``wall_ms`` and ``device_ms`` as above, beside the eager
V-cycle's.
"""

from __future__ import annotations

import argparse
import bisect
import json
import sys
import tempfile
from pathlib import Path

import numpy as np


def _events_ms(torch, fn) -> float:
    """``fn()`` between two CUDA events, the first on an idle stream."""
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    fn()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e)


def _device_ms(torch, fn, calls: int) -> float:
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
        raise RuntimeError("the host enqueued the calls more slowly than the hold")
    return s.elapsed_time(e) / calls


def _kernels(torch, fn, reps: int, top: int):
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = []
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us and ev.device_type is not None and "CUDA" in str(ev.device_type):
            rows.append((ev.key, ev.count, dev_us))
    if not rows:  # older key_averages() attribute the time to CPU-side keys
        rows = [(ev.key, ev.count, getattr(ev, "self_device_time_total", 0.0))
                for ev in prof.key_averages() if getattr(ev, "self_device_time_total", 0.0)]
    rows.sort(key=lambda r: -r[2])
    total = sum(r[2] for r in rows) / 1e3 / reps
    return total, [dict(name=k[:120], calls_per_vcycle=c / reps, device_ms=us / 1e3 / reps)
                   for k, c, us in rows[:top]]


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _device_ms_in(events, names):
    """Device ms of the operations launched inside the ranges of each of
    ``names`` (the launching runtime call, found by its correlation id,
    lies in one of the name's intervals), from a Chrome trace's events."""
    launch, ops, spans = {}, [], {n: [] for n in names}
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat, args = ev.get("cat", ""), ev.get("args") or {}
        if cat in DEVICE_CATS:
            ops.append((args.get("correlation"), float(ev.get("dur", 0.0))))
        elif cat in ("cuda_runtime", "cuda_driver") and "correlation" in args:
            launch[args["correlation"]] = float(ev["ts"])
        elif cat == "user_annotation" and ev.get("name") in spans:
            spans[ev["name"]].append((float(ev["ts"]), float(ev["ts"]) + float(ev["dur"])))
    out = {}
    for name, iv in spans.items():
        iv.sort()
        starts = [s for s, _ in iv]
        total = 0.0
        for corr, dur in ops:
            t = launch.get(corr)
            i = bisect.bisect_right(starts, t) - 1 if t is not None else -1
            if i >= 0 and t <= iv[i][1]:
                total += dur
        out[name] = total / 1e3
    return out


def _by_level(torch, hier, r, reps: int):
    """Ms per V-cycle of each level's own device work, from a profiler
    trace of ``reps`` V-cycles: the device time launched inside the
    V-cycle's span ``spmx.amg.level<l>`` less that inside the level below
    it (``spmx.amg.coarse`` below the last level)."""
    from sparse_matrix_tpu_torch.utils import profiling

    nlev = len(hier.levels)
    names = [f"spmx.amg.level{i}" for i in range(nlev)] + ["spmx.amg.coarse"]
    hier.vcycle(r)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as d:
        path = Path(d) / "vcycle.json"
        with profiling.trace(path):
            for _ in range(reps):
                hier.vcycle(r)
        data = json.loads(path.read_text())
    inclusive = _device_ms_in(data["traceEvents"] if isinstance(data, dict) else data, names)
    inc = [inclusive[n] / reps for n in names]
    own = [inc[i] - inc[i + 1] for i in range(nlev)] + [inc[nlev]]
    return [dict(level=i, n=(hier.levels[i].n if i < nlev else hier.coarse_inv.shape[0]),
                 device_ms=float(own[i])) for i in range(nlev + 1)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--top", type=int, default=12)
    args = ap.parse_args()
    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    import torch

    if not torch.cuda.is_available():
        print("amg_times: no CUDA device is visible", file=sys.stderr)
        return 1
    from sparse_matrix_tpu_torch.solvers import amg
    from sparse_matrix_tpu_torch.solvers.poisson import poisson_2d_csr

    dev = torch.device("cuda", 0)
    a = poisson_2d_csr(args.n, dtype=np.float32)
    made = {}
    setup_ms = _events_ms(torch, lambda: made.update(h=amg.amg_setup(a, device=dev)))
    hier = made["h"]
    rng = np.random.default_rng(0)
    out = dict(device=torch.cuda.get_device_name(0), n=args.n, setup_s=setup_ms / 1e3,
               levels=[(lv.n, lv.a_op.format, lv.p_op.format, lv.pt_op.format)
                       for lv in hier.levels])
    for tag, shape in (("vector", (a.rows,)), (f"block{args.k}", (a.rows, args.k))):
        r = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

        def vc(r=r):
            return hier.vcycle(r)

        vc()

        def many(vc=vc):
            for _ in range(args.reps):
                vc()

        wall = _events_ms(torch, many) / args.reps
        dev_ms = _device_ms(torch, vc, args.reps)
        prof_ms, kern = _kernels(torch, vc, args.reps, args.top)
        out[tag] = dict(wall_ms=wall, device_ms=dev_ms, host_share=max(0.0, 1 - dev_ms / wall),
                        profiled_device_ms=prof_ms, kernels=kern,
                        by_level=_by_level(torch, hier, r, args.reps))
        if r.dim() == 1:
            m_inv = hier.preconditioner()
            m_inv(r)  # the capture

            def replays(r=r, m_inv=m_inv):
                for _ in range(args.reps):
                    m_inv(r)

            out[tag]["graph"] = dict(wall_ms=_events_ms(torch, replays) / args.reps,
                                     device_ms=_device_ms(torch, lambda: m_inv(r), args.reps))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
