"""The control of a cell: the plain reference, put in the program's place
and computed in the precision below the configuration's, must come out
as not correct.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--count 2]

For each seed it builds the cell's matrix and pool as a run does, lets
the traffic kind's ``control`` answer the first ``count`` requests with
the plain reference solver or product in the cell's ``control`` dtype
(bfloat16 for the float32 configurations), compares those answers as a
run compares the program's, and prints one JSON line with the numbers
beside their limits. The program is not imported. Needs a CUDA device
(``--device cpu`` for the tests).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench.harness import ROOT, Bench, Context, make_matrix  # noqa: E402


def control_readings(bench: Bench, name: str, seed: int, count: int, device):
    """The cell's comparison numbers for the control's answers."""
    import torch

    wl = bench.workload(name)
    cfg = bench.config(wl["config"])
    dev = torch.device(device)
    ctx = Context(torch, dev, seed, wl, cfg, make_matrix(bench, cfg, wl, seed))
    traffic = bench.traffic_kind(wl["kind"]).Traffic(ctx)
    answers = traffic.control(count)
    return traffic.check(answers)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run a cell's lower-precision control.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--count", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("control: no CUDA device is visible", file=sys.stderr)
        return 2
    bench = Bench(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        checks = control_readings(bench, args.workload, seed, args.count, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "control": True,
                          "checks": checks, "seconds": time.perf_counter() - t0,
                          "fails": any(c["value"] > c["limit"] for c in checks.values())}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
