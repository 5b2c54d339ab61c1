"""Run one cell of the benchmark once and print its result line.

A cell (``workloads/<cell>.json``) names its configuration
(``configs/<config>.json``), its traffic kind (``traffic/<kind>.py``) and
that kind's parameters. A run:

1. set-up (``setup_s``, from the start of the process): the matrix from
   the configuration's generator and ``--seed``, the program's plans
   (timed apart as ``plan_s``), a seeded pool of right-hand sides or
   value vectors on the device, and the cell's ``warm_requests``
   requests, which build every launch record and bring the card and the
   host to their steady pace;
2. the measured window: a closed loop with one caller, each request
   waited for until its result is on the device, the window from its
   first call until the last request that started before ``--seconds``
   ran out has completed (host clock); where a metric of the cell reads
   each request's latency (its reader sets ``LATENCIES``), each request
   is also timed by CUDA events from the call to its last operation;
3. with ``--trace 1``, a profiled sub-window of the cell's
   ``trace_requests`` further requests, each waited for as in the window,
   with the benchmark's ranges on;
4. the device's memory peak, then the program's state freed, then the
   comparison of a seeded sample of the window's answers with the plain
   float64 reference (``reference.py``);
5. no result where the process then holds JAX or the JAX package
   (:func:`finish`).

The metrics a run reports are those ``BENCHMARK.json`` lists for the
cell: its ``end_to_end`` metrics with ``--trace 0``, its ``per_layer``
metrics with ``--trace 1``; each is read by ``metrics/<metric>.py``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import resource
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _load_module(path: Path, tag: str):
    if not path.is_file():
        raise FileNotFoundError(f"no {tag} file {path}")
    spec = importlib.util.spec_from_file_location(f"portbench_{tag}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files it names, found by
    name under ``root/portbench``."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "portbench"
        with open(self.root / "BENCHMARK.json") as f:
            self.spec = json.load(f)

    def cell(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def workload(self, name: str) -> dict:
        with open(self.dir / "workloads" / f"{name}.json") as f:
            wl = json.load(f)
        cell = self.cell(name)
        for key in ("config", "traffic"):
            if wl[key] != cell[key]:
                raise ValueError(f"{name}: {key} {wl[key]!r} in its file, {cell[key]!r} in "
                                 "BENCHMARK.json")
        return wl

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                with open(self.root / c["file"]) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def metrics(self, cell: str, trace: bool) -> list:
        """The cell's end-to-end (``trace`` false) or per-layer metrics."""
        group = self.spec["per_layer"] if trace else self.spec["end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def traffic_kind(self, kind: str):
        return _load_module(self.dir / "traffic" / f"{kind}.py", "traffic")

    def reader(self, metric: str):
        return _load_module(self.dir / "metrics" / f"{metric}.py", "metric")

    def generator(self, name: str):
        return _load_module(self.dir / "generators" / f"{name}.py", "generator")


class Context:
    """What a traffic kind is given: the device, the seed, the cell's and
    the configuration's data, the matrix, and a timer for plans."""

    def __init__(self, torch, device, seed: int, workload: dict, config: dict, matrix):
        self.torch = torch
        self.device = device
        self.seed = int(seed)
        self.workload = workload
        self.params = workload["params"]
        self.config = config
        self.matrix = matrix
        self.plan_s = 0.0
        self.phases = []

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def plan(self, label: str, fn):
        """``fn()`` timed on the host clock to its device work's end, added
        to ``plan_s``."""
        self.sync()
        t0 = time.perf_counter()
        out = fn()
        self.sync()
        dt = time.perf_counter() - t0
        self.plan_s += dt
        self.phases.append((label, dt))
        return out

    def note(self, label: str, seconds: float):
        """A phase inside a plan, for the set-up line (not added again)."""
        self.phases.append((label, seconds))

    def generator(self):
        """A device ``torch.Generator`` seeded from ``--seed``."""
        g = self.torch.Generator(device=self.device)
        g.manual_seed(self.seed % (1 << 63))
        return g


def make_matrix(bench: Bench, config: dict, workload: dict, seed: int):
    """The configuration's matrix from its generator and numpy state
    ``default_rng(matrix_seed)`` (the configuration's own, where it fixes
    its operator; else the run's seed), then the cell's transform if it
    names one."""
    rng = np.random.default_rng(int(config.get("matrix_seed", seed)) % (1 << 64))
    m = bench.generator(config["generator"]).make(rng, **config["generator_params"])
    tr = workload.get("matrix_transform")
    if tr:
        m = bench.generator(tr["name"]).transform(m, **tr.get("params", {}))
    return m


class Reservoir:
    """A uniform sample of at most ``k`` items of a stream of unknown
    length, drawn from the seed."""

    def __init__(self, k: int, seed: int):
        self.k = int(k)
        self.rng = np.random.default_rng([int(seed) % (1 << 64), 0x5eed])
        self.items = []
        self.seen = 0

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = item


class Run:
    """What the metric readers read."""

    def __init__(self):
        self.setup_s = None
        self.plan_s = None
        self.window_s = None
        self.requests = 0
        self.latencies_ms = []  # by CUDA events, where a metric reads them
        self.iterations = []
        self.trace = None
        self.trace_requests = 0
        self.work = {}


def _by_tenth(ends, t0):
    """Host-clock ms a request in each tenth of the window's requests, in
    order, from each request's end time."""
    n = len(ends)
    if n < 10:
        return []
    cut = [t0] + ends
    return [(cut[(k + 1) * n // 10] - cut[k * n // 10]) * 1e3
            / ((k + 1) * n // 10 - k * n // 10) for k in range(10)]


def _cpu_s() -> float:
    """CPU seconds this process has used."""
    ru = resource.getrusage(resource.RUSAGE_SELF)
    return ru.ru_utime + ru.ru_stime


def _request(torch, dev, traffic, i, timed):
    """Request ``i``, waited for until its result is on the device; with
    ``timed``, also its latency in ms by CUDA events, from the call to its
    last operation (on the CPU, the host clock)."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = traffic.request(i)
        return out, (time.perf_counter() - t0) * 1e3
    if not timed:
        out = traffic.request(i)
        torch.cuda.synchronize(dev)
        return out, None
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    out = traffic.request(i)
    e.record()
    torch.cuda.synchronize(dev)
    return out, s.elapsed_time(e)


def run_cell(bench: Bench, name: str, *, seed: int, seconds: float, trace: bool, device,
             t_start: float):
    """One run of cell ``name`` on ``device``; returns the result line as a
    dict, its ``checks`` last."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl = bench.workload(name)
    cfg = bench.config(wl["config"])
    dev = torch.device(device)
    marks = [("imports", time.perf_counter())]
    if dev.type == "cuda":
        torch.zeros(1, device=dev)
        torch.cuda.synchronize(dev)
    marks.append(("device_start", time.perf_counter()))
    matrix = make_matrix(bench, cfg, wl, seed)
    marks.append(("matrix", time.perf_counter()))
    ctx = Context(torch, dev, seed, wl, cfg, matrix)
    traffic = bench.traffic_kind(wl["kind"]).Traffic(ctx)
    traffic.setup()
    marks.append(("plans_and_pool", time.perf_counter()))
    for k in range(int(wl["params"].get("warm_requests", 1))):
        traffic.request(k)
        ctx.sync()
    marks.append(("warm", time.perf_counter()))
    ctx.note("imports", marks[0][1] - t_start)
    for (_, t0), (label, t1) in zip(marks, marks[1:]):
        ctx.note(label, t1 - t0)
    run = Run()
    run.setup_s = time.perf_counter() - t_start
    run.plan_s = ctx.plan_s
    print(json.dumps({"setup_phases": [[k, v] for k, v in ctx.phases], "setup_s": run.setup_s,
                      "plan_s": run.plan_s}), file=sys.stderr, flush=True)

    timed = any(getattr(bench.reader(m["name"]), "LATENCIES", False)
                for m in bench.metrics(name, False))
    sample = Reservoir(wl["params"]["check_samples"], seed)
    failed = 0
    ends = []
    i = 0
    cpu0 = _cpu_s()
    t0 = time.perf_counter()
    deadline = t0 + float(seconds)
    while i == 0 or time.perf_counter() < deadline:
        out, ms = _request(torch, dev, traffic, i, timed)
        ends.append(time.perf_counter())
        if ms is not None:
            run.latencies_ms.append(ms)
        if out.iterations is not None:
            run.iterations.append(out.iterations)
        failed += int(out.failed)
        sample.offer((i, out))
        i += 1
    run.window_s = ends[-1] - t0
    run.requests = attempted = i
    print(json.dumps({"window_s": run.window_s, "requests": i,
                      "iterations_mean": (sum(run.iterations) / len(run.iterations)
                                          if run.iterations else None),
                      "ms_by_tenth": _by_tenth(ends, t0),
                      "cpu_s": _cpu_s() - cpu0}),
          file=sys.stderr)

    if trace:
        from portbench.tracing import REQUEST, WINDOW, Trace

        n_tr = int(wl["params"]["trace_requests"])
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        traffic.set_ranges(True)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                for j in range(n_tr):
                    with torch.profiler.record_function(REQUEST):
                        _request(torch, dev, traffic, i + j, False)
        traffic.set_ranges(False)
        run.trace = Trace.from_profiler(prof)
        run.trace_requests = n_tr
        del prof

    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    traffic.release()
    ctx.sync()
    checks = traffic.check(sample.items)
    run.work = traffic.work() if trace else {}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and failed == 0

    metrics = {}
    for m in bench.metrics(name, trace):
        val = bench.reader(m["name"]).read(run)
        if val is not None:
            metrics[m["name"]] = {"value": float(val), "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak),
                   "power_limit_w": power_limit_w() if dev.type == "cuda" else None}
    line = {"correct": bool(correct), "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device_info}
    if run.trace is not None:
        device_info["busy_s"] = run.trace.busy_s()
        device_info["window_s"] = run.trace.window_s()
        line["breakdown"] = run.trace.breakdown()
        print(json.dumps({"trace_requests": run.trace_requests,
                          "unattributed_device_ops": run.trace.unattributed(),
                          "kernels": len(run.trace.kernels())}), file=sys.stderr)
    line["checks"] = checks
    return line


def power_limit_w():
    """The card's power limit in W from ``nvidia-smi``, None if unread."""
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30)
        return float(res.stdout.strip().splitlines()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def emit(line: dict) -> None:
    """The checks on standard error, each number beside its limit, as the
    last lines there; the result as the last line of standard output."""
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if c['value'] <= c['limit'] else 'FAILED'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def main(argv=None, t_start=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    ap = argparse.ArgumentParser(description="Run one cell of the port's benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench: no CUDA device is visible; the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    bench = Bench(ROOT)
    cell = bench.cell(args.workload)
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} devices, "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    line = run_cell(bench, args.workload, seed=args.seed, seconds=args.seconds,
                    trace=bool(args.trace), device=torch.device("cuda", 0), t_start=t_start)
    return finish(line)


#: top-level names of JAX, Flax and the JAX package, which no run may load
#: (the port, ``sparse_matrix_tpu_torch``, is another top-level name)
FOREIGN = ("jax", "jaxlib", "flax", "sparse_matrix_tpu")


def foreign_modules(modules=None) -> list:
    """The names in ``modules`` (``sys.modules``) whose top-level name,
    the part before the first dot, is one of :data:`FOREIGN`."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in list(modules) if m.split(".")[0] in FOREIGN)


def finish(line: dict) -> int:
    """Once the window has closed: where this process holds JAX or the JAX
    package, name what it holds on standard error and return 3 with no
    result printed; else :func:`emit` the line and return 0."""
    found = foreign_modules()
    if found:
        tops = sorted({m.split(".")[0] for m in found})
        print(f"portbench: this run loaded {', '.join(tops)} ({len(found)} modules: "
              f"{', '.join(found[:20])}); no result is printed", file=sys.stderr, flush=True)
        return 3
    emit(line)
    return 0


def cache_env(root: Path = ROOT) -> None:
    """Fix the kernel caches a run may write to directories inside the
    checkout (the port builds its own library under
    ``sparse_matrix_tpu_torch/_build/``)."""
    cache = Path(root) / "portbench" / "_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "nv")
