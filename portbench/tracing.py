"""The traced sub-window: ``torch.profiler`` over a stated number of
requests, with the benchmark's own ``record_function`` ranges around the
calls into each layer, read back from the profiler's Chrome trace.

Ranges (host side): ``portbench.window`` around the whole sub-window,
``portbench.request`` around each request, and the traffic kind's own
(``portbench.matvec`` around the outer Krylov matvec,
``portbench.precond`` around the ``M^-1`` callable,
``portbench.multiply`` around ``multiply_device``). A device operation
belongs to a range when the host call that launched it (the CUDA runtime
or driver event with its correlation id) lies inside the range.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from collections import defaultdict

WINDOW = "portbench.window"
REQUEST = "portbench.request"
PREFIX = "portbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class ranged:
    """``fn`` called inside a ``record_function`` range named ``name``."""

    def __init__(self, fn, name: str):
        self.fn = fn
        self.name = name

    def __call__(self, *args, **kw):
        import torch

        with torch.profiler.record_function(self.name):
            return self.fn(*args, **kw)


class _Intervals:
    """Sorted, non-overlapping host intervals of one range name."""

    def __init__(self, spans):
        spans = sorted(spans)
        self.start = [s for s, _ in spans]
        self.end = [e for _, e in spans]

    def __len__(self):
        return len(self.start)

    def find(self, t):
        """The interval containing ``t`` as ``(start, end)``, else None."""
        i = bisect.bisect_right(self.start, t) - 1
        if i >= 0 and t <= self.end[i]:
            return self.start[i], self.end[i]
        return None


class Trace:
    """The events of one profiled sub-window (microseconds, one clock)."""

    def __init__(self, events):
        launches = {}
        self.device_ops = []  # (start, end, name, correlation, cat)
        spans = defaultdict(list)
        cpu_ops = []
        for ev in events:
            if ev.get("ph") != "X":
                continue
            cat = ev.get("cat", "")
            ts, dur = float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
            args = ev.get("args") or {}
            if cat in DEVICE_CATS:
                self.device_ops.append((ts, ts + dur, ev.get("name", ""),
                                        args.get("correlation"), cat))
            elif cat in ("cuda_runtime", "cuda_driver"):
                if "correlation" in args:
                    launches[args["correlation"]] = ts
            elif cat == "user_annotation" and ev.get("name", "").startswith(PREFIX):
                spans[ev["name"]].append((ts, ts + dur))
            elif cat == "cpu_op":
                cpu_ops.append((ts, ts + dur, ev.get("name", "")))
        self.device_ops.sort()
        self.launch_ts = launches
        self.ranges = {k: _Intervals(v) for k, v in spans.items()}
        win = self.ranges.get(WINDOW)
        if win is None or len(win) != 1:
            raise ValueError("the trace holds no single portbench.window range")
        self.t0, self.t1 = win.start[0], win.end[0]
        cpu_ops.sort()
        self._cpu_ops = cpu_ops

    @classmethod
    def from_profiler(cls, prof):
        """Export ``prof``'s Chrome trace to a temporary file, read it and
        delete it."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                data = json.load(f)
        finally:
            os.unlink(path)
        return cls(data["traceEvents"] if isinstance(data, dict) else data)

    # -- readings ------------------------------------------------------------

    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def kernels(self):
        return [op for op in self.device_ops if op[4] == "kernel"
                and self.t0 <= op[0] and op[1] <= self.t1]

    def count(self, name: str) -> int:
        iv = self.ranges.get(name)
        return 0 if iv is None else len(iv)

    def device_s_in(self, name: str) -> float | None:
        """Seconds of device operations launched inside the ranges
        ``name``; None where the trace has no such range."""
        iv = self.ranges.get(name)
        if iv is None or not len(iv):
            return None
        total = 0.0
        for s, e, _n, corr, _c in self.device_ops:
            t = self.launch_ts.get(corr)
            if t is not None and iv.find(t) is not None:
                total += e - s
        return total / 1e6

    def unattributed(self) -> int:
        """Device operations of the window with no launch event."""
        return sum(1 for op in self.device_ops
                   if self.t0 <= op[0] <= self.t1 and op[3] not in self.launch_ts)

    def busy_intervals(self):
        """The union of the device operations' intervals, clipped to the
        window."""
        out = []
        for s, e, *_ in self.device_ops:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e6

    def host_context(self, t: float, next_corr) -> str:
        """What the host was doing at ``t``: the innermost benchmark range
        around it, and the operation whose launch ended the gap."""
        inner, best = "between requests", None
        for name, iv in self.ranges.items():
            if name == WINDOW:
                continue
            hit = iv.find(t)
            if hit is not None and (best is None or hit[0] > best):
                inner, best = name, hit[0]
        op = "none"
        lt = self.launch_ts.get(next_corr)
        if lt is not None:
            i = bisect.bisect_right(self._cpu_ops, (lt, float("inf"), "")) - 1
            while i >= 0:
                s, e, name = self._cpu_ops[i]
                if s <= lt <= e:
                    op = name
                    break
                if lt - s > 1e6:
                    break
                i -= 1
        return f"{inner} > {op}"

    def breakdown(self, top: int = 10):
        """The device operations that took most time (by name) and the
        idle gaps of the window summed by what the host was doing."""
        by_name = defaultdict(float)
        for s, e, name, _c, _k in self.device_ops:
            if self.t0 <= s and e <= self.t1:
                by_name[name[:120]] += (e - s) / 1e6
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        busy = self.busy_intervals()
        starts = [op[0] for op in self.device_ops]
        gaps = defaultdict(float)
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        for gs, ge in zip(edges[0::2], edges[1::2]):
            if ge <= gs:
                continue
            j = bisect.bisect_left(starts, ge)
            corr = self.device_ops[j][3] if j < len(self.device_ops) else None
            gaps[self.host_context(gs, corr)] += (ge - gs) / 1e6
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": [[k, v] for k, v in idle]}


def device_idle_pct(trace) -> float | None:
    """``1 - busy / window`` over the sub-window, in percent."""
    if trace is None or trace.window_s() <= 0:
        return None
    busy = trace.busy_s()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / trace.window_s())
