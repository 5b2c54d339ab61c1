"""Spans at the port's layer boundaries, on the clock of the device trace.

Counterpart of ``sparse_matrix_tpu/utils/profiling.py``, which wraps the
JAX profiler in one ``trace`` switched by ``SPMX_TRACE_DIR``. The port
instead marks its own layer boundaries with named spans (``spmx.solve``,
``spmx.krylov.matvec``, ``spmx.amg.level1``, ``spmx.esc.multiply``,
``spmx.plan.operator``, ...) and reads no environment variable:

* :func:`span` is off by default. Off, it returns one shared null context:
  no clock read, no allocation, no profiler call.
* :func:`enable` turns it on. A span then appends ``Span(name, parent,
  start_ns, end_ns)`` (``time.perf_counter_ns``) to an in-memory list, for
  work no profiler watches (set-up); :func:`take` hands the list out and
  clears it; nothing else drops them, so a long ``enable()`` grows the
  list until then. Under an active ``torch.profiler`` it also enters
  ``torch.profiler.record_function(name)``, so it lies in the same Chrome
  trace as the device operations its code launched, on their clock. With
  no profiler active it skips that call, which would record nothing and
  cost about 11 us a span (PyTorch 2.11 on an H100 machine's host CPU).
* :func:`trace` writes one profiler trace of a block with the spans on.

A span launches nothing, reads no device value and never synchronises.
Spans nest by call order on the one thread that runs the port's host
code; no span name is opened inside a span of the same name.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, List, NamedTuple

import torch

__all__ = ["Span", "span", "enable", "disable", "enabled", "take", "trace"]

_ON = False
_SPANS: list = []  # [name, parent, start_ns, end_ns] of each span, in opening order
_OPEN: List[int] = []  # indices into _SPANS of the spans now open, innermost last
_NULL = contextlib.nullcontext()


class Span(NamedTuple):
    name: str
    parent: int  # index of the enclosing span in the same list, -1 at the top
    start_ns: int
    end_ns: int


class _Recorded:
    """An open span: its entry in the list and, under a profiler, its
    ``record_function`` range."""

    __slots__ = ("name", "_rf", "_i")

    def __init__(self, name: str):
        self.name = name
        self._rf = None

    def __enter__(self):
        if torch._C._autograd._profiler_enabled():
            self._rf = torch.profiler.record_function(self.name)
            self._rf.__enter__()
        self._i = len(_SPANS)
        _SPANS.append([self.name, _OPEN[-1] if _OPEN else -1, time.perf_counter_ns(), 0])
        _OPEN.append(self._i)
        return self

    def __exit__(self, *exc):
        _SPANS[self._i][3] = time.perf_counter_ns()
        _OPEN.pop()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        return False


def span(name: str):
    """A context manager around one layer's work: the shared null context
    while spans are off, else a recorded span named ``name``."""
    if not _ON:
        return _NULL
    return _Recorded(name)


def enable() -> None:
    global _ON
    _ON = True


def disable() -> None:
    global _ON
    _ON = False


def enabled() -> bool:
    return _ON


def take() -> List[Span]:
    """The spans recorded since the last call, in opening order, and clear
    the list; raises while a span is open (its parent index would
    dangle)."""
    if _OPEN:
        raise RuntimeError(f"take() inside the open span {_SPANS[_OPEN[-1]][0]!r}")
    out = [Span(*s) for s in _SPANS]
    _SPANS.clear()
    return out


@contextlib.contextmanager
def trace(path) -> Iterator[torch.profiler.profile]:
    """Profile the block with the spans on and write its Chrome trace to
    ``path``: ``torch.profiler`` with the CPU activity and, where CUDA is
    there, the CUDA activity (the device synchronised before it stops).
    The spans' previous state comes back afterwards. Where they were off,
    the spans the block recorded are dropped from memory (the trace holds
    them); where they were on, they stay for :func:`take`. View the file
    in ui.perfetto.dev or chrome://tracing."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    was, first = _ON, len(_SPANS)
    enable()
    try:
        with torch.profiler.profile(activities=acts) as prof:
            yield prof
            if cuda:
                torch.cuda.synchronize()
    finally:
        if not was:
            disable()
            del _SPANS[first:]
    prof.export_chrome_trace(str(path))
