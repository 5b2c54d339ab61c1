"""Debug instrumentation flag and histogram store.

Counterpart of the part of ``sparse_matrix_tpu/utils/debugflags.py`` that
the hash SpGEMM uses: a runtime flag (:func:`set_debug`) in place of the
reference crate's ``debug`` cargo feature, and a process-global store of
the histograms the engine records under it (probe lengths of the host
library's hash tables, output row lengths, and the dict loop's per-phase
counts), which tests and benches read back. The reference also reads the
flag from ``SPMX_DEBUG`` at import; the port reads no environment outside
its build, so the flag starts off.
"""

from __future__ import annotations

from typing import Dict

__all__ = [
    "debug_enabled",
    "set_debug",
    "record_histogram",
    "get_histograms",
    "clear_histograms",
]

_DEBUG = False
_HISTOGRAMS: Dict[str, Dict[int, int]] = {}


def debug_enabled() -> bool:
    return _DEBUG


def set_debug(on: bool) -> None:
    global _DEBUG
    _DEBUG = bool(on)


def record_histogram(name: str, hist: Dict[int, int]) -> None:
    """Add ``hist`` (bin -> count) into the store's histogram ``name``."""
    agg = _HISTOGRAMS.setdefault(name, {})
    for k, v in hist.items():
        agg[k] = agg.get(k, 0) + v


def get_histograms() -> Dict[str, Dict[int, int]]:
    return {k: dict(v) for k, v in _HISTOGRAMS.items()}


def clear_histograms() -> None:
    _HISTOGRAMS.clear()
