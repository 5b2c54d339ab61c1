"""Tiny stand-ins of the configurations added after the benchmark's first
ones, for the CPU tests under ``tests/``: ``tests/conftest.py`` sizes a
tiny benchmark from ``TINY_GENERATORS``, ``tests/test_control.py`` from
its ``CONTROL_SIZES`` and ``tests/test_program_spans.py`` from its
``SIZES``; each later configuration's entry joins them here before every
test, so that those files stay as they are."""

from __future__ import annotations

import pytest

#: generator parameters of the later configurations at a size the CPU runs
#: in seconds: HPCG's 4 levels need sides divisible by 8
LATER_TINY = {"hpcg_104": {"nx": 16, "ny": 16, "nz": 16}}


@pytest.fixture(autouse=True)
def _later_configs_tiny(request):
    from portbench.tests import conftest

    tables = [conftest.TINY_GENERATORS]
    tables += [getattr(request.module, k) for k in ("CONTROL_SIZES", "SIZES")
               if isinstance(getattr(request.module, k, None), dict)]
    for sizes in tables:
        for name, params in LATER_TINY.items():
            sizes.setdefault(name, params)
