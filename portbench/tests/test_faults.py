"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell can have, as its traffic kind's
``faults/<kind>.py`` plants them."""

from __future__ import annotations

import time

import pytest

from portbench.harness import Bench, run_cell

from .conftest import fault_cases, faults, kind_of


@pytest.mark.parametrize("cell,fault", fault_cases())
def test_fault_is_caught(tiny_root, monkeypatch, cell, fault):
    planted = faults(tiny_root, kind_of(tiny_root, cell))
    planted.FAULTS[fault](monkeypatch)
    line = run_cell(Bench(tiny_root), cell, seed=2**31 + 5, seconds=0.02, trace=False,
                    device="cpu", t_start=time.perf_counter())
    assert line["correct"] is False
    check = line["checks"][planted.CHECK]
    assert check["value"] > check["limit"]
