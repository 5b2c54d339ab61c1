"""Each cell's control, the plain reference in bfloat16 put in the
program's place, fails the cell's comparison: here on the CPU at small
sizes, on the card at the cells' own by ``control.py``. bfloat16 CG's
true residual grows with the grid (0.11 at 40², 0.41-0.54 at 128², 17.8-36
at 2048² on the card), so the Poisson cells' control runs at 128²."""

from __future__ import annotations

import pytest

from portbench.control import control_readings
from portbench.harness import Bench

from .conftest import cells, make_tiny_bench

CELLS = cells()


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2**31 + 77])
def test_control_fails(tmp_path, cell, seed):
    root = make_tiny_bench(tmp_path, "control")
    checks = control_readings(Bench(root), cell, seed, 2, "cpu")
    assert any(c["value"] > c["limit"] for c in checks.values()), checks
