"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with
tiny configurations, in which a run drives the program on the CPU."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH_DIR = HERE.parent
ROOT = BENCH_DIR.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: tiny stand-ins of the configurations, the same generators
TINY_GENERATORS = {"poisson2d_2048": {"n": 40}, "femlike_262k": {"n_side": 24, "jitter": 2}}


def make_tiny_bench(dest: Path, sizes=None) -> Path:
    """``dest`` holding the benchmark's files and a ``BENCHMARK.json`` whose
    configurations are tiny (``sizes``: generator parameters by
    configuration, default :data:`TINY_GENERATORS`); returns ``dest``."""
    sizes = TINY_GENERATORS if sizes is None else sizes
    shutil.copytree(BENCH_DIR, dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache", "tests"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        cfg["generator_params"] = sizes[c["name"]]
        path.write_text(json.dumps(cfg))
    for w in spec["workloads"]:
        path = dest / "portbench" / "workloads" / f"{w['name']}.json"
        wl = json.loads(path.read_text())
        wl["params"]["trace_requests"] = 2
        wl["params"]["warm_requests"] = 2
        path.write_text(json.dumps(wl))
    (dest / "BENCHMARK.json").write_text(json.dumps(spec))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_bench(tmp_path)
