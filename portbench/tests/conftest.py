"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with
tiny configurations, in which a run drives the program on the CPU, and
the cells and planted faults that the run, control and fault tests take.

Everything a test needs of a configuration or a traffic kind sits in the
files it brings, so a new one joins every test here without an edit:

* a configuration: ``configs/<config>.json`` with its ``generator``,
  ``generator_params`` and ``tiny``: ``{"run": {...}}``, generator
  parameters that the CPU runs in seconds, with optional ``"control"``
  and ``"spans"`` entries (default ``"run"``) for the control's and the
  spans' tests; and its entry in ``BENCHMARK.json``;
* a traffic kind: ``traffic/<kind>.py`` (its ``Traffic``, with ``check``
  and ``control``) and ``faults/<kind>.py``, whose ``FAULTS`` maps a name
  to each function that breaks the timed path under pytest's
  ``monkeypatch`` and whose ``CHECK`` names the comparison each must fail;
* a cell: ``workloads/<cell>.json`` and its entries in ``BENCHMARK.json``.

``test_layout.py`` fails, naming the file, where a configuration has no
``tiny.run`` or a cell's kind no faults.
"""

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


def _spec(root: Path) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def tiny_sizes(root: Path, config: dict, which: str = "run"):
    """The generator parameters of ``config`` (a ``BENCHMARK.json`` entry)
    for the tests named ``which``, or None where its file has no
    ``tiny.run``."""
    tiny = json.loads((Path(root) / config["file"]).read_text()).get("tiny") or {}
    if not isinstance(tiny.get("run"), dict):
        return None
    return tiny.get(which, tiny["run"])


def cells(root: Path = ROOT) -> list:
    """The cells of ``BENCHMARK.json`` at ``root`` whose configuration has a
    tiny size: those that the run and control tests run."""
    spec = _spec(root)
    sized = {c["name"] for c in spec["configs"] if tiny_sizes(root, c) is not None}
    return [w["name"] for w in spec["workloads"] if w["config"] in sized]


def kind_of(root: Path, cell: str) -> str:
    return json.loads((Path(root) / "portbench" / "workloads" / f"{cell}.json").read_text())["kind"]


def faults(root: Path, kind: str):
    """``faults/<kind>.py`` at ``root``, loaded, or None where there is none."""
    from portbench.harness import _load_module

    path = Path(root) / "portbench" / "faults" / f"{kind}.py"
    return _load_module(path, "faults") if path.is_file() else None


def fault_cases(root: Path = ROOT) -> list:
    """Each of :func:`cells` with each fault of its kind: ``(cell, fault)``."""
    out = []
    for cell in cells(root):
        mod = faults(root, kind_of(root, cell))
        out += [(cell, name) for name in (getattr(mod, "FAULTS", None) or {})]
    return out


def configs_without_tiny(root: Path = ROOT) -> list:
    """A message naming the file of each configuration without ``tiny.run``."""
    return [f"{c['file']}: no \"tiny\": {{\"run\": {{...}}}}, the generator parameters at "
            "which the benchmark's CPU tests run its cells (portbench/tests/conftest.py)"
            for c in _spec(root)["configs"] if tiny_sizes(root, c) is None]


def kinds_without_faults(root: Path = ROOT) -> list:
    """A message naming ``faults/<kind>.py`` of each cell's traffic kind
    that has no such file, or an empty ``FAULTS``."""
    by_kind = {}
    for w in _spec(root)["workloads"]:
        by_kind.setdefault(kind_of(root, w["name"]), []).append(w["name"])
    return [f"portbench/faults/{kind}.py: missing or its FAULTS empty, so no fault is planted "
            f"in {', '.join(names)} (portbench/tests/conftest.py)"
            for kind, names in sorted(by_kind.items())
            if not getattr(faults(root, kind), "FAULTS", None)]


def copy_bench(dest: Path, source: Path = ROOT) -> Path:
    """``dest`` holding ``BENCHMARK.json`` and ``portbench/`` of ``source``
    as they are; returns ``dest``."""
    shutil.copytree(Path(source) / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    shutil.copy(Path(source) / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


def make_tiny_bench(dest: Path, which: str = "run", source: Path = ROOT) -> Path:
    """``dest`` holding the benchmark of ``source`` with each configuration
    at its tiny size for the tests named ``which`` (``"run"``,
    ``"control"`` or ``"spans"``) and each cell's trace and warm-up at two
    requests; returns ``dest``. A configuration without a tiny size is
    left out, with its cells, so that no test runs it at its full size."""
    copy_bench(dest, source)
    spec = _spec(source)
    keep = []
    for c in spec["configs"]:
        sizes = tiny_sizes(source, c, which)
        if sizes is None:
            continue
        path = dest / c["file"]
        cfg = json.loads(path.read_text())
        cfg["generator_params"] = sizes
        path.write_text(json.dumps(cfg))
        keep.append(c)
    spec["configs"] = keep
    spec["workloads"] = [w for w in spec["workloads"]
                         if w["config"] in {c["name"] for c in keep}]
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
