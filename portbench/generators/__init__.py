"""Matrix generators of the benchmark, one file a generator.

``generators/<name>.py`` defines ``make(rng, **params) -> Csr`` (a
configuration's ``generator``) or ``transform(csr, **params) -> Csr`` (a
cell's ``matrix_transform``). They are copies of the port's own
generators on plain numpy arrays (:mod:`.csr`), so that a change to the
program cannot move the benchmark's matrices; the tests hold them
array-equal to the port's.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

HERE = Path(__file__).resolve().parent


def load(name: str, root: Path = HERE):
    """The module ``<root>/<name>.py``."""
    path = Path(root) / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no generator {name!r} ({path})")
    spec = importlib.util.spec_from_file_location(f"portbench_generator_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
