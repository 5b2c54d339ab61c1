"""Discipline of the port package (sparse_matrix_tpu_torch) and chip_smoke.py.

* With every ``jax*`` import and the JAX package ``sparse_matrix_tpu``
  itself blocked, the port imports every module and chip_smoke.py, plans a
  Poisson 32^2 operator on the CPU and runs three CG iterations, squares
  a small matrix with ``BlockSpgemm`` and with ``EscSpgemm``, and, with
  the default device set to the CPU, with ``A @ A``; importing the
  package itself loads neither torch nor the CUDA toolchain.
* No module of the port, nor chip_smoke.py, imports jax or anything of
  ``sparse_matrix_tpu``.
* The capability rules of tests/test_capability_discipline.py, applied to
  the port: no unseeded or global RNG, environment reads only in
  ``native/build.py``, wall clocks only in chip_smoke.py, no bare
  ``open()``.
* No silent CPU fallback: ``device="cuda"`` without a GPU raises, the
  kernel wrappers refuse CPU tensors, and a missing nvcc raises.
"""

import ast
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "sparse_matrix_tpu_torch"
ENV_ALLOWED = {"native/build.py"}

_BLOCK_JAX = """
import importlib.abc, sys

class _NoJax(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "jax" or name.startswith(("jax.", "jaxlib")):
            raise ImportError(f"jax is blocked: {name}")
        if name == "sparse_matrix_tpu" or name.startswith("sparse_matrix_tpu."):
            raise ImportError(f"the JAX package is blocked: {name}")
        return None

sys.meta_path.insert(0, _NoJax())
"""


def _run_blocked(body: str) -> str:
    res = subprocess.run(
        [sys.executable, "-c", _BLOCK_JAX + body],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_port_runs_with_jax_blocked():
    out = _run_blocked("""
import sparse_matrix_tpu_torch as spt
assert "torch" not in sys.modules, "importing the package must stay lazy"
import numpy as np, torch, pkgutil, importlib
for mod in pkgutil.walk_packages(spt.__path__, "sparse_matrix_tpu_torch."):
    importlib.import_module(mod.name)
import chip_smoke
from sparse_matrix_tpu_torch.formats import bcsr
from sparse_matrix_tpu_torch.ops import device_sorted, spgemm_block
a = spt.poisson_2d_csr(32, dtype=np.float32)
op = spt.SpmvOperator(a, device="cpu")
b = torch.from_numpy(np.random.default_rng(0).standard_normal(a.rows).astype(np.float32))
res = spt.cg_solve(op, b, maxiter=3)
assert res.iterations == 3 and bool(torch.isfinite(res.x).all())
c = spgemm_block.BlockSpgemm(a, a, device="cpu", bs=64).multiply()
want = a.to_dense() @ a.to_dense()
assert c.nnz() == np.count_nonzero(want) and np.allclose(c.to_dense(), want)
e = spt.EscSpgemm(a, a, device="cpu", reduce="sort")
assert e.engine == "pallas" and np.allclose(e.multiply().to_dense(), want)
spt.set_default_device("cpu")
assert np.allclose((a @ a).to_dense(), want)
assert not any(m == "jax" or m.startswith("jax.") for m in sys.modules)
assert not any(m == "sparse_matrix_tpu" or m.startswith("sparse_matrix_tpu.")
               for m in sys.modules)
print(op.format, res.iterations)
""")
    assert out.split() == ["dia", "3"]


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _dotted(node):
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def _blocked(name: str) -> bool:
    return (name == "jax" or name.startswith(("jax.", "jaxlib"))
            or name == "sparse_matrix_tpu" or name.startswith("sparse_matrix_tpu."))


def test_no_jax_import_in_port():
    bad = []
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            bad += [f"{path.name}:{node.lineno}: {n}" for n in names if _blocked(n)]
    assert not bad, bad


def test_capability_discipline_in_port():
    problems = []
    for path in _sources():
        rel = path.relative_to(PKG).as_posix() if PKG in path.parents else path.name
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Attribute, ast.Name)):
                if _dotted(node) in ("os.environ", "os.getenv") and rel not in ENV_ALLOWED:
                    problems.append(f"{rel}:{node.lineno}: environment read")
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func)
            if d.endswith("random.default_rng") and not node.args and not node.keywords:
                problems.append(f"{rel}:{node.lineno}: unseeded default_rng()")
            if d.startswith("np.random.") and d != "np.random.default_rng":
                problems.append(f"{rel}:{node.lineno}: global RNG {d}")
            if d.startswith("torch.") and d.split(".")[-1] in ("manual_seed", "seed", "rand", "randn"):
                problems.append(f"{rel}:{node.lineno}: torch global RNG {d}")
            if d in ("time.time", "time.perf_counter", "time.monotonic") and rel != "chip_smoke.py":
                problems.append(f"{rel}:{node.lineno}: wall clock {d}")
            if d == "open":
                problems.append(f"{rel}:{node.lineno}: bare open()")
    assert not problems, "\n".join(problems)


def test_cuda_device_without_gpu_raises():
    from sparse_matrix_tpu_torch.device import require_device
    from sparse_matrix_tpu_torch.ops.operator import SpmvOperator
    from sparse_matrix_tpu_torch.solvers.poisson import poisson_2d_csr

    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        SpmvOperator(poisson_2d_csr(8, dtype=np.float32), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        require_device("cuda:0")
    with pytest.raises(ValueError, match="unsupported device"):
        require_device("meta")


@pytest.mark.parametrize("launch", ["dia", "aligned", "lanepack", "bell", "stripe",
                                    "dia_spmm", "aligned_spmm", "lanepack_spmm",
                                    "bell_spmm", "bcsr_spmm", "block_spgemm",
                                    "esc_expand"])
def test_kernel_wrappers_refuse_cpu_tensors(launch):
    from sparse_matrix_tpu_torch.native import kernels

    f32 = torch.zeros(128)
    i8 = torch.zeros(128, dtype=torch.int8)
    i16 = torch.zeros(128, dtype=torch.int16)
    i32 = torch.zeros(1, dtype=torch.int32)
    blk = torch.zeros(1, 16, 16)
    calls = {
        "dia": lambda: kernels.launch_dia(f32[None], i32, f32, f32, rows=128, cols=128),
        "aligned": lambda: kernels.launch_aligned(f32, i8, i32, i32, f32, f32),
        "lanepack": lambda: kernels.launch_lanepack(f32, i16, i8, i8, i32, i32, f32, f32),
        "bell": lambda: kernels.launch_bell(f32[None, None], i8[None, None], i32, f32, f32,
                                            bias=128, rows=128),
        "stripe": lambda: kernels.launch_stripe(f32, i8, i8, None, i32, i32, f32, f32, levels=1),
        "dia_spmm": lambda: kernels.launch_dia_spmm(f32[None], i32, f32[None, None], f32[None, None],
                                                    rows=128, cols=128, x_lo=0, y_lo=0),
        "aligned_spmm": lambda: kernels.launch_aligned_spmm(f32, i8, i32, i32, f32[None, None],
                                                            f32[None, None], cols=128),
        "lanepack_spmm": lambda: kernels.launch_lanepack_spmm(
            f32, i16, i8, i8, i32, i32, f32[None, None], f32[None, None], cols=128),
        "bell_spmm": lambda: kernels.launch_bell_spmm(f32[None, None], i8[None, None], i32,
                                                      f32[None, None], f32[None, None],
                                                      bias=128, cols=128),
        "bcsr_spmm": lambda: kernels.launch_bcsr_spmm(blk, i32, i32.repeat(2), f32[:, None],
                                                      f32[:, None]),
        "block_spgemm": lambda: kernels.launch_block_spgemm(blk, blk, i32, i32,
                                                            i32.repeat(2), blk),
        "esc_expand": lambda: kernels.launch_esc_expand(f32, f32, i16, i16, i32, i32,
                                                        torch.zeros(1024), num_products=5),
    }
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="needs CUDA"):
        calls[launch]()
    assert kernels.launch_counts == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from sparse_matrix_tpu_torch.native import build

    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "LIB", tmp_path / "missing.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
