"""Discipline of the port package (sparse_matrix_tpu_torch) and chip_smoke.py.

* With every ``jax*`` import and the JAX package ``sparse_matrix_tpu``
  itself blocked, the port imports every module and chip_smoke.py, plans a
  Poisson 32^2 operator on the CPU and runs three CG iterations and three
  IC-PCG iterations (the host factorization library included), squares
  a small matrix with ``BlockSpgemm`` and with ``EscSpgemm``, and, with
  the default device set to the CPU, with ``A @ A``; importing the
  package itself loads neither torch nor the CUDA toolchain.
* No module of the port, nor chip_smoke.py, imports jax or anything of
  ``sparse_matrix_tpu``.
* The capability rules of tests/test_capability_discipline.py, applied to
  the port: no unseeded or global RNG, environment reads only in
  ``native/build.py``, wall clocks (the ``_ns`` forms too) only in
  chip_smoke.py and in ``utils/profiling.py``'s spans, which read the
  clock only while they are on, no bare ``open()``.
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
CLOCK_ALLOWED = {"chip_smoke.py", "utils/profiling.py"}
WALL_CLOCKS = ("time.time", "time.perf_counter", "time.monotonic",
               "time.time_ns", "time.perf_counter_ns", "time.monotonic_ns")

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


def _in_blocked_process(body: str) -> str:
    res = subprocess.run(
        [sys.executable, "-c", _BLOCK_JAX + body],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr
    return res.stdout


def test_port_runs_with_jax_blocked():
    out = _in_blocked_process("""
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
ic = spt.ic_pcg_solve(a, b, device="cpu", maxiter=3)
assert ic.iterations == 3 and bool(torch.isfinite(ic.x).all())
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
            if d in WALL_CLOCKS and rel not in CLOCK_ALLOWED:
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
                                    "esc_expand", "esc_run_sum", "trisweep", "symgs",
                                    "krylov"])
def test_kernel_wrappers_refuse_cpu_tensors(launch):
    from sparse_matrix_tpu_torch.native import kernels

    f32 = torch.zeros(128)
    i8 = torch.zeros(128, dtype=torch.int8)
    i16 = torch.zeros(128, dtype=torch.int16)
    i32 = torch.zeros(1, dtype=torch.int32)
    blk = torch.zeros(1, 16, 16)
    calls = {
        "dia": lambda: kernels.prepare_dia(f32[None], i32, rows=128, cols=128),
        "aligned": lambda: kernels.prepare_aligned(f32[None], i8[None], i32, i32.repeat(1, 4),
                                                   i32.repeat(2), f32[None], i32,
                                                   cols=128, rows=128),
        "lanepack": lambda: kernels.prepare_lanepack(f32[None], i16[None], i8[None], i8[None],
                                                     i32, i32.repeat(1, 4), i32.repeat(2),
                                                     f32[None], i32, cols=128, rows=128),
        "bell": lambda: kernels.prepare_bell(f32[None, None], i8[None, None], i32,
                                             bias=128, rows=128, cols=128),
        "stripe": lambda: kernels.prepare_stripe(f32[None], i8[None], i8[None, None, None],
                                                 None, i32, i32, f32, i32.repeat(1, 4),
                                                 i32.repeat(2), f32[None], i32, levels=1,
                                                 cols=128, rows=128, foreign_pad=False),
        "dia_spmm": lambda: kernels.prepare_dia_spmm(f32[None], i32, rows=128, cols=128, lo=1),
        "aligned_spmm": lambda: kernels.prepare_aligned_spmm(
            f32[None], i8[None], i32, i32.repeat(1, 4), i32.repeat(2), torch.zeros(0, 2048),
            i32.repeat(2), cols=128, rows=128),
        "lanepack_spmm": lambda: kernels.prepare_lanepack_spmm(
            f32[None], i16[None], i8[None], i8[None], i32, i32.repeat(1, 4), i32.repeat(2),
            torch.zeros(0, 2048), i32.repeat(2), cols=128, rows=128),
        "bell_spmm": lambda: kernels.prepare_bell_spmm(f32[None, None], i8[None, None], i32,
                                                       bias=128, rows=128, cols=128),
        "bcsr_spmm": lambda: kernels.prepare_bcsr_spmm(blk, i32, i32.repeat(2),
                                                       i32.repeat(1, 2), i32.repeat(2)),
        "block_spgemm": lambda: kernels.prepare_block_spgemm(blk, blk, i32.repeat(1, 2),
                                                             i32.repeat(2), num_c=1),
        "esc_expand": lambda: kernels.prepare_esc_expand(i32.repeat(2, 4), i32.repeat(1, 8),
                                                         i32, num_products=5, num_slots=1024,
                                                         n_lv=1, n_rv=1),
        "esc_run_sum": lambda: kernels.prepare_esc_run_sum(i32, i32.repeat(2), num_summed=1),
        "trisweep": lambda: kernels.prepare_trisweep(f32[None], i32, f32[:0], i32[:0],
                                                     i32.repeat(2), offsets=(-1,), rows=128,
                                                     chunk_rows=128, levels=0, halo=1),
        "symgs": lambda: kernels.prepare_symgs(f32[None], i32.repeat(128), i32,
                                               color_start=(0, 128), diag=0),
        "krylov": lambda: kernels.KrylovScratch(f32),
    }
    before = dict(kernels.launch_counts)
    with pytest.raises(ValueError, match="need CUDA" if launch == "krylov" else "needs CUDA"):
        calls[launch]()
    assert kernels.launch_counts == before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    from sparse_matrix_tpu_torch.native import build

    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "LIB", tmp_path / "missing.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build()
