"""The port's host runtime: ``native/src/spmx_host.cpp`` built with g++ and
bound with ctypes.

The incomplete factorizations and the exact triangular solve of
``solvers/ilu.py`` are sequential along the row-dependency chain, so they
run on the host, in C++ copied from the reference's native runtime
(``sparse_matrix_tpu/native/src/spmx_native.cpp``). The library is built
at the first call, never at import, with the reference's flags
(``sparse_matrix_tpu/native/build.py``) into
``_build/libspmx_torch_host.so``; it is rebuilt when the source is newer
than it, and g++ writes a temporary file that is renamed into place, so a
concurrent loader never sees half a library. A missing g++ or a failed
compile raises: nothing falls back to the Python loops of
``solvers/ilu.py``, which are the plain versions the tests hold the
library to.

The bindings keep the signatures of ``sparse_matrix_tpu/native/loader.py``
(``ilu0_native``, ``ilut_native``, ``trisolve_native``) and take float32
or float64 values; any other dtype raises ``TypeError``.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import numpy as np

from .build import BUILD_DIR

__all__ = ["build", "ilu0_native", "ilut_native", "trisolve_native"]

SRC = Path(__file__).resolve().parent / "src" / "spmx_host.cpp"
LIB = BUILD_DIR / "libspmx_torch_host.so"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared")

_LIB: Optional[ctypes.CDLL] = None

_I64P = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_U32P = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
_VALP = {
    "f64": np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS"),
    "f32": np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS"),
}
_SUFFIX = {np.dtype(np.float64): "f64", np.dtype(np.float32): "f32"}


def build() -> str:
    """Compile if stale and return the library path."""
    if LIB.exists() and LIB.stat().st_mtime >= SRC.stat().st_mtime:
        return str(LIB)
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            "g++ not found on PATH: the host runtime of sparse_matrix_tpu_torch "
            "cannot be built"
        )
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = BUILD_DIR / f"{LIB.name}.{os.getpid()}.tmp"
    cmd = [cxx, *CXX_FLAGS, str(SRC), "-o", str(tmp)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"g++ failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stderr}{res.stdout}"
        )
    os.replace(tmp, LIB)
    return str(LIB)


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        i64, c_int, c_double = ctypes.c_int64, ctypes.c_int, ctypes.c_double
        for sfx, vp in _VALP.items():
            fn = getattr(lib, f"spmx_ilu0_{sfx}")
            fn.restype = i64
            fn.argtypes = [i64, i64, _I64P, _U32P, vp, _I64P]
            fn = getattr(lib, f"spmx_ilut_{sfx}")
            fn.restype = i64
            fn.argtypes = [i64, i64, _I64P, _U32P, vp, c_double, i64,
                           _I64P, _U32P, vp, _I64P, _U32P, vp]
            fn = getattr(lib, f"spmx_trisolve_{sfx}")
            fn.restype = i64
            fn.argtypes = [i64, _I64P, _U32P, vp, _I64P, vp, c_int, c_int]
        _LIB = lib
    return _LIB


def _entry(prefix: str, dtype):
    sfx = _SUFFIX.get(np.dtype(dtype))
    if sfx is None:
        raise TypeError(f"{prefix}: values of dtype {dtype}; the host runtime takes "
                        "float32 and float64")
    return getattr(_library(), f"{prefix}_{sfx}")


def _csr_arrays(name: str, rows: int, cols: int, offsets, indices, nvals: int):
    """Offsets (int64) and indices (uint32) checked against ``rows``,
    ``cols`` and the value count before any pointer reaches C++."""
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    indices = np.ascontiguousarray(indices, dtype=np.uint32)
    if offsets.shape != (rows + 1,) or offsets[0] != 0 or np.any(np.diff(offsets) < 0):
        raise ValueError(f"{name}: offsets must be a nondecreasing (rows + 1,) array from 0")
    if indices.size != offsets[-1] or nvals != indices.size:
        raise ValueError(f"{name}: offsets, indices and values disagree on nnz")
    if indices.size and int(indices.max()) >= cols:
        raise ValueError(f"{name}: a column index is out of range")
    return offsets, indices


def _diag_array(name: str, rows: int, nnz: int, diag_pos):
    diag_pos = np.ascontiguousarray(diag_pos, dtype=np.int64)
    if diag_pos.shape != (rows,) or (
        rows and (int(diag_pos.max()) >= nnz or int(diag_pos.min()) < -1)
    ):
        raise ValueError(f"{name}: diag_pos must be (rows,) positions below nnz, or -1")
    return diag_pos


def _contiguous(name: str, a: np.ndarray) -> None:
    if not a.flags["C_CONTIGUOUS"]:
        raise ValueError(f"{name}: the array updated in place must be C-contiguous")


def ilu0_native(rows, cols, offsets, indices, vals, diag_pos) -> int:
    """In-place ILU(0) on the CSR value array ``vals`` (C-contiguous,
    float32 or float64; sorted column indices). Returns the first
    zero-pivot row, or -1 on success."""
    _contiguous("ilu0", vals)
    fn = _entry("spmx_ilu0", vals.dtype)
    offsets, indices = _csr_arrays("ilu0", rows, cols, offsets, indices, vals.size)
    diag_pos = _diag_array("ilu0", rows, vals.size, diag_pos)
    return int(fn(rows, cols, offsets, indices, vals, diag_pos))


def ilut_native(rows, cols, offsets, indices, vals, *, tau: float, p: int):
    """ILUT(p, tau). Returns ``(l_cnt, l_idx, l_val, u_cnt, u_idx, u_val)``:
    fixed-cap row arrays (caps p and p + 1; U rows start with the
    diagonal; columns within a row unsorted). Raises ValueError on a zero
    pivot."""
    vals = np.ascontiguousarray(vals)
    fn = _entry("spmx_ilut", vals.dtype)
    if p < 1:
        raise ValueError("ilut needs p >= 1")
    offsets, indices = _csr_arrays("ilut", rows, cols, offsets, indices, vals.size)
    l_cnt = np.zeros(rows, dtype=np.int64)
    l_idx = np.zeros(rows * p, dtype=np.uint32)
    l_val = np.zeros(rows * p, dtype=vals.dtype)
    u_cnt = np.zeros(rows, dtype=np.int64)
    u_idx = np.zeros(rows * (p + 1), dtype=np.uint32)
    u_val = np.zeros(rows * (p + 1), dtype=vals.dtype)
    rc = int(fn(rows, cols, offsets, indices, vals, float(tau), int(p),
                l_cnt, l_idx, l_val, u_cnt, u_idx, u_val))
    if rc >= 0:
        raise ValueError(f"ilut: zero pivot in row {rc}")
    return l_cnt, l_idx, l_val, u_cnt, u_idx, u_val


def trisolve_native(rows, offsets, indices, vals, diag_pos, x, *, lower, unit) -> int:
    """In-place exact CSR triangular solve: ``x`` (C-contiguous, the dtype
    of ``vals``) holds b on entry and the solution on return. Returns the
    zero-pivot row, or -1 on success."""
    _contiguous("trisolve", x)
    vals = np.ascontiguousarray(vals)
    if x.dtype != vals.dtype or x.shape != (rows,):
        raise ValueError("trisolve: x must be (rows,) of the values' dtype")
    fn = _entry("spmx_trisolve", vals.dtype)
    offsets, indices = _csr_arrays("trisolve", rows, rows, offsets, indices, vals.size)
    diag_pos = _diag_array("trisolve", rows, vals.size, diag_pos)
    return int(fn(rows, offsets, indices, vals, diag_pos, x, 1 if lower else 0,
                  1 if unit else 0))
