"""The port's host runtime: ``native/src/spmx_host.cpp`` built with g++ and
bound with ctypes.

Copied from the reference's native runtime
(``sparse_matrix_tpu/native/src/spmx_native.cpp``): the incomplete
factorizations and the exact triangular solve of ``solvers/ilu.py``; the
aggregation passes, strength and diagonal sweeps, row scaling, Jacobi
smoother values and colmap products of ``solvers/amg.py``; and the threaded
two-phase hash SpGEMM (with its SPA variants and probe-length histograms)
under ``ops/spgemm_host.py``. The library is built at the first call, never
at import, with the reference's flags
(``sparse_matrix_tpu/native/build.py``) into
``_build/libspmx_torch_host.so``; it is rebuilt when the source is newer
than it, and g++ writes a temporary file that is renamed into place, so a
concurrent loader never sees half a library. A missing g++, a failed
compile or a missing symbol raises: nothing falls back to the numpy and
Python versions in ``solvers/`` and ``ops/``, which are the plain versions
the tests hold the library to.

The bindings keep the signatures of ``sparse_matrix_tpu/native/loader.py``
and take float32 or float64 values (the hash engine also int64); any other
dtype raises ``TypeError``. Where the reference returns None because the
library is missing, these raise. Three returns keep the reference's
meaning because they state a property of the input, not a failure:
``jacobi_smoother_native`` returns False when a row has no explicit
diagonal; ``colmap_spgemm_native`` and ``colmap_smoothed_native`` return
None when the rhs has a row with more than one entry (or, for the
smoothed form, the operator is not square), or the values are neither
float32 nor float64; ``amg_strength_native`` returns None when a magnitude
exceeds 1e150 (its squared comparisons would overflow).
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

__all__ = [
    "build",
    "ilu0_native",
    "ilut_native",
    "trisolve_native",
    "hardware_threads",
    "flops_per_row_native",
    "spgemm_hash_native",
    "colmap_spgemm_native",
    "colmap_smoothed_native",
    "aggregate_pass_native",
    "amg_strength_native",
    "scale_rows_native",
    "jacobi_smoother_native",
]

SRC = Path(__file__).resolve().parent / "src" / "spmx_host.cpp"
LIB = BUILD_DIR / "libspmx_torch_host.so"
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-shared", "-pthread")

_LIB: Optional[ctypes.CDLL] = None

_I64P = np.ctypeslib.ndpointer(dtype=np.int64, flags="C_CONTIGUOUS")
_U32P = np.ctypeslib.ndpointer(dtype=np.uint32, flags="C_CONTIGUOUS")
_F64P = np.ctypeslib.ndpointer(dtype=np.float64, flags="C_CONTIGUOUS")
_VALP = {
    "f64": _F64P,
    "f32": np.ctypeslib.ndpointer(dtype=np.float32, flags="C_CONTIGUOUS"),
}
_SUFFIX = {np.dtype(np.float64): "f64", np.dtype(np.float32): "f32"}
# the hash engine also takes int64 values
_SPGEMM_SUFFIX = {**_SUFFIX, np.dtype(np.int64): "i64"}
_SPGEMM_VALP = {**_VALP, "i64": _I64P}

# per-chunk SPA arrays are cols x (4 B mark + value): the reference's limit
_SPA_COLS_LIMIT = 4_194_304
_PROBE_BINS = 64  # kProbeBins of the probe-length histograms


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


def _declare(lib: ctypes.CDLL) -> None:
    """Signatures of every entry point; a missing symbol raises
    ``AttributeError`` here, at the first load."""
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
        fn = getattr(lib, f"spmx_amg_diag_abssum_{sfx}")
        fn.restype = None
        fn.argtypes = [i64, _I64P, _U32P, vp, _F64P, _F64P, _F64P]
        fn = getattr(lib, f"spmx_strength_count_{sfx}")
        fn.restype = None
        fn.argtypes = [i64, _I64P, _U32P, vp, c_double, _F64P, _I64P]
        fn = getattr(lib, f"spmx_strength_fill_{sfx}")
        fn.restype = None
        fn.argtypes = [i64, _I64P, _U32P, vp, c_double, _F64P, _I64P, _I64P]
        fn = getattr(lib, f"spmx_scale_rows_{sfx}")
        fn.restype = None
        fn.argtypes = [i64, _I64P, vp, _F64P, vp]
        fn = getattr(lib, f"spmx_jacobi_smoother_{sfx}")
        fn.restype = i64
        fn.argtypes = [i64, _I64P, _U32P, vp, _F64P, vp]
        fn = getattr(lib, f"spmx_colmap_spgemm_{sfx}")
        fn.restype = i64
        fn.argtypes = [i64, _I64P, _U32P, vp, _U32P, vp, _I64P, _U32P, vp]
        fn = getattr(lib, f"spmx_colmap_smoothed_{sfx}")
        fn.restype = i64
        fn.argtypes = [i64, _I64P, _U32P, vp, _F64P, _U32P, vp, _I64P, _U32P, vp]
    for sfx, vp in _SPGEMM_VALP.items():
        fn = getattr(lib, f"spmx_spgemm_numeric_{sfx}")
        fn.restype = None
        fn.argtypes = [i64, _I64P, _U32P, vp, _I64P, _U32P, vp, _I64P, _I64P, _I64P,
                       i64, c_int, c_int, _U32P, vp]
        fn = getattr(lib, f"spmx_spgemm_numeric_spa_{sfx}")
        fn.restype = None
        fn.argtypes = [i64, i64, _I64P, _U32P, vp, _I64P, _U32P, vp, _I64P, _I64P,
                       _I64P, i64, c_int, c_int, _U32P, vp]
    lib.spmx_hardware_threads.restype = c_int
    lib.spmx_hardware_threads.argtypes = []
    lib.spmx_flops_per_row.restype = None
    lib.spmx_flops_per_row.argtypes = [i64, _I64P, _U32P, _I64P, _I64P]
    lib.spmx_partition_rows.restype = None
    lib.spmx_partition_rows.argtypes = [i64, _I64P, i64, _I64P]
    lib.spmx_spgemm_symbolic.restype = None
    lib.spmx_spgemm_symbolic.argtypes = [i64, _I64P, _U32P, _I64P, _U32P, _I64P, i64,
                                         c_int, _I64P]
    lib.spmx_spgemm_symbolic_spa.restype = None
    lib.spmx_spgemm_symbolic_spa.argtypes = [i64, i64, _I64P, _U32P, _I64P, _U32P, _I64P,
                                             i64, c_int, _I64P]
    lib.spmx_debug_set.restype = None
    lib.spmx_debug_set.argtypes = [c_int]
    lib.spmx_debug_clear.restype = None
    lib.spmx_debug_clear.argtypes = []
    lib.spmx_debug_probe_hist.restype = None
    lib.spmx_debug_probe_hist.argtypes = [_I64P, _I64P]
    for which in (1, 2):
        fn = getattr(lib, f"spmx_aggregate_pass{which}")
        fn.restype = i64
        fn.argtypes = [i64, _I64P, _I64P, _I64P]
    lib.spmx_aggregate_pass3.restype = i64
    lib.spmx_aggregate_pass3.argtypes = [i64, _I64P, _I64P, i64, _I64P]


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(build())
        _declare(lib)
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


# -- the hash SpGEMM engine (the reference crate's mul_hash) -----------------


def hardware_threads() -> int:
    """``std::thread::hardware_concurrency()`` of the host library."""
    return int(_library().spmx_hardware_threads())


def flops_per_row_native(lhs, rhs) -> np.ndarray:
    """Intermediate products of each output row of ``lhs @ rhs`` (int64),
    one sweep over lhs."""
    lib = _library()
    lo, li = _csr_arrays("flops_per_row", lhs.rows, lhs.cols, lhs.offsets, lhs.indices,
                         lhs.nnz())
    ro = np.ascontiguousarray(rhs.offsets, dtype=np.int64)
    if lhs.cols != rhs.rows or ro.shape != (rhs.rows + 1,):
        raise ValueError("LHS cols != RHS rows")
    out = np.zeros(lhs.rows, dtype=np.int64)
    lib.spmx_flops_per_row(lhs.rows, lo, li, ro, out)
    return out


def _debug_begin(lib) -> bool:
    """Arm the library's probe-length recorder when the debug flag is on
    (``utils.debugflags``); True when armed."""
    from ..utils.debugflags import debug_enabled

    if not debug_enabled():
        return False
    lib.spmx_debug_clear()
    lib.spmx_debug_set(1)
    return True


def _debug_end(lib, row_nz) -> None:
    """Read the probe histograms back, disarm, and record them with the
    output row-length histogram in ``utils.debugflags``."""
    from ..utils.debugflags import record_histogram

    sym = np.zeros(_PROBE_BINS, dtype=np.int64)
    num = np.zeros(_PROBE_BINS, dtype=np.int64)
    lib.spmx_debug_probe_hist(sym, num)
    lib.spmx_debug_set(0)
    record_histogram("native_probe_symbolic", {int(i): int(c) for i, c in enumerate(sym) if c})
    record_histogram("native_probe_numeric", {int(i): int(c) for i, c in enumerate(num) if c})
    lens, counts = np.unique(row_nz, return_counts=True)
    record_histogram("native_row_nz", {int(k): int(v) for k, v in zip(lens, counts)})


def spgemm_hash_native(lhs, rhs, *, output_sorted: bool = False, num_threads: int = 0):
    """``lhs @ rhs`` by the two-phase threaded Gustavson engine: FLOP
    bounds and a FLOP-balanced split into ``4 * hardware_threads()`` row
    chunks, an exact symbolic count, then the numeric phase into exactly
    sized rows. Each output entry sums its products in lhs-CSR order, and
    cancellation zeros stay explicit. The SPA variant (a dense
    epoch-marked accumulator) runs when ``rhs.cols <= 4,194,304`` and the
    products number at least ``rhs.cols / 4``, else the linear-probe hash
    tables (``h(k) = k * 107``, capacity twice the next power of two of the
    row's bound, at least 16); unsorted rows come back in hash-table order
    (hash) or first-appearance order (SPA). The result does not depend on
    ``num_threads`` (0: every hardware thread) or the split. Values of
    float32, float64 or int64 (both operands cast to their result type)."""
    from ..formats.csr import CsrMatrix, INDEX_DTYPE, OFFSET_DTYPE

    lib = _library()
    if lhs.cols != rhs.rows:
        raise ValueError("LHS cols != RHS rows")
    dtype = np.result_type(lhs.vals.dtype, rhs.vals.dtype)
    sfx = _SPGEMM_SUFFIX.get(np.dtype(dtype))
    if sfx is None:
        raise TypeError(f"spgemm_hash_native: values of dtype {dtype}; the engine takes "
                        "float32, float64 and int64")
    rows = lhs.rows
    lo, li = _csr_arrays("spgemm lhs", rows, lhs.cols, lhs.offsets, lhs.indices, lhs.nnz())
    ro, ri = _csr_arrays("spgemm rhs", rhs.rows, rhs.cols, rhs.offsets, rhs.indices,
                         rhs.nnz())
    lv = np.ascontiguousarray(lhs.vals, dtype=dtype)
    rv = np.ascontiguousarray(rhs.vals, dtype=dtype)

    # phase 1: FLOP upper bounds and balanced row chunks
    row_nz = np.zeros(rows, dtype=np.int64)
    lib.spmx_flops_per_row(rows, lo, li, ro, row_nz)
    num_parts = max(1, min(rows, int(lib.spmx_hardware_threads()) * 4))
    rows_offset = np.zeros(num_parts + 1, dtype=np.int64)
    lib.spmx_partition_rows(rows, row_nz, num_parts, rows_offset)
    use_spa = rhs.cols <= _SPA_COLS_LIMIT and int(row_nz.sum()) >= rhs.cols // 4
    debug_armed = False if use_spa else _debug_begin(lib)

    # phase 2: symbolic, exact row nnz
    if use_spa:
        lib.spmx_spgemm_symbolic_spa(rows, rhs.cols, lo, li, ro, ri, rows_offset, num_parts,
                                     int(num_threads), row_nz)
    else:
        lib.spmx_spgemm_symbolic(rows, lo, li, ro, ri, rows_offset, num_parts,
                                 int(num_threads), row_nz)

    # phase 3: exact allocation, numeric
    offsets = np.zeros(rows + 1, dtype=OFFSET_DTYPE)
    np.cumsum(row_nz, out=offsets[1:])
    nnz = int(offsets[-1])
    out_indices = np.zeros(nnz, dtype=INDEX_DTYPE)
    out_vals = np.zeros(nnz, dtype=dtype)
    srt = 1 if output_sorted else 0
    if use_spa:
        getattr(lib, f"spmx_spgemm_numeric_spa_{sfx}")(
            rows, rhs.cols, lo, li, lv, ro, ri, rv, offsets, row_nz, rows_offset,
            num_parts, int(num_threads), srt, out_indices, out_vals)
    else:
        getattr(lib, f"spmx_spgemm_numeric_{sfx}")(
            rows, lo, li, lv, ro, ri, rv, offsets, row_nz, rows_offset, num_parts,
            int(num_threads), srt, out_indices, out_vals)
    if debug_armed:
        _debug_end(lib, row_nz)
    return CsrMatrix(rows, rhs.cols, out_vals, out_indices, offsets, is_sorted=output_sorted)


# -- colmap products (rhs with at most one entry per row) --------------------


def _colmap_operand(rhs, dtype):
    """``(tmap, tval)`` of an rhs with at most one entry per row (0xFFFFFFFF
    marks an empty row), or None when a row holds more."""
    ro = np.asarray(rhs.offsets)
    row_len = np.diff(ro)
    if row_len.max(initial=0) > 1:
        return None
    tmap = np.full(rhs.rows, 0xFFFFFFFF, dtype=np.uint32)
    tval = np.zeros(rhs.rows, dtype=dtype)
    has = row_len == 1
    src = ro[:-1][has]
    tmap[has] = rhs.indices[src]
    tval[has] = rhs.vals[src]
    return tmap, tval


def colmap_spgemm_native(lhs, rhs):
    """``lhs @ rhs`` when rhs has at most one entry per row: a hash-free
    column relabel and a per-row merge (products summed in lhs-CSR order,
    cancellation zeros kept). Returns a sorted CsrMatrix, or None when a
    row of rhs holds more than one entry or the values are neither float32
    nor float64."""
    from ..formats.csr import CsrMatrix, INDEX_DTYPE, OFFSET_DTYPE

    if lhs.cols != rhs.rows:
        raise ValueError("LHS cols != RHS rows")
    dtype = np.result_type(lhs.vals.dtype, rhs.vals.dtype)
    sfx = _SUFFIX.get(np.dtype(dtype))
    if sfx is None:
        return None
    op = _colmap_operand(rhs, dtype)
    if op is None:
        return None
    fn = getattr(_library(), f"spmx_colmap_spgemm_{sfx}")
    lo, li = _csr_arrays("colmap_spgemm", lhs.rows, lhs.cols, lhs.offsets, lhs.indices,
                         lhs.nnz())
    nnz_ub = max(1, int(lo[-1]))
    out_offsets = np.zeros(lhs.rows + 1, dtype=OFFSET_DTYPE)
    out_indices = np.empty(nnz_ub, dtype=INDEX_DTYPE)
    out_vals = np.empty(nnz_ub, dtype=dtype)
    w = fn(lhs.rows, lo, li, np.ascontiguousarray(lhs.vals, dtype=dtype), *op,
           out_offsets, out_indices, out_vals)
    return CsrMatrix(lhs.rows, rhs.cols, out_vals[:w], out_indices[:w], out_offsets,
                     is_sorted=True)


def colmap_smoothed_native(a, ws, rhs):
    """Fused prolongator smoothing ``(I - diag(ws) @ a) @ rhs`` for square
    ``a`` and an rhs with at most one entry per row, in one pass over
    ``a``: each term is ``(V)((r == j) - a_rj * ws_r) * t_j``, the per-term
    rounding of materializing the smoother matrix and running
    :func:`colmap_spgemm_native`; a row of ``a`` without an explicit
    diagonal takes the identity's term. Returns a sorted CsrMatrix, or None
    when ``a`` is not square, a row of rhs holds more than one entry or
    the values are neither float32 nor float64."""
    from ..formats.csr import CsrMatrix, INDEX_DTYPE, OFFSET_DTYPE

    dtype = np.result_type(a.vals.dtype, rhs.vals.dtype)
    sfx = _SUFFIX.get(np.dtype(dtype))
    if sfx is None or a.rows != a.cols or a.cols != rhs.rows:
        return None
    op = _colmap_operand(rhs, dtype)
    if op is None:
        return None
    fn = getattr(_library(), f"spmx_colmap_smoothed_{sfx}")
    lo, li = _csr_arrays("colmap_smoothed", a.rows, a.cols, a.offsets, a.indices, a.nnz())
    ws = np.ascontiguousarray(ws, dtype=np.float64)
    if ws.shape != (a.rows,):
        raise ValueError("colmap_smoothed: ws must be (rows,)")
    # + rows: a row without an explicit diagonal adds the identity's term
    nnz_ub = max(1, int(lo[-1]) + a.rows)
    out_offsets = np.zeros(a.rows + 1, dtype=OFFSET_DTYPE)
    out_indices = np.empty(nnz_ub, dtype=INDEX_DTYPE)
    out_vals = np.empty(nnz_ub, dtype=dtype)
    w = fn(a.rows, lo, li, np.ascontiguousarray(a.vals, dtype=dtype), ws, *op,
           out_offsets, out_indices, out_vals)
    return CsrMatrix(a.rows, rhs.cols, out_vals[:w], out_indices[:w], out_offsets,
                     is_sorted=True)


# -- the AMG setup sweeps ----------------------------------------------------


def _graph_arrays(so, si, n: int):
    so = np.ascontiguousarray(so, dtype=np.int64)
    si = np.ascontiguousarray(si, dtype=np.int64)
    if so.shape != (n + 1,) or so[0] != 0 or np.any(np.diff(so) < 0) or si.size != so[-1]:
        raise ValueError("aggregate: s_offsets must be a nondecreasing (n + 1,) array "
                         "from 0 that ends at the size of s_indices")
    if si.size and (int(si.min()) < 0 or int(si.max()) >= n):
        raise ValueError("aggregate: a strong neighbour is out of range")
    return so, si


def aggregate_pass_native(which: int, so, si, agg, na: int = 0) -> int:
    """Greedy aggregation pass 1, 2 or 3 of ``solvers/amg.py`` on the strong
    graph ``(so, si)``: updates ``agg`` (int64, C-contiguous, -1 for a
    free node) in place and returns the aggregate count (passes 1 and 3;
    pass 3 numbers new aggregates from ``na``) or the nodes attached
    (pass 2)."""
    if which not in (1, 2, 3):
        raise ValueError(f"aggregate: no pass {which}")
    if agg.dtype != np.int64:
        raise TypeError("aggregate: agg must be int64")
    _contiguous("aggregate", agg)
    lib = _library()
    so, si = _graph_arrays(so, si, len(agg))
    if which == 1:
        return int(lib.spmx_aggregate_pass1(len(agg), so, si, agg))
    if which == 2:
        return int(lib.spmx_aggregate_pass2(len(agg), so, si, agg))
    return int(lib.spmx_aggregate_pass3(len(agg), so, si, int(na), agg))


def amg_strength_native(rows, offsets, indices, vals, theta: float):
    """The AMG per-level analysis in three sweeps: ``(diag, abssum,
    s_offsets, s_indices)``, the signed diagonal, the absolute row sums and
    the strong graph (``|a_ij| >= theta sqrt(d_i d_j)``, compared in
    squares, ``d`` the absolute diagonal or, where it is 0, the row's
    largest magnitude, or 1). None when a magnitude exceeds 1e150."""
    vals = np.ascontiguousarray(vals)
    n = int(rows)
    offsets, indices = _csr_arrays("amg_strength", n, n, offsets, indices, vals.size)
    diag = np.zeros(n, dtype=np.float64)
    abssum = np.zeros(n, dtype=np.float64)
    rowmax = np.zeros(n, dtype=np.float64)
    _entry("spmx_amg_diag_abssum", vals.dtype)(n, offsets, indices, vals, diag, abssum,
                                               rowmax)
    if n and float(rowmax.max()) > 1e150:
        return None
    sdiag = np.abs(diag)
    missing = sdiag == 0.0
    if missing.any():
        sdiag[missing] = np.where(rowmax[missing] > 0, rowmax[missing], 1.0)
    theta2 = float(theta) * float(theta)
    counts = np.zeros(n, dtype=np.int64)
    _entry("spmx_strength_count", vals.dtype)(n, offsets, indices, vals, theta2, sdiag,
                                              counts)
    s_offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=s_offsets[1:])
    s_indices = np.zeros(max(1, int(s_offsets[-1])), dtype=np.int64)
    _entry("spmx_strength_fill", vals.dtype)(n, offsets, indices, vals, theta2, sdiag,
                                             s_offsets, s_indices)
    return diag, abssum, s_offsets, s_indices[: int(s_offsets[-1])]


def scale_rows_native(rows, offsets, vals, s) -> np.ndarray:
    """``out[k] = vals[k] * s[row(k)]`` (rounded once from float64), one
    sweep."""
    vals = np.ascontiguousarray(vals)
    fn = _entry("spmx_scale_rows", vals.dtype)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    s = np.ascontiguousarray(s, dtype=np.float64)
    if offsets.shape != (int(rows) + 1,) or offsets[-1] != vals.size or s.shape != (int(rows),):
        raise ValueError("scale_rows: offsets, values and s disagree")
    out = np.empty_like(vals)
    fn(int(rows), offsets, vals, s, out)
    return out


def jacobi_smoother_native(rows, offsets, indices, vals, ws):
    """The values of ``S = I - diag(ws) A`` on A's pattern:
    ``out = -vals * ws[row]`` with 1 added at diagonal entries, in float64,
    rounded once. False when some row has no explicit diagonal."""
    vals = np.ascontiguousarray(vals)
    fn = _entry("spmx_jacobi_smoother", vals.dtype)
    n = int(rows)
    offsets, indices = _csr_arrays("jacobi_smoother", n, n, offsets, indices, vals.size)
    ws = np.ascontiguousarray(ws, dtype=np.float64)
    if ws.shape != (n,):
        raise ValueError("jacobi_smoother: ws must be (rows,)")
    out = np.empty_like(vals)
    ndiag = int(fn(n, offsets, indices, vals, ws, out))
    if ndiag != n:
        return False
    return out
