"""ctypes bindings of the CUDA kernels, with launch counts.

Every kernel is launched through a launch record (a :class:`_LaunchRecord`)
made once for one plan: ``prepare_<kernel>`` checks that the plan's tensors
are contiguous CUDA tensors of the types the kernel takes on one device,
with the shapes and alignment it needs, and packs the arguments that lead
each call (the kernel's C struct, or its plain leading arguments). A call
of the record checks only what changes per call (its vectors or blocks, K)
and makes one ctypes call, :meth:`_LaunchRecord._enqueue`, which enqueues
the kernel on PyTorch's current stream, raises if the launch was refused
and adds the launches to ``launch_counts[name]``; a plan with no work
launches and counts nothing. A :class:`KrylovScratch` holds one CG or PCG
solve's scratch and a record for each fused Krylov kernel. Nothing here
synchronises or allocates; the callers in ``ops/`` own the outputs. The
library is built and loaded at the first launch, never at import.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

__all__ = [
    "launch_counts",
    "reset_launch_counts",
    "BLOCK_TILE",
    "STRIPE_GROUP_LEVELS",
    "PreparedLaunch",
    "prepare_dia",
    "prepare_aligned",
    "prepare_lanepack",
    "prepare_bell",
    "prepare_stripe",
    "prepare_csr",
    "PreparedSpmm",
    "prepare_aligned_spmm",
    "prepare_lanepack_spmm",
    "prepare_bell_spmm",
    "PreparedTrisweep",
    "prepare_trisweep",
    "PreparedDiaSpmm",
    "prepare_dia_spmm",
    "PreparedBcsr",
    "prepare_bcsr_spmm",
    "PreparedBlockSpgemm",
    "prepare_block_spgemm",
    "PreparedExpand",
    "prepare_esc_expand",
    "PreparedRunSum",
    "prepare_esc_run_sum",
    "PreparedSymgs",
    "prepare_symgs",
    "PreparedBfs",
    "prepare_bfs",
    "KrylovScratch",
]

KERNELS = ("dia", "aligned", "lanepack", "bell", "stripe", "dia_spmm", "aligned_spmm",
           "lanepack_spmm", "bell_spmm", "bcsr_spmm", "block_spgemm", "esc_expand",
           "esc_run_sum", "trisweep", "symgs", "krylov_dot", "cg_update", "p_update",
           "spmv_csr", "bfs_top_down", "bfs_bottom_up")

#: launches per kernel since the last :func:`reset_launch_counts`
launch_counts: Dict[str, int] = {k: 0 for k in KERNELS}

_LIB: Optional[ctypes.CDLL] = None

#: the output tile edge of the block kernels (kTile of csrc/block_tile.h,
#: checked against the library's ``spmx_block_tile`` when it loads): their
#: live-depth streams have one segment per output tile
BLOCK_TILE = 64

#: the levels one thread block of the stripe kernel owns (kGroupLevels of
#: csrc/spmv_stripe.cu, checked against ``spmx_stripe_group_levels`` when
#: the library loads): a plan of L levels needs ``ceil(L / 8)`` tickets a
#: stripe
STRIPE_GROUP_LEVELS = 8

#: the most columns one launch of the aligned and LanePack SpMM kernels
#: takes, and one of their warps (kMaxCols and kGroupCols of
#: csrc/spmm_segments.h, checked against ``spmx_lanepack_spmm_max_cols``/
#: ``_group_cols`` when the library loads): their scratch slots are 16
#: 128-float rows wide, a wider X takes several launches, and a plan needs
#: 16 / 8 tickets a row block
LANEPACK_SPMM_COLS = 16
LANEPACK_SPMM_GROUP_COLS = 8
LANEPACK_SPMM_GROUPS = LANEPACK_SPMM_COLS // LANEPACK_SPMM_GROUP_COLS

#: the threads of one block of the trisweep kernel (kThreads of
#: csrc/trisweep.cu, checked against ``spmx_trisweep_threads`` when the
#: library loads)
TRISWEEP_THREADS = 512

#: the slots one block of the ESC expansion kernel takes, and the most values
#: of each operand window and the most segment starts of a tile it stages in
#: shared memory (kTile, kStage and kSegStage of csrc/esc_expand.cu, checked
#: against ``spmx_esc_expand_tile``/``_stage``/``_seg_stage`` when the
#: library loads): a plan has one tile row a ESC_TILE slots, and a tile past
#: either stage is read from device memory
ESC_TILE = 2048
ESC_STAGE = 2048
ESC_SEG_STAGE = 1024

#: the most colours a SymGS plan may have (SPMX_SYMGS_MAX_COLORS of
#: csrc/spmx_cuda.h, checked against ``spmx_symgs_max_colors`` when the
#: library loads): the plan's C struct holds that many colour starts
SYMGS_MAX_COLORS = 64

#: the 0-d scalars a :class:`KrylovScratch` holds for its kernels to write
KRYLOV_SLOTS = 5

#: the threads of one tile of the CSR-row kernel and the merge-path items
#: each walks (kThreads and kItems of csrc/spmv_csr.cu, checked against
#: ``spmx_csr_threads``/``_items`` when the library loads): a plan's tiles
#: are CSR_THREADS * CSR_ITEMS items of the path
CSR_THREADS = 256
CSR_ITEMS = 8

_F32 = torch.float32
_VALS = (torch.float32, torch.bfloat16)


def reset_launch_counts() -> None:
    for k in KERNELS:
        launch_counts[k] = 0


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from .build import build

        lib = ctypes.CDLL(build())
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.spmx_cuda_error_string.restype = ctypes.c_char_p
        lib.spmx_cuda_error_string.argtypes = [i32]
        lib.spmx_dia.restype = i32
        lib.spmx_dia.argtypes = [i32, vp, i32, vp, i32, i64, i64, vp, vp, vp]
        lib.spmx_dia_f64.restype = i32
        lib.spmx_dia_f64.argtypes = [i32, vp, vp, i32, i64, i64, vp, vp, vp]
        # (plan struct, r, x, stream)
        for fn in (lib.spmx_symgs, lib.spmx_symgs_by_pass):
            fn.restype = i32
            fn.argtypes = [vp, vp, vp, vp]
        # (plan struct): sets its chunk_rows and grid
        lib.spmx_symgs_prepare.restype = i32
        lib.spmx_symgs_prepare.argtypes = [vp]
        # prepared launches: (plan struct, x, y, add, stream)
        for fn in (lib.spmx_aligned, lib.spmx_lanepack, lib.spmx_bell, lib.spmx_stripe):
            fn.restype = i32
            fn.argtypes = [vp, vp, vp, i32, vp]
        lib.spmx_dia_spmm.restype = i32
        lib.spmx_dia_spmm.argtypes = [
            i32, vp, i32, vp, i32, i64, i64, i32, vp, i64, vp, i64, i64, vp,
        ]
        # (plan struct, x, y, k, q0, kq, packed, y_blocks, add, stream)
        for fn in (lib.spmx_aligned_spmm, lib.spmx_lanepack_spmm):
            fn.restype = i32
            fn.argtypes = [vp, vp, vp, i32, i32, i32, i32, i64, i32, vp]
        # (plan struct, x, y, k, stream)
        lib.spmx_bell_spmm.restype = i32
        lib.spmx_bell_spmm.argtypes = [vp, vp, vp, i32, vp]
        lib.spmx_bcsr_spmm.restype = i32
        lib.spmx_bcsr_spmm.argtypes = [
            i32, vp, vp, vp, vp, i64, vp, vp, i64, i32, i64, vp, vp, vp,
        ]
        lib.spmx_block_spgemm.restype = i32
        lib.spmx_block_spgemm.argtypes = [i32, vp, vp, i32, vp, i64, vp, i64, i32, vp, vp]
        # (plan struct, lv, rv, csr_order, p, stream)
        lib.spmx_esc_expand.restype = i32
        lib.spmx_esc_expand.argtypes = [vp, vp, vp, i32, vp, vp]
        # (plan struct, p, val, stream)
        lib.spmx_esc_run_sum.restype = i32
        lib.spmx_esc_run_sum.argtypes = [vp, vp, vp, vp]
        # (plan struct, b, dinv, sweeps, y, stream)
        lib.spmx_trisweep.restype = i32
        lib.spmx_trisweep.argtypes = [vp, vp, vp, i32, vp, vp]
        # (device, values_f64, n, &blocks)
        lib.spmx_krylov_blocks.restype = i32
        lib.spmx_krylov_blocks.argtypes = [i32, i32, i64, ctypes.POINTER(ctypes.c_int32)]
        # (plan struct, u, v, vec, out, stream)
        lib.spmx_krylov_dot.restype = i32
        lib.spmx_krylov_dot.argtypes = [vp, vp, vp, i32, vp, vp]
        # (plan struct, x, r, p, ap, vec, num, den, rr, stream)
        lib.spmx_cg_update.restype = i32
        lib.spmx_cg_update.argtypes = [vp, vp, vp, vp, vp, i32, vp, vp, vp, vp]
        # (plan struct, p, z, vec, num, den, stream)
        lib.spmx_p_update.restype = i32
        lib.spmx_p_update.argtypes = [vp, vp, vp, i32, vp, vp, vp]
        # (plan struct, x, y, stream)
        lib.spmx_csr.restype = i32
        lib.spmx_csr.argtypes = [vp, vp, vp, vp]
        # (plan struct): sets its grid
        lib.spmx_bfs_prepare.restype = i32
        lib.spmx_bfs_prepare.argtypes = [vp]
        # (plan struct, parents, source, stream); (plan struct, parents, cur, q,
        # stream); (plan struct, cur, q, flip, stream); (plan struct, parents,
        # flip, stream); (plan struct, flip, cur, stream); (plan struct,
        # parents, stream)
        for fn, args in ((lib.spmx_bfs_start, [vp, vp, i64, vp]),
                         (lib.spmx_bfs_top_down, [vp, vp, i32, i64, vp]),
                         (lib.spmx_bfs_enter_bitmap, [vp, i32, i64, i32, vp]),
                         (lib.spmx_bfs_bottom_up, [vp, vp, i32, vp]),
                         (lib.spmx_bfs_leave_bitmap, [vp, i32, i32, vp]),
                         (lib.spmx_bfs_end, [vp, vp, vp])):
            fn.restype = i32
            fn.argtypes = args
        for fn in (lib.spmx_block_tile, lib.spmx_stripe_group_levels,
                   lib.spmx_lanepack_spmm_max_cols, lib.spmx_lanepack_spmm_group_cols,
                   lib.spmx_trisweep_threads, lib.spmx_esc_expand_tile,
                   lib.spmx_esc_expand_stage, lib.spmx_esc_expand_seg_stage,
                   lib.spmx_symgs_max_colors, lib.spmx_csr_threads, lib.spmx_csr_items):
            fn.restype = i32
            fn.argtypes = []
        cols = (lib.spmx_lanepack_spmm_max_cols(), lib.spmx_lanepack_spmm_group_cols())
        if cols != (LANEPACK_SPMM_COLS, LANEPACK_SPMM_GROUP_COLS):
            raise RuntimeError(f"the LanePack SpMM kernel takes {cols[0]} columns a launch and "
                               f"{cols[1]} a warp, LANEPACK_SPMM_COLS and _GROUP_COLS are "
                               f"{LANEPACK_SPMM_COLS} and {LANEPACK_SPMM_GROUP_COLS}: its scratch "
                               "slots and tickets would not match")
        if lib.spmx_trisweep_threads() != TRISWEEP_THREADS:
            raise RuntimeError(f"the trisweep kernel runs {lib.spmx_trisweep_threads()} threads "
                               f"a block, TRISWEEP_THREADS is {TRISWEEP_THREADS}")
        esc = (lib.spmx_esc_expand_tile(), lib.spmx_esc_expand_stage(),
               lib.spmx_esc_expand_seg_stage())
        if esc != (ESC_TILE, ESC_STAGE, ESC_SEG_STAGE):
            raise RuntimeError(f"the ESC expansion kernel takes {esc[0]} slots a block and stages "
                               f"{esc[1]} values and {esc[2]} segment starts; ESC_TILE, ESC_STAGE "
                               f"and ESC_SEG_STAGE are {ESC_TILE}, {ESC_STAGE} and "
                               f"{ESC_SEG_STAGE}: the plan's tiles would not match")
        if lib.spmx_symgs_max_colors() != SYMGS_MAX_COLORS:
            raise RuntimeError(f"the SymGS plan holds {lib.spmx_symgs_max_colors()} colours, "
                               f"SYMGS_MAX_COLORS is {SYMGS_MAX_COLORS}: the structs would not "
                               "match")
        if (lib.spmx_csr_threads(), lib.spmx_csr_items()) != (CSR_THREADS, CSR_ITEMS):
            raise RuntimeError(f"the CSR-row kernel runs {lib.spmx_csr_threads()} threads of "
                               f"{lib.spmx_csr_items()} items a tile, CSR_THREADS and CSR_ITEMS "
                               f"are {CSR_THREADS} and {CSR_ITEMS}: the plan's tiles would not "
                               "match")
        if lib.spmx_block_tile() != BLOCK_TILE:
            raise RuntimeError(f"the block kernels tile by {lib.spmx_block_tile()}, "
                               f"BLOCK_TILE is {BLOCK_TILE}: the streams would not match")
        if lib.spmx_stripe_group_levels() != STRIPE_GROUP_LEVELS:
            raise RuntimeError(f"the stripe kernel groups {lib.spmx_stripe_group_levels()} "
                               f"levels, STRIPE_GROUP_LEVELS is {STRIPE_GROUP_LEVELS}: the "
                               "tickets would not match")
        _LIB = lib
    return _LIB


class SegPlan(ctypes.Structure):
    """``SpmxSegPlan`` of ``csrc/spmx_cuda.h``: a segmented SpMV plan's
    pointers and sizes."""

    _fields_ = [(f, ctypes.c_void_p) for f in ("vals", "lane", "ends", "starts", "col_off",
                                                 "segments", "rb_seg", "scratch", "tickets")]
    _fields_ += [("num_segments", ctypes.c_int64), ("cols", ctypes.c_int64),
                 ("rows", ctypes.c_int64), ("device", ctypes.c_int32)]


class BellPlan(ctypes.Structure):
    """``SpmxBellPlan`` of ``csrc/spmx_cuda.h``."""

    _fields_ = [(f, ctypes.c_void_p) for f in ("vals", "lane", "ds")]
    _fields_ += [(f, ctypes.c_int64) for f in ("r128", "rows", "cols")]
    _fields_ += [(f, ctypes.c_int32) for f in ("num_layers", "bias", "lane_bytes",
                                               "values_bf16", "device")]


class StripePlan(ctypes.Structure):
    """``SpmxStripePlan`` of ``csrc/spmx_cuda.h``."""

    _fields_ = [(f, ctypes.c_void_p) for f in (
        "vals", "lane", "ends", "starts", "col_off", "chunk_stripe", "rb_mask", "segments",
        "stripe_seg", "scratch", "tickets")]
    _fields_ += [(f, ctypes.c_int64) for f in ("num_segments", "cols", "rows")]
    _fields_ += [(f, ctypes.c_int32) for f in ("levels", "lane_bytes", "foreign_pad", "device")]


class TrisweepPlan(ctypes.Structure):
    """``SpmxTrisweepPlan`` of ``csrc/spmx_cuda.h``."""

    _fields_ = [(f, ctypes.c_void_p) for f in ("data", "offsets", "scratch", "flags", "state")]
    _fields_ += [(f, ctypes.c_int64) for f in ("rows", "chunks", "reach")]
    _fields_ += [(f, ctypes.c_int32) for f in ("nb", "chunk_rows", "chunk_shift", "tail",
                                               "levels", "upper", "halo", "device")]


class EscPlan(ctypes.Structure):
    """``SpmxEscPlan`` of ``csrc/spmx_cuda.h``."""

    _fields_ = [(f, ctypes.c_void_p) for f in ("segments", "tiles", "perm")]
    _fields_ += [(f, ctypes.c_int64) for f in ("num_segments", "num_tiles", "num_products",
                                               "num_slots")]
    _fields_ += [("device", ctypes.c_int32)]


class RunSumPlan(ctypes.Structure):
    """``SpmxRunSumPlan`` of ``csrc/spmx_cuda.h``."""

    _fields_ = [(f, ctypes.c_void_p) for f in ("order", "run_off")]
    _fields_ += [(f, ctypes.c_int64) for f in ("num_summed", "cap")]
    _fields_ += [("device", ctypes.c_int32)]


class SymgsPlan(ctypes.Structure):
    """``SpmxSymgsPlan`` of ``csrc/spmx_cuda.h``."""

    _fields_ = [(f, ctypes.c_void_p) for f in ("data", "rows", "offsets", "state")]
    _fields_ += [("color_start", ctypes.c_int64 * (SYMGS_MAX_COLORS + 1)), ("n", ctypes.c_int64)]
    _fields_ += [(f, ctypes.c_int32) for f in ("nb", "diag", "colors", "values_f64", "chunk_rows",
                                               "grid", "device")]


class CsrStripe(ctypes.Structure):
    """``SpmxCsrStripe`` of ``csrc/spmx_cuda.h``."""

    _fields_ = [(f, ctypes.c_void_p) for f in ("offsets", "cols", "vals", "coords", "splits",
                                                 "row_ids", "carry")]
    _fields_ += [(f, ctypes.c_int64) for f in ("rows", "tiles", "num_splits")]


class CsrPlan(ctypes.Structure):
    """``SpmxCsrPlan`` of ``csrc/spmx_cuda.h``."""

    _fields_ = [("stripes", ctypes.c_void_p)]
    _fields_ += [(f, ctypes.c_int64) for f in ("num_stripes", "rows", "ncols")]
    _fields_ += [("device", ctypes.c_int32)]


class BfsPlan(ctypes.Structure):
    """``SpmxBfsPlan`` of ``csrc/spmx_cuda.h``."""

    _fields_ = [(f, ctypes.c_void_p) for f in ("offsets", "cols", "has_edges", "unvisited",
                                                 "bits0", "bits1", "queue0", "queue1", "prefix",
                                                 "counts")]
    _fields_ += [(f, ctypes.c_int64) for f in ("n", "words")]
    _fields_ += [(f, ctypes.c_int32) for f in ("grid", "device")]


class KrylovPlan(ctypes.Structure):
    """``SpmxKrylovPlan`` of ``csrc/spmx_cuda.h``."""

    _fields_ = [(f, ctypes.c_void_p) for f in ("partials", "ticket")]
    _fields_ += [("n", ctypes.c_int64)]
    _fields_ += [(f, ctypes.c_int32) for f in ("blocks", "values_f64", "device")]


class _LaunchRecord:
    """What the launch records share: ``args``, the arguments that lead
    every call of the kernel's library function, packed once (the kernel's
    C struct, passed by its address, or a tuple of plain arguments; ``keep``
    holds the tensors they name), ``dtype``, the type of the vectors a call
    takes, the library function, resolved at the first launch, and
    :meth:`_enqueue`. A plan with no work (``empty``) launches and counts
    nothing."""

    __slots__ = ("name", "device", "dtype", "_cname", "_args", "_lead", "_keep", "_fn",
                 "_stream", "_empty")

    def __init__(self, name: str, cname: str, args, device: torch.device, *, empty: bool,
                 keep: tuple, dtype: torch.dtype = _F32):
        self.name, self.device, self.dtype = name, device, dtype
        self._cname, self._args = cname, args
        self._lead = (ctypes.addressof(args),) if isinstance(args, ctypes.Structure) else args
        self._keep, self._empty = keep, empty
        self._fn = self._stream = None

    def _ptr(self, what: str, t: torch.Tensor, n: Optional[int] = None, align: int = 1) -> int:
        """The data pointer of ``t``, a call's operand, once it is checked:
        a contiguous CUDA tensor of the record's device and ``dtype``, of
        ``n`` elements (None: any), its data ``align``-byte aligned."""
        ptr = t.data_ptr()
        if (t.is_cuda and t.get_device() == self.device.index and t.dtype is self.dtype
                and t.is_contiguous() and (n is None or t.numel() == n) and not ptr % align):
            return ptr
        if t.device != self.device:
            raise ValueError(f"{self.name}: {what} is on {t.device}, the plan on {self.device}")
        if t.dtype != self.dtype:
            raise TypeError(f"{self.name}: {what} has dtype {t.dtype}, expected {self.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{self.name}: {what} must be contiguous")
        if n is not None and t.numel() != n:
            raise ValueError(f"{self.name}: {what} has {t.numel()} elements, expected {n}")
        raise ValueError(f"{self.name}: {what} must be {align}-byte aligned")

    def _enqueue(self, *call, launches: int = 1) -> None:
        """One ctypes call ``(*args, *call, stream)`` of the kernel on the
        current stream; raises on a refused launch, else adds the
        ``launches`` it enqueued to ``launch_counts[name]``."""
        fn = self._fn
        if fn is None:
            fn = self._fn = getattr(_library(), self._cname)
            raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
            self._stream = raw or (lambda i: torch.cuda.current_stream(i).cuda_stream)
        err = fn(*self._lead, *call, self._stream(self.device.index))
        if err != 0:
            msg = _library().spmx_cuda_error_string(err).decode()
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA error {err} ({msg})")
        launch_counts[self.name] += launches


class PreparedLaunch(_LaunchRecord):
    """One SpMV kernel's launch on one checked plan: ``launch(x, y,
    add=False)`` checks x (a contiguous CUDA vector of the record's
    ``dtype`` and ``x_len`` elements on the plan's device) and y (the same,
    ``y_len`` elements, 16-byte aligned) and enqueues the kernel with one
    ctypes call of ``(args, x, y, add, stream)``, or of ``(args, x, y,
    stream)`` where the kernel only writes y (``adds=False``: DIA and
    CSR-row, whose ``add=True`` is refused). A call counts ``launches``
    kernels (the CSR-row plan's: two a stripe with split rows)."""

    __slots__ = ("x_len", "y_len", "adds", "launches")

    def __init__(self, name: str, cname: str, args, device: torch.device, *, x_len: int,
                 y_len: int, empty: bool, keep: tuple, dtype: torch.dtype = _F32,
                 adds: bool = True, launches: int = 1):
        super().__init__(name, cname, args, device, empty=empty, keep=keep, dtype=dtype)
        self.x_len, self.y_len, self.adds, self.launches = x_len, y_len, adds, launches

    def __call__(self, x: torch.Tensor, y: torch.Tensor, add: bool = False) -> None:
        px, py = self._ptr("x", x, self.x_len), self._ptr("y", y, self.y_len, 16)
        if add and not self.adds:
            raise ValueError(f"{self.name}: the kernel only writes y")
        if not self._empty:
            self._enqueue(px, py, *((int(add),) if self.adds else ()), launches=self.launches)


class PreparedSpmm(_LaunchRecord):
    """One SpMM kernel's launches on one checked plan: ``launch(x, y,
    packed=False, add=False)`` takes X ``(cols, K)`` and Y ``(rows, K)``
    row-major or, with ``packed`` (the aligned and LanePack SpMM), packed X
    ``(>= c128, K, 128)`` and Y ``(>= r128, K, 128)`` (``X[j, q]`` at ``[j
    // 128, q, j % 128]``), both contiguous f32 CUDA tensors on the plan's
    device, Y 16-byte aligned. ``max_cols``: the aligned and LanePack SpMM
    take any K in launches of that many columns, ``(args, x, y, K, q0,
    columns, packed, Y's row blocks, add, stream)``; None: the BELL SpMM,
    one launch ``(args, x, y, K, stream)`` of at most 16 columns. Store
    mode writes every row of Y (packed: and zeros on Y's row blocks past
    the plan's); ``add=True`` adds (the aligned and LanePack SpMM)."""

    __slots__ = ("rows", "cols", "max_cols")

    def __init__(self, name: str, cname: str, args: ctypes.Structure, device: torch.device,
                 *, rows: int, cols: int, max_cols: Optional[int], empty: bool, keep: tuple):
        super().__init__(name, cname, args, device, empty=empty, keep=keep)
        self.rows, self.cols, self.max_cols = rows, cols, max_cols

    def __call__(self, x: torch.Tensor, y: torch.Tensor, *, packed: bool = False,
                 add: bool = False) -> None:
        px, py = self._ptr("x", x), self._ptr("y", y, align=16)
        k = int(x.shape[1]) if x.dim() >= 2 else 0
        if packed:
            fits = (self.max_cols is not None and x.dim() == 3 and x.shape[2] == 128
                    and x.shape[0] * 128 >= self.cols and y.dim() == 3
                    and y.shape[1:] == x.shape[1:] and y.shape[0] * 128 >= self.rows)
        else:
            fits = x.dim() == 2 and x.shape[0] == self.cols and tuple(y.shape) == (self.rows, k)
        if not fits or k < 1 or (self.max_cols is None and k > 16):
            raise ValueError(f"{self.name}: x {tuple(x.shape)} and y {tuple(y.shape)} do not fit "
                             f"a {self.rows} x {self.cols} plan"
                             + (" in the packed layout" if packed else " as (cols, K), (rows, K)")
                             + ("" if self.max_cols else " with 1 <= K <= 16"))
        if add and self.max_cols is None:
            raise ValueError(f"{self.name}: the kernel only writes y")
        if self._empty:
            if packed and not add:
                y.zero_()
            return
        if self.max_cols is None:
            self._enqueue(px, py, k)
            return
        y_blocks = int(y.shape[0]) if packed else 0
        for q0 in range(0, k, self.max_cols):
            self._enqueue(px, py, k, q0, min(self.max_cols, k - q0), int(packed), y_blocks,
                          int(add))


def _seg_plan(name, dtypes, *, cols, rows, scratch_width=128, tickets_per_rb=1, **tensors):
    """Check a segmented plan (``csrc/segments.h``) and pack its C struct:
    slot arrays ``(chunks, 128)``, ``col_off`` ``(chunks,)``, ``segments``
    ``(S, 4)``, ``rb_seg`` ``(r128 + 1,)``, ``scratch`` ``(slots,
    scratch_width)`` and ``tickets`` ``(tickets_per_rb * r128,)`` int32
    zeros. The segment values are the host's (``ops.spmv.chunk_segments``:
    at most 32 chunks a segment), not read back here. Returns ``(device,
    args)``."""
    dev = _check(name, dtypes, **tensors)
    vals, seg, rb_seg = tensors["vals"], tensors["segments"], tensors["rb_seg"]
    chunks = vals.shape[0] if vals.dim() == 2 else -1
    r128 = -(-rows // 128)
    if (
        vals.shape != (chunks, 128)
        or any(tensors[k].shape != vals.shape for k in ("lane", "ends", "starts") if k in tensors)
        or tensors["col_off"].numel() < chunks
        or seg.dim() != 2 or seg.shape[1] != 4 or rb_seg.numel() != r128 + 1
        or tensors["tickets"].numel() != tickets_per_rb * r128 or tensors["scratch"].dim() != 2
        or tensors["scratch"].shape[1] != scratch_width
    ):
        raise ValueError(f"{name}: slot, chunk and segment arrays disagree with {rows} rows")
    if chunks >= 1 << 31 or seg.shape[0] >= 1 << 31:
        raise ValueError(f"{name}: the kernel indexes chunks and segments with int32")
    # the kernels copy slot rows in 16-byte pieces and read segments as int4
    _check_aligned(name, 16, **{k: tensors[k] for k in ("vals", "lane", "ends", "starts",
                                                         "segments", "scratch")
                                if k in tensors})
    ptr = {k: t.data_ptr() for k, t in tensors.items()}
    return dev, SegPlan(vals=ptr["vals"], lane=ptr["lane"], ends=ptr.get("ends"),
                        starts=ptr.get("starts"), col_off=ptr["col_off"],
                        segments=ptr["segments"], rb_seg=ptr["rb_seg"], scratch=ptr["scratch"],
                        tickets=ptr["tickets"], num_segments=seg.shape[0], cols=cols, rows=rows,
                        device=dev.index)


def _prepare_segmented(name, dtypes, *, cols, rows, **tensors) -> PreparedLaunch:
    """The launch record of a segmented SpMV plan (:func:`_seg_plan`, one
    128-float scratch row a slot and one ticket a row block)."""
    dev, args = _seg_plan(name, dtypes, cols=cols, rows=rows, **tensors)
    return PreparedLaunch(name, f"spmx_{name}", args, dev, x_len=cols, y_len=rows,
                          empty=args.num_segments == 0, keep=tuple(tensors.values()))


_SEG_DTYPES = dict(col_off=torch.int32, segments=torch.int32, rb_seg=torch.int32,
                   scratch=torch.float32, tickets=torch.int32)


def prepare_aligned(vals, lane, col_off, segments, rb_seg, scratch, tickets, *, cols: int,
                    rows: int) -> PreparedLaunch:
    """The aligned kernel's launch on one plan (vals f32 and lane int8
    ``(chunks, 128)``): ``launch(x, y)`` writes ``y = A @ x`` into every
    row of y, ``launch(x, y, add=True)`` adds it."""
    return _prepare_segmented("aligned", dict(vals=torch.float32, lane=torch.int8, **_SEG_DTYPES),
                              cols=cols, rows=rows, vals=vals, lane=lane, col_off=col_off,
                              segments=segments, rb_seg=rb_seg, scratch=scratch,
                              tickets=tickets)


def prepare_lanepack(vals, lane, ends, starts, col_off, segments, rb_seg, scratch, tickets, *,
                     cols: int, rows: int) -> PreparedLaunch:
    """The LanePack kernel's launch on one plan (vals f32, lane int16,
    ends/starts int8 ``(chunks, 128)``): as :func:`prepare_aligned`."""
    return _prepare_segmented(
        "lanepack",
        dict(vals=torch.float32, lane=torch.int16, ends=torch.int8, starts=torch.int8,
             **_SEG_DTYPES),
        cols=cols, rows=rows, vals=vals, lane=lane, ends=ends, starts=starts, col_off=col_off,
        segments=segments, rb_seg=rb_seg, scratch=scratch, tickets=tickets)


def _prepare_segmented_spmm(name, dtypes, *, cols, rows, **tensors) -> PreparedSpmm:
    """The launch record of a segmented SpMM plan (:func:`_seg_plan`, its
    scratch slots 16 128-float rows wide and 16 / 8 tickets a row block):
    one launch a 16 columns."""
    dev, args = _seg_plan(name, dtypes, cols=cols, rows=rows,
                          scratch_width=LANEPACK_SPMM_COLS * 128,
                          tickets_per_rb=LANEPACK_SPMM_GROUPS, **tensors)
    return PreparedSpmm(name, f"spmx_{name}", args, dev, rows=rows, cols=cols,
                        max_cols=LANEPACK_SPMM_COLS, empty=args.num_segments == 0,
                        keep=tuple(tensors.values()))


def prepare_lanepack_spmm(vals, lane, ends, starts, col_off, segments, rb_seg, scratch, tickets,
                          *, cols: int, rows: int) -> PreparedSpmm:
    """The LanePack SpMM kernel's launches on one LanePack plan and its
    segments (the arrays of :func:`prepare_lanepack`, with the SpMM's own
    ``scratch`` ``(slots, 16 * 128)`` f32 and ``tickets`` ``(2 * r128,)``
    int32 zeros): ``launch(x, y, packed=..., add=...)`` (see
    :class:`PreparedSpmm`), one launch a 16 columns."""
    return _prepare_segmented_spmm(
        "lanepack_spmm",
        dict(vals=torch.float32, lane=torch.int16, ends=torch.int8, starts=torch.int8,
             **_SEG_DTYPES),
        cols=cols, rows=rows, vals=vals, lane=lane, ends=ends, starts=starts, col_off=col_off,
        segments=segments, rb_seg=rb_seg, scratch=scratch, tickets=tickets)


def prepare_aligned_spmm(vals, lane, col_off, segments, rb_seg, scratch, tickets, *, cols: int,
                         rows: int) -> PreparedSpmm:
    """The aligned SpMM kernel's launches on one aligned plan and its
    segments (the arrays of :func:`prepare_aligned`, with the SpMM's own
    ``scratch`` and ``tickets``, as :func:`prepare_lanepack_spmm`):
    ``launch(x, y, packed=..., add=...)`` (see :class:`PreparedSpmm`)."""
    return _prepare_segmented_spmm(
        "aligned_spmm", dict(vals=torch.float32, lane=torch.int8, **_SEG_DTYPES),
        cols=cols, rows=rows, vals=vals, lane=lane, col_off=col_off, segments=segments,
        rb_seg=rb_seg, scratch=scratch, tickets=tickets)


def _bell_plan(name, vals, lane, ds, *, bias: int, rows: int, cols: int):
    """Check a BELL plan's planes and pack its C struct; returns ``(device,
    args)``."""
    dev = _check(name, dict(vals=_VALS, lane=(torch.int8, torch.int16), ds=torch.int32),
                 vals=vals, lane=lane, ds=ds)
    layers = ds.numel()
    if vals.dim() != 3 or vals.shape[0] != layers or vals.shape[2] != 128 \
            or lane.shape != vals.shape:
        raise ValueError(f"{name}: value/lane planes disagree with ds")
    r128 = vals.shape[1]
    if r128 * 128 < rows:
        raise ValueError(f"{name}: planes do not cover the rows")
    return dev, BellPlan(vals=vals.data_ptr(), lane=lane.data_ptr(), ds=ds.data_ptr(),
                         r128=r128, rows=rows, cols=cols, num_layers=layers, bias=bias,
                         lane_bytes=lane.element_size(),
                         values_bf16=int(vals.dtype == torch.bfloat16), device=dev.index)


def prepare_bell_spmm(vals, lane, ds, *, bias: int, rows: int, cols: int) -> PreparedSpmm:
    """The BELL SpMM kernel's launch on one plan (the planes of
    :func:`prepare_bell`): ``launch(x, y)`` writes ``Y = A @ X`` into
    every row of Y, X ``(cols, K)`` and Y ``(rows, K)`` row-major, 1 <= K
    <= 16; add mode and the packed layout are refused."""
    dev, args = _bell_plan("bell_spmm", vals, lane, ds, bias=bias, rows=rows, cols=cols)
    return PreparedSpmm("bell_spmm", "spmx_bell_spmm", args, dev, rows=rows, cols=cols,
                        max_cols=None, empty=rows == 0, keep=(vals, lane, ds))


def prepare_bell(vals, lane, ds, *, bias: int, rows: int, cols: int) -> PreparedLaunch:
    """The BELL kernel's launch on one plan (vals f32 or bf16 and lane int8
    or int16 ``(L, r128, 128)``, ds ``(L,)`` int32 bucket bases, lane
    positions stored as ``pos - bias``): ``launch(x, y)`` writes ``y = A @
    x`` into every row of y; ``launch(x, y, add=True)`` is refused (a BELL
    plan only writes y, its spill adds)."""
    dev, args = _bell_plan("bell", vals, lane, ds, bias=bias, rows=rows, cols=cols)
    return PreparedLaunch("bell", "spmx_bell", args, dev, x_len=cols, y_len=rows,
                          empty=rows == 0, keep=(vals, lane, ds))


def prepare_stripe(vals, lane, ends, starts, col_off, chunk_stripe, rb_mask, segments,
                   stripe_seg, scratch, tickets, *, levels: int, cols: int, rows: int,
                   foreign_pad: bool) -> PreparedLaunch:
    """The stripe kernel's launch on one plan and its segments
    (``ops.spmv.stripe_segments``): slab arrays ``vals`` f32 and ``lane``
    int8 or int16 ``(S * 8, 128)``, ``ends`` and, in scan mode, ``starts``
    int8 ``(S, L, 8, 128)`` (``starts=None``: select mode), ``col_off`` and
    ``chunk_stripe`` int32 ``(S * 8,)``, ``rb_mask`` f32, ``segments`` ``(N,
    4)`` and ``stripe_seg`` ``(stripes + 1,)`` int32, ``scratch`` ``(slots,
    L * 128)`` f32 and ``tickets`` ``(stripes * ceil(L / 8),)`` int32 zeros.
    ``launch(x, y)`` writes ``y = A @ x`` into every row of y,
    ``launch(x, y, add=True)`` adds it. The segment values are the
    host's, not read back here."""
    tensors = dict(vals=vals, lane=lane, ends=ends, col_off=col_off, chunk_stripe=chunk_stripe,
                   rb_mask=rb_mask, segments=segments, stripe_seg=stripe_seg, scratch=scratch,
                   tickets=tickets)
    if starts is not None:
        tensors["starts"] = starts
    dev = _check("stripe",
                 dict(vals=_F32, lane=(torch.int8, torch.int16), ends=torch.int8,
                      starts=torch.int8, col_off=torch.int32, chunk_stripe=torch.int32,
                      rb_mask=_F32, segments=torch.int32, stripe_seg=torch.int32,
                      scratch=_F32, tickets=torch.int32),
                 **tensors)
    if levels < 1:
        raise ValueError(f"stripe: {levels} levels")
    slabs = ends.shape[0] if ends.dim() == 4 else -1
    stripes = -(-rows // (levels * 128))
    groups = -(-levels // STRIPE_GROUP_LEVELS)
    if (
        ends.shape != (slabs, levels, 8, 128)
        or (starts is not None and starts.shape != ends.shape)
        or vals.shape != (slabs * 8, 128) or lane.shape != vals.shape
        or col_off.numel() < slabs * 8 or chunk_stripe.numel() < slabs * 8
        or rb_mask.numel() < stripes * levels
        or segments.dim() != 2 or segments.shape[1] != 4
        or stripe_seg.numel() != stripes + 1 or tickets.numel() != stripes * groups
        or scratch.dim() != 2 or scratch.shape[1] != levels * 128
    ):
        raise ValueError(f"stripe: slab, segment and scratch arrays disagree with {levels} "
                         f"levels and {rows} rows")
    if segments.shape[0] >= 1 << 31 or stripes * levels >= 1 << 31:
        raise ValueError("stripe: the kernel indexes segments and row blocks with int32")
    # the kernel copies slab rows, window bases and chunk stripes in 16-byte
    # pieces, reads segments as int4 and scratch as V floats
    _check_aligned("stripe", 16, **{k: tensors[k] for k in (
        "vals", "lane", "ends", "starts", "col_off", "chunk_stripe", "segments", "scratch")
        if k in tensors})
    ptr = {k: t.data_ptr() for k, t in tensors.items()}
    args = StripePlan(vals=ptr["vals"], lane=ptr["lane"], ends=ptr["ends"],
                      starts=ptr.get("starts"), col_off=ptr["col_off"],
                      chunk_stripe=ptr["chunk_stripe"], rb_mask=ptr["rb_mask"],
                      segments=ptr["segments"], stripe_seg=ptr["stripe_seg"],
                      scratch=ptr["scratch"], tickets=ptr["tickets"],
                      num_segments=segments.shape[0], cols=cols, rows=rows, levels=levels,
                      lane_bytes=lane.element_size(), foreign_pad=int(foreign_pad),
                      device=dev.index)
    return PreparedLaunch("stripe", "spmx_stripe", args, dev, x_len=cols, y_len=rows,
                          empty=segments.shape[0] == 0, keep=tuple(tensors.values()))


def _check(name: str, dtypes: dict, **tensors) -> torch.device:
    """All tensors contiguous, on one CUDA device, of the listed dtypes."""
    dev = None
    for key, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{name}: {key} is on {t.device}, the kernel needs CUDA")
        if dev is None:
            dev = t.device
        elif t.device != dev:
            raise ValueError(f"{name}: {key} is on {t.device}, expected {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        want = dtypes[key]
        if t.dtype not in (want if isinstance(want, tuple) else (want,)):
            raise TypeError(f"{name}: {key} has dtype {t.dtype}, expected {want}")
    return dev


def _check_aligned(name: str, align: int, **tensors) -> None:
    """Each tensor's data starts on an ``align``-byte boundary: the block
    kernels copy their operands in 16-byte pieces and store pairs of
    floats, which fault (and poison the CUDA context) off their
    alignment. A fresh allocation always is; a view at an offset may not
    be."""
    for key, t in tensors.items():
        if t.data_ptr() % align:
            raise ValueError(f"{name}: {key} must be {align}-byte aligned")


def prepare_dia(data, offsets, *, rows: int, cols: int) -> PreparedLaunch:
    """The DIA kernel's launch on one plan: band planes ``data`` ``(nb,
    rows)`` and their ``(nb,)`` int32 ``offsets``. f32 or bf16 planes take
    f32 x and y (``spmx_dia``), f64 planes f64 x and y (``spmx_dia_f64``,
    also counted as ``dia``). ``launch(x, y)`` writes ``y = A @ x`` into
    every row of y."""
    dev = _check("dia", dict(data=(*_VALS, torch.float64), offsets=torch.int32),
                 data=data, offsets=offsets)
    nb = offsets.numel()
    if data.shape != (nb, rows):
        raise ValueError("dia: shapes disagree with (nb, rows, cols)")
    if data.dtype == torch.float64:
        cname, vec, lead = "spmx_dia_f64", torch.float64, (dev.index, data.data_ptr())
    else:
        cname, vec = "spmx_dia", _F32
        lead = (dev.index, data.data_ptr(), int(data.dtype == torch.bfloat16))
    return PreparedLaunch("dia", cname, (*lead, offsets.data_ptr(), nb, rows, cols), dev,
                          x_len=cols, y_len=rows, empty=False, keep=(data, offsets), dtype=vec,
                          adds=False)


def prepare_csr(stripes, *, rows: int, ncols: int) -> PreparedLaunch:
    """The CSR-row kernel's launch on one plan (``ops.spmv_csr``):
    ``stripes``, the plan's column stripes in order, each a dict of its
    CSR, ``offsets`` (R + 1) int64, ``cols`` (nnz) int32 holding the
    uint32 column bits and ``vals`` (nnz) f32 of its R rows; ``coords``
    (tiles + 1, 2) and ``splits`` (S, 3) int64 from
    ``ops.spmv_csr.merge_path``; ``carry`` (tiles,) f32 scratch; and
    ``row_ids`` (R,) int32, y's row of each of its rows, None for stripe 0
    alone, whose R rows are y's. ``launch(x, y)`` writes ``y = A @ x`` into
    every row of y: stripe 0 stores its rows, each later stripe adds to
    its rows, in order on the stream; a call counts each stripe's
    launches, two where it has split rows and none where it has no
    entries. The path's values are the host's, not read back here."""
    types = dict(offsets=torch.int64, cols=torch.int32, vals=_F32, coords=torch.int64,
                 splits=torch.int64, carry=_F32, row_ids=torch.int32)
    dev, structs, keep, launches = None, [], [], 0
    for s, st in enumerate(stripes):
        row_ids = st["row_ids"]
        tensors = {k: st[k] for k in types if k != "row_ids" or row_ids is not None}
        d = _check("spmv_csr", types, **tensors)
        if dev is not None and d != dev:
            raise ValueError(f"spmv_csr: stripe {s} is on {d}, stripe 0 on {dev}")
        dev = d
        offsets, cols, coords, splits = st["offsets"], st["cols"], st["coords"], st["splits"]
        n = rows if s == 0 else (row_ids.numel() if row_ids is not None else -1)
        tiles = coords.shape[0] - 1 if coords.dim() == 2 else -1
        if ((s == 0) != (row_ids is None) or offsets.shape != (n + 1,) or cols.dim() != 1
                or st["vals"].shape != cols.shape or tiles < (1 if s == 0 else 0)
                or coords.shape[1] != 2 or splits.dim() != 2 or splits.shape[1] != 3
                or st["carry"].shape != (tiles,)):
            raise ValueError(f"spmv_csr: stripe {s}'s arrays disagree with a {rows} x {ncols} "
                             "plan")
        if tiles >= 1 << 31:
            raise ValueError("spmv_csr: the kernel launches a block a tile, at most 2**31 - 1")
        ptr = {k: (0 if t is None else t.data_ptr()) for k, t in st.items() if k in types}
        structs.append(CsrStripe(rows=n, tiles=tiles, num_splits=splits.shape[0], **ptr))
        keep += tensors.values()
        launches += (tiles > 0) * (1 + (splits.shape[0] > 0))
    if dev is None:
        raise ValueError("spmv_csr: a plan has at least one stripe")
    table = (CsrStripe * len(structs))(*structs)
    args = CsrPlan(stripes=ctypes.addressof(table), num_stripes=len(structs), rows=rows,
                   ncols=ncols, device=dev.index)
    return PreparedLaunch("spmv_csr", "spmx_csr", args, dev, x_len=ncols, y_len=rows,
                          empty=False, keep=(table, *keep), adds=False, launches=launches)


class PreparedDiaSpmm(_LaunchRecord):
    """The DIA SpMM kernel's launch on one plan, in the packed layout:
    ``launch(x3, y3)`` takes x3 ``(>= lo + ceil(cols / 128), K, 128)`` and
    y3 ``(>= lo + ceil(rows / 128), K, 128)`` (``lo`` guard row blocks
    first), contiguous f32 CUDA tensors on the plan's device, 1 <= K <=
    16, and writes every element of y3 with one ctypes call of ``(args, K,
    x3, lo, y3, lo, y3's row blocks, stream)``."""

    __slots__ = ("rows", "cols", "lo")

    def __init__(self, args: tuple, device: torch.device, *, rows: int, cols: int, lo: int,
                 keep: tuple):
        super().__init__("dia_spmm", "spmx_dia_spmm", args, device, empty=False, keep=keep)
        self.rows, self.cols, self.lo = rows, cols, lo

    def __call__(self, x3: torch.Tensor, y3: torch.Tensor) -> None:
        px, py = self._ptr("x3", x3), self._ptr("y3", y3)
        k = x3.shape[1] if x3.dim() == 3 else 0
        if (
            x3.dim() != 3 or y3.dim() != 3 or not 1 <= k <= 16 or x3.shape[2] != 128
            or y3.shape[1:] != (k, 128) or (x3.shape[0] - self.lo) * 128 < self.cols
            or (y3.shape[0] - self.lo) * 128 < self.rows
        ):
            raise ValueError("dia_spmm: shapes disagree with (nb, rows, cols, K)")
        self._enqueue(k, px, self.lo, py, self.lo, y3.shape[0])


def prepare_dia_spmm(data, offsets, *, rows: int, cols: int, lo: int) -> PreparedDiaSpmm:
    """The DIA SpMM kernel's launch on one plan (f32 or bf16 ``data``
    ``(nb, rows)`` and int32 ``offsets``; the kernel has no f64 form) with
    ``lo`` guard row blocks before x3's and y3's bodies: ``launch(x3,
    y3)`` (see :class:`PreparedDiaSpmm`)."""
    dev = _check("dia_spmm", dict(data=_VALS, offsets=torch.int32), data=data, offsets=offsets)
    nb = offsets.numel()
    if data.shape != (nb, rows):
        raise ValueError("dia_spmm: shapes disagree with (nb, rows, cols, K)")
    args = (dev.index, data.data_ptr(), int(data.dtype == torch.bfloat16), offsets.data_ptr(),
            nb, rows, cols)
    return PreparedDiaSpmm(args, dev, rows=rows, cols=cols, lo=lo, keep=(data, offsets))


def _check_bs(name: str, bs: int) -> None:
    if bs % 16 or not 16 <= bs <= 128:
        raise ValueError(f"{name}: block size {bs} must be a multiple of 16 in [16, 128]")


def _check_stream(name: str, stream, offsets, segments: int) -> int:
    """A live-depth stream: ``(L, 2)`` int32 row pairs, 8-byte aligned
    (the kernel reads one pair as one int2), ``L < 2^31``, and
    ``segments + 1`` int32 offsets. Returns L. The offsets' values are the
    plan's (checked there, not here: that would read the device)."""
    if stream.dim() != 2 or stream.shape[1] != 2:
        raise ValueError(f"{name}: the depth stream must be (L, 2) row pairs")
    _check_aligned(name, 8, stream=stream)
    if stream.shape[0] >= 1 << 31:
        raise ValueError(f"{name}: {stream.shape[0]} stream rows; the kernel takes < 2^31")
    if offsets.dim() != 1 or offsets.numel() != segments + 1:
        raise ValueError(f"{name}: the stream offsets must be ({segments + 1},)")
    return int(stream.shape[0])


class PreparedBcsr(_LaunchRecord):
    """The BCSR SpMM kernel's launch on one plan: ``launch(x_sum, x, y)``
    writes ``y = BCSR @ x`` into every element of y (block rows with no
    block get zeros), x ``(bcols * bs, F)`` 16-byte aligned and y ``(brows
    * bs, F)`` 8-byte aligned, F a multiple of 128, contiguous f32 CUDA
    tensors on the plan's device. The kernel walks the plan's live-depth
    stream when the one-element f32 device tensor ``x_sum``, the sum of x
    (``x.sum()``), is finite, else every column of every block; one ctypes
    call of ``(args, x_sum, brows, bs, F, x, y, stream)``. A plan of no
    block rows, or an x of no columns, launches nothing."""

    __slots__ = ("brows", "bs")

    def __init__(self, args: tuple, device: torch.device, *, brows: int, bs: int, keep: tuple):
        super().__init__("bcsr_spmm", "spmx_bcsr_spmm", args, device, empty=brows == 0,
                         keep=keep)
        self.brows, self.bs = brows, bs

    def __call__(self, x_sum: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> None:
        bs = self.bs
        ps, px = self._ptr("x_sum", x_sum), self._ptr("x", x, align=16)
        py = self._ptr("y", y, align=8)
        f = x.shape[1] if x.dim() == 2 else 0
        if f % 128 or x.shape[0] % bs or y.shape != (self.brows * bs, f) or x_sum.numel() != 1:
            raise ValueError("bcsr_spmm: shapes disagree with (nnzb, bs, brows, F)")
        if x.shape[0] >= 1 << 31:
            raise ValueError("bcsr_spmm: the kernel indexes block and x rows with int32")
        if not self._empty and f:
            self._enqueue(ps, self.brows, bs, f, px, py)


def prepare_bcsr_spmm(blocks_t, block_cols, block_offsets, stream, stream_offsets) -> PreparedBcsr:
    """The BCSR SpMM kernel's launch on one plan: the blocks held
    transposed (``blocks_t[p] = blocks[p]^T``, f32 ``(nnzb, bs, bs)``,
    16-byte aligned), ``block_cols`` and ``block_offsets`` (int32), and
    ``stream``/``stream_offsets``, the A-side live-depth stream
    (``ops.spmm.bcsr_depth_stream``, one segment per block row and 64-row
    tile). ``launch(x_sum, x, y)`` (see :class:`PreparedBcsr`)."""
    dev = _check("bcsr_spmm",
                 dict(blocks_t=_F32, block_cols=torch.int32, block_offsets=torch.int32,
                      stream=torch.int32, stream_offsets=torch.int32),
                 blocks_t=blocks_t, block_cols=block_cols, block_offsets=block_offsets,
                 stream=stream, stream_offsets=stream_offsets)
    _check_aligned("bcsr_spmm", 16, blocks_t=blocks_t)
    if blocks_t.dim() != 3 or blocks_t.shape[1] != blocks_t.shape[2]:
        raise ValueError("bcsr_spmm: blocks must be (nnzb, bs, bs)")
    bs = blocks_t.shape[1]
    _check_bs("bcsr_spmm", bs)
    brows = block_offsets.numel() - 1
    if block_cols.numel() != blocks_t.shape[0] or brows < 0:
        raise ValueError("bcsr_spmm: shapes disagree with (nnzb, bs, brows, F)")
    if blocks_t.shape[0] * bs >= 1 << 31:
        raise ValueError("bcsr_spmm: the kernel indexes block and x rows with int32")
    length = _check_stream("bcsr_spmm", stream, stream_offsets, brows * -(-bs // BLOCK_TILE))
    args = (dev.index, blocks_t.data_ptr(), block_cols.data_ptr(), block_offsets.data_ptr(),
            stream.data_ptr(), length, stream_offsets.data_ptr())
    return PreparedBcsr(args, dev, brows=brows, bs=bs,
                        keep=(blocks_t, block_cols, block_offsets, stream, stream_offsets))


class PreparedBlockSpgemm(_LaunchRecord):
    """The block SpGEMM kernel's launch on one plan: ``launch(c)`` writes
    every block of c, a contiguous f32 CUDA tensor ``(num_c, bs, bs)`` on
    the plan's device, 8-byte aligned, with one ctypes call of ``(args, c,
    stream)``. A plan of no C block launches nothing."""

    __slots__ = ("shape",)

    def __init__(self, args: tuple, device: torch.device, *, shape: tuple, keep: tuple):
        super().__init__("block_spgemm", "spmx_block_spgemm", args, device,
                         empty=shape[0] == 0, keep=keep)
        self.shape = shape

    def __call__(self, c: torch.Tensor) -> None:
        pc = self._ptr("c", c, align=8)
        if c.shape != self.shape:
            raise ValueError("block_spgemm: shapes disagree with (num_c, bs)")
        if not self._empty:
            self._enqueue(pc)


def prepare_block_spgemm(a_blocks_t, b_blocks, stream, offsets, *,
                         num_c: int) -> PreparedBlockSpgemm:
    """The block SpGEMM kernel's launch on one plan of ``num_c`` C blocks:
    tile (tm, tn) of ``c[q]`` is the sum over ``e in [offsets[s],
    offsets[s+1])``, ``s = (q * tiles + tm) * tiles + tn``, of ``outer(
    a_blocks_t row stream[e, 0], b_blocks row stream[e, 1])`` on the tile,
    in stream order (rows of the ``(n * bs, bs)`` views; 64 x 64 tiles,
    ``tiles = ceil(bs / 64)``): the block products over the live-depth
    stream of ``ops.spgemm_block.block_depth_stream``, A held transposed
    (``a_blocks_t[i] = A_blocks[i]^T``). Blocks f32 or bf16 (one type for
    both, 16-byte aligned). ``launch(c)`` (see
    :class:`PreparedBlockSpgemm`)."""
    dev = _check("block_spgemm",
                 dict(a_blocks_t=_VALS, b_blocks=_VALS, stream=torch.int32, offsets=torch.int32),
                 a_blocks_t=a_blocks_t, b_blocks=b_blocks, stream=stream, offsets=offsets)
    _check_aligned("block_spgemm", 16, a_blocks_t=a_blocks_t, b_blocks=b_blocks)
    if a_blocks_t.dtype != b_blocks.dtype:
        raise TypeError("block_spgemm: A and B blocks must share one dtype")
    if a_blocks_t.dim() != 3 or a_blocks_t.shape[1] != a_blocks_t.shape[2]:
        raise ValueError("block_spgemm: blocks must be (n, bs, bs)")
    bs = a_blocks_t.shape[1]
    _check_bs("block_spgemm", bs)
    if b_blocks.dim() != 3 or b_blocks.shape[1:] != (bs, bs) or num_c < 0:
        raise ValueError("block_spgemm: shapes disagree with (num_c, bs)")
    if max(a_blocks_t.shape[0], b_blocks.shape[0]) * bs >= 1 << 31:
        raise ValueError("block_spgemm: the kernel indexes block rows with int32")
    length = _check_stream("block_spgemm", stream, offsets, num_c * (-(-bs // BLOCK_TILE)) ** 2)
    args = (dev.index, a_blocks_t.data_ptr(), b_blocks.data_ptr(),
            int(a_blocks_t.dtype == torch.bfloat16), stream.data_ptr(), length,
            offsets.data_ptr(), num_c, bs)
    return PreparedBlockSpgemm(args, dev, shape=(num_c, bs, bs),
                               keep=(a_blocks_t, b_blocks, stream, offsets))


class PreparedTrisweep(_LaunchRecord):
    """The fused triangular sweeps on one checked plan: ``launch(b, dinv,
    y, sweeps)`` checks b, dinv and y (contiguous f32 CUDA vectors of the
    plan's rows on its device, y distinct from b and dinv) and ``0 <=
    sweeps <= levels`` where a chunk publishes rows (more chunks than one
    and a reach), and enqueues the kernel with one ctypes call of ``(args,
    b, dinv, sweeps, y, stream)``; it writes every row of y. The plan's
    scratch, flags and state are the caller's (one launch at a time)."""

    __slots__ = ("rows", "levels", "publishes")

    def __init__(self, args: TrisweepPlan, device: torch.device, *, levels: int, keep: tuple):
        super().__init__("trisweep", "spmx_trisweep", args, device, empty=args.rows == 0,
                         keep=keep)
        self.rows, self.levels = int(args.rows), levels
        self.publishes = args.chunks > 1 and args.tail > 0

    def __call__(self, b: torch.Tensor, dinv: torch.Tensor, y: torch.Tensor, sweeps: int) -> None:
        pb, pd, py = (self._ptr(w, t, self.rows) for w, t in (("b", b), ("dinv", dinv), ("y", y)))
        if py in (pb, pd):
            raise ValueError("trisweep: y must not alias b or dinv")
        if not 0 <= sweeps < 2 ** 31 or (self.publishes and sweeps > self.levels):
            raise ValueError(f"trisweep: sweeps {sweeps} outside [0, {self.levels}], the levels "
                             "the plan's scratch holds")
        if not self._empty:
            self._enqueue(pb, pd, int(sweeps), py)


#: the shared memory one block of the trisweep kernel may take (227 KB, the
#: H100's limit a block, less its static variables)
TRISWEEP_MAX_SMEM = 227 * 1024 - 64


def prepare_trisweep(data, offsets_t, scratch, flags, state, *, offsets: tuple, rows: int,
                     chunk_rows: int, levels: int, halo: int) -> PreparedTrisweep:
    """The trisweep kernel's launch on one plan: ``data`` ``(nb, rows)`` f32
    band planes of the strict part N, ``offsets_t`` its ``(nb,)`` int32
    offsets on the card and ``offsets`` the same on the host, all negative
    or all positive; chunks of ``chunk_rows`` rows, a power of two in [32,
    65536]; ``halo`` the reach (the kernel stages a chunk's neighbour rows
    in shared memory) or 0 (it reads them from L2); the block's shared
    memory (``(nb + 4) * chunk_rows + halo`` floats and the offsets) must
    fit; ``scratch`` ``(chunks * levels * tail,)`` f32, ``flags`` ``(chunks
    * levels,)`` int32 zeros and ``state`` ``(2,)`` int32 zeros, ``tail =
    min(max |offset|, chunk_rows)``: the rows each chunk publishes for
    levels below ``levels``, their flags, and the kernel's ticket and
    launch epoch. ``launch(b, dinv, y, sweeps)`` (see
    :class:`PreparedTrisweep`)."""
    dev = _check("trisweep", dict(data=_F32, offsets_t=torch.int32, scratch=_F32,
                                  flags=torch.int32, state=torch.int32),
                 data=data, offsets_t=offsets_t, scratch=scratch, flags=flags, state=state)
    nb = len(offsets)
    if offsets_t.numel() != nb or data.shape != (nb, rows):
        raise ValueError("trisweep: data must be (len(offsets), rows), one offset a plane")
    if not (all(o < 0 for o in offsets) or all(o > 0 for o in offsets)):
        raise ValueError(f"trisweep: offsets {offsets} are not all of one sign (a strictly "
                         "triangular N)")
    t = int(chunk_rows)
    if t < 32 or t > 1 << 16 or t & (t - 1):
        raise ValueError(f"trisweep: chunk_rows {t} must be a power of two in [32, 65536]")
    reach = max((abs(int(o)) for o in offsets), default=0)
    if halo not in (0, reach):
        raise ValueError(f"trisweep: halo {halo} must be 0 or the reach {reach}")
    if (nb + 4) * t * 4 + -(-nb // 4) * 16 + halo * 4 > TRISWEEP_MAX_SMEM:
        raise ValueError(f"trisweep: {nb} bands at {t} rows a chunk and {halo} staged rows "
                         "take more shared memory than a block has")
    chunks = -(-rows // t)
    tail = min(reach, t)
    if chunks >= 1 << 31 or not 0 <= levels < 1 << 31:
        raise ValueError("trisweep: the kernel numbers chunks and levels with int32")
    if (scratch.numel() != chunks * levels * tail or flags.numel() != chunks * levels
            or state.numel() != 2):
        raise ValueError(f"trisweep: scratch, flags and state must hold {chunks} chunks x "
                         f"{levels} levels x {tail} rows, {chunks} x {levels} flags and 2 words")
    args = TrisweepPlan(data=data.data_ptr(), offsets=offsets_t.data_ptr(),
                        scratch=scratch.data_ptr(), flags=flags.data_ptr(),
                        state=state.data_ptr(), rows=rows, chunks=chunks, reach=reach, nb=nb,
                        chunk_rows=t, chunk_shift=t.bit_length() - 1, tail=tail, levels=levels,
                        upper=int(nb > 0 and offsets[0] > 0), halo=halo, device=dev.index)
    return PreparedTrisweep(args, dev, levels=levels,
                            keep=(data, offsets_t, scratch, flags, state))


class PreparedExpand(_LaunchRecord):
    """The ESC expansion kernel on one checked plan: ``launch(lv, rv, p,
    csr_order=False)`` checks lv (the ``n_lv`` lhs values, CSC-permuted,
    or in CSR order with ``csr_order``, read through the plan's ``perm``),
    rv (the ``n_rv`` rhs values in CSR order) and p (``num_slots``, distinct
    from both, 16-byte aligned), all contiguous f32 CUDA vectors on the
    plan's device, and
    enqueues the kernel with one ctypes call of ``(args, lv, rv, csr_order,
    p, stream)``; it writes every slot of p."""

    __slots__ = ("n_lv", "n_rv", "num_slots", "num_products")

    def __init__(self, args: EscPlan, device: torch.device, *, n_lv: int, n_rv: int,
                 keep: tuple):
        super().__init__("esc_expand", "spmx_esc_expand", args, device,
                         empty=args.num_slots == 0, keep=keep)
        self.n_lv, self.n_rv = n_lv, n_rv
        self.num_slots, self.num_products = int(args.num_slots), int(args.num_products)

    def __call__(self, lv: torch.Tensor, rv: torch.Tensor, p: torch.Tensor,
                 csr_order: bool = False) -> None:
        pl, pr = self._ptr("lv", lv, self.n_lv), self._ptr("rv", rv, self.n_rv)
        pp = self._ptr("p", p, self.num_slots, 16)
        if pp in (pl, pr):
            raise ValueError("esc_expand: p must not alias lv or rv")
        if not self._empty:
            self._enqueue(pl, pr, int(bool(csr_order)), pp)


def prepare_esc_expand(segments, tiles, perm, *, num_products: int, num_slots: int,
                       n_lv: int, n_rv: int) -> PreparedExpand:
    """The ESC expansion kernel's launch on one plan's segment descriptors
    (``ops.esc_expand.expand_segment_arrays``): ``segments`` ``(G + 1, 4)``
    int32 rows (first slot, lk, la, ra) and a sentinel row, ``tiles``
    ``(ceil(num_slots / ESC_TILE), 8)`` int32 rows (first segment, lhs and
    rhs windows, last segment), ``perm`` ``(n_lv,)`` int32, the lhs CSC-to-CSR value
    permutation; ``num_slots <= 2^30``. ``launch(lv, rv, p,
    csr_order=False)`` (see :class:`PreparedExpand`). The descriptors'
    values are the host's, not read back here."""
    dev = _check("esc_expand", dict(segments=torch.int32, tiles=torch.int32, perm=torch.int32),
                 segments=segments, tiles=tiles, perm=perm)
    num_tiles = -(-num_slots // ESC_TILE)
    if (segments.dim() != 2 or segments.shape[1] != 4 or segments.shape[0] < 1
            or tiles.shape != (num_tiles, 8) or perm.numel() != n_lv
            or not 0 <= num_products <= num_slots or num_slots % 8):
        raise ValueError(f"esc_expand: segment, tile and permutation arrays disagree with "
                         f"{num_products} products in {num_slots} slots")
    if num_slots > 1 << 30 or max(n_lv, n_rv, segments.shape[0]) >= 1 << 31:
        raise ValueError(f"esc_expand: {num_slots} slots; the kernel numbers at most 2^30 slots "
                         "and indexes segments and values with int32")
    # the kernel reads segment and tile rows as int4
    _check_aligned("esc_expand", 16, segments=segments, tiles=tiles)
    args = EscPlan(segments=segments.data_ptr(), tiles=tiles.data_ptr(), perm=perm.data_ptr(),
                   num_segments=segments.shape[0] - 1, num_tiles=num_tiles,
                   num_products=num_products, num_slots=num_slots, device=dev.index)
    return PreparedExpand(args, dev, n_lv=n_lv, n_rv=n_rv, keep=(segments, tiles, perm))


class PreparedRunSum(_LaunchRecord):
    """The run sums of a sort reduction planned once: ``launch(p, val)``
    checks p (the ``cap`` products in plan order) and val (``cap``,
    distinct from p), contiguous f32 CUDA vectors on the plan's device,
    and enqueues the kernel with one ctypes call of ``(args, p, val,
    stream)``; it writes every element of val."""

    __slots__ = ("cap",)

    def __init__(self, args: RunSumPlan, device: torch.device, *, keep: tuple):
        super().__init__("esc_run_sum", "spmx_esc_run_sum", args, device, empty=args.cap == 0,
                         keep=keep)
        self.cap = int(args.cap)

    def __call__(self, p: torch.Tensor, val: torch.Tensor) -> None:
        pp, pv = self._ptr("p", p, self.cap), self._ptr("val", val, self.cap)
        if pp == pv:
            raise ValueError("esc_run_sum: val must not alias p")
        if not self._empty:
            self._enqueue(pp, pv)


def prepare_esc_run_sum(order, run_off, *, num_summed: int) -> PreparedRunSum:
    """The run-sum kernel's launch on one planned sort reduction: ``order``
    ``(cap,)`` int32, the plan slot of each sorted position; ``run_off``
    ``(runs + 1,)`` int32 run bounds in sorted positions (the host's,
    not read back here); the first ``num_summed`` runs are summed, the rest
    of val written 0. ``launch(p, val)`` (see :class:`PreparedRunSum`)."""
    dev = _check("esc_run_sum", dict(order=torch.int32, run_off=torch.int32),
                 order=order, run_off=run_off)
    cap = order.numel()
    if order.dim() != 1 or run_off.dim() != 1 or not 0 <= num_summed < run_off.numel():
        raise ValueError(f"esc_run_sum: {num_summed} runs summed of {run_off.numel() - 1}")
    if cap > 1 << 30:
        raise ValueError(f"esc_run_sum: {cap} sorted positions; the kernel indexes at most 2^30 "
                         "with int32")
    args = RunSumPlan(order=order.data_ptr(), run_off=run_off.data_ptr(), num_summed=num_summed,
                      cap=cap, device=dev.index)
    return PreparedRunSum(args, dev, keep=(order, run_off))


class PreparedSymgs(_LaunchRecord):
    """One symmetric Gauss-Seidel step on one checked plan: ``launch(r,
    x)`` checks r and x (contiguous CUDA vectors of the plan's rows and
    value type on its device, x distinct from r) and enqueues the step, all
    its colour passes, as one launch with one ctypes call of ``(args, r, x,
    stream)``. x is updated in place, and so is the plan's ``state`` (the
    step's ticket, epoch and pass counts): a step in flight on one plan is
    one caller's. ``by_pass(r, x)``: the same step as one launch a colour
    pass (``passes`` of them, each counted), the yardstick that gives the
    step's bits."""

    __slots__ = ("n", "passes", "_by_pass")

    def __init__(self, args: SymgsPlan, device: torch.device, *, dtype, passes: int,
                 keep: tuple):
        super().__init__("symgs", "spmx_symgs", args, device, empty=passes == 0, keep=keep,
                         dtype=dtype)
        self.n, self.passes = int(args.n), passes
        self._by_pass = _LaunchRecord("symgs", "spmx_symgs_by_pass", args, device,
                                      empty=passes == 0, keep=keep, dtype=dtype)

    def _operands(self, r: torch.Tensor, x: torch.Tensor) -> tuple:
        pr, px = self._ptr("r", r, self.n), self._ptr("x", x, self.n)
        if px == pr:
            raise ValueError("symgs: x must not alias r")
        return pr, px

    def __call__(self, r: torch.Tensor, x: torch.Tensor) -> None:
        pr, px = self._operands(r, x)
        if not self._empty:
            self._enqueue(pr, px)

    def by_pass(self, r: torch.Tensor, x: torch.Tensor) -> None:
        pr, px = self._operands(r, x)
        if not self._empty:
            self._by_pass._enqueue(pr, px, launches=self.passes)


def prepare_symgs(data, rows, offsets_t, *, color_start: tuple, diag: int) -> PreparedSymgs:
    """The SymGS kernel's launch on one plan: ``data`` ``(nb, n)`` band
    planes re-laid by colour (f64 or f32), ``rows`` ``(n,)`` int32 the
    natural row of each column of ``data``, ``offsets_t`` ``(nb,)`` int32
    band offsets, band ``diag`` the main diagonal, and ``color_start`` the
    host's ``colors + 1`` bounds of each colour's columns (at most
    ``SYMGS_MAX_COLORS`` colours). The plan's values (the colouring, the
    diagonal) are the host's, checked there, not read back here. The
    record holds the kernel's ``state`` (the ticket, the epoch and a count
    a colour pass, zeros here); the kernel's library sets the rows of a
    work item from the colours and the grid from the card's occupancy (one
    query here). ``launch(r, x)`` (see :class:`PreparedSymgs`)."""
    dev = _check("symgs", dict(data=(torch.float64, _F32), rows=torch.int32,
                               offsets_t=torch.int32),
                 data=data, rows=rows, offsets_t=offsets_t)
    nb, n = (int(d) for d in data.shape) if data.dim() == 2 else (-1, -1)
    colors = len(color_start) - 1
    if (data.dim() != 2 or rows.numel() != n or offsets_t.numel() != nb
            or not 0 <= diag < nb or color_start[0] != 0 or color_start[-1] != n
            or any(b < a for a, b in zip(color_start, color_start[1:]))):
        raise ValueError("symgs: planes, rows, offsets and colour bounds disagree")
    if not 1 <= colors <= SYMGS_MAX_COLORS or n >= 1 << 31:
        raise ValueError(f"symgs: {colors} colours and {n} rows; the kernel takes 1 to "
                         f"{SYMGS_MAX_COLORS} colours and indexes rows with int32")
    state = torch.zeros(2 + 2 * colors, dtype=torch.int32, device=dev)
    starts = (ctypes.c_int64 * (SYMGS_MAX_COLORS + 1))(*color_start)
    args = SymgsPlan(data=data.data_ptr(), rows=rows.data_ptr(), offsets=offsets_t.data_ptr(),
                     state=state.data_ptr(), color_start=starts, n=n, nb=nb, diag=diag,
                     colors=colors, values_f64=int(data.dtype == torch.float64),
                     device=dev.index)
    passes = 2 * sum(1 for a, b in zip(color_start, color_start[1:]) if b > a)
    if passes:
        lib = _library()
        err = lib.spmx_symgs_prepare(ctypes.addressof(args))
        if err != 0:
            raise RuntimeError(f"symgs: CUDA error {err} "
                               f"({lib.spmx_cuda_error_string(err).decode()})")
    return PreparedSymgs(args, dev, dtype=data.dtype, passes=passes,
                         keep=(data, rows, offsets_t, state))


class PreparedBfs:
    """The BFS kernels (``csrc/bfs.cu``) on one checked plan, a method a
    step of ``graph/bfs.py``, each one ctypes call that enqueues its
    launches and counts them: ``start(parents, source)``,
    ``top_down(parents, cur, q)`` and ``end(parents)`` under
    ``launch_counts["bfs_top_down"]`` (one, two and one launches),
    ``enter_bitmap(cur, q, flip)``,
    ``bottom_up(parents, flip)`` and ``leave_bitmap(flip, cur)`` under
    ``["bfs_bottom_up"]`` (one each). ``parents`` is checked at each call
    (a contiguous int32 CUDA vector of the plan's ``n`` vertices on its
    device); the step's counts land in the plan's ``counts``. The plan's
    state is updated in place: a search in flight on one plan is one
    caller's."""

    __slots__ = ("n", "_start", "_top_down", "_enter", "_bottom_up", "_leave", "_end")

    def __init__(self, args: BfsPlan, device: torch.device, *, keep: tuple):
        def record(name, cname):
            return _LaunchRecord(name, cname, args, device, empty=False, keep=keep,
                                 dtype=torch.int32)

        self.n = int(args.n)
        self._start = record("bfs_top_down", "spmx_bfs_start")
        self._top_down = record("bfs_top_down", "spmx_bfs_top_down")
        self._enter = record("bfs_bottom_up", "spmx_bfs_enter_bitmap")
        self._bottom_up = record("bfs_bottom_up", "spmx_bfs_bottom_up")
        self._leave = record("bfs_bottom_up", "spmx_bfs_leave_bitmap")
        self._end = record("bfs_top_down", "spmx_bfs_end")

    def start(self, parents: torch.Tensor, source: int) -> None:
        if not 0 <= source < self.n:
            raise ValueError(f"bfs: source {source} outside [0, {self.n})")
        self._start._enqueue(self._start._ptr("parents", parents, self.n), int(source))

    def top_down(self, parents: torch.Tensor, cur: int, q: int) -> None:
        if not 1 <= q <= self.n:
            raise ValueError(f"bfs: a frontier of {q} vertices")
        self._top_down._enqueue(self._top_down._ptr("parents", parents, self.n), int(cur) & 1,
                                int(q), launches=2)

    def enter_bitmap(self, cur: int, q: int, flip: int) -> None:
        if not 1 <= q <= self.n:
            raise ValueError(f"bfs: a frontier of {q} vertices")
        self._enter._enqueue(int(cur) & 1, int(q), int(flip) & 1)

    def bottom_up(self, parents: torch.Tensor, flip: int) -> None:
        self._bottom_up._enqueue(self._bottom_up._ptr("parents", parents, self.n),
                                 int(flip) & 1)

    def leave_bitmap(self, flip: int, cur: int) -> None:
        self._leave._enqueue(int(flip) & 1, int(cur) & 1)

    def end(self, parents: torch.Tensor) -> None:
        self._end._enqueue(self._end._ptr("parents", parents, self.n))


def prepare_bfs(offsets, cols, has_edges, unvisited, bits, queues, prefix,
                counts) -> PreparedBfs:
    """The BFS kernels' launches on one plan (``graph.bfs.BfsPlan``): the
    graph's ``offsets`` (n + 1) int64 and ``cols`` (nnz) int32 holding the
    uint32 column bits, sorted within each row (not read back here);
    ``has_edges`` (words) int32, the bitmap of the vertices of degree > 0;
    the state: ``unvisited`` (words) int32, ``bits`` (2, words) int32,
    ``queues`` (2, n) int32, ``prefix`` (n) int64 and ``counts`` (2) int64,
    where words = ceil(n / 32). The grid is the blocks the card holds at
    once (one query here). See :class:`PreparedBfs`."""
    tensors = dict(offsets=offsets, cols=cols, has_edges=has_edges, unvisited=unvisited,
                   bits=bits, queues=queues, prefix=prefix, counts=counts)
    i32, i64 = torch.int32, torch.int64
    dev = _check("bfs", dict(offsets=i64, cols=i32, has_edges=i32, unvisited=i32, bits=i32,
                             queues=i32, prefix=i64, counts=i64), **tensors)
    n = offsets.numel() - 1
    words = -(-n // 32)
    if (n < 1 or n >= 1 << 31 or cols.dim() != 1 or has_edges.shape != (words,)
            or unvisited.shape != (words,) or bits.shape != (2, words)
            or queues.shape != (2, n) or prefix.shape != (n,)
            or counts.shape != (2,)):
        raise ValueError(f"bfs: the state disagrees with a graph of {n} vertices (1 to 2**31 - 1, "
                         "int32 ids)")
    args = BfsPlan(offsets=offsets.data_ptr(), cols=cols.data_ptr(),
                   has_edges=has_edges.data_ptr(), unvisited=unvisited.data_ptr(),
                   bits0=bits[0].data_ptr(), bits1=bits[1].data_ptr(),
                   queue0=queues[0].data_ptr(), queue1=queues[1].data_ptr(),
                   prefix=prefix.data_ptr(), counts=counts.data_ptr(), n=n,
                   words=words, grid=0, device=dev.index)
    lib = _library()
    err = lib.spmx_bfs_prepare(ctypes.addressof(args))
    if err != 0:
        raise RuntimeError(f"bfs: CUDA error {err} ({lib.spmx_cuda_error_string(err).decode()})")
    return PreparedBfs(args, dev, keep=tuple(tensors.values()))


class KrylovScratch:
    """The fused Krylov kernels (``csrc/krylov_update.cu``) with one solve's
    scratch, for contiguous CUDA n-vectors of ``like``'s device and dtype
    (f32 or f64): the grid's partial sums and the self-resetting ticket of
    its reductions, and ``slots``, ``KRYLOV_SLOTS`` 0-d device scalars that
    the kernels write (each a view of one buffer, carrying this scratch as
    ``krylov_scratch``, so that a step can find it from its scalar).

    ``dot(u, v, slot)``, ``cg_update(x, r, p, ap, num, den, slot)`` and
    ``p_update(p, z, num, den)`` each enqueue one kernel on the current
    stream and count it (``krylov_dot``, ``cg_update``, ``p_update``); the
    first two return ``slots[slot]``. ``num`` and ``den`` are 0-d scalars
    of the dtype on the device, which the kernels read there. x, r and p
    are updated in place. One call at a time: calls share the scratch."""

    __slots__ = ("device", "dtype", "n", "slots", "_idx", "_keep", "_args", "_dot", "_cg",
                 "_p")

    def __init__(self, like: torch.Tensor):
        dtype, n = like.dtype, like.numel()
        if not like.is_cuda:
            raise ValueError(f"krylov: vectors on {like.device}, the kernels need CUDA")
        if dtype not in (_F32, torch.float64):
            raise TypeError(f"krylov: dtype {dtype}, the kernels take float32 and float64")
        self.device, self.dtype, self.n = like.device, dtype, n
        self._idx = like.get_device()
        lib = _library()
        f64 = int(dtype == torch.float64)
        blocks = ctypes.c_int32(0)
        err = lib.spmx_krylov_blocks(self._idx, f64, n, ctypes.byref(blocks))
        if err != 0:
            raise RuntimeError(f"krylov: CUDA error {err} "
                               f"({lib.spmx_cuda_error_string(err).decode()})")
        partials = torch.empty(blocks.value, dtype=dtype, device=self.device)
        ticket = torch.zeros(1, dtype=torch.int32, device=self.device)
        scalars = torch.empty(KRYLOV_SLOTS, dtype=dtype, device=self.device)
        self.slots = tuple(scalars[i] for i in range(KRYLOV_SLOTS))
        for s in self.slots:
            s.krylov_scratch = self
        self._keep = (partials, ticket, scalars)
        self._args = KrylovPlan(partials=partials.data_ptr(), ticket=ticket.data_ptr(), n=n,
                                blocks=blocks.value, values_f64=f64, device=self._idx)
        self._dot, self._cg, self._p = (
            _LaunchRecord(name, f"spmx_{name}", self._args, self.device, empty=False,
                          keep=self._keep, dtype=dtype)
            for name in ("krylov_dot", "cg_update", "p_update"))

    @property
    def blocks(self) -> int:
        return int(self._args.blocks)

    def fits(self, v: torch.Tensor) -> bool:
        """Whether ``v`` is a vector of this scratch's device, dtype and size."""
        return v.is_cuda and v.get_device() == self._idx and v.dtype is self.dtype \
            and v.numel() == self.n

    def _vec(self, what: str, t: torch.Tensor) -> int:
        if not (self.fits(t) and t.is_contiguous()):
            raise ValueError(f"krylov: {what} must be a contiguous {self.dtype} vector of "
                             f"{self.n} elements on {self.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
        return t.data_ptr()

    def _scalar(self, what: str, t: torch.Tensor) -> int:
        if not (t.is_cuda and t.get_device() == self._idx and t.dtype is self.dtype
                and t.numel() == 1):
            raise ValueError(f"krylov: {what} must be a 0-d {self.dtype} scalar on "
                             f"{self.device}, got {t.dtype} {tuple(t.shape)} on {t.device}")
        return t.data_ptr()

    def dot(self, u: torch.Tensor, v: torch.Tensor, slot: int) -> torch.Tensor:
        """``slots[slot] = u . v``."""
        pu, pv = self._vec("u", u), self._vec("v", v)
        out = self.slots[slot]
        self._dot._enqueue(pu, pv, int(not (pu | pv) % 16), out.data_ptr())
        return out

    def cg_update(self, x, r, p, ap, num, den, slot: int) -> torch.Tensor:
        """``alpha = num / den``; ``x += alpha p``; ``r -= alpha ap``;
        ``slots[slot] = r . r`` of the new r. x, r, p, ap distinct, the slot
        neither num nor den."""
        ptrs = (self._vec("x", x), self._vec("r", r), self._vec("p", p), self._vec("ap", ap))
        pn, pd = self._scalar("num", num), self._scalar("den", den)
        out = self.slots[slot]
        if len(set(ptrs)) < 4 or out.data_ptr() in (pn, pd):
            raise ValueError("cg_update: x, r, p and ap must be distinct vectors, and the "
                             "output slot neither num nor den")
        vec = int(not (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3]) % 16)
        self._cg._enqueue(*ptrs, vec, pn, pd, out.data_ptr())
        return out

    def p_update(self, p, z, num, den) -> None:
        """``beta = num / den``; ``p = z + beta p``; z distinct from p (CG
        passes r)."""
        pp, pz = self._vec("p", p), self._vec("z", z)
        if pp == pz:
            raise ValueError("p_update: z must not alias p")
        self._p._enqueue(pp, pz, int(not (pp | pz) % 16), self._scalar("num", num),
                         self._scalar("den", den))
