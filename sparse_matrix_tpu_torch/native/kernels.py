"""ctypes bindings of the CUDA kernels, with launch counts.

Each ``launch_*`` function checks that its tensors are contiguous CUDA
tensors of the types the kernel takes on one device, enqueues the kernel on
PyTorch's current stream, raises if the launch was refused, and then adds
one to ``launch_counts[name]``; with no work (an empty plan) it launches
and counts nothing. Nothing here synchronises or allocates; the
callers in ``ops/`` own the outputs. The library is built and loaded at the
first launch, never at import.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

__all__ = [
    "launch_counts",
    "reset_launch_counts",
    "launch_dia",
    "launch_aligned",
    "launch_lanepack",
    "launch_bell",
    "launch_stripe",
    "launch_dia_spmm",
    "launch_aligned_spmm",
    "launch_lanepack_spmm",
    "launch_bell_spmm",
    "launch_bcsr_spmm",
    "launch_block_spgemm",
    "launch_esc_expand",
]

KERNELS = ("dia", "aligned", "lanepack", "bell", "stripe", "dia_spmm", "aligned_spmm",
           "lanepack_spmm", "bell_spmm", "bcsr_spmm", "block_spgemm", "esc_expand")

#: launches per kernel since the last :func:`reset_launch_counts`
launch_counts: Dict[str, int] = {k: 0 for k in KERNELS}

_LIB: Optional[ctypes.CDLL] = None


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
        lib.spmx_aligned.restype = i32
        lib.spmx_aligned.argtypes = [i32, vp, vp, vp, vp, i64, i64, vp, vp, vp]
        lib.spmx_lanepack.restype = i32
        lib.spmx_lanepack.argtypes = [
            i32, vp, vp, vp, vp, vp, vp, i64, i64, vp, vp, vp,
        ]
        lib.spmx_bell.restype = i32
        lib.spmx_bell.argtypes = [
            i32, vp, i32, vp, i32, i32, vp, i32, i64, i64, i64, vp, vp, vp,
        ]
        lib.spmx_stripe.restype = i32
        lib.spmx_stripe.argtypes = [
            i32, vp, vp, i32, vp, vp, vp, vp, i64, i32, i64, vp, vp, vp,
        ]
        lib.spmx_dia_spmm.restype = i32
        lib.spmx_dia_spmm.argtypes = [
            i32, vp, i32, vp, i32, i64, i64, i32, vp, i64, vp, i64, i64, vp,
        ]
        lib.spmx_aligned_spmm.restype = i32
        lib.spmx_aligned_spmm.argtypes = [
            i32, vp, vp, vp, vp, i64, i64, i32, vp, vp, vp,
        ]
        lib.spmx_lanepack_spmm.restype = i32
        lib.spmx_lanepack_spmm.argtypes = [
            i32, vp, vp, vp, vp, vp, vp, i64, i64, i32, vp, vp, vp,
        ]
        lib.spmx_bell_spmm.restype = i32
        lib.spmx_bell_spmm.argtypes = [
            i32, vp, i32, vp, i32, i32, vp, i32, i64, i64, i32, vp, vp, vp,
        ]
        lib.spmx_bcsr_spmm.restype = i32
        lib.spmx_bcsr_spmm.argtypes = [i32, vp, vp, vp, i64, i32, i64, vp, vp, vp]
        lib.spmx_block_spgemm.restype = i32
        lib.spmx_block_spgemm.argtypes = [i32, vp, vp, i32, vp, vp, vp, i64, i32, vp, vp]
        lib.spmx_esc_expand.restype = i32
        lib.spmx_esc_expand.argtypes = [i32, vp, i64, vp, i64, vp, vp, vp, vp, i64, i64, vp, vp]
        _LIB = lib
    return _LIB


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


def _run(name: str, dev: torch.device, fn, *args) -> None:
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(dev.index, *args, stream)
    if err != 0:
        msg = _library().spmx_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} ({msg})")
    launch_counts[name] += 1


_F32 = torch.float32
_VALS = (torch.float32, torch.bfloat16)


def launch_dia(data, offsets, x, y, *, rows: int, cols: int) -> None:
    """``y[:rows] = DIA(data, offsets) @ x`` (data ``(nb, rows)``)."""
    dev = _check("dia", dict(data=_VALS, offsets=torch.int32, x=_F32, y=_F32),
                 data=data, offsets=offsets, x=x, y=y)
    nb = offsets.numel()
    if data.shape != (nb, rows) or x.numel() != cols or y.numel() != rows:
        raise ValueError("dia: shapes disagree with (nb, rows, cols)")
    _run("dia", dev, _library().spmx_dia, data.data_ptr(),
         int(data.dtype == torch.bfloat16), offsets.data_ptr(), nb, rows, cols,
         x.data_ptr(), y.data_ptr())


def launch_aligned(vals, lane, col_off, chunk_rb, x, y) -> None:
    """``y += aligned(vals, lane, col_off, chunk_rb) @ x``; y is the
    ``(r128 * 128,)`` accumulator."""
    dev = _check("aligned", dict(vals=_F32, lane=torch.int8, col_off=torch.int32,
                                 chunk_rb=torch.int32, x=_F32, y=_F32),
                 vals=vals, lane=lane, col_off=col_off, chunk_rb=chunk_rb, x=x, y=y)
    chunks = vals.numel() // 128
    if lane.numel() != vals.numel() or col_off.numel() < chunks or chunk_rb.numel() < chunks:
        raise ValueError("aligned: slot and chunk arrays disagree")
    if chunks == 0:
        return
    _run("aligned", dev, _library().spmx_aligned, vals.data_ptr(), lane.data_ptr(),
         col_off.data_ptr(), chunk_rb.data_ptr(), chunks, x.numel(),
         x.data_ptr(), y.data_ptr())


def launch_lanepack(vals, lane, ends, starts, col_off, chunk_rb, x, y) -> None:
    """``y += lanepack(...) @ x``; y is the ``(r128 * 128,)`` accumulator."""
    dev = _check(
        "lanepack",
        dict(vals=_F32, lane=torch.int16, ends=torch.int8, starts=torch.int8,
             col_off=torch.int32, chunk_rb=torch.int32, x=_F32, y=_F32),
        vals=vals, lane=lane, ends=ends, starts=starts, col_off=col_off,
        chunk_rb=chunk_rb, x=x, y=y,
    )
    chunks = vals.numel() // 128
    n = vals.numel()
    if (lane.numel(), ends.numel(), starts.numel()) != (n, n, n) or min(
        col_off.numel(), chunk_rb.numel()
    ) < chunks:
        raise ValueError("lanepack: slot and chunk arrays disagree")
    if chunks == 0:
        return
    _run("lanepack", dev, _library().spmx_lanepack, vals.data_ptr(), lane.data_ptr(),
         ends.data_ptr(), starts.data_ptr(), col_off.data_ptr(),
         chunk_rb.data_ptr(), chunks, x.numel(), x.data_ptr(), y.data_ptr())


def launch_bell(vals, lane, ds, x, y, *, bias: int, rows: int) -> None:
    """``y = BELL(vals, lane, ds) @ x`` (vals/lane ``(L, r128, 128)``)."""
    dev = _check(
        "bell",
        dict(vals=_VALS, lane=(torch.int8, torch.int16), ds=torch.int32, x=_F32, y=_F32),
        vals=vals, lane=lane, ds=ds, x=x, y=y,
    )
    layers = ds.numel()
    if vals.dim() != 3 or vals.shape[0] != layers or lane.shape != vals.shape:
        raise ValueError("bell: value/lane planes disagree with ds")
    r128 = vals.shape[1]
    if r128 * 128 < rows or y.numel() != rows:
        raise ValueError("bell: planes do not cover the rows")
    _run("bell", dev, _library().spmx_bell, vals.data_ptr(),
         int(vals.dtype == torch.bfloat16), lane.data_ptr(), lane.element_size(),
         bias, ds.data_ptr(), layers, r128, rows, x.numel(), x.data_ptr(),
         y.data_ptr())


def launch_stripe(vals, lane, ends, starts, stripe_rb, col_off, x, y, *, levels: int) -> None:
    """``y += stripe(...) @ x`` for one stripe plan (scan mode when
    ``starts`` is given, select mode when it is None); y is the
    ``(r128_padded * 128,)`` accumulator."""
    tensors = dict(vals=vals, lane=lane, ends=ends, stripe_rb=stripe_rb,
                   col_off=col_off, x=x, y=y)
    if starts is not None:
        tensors["starts"] = starts
    dev = _check(
        "stripe",
        dict(vals=_F32, lane=(torch.int8, torch.int16), ends=torch.int8,
             starts=torch.int8, stripe_rb=torch.int32, col_off=torch.int32,
             x=_F32, y=_F32),
        **tensors,
    )
    slabs = stripe_rb.numel()
    if (
        vals.numel() != slabs * 1024 or lane.numel() != vals.numel()
        or col_off.numel() != slabs * 8
        or ends.shape != (slabs, levels, 8, 128)
        or (starts is not None and starts.shape != ends.shape)
    ):
        raise ValueError("stripe: slab arrays disagree with (slabs, levels)")
    if slabs == 0:
        return
    _run("stripe", dev, _library().spmx_stripe, vals.data_ptr(), lane.data_ptr(),
         lane.element_size(), ends.data_ptr(),
         None if starts is None else starts.data_ptr(), stripe_rb.data_ptr(),
         col_off.data_ptr(), slabs, levels, x.numel(), x.data_ptr(), y.data_ptr())


def launch_dia_spmm(data, offsets, x3, y3, *, rows: int, cols: int, x_lo: int, y_lo: int) -> None:
    """``y3 = DIA(data, offsets) @ x3`` in the packed ``(.., K, 128)``
    layout (data ``(nb, rows)``, 1 <= K <= 16); writes every element of
    y3."""
    dev = _check("dia_spmm", dict(data=_VALS, offsets=torch.int32, x3=_F32, y3=_F32),
                 data=data, offsets=offsets, x3=x3, y3=y3)
    nb = offsets.numel()
    k = x3.shape[1] if x3.dim() == 3 else 0
    if (
        data.shape != (nb, rows) or x3.dim() != 3 or y3.dim() != 3
        or not 1 <= k <= 16 or x3.shape[2] != 128 or y3.shape[1:] != (k, 128)
        or (x3.shape[0] - x_lo) * 128 < cols or (y3.shape[0] - y_lo) * 128 < rows
    ):
        raise ValueError("dia_spmm: shapes disagree with (nb, rows, cols, K)")
    _run("dia_spmm", dev, _library().spmx_dia_spmm, data.data_ptr(),
         int(data.dtype == torch.bfloat16), offsets.data_ptr(), nb, rows, cols, k,
         x3.data_ptr(), x_lo, y3.data_ptr(), y_lo, y3.shape[0])


def launch_aligned_spmm(vals, lane, col_off, chunk_rb, x3, y3, *, cols: int) -> None:
    """``y3 += aligned(vals, lane, col_off, chunk_rb) @ x3`` in the packed
    ``(.., K, 128)`` layout; y3 is the accumulator."""
    dev = _check("aligned_spmm",
                 dict(vals=_F32, lane=torch.int8, col_off=torch.int32,
                      chunk_rb=torch.int32, x3=_F32, y3=_F32),
                 vals=vals, lane=lane, col_off=col_off, chunk_rb=chunk_rb, x3=x3, y3=y3)
    chunks = vals.numel() // 128
    if lane.numel() != vals.numel() or min(col_off.numel(), chunk_rb.numel()) < chunks:
        raise ValueError("aligned_spmm: slot and chunk arrays disagree")
    if x3.dim() != 3 or x3.shape[2] != 128 or y3.shape[1:] != x3.shape[1:]:
        raise ValueError("aligned_spmm: x3 and y3 must be (.., K, 128) with one K")
    if x3.shape[0] * 128 < cols:
        raise ValueError("aligned_spmm: x3 does not cover the columns")
    if chunks == 0:
        return
    _run("aligned_spmm", dev, _library().spmx_aligned_spmm, vals.data_ptr(),
         lane.data_ptr(), col_off.data_ptr(), chunk_rb.data_ptr(), chunks, cols,
         x3.shape[1], x3.data_ptr(), y3.data_ptr())


def launch_lanepack_spmm(vals, lane, ends, starts, col_off, chunk_rb, x3, y3, *, cols: int) -> None:
    """``y3 += lanepack(...) @ x3`` in the packed ``(.., K, 128)`` layout;
    y3 is the accumulator, x reads past ``cols`` give zero."""
    dev = _check(
        "lanepack_spmm",
        dict(vals=_F32, lane=torch.int16, ends=torch.int8, starts=torch.int8,
             col_off=torch.int32, chunk_rb=torch.int32, x3=_F32, y3=_F32),
        vals=vals, lane=lane, ends=ends, starts=starts, col_off=col_off,
        chunk_rb=chunk_rb, x3=x3, y3=y3,
    )
    chunks = vals.numel() // 128
    n = vals.numel()
    if (lane.numel(), ends.numel(), starts.numel()) != (n, n, n) or min(
        col_off.numel(), chunk_rb.numel()
    ) < chunks:
        raise ValueError("lanepack_spmm: slot and chunk arrays disagree")
    if x3.dim() != 3 or x3.shape[2] != 128 or y3.dim() != 3 or y3.shape[1:] != x3.shape[1:]:
        raise ValueError("lanepack_spmm: x3 and y3 must be (.., K, 128) with one K")
    if x3.shape[0] * 128 < cols:
        raise ValueError("lanepack_spmm: x3 does not cover the columns")
    if chunks == 0 or x3.shape[1] == 0:
        return
    _run("lanepack_spmm", dev, _library().spmx_lanepack_spmm, vals.data_ptr(),
         lane.data_ptr(), ends.data_ptr(), starts.data_ptr(), col_off.data_ptr(),
         chunk_rb.data_ptr(), chunks, cols, x3.shape[1], x3.data_ptr(), y3.data_ptr())


def launch_bell_spmm(vals, lane, ds, x3, y3, *, bias: int, cols: int) -> None:
    """``y3 = BELL(vals, lane, ds) @ x3`` in the packed ``(.., K, 128)``
    layout (vals/lane ``(L, r128, 128)``, y3 ``(r128, K, 128)``, 1 <= K <=
    16); writes every element of y3."""
    dev = _check(
        "bell_spmm",
        dict(vals=_VALS, lane=(torch.int8, torch.int16), ds=torch.int32, x3=_F32, y3=_F32),
        vals=vals, lane=lane, ds=ds, x3=x3, y3=y3,
    )
    layers = ds.numel()
    if vals.dim() != 3 or vals.shape[0] != layers or lane.shape != vals.shape:
        raise ValueError("bell_spmm: value/lane planes disagree with ds")
    k = x3.shape[1] if x3.dim() == 3 else 0
    r128 = vals.shape[1]
    if (
        not 1 <= k <= 16 or x3.shape[2] != 128 or y3.shape != (r128, k, 128)
        or x3.shape[0] * 128 < cols
    ):
        raise ValueError("bell_spmm: shapes disagree with (L, r128, cols, K)")
    _run("bell_spmm", dev, _library().spmx_bell_spmm, vals.data_ptr(),
         int(vals.dtype == torch.bfloat16), lane.data_ptr(), lane.element_size(),
         bias, ds.data_ptr(), layers, r128, cols, k, x3.data_ptr(), y3.data_ptr())


def _check_bs(name: str, bs: int) -> None:
    if bs % 16 or not 16 <= bs <= 128:
        raise ValueError(f"{name}: block size {bs} must be a multiple of 16 in [16, 128]")


def launch_bcsr_spmm(blocks, block_cols, block_offsets, x, y) -> None:
    """``y = BCSR(blocks, block_cols, block_offsets) @ x``: x is
    ``(bcols * bs, F)``, y ``(brows * bs, F)``, F a multiple of 128; writes
    every element of y (block rows with no block get zeros)."""
    dev = _check("bcsr_spmm",
                 dict(blocks=_F32, block_cols=torch.int32, block_offsets=torch.int32,
                      x=_F32, y=_F32),
                 blocks=blocks, block_cols=block_cols, block_offsets=block_offsets, x=x, y=y)
    if blocks.dim() != 3 or blocks.shape[1] != blocks.shape[2]:
        raise ValueError("bcsr_spmm: blocks must be (nnzb, bs, bs)")
    bs = blocks.shape[1]
    _check_bs("bcsr_spmm", bs)
    brows = block_offsets.numel() - 1
    f = x.shape[1] if x.dim() == 2 else 0
    if (
        block_cols.numel() != blocks.shape[0] or brows < 0 or f % 128
        or x.shape[0] % bs or y.shape != (brows * bs, f)
    ):
        raise ValueError("bcsr_spmm: shapes disagree with (nnzb, bs, brows, F)")
    if brows == 0 or f == 0:
        return
    _run("bcsr_spmm", dev, _library().spmx_bcsr_spmm, blocks.data_ptr(),
         block_cols.data_ptr(), block_offsets.data_ptr(), brows, bs, f, x.data_ptr(),
         y.data_ptr())


def launch_block_spgemm(a_blocks, b_blocks, pair_a, pair_b, seg, c) -> None:
    """``c[q] = sum_{p in [seg[q], seg[q+1])} a_blocks[pair_a[p]] @
    b_blocks[pair_b[p]]`` for every C block q, in pair order; blocks f32 or
    bf16 (one type for both), c f32 ``(num_c, bs, bs)``, written whole."""
    dev = _check("block_spgemm",
                 dict(a_blocks=_VALS, b_blocks=_VALS, pair_a=torch.int32,
                      pair_b=torch.int32, seg=torch.int32, c=_F32),
                 a_blocks=a_blocks, b_blocks=b_blocks, pair_a=pair_a, pair_b=pair_b,
                 seg=seg, c=c)
    if a_blocks.dtype != b_blocks.dtype:
        raise TypeError("block_spgemm: A and B blocks must share one dtype")
    if a_blocks.dim() != 3 or a_blocks.shape[1] != a_blocks.shape[2]:
        raise ValueError("block_spgemm: blocks must be (n, bs, bs)")
    bs = a_blocks.shape[1]
    _check_bs("block_spgemm", bs)
    num_c = seg.numel() - 1
    if (
        b_blocks.shape[1:] != (bs, bs) or pair_a.numel() != pair_b.numel()
        or num_c < 0 or c.shape != (num_c, bs, bs)
    ):
        raise ValueError("block_spgemm: shapes disagree with (pairs, num_c, bs)")
    if num_c == 0:
        return
    _run("block_spgemm", dev, _library().spmx_block_spgemm, a_blocks.data_ptr(),
         b_blocks.data_ptr(), int(a_blocks.dtype == torch.bfloat16), pair_a.data_ptr(),
         pair_b.data_ptr(), seg.data_ptr(), num_c, bs, c.data_ptr())


def launch_esc_expand(lv, rv, lv_lane, rv_lane, lv_off, rv_off, p, *, num_products: int) -> None:
    """``p[s] = lv[lv_off[s >> 7] * 128 + lv_lane[s]] * rv[rv_off[s >> 7] *
    128 + rv_lane[s]]`` for every slot ``s < num_products`` (operand
    positions past the end read 0), ``p[s] = 0`` on the rest; lanes
    ``(S, 8, 128)`` int16, window rows ``(S * 8,)`` int32, values and p
    f32; writes every element of p."""
    for key, t in (("lv", lv), ("rv", rv), ("p", p)):
        if t.dtype != _F32:
            raise ValueError(f"esc_expand: {key} has dtype {t.dtype}; the kernel takes "
                             "f32 (torch.float32) values only")
    dev = _check("esc_expand",
                 dict(lv=_F32, rv=_F32, lv_lane=torch.int16, rv_lane=torch.int16,
                      lv_off=torch.int32, rv_off=torch.int32, p=_F32),
                 lv=lv, rv=rv, lv_lane=lv_lane, rv_lane=rv_lane, lv_off=lv_off,
                 rv_off=rv_off, p=p)
    slots = p.numel()
    if (
        lv_lane.numel() != slots or rv_lane.numel() != slots or slots % 1024
        or lv_off.numel() != slots // 128 or rv_off.numel() != slots // 128
        or not 0 <= num_products <= slots
    ):
        raise ValueError("esc_expand: lane, window and product arrays disagree")
    if slots == 0:
        return
    _run("esc_expand", dev, _library().spmx_esc_expand, lv.data_ptr(), lv.numel(),
         rv.data_ptr(), rv.numel(), lv_lane.data_ptr(), rv_lane.data_ptr(),
         lv_off.data_ptr(), rv_off.data_ptr(), num_products, slots, p.data_ptr())
