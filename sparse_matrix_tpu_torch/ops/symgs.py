"""Multicolour symmetric Gauss-Seidel (SymGS) over DIA band planes.

No counterpart in the JAX package, which has no Gauss-Seidel smoother;
HPCG's multigrid (``solvers/hpcg.py``) smooths with it. One step toward
``A x = r`` is a forward sweep over the colours ``0 .. C-1`` and a backward
sweep ``C-1 .. 0``; a colour's pass sets, for all its rows at once,
``x_i = (r_i - sum_{j != i} a_ij x_j) / a_ii`` from the current x. A
colouring in which no two rows of one colour are coupled makes that exact
Gauss-Seidel in the order of the colours (:func:`parity_colors` gives the
8-colour parity colouring of a 27-point grid). On CUDA a step is
``csrc/symgs_dia.cu``, all its colour passes in one launch, over planes
re-laid by colour; on the CPU the plain version :func:`_symgs_torch` runs
on the natural planes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import on_cuda, require_device
from ..formats.dia import DiaMatrix

__all__ = ["SymgsPlan", "parity_colors", "coupled_same_color"]


def parity_colors(nx: int, ny: int, nz: int) -> np.ndarray:
    """The colour ``(ix & 1) + 2 (iy & 1) + 4 (iz & 1)`` of each row ``ix +
    nx (iy + ny iz)`` of an ``nx * ny * nz`` grid (int64)."""
    idx = np.arange(nx * ny * nz, dtype=np.int64)
    ix, iy, iz = idx % nx, (idx // nx) % ny, idx // (nx * ny)
    return (ix & 1) + 2 * (iy & 1) + 4 * (iz & 1)


def coupled_same_color(dia: DiaMatrix, colors: np.ndarray) -> int:
    """The nonzero slots of ``dia`` off the diagonal that couple two rows
    of one colour (0 for a valid colouring)."""
    i = np.arange(dia.rows, dtype=np.int64)
    bad = 0
    for b, off in enumerate(dia.offsets):
        if off == 0:
            continue
        j = i + off
        live = (j >= 0) & (j < dia.cols) & (dia.data[b] != 0)
        bad += int(np.count_nonzero(colors[i[live]] == colors[j[live]]))
    return bad


class SymgsPlan:
    """One SymGS step on a square DIA operator with a colouring: ``plan.step(x,
    r)`` updates the vector ``x`` (its own, (n,), in ``dtype``) in place and
    returns it.

    Refused at construction: a non-square operator, no main diagonal or a
    zero on it, a colouring of the wrong length or with more colours than
    the kernel takes, and one that couples two rows of one colour. The
    colours' rows keep their natural order within a colour.

    On CUDA ``launch`` is the kernel's launch record
    (:class:`~..native.kernels.PreparedSymgs`; ``launch.by_pass(r, x)`` is
    the same step as one launch a colour pass, the yardstick), which holds
    the kernel's state: the ticket, the epoch and the pass counts that
    order a step's colour passes inside its one launch. A step in flight
    on one plan is one caller's (x is updated in place anyway); steps on
    one stream, eager or replayed in a CUDA graph, follow one another."""

    def __init__(self, dia: DiaMatrix, colors: np.ndarray, *, device, dtype=torch.float64):
        from .operator import _NP_DTYPES

        self.device = require_device(device)
        self.dtype = dtype
        if dia.rows != dia.cols:
            raise ValueError("symgs: the operator must be square")
        if 0 not in dia.offsets:
            raise ValueError("symgs: the operator has no main diagonal band")
        self.diag = dia.offsets.index(0)
        data = np.ascontiguousarray(dia.data, dtype=_NP_DTYPES[dtype])
        if not np.all(data[self.diag] != 0):
            raise ValueError("symgs: a zero on the main diagonal")
        colors = np.asarray(colors, dtype=np.int64)
        if colors.shape != (dia.rows,) or (colors.size and colors.min() < 0):
            raise ValueError(f"symgs: the colouring must give each of {dia.rows} rows a colour "
                             ">= 0")
        ncol = int(colors.max()) + 1 if colors.size else 1
        from ..native.kernels import SYMGS_MAX_COLORS

        if ncol > SYMGS_MAX_COLORS:
            raise ValueError(f"symgs: {ncol} colours; the kernel takes at most {SYMGS_MAX_COLORS}")
        bad = coupled_same_color(dia, colors)
        if bad:
            raise ValueError(f"symgs: the colouring couples {bad} pairs of rows of one colour")
        self.n, self.colors, self.offsets = dia.rows, ncol, dia.offsets
        order = np.argsort(colors, kind="stable")
        starts = np.zeros(ncol + 1, dtype=np.int64)
        np.cumsum(np.bincount(colors, minlength=ncol), out=starts[1:])
        self.color_start = tuple(int(s) for s in starts)
        self.launch = None
        if self.device.type == "cuda":
            from ..native.kernels import prepare_symgs

            self.data = torch.from_numpy(np.ascontiguousarray(data[:, order])).to(self.device)
            rows = torch.from_numpy(order.astype(np.int32)).to(self.device)
            offsets_t = torch.tensor(dia.offsets, dtype=torch.int32, device=self.device)
            self.launch = prepare_symgs(self.data, rows, offsets_t,
                                        color_start=self.color_start, diag=self.diag)
        else:
            self.data = torch.from_numpy(data)
            self._passes = [_color_pass(self.data, self.offsets, self.diag,
                                        torch.from_numpy(order[a:b]))
                            for a, b in zip(starts[:-1], starts[1:]) if b > a]

    def step(self, x: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
        """One SymGS step toward ``A x = r`` on the vector ``x`` in place;
        on CUDA through the kernel, on the CPU through
        :func:`_symgs_torch`."""
        if x.device != self.device or r.device != self.device:
            raise ValueError(f"symgs: x and r must be on {self.device}")
        if x.shape != (self.n,) or r.shape != (self.n,):
            raise ValueError(f"symgs: x {tuple(x.shape)} and r {tuple(r.shape)} must be vectors "
                             f"of {self.n}")
        if on_cuda(x):
            self.launch(r.contiguous(), x)
            return x
        return _symgs_torch(self._passes, x, r)


def _color_pass(data, offsets: tuple, diag: int, rows):
    """What the plain version reads for one colour's rows (int64): the
    rows, each off-diagonal band's column of each row (clamped into
    ``[0, n)``) and whether it lies there, the band values and the
    diagonal."""
    n = data.shape[1]
    bands = [b for b in range(len(offsets)) if b != diag]
    off = torch.tensor([offsets[b] for b in bands], dtype=torch.int64)
    j = rows[None, :] + off[:, None]
    return rows, j.clamp(0, n - 1), (j >= 0) & (j < n), data[bands][:, rows], data[diag, rows]


def _symgs_torch(passes: list, x, r):
    """Plain PyTorch SymGS step, in place on the vector ``x``: for each
    colour's :func:`_color_pass` forward, then backward, its rows get ``(r
    - sum_{b != diag} data[b] x[row + off_b]) / data[diag]`` (x outside
    [0, n) reads 0) from the current x. The off-diagonal products
    are gathered for all bands at once and summed by ``torch.sum``, so the
    last bits may differ from the kernel's band-order sum."""
    for rows, jc, live, coef, dg in (*passes, *passes[::-1]):
        s = (coef * torch.where(live, x[jc], 0.0)).sum(0)
        x[rows] = (r[rows] - s) / dg
    return x
