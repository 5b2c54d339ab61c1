"""Work counts of HPCG's symmetric Gauss-Seidel (SymGS), from the
configuration alone, and the reading of its kernels in a trace.

A SymGS step is a forward and a backward sweep. The least a sweep
direction of a level must move is that level's matrix once in its
smallest plain form (``roofline.plain_form_bytes``, 8-byte values), r
read once, and x read and written once; its operations are two an entry
(a multiply and an add or, on the diagonal, the division). A V-cycle of
HPCG's multigrid runs one step before and one after on each level but
the coarsest and one on the coarsest (7 steps with 4 levels). The least
time of a direction is its bytes over the HBM peak or its operations over
the FP64 peak, whichever is longer. The same work whatever implements the
sweep: natural order, colours, or another reordering.

The SymGS kernels of a trace are picked out by the symbol the port gives
its colour pass (:data:`SYMGS_KERNEL`), since a benchmark range cannot
split the kernels of one CUDA graph replay; a program without that kernel
reads nothing.
"""

from __future__ import annotations

from portbench.roofline import HBM_BYTES_PER_S, plain_form_bytes

#: the FP64 rate outside the tensor cores of one H100 SXM at 700 W (data
#: sheet), FLOP/s
F64_FLOP_PER_S = 34e12

#: a substring of the name of the port's SymGS colour-pass kernel
#: (``csrc/symgs_dia.cu``: ``spmx_symgs_color<double>``)
SYMGS_KERNEL = "spmx_symgs_color"

#: bytes of a value in float64
VALUE_BYTES = 8


def stencil_counts(nx: int, ny: int, nz: int):
    """``(rows, nnz, occupied diagonals)`` of the 27-point operator on an
    ``nx * ny * nz`` grid."""
    rows = nx * ny * nz
    nnz = (3 * nx - 2) * (3 * ny - 2) * (3 * nz - 2)

    def steps(n):
        return (-1, 0, 1) if n > 1 else (0,)

    offsets = {sx + nx * (sy + ny * sz) for sz in steps(nz) for sy in steps(ny)
               for sx in steps(nx)}
    return rows, nnz, len(offsets)


def sweep_work(nx: int, ny: int, nz: int):
    """``(bytes, flops)`` of one SymGS sweep direction on one level."""
    rows, nnz, ndiag = stencil_counts(nx, ny, nz)
    nbytes = (plain_form_bytes(rows, rows, nnz, ndiag, VALUE_BYTES)
              + VALUE_BYTES * rows + 2 * VALUE_BYTES * rows)
    return nbytes, 2.0 * nnz


def vcycle_symgs_s(nx: int, ny: int, nz: int, levels: int) -> float:
    """The least time of one V-cycle's SymGS steps: two steps on each level
    but the coarsest and one there, two directions a step."""
    total = 0.0
    for lvl in range(levels):
        nbytes, flops = sweep_work(nx >> lvl, ny >> lvl, nz >> lvl)
        steps = 1 if lvl == levels - 1 else 2
        total += 2 * steps * max(nbytes / HBM_BYTES_PER_S, flops / F64_FLOP_PER_S)
    return total


def symgs_device_s(trace) -> float:
    """Seconds of the SymGS colour-pass kernels in the traced sub-window."""
    return sum(e - s for s, e, name, _c, _k in trace.kernels() if SYMGS_KERNEL in name) / 1e6
