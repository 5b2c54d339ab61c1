"""Work counts of the operations the benchmark times, and the peaks they
are held against.

Each count is of the work, not of an implementation: the compulsory
bytes (every input byte read once and every output byte written once,
the matrix in the smallest of its plain forms) and the operations the
algorithm needs for these inputs. The arithmetic is ``chip_smoke.py``'s
(``plain_form_bytes``, the DIA SpMV bound, the ESC expansion and run-sum
bounds), cut to what a refreshed product must move. A kernel's roofline
share is the least time these counts allow, over the time measured.

Peaks: NVIDIA's H100 SXM data sheet, dense rates at the full 700 W power
limit. A result names the card's power limit beside them
(``nvidia-smi --query-gpu=power.limit``): a card set below 700 W runs
slower under load.
"""

from __future__ import annotations

import numpy as np

#: HBM3 bandwidth of one H100 SXM, bytes/s (data sheet)
HBM_BYTES_PER_S = 3.35e12
#: float32 rate outside the tensor cores (TF32 stays off), FLOP/s
F32_FLOP_PER_S = 67e12


def index_bytes(extent: int) -> int:
    """The narrowest unsigned index that addresses ``extent`` positions."""
    return 1 if extent <= 1 << 8 else 2 if extent <= 1 << 16 else 4 if extent <= 1 << 32 else 8


def csr_bytes(rows: int, cols: int, nnz: int, value_bytes: int) -> int:
    """CSR with the narrowest column index and row pointer."""
    return nnz * (value_bytes + index_bytes(cols)) + (rows + 1) * index_bytes(nnz + 1)


def plain_form_bytes(rows: int, cols: int, nnz: int, ndiag: int, value_bytes: int) -> int:
    """The smaller of the two plain forms: CSR, or DIA (a plane of ``rows``
    values and one 4-byte offset per occupied diagonal)."""
    return min(csr_bytes(rows, cols, nnz, value_bytes), ndiag * (rows * value_bytes + 4))


def occupied_diagonals(row_ids: np.ndarray, cols: np.ndarray) -> int:
    return int(np.unique(cols.astype(np.int64) - row_ids).size)


def spmv_work(rows: int, cols: int, nnz: int, ndiag: int, *, value_bytes: int = 4):
    """``(bytes, flops)`` of one ``y = A x``: A once in its smallest plain
    form, x read and y written once; two operations an entry."""
    nbytes = plain_form_bytes(rows, cols, nnz, ndiag, value_bytes) + value_bytes * (rows + cols)
    return nbytes, 2.0 * nnz


def spgemm_refresh_work(rows: int, cols: int, nnz: int, c_nnz: int, products: int, *,
                        value_bytes: int = 4):
    """``(bytes, flops)`` of one refreshed square ``C = A A`` on a fixed
    pattern, both operands one matrix with one value vector: A's values and
    its CSR pattern read once, C's values written once (its pattern is the
    plan's, unchanged by a refresh); one multiply a product and one add a
    product beyond the first of each entry of C."""
    return csr_bytes(rows, cols, nnz, value_bytes) + value_bytes * c_nnz, \
        float(2 * products - c_nnz)


def bound_s(nbytes: float, flops: float, flop_per_s: float = F32_FLOP_PER_S) -> float:
    """The least time the chip could take: the larger of the byte time
    and the operation time."""
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_per_s)
