"""Device-resident sorted sparse results.

The subset of ``sparse_matrix_tpu/ops/device_sorted.py`` that the block
SpGEMM needs: the :class:`PaddedCoo` result type, holding tensors, and
:func:`padded_to_host`. The ESC SpGEMM, the add/sub merges and the
transpose of that module are not ported yet (ROADMAP.md, slice 4).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..formats.csr import INDEX_DTYPE, OFFSET_DTYPE, CsrMatrix

__all__ = ["PaddedCoo", "padded_to_host"]


class PaddedCoo(NamedTuple):
    """Row-sorted COO with a fixed capacity and a device-side nnz.

    Entries beyond ``nnz`` have ``row == rows`` (the sentinel) and zero
    values.
    """

    row: torch.Tensor  # (cap,) int32, sorted; sentinel = rows
    col: torch.Tensor  # (cap,) int32
    val: torch.Tensor  # (cap,)
    nnz: torch.Tensor  # () int32
    rows: int
    cols: int


def padded_to_host(p: PaddedCoo) -> CsrMatrix:
    """The exact host CSR (sorted) of a device result: one scalar read of
    ``nnz``, then only the live prefix is copied back."""
    n = int(p.nnz)
    row = p.row[:n].cpu().numpy()
    offsets = np.zeros(p.rows + 1, dtype=OFFSET_DTYPE)
    np.cumsum(np.bincount(row, minlength=p.rows), out=offsets[1:])
    return CsrMatrix(p.rows, p.cols, p.val[:n].cpu().numpy(),
                     p.col[:n].cpu().numpy().astype(INDEX_DTYPE), offsets, is_sorted=True)
