"""Device-resident CSR: the host CSR arrays as tensors on one device.

Counterpart of ``sparse_matrix_tpu/formats/device.py``. The reference's
pytree registration (static ``rows``/``cols``/``is_sorted`` for jit) has
no counterpart: the port runs eagerly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from ..device import require_device
from .csr import INDEX_DTYPE, OFFSET_DTYPE, CsrMatrix

__all__ = ["DeviceCsr"]


@dataclass
class DeviceCsr:
    """CSR arrays on a device: values, int32 column indices, int32 row
    offsets and the int32 per-entry row ids (the expanded offsets)."""

    vals: torch.Tensor  # (nnz,) float
    indices: torch.Tensor  # (nnz,) int32
    offsets: torch.Tensor  # (rows + 1,) int32
    row_ids: torch.Tensor  # (nnz,) int32
    rows: int
    cols: int
    is_sorted: bool

    @property
    def nnz(self) -> int:
        return int(self.vals.shape[0])

    @property
    def shape(self) -> Tuple[int, int]:
        return (self.rows, self.cols)

    @classmethod
    def from_host(cls, m: CsrMatrix, *, device, dtype=torch.float32) -> "DeviceCsr":
        dev = require_device(device)

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

        return cls(
            vals=up(m.vals).to(dtype),
            indices=up(m.indices.astype(np.int32)),
            offsets=up(m.offsets.astype(np.int32)),
            row_ids=up(m.row_ids().astype(np.int32)),
            rows=m.rows,
            cols=m.cols,
            is_sorted=m.is_sorted,
        )

    def to_host(self) -> CsrMatrix:
        return CsrMatrix(
            self.rows,
            self.cols,
            self.vals.cpu().numpy(),
            self.indices.cpu().numpy().astype(INDEX_DTYPE),
            self.offsets.cpu().numpy().astype(OFFSET_DTYPE),
            is_sorted=self.is_sorted,
        )
