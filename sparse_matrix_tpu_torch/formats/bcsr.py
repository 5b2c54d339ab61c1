"""BCSR: block-compressed sparse rows with dense blocks.

Counterpart of ``sparse_matrix_tpu/formats/bcsr.py``: only the nonzero
``bs x bs`` tiles of a matrix are stored, each fully dense, in a CSR at block
granularity — ``blocks (nnzb, bs, bs)``, ``block_cols (nnzb,)`` int32,
``block_offsets (brows + 1,)`` int64 — so SpMM and SpGEMM become streams of
dense block products. ``from_csr`` builds arrays equal to the reference's
for the same CSR; ``to_csr`` is the reference's numpy branch (its native
``blocks_to_coo_native`` is not ported, ROADMAP.md queue A item 17).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .csr import CsrMatrix

__all__ = ["BsrMatrix", "BLOCK_SIZE"]

BLOCK_SIZE = 128


@dataclass
class BsrMatrix:
    rows: int
    cols: int
    bs: int
    blocks: np.ndarray  # (nnzb, bs, bs)
    block_cols: np.ndarray  # (nnzb,) int32
    block_offsets: np.ndarray  # (brows+1,) int64

    @property
    def brows(self) -> int:
        return -(-self.rows // self.bs)

    @property
    def bcols(self) -> int:
        return -(-self.cols // self.bs)

    @property
    def nnzb(self) -> int:
        return int(self.blocks.shape[0])

    @property
    def block_density(self) -> float:
        total = self.brows * self.bcols
        return self.nnzb / total if total else 0.0

    @classmethod
    def from_csr(cls, m: CsrMatrix, bs: int = BLOCK_SIZE, *, dtype=np.float32) -> "BsrMatrix":
        """The blocks of ``m`` that hold an entry, sorted by (block row,
        block column), as dense ``dtype`` tiles."""
        r = m.row_ids()
        c = m.indices.astype(np.int64)
        bcols = -(-m.cols // bs)
        key = (r // bs) * bcols + c // bs
        uniq = np.unique(key)
        blocks = np.zeros((len(uniq), bs, bs), dtype=dtype)
        slot = np.searchsorted(uniq, key)
        blocks[slot, r % bs, c % bs] = m.vals.astype(dtype)
        block_rows = (uniq // bcols).astype(np.int64)
        block_cols = (uniq % bcols).astype(np.int32)
        brows = -(-m.rows // bs)
        block_offsets = np.zeros(brows + 1, dtype=np.int64)
        np.add.at(block_offsets, block_rows + 1, 1)
        np.cumsum(block_offsets, out=block_offsets)
        return cls(m.rows, m.cols, bs, blocks, block_cols, block_offsets)

    def block_rows_expanded(self) -> np.ndarray:
        return np.repeat(
            np.arange(self.brows, dtype=np.int64), np.diff(self.block_offsets)
        )

    def to_csr(self) -> CsrMatrix:
        """Back to element CSR, dropping explicit zeros inside blocks."""
        br = self.block_rows_expanded()
        s, rr, cc = np.nonzero(self.blocks)
        r = br[s] * self.bs + rr
        c = self.block_cols.astype(np.int64)[s] * self.bs + cc
        v = self.blocks[s, rr, cc]
        keep = (r < self.rows) & (c < self.cols)
        return CsrMatrix.from_coo(
            self.rows, self.cols, r[keep], c[keep], v[keep], sum_duplicates=False
        )
