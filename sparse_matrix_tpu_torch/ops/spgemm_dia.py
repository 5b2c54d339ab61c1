"""DIA x DIA SpGEMM: band convolution.

Counterpart of ``sparse_matrix_tpu/ops/spgemm_dia.py``. A band at offset
``o1`` times a band at offset ``o2`` adds to the band at ``o1 + o2``::

    C[i, i+o1+o2] += A[i, i+o1] * B[i+o1, i+o1+o2] = da[b1][i] * db[b2][i+o1]

so the product is ``nbands_a * nbands_b`` shifted multiply-adds of f32
vectors: no indices, no sort. The reference runs it in XLA outside any
Pallas kernel; the port runs it in plain PyTorch on ``device``, in the
reference's order (for each A band, each B band), and reads the result
planes back as a host :class:`~..formats.dia.DiaMatrix`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import require_device
from ..formats.dia import DiaMatrix

__all__ = ["spgemm_dia"]


def _band_conv(da, db, *, offs_a: tuple, offs_b: tuple, offs_c: tuple, rows: int,
               inner: int, cols: int):
    """The result planes ``(len(offs_c), rows)``: the reference's
    ``_band_conv``, with positions whose column leaves the result shape
    zeroed."""
    dev = da.device
    pos = {o: k for k, o in enumerate(offs_c)}
    out = torch.zeros((len(offs_c), rows), dtype=da.dtype, device=dev)
    # B's planes behind |min(o1, 0)| zeros and ahead of enough zeros that
    # every shifted slice stays inside the buffer
    pre = max(0, -min(offs_a))
    post = max(0, max(offs_a)) + rows
    dbp = torch.zeros((db.shape[0], pre + db.shape[1] + post), dtype=db.dtype, device=dev)
    dbp[:, pre : pre + db.shape[1]] = db
    i = torch.arange(rows, device=dev)
    for b1, o1 in enumerate(offs_a):
        valid_k = (i + o1 >= 0) & (i + o1 < inner)
        a_band = torch.where(valid_k, da[b1], torch.zeros((), dtype=da.dtype, device=dev))
        for b2, o2 in enumerate(offs_b):
            k = pos.get(o1 + o2)
            if k is None:
                continue  # the target band lies outside the result shape
            out[k] += a_band * dbp[b2, pre + o1 : pre + o1 + rows]
    for k, o in enumerate(offs_c):
        bad = (i + o < 0) | (i + o >= cols)
        out[k][bad] = 0
    return out


def spgemm_dia(a: DiaMatrix, b: DiaMatrix, *, device) -> DiaMatrix:
    """``C = A @ B`` for banded operators on ``device``: a host
    DiaMatrix whose bands are the offset sums inside the result shape
    (entries outside it are dropped)."""
    if a.cols != b.rows:
        raise ValueError("LHS cols != RHS rows")
    dev = require_device(device)
    offs_c = sorted({o1 + o2 for o1 in a.offsets for o2 in b.offsets
                     if -(a.rows) < o1 + o2 < b.cols})
    if not offs_c:
        offs_c = [0]
    data = _band_conv(torch.from_numpy(np.ascontiguousarray(a.data)).to(dev),
                      torch.from_numpy(np.ascontiguousarray(b.data)).to(dev),
                      offs_a=a.offsets, offs_b=b.offsets, offs_c=tuple(offs_c),
                      rows=a.rows, inner=a.cols, cols=b.cols)
    return DiaMatrix(a.rows, b.cols, data.cpu().numpy(), tuple(offs_c))
