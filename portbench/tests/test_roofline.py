"""The work counts against counts made by hand."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import roofline
from portbench.generators import load


def test_poisson_spmv_bytes_by_hand():
    # Poisson 4x4: 16 rows, 64 nnz (16 + 4 * 12), 5 diagonals; the smaller
    # of CSR with 1-byte columns and pointers (337 bytes) and DIA (340)
    m = load("poisson_2d").make(None, n=4)
    assert m.nnz() == 64
    ndiag = roofline.occupied_diagonals(m.row_ids(), m.indices)
    assert ndiag == 5
    nbytes, flops = roofline.spmv_work(m.rows, m.cols, m.nnz(), ndiag)
    assert nbytes == min(64 * (4 + 1) + 17 * 1, 5 * (16 * 4 + 4)) + 4 * (16 + 16)
    assert flops == 2 * 64


def test_poisson_2048_spmv_bytes():
    # the DIA planes: 5 * (4194304 * 4 + 4) bytes, x and y 16.8 MB each
    nbytes, flops = roofline.spmv_work(2048 * 2048, 2048 * 2048, 20963328, 5)
    assert nbytes == 5 * (4194304 * 4 + 4) + 4 * 2 * 4194304
    assert flops == 2.0 * 20963328
    # bytes bound it: 0.0351 ms at 3.35 TB/s (chip_smoke.py's B1 bound 0.0351)
    assert roofline.bound_s(nbytes, flops) == pytest.approx(nbytes / 3.35e12)
    assert roofline.bound_s(nbytes, flops) * 1e3 == pytest.approx(0.03506, abs=1e-5)


def test_femlike_spgemm_bytes_by_hand():
    m = load("fem_like").make(np.random.default_rng(1), n_side=6, jitter=1)
    a = m.vals.size
    dense = np.zeros((36, 36))
    dense[m.row_ids(), m.indices.astype(np.int64)] = 1
    c_nnz = int(np.count_nonzero(dense @ dense))
    products = int(sum(np.diff(m.offsets)[m.indices.astype(np.int64)]))
    nbytes, flops = roofline.spgemm_refresh_work(36, 36, a, c_nnz, products)
    # values 4 bytes and 1-byte columns per entry, 37 one-byte or two-byte
    # pointers, C's values written once
    ptr = 1 if a + 1 <= 256 else 2
    assert nbytes == a * (4 + 1) + 37 * ptr + 4 * c_nnz
    assert flops == 2 * products - c_nnz


def test_index_bytes():
    assert [roofline.index_bytes(e) for e in (1, 256, 257, 65536, 65537, 1 << 32, (1 << 32) + 1)] \
        == [1, 1, 2, 2, 4, 4, 8]
