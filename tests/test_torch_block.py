"""Port parity: the block-sparse path (sparse_matrix_tpu_torch/
formats/bcsr.py, ops/spmm.py ``spmm_bcsr``, ops/spgemm_block.py).

Each package builds its own plans from the same CSR; the port's CPU path
(the plain versions of the BCSR SpMM and block SpGEMM kernels) is held to
the JAX package's CPU path. Tolerances:

* plans (``BsrMatrix`` arrays, ``block_pairs_plan``): array-equal;
* port vs JAX, both f32: ``max|dY| <= 2e-5 * max(1, max|Y|)``; a SpGEMM
  result must also have the reference's pattern (offsets and indices
  equal);
* port vs float64: BCSR SpMM column by column ``(nnz_row + 1) * u *
  (|A||x|)_i``; a SpGEMM entry ``(n_ij + 2) * u * (|A||B|)_ij`` with n_ij
  its product count, plus ``2 * 2^-8 * (|A||B|)_ij`` for bf16 blocks, on
  the union of both patterns (so a dropped entry is checked too).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sparse_matrix_tpu.bench import corpus as ref_corpus  # noqa: E402
from sparse_matrix_tpu.formats import bcsr as ref_bcsr  # noqa: E402
from sparse_matrix_tpu.formats import csr as ref_csr  # noqa: E402
from sparse_matrix_tpu.ops import spgemm_block as ref_sb  # noqa: E402
from sparse_matrix_tpu.ops import spmm as ref_spmm  # noqa: E402
from sparse_matrix_tpu_torch.bench import corpus  # noqa: E402
from sparse_matrix_tpu_torch.formats.bcsr import BsrMatrix  # noqa: E402
from sparse_matrix_tpu_torch.formats.csr import CsrMatrix  # noqa: E402
from sparse_matrix_tpu_torch.native import kernels  # noqa: E402
from sparse_matrix_tpu_torch.native.kernels import BLOCK_TILE  # noqa: E402
from sparse_matrix_tpu_torch.ops import spgemm_block as sb  # noqa: E402
from sparse_matrix_tpu_torch.ops import spmm  # noqa: E402
from sparse_matrix_tpu_torch.ops.spmv import spmv_f64_bound  # noqa: E402


def _ref(m):
    return ref_csr.CsrMatrix(m.rows, m.cols, m.vals, m.indices, m.offsets,
                             is_sorted=m.is_sorted)


def _f32(m):
    """``m`` with float32 values (exact in both packages' block types)."""
    return CsrMatrix(m.rows, m.cols, m.vals.astype(np.float32), m.indices, m.offsets,
                     is_sorted=m.is_sorted)


def _agree(y, y_ref):
    y_ref = np.asarray(y_ref)
    assert y.shape == y_ref.shape
    assert np.max(np.abs(y - y_ref), initial=0.0) <= 2e-5 * max(
        1.0, float(np.max(np.abs(y_ref), initial=0.0)))


def _spgemm_bounded(a, b, c, *, bf16=False):
    assert sb.spgemm_err_over_bound(a, b, c, bf16=bf16) <= 1.0


def _same_csr(c, rc):
    assert (c.rows, c.cols) == (rc.rows, rc.cols)
    assert np.array_equal(c.offsets, rc.offsets) and np.array_equal(c.indices, rc.indices)
    _agree(c.vals, rc.vals)


@pytest.fixture(scope="module")
def uniform():
    return _f32(corpus.random_uniform(np.random.default_rng(0), 300, 0.02))


def test_corpus_generators_match_reference():
    for gen, args in (("random_uniform", (300, 0.01)), ("blocked", (512, 64, 0.05))):
        a = getattr(corpus, gen)(np.random.default_rng(3), *args)
        b = getattr(ref_corpus, "_" + gen)(np.random.default_rng(3), *args)
        for f in ("offsets", "indices", "vals"):
            assert np.array_equal(getattr(a, f), getattr(b, f))


def test_csr_new_and_to_dense(uniform):
    e = CsrMatrix.new(3, 5, dtype=np.float32)
    assert e.nnz() == 0 and e.offsets.shape == (4,) and e.vals.dtype == np.float32
    assert np.array_equal(uniform.to_dense(), _ref(uniform).to_dense())


@pytest.mark.parametrize("bs", [8, 32, 128])
def test_bsr_from_csr_matches_reference(uniform, bs):
    b = BsrMatrix.from_csr(uniform, bs)
    rb = ref_bcsr.BsrMatrix.from_csr(_ref(uniform), bs)
    for f in ("blocks", "block_cols", "block_offsets"):
        assert np.array_equal(getattr(b, f), getattr(rb, f)), f
        assert getattr(b, f).dtype == getattr(rb, f).dtype, f
    assert (b.brows, b.bcols, b.nnzb, b.block_density) == (rb.brows, rb.bcols, rb.nnzb,
                                                           rb.block_density)
    assert np.array_equal(b.block_rows_expanded(), rb.block_rows_expanded())
    back = b.to_csr()
    for f in ("offsets", "indices", "vals"):
        assert np.array_equal(getattr(back, f), getattr(uniform, f))


@pytest.mark.parametrize("bs", [8, 32, 128])
def test_block_pairs_plan_matches_reference(bs):
    a = corpus.blocked(np.random.default_rng(1), 384, 32, 0.1)
    b = _f32(corpus.random_uniform(np.random.default_rng(2), 384, 0.01))
    got = sb.block_pairs_plan(BsrMatrix.from_csr(a, bs), BsrMatrix.from_csr(b, bs))
    want = ref_sb.block_pairs_plan(ref_bcsr.BsrMatrix.from_csr(_ref(a), bs),
                                   ref_bcsr.BsrMatrix.from_csr(_ref(b), bs))
    for g, w in zip(got, want):
        assert np.array_equal(g, w) and g.dtype == w.dtype


def _with_empty_block_rows(rows, cols, seed):
    """Random entries in rows [0, 64) and [160, rows): block rows 2 and 3 at
    bs 32 hold nothing."""
    rng = np.random.default_rng(seed)
    r = rng.integers(0, rows - 96, 1500)
    r = np.where(r >= 64, r + 96, r)
    c = rng.integers(0, cols, 1500)
    return CsrMatrix.from_coo(rows, cols, r, c, rng.standard_normal(1500).astype(np.float32))


@pytest.mark.parametrize("bs", [32, 128])
@pytest.mark.parametrize("f", [1, 5, 130])
def test_spmm_bcsr_matches_reference(bs, f):
    m = _with_empty_block_rows(300, 270, bs)  # neither side a multiple of bs
    b = BsrMatrix.from_csr(m, bs)
    if bs == 32:
        assert np.any(np.diff(b.block_offsets) == 0)
    X = np.random.default_rng(f).standard_normal((m.cols, f)).astype(np.float32)
    Y = spmm.spmm_bcsr(b, torch.from_numpy(X)).numpy()
    assert Y.shape == (m.rows, f)
    _agree(Y, ref_spmm.spmm_bcsr(ref_bcsr.BsrMatrix.from_csr(_ref(m), bs), X))
    assert not Y[64:160].any()
    for q in range(f):
        y64, bound = spmv_f64_bound(m, X[:, q])
        assert np.all(np.abs(Y[:, q] - y64) <= bound)


def test_spmm_bcsr_refuses_bad_x(uniform):
    b = BsrMatrix.from_csr(uniform, 32)
    with pytest.raises(ValueError, match="x must be"):
        spmm.spmm_bcsr(b, torch.zeros(uniform.cols + 1, 2))
    with pytest.raises(TypeError, match="dtype"):
        spmm.spmm_bcsr(b, torch.zeros(uniform.cols, 2, dtype=torch.float64))


@pytest.mark.parametrize("bs", [32, 128])
def test_spgemm_block_pad_device_live_prefix(uniform, bs):
    p = sb.spgemm_block_pad_device(uniform, uniform, device="cpu", bs=bs)
    rp = ref_sb.spgemm_block_pad_device(_ref(uniform), _ref(uniform), bs=bs)
    n = int(p.nnz)
    assert n == int(rp.nnz) and (p.rows, p.cols) == (rp.rows, rp.cols)
    assert p.row.dtype == p.col.dtype == torch.int32
    assert np.array_equal(p.row[:n].numpy(), np.asarray(rp.row)[:n])
    assert np.array_equal(p.col[:n].numpy(), np.asarray(rp.col)[:n])
    _agree(p.val[:n].numpy(), np.asarray(rp.val)[:n])
    assert torch.all(p.row[n:] == uniform.rows) and not p.val[n:].any()


@pytest.mark.parametrize("bs", [32, 128])
def test_spgemm_block_device_matches_reference(bs):
    a = _f32(corpus.blocked(np.random.default_rng(4), 448, 64, 0.05))
    b = _f32(corpus.random_uniform(np.random.default_rng(5), 448, 0.01))
    c = sb.spgemm_block_device(a, b, device="cpu", bs=bs)
    _same_csr(c, ref_sb.spgemm_block_device(_ref(a), _ref(b), bs=bs))
    _spgemm_bounded(a, b, c)


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("bs", [32, 128])
def test_block_spgemm_matches_reference(uniform, storage, bs):
    eng = sb.BlockSpgemm(uniform, uniform, device="cpu", bs=bs, storage=storage)
    ref = ref_sb.BlockSpgemm(_ref(uniform), _ref(uniform), bs=bs, storage=storage)
    assert eng.num_pairs == ref.num_pairs and np.array_equal(eng.c_keys, ref.c_keys)
    assert eng.a_blocks.dtype == (torch.bfloat16 if storage == "bf16" else torch.float32)
    c = eng.multiply()
    _same_csr(c, ref.multiply())
    _spgemm_bounded(uniform, uniform, c, bf16=storage == "bf16")
    blocks = eng.multiply_device()
    assert blocks.shape == (len(eng.c_keys), bs, bs) and blocks.dtype == torch.float32


def test_spgemm_cancellation_drops_the_entry():
    # C[0, 0] = 1*1 + 1*(-1) = 0 exactly: the zero is not kept
    a = CsrMatrix.from_coo(4, 4, [0, 0, 1], [0, 1, 1], np.array([1.0, 1.0, 2.0], np.float32))
    b = CsrMatrix.from_coo(4, 4, [0, 1, 1], [0, 0, 2], np.array([1.0, -1.0, 3.0], np.float32))
    for c in (sb.spgemm_block_device(a, b, device="cpu", bs=16),
              sb.BlockSpgemm(a, b, device="cpu", bs=16).multiply()):
        _same_csr(c, ref_sb.spgemm_block_device(_ref(a), _ref(b), bs=16))
        assert c.nnz() == 3 and 0 not in c.indices[c.offsets[0]:c.offsets[1]]
        _spgemm_bounded(a, b, c)


def test_spgemm_empty_pairs():
    # A's only column block meets an empty B block row: no pair at all
    a = CsrMatrix.from_coo(64, 64, [0, 5], [40, 41], np.ones(2, np.float32))
    b = CsrMatrix.from_coo(64, 64, [1, 2], [3, 4], np.ones(2, np.float32))
    p = sb.spgemm_block_pad_device(a, b, device="cpu", bs=32)
    assert int(p.nnz) == 0 and p.row.numel() == 0 and (p.rows, p.cols) == (64, 64)
    c = sb.spgemm_block_device(a, b, device="cpu", bs=32)
    assert c.nnz() == 0 and c.offsets.shape == (65,)
    eng = sb.BlockSpgemm(a, b, device="cpu", bs=32)
    assert eng.num_pairs == 0 and eng.multiply_device().shape == (0, 32, 32)
    assert eng.multiply().nnz() == 0
    with pytest.raises(ValueError, match="LHS cols"):
        sb.BlockSpgemm(a, CsrMatrix.new(32, 8), device="cpu")


def test_spgemm_err_over_bound_catches_faults(uniform):
    c = sb.spgemm_block_device(uniform, uniform, device="cpu", bs=32)
    assert sb.spgemm_err_over_bound(uniform, uniform, c) <= 1.0
    worse = CsrMatrix(c.rows, c.cols, c.vals * np.float32(1 + 1e-4), c.indices, c.offsets,
                      is_sorted=True)
    assert sb.spgemm_err_over_bound(uniform, uniform, worse) > 1.0
    keep = np.ones(c.nnz(), bool)
    keep[np.argmax(np.abs(c.vals))] = False  # a dropped entry
    dropped = CsrMatrix.from_coo(c.rows, c.cols, c.row_ids()[keep], c.indices[keep],
                                 c.vals[keep])
    assert sb.spgemm_err_over_bound(uniform, uniform, dropped) > 1.0
    extra = CsrMatrix.from_coo(c.rows, c.cols, np.r_[c.row_ids(), 0], np.r_[c.indices, 0],
                               np.r_[c.vals, np.float32(1.0)])
    if extra.nnz() > c.nnz():  # (0, 0) outside the structural product
        assert sb.spgemm_err_over_bound(uniform, uniform, extra) == float("inf")


def test_spgemm_dense_matches_reference(uniform):
    c = sb.spgemm_dense(uniform, uniform, device="cpu")
    _same_csr(c, ref_sb.spgemm_dense_xla(_ref(uniform), _ref(uniform)))
    _spgemm_bounded(uniform, uniform, c)



# ---------------------------------------------------------------------------
# The live-depth streams of the block kernels (B11 block SpGEMM, B10 BCSR
# SpMM). On the card the kernels walk these streams; here their plain
# evaluations (float64, rounded once) are held to the dense float64 plain
# versions within 1 f32 ulp per entry, NaN exactly where the dense product
# has one: dropping a depth index never changes a result. The streams
# themselves are held array-equal to the drop rule written out per pair in
# numpy.
# ---------------------------------------------------------------------------


def _within_ulp(got, want):
    got, want = got.numpy(), want.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    assert np.array_equal(np.isnan(got), np.isnan(want))
    ok = (got == want) | (np.abs(got.astype(np.float64) - want) <= np.spacing(np.abs(want)))
    assert ok[~np.isnan(want)].all()


def _dropped(a_col, b_row):
    """The drop rule per depth index: every term is an exact zero."""
    return ((~a_col.any(-1) & np.isfinite(b_row).all(-1))
            | (~b_row.any(-1) & np.isfinite(a_col).all(-1)))


def _tiles(bs):
    """The kernels' BLOCK_TILE-wide output tiles of a block, as slices."""
    return [slice(lo, min(lo + BLOCK_TILE, bs)) for lo in range(0, bs, BLOCK_TILE)]


def _stream_of(parts, counts):
    rows = np.concatenate(parts) if parts else np.zeros((0, 2), np.int64)
    return rows, np.concatenate(([0], np.cumsum(counts))).astype(np.int64)


def _expected_spgemm_stream(eng):
    """The B11 stream of ``eng``, C block by C block, output tile by output
    tile, pair by pair in numpy: (rows, offsets)."""
    bs = eng.bs
    a_t = eng.a_blocks_t.float().numpy()
    b = eng.b_blocks.float().numpy()
    pa, pb, pc = (t.numpy().astype(np.int64) for t in (eng.pair_a, eng.pair_b, eng.pair_c))
    parts, counts = [], []
    for q in range(len(eng.c_keys)):
        pairs = np.nonzero(pc == q)[0]
        for rows_t in _tiles(bs):
            for cols_t in _tiles(bs):
                n = 0
                for p in pairs:
                    k = np.nonzero(~_dropped(a_t[pa[p]][:, rows_t], b[pb[p]][:, cols_t]))[0]
                    parts.append(np.stack((pa[p] * bs + k, pb[p] * bs + k), 1))
                    n += k.size
                counts.append(n)
    return _stream_of(parts, counts)


def _stream_equal(stream, offsets, want_rows, want_offsets):
    assert stream.dtype == offsets.dtype == torch.int32 and stream.shape == want_rows.shape
    assert np.array_equal(stream.numpy(), want_rows)
    assert np.array_equal(offsets.numpy(), want_offsets)


_STREAM_MATRICES = {
    "uniform": lambda: _f32(corpus.random_uniform(np.random.default_rng(6), 320, 0.02)),
    "blocked": lambda: _f32(corpus.blocked(np.random.default_rng(7), 384, 32, 0.05)),
}


@pytest.mark.parametrize("storage", ["f32", "bf16"])
@pytest.mark.parametrize("bs", [16, 32, 128])
@pytest.mark.parametrize("name", list(_STREAM_MATRICES))
def test_block_depth_stream_matches_dense(name, bs, storage):
    m = _STREAM_MATRICES[name]()
    eng = sb.BlockSpgemm(m, m, device="cpu", bs=bs, storage=storage)
    num_c = len(eng.c_keys)
    assert eng.a_blocks_t.is_contiguous()
    assert torch.equal(eng.a_blocks, eng.a_blocks_t.transpose(1, 2))
    _stream_equal(eng.depth_stream, eng.depth_offsets, *_expected_spgemm_stream(eng))
    # the stream skips depth: less work than the dense block products
    assert eng.live_flops() < 2.0 * eng.num_pairs * bs ** 3
    dense = sb._block_numeric_torch(eng.a_blocks, eng.b_blocks, eng.pair_a, eng.pair_b,
                                    eng.pair_c, num_c=num_c, bs=bs)
    got = sb._stream_numeric_torch(eng.a_blocks_t, eng.b_blocks, eng.depth_stream,
                                   eng.depth_offsets, num_c=num_c, bs=bs)
    _within_ulp(got, dense)
    _within_ulp(eng.multiply_device(), dense)


@pytest.mark.parametrize("chunk", [1, 3, 1 << 14])
def test_block_depth_stream_is_the_same_in_pair_chunks(monkeypatch, chunk):
    # the plan takes the pairs _STREAM_PAIR_CHUNK at a time; the stream and
    # its offsets do not depend on the chunk
    m = _STREAM_MATRICES["uniform"]()
    monkeypatch.setattr(sb, "_STREAM_PAIR_CHUNK", chunk)
    eng = sb.BlockSpgemm(m, m, device="cpu", bs=32)
    assert eng.num_pairs > 3
    _stream_equal(eng.depth_stream, eng.depth_offsets, *_expected_spgemm_stream(eng))


def test_block_depth_stream_pair_with_empty_live_depth():
    # one C block, two pairs: A's block (0, 0) uses columns 0..7 only and
    # B's block (0, 0) rows 8..15 only (no live depth); the pair through
    # block column 1 meets on depth 3 alone
    a = CsrMatrix.from_coo(16, 32, [0, 5, 9, 2], [1, 7, 19, 19],
                           np.array([1.0, 2.0, 3.0, -1.0], np.float32))
    b = CsrMatrix.from_coo(32, 16, [8, 15, 19, 30], [0, 4, 2, 9],
                           np.array([1.0, 1.0, 4.0, 5.0], np.float32))
    eng = sb.BlockSpgemm(a, b, device="cpu", bs=16)
    assert eng.num_pairs == 2 and len(eng.c_keys) == 1
    _stream_equal(eng.depth_stream, eng.depth_offsets, *_expected_spgemm_stream(eng))
    assert eng.depth_stream.numpy().tolist() == [[16 + 3, 16 + 3]]
    c = eng.multiply()
    assert c.to_dense().tolist() == (a.to_dense() @ b.to_dense()).tolist()
    _within_ulp(sb._stream_numeric_torch(eng.a_blocks_t, eng.b_blocks, eng.depth_stream,
                                         eng.depth_offsets, num_c=1, bs=16),
                eng.multiply_device())
    # with B's row 19 gone the C block's stream is empty: the block is zeros
    b2 = CsrMatrix.from_coo(32, 16, [8, 15, 30], [0, 4, 9], np.ones(3, np.float32))
    eng2 = sb.BlockSpgemm(a, b2, device="cpu", bs=16)
    assert eng2.num_pairs == 2 and eng2.depth_offsets.tolist() == [0, 0]
    assert eng2.depth_stream.shape == (0, 2)
    assert not sb._stream_numeric_torch(eng2.a_blocks_t, eng2.b_blocks, eng2.depth_stream,
                                        eng2.depth_offsets, num_c=1, bs=16).any()
    assert eng2.multiply().nnz() == 0


def test_block_depth_stream_empty_pairs():
    a = CsrMatrix.from_coo(64, 64, [0, 5], [40, 41], np.ones(2, np.float32))
    b = CsrMatrix.from_coo(64, 64, [1, 2], [3, 4], np.ones(2, np.float32))
    eng = sb.BlockSpgemm(a, b, device="cpu", bs=32)
    assert eng.depth_stream.shape == (0, 2) and eng.depth_stream.dtype == torch.int32
    assert eng.depth_offsets.tolist() == [0]
    got = sb._stream_numeric_torch(eng.a_blocks_t, eng.b_blocks, eng.depth_stream,
                                   eng.depth_offsets, num_c=0, bs=32)
    assert got.shape == (0, 32, 32) and got.dtype == torch.float32


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_block_depth_stream_keeps_nonfinite_terms(storage):
    # B row 5 holds an inf facing A's all-zero column 5: 0 * inf is NaN, so
    # depth 5 stays and C's column 3 is NaN in every row; A's column 9
    # holds a NaN facing B's all-zero row 9: C's row 7 is NaN
    inf, nan = np.float32(np.inf), np.float32(np.nan)
    a = CsrMatrix.from_coo(16, 16, [0, 3, 7], [1, 2, 9], np.array([1.0, 2.0, nan], np.float32))
    b = CsrMatrix.from_coo(16, 16, [1, 2, 5], [0, 6, 3], np.array([1.0, 3.0, inf], np.float32))
    eng = sb.BlockSpgemm(a, b, device="cpu", bs=16, storage=storage)
    _stream_equal(eng.depth_stream, eng.depth_offsets, *_expected_spgemm_stream(eng))
    assert sorted(eng.depth_stream[:, 0].tolist()) == [1, 2, 5, 9]
    dense = sb._block_numeric_torch(eng.a_blocks, eng.b_blocks, eng.pair_a, eng.pair_b,
                                    eng.pair_c, num_c=1, bs=16)
    nan_at = np.zeros((16, 16), bool)
    nan_at[:, 3] = nan_at[7, :] = True
    assert np.array_equal(np.isnan(dense[0].numpy()), nan_at)
    got = sb._stream_numeric_torch(eng.a_blocks_t, eng.b_blocks, eng.depth_stream,
                                   eng.depth_offsets, num_c=1, bs=16)
    _within_ulp(got, dense)
    # dropping depth 5 (the finite-only rule) would lose the NaN column
    kept = eng.depth_stream[eng.depth_stream[:, 0] != 5].contiguous()
    lost = sb._stream_numeric_torch(eng.a_blocks_t, eng.b_blocks, kept,
                                    torch.tensor([0, kept.shape[0]], dtype=torch.int32),
                                    num_c=1, bs=16)
    assert not np.array_equal(np.isnan(lost.numpy()), np.isnan(dense.numpy()))


def _expected_bcsr_stream(arrs):
    """The B10 stream, block row by block row, row tile by row tile, block
    by block in numpy: (rows, offsets)."""
    blocks_t = arrs["blocks_t"].numpy()
    bs = blocks_t.shape[-1]
    cols = arrs["block_cols"].numpy().astype(np.int64)
    off = arrs["block_offsets"].numpy()
    parts, counts = [], []
    for br in range(off.size - 1):
        for rows_t in _tiles(bs):
            n = 0
            for p in range(off[br], off[br + 1]):
                k = np.nonzero(blocks_t[p][:, rows_t].any(-1))[0]
                parts.append(np.stack((p * bs + k, cols[p] * bs + k), 1))
                n += k.size
            counts.append(n)
    return _stream_of(parts, counts)


def _padded_x(b, x_np):
    fpad = max(128, -(-x_np.shape[1] // 128) * 128)
    xf = torch.zeros((b.bcols * b.bs, fpad))
    xf[: x_np.shape[0], : x_np.shape[1]] = torch.from_numpy(x_np)
    return xf


@pytest.mark.parametrize("x_finite", [True, False])
@pytest.mark.parametrize("bs", [16, 32, 128])
@pytest.mark.parametrize("name", list(_STREAM_MATRICES))
def test_bcsr_depth_stream_matches_dense(name, bs, x_finite):
    m = _STREAM_MATRICES[name]()
    b = BsrMatrix.from_csr(m, bs)
    arrs = spmm.bcsr_device_arrays(b, "cpu")
    assert arrs["blocks_t"].is_contiguous()
    assert torch.equal(arrs["blocks"], torch.from_numpy(b.blocks))
    _stream_equal(arrs["stream"], arrs["stream_offsets"], *_expected_bcsr_stream(arrs))
    assert spmm.bcsr_live_flops(arrs, 1) < 2.0 * b.nnzb * bs ** 2
    xf = _padded_x(b, np.random.default_rng(bs).standard_normal((m.cols, 3)).astype(np.float32))
    dense = spmm._bcsr_torch(arrs, xf.reshape(b.bcols, bs, -1), brows=b.brows)
    got = spmm._bcsr_stream_torch(arrs, xf, brows=b.brows, x_finite=x_finite)
    _within_ulp(got, dense.reshape(b.brows * bs, -1))


def test_bcsr_depth_stream_needs_finite_x():
    # block (0, 0) column 5 is all zero; x row 5 holds an inf: the dense
    # product's block row 0 is NaN in that column, which only the full
    # walk (x_finite down) reproduces
    m = CsrMatrix.from_coo(32, 32, [0, 3, 20], [1, 2, 5], np.array([1.0, 2.0, 3.0], np.float32))
    b = BsrMatrix.from_csr(m, 16)
    arrs = spmm.bcsr_device_arrays(b, "cpu")
    _stream_equal(arrs["stream"], arrs["stream_offsets"], *_expected_bcsr_stream(arrs))
    x_np = np.ones((32, 2), np.float32)
    x_np[5, 1] = np.inf
    xf = _padded_x(b, x_np)
    dense = spmm._bcsr_torch(arrs, xf.reshape(b.bcols, 16, -1), brows=b.brows).reshape(32, -1)
    assert torch.isnan(dense[:16, 1]).all() and not torch.isnan(dense[:, 0]).any()
    assert torch.isinf(dense[20, 1]) and torch.isnan(dense[16:20, 1]).all()  # 3 * inf
    _within_ulp(spmm._bcsr_stream_torch(arrs, xf, brows=b.brows, x_finite=False), dense)
    live = spmm._bcsr_stream_torch(arrs, xf, brows=b.brows, x_finite=True)
    assert not torch.isnan(live[:16, 1]).any()
    y = spmm.spmm_bcsr(b, torch.from_numpy(x_np))
    _within_ulp(y, dense[:, :2].contiguous())


@pytest.mark.parametrize("bs", [32, 128])
def test_depth_streams_keep_every_row_of_dense_blocks(bs):
    # every entry of every block stored: no depth index is dropped anywhere,
    # and the work is the dense block products'
    m = corpus.dense_block_tridiagonal(np.random.default_rng(bs), 4 * bs, bs)
    assert m.nnz() == 10 * bs * bs
    eng = sb.BlockSpgemm(m, m, device="cpu", bs=bs)
    _stream_equal(eng.depth_stream, eng.depth_offsets, *_expected_spgemm_stream(eng))
    assert eng.live_flops() == 2.0 * eng.num_pairs * bs ** 3
    _within_ulp(sb._stream_numeric_torch(eng.a_blocks_t, eng.b_blocks, eng.depth_stream,
                                         eng.depth_offsets, num_c=len(eng.c_keys), bs=bs),
                eng.multiply_device())
    arrs = spmm.bcsr_device_arrays(BsrMatrix.from_csr(m, bs), "cpu")
    assert spmm.bcsr_live_flops(arrs, 128) == 2.0 * 10 * bs ** 2 * 128


def test_spmm_bcsr_takes_an_aligned_x_as_is():
    # cols a multiple of bs and F of 128: X goes to the kernel unpadded
    m = _f32(corpus.blocked(np.random.default_rng(8), 256, 32, 0.1))
    b = BsrMatrix.from_csr(m, 32)
    X = torch.from_numpy(np.random.default_rng(9).standard_normal((256, 128)).astype(np.float32))
    Y = spmm.spmm_bcsr(b, X)
    _within_ulp(Y[:, :127].contiguous(), spmm.spmm_bcsr(b, X[:, :127].contiguous()))
    for q in (0, 127):
        y64, bound = spmv_f64_bound(m, X[:, q].numpy())
        assert np.all(np.abs(Y[:, q].numpy() - y64) <= bound)


def test_spmm_bcsr_copies_a_misaligned_x():
    # the kernel copies X in 16-byte pieces: a view of the kernel's shape that
    # starts 4 bytes into its buffer is copied into an aligned one (and the
    # wrappers' alignment check refuses it); an aligned X is taken as is
    m = _f32(corpus.blocked(np.random.default_rng(8), 256, 32, 0.1))
    b = BsrMatrix.from_csr(m, 32)
    X = torch.from_numpy(np.random.default_rng(9).standard_normal((256, 128)).astype(np.float32))
    xm = torch.zeros(X.numel() + 1)[1:].view(256, 128).copy_(X)
    assert xm.is_contiguous() and xm.data_ptr() % 16
    xf = spmm._kernel_x(b, xm)
    assert xf.data_ptr() != xm.data_ptr() and xf.data_ptr() % 16 == 0 and torch.equal(xf, X)
    assert spmm._kernel_x(b, X) is X
    with pytest.raises(ValueError, match="x must be 16-byte aligned"):
        kernels._check_aligned("bcsr_spmm", 16, x=xm)
    kernels._check_aligned("bcsr_spmm", 16, x=X)
    assert torch.equal(spmm.spmm_bcsr(b, xm), spmm.spmm_bcsr(b, X))
