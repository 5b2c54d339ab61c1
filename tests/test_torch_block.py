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
