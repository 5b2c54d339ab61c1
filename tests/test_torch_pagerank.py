"""PageRank and the CSR-row format on the CPU.

``solvers/pagerank.py`` through the dispatched operator against the plain
reference (``reference/pagerank.py``) on Kronecker graphs (the benchmark's
generator, ``bench/kron.py``, held to a plain numpy rendering of its hash
rule) and on a graph small enough to
rank by hand; the CSR-row format's plain version (``ops/spmv_csr.py``, the
kernel's order) against float64 on rows of every awkward length; the skew
test of the dispatch, which sends Kronecker graphs to ``csr`` and leaves
every other configuration's format as it was; the DIA probe's sampled
pre-filter, whose plans stay the reference's byte for byte.
"""

from __future__ import annotations

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sparse_matrix_tpu.formats import csr as ref_csr  # noqa: E402
from sparse_matrix_tpu.formats import dia as ref_dia  # noqa: E402
from sparse_matrix_tpu_torch.bench import corpus, kron  # noqa: E402
from sparse_matrix_tpu_torch.formats.csr import CsrMatrix  # noqa: E402
from sparse_matrix_tpu_torch.formats.dia import try_dia_from_csr  # noqa: E402
from sparse_matrix_tpu_torch.ops import spmv_csr  # noqa: E402
from sparse_matrix_tpu_torch.ops.operator import (  # noqa: E402
    SpmvOperator,
    load_operator_plan,
    save_operator_plan,
    skewed_rows,
)
from sparse_matrix_tpu_torch.ops.spmv import spmv_f64_bound  # noqa: E402
from sparse_matrix_tpu_torch.reference import pagerank as ref  # noqa: E402
from sparse_matrix_tpu_torch.solvers.amg import amg_setup  # noqa: E402
from sparse_matrix_tpu_torch.solvers.pagerank import pagerank  # noqa: E402
from sparse_matrix_tpu_torch.solvers.hpcg import hpcg_problem  # noqa: E402
from sparse_matrix_tpu_torch.solvers.poisson import poisson_2d_csr  # noqa: E402

KRON = dict(edgefactor=16, a=0.57, b=0.19, c=0.19)


def _program(c, dtype=np.float32) -> CsrMatrix:
    """``c`` with its values in ``dtype``."""
    return CsrMatrix(c.rows, c.cols, c.vals.astype(dtype), c.indices, c.offsets, is_sorted=True)


def _kron(scale: int, seed: int = 0) -> CsrMatrix:
    return kron.kronecker(np.random.default_rng(seed), scale=scale, device="cpu", **KRON)


def _graph(m: CsrMatrix):
    return torch.from_numpy(m.offsets), torch.from_numpy(m.indices.view(np.int32))


def _csr(rows, cols, lens, seed):
    """A matrix with the given row lengths, sorted distinct random columns
    and standard normal values."""
    rng = np.random.default_rng(seed)
    c = [np.sort(rng.choice(cols, n, replace=False)) for n in lens]
    offsets = np.zeros(rows + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    c = np.concatenate(c) if c else np.zeros(0, np.int64)
    return CsrMatrix(rows, cols, rng.standard_normal(len(c)).astype(np.float32),
                     c.astype(np.uint32), offsets, is_sorted=True)


def _rows_case(name):
    n = 7000 if name == "tile_edges" else 3000
    lens = np.zeros(n, np.int64)
    if name == "empty_one_full":
        lens[1], lens[2] = 1, n  # a row of length 0, one of 1, one holding every column
    elif name == "tile_edges":
        t = spmv_csr.TILE
        lens[5:12] = [t - 1, t, t + 1, 2 * t - 7, 1, 0, 3 * t + 5]
        lens[12:] = np.random.default_rng(3).integers(0, 4, n - 12)
    elif name == "hub_across_tiles":
        lens[:] = np.random.default_rng(4).integers(0, 3, n)
        lens[1500] = n  # spans several tiles among short rows
        lens[2999] = 2500  # the last row crosses a tile edge
    elif name == "no_entries":
        pass
    return _csr(n, n, lens, {"empty_one_full": 1, "tile_edges": 2, "hub_across_tiles": 3,
                             "no_entries": 4}[name])


# -- the Kronecker generator ----------------------------------------------


def _numpy_kron(rng, scale, edgefactor, a, b, c):
    """GAP's MakeKronEL and squish on uint64 numpy arrays, one level at a
    time with the generator's hash and constants, the duplicates dropped
    through a set of pairs."""
    m32 = np.uint64(0xFFFFFFFF)

    def mix(h):
        h = h ^ (h >> np.uint64(16))
        h = (h * np.uint64(kron.MUL1)) & m32
        h = h ^ (h >> np.uint64(15))
        h = (h * np.uint64(kron.MUL2)) & m32
        return h ^ (h >> np.uint64(16))

    s0, s1, s2, s3 = (np.uint64(s) for s in rng.integers(0, 1 << 32, size=4, dtype=np.uint64))
    n, m = 1 << scale, edgefactor << scale
    t_a, t_ab, t_abc = (np.uint64(int(p * 2.0 ** 32)) for p in (a, a + b, a + b + c))
    he = mix((np.arange(m, dtype=np.uint64) + s0) & m32)
    src = np.zeros(m, np.uint64)
    dst = np.zeros(m, np.uint64)
    for level in range(scale):
        u = mix(he ^ ((s1 + np.uint64(level * kron.GOLDEN)) & m32))
        row = u >= t_ab
        col = np.where(row, u > t_abc, u > t_a)
        src = (src << np.uint64(1)) | row.astype(np.uint64)
        dst = (dst << np.uint64(1)) | col.astype(np.uint64)
    v = np.arange(n, dtype=np.uint64)
    key = (mix((v + s2) & m32) << np.uint64(31)) | (mix((v ^ s3) & m32) >> np.uint64(1))
    perm = np.argsort(key, kind="stable")
    pairs = set()
    for x, y in zip(perm[src.astype(np.int64)].tolist(), perm[dst.astype(np.int64)].tolist()):
        if x != y:
            pairs |= {(x, y), (y, x)}
    r, cc = (np.array(t, np.int64) for t in zip(*sorted(pairs)))
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(r, minlength=n), out=offsets[1:])
    return offsets, cc.astype(np.uint32)


@pytest.mark.parametrize("scale,seed", [(8, 0), (8, 2**33 + 9), (5, 7)])
def test_kronecker_equals_numpy_rendering(scale, seed):
    g = kron.kronecker(np.random.default_rng(seed), scale=scale, device="cpu", **KRON)
    offsets, cols = _numpy_kron(np.random.default_rng(seed), scale, **KRON)
    np.testing.assert_array_equal(g.offsets, offsets)
    np.testing.assert_array_equal(g.indices, cols)
    assert g.indices.dtype == np.uint32 and g.offsets.dtype == np.int64
    assert g.vals.dtype == np.float32 and np.all(g.vals == 1)


def test_kronecker_squishes():
    """No self-loops, no duplicates, symmetric, rows sorted, ids permuted
    (the hubs are not the low ids GAP's unpermuted generator favours)."""
    g = _kron(11, seed=3)
    rows = g.row_ids()
    cols = g.indices.astype(np.int64)
    assert not np.any(rows == cols)
    keys = rows * g.cols + cols
    assert np.all(np.diff(keys) > 0)  # sorted within and across rows, no duplicates
    assert np.array_equal(np.sort(cols * g.cols + rows), keys)  # symmetric
    deg = np.diff(g.offsets)
    assert 0.1 < np.mean(deg == 0) < 0.3  # isolated: 13 % at scale 10, 18 % at 12
    assert int(np.argmax(deg)) > 16


# -- the CSR-row format --------------------------------------------------


@pytest.mark.parametrize("name", ["empty_one_full", "tile_edges", "hub_across_tiles",
                                  "no_entries"])
def test_forced_csr_within_float32_bound(name):
    m = _rows_case(name)
    op = SpmvOperator(m, device="cpu", force="csr")
    assert op.format == "csr"
    x_np = np.random.default_rng(7).standard_normal(m.cols).astype(np.float32)
    x = torch.from_numpy(x_np)
    y = op(x)
    y64, bound = spmv_f64_bound(m, x_np)
    assert np.all(np.abs(y.numpy().astype(np.float64) - y64) <= bound)
    assert torch.equal(op(x), y)
    if name != "no_entries":
        assert op.part("csr").arrays["stripes"][0]["splits"].shape[0] > 0


@pytest.mark.parametrize("name", ["empty_one_full", "tile_edges", "hub_across_tiles"])
def test_forced_csr_pull_matches_reference(name):
    """Unit values: the operator's pull is the reference's pull."""
    m = _rows_case(name)
    m = CsrMatrix(m.rows, m.cols, np.ones(m.nnz(), np.float32), m.indices, m.offsets,
                  is_sorted=True)
    contrib = torch.from_numpy(np.random.default_rng(8).random(m.cols).astype(np.float32))
    offsets, cols = _graph(m)
    want = ref.pull(offsets, cols, contrib.double(), ref.row_blocks(offsets, 4096))
    got = SpmvOperator(m, device="cpu", force="csr")(contrib).double()
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("name", ["kron13", "tile_edges", "hub_across_tiles", "no_entries"])
@pytest.mark.parametrize("tiles_per_pass", [1, 3, 64])
def test_plain_version_in_passes_gives_the_same_bits(name, tiles_per_pass):
    """The plain version run a range of tiles at a time (as the card runs
    it on a graph of a billion entries) gives the bits of one pass."""
    if name == "kron13":
        g = _kron(13, seed=13)
        m = CsrMatrix(g.rows, g.cols,
                      np.random.default_rng(5).standard_normal(g.nnz()).astype(np.float32),
                      g.indices, g.offsets, is_sorted=True)
    else:
        m = _rows_case(name)
    arrs = SpmvOperator(m, device="cpu", force="csr").part("csr").arrays
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(m.cols).astype(np.float32))
    want = spmv_csr._csr_merge_torch(arrs, x)
    assert torch.equal(spmv_csr._csr_merge_torch(arrs, x, tiles_per_pass=tiles_per_pass), want)


def test_merge_path_tiles_and_splits():
    """Every tile holds TILE items of the path (the last the rest), and the
    split rows are exactly the rows whose entries two tiles share."""
    m = _rows_case("hub_across_tiles")
    offsets = torch.from_numpy(m.offsets)
    coords, splits = spmv_csr.merge_path(offsets)
    items = coords.sum(1)
    assert int(items[-1]) == m.rows + m.nnz()
    assert torch.all(items[1:-1] - items[:-2] == spmv_csr.TILE)
    # row i's entries lie at path items offsets[i] + i .., its end at
    # offsets[i + 1] + i: a row is split where its first entry and its end
    # lie in different tiles
    ar = torch.arange(m.rows)
    entry_tile = (offsets[:-1] + ar) // spmv_csr.TILE
    end_tile = (offsets[1:] + ar) // spmv_csr.TILE
    lens = offsets[1:] - offsets[:-1]
    want = torch.nonzero((lens > 0) & (entry_tile < end_tile)).flatten()
    assert want.numel() >= 3
    assert torch.equal(splits[:, 0], want)
    assert torch.equal(splits[:, 2], end_tile[want])
    # the first tile whose carry is the row's: the row pointer reaches it
    # at that tile's end and not before
    first = splits[:, 1]
    assert torch.all(first <= entry_tile[want])
    assert torch.all(coords[first + 1, 0] == want)
    assert torch.all((first == 0) | (coords[first, 0] < want))


def test_csr_plan_file_round_trip(tmp_path):
    m = _kron(10)
    op = SpmvOperator(m, device="cpu")
    save_operator_plan(op, str(tmp_path / "plan.npz"))
    back = load_operator_plan(str(tmp_path / "plan.npz"), "cpu")
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(m.cols).astype(np.float32))
    assert back.format == "csr" and torch.equal(back(x), op(x))
    assert back.bytes_per_apply() == op.bytes_per_apply()


# -- column stripes --------------------------------------------------------

#: sha256 of the CSR-row format's y on two Kronecker graphs (``_kron13``'s
#: recipe at scales 11 and 13) as the format gave it before it had stripes:
#: a one-stripe plan keeps those bits
UNSTRIPED_BITS = {
    11: "4ad3628a681ce4d788338e9c7d10dd7de90a8671adf327aaadf077bee5ba689b",
    13: "3fba6fced3b03012cfc88b4d66c48be9f51a6df777d75d3a21b9103d7c213526",
}


def _kron_values(scale: int) -> CsrMatrix:
    """GAP's Kronecker graph at ``scale`` (seeded by it) with standard
    normal values."""
    g = _kron(scale, seed=scale)
    return CsrMatrix(g.rows, g.cols,
                     np.random.default_rng(5).standard_normal(g.nnz()).astype(np.float32),
                     g.indices, g.offsets, is_sorted=True)


def _stripe_case(name):
    """``(matrix, stripe width)``: a Kronecker graph in 8 stripes; a stripe
    no entry falls in; a hub row across every stripe among short rows, 12
    stripes, the last narrower; rows each inside one stripe; row lengths
    across the tiles' shares with ``ncols`` no multiple of the width; a
    matrix with no entries."""
    if name == "kron13":
        m = _kron_values(13)
        return m, m.cols // 8
    if name == "hub_every_stripe":
        return _rows_case("hub_across_tiles"), 256
    if name == "ragged_width":
        return _rows_case("tile_edges"), 1024
    if name == "no_entries":
        return _rows_case("no_entries"), 500
    n, width = 3000, 500
    rng = np.random.default_rng(6)
    lens = rng.integers(0, 7, n)
    if name == "empty_stripe":  # no column in [1000, 1500)
        pool = np.r_[0:1000, 1500:n]
        cols = [np.sort(rng.choice(pool, k, replace=False)) for k in lens]
    else:  # "rows_in_one_stripe": row i's columns in stripe i % 6
        cols = [np.sort(rng.choice(width, k, replace=False)) + width * (i % 6)
                for i, k in enumerate(lens)]
    offsets = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    c = np.concatenate(cols)
    return CsrMatrix(n, n, rng.standard_normal(len(c)).astype(np.float32), c.astype(np.uint32),
                     offsets, is_sorted=True), width


STRIPE_CASES = ["kron13", "empty_stripe", "hub_every_stripe", "rows_in_one_stripe",
                "ragged_width", "no_entries"]


@pytest.mark.parametrize("ncols,itemsize,l2,width,stripes", [
    (1 << 25, 4, 50 << 20, 1 << 22, 8),  # kron25's x, 134 MB, on an H100
    (1 << 25, 8, 50 << 20, 1 << 21, 16),  # the same x in float64
    (1 << 25, 4, 40 << 20, 3_355_456, 10),
    (1 << 20, 4, 50 << 20, 1 << 20, 1),  # kron20's x, 4 MB, fits
    (1 << 16, 4, 50 << 20, 1 << 16, 1),
    (1000, 4, 12_000, 1000, 1),  # exactly the share
    (1001, 4, 12_000, 512, 2),
    (0, 4, 50 << 20, 1, 1),
])
def test_stripe_width_is_a_rule_of_x_and_l2(ncols, itemsize, l2, width, stripes):
    """One stripe where x fits a third of L2; else the fewest equal stripes
    whose slices fit, in whole 128-byte lines."""
    got = spmv_csr.stripe_width(ncols, itemsize, l2)
    assert got == width and max(1, -(-ncols // got)) == stripes
    if stripes > 1:
        assert got % 32 == 0
        assert (got - 32) * itemsize * spmv_csr.STRIPE_L2_DIV < l2


@pytest.mark.parametrize("scale", [11, 13])
def test_one_stripe_plan_is_the_csr_as_given(scale):
    """On a CPU device, and wherever the width covers every column, the
    plan is one stripe, the CSR as given with its merge path, and gives
    the bits the format gave before it had stripes."""
    m = _kron_values(scale)
    op = SpmvOperator(m, device="cpu", force="csr")
    assert op.part("csr").stripes == 1
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(m.cols).astype(np.float32))
    for arrs in (op.part("csr").arrays,
                 spmv_csr.csr_device_arrays(m, "cpu", _stripe_cols=m.cols),
                 spmv_csr.csr_device_arrays(m, "cpu", _stripe_cols=4 * m.cols)):
        (st,) = arrs["stripes"]
        assert st["row_ids"] is None
        assert np.array_equal(st["offsets"].numpy(), m.offsets)
        assert np.array_equal(st["cols"].numpy(), m.indices.view(np.int32))
        assert np.array_equal(st["vals"].numpy(), m.vals)
        coords, splits = spmv_csr.merge_path(st["offsets"])
        assert torch.equal(st["coords"], coords) and torch.equal(st["splits"], splits)
        y = spmv_csr.spmv_csr(m, x, device_arrays=arrs)
        assert hashlib.sha256(y.numpy().tobytes()).hexdigest() == UNSTRIPED_BITS[scale]


@pytest.mark.parametrize("name", STRIPE_CASES)
def test_stripes_partition_the_csr(name, monkeypatch):
    """Each stripe holds its columns' entries in row order: stripe 0 every
    row, each later stripe the rows with entries in it, ascending; together
    they hold the CSR's entries once. A build in passes of a few entries
    gives the same arrays; the bytes an apply streams are the stripes'."""
    m, width = _stripe_case(name)
    arrs = spmv_csr.csr_device_arrays(m, "cpu", _stripe_cols=width)
    stripes = arrs["stripes"]
    assert len(stripes) == -(-m.cols // width) > 1
    rows = torch.from_numpy(m.row_ids())
    want = {}
    for s, st in enumerate(stripes):
        lo, hi = s * width, min((s + 1) * width, m.cols)
        inside = (m.indices >= lo) & (m.indices < hi)
        r = rows[torch.from_numpy(inside)]
        lens = torch.bincount(r, minlength=m.rows)
        if s == 0:
            assert st["row_ids"] is None
            assert torch.equal(torch.diff(st["offsets"]), lens)
        else:
            ids = st["row_ids"].long()
            assert st["row_ids"].dtype == torch.int32
            assert torch.equal(ids, torch.nonzero(lens).flatten())
            assert torch.equal(torch.diff(st["offsets"]), lens[ids])
        assert int(st["offsets"][0]) == 0
        assert np.array_equal(st["cols"].numpy(), m.indices[inside].view(np.int32))
        assert np.array_equal(st["vals"].numpy(), m.vals[inside])
        coords, splits = spmv_csr.merge_path(st["offsets"])
        assert torch.equal(st["coords"], coords) and torch.equal(st["splits"], splits)
        want[s] = st
    assert spmv_csr.csr_stream_bytes(arrs) == sum(
        sum(int(st[k].nbytes) for k in ("offsets", "cols", "vals", "coords", "splits"))
        + (0 if st["row_ids"] is None else 4 * st["row_ids"].numel()) + 8 * st["coords"].shape[0]
        - 8 for st in stripes)
    monkeypatch.setattr(spmv_csr, "STRIPE_PASS_ENTRIES", 97)
    again = spmv_csr.csr_device_arrays(m, "cpu", _stripe_cols=width)["stripes"]
    for s, st in enumerate(again):
        assert st["carry"].shape == want[s]["carry"].shape  # scratch
        for k, t in st.items():
            if k != "carry":
                assert (t is None and want[s][k] is None) or torch.equal(t, want[s][k]), (s, k)


@pytest.mark.parametrize("name", STRIPE_CASES)
@pytest.mark.parametrize("tiles_per_pass", [1, 3, 64])
def test_striped_plain_version_in_passes_gives_the_same_bits(name, tiles_per_pass):
    m, width = _stripe_case(name)
    arrs = spmv_csr.csr_device_arrays(m, "cpu", _stripe_cols=width)
    x = torch.from_numpy(np.random.default_rng(9).standard_normal(m.cols).astype(np.float32))
    want = spmv_csr._csr_merge_torch(arrs, x)
    assert torch.equal(spmv_csr._csr_merge_torch(arrs, x, tiles_per_pass=tiles_per_pass), want)


@pytest.mark.parametrize("name", STRIPE_CASES)
def test_striped_plain_version_within_float32_bound(name):
    """The stripes' sum within the float32 bound of float64, the same bits
    on two calls, and a non-finite x only in the rows that read it."""
    m, width = _stripe_case(name)
    arrs = spmv_csr.csr_device_arrays(m, "cpu", _stripe_cols=width)
    x_np = np.random.default_rng(7).standard_normal(m.cols).astype(np.float32)
    x = torch.from_numpy(x_np)
    y = spmv_csr.spmv_csr(m, x, device_arrays=arrs)
    y64, bound = spmv_f64_bound(m, x_np)
    assert np.all(np.abs(y.numpy().astype(np.float64) - y64) <= bound)
    assert torch.equal(spmv_csr.spmv_csr(m, x, device_arrays=arrs), y)
    if m.nnz():
        c = int(m.indices[len(m.indices) // 2])
        x[c] = float("nan")
        readers = np.unique(m.row_ids()[m.indices == c])
        assert np.array_equal(np.flatnonzero(spmv_csr.spmv_csr(m, x, device_arrays=arrs).isnan()),
                              readers)


@pytest.mark.parametrize("name", ["kron13", "hub_every_stripe", "empty_stripe"])
def test_striped_pull_matches_reference(name):
    """Unit values: the striped pull is the reference's pull."""
    m, width = _stripe_case(name)
    m = CsrMatrix(m.rows, m.cols, np.ones(m.nnz(), np.float32), m.indices, m.offsets,
                  is_sorted=True)
    arrs = spmv_csr.csr_device_arrays(m, "cpu", _stripe_cols=width)
    contrib = torch.from_numpy(np.random.default_rng(8).random(m.cols).astype(np.float32))
    offsets, cols = _graph(m)
    want = ref.pull(offsets, cols, contrib.double(), ref.row_blocks(offsets, 4096))
    got = spmv_csr.spmv_csr(m, contrib, device_arrays=arrs).double()
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


# -- the dispatch --------------------------------------------------------


@pytest.mark.parametrize("scale", [12, 13, 14])
def test_kronecker_dispatches_to_csr(scale):
    m = _kron(scale, seed=scale)
    assert skewed_rows(m.offsets)
    op = SpmvOperator(m, device="cpu")
    assert op.format == "csr"
    plain_csr = 8 * m.nnz() + 8 * (m.rows + 1)  # f32 values, uint32 columns, int64 offsets
    assert op.bytes_per_apply() <= 1.1 * plain_csr


def _config_matrix(name):
    if name == "poisson2d_2048":
        return _program(poisson_2d_csr(40))
    if name == "femlike_262k":
        return _program(corpus.fem_like(np.random.default_rng(5), n_side=24, jitter=2))
    if name == "femlike_262k_dominant":
        fem = corpus.fem_like(np.random.default_rng(5), n_side=24, jitter=2)
        return _program(corpus.with_dominant_diagonal(fem))
    return _program(hpcg_problem(16, 16, 16)[0], np.float64)


@pytest.mark.parametrize("name,fmt", [("poisson2d_2048", "dia"), ("femlike_262k", "dia"),
                                      ("femlike_262k_dominant", "dia"), ("hpcg_104", "dia")])
def test_existing_configurations_keep_their_format(name, fmt):
    """Each configuration of the benchmark at its tiny size: no skew, the
    format it had."""
    m = _config_matrix(name)
    assert not skewed_rows(m.offsets)
    dtype = torch.float64 if m.vals.dtype == np.float64 else torch.float32
    assert SpmvOperator(m, device="cpu", dtype=dtype).format == fmt


def test_amg_levels_keep_their_formats():
    hier = amg_setup(poisson_2d_csr(256, dtype=np.float32), device="cpu")
    assert [(lv.a_op.format, lv.p_op.format, lv.pt_op.format) for lv in hier.levels[:-1]] + [
        (hier.levels[-1].a_op.format,)] == [("dia", "aligned", "aligned"),
                                            ("dia", "aligned", "lanepack"), ("hybrid",)]


def test_skew_test_reads_offsets_alone():
    """Long rows are longer than four times the mean and SKEW_LONG_MIN:
    a hyper-sparse matrix with a few rows of two entries is not skewed; a
    single full row beside a diagonal is."""
    n = 4096
    diag = np.arange(n + 1, dtype=np.int64)
    assert not skewed_rows(diag)
    lens = np.ones(n, np.int64)
    lens[7] = n
    assert skewed_rows(np.r_[0, np.cumsum(lens)])
    sparse = np.zeros(n, np.int64)
    sparse[::3] = 1
    sparse[::97] = 2
    assert not skewed_rows(np.r_[0, np.cumsum(sparse)])
    assert not skewed_rows(np.zeros(n + 1, np.int64))


# -- PageRank ------------------------------------------------------------


@pytest.mark.parametrize("scale", [8, 10, 12])
def test_pagerank_matches_reference(scale):
    m = _kron(scale, seed=100 + scale)
    op = SpmvOperator(m, device="cpu")
    if scale >= 10:
        assert op.format == "csr"
    deg = torch.diff(torch.from_numpy(m.offsets))
    res = pagerank(op, deg)
    want = ref.pagerank(*_graph(m), dtype=torch.float64)
    assert res.scores.dtype == torch.float32
    assert res.iterations == want.iterations
    s, r = res.scores.double(), want.scores
    assert float((s - r).abs().sum() / r.abs().sum()) <= 1e-6
    assert float(((s - r).abs() / r).max()) <= 1e-5


def test_pagerank_by_hand():
    """A star (0 with 1, 2, 3), a path (4 - 5 - 6) and an isolated vertex
    (7): the isolated vertex keeps the base score, each class of vertex
    (centre, leaf, path end, path middle) shares one score, and the scores
    follow the pull from uniform scores, iteration by iteration."""
    n, d = 8, 0.85
    edges = [(0, 1), (0, 2), (0, 3), (4, 5), (5, 6)]
    r = [a for a, b in edges] + [b for a, b in edges]
    c = [b for a, b in edges] + [a for a, b in edges]
    m = CsrMatrix.from_coo(n, n, r, c, np.ones(len(r), np.float32))
    deg = torch.diff(torch.from_numpy(m.offsets))
    res = pagerank(SpmvOperator(m, device="cpu", force="csr"), deg, damping=d, tol=1e-12,
                   maxiter=3)
    # by hand, in fractions of 1/8: iteration 1 moves the centre to
    # 0.15/8 + 0.85 * 3 * (1/8) / 1, a leaf to 0.15/8 + 0.85 * (1/8) / 3,
    # a path end to 0.15/8 + 0.85 * (1/8) / 2, the middle to
    # 0.15/8 + 0.85 * 2 * (1/8)
    s = {"centre": 1 / 8, "leaf": 1 / 8, "end": 1 / 8, "mid": 1 / 8}
    base = 0.15 / 8
    for _ in range(3):
        s = {"centre": base + d * 3 * s["leaf"], "leaf": base + d * s["centre"] / 3,
             "end": base + d * s["mid"] / 2, "mid": base + d * 2 * s["end"]}
    want = np.array([s["centre"], s["leaf"], s["leaf"], s["leaf"], s["end"], s["mid"],
                     s["end"], base])
    assert res.iterations == 3
    np.testing.assert_allclose(res.scores.numpy(), want, rtol=2e-6)
    assert float(res.scores[7]) == np.float32(np.float32(1.0 - np.float32(d)) / n)


# -- the DIA probe's pre-filter -------------------------------------------


def _dia_case(name):
    if name == "poisson512":
        return poisson_2d_csr(512, dtype=np.float32)
    if name == "hpcg40":
        return _program(hpcg_problem(40, 40, 40)[0])
    if name == "femlike400":
        return _program(corpus.fem_like(np.random.default_rng(0), n_side=400, jitter=2))
    return corpus.random_local(np.random.default_rng(0), 1 << 17, 10, 600)


@pytest.mark.parametrize("name", ["poisson512", "hpcg40", "femlike400", "randlocal"])
def test_dia_probe_over_a_million_entries_is_the_reference(name):
    """Past 1M entries the probe samples rows from the offsets before it
    builds any per-entry array; the plans stay the reference's byte for
    byte, and a matrix the sample rejects (random local columns) never
    builds its row ids."""
    m = _dia_case(name)
    assert m.nnz() > 1_000_000
    mine = try_dia_from_csr(m, dtype=np.float32)
    theirs = ref_dia.try_dia_from_csr(
        ref_csr.CsrMatrix(m.rows, m.cols, m.vals, m.indices, m.offsets, is_sorted=True),
        dtype=np.float32)
    assert (mine is None) == (theirs is None) == (name == "randlocal")
    if mine is not None:
        assert mine.offsets == tuple(int(o) for o in theirs.offsets)
        assert mine.data.dtype == theirs.data.dtype
        assert mine.data.tobytes() == np.asarray(theirs.data).tobytes()
    if name == "randlocal":
        assert "row_ids" not in m._cache
