"""The benchmark's generator copies give the port's matrices array for
array at small sizes."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.generators import load


def _same(ours, theirs):
    assert (ours.rows, ours.cols) == (theirs.rows, theirs.cols)
    np.testing.assert_array_equal(ours.offsets, theirs.offsets)
    np.testing.assert_array_equal(ours.indices, theirs.indices)
    assert ours.indices.dtype == theirs.indices.dtype
    assert ours.vals.dtype == theirs.vals.dtype
    np.testing.assert_array_equal(ours.vals, theirs.vals)


@pytest.mark.parametrize("n", [1, 2, 7, 33])
def test_poisson_equals_port(n):
    from sparse_matrix_tpu_torch.solvers.poisson import poisson_2d_csr

    _same(load("poisson_2d").make(None, n=n), poisson_2d_csr(n))


@pytest.mark.parametrize("n_side,jitter,seed", [(8, 2, 0), (24, 2, 5), (16, 0, 3), (31, 3, 2**33)])
def test_fem_like_equals_port(n_side, jitter, seed):
    from sparse_matrix_tpu_torch.bench.corpus import fem_like

    ours = load("fem_like").make(np.random.default_rng(seed), n_side=n_side, jitter=jitter)
    _same(ours, fem_like(np.random.default_rng(seed), n_side, jitter))


@pytest.mark.parametrize("shift", [2.0, 0.5])
def test_dominant_diagonal_equals_port(shift):
    from sparse_matrix_tpu_torch.bench.corpus import fem_like, with_dominant_diagonal
    from sparse_matrix_tpu_torch.formats.csr import CsrMatrix

    m = fem_like(np.random.default_rng(11), 20, 2)
    ours = load("with_dominant_diagonal").transform(
        load("fem_like").make(np.random.default_rng(11), n_side=20, jitter=2), shift=shift)
    _same(ours, with_dominant_diagonal(m, shift=shift))
    # a row with no diagonal entry gets one
    t = CsrMatrix.from_coo(3, 3, [0, 1, 2], [1, 2, 0], [1.0, -2.0, 3.0])
    from portbench.generators.csr import from_coo

    ours = load("with_dominant_diagonal").transform(from_coo(3, 3, [0, 1, 2], [1, 2, 0],
                                                              np.array([1.0, -2.0, 3.0])))
    _same(ours, with_dominant_diagonal(t))


def test_femlike_config_is_the_corpus_matrix():
    """The configuration's fixed draw is ``bench.py``'s femlike_262k."""
    import json
    from pathlib import Path

    from sparse_matrix_tpu_torch.bench.corpus import bench_classes

    cfg = json.loads((Path(__file__).resolve().parents[1] / "configs"
                      / "femlike_262k.json").read_text())
    ours = load(cfg["generator"]).make(np.random.default_rng(cfg["matrix_seed"]),
                                       **cfg["generator_params"])
    name, _tag, theirs = bench_classes(0)[0]
    assert name == "femlike_262k"
    _same(ours, theirs)
