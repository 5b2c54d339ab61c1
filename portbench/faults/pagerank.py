"""Planted faults of traffic kind ``pagerank``: each takes pytest's
``monkeypatch`` and breaks the program's PageRank under it; the run must
then fail ``CHECK``: the carries of the rows that a CSR-row tile boundary
cuts dropped (the hubs'), one iteration fewer, the damping left out,
contributions not divided by the degree."""

from __future__ import annotations

#: the comparison each fault must push past its limit
CHECK = "l1_error"


def _wrap(monkeypatch, change):
    import sparse_matrix_tpu_torch.solvers.pagerank as pagerank

    orig = pagerank.pagerank

    def faulty(op, degrees, **kw):
        degrees, kw = change(degrees, kw)
        return orig(op, degrees, **kw)

    monkeypatch.setattr(pagerank, "pagerank", faulty)


def dropped_carries(monkeypatch):
    import sparse_matrix_tpu_torch.ops.spmv_csr as spmv_csr

    orig = spmv_csr.merge_path

    def no_splits(offsets):
        coords, splits = orig(offsets)
        return coords, splits[:0]

    monkeypatch.setattr(spmv_csr, "merge_path", no_splits)


def one_iteration_fewer(monkeypatch):
    """Each ranking stops one iteration before its stopping test does."""
    import sparse_matrix_tpu_torch.solvers.pagerank as pagerank

    orig = pagerank.pagerank

    def early(op, degrees, **kw):
        full = orig(op, degrees, **kw)
        return orig(op, degrees, **{**kw, "maxiter": full.iterations - 1})

    monkeypatch.setattr(pagerank, "pagerank", early)


def no_damping(monkeypatch):
    _wrap(monkeypatch, lambda deg, kw: (deg, {**kw, "damping": 1.0}))


def undivided_contributions(monkeypatch):
    _wrap(monkeypatch, lambda deg, kw: (deg.clamp(max=1), kw))


FAULTS = {"dropped_carries": dropped_carries, "one_iteration_fewer": one_iteration_fewer,
          "no_damping": no_damping, "undivided_contributions": undivided_contributions}
