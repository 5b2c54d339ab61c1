"""A run with the timed path broken underneath comes out not correct:
once for each fault a cell can have. A step that returns its state
unchanged; an answer altered where it is produced; for the product, half
of its products left out. (No cell runs on more than one chip, so none
has an exchange to leave out; a solve request carries one right-hand
side, so a solve has no batch to halve.)"""

from __future__ import annotations

import json
import time
from pathlib import Path

import pytest
import torch

from portbench.harness import Bench, run_cell

SPEC = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
SOLVE_CELLS = [w["name"] for w in SPEC["workloads"] if "spgemm" not in w["name"]]
PRODUCT_CELLS = [w["name"] for w in SPEC["workloads"] if "spgemm" in w["name"]]


def _run(root, cell):
    return run_cell(Bench(root), cell, seed=2**31 + 5, seconds=0.02, trace=False,
                    device="cpu", t_start=time.perf_counter())


def _unchanged_steps(monkeypatch):
    import sparse_matrix_tpu_torch.solvers.bicgstab as bicgstab
    import sparse_matrix_tpu_torch.solvers.cg as cg

    monkeypatch.setattr(cg, "_cg_step", lambda matvec, x, r, p, rs: (x, r, p, rs))
    monkeypatch.setattr(cg, "_pcg_step", lambda matvec, precond, x, r, p, rz:
                        (x, r, p, rz, torch.dot(r, r)))
    monkeypatch.setattr(bicgstab, "_bicgstab_step", lambda matvec, m_inv, r_hat, x, p, r, rho:
                        (x, p, r, rho, torch.dot(r, r), torch.tensor(True)))


def _altered_answers(monkeypatch):
    import sparse_matrix_tpu_torch.solvers.amg as amg
    import sparse_matrix_tpu_torch.solvers.bicgstab as bicgstab
    import sparse_matrix_tpu_torch.solvers.cg as cg

    def alter(fn):
        def wrapped(*args, **kw):
            res = fn(*args, **kw)
            return res._replace(x=2 * res.x)  # doubled where the answer is made

        return wrapped

    for mod, name in ((amg, "amg_pcg_solve"), (cg, "cg_solve"), (cg, "pcg_solve"),
                      (bicgstab, "bicgstab_solve")):
        monkeypatch.setattr(mod, name, alter(getattr(mod, name)))


@pytest.mark.parametrize("cell", SOLVE_CELLS)
@pytest.mark.parametrize("fault", [_unchanged_steps, _altered_answers])
def test_solve_fault_is_caught(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    line = _run(tiny_root, cell)
    assert line["correct"] is False
    assert line["checks"]["residual"]["value"] > line["checks"]["residual"]["limit"]


def _stale_product(monkeypatch):
    from sparse_matrix_tpu_torch.ops.device_sorted import EscSpgemm

    orig = EscSpgemm.multiply_device
    first = {}

    def stale(self, lhs_vals=None, rhs_vals=None):
        if "c" not in first:
            first["c"] = orig(self, lhs_vals=lhs_vals, rhs_vals=rhs_vals)
        return first["c"]

    monkeypatch.setattr(EscSpgemm, "multiply_device", stale)


def _altered_product(monkeypatch):
    from sparse_matrix_tpu_torch.ops.device_sorted import EscSpgemm

    orig = EscSpgemm.multiply_device

    def altered(self, lhs_vals=None, rhs_vals=None):
        c = orig(self, lhs_vals=lhs_vals, rhs_vals=rhs_vals)
        val = c.val.clone()
        val[int(c.nnz) // 2] += 1.0
        return c._replace(val=val)

    monkeypatch.setattr(EscSpgemm, "multiply_device", altered)


def _half_products(monkeypatch):
    import sparse_matrix_tpu_torch.ops.esc_expand as esc_expand

    orig = esc_expand.expand_products

    def half(*args, **kw):
        p = orig(*args, **kw).clone()
        p[p.numel() // 2:] = 0
        return p

    monkeypatch.setattr(esc_expand, "expand_products", half)


@pytest.mark.parametrize("cell", PRODUCT_CELLS)
@pytest.mark.parametrize("fault", [_stale_product, _altered_product, _half_products])
def test_product_fault_is_caught(tiny_root, monkeypatch, cell, fault):
    fault(monkeypatch)
    line = _run(tiny_root, cell)
    assert line["correct"] is False
    assert line["checks"]["err_over_bound"]["value"] > line["checks"]["err_over_bound"]["limit"]
