"""Planted faults of traffic kind ``solve_loop``, for the benchmark's CPU
tests (``tests/test_faults.py``): each takes pytest's ``monkeypatch`` and
breaks the program's solve under it; the run must then fail ``CHECK``.
A solve request carries one right-hand side, so a solve has no batch to
halve, and no cell runs on more than one chip, so none has an exchange
to leave out."""

from __future__ import annotations

#: the comparison each fault must push past its limit
CHECK = "residual"


def unchanged_steps(monkeypatch):
    """Each solver step returns its state unchanged."""
    import torch

    import sparse_matrix_tpu_torch.solvers.bicgstab as bicgstab
    import sparse_matrix_tpu_torch.solvers.cg as cg

    monkeypatch.setattr(cg, "_cg_step", lambda matvec, x, r, p, rs: (x, r, p, rs))
    monkeypatch.setattr(cg, "_pcg_step", lambda matvec, precond, x, r, p, rz:
                        (x, r, p, rz, torch.dot(r, r)))
    monkeypatch.setattr(bicgstab, "_bicgstab_step", lambda matvec, m_inv, r_hat, x, p, r, rho:
                        (x, p, r, rho, torch.dot(r, r), torch.tensor(True)))


def altered_answers(monkeypatch):
    """Each solver's answer doubled where it is made."""
    import sparse_matrix_tpu_torch.solvers.amg as amg
    import sparse_matrix_tpu_torch.solvers.bicgstab as bicgstab
    import sparse_matrix_tpu_torch.solvers.cg as cg

    def alter(fn):
        def wrapped(*args, **kw):
            res = fn(*args, **kw)
            return res._replace(x=2 * res.x)

        return wrapped

    for mod, name in ((amg, "amg_pcg_solve"), (cg, "cg_solve"), (cg, "pcg_solve"),
                      (bicgstab, "bicgstab_solve")):
        monkeypatch.setattr(mod, name, alter(getattr(mod, name)))


FAULTS = {"unchanged_steps": unchanged_steps, "altered_answers": altered_answers}
