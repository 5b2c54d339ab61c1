"""Planted faults of traffic kind ``spgemm_refresh``: each takes pytest's
``monkeypatch`` and breaks the program's product under it; the run must
then fail ``CHECK``. A stale product (the refresh returns its first C);
an entry altered where C is made; half of the products left out."""

from __future__ import annotations

#: the comparison each fault must push past its limit
CHECK = "err_over_bound"


def stale_product(monkeypatch):
    from sparse_matrix_tpu_torch.ops.device_sorted import EscSpgemm

    orig = EscSpgemm.multiply_device
    first = {}

    def stale(self, lhs_vals=None, rhs_vals=None):
        if "c" not in first:
            first["c"] = orig(self, lhs_vals=lhs_vals, rhs_vals=rhs_vals)
        return first["c"]

    monkeypatch.setattr(EscSpgemm, "multiply_device", stale)


def altered_product(monkeypatch):
    from sparse_matrix_tpu_torch.ops.device_sorted import EscSpgemm

    orig = EscSpgemm.multiply_device

    def altered(self, lhs_vals=None, rhs_vals=None):
        c = orig(self, lhs_vals=lhs_vals, rhs_vals=rhs_vals)
        val = c.val.clone()
        val[int(c.nnz) // 2] += 1.0
        return c._replace(val=val)

    monkeypatch.setattr(EscSpgemm, "multiply_device", altered)


def half_products(monkeypatch):
    import sparse_matrix_tpu_torch.ops.esc_expand as esc_expand

    orig = esc_expand.expand_products

    def half(*args, **kw):
        p = orig(*args, **kw).clone()
        p[p.numel() // 2:] = 0
        return p

    monkeypatch.setattr(esc_expand, "expand_products", half)


FAULTS = {"stale_product": stale_product, "altered_product": altered_product,
          "half_products": half_products}
