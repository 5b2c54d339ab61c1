"""Cost-model constants of the SpMV format dispatch and the SpGEMM
dispatch.

Counterpart of ``sparse_matrix_tpu/utils/autotune.py``: its ``DEFAULTS``
(the constants the reference measured on a TPU v5e) for the SpMV planners,
``SpmvOperator``'s dispatch and ``spgemm_auto``, and :func:`get`. With the
same constants the port picks the same formats, plans and SpGEMM engines
as the reference. They are the reference's v5e values, not H100 times:
the host rate is the reference's native engine's, and the one-shot
compile term is a TPU cost. The H100 calibration that replaces them is
ROADMAP.md queue A item 16. There is no calibration cache file here;
tests that need other constants patch ``DEFAULTS``.
"""

from __future__ import annotations

from typing import Dict

__all__ = ["DEFAULTS", "get"]

# per-slab / per-chunk kernel costs in ns, the reference's v5e values
DEFAULTS: Dict[str, float] = {
    # general LanePack: time per slab = fixed + kw_slope * KW
    "lanepack_fixed_ns": 30.0,
    "lanepack_kw_ns": 4.0,
    # pack-mode per-slab costs at kw=1 (dense two-target vs per-rb padded)
    "lanepack_dense_slab_ns": 30.0,
    "lanepack_per_rb_slab_ns": 32.0,
    # aligned (dst-aligned slots, no cumsum) per-slab cost
    "lanepack_aligned_slab_ns": 19.0,
    # BELL: per-(layer, 128-row-block) cost c0 + c1*(128/BR) + dspan term
    "bell_chunk_c0_ns": -0.43,
    "bell_chunk_c1_ns": 4.44,
    "bell_chunk_dspan_ns": 0.04,
    # aligned dispatch estimate: slabs*base + nnz*per_entry, with a
    # per-chunk floor interpolated in the x working set
    "aligned_slab_base_ns": 5.22,
    "aligned_slab_per_entry_ns": 0.027,
    "aligned_chunk_floor_lo_ns": 1.0,
    "aligned_chunk_floor_hi_ns": 2.2,
    # stripe scan mode: per slab fixed + kw_slope*KW + lvl_slope*L
    "stripe_fixed_ns": 11.23,
    "stripe_kw_ns": 5.15,
    "stripe_lvl_ns": 8.51,
    # stripe select mode (kw term on the measured gather width kw_g)
    "stripe_sel_fixed_ns": 1.96,
    "stripe_sel_kw_ns": 12.06,
    "stripe_sel_lvl_ns": 4.51,
    # ELL x-gather per element (prices the hyper-sparse ELL shortcut)
    "ell_gather_ns": 7.1,
    # spgemm_auto rates
    "spgemm_host_products_per_s": 5e7,  # per core
    "spgemm_host_touch_s_per_byte": 4e-9,  # numpy densify/sparsify passes
    "spgemm_mxu_pair_s": 4.5e-7,  # per 128x128 block pair
    "spgemm_dense_mac_per_s": 2e13,
    "spgemm_esc_products_per_s": 1.7e8,  # device ESC engine
    # one-shot device-call overhead (upload, dispatch, readback sync)
    "device_call_sync_s": 0.03,
    # first-call compile of a device engine at a new shape (a TPU cost)
    "device_oneshot_compile_s": 40.0,
}


def get(name: str) -> float:
    """A cost-model constant; unknown names raise ``KeyError``."""
    return DEFAULTS[name]
