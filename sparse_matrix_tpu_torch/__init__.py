"""sparse_matrix_tpu_torch — the PyTorch + CUDA port of sparse_matrix_tpu.

The package imports nothing of the JAX package: it keeps its own numpy
copies of the host planners (``formats/``, ``utils/autotune.py``; the
reference's native C++ runtime is not copied) and rebuilds the device side
for an NVIDIA Hopper GPU. Its modules mirror the reference's names:

    device.py           require_device, default_device (the device of
                        A @ B); CPU tensors take plain versions
    formats/            CsrMatrix and the DIA, LanePack, aligned, BELL,
                        stripe and BCSR planners (numpy), DeviceCsr
    utils/autotune.py   the dispatch cost-model constants
    native/             nvcc build and ctypes bindings of csrc/*.cu
    ops/spmv_dia.py     DIA SpMV and SpMM (csrc/spmv_dia.cu,
                        csrc/spmm_dia.cu)
    ops/spmv.py         LanePack, aligned, stripe (csrc/spmv_lanepack.cu,
                        csrc/spmv_aligned.cu, csrc/spmv_stripe.cu) and ELL
                        SpMV
    ops/spmv_bell.py    BELL SpMV (kernel: csrc/spmv_bell.cu)
    ops/spmm.py         aligned SpMM (csrc/spmm_aligned.cu), packed layout
    ops/operator.py     SpmvOperator (apply, matmat) + plan files
    ops/spgemm_*.py     SpGEMM: host hash and ESC engines, band
                        convolution, block SpGEMM (csrc/spgemm_block.cu),
                        selection-matrix SpMV engines, spgemm_auto
    ops/esc_expand.py   ESC expansion plan and kernel (csrc/esc_expand.cu)
    ops/device_sorted.py  EscSpgemm, device transpose, add and sub
    solvers/cg.py       CG, PCG, mixed-precision CG, multi-RHS CG and PCG
    solvers/poisson.py  the 2-D Poisson model problem
    bench/corpus.py     the bench's 262k-row matrix classes
    entry.py            one CG step through the aligned kernel

Importing the package imports nothing else: the names below load their
modules on first use, and the CUDA library is built at its first launch.
``entry`` is reached as ``sparse_matrix_tpu_torch.entry.entry``.
"""

import importlib

__version__ = "0.1.0"

_EXPORTS = {
    "require_device": "device",
    "default_device": "device",
    "set_default_device": "device",
    "DeviceCsr": "formats.device",
    "EscSpgemm": "ops.device_sorted",
    "transpose_device": "ops.device_sorted",
    "add_device": "ops.device_sorted",
    "sub_device": "ops.device_sorted",
    "ReduceSpmv": "ops.spgemm_spmv",
    "FixedSideSpgemm": "ops.spgemm_spmv",
    "spgemm_auto": "ops.spgemm_block",
    "spgemm_hash_host": "ops.spgemm_host",
    "spgemm_dia": "ops.spgemm_dia",
    "SpmvOperator": "ops.operator",
    "save_operator_plan": "ops.operator",
    "load_operator_plan": "ops.operator",
    "CgResult": "solvers.cg",
    "cg_solve": "solvers.cg",
    "cg_solve_ir": "solvers.cg",
    "cg_solve_multi": "solvers.cg",
    "pcg_solve": "solvers.cg",
    "pcg_solve_multi": "solvers.cg",
    "CsrMatrix": "formats.csr",
    "jacobi_preconditioner": "solvers.cg",
    "poisson_2d_csr": "solvers.poisson",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)
