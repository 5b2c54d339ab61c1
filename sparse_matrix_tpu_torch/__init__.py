"""sparse_matrix_tpu_torch — the PyTorch + CUDA port of sparse_matrix_tpu.

The host planners (``sparse_matrix_tpu.formats``, ``.utils.autotune``,
``.native``: numpy, ctypes and C++) are shared with the JAX package; this
package rebuilds the device side for an NVIDIA Hopper GPU. Its modules
mirror the reference's names:

    device.py           require_device; CPU tensors take plain versions
    native/             nvcc build and ctypes bindings of csrc/*.cu
    ops/spmv_dia.py     DIA SpMV (kernel: csrc/spmv_dia.cu)
    ops/spmv.py         LanePack, aligned (csrc/spmv_lanepack.cu,
                        csrc/spmv_aligned.cu) and ELL SpMV
    ops/spmv_bell.py    BELL SpMV (kernel: csrc/spmv_bell.cu)
    ops/operator.py     SpmvOperator + plan files
    solvers/cg.py       CG, PCG, mixed-precision CG
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
    "SpmvOperator": "ops.operator",
    "save_operator_plan": "ops.operator",
    "load_operator_plan": "ops.operator",
    "CgResult": "solvers.cg",
    "cg_solve": "solvers.cg",
    "cg_solve_ir": "solvers.cg",
    "pcg_solve": "solvers.cg",
    "jacobi_preconditioner": "solvers.cg",
    "poisson_2d_csr": "solvers.poisson",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)
