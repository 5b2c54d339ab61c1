"""sparse_matrix_tpu_torch — the PyTorch + CUDA port of sparse_matrix_tpu.

The package imports nothing of the JAX package: it keeps its own numpy
copies of the host planners (``formats/``, ``utils/autotune.py``; the
reference's native C++ runtime is copied only where a solver needs it: the
incomplete factorizations, the AMG setup sweeps and the hash SpGEMM
engine, in ``native/src/spmx_host.cpp``) and rebuilds the device side for
an NVIDIA Hopper GPU. Its modules mirror the reference's names:

    device.py           require_device, default_device (the device of
                        A @ B); CPU tensors take plain versions
    formats/            CsrMatrix and the DIA, LanePack, aligned, BELL,
                        stripe and BCSR planners (numpy), DeviceCsr
    utils/autotune.py   the dispatch cost-model constants
    native/             nvcc build and ctypes bindings of csrc/*.cu; the
                        host runtime (native/src/spmx_host.cpp, g++)
    utils/debugflags.py, utils/linprobe.py  the debug flag, its histogram
                        store and the linear-probe tables of the hash
                        SpGEMM's instrumentation
    ops/spmv_dia.py     DIA SpMV and SpMM (csrc/spmv_dia.cu,
                        csrc/spmm_dia.cu)
    ops/spmv.py         LanePack, aligned, stripe (csrc/spmv_lanepack.cu,
                        csrc/spmv_aligned.cu, csrc/spmv_stripe.cu) and ELL
                        SpMV
    ops/spmv_bell.py    BELL SpMV (kernel: csrc/spmv_bell.cu)
    ops/spmm.py         aligned SpMM (csrc/spmm_aligned.cu), packed layout
    ops/spmv_csr.py     CSR-row SpMV for the skew class, balanced by the
                        merge path, in column stripes where x is past
                        L2 (csrc/spmv_csr.cu)
    ops/operator.py     SpmvOperator (apply, matmat) + plan files
    ops/spgemm_*.py     SpGEMM: host hash and ESC engines, band
                        convolution, block SpGEMM (csrc/spgemm_block.cu),
                        selection-matrix SpMV engines, spgemm_auto
    ops/esc_expand.py   ESC expansion plan and kernel (csrc/esc_expand.cu)
    ops/device_sorted.py  EscSpgemm, device transpose, add and sub
    ops/trisweep.py     fused triangular Jacobi sweeps (csrc/trisweep.cu)
    ops/symgs.py        multicolour symmetric Gauss-Seidel over DIA planes
                        (csrc/symgs_dia.cu)
    solvers/cg.py       CG, PCG, mixed-precision CG, multi-RHS CG and PCG
    solvers/ilu.py      ILU(0), IC(0), ILUT (host), TriangularJacobi and
                        the ILU/IC preconditioners, IC-PCG
    solvers/amg.py      smoothed-aggregation AMG: host coarsening, the
                        V-cycle over SpmvOperators, AMG-PCG
    solvers/bicgstab.py, solvers/gmres.py  BiCGSTAB and GMRES(m)
    solvers/poisson.py  the 2-D Poisson model problem
    solvers/hpcg.py     HPCG's 27-point problem and geometric multigrid as
                        an AmgHierarchy (smoother "symgs")
    solvers/pagerank.py GAP's pull PageRank over a planned operator
    graph/bfs.py        GAP's direction-optimizing BFS: BfsPlan, bfs
                        (csrc/bfs.cu: top-down and bottom-up steps)
    reference/hpcg.py   HPCG written plainly on grid tensors, the tests'
                        reference
    reference/pagerank.py  GAP's PageRank written plainly over a CSR
                        pattern, the tests' reference
    reference/bfs.py    a level-synchronous BFS and Graph500's validation
                        of a BFS tree, the tests' reference
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
    "bicgstab_solve": "solvers.bicgstab",
    "gmres_solve": "solvers.gmres",
    "IluFactors": "solvers.ilu",
    "ilu0": "solvers.ilu",
    "ic0": "solvers.ilu",
    "ilut": "solvers.ilu",
    "trisolve_host": "solvers.ilu",
    "TriangularJacobi": "solvers.ilu",
    "ilu_preconditioner": "solvers.ilu",
    "ic_preconditioner": "solvers.ilu",
    "ilut_preconditioner": "solvers.ilu",
    "ic_pcg_solve": "solvers.ilu",
    "save_ilu_factors": "solvers.ilu",
    "load_ilu_factors": "solvers.ilu",
    "poisson_2d_csr": "solvers.poisson",
    "pagerank": "solvers.pagerank",
    "PageRankResult": "solvers.pagerank",
    "AmgHierarchy": "solvers.amg",
    "AmgLevel": "solvers.amg",
    "aggregate_strong": "solvers.amg",
    "amg_coarsen": "solvers.amg",
    "save_amg_coarsening": "solvers.amg",
    "load_amg_coarsening": "solvers.amg",
    "amg_preconditioner": "solvers.amg",
    "amg_pcg_solve": "solvers.amg",
    "amg_setup": "solvers.amg",
    "strength_graph": "solvers.amg",
    "tentative_prolongator": "solvers.amg",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f".{mod}", __name__), name)
