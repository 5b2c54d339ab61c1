"""Build the port's CUDA kernels into one shared library.

Usage: ``python -m sparse_matrix_tpu_torch.native.build``; also invoked by
:mod:`.kernels` at the first launch. ``nvcc`` compiles every
``csrc/*.cu`` for ``sm_90a`` (Hopper), one compiler process per source,
all started together, and links the objects into
``_build/libspmx_torch_cuda.so``, a library with a plain C interface
(``csrc/spmx_cuda.h``) that ctypes loads. The library is rebuilt when any
source is newer than it (the staleness rule of
``sparse_matrix_tpu/native/build.py``); the linker writes a temporary file
that is renamed into place, so a concurrent loader never sees half a
library.

No ``--use_fast_math``: subnormals must survive, and division and square
root stay IEEE. A missing ``nvcc`` or a failed compile raises; there is no
fallback.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
LIB = BUILD_DIR / "libspmx_torch_cuda.so"

ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC")


def sources() -> list:
    """The ``.cu`` translation units, in a fixed order."""
    return sorted(CSRC.glob("*.cu"))


def nvcc_path() -> str:
    """``nvcc`` from ``PATH``, else from ``$CUDA_HOME/bin`` (default
    ``/usr/local/cuda``); raises when neither exists."""
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME") or "/usr/local/cuda") / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME: the CUDA kernels of "
        "sparse_matrix_tpu_torch cannot be built"
    )


def _check(cmd, res) -> None:
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(map(str, cmd))}\n"
            f"{res.stderr}{res.stdout}"
        )


def build(verbose: bool = False) -> str:
    """Compile if stale and return the library path. ``verbose`` adds
    ``-Xptxas -v`` and prints the compiler's report (registers, shared
    memory and spills per kernel) to stderr."""
    srcs = sources()
    inputs = srcs + sorted(CSRC.glob("*.h"))
    if LIB.exists() and LIB.stat().st_mtime >= max(p.stat().st_mtime for p in inputs):
        return str(LIB)
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    extra = ["-Xptxas", "-v"] if verbose else []
    jobs = []
    for src in srcs:
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *COMPILE_FLAGS, *extra, "-c", "-o", str(obj), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs.append((cmd, obj, proc))
    objs, report = [], []
    try:
        for cmd, obj, proc in jobs:
            out, err = proc.communicate()
            _check(cmd, subprocess.CompletedProcess(cmd, proc.returncode, out, err))
            objs.append(obj)
            report.append(err + out)
        tmp = BUILD_DIR / f"{LIB.name}.{tag}"
        cmd = [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            tmp.unlink(missing_ok=True)
        _check(cmd, res)
        os.replace(tmp, LIB)
    finally:
        for _cmd, obj, proc in jobs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            obj.unlink(missing_ok=True)
    if verbose:
        print("".join(report), file=sys.stderr)
    return str(LIB)


if __name__ == "__main__":
    print(build(verbose=True))
