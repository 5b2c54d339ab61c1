"""CUDA kernel library of the port: ``build`` compiles ``csrc/*.cu`` with
nvcc, ``kernels`` binds the result with ctypes and counts launches. Neither
is imported by the package until a kernel is launched."""
