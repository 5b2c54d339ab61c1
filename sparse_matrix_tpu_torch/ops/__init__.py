"""Device side of the port: SpMV, SpMM and block SpGEMM wrappers (kernel on
CUDA, plain PyTorch on the CPU) and the planned operator. Import the
submodules directly."""
