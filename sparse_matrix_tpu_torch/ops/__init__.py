"""Device side of the port: SpMV wrappers (kernel on CUDA, plain PyTorch on
the CPU) and the planned operator. Import the submodules directly."""
