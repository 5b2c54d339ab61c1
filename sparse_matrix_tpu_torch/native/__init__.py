"""Native libraries of the port: ``build`` compiles ``csrc/*.cu`` with
nvcc and ``kernels`` binds the result with ctypes and counts launches;
``host`` compiles ``src/spmx_host.cpp`` (the factorizations of
``solvers/ilu.py``, the AMG setup sweeps of ``solvers/amg.py`` and the hash
SpGEMM engine of ``ops/spgemm_host.py``) with g++ and binds it. Nothing is
built or loaded until first use."""
