"""Benchmark inputs of the port. Import the submodules directly."""
