"""Solvers of the port: CG family (``cg``) and the Poisson model problem
(``poisson``). Import the submodules directly."""
