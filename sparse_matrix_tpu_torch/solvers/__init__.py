"""Solvers of the port: the CG family (``cg``), BiCGSTAB (``bicgstab``),
restarted GMRES (``gmres``), the incomplete factorizations and their
preconditioners (``ilu``: ``ilu0``, ``ic0``, ``ilut``, ``TriangularJacobi``,
``ilu_preconditioner``, ``ic_preconditioner``, ``ilut_preconditioner``,
``ic_pcg_solve``, ``trisolve_host``, ``save_ilu_factors``,
``load_ilu_factors``), smoothed-aggregation AMG (``amg``: ``amg_setup``,
``amg_coarsen``, ``AmgHierarchy``, ``AmgLevel``, ``amg_preconditioner``,
``amg_pcg_solve``, ``strength_graph``, ``aggregate_strong``,
``tentative_prolongator``, ``save_amg_coarsening``,
``load_amg_coarsening``), GAP's pull PageRank (``pagerank``) and the
Poisson model problem (``poisson``). Import
the submodules directly, or the names from the package."""
