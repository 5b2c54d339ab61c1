"""Plain PyTorch references of whole workloads the port runs, each in a
module of its own that imports ``torch`` alone: no kernel, planner or
solver of the port, and nothing of the JAX package.

    hpcg.py   HPCG 3.1's problem, multigrid V-cycle and CG set on grid
              tensors
    pagerank.py  GAP's pull PageRank (pr_spmv.cc) over a CSR pattern
    bfs.py    a level-synchronous BFS over a CSR pattern and Graph500's
              validation of a BFS tree
"""
