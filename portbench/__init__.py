"""The benchmark of the PyTorch and CUDA port (``sparse_matrix_tpu_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell once on the CUDA device and prints one JSON
result line. Everything that belongs to one configuration, cell, traffic
kind, generator or metric lives in a file of its own, found by name:
``configs/<config>.json``, ``workloads/<cell>.json``,
``traffic/<kind>.py``, ``generators/<generator>.py`` and
``metrics/<metric>.py``; ``BENCHMARK.json`` at the root of the repository
lists them. Nothing here imports JAX or the JAX package.
"""
