"""Work counts of one breadth-first search, and the BFS kernels' reading
in a trace.

The least a BFS must move, whatever implements it and whichever direction
its steps take: for each vertex it reaches other than the root, its
parent written once and one entry of its row (the edge to that parent)
read once, each at the narrowest width that holds a vertex id
(``roofline.index_bytes``). No operations. The reached count is the
reference's (the root's component), never the program's. No BFS can move
less, so a program's share of this floor reads low (every step of a real
search reads far more of the graph than the tree's edges) and cannot pass
100 %.
"""

from __future__ import annotations

from portbench.roofline import index_bytes

#: the symbols of the port's top-down and bottom-up kernels (``csrc/bfs.cu``)
TD_KERNELS = "spmx_bfs_td"
BU_KERNELS = "spmx_bfs_bu"


def bfs_bytes(n: int, reached: int) -> int:
    """Bytes of one BFS over ``n`` vertices that reaches ``reached`` of
    them, its root included."""
    return 2 * index_bytes(n) * max(int(reached) - 1, 0)


def kernels_device_s(trace, symbol: str) -> float:
    """Seconds of the traced sub-window's kernels whose name holds
    ``symbol``."""
    return sum(e - s for s, e, name, _c, _k in trace.kernels() if symbol in name) / 1e6
