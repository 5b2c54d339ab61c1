"""Work counts of one PageRank pull, and its reading in a trace.

A pull computes ``incoming[u] = sum_{v in N(u)} contrib[v]`` over the
graph's pattern. The least it must move is the pattern once in CSR with
the narrowest column index and row pointer (``roofline.csr_bytes`` with no
values: a pull reads none, whatever format the program keeps), the
contributions read once and the sums written once, in float32; its
operations are one add an entry. The same work whatever format or kernel
does the pull, so a program that streams values too, or gathers a vector
past L2 a sector at a time, reads below 100 %.
"""

from __future__ import annotations

from portbench.roofline import csr_bytes

#: bytes of a score, a contribution and a sum (float32)
VALUE_BYTES = 4


def pull_work(rows: int, nnz: int):
    """``(bytes, flops)`` of one pull over a square graph of ``rows``
    vertices and ``nnz`` stored entries."""
    return csr_bytes(rows, rows, nnz, 0) + 2 * VALUE_BYTES * rows, float(nnz)
