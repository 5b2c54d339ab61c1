"""Graph traversals of the port: GAP's direction-optimizing BFS
(``bfs``: ``BfsPlan``, ``bfs``, ``BfsResult``; kernels in
``csrc/bfs.cu``). Import the submodule directly."""
