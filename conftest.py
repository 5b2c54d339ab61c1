"""Builds the JAX package's native library once, before any test worker
starts.

``sparse_matrix_tpu.native.build`` has g++ write ``libspmx_native.so`` in
place. Under pytest-xdist a worker that loads the file while another worker
is still writing it fails to load it, marks the library unavailable and
skips the native tests for the rest of its run. So the controlling process
builds it first; its workers (``config.workerinput``) find it built. A
machine without g++, or without the JAX package, skips those tests as
before.
"""


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    try:
        from sparse_matrix_tpu.native.build import build

        build()
    except Exception:
        pass
