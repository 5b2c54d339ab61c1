"""Host planning of the port: CSR, BCSR and the SpMV plan formats (numpy
only).

Counterparts of ``sparse_matrix_tpu/formats/`` (the numpy branches of its
planners; the reference's native C++ runtime is not copied). The plans
are array-equal to the reference's on the same COO input, so the port's
dispatch and plan files match the reference's.
"""
