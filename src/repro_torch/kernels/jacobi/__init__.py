"""The ``jacobi`` kernel: one 5-point Jacobi sweep."""
