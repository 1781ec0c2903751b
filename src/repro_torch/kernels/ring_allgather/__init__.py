"""The ``ring_allgather`` kernel: a bidirectional-ring all-gather in one
launch."""
