"""The ``ring_allgather`` kernel: an all-gather in one launch, each shard
read once and pushed into every replica."""
