"""The ``rwkv6_scan`` kernel: the chunked RWKV-6 (Finch) gated linear
recurrence with a per-channel data-dependent decay and a bonus term."""
