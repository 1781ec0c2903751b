"""The ``flash_attention`` kernel: blockwise online-softmax attention with
grouped-query heads, causal and sliding-window masks."""
