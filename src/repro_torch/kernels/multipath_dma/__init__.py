"""The ``multipath_dma`` kernel: a scheduled transfer graph in one launch."""
