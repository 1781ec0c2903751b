"""Hand-written CUDA kernels of the port, each beside its plain version.

* :mod:`repro_torch.kernels.multipath_dma` — one transfer graph per launch
* :mod:`repro_torch.kernels.jacobi` — the 5-point Jacobi sweep
* :mod:`repro_torch.kernels.ring_allgather` — the all-gather, each shard
  pushed into every replica
* :mod:`repro_torch.kernels.flash_attention` — blockwise online-softmax
  attention (GQA, causal and sliding-window masks)
* :mod:`repro_torch.kernels.rwkv6_scan` — the chunked RWKV-6 recurrence
"""
