"""repro_torch — the PyTorch/CUDA port of the multi-path transfer system.

A package of its own beside the reference ``repro`` package, for one
NVIDIA Hopper card. Layering mirrors the reference:

* :mod:`repro_torch.core` — topology model, analytic pipeline model, and
  the Jacobi halo-exchange application
* :mod:`repro_torch.comm` — config, plans, planner, transfer-graph IR,
  scheduler passes, the CUDA-graph cache, the engine and
  :class:`~repro_torch.comm.session.CommSession`
* :mod:`repro_torch.kernels` — the hand-written CUDA kernels
  (``multipath_dma``, ``jacobi``), each beside its plain PyTorch version
* :mod:`repro_torch.carry` — topology/config state from plain dicts

Typical use::

    from repro_torch.comm import CommSession

    session = CommSession(schedule="auto")      # on cuda
    out = session.send(message, src=0, dst=1)
    print(session.stats()["fastpath"])
"""
