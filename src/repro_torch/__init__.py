"""repro_torch — the PyTorch/CUDA port of the multi-path transfer system.

A package of its own beside the reference ``repro`` package, for one
NVIDIA Hopper card. Layering mirrors the reference:

* :mod:`repro_torch.core` — topology model, analytic pipeline model, and
  the Jacobi halo-exchange application
* :mod:`repro_torch.comm` — config, plans, planner, transfer-graph IR,
  scheduler passes, the CUDA-graph cache, the engine and
  :class:`~repro_torch.comm.session.CommSession`
* :mod:`repro_torch.kernels` — the hand-written CUDA kernels
  (``multipath_dma``, ``jacobi``, ``ring_allgather``,
  ``flash_attention``), each beside its plain PyTorch version
* :mod:`repro_torch.configs` — architecture configs (Llama-3 8B,
  SmolLM 360M, Gemma-3 27B)
* :mod:`repro_torch.models` — forward-only transformer: layers, prefill
  into a KV cache, decode steps
* :mod:`repro_torch.serving` — ``ServeEngine`` (prefill, greedy or
  sampled decode, KV migration through a session) and the captured
  decode step
* :mod:`repro_torch.carry` — topology/config state from plain dicts, and
  weights and caches from numpy arrays

Typical use::

    from repro_torch.comm import CommSession

    session = CommSession(schedule="auto")      # on cuda
    out = session.send(message, src=0, dst=1)
    print(session.stats()["fastpath"])

    from repro_torch.configs import get_config
    from repro_torch.models.transformer import init_params
    from repro_torch.serving import Request, ServeEngine

    cfg = get_config("llama3_8b")
    params = init_params(cfg, generator=torch.Generator("cuda").manual_seed(0),
                         device="cuda")
    engine = ServeEngine(cfg, params, max_len=1024, comm=session)
    done = engine.generate([Request([1, 2, 3], max_new_tokens=8)])
"""
