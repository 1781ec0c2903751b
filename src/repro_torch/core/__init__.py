"""Hardware model, analytic pipeline model and the Jacobi application.

* :mod:`repro_torch.core.topology`   — link graph of the logical devices
* :mod:`repro_torch.core.pipelining` — 2-D pipelining + analytic time model
* :mod:`repro_torch.core.halo`       — Jacobi halo exchange application
"""
