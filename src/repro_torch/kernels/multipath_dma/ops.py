"""Wrapper of the ``multipath_dma`` kernel for one plan on a stacked buffer.

``multipath_dma_transfer`` is the kernel-backed counterpart of the
reference package's ``kernels/multipath_dma/ops.multipath_dma_transfer``:
same plans, same contract (``y[dst] = x[src]``, identity elsewhere). The
engine (:mod:`repro_torch.comm.engine`) drives the same kernel through
:class:`~repro_torch.kernels.multipath_dma.kernel.DmaProgram` with the
zero-fill contract instead, inside a captured CUDA graph.
"""

from __future__ import annotations

import torch

from repro_torch.comm.graph import lower
from repro_torch.comm.plan import TransferPlan
from repro_torch.core.topology import HOST
from repro_torch.kernels.multipath_dma.kernel import (DmaProgram,
                                                      build_node_table)


def check_plan(plan: TransferPlan) -> None:
    """The reference kernel's limits: direct and 2-hop staged routes only
    (``NotImplementedError`` beyond), no host route (``ValueError``)."""
    for pa in plan.paths:
        if pa.route.num_hops > 2:
            raise NotImplementedError(
                "the DMA kernel implements direct and 2-hop staged routes "
                "(paper Alg. 2); longer detours run through the engine "
                "(repro_torch.comm.engine)")
    for pa in plan.paths:
        if pa.route.via == HOST or any(HOST in (h.src, h.dst)
                                       for h in pa.route.hops):
            raise ValueError("host-staged path not executable on the device")


def multipath_dma_transfer(x: torch.Tensor, plan: TransferPlan
                           ) -> torch.Tensor:
    """Execute ``plan`` on ``x: (num_devices, nelems)``.

    Returns a new tensor with ``y[dst] = x[src]`` and ``y[r] = x[r]`` for
    every other row. On a CUDA tensor this launches the hand-written
    kernel (one launch); on a CPU tensor it runs the plain version.
    """
    check_plan(plan)
    if x.dim() != 2:
        raise ValueError(f"x must be (num_devices, nelems), got "
                         f"{tuple(x.shape)}")
    ndev, nelems = x.shape
    table = build_node_table(lower(plan), (nelems,), (x.element_size(),),
                             ndev, fill="copy")
    prog = DmaProgram(table, (x.dtype,), x.device)
    (xin,) = prog.inputs()
    xin[0].copy_(x)
    prog.run()
    return prog.outputs()[0][0].clone()
