"""Wrapper of the ``multipath_dma`` kernel for one plan on a stacked buffer.

``multipath_dma_transfer`` is the kernel-backed counterpart of the
reference package's ``kernels/multipath_dma/ops.multipath_dma_transfer``:
same plans, same contract (``y[dst] = x[src]``, identity elsewhere), and
``captured_multipath_dma`` records that kernel as one compute node of a
captured step. The engine (:mod:`repro_torch.comm.engine`) drives the
same kernel through
:class:`~repro_torch.kernels.multipath_dma.kernel.DmaProgram` with the
zero-fill contract instead, inside a captured CUDA graph.
"""

from __future__ import annotations

import torch

from repro_torch.comm.graph import lower
from repro_torch.comm.plan import TransferPlan
from repro_torch.core.topology import HOST
from repro_torch.kernels.multipath_dma.kernel import (DmaProgram,
                                                      PeerDmaProgram,
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


class PlanKernel:
    """``plan`` on a stacked ``(num_devices, nelems)`` tensor, as the
    kernel function of :func:`captured_multipath_dma`.

    The work table is built once, here, with the identity contract
    (``fill="copy"``). The first call on a device makes it resident there
    as a :class:`DmaProgram` without an operand buffer of its own; that
    call is a step program's warm-up, so recording the step's CUDA graph
    captures launches only. A call runs the program once on the
    operand's bytes (one kernel launch on a CUDA tensor, the plain
    version on a CPU tensor) and returns the program's output, which the
    next call overwrites.

    In a peer step the node runs in its peer form (:meth:`peer_program`):
    the plan's per-device table with the same identity fill over each
    logical device's operand and result views, one launch a card.
    """

    def __init__(self, plan: TransferPlan, nelems: int, dtype: torch.dtype,
                 num_devices: int):
        check_plan(plan)
        self.plan = plan
        self.shape = (int(num_devices), int(nelems))
        self.dtype = dtype
        self.table = build_node_table(lower(plan), (nelems,),
                                      (dtype.itemsize,), num_devices,
                                      fill="copy")
        self._programs: dict[torch.device, DmaProgram] = {}

    def peer_program(self, devices, operands, results) -> PeerDmaProgram:
        """The peer form in a peer step: ``operands[0][d]`` and
        ``results[0][d]`` are logical device *d*'s ``(1, nelems)`` views;
        returns the program that writes ``y[dst] = x[src]`` and ``y[d] =
        x[d]`` elsewhere into the result views (fill ``"copy"``), its
        staging its own."""
        (xs,), (ys,) = operands, results
        n = len(devices)
        table = build_node_table(lower(self.plan), (self.shape[1],),
                                 (self.dtype.itemsize,), n, fill="copy",
                                 bases=[((0, 0),) * n], per_device=True)
        stages = [torch.empty(max(own[2], 16), dtype=torch.uint8,
                              device=d)
                  for own, d in zip(table.device_bytes, devices)]
        return PeerDmaProgram(table, (self.dtype,), devices, buffers=(
            [x.reshape(-1).view(torch.uint8) for x in xs],
            [y.reshape(-1).view(torch.uint8) for y in ys], stages))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) != self.shape or x.dtype != self.dtype:
            raise ValueError(f"expected {self.shape} {self.dtype}, got "
                             f"{tuple(x.shape)} {x.dtype}")
        prog = self._programs.get(x.device)
        if prog is None:
            prog = self._programs[x.device] = DmaProgram(
                self.table, (self.dtype,), x.device, operand=False)
        prog.run(x.contiguous().reshape(-1).view(torch.uint8))
        return prog.outputs()[0][0]


def captured_multipath_dma(cap, x, plan: TransferPlan, num_devices: int, *,
                           name: str = "multipath_dma", telemetry=None):
    """Record the ``multipath_dma`` kernel on a ``session.capture`` step.

    ``x`` is a capture ref with local shape ``(nelems,)``; returns the
    same-shape ref with ``y[dst] = x[src]`` (identity elsewhere),
    executing ``plan``'s copy schedule as one kernel launch inside the
    captured program (:class:`PlanKernel`). One compute node with the
    declared result spec and ``flops`` 0 (on a peer session its per-device
    table, one launch a card); ``cost_ns`` is stamped from
    ``telemetry``'s recorded median for ``name`` when a recorder is
    passed (0 without one), so the lane model prices the kernel's
    measured duration.
    """
    from repro_torch.comm.capture import BufferSpec, as_dtype
    spec = cap.buffers[cap._resolve(x)]
    (nelems,) = spec.shape
    fn = PlanKernel(plan, nelems, as_dtype(spec.dtype), num_devices)
    cost = int(telemetry.kernel_cost_ns(name)) if telemetry is not None \
        else 0
    return cap.kernel(fn, x, name=name, out=BufferSpec((nelems,), spec.dtype),
                      cost_ns=cost)
