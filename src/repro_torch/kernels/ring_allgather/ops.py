"""Wrappers of the ring all-gather: the kernel on the card, the plain
version on the CPU, and the capture adopter."""

from __future__ import annotations

import torch

from repro_torch.kernels.ring_allgather.kernel import (
    PeerRingProgram, ring_allgather_cuda, ring_allgather_peer_cuda,
    ring_allgather_peer_plain, ring_allgather_plain)


def ring_allgather(xs):
    """All-gather of the stacked shards ``xs: (n, rows, f)`` →
    ``(n, n, rows, f)``; ``out[d]`` is device ``d``'s replica (the
    reference's bidirectional ring's result; the kernel reads each shard
    once and stores it into every replica). A list of per-device shards
    ``(rows, f)`` takes the peer form and returns one replica
    ``(n, rows, f)`` a shard, on its device. A CUDA tensor goes through
    the hand-written kernel (or raises), and so does a meta tensor, which
    a cost count passes; a CPU tensor through the plain version."""
    if isinstance(xs, (list, tuple)):
        kinds = {x.device.type for x in xs}
        if kinds == {"cpu"}:
            return ring_allgather_peer_plain(xs)
        return ring_allgather_peer_cuda(xs)
    if xs.device.type in ("cuda", "meta"):
        return ring_allgather_cuda(xs)
    if xs.device.type == "cpu":
        return ring_allgather_plain(xs)
    raise ValueError(f"unsupported device {xs.device}")


def gather_rows(xs: torch.Tensor) -> torch.Tensor:
    """Stacked ``(n, rows, f)`` → ``(n, n * rows, f)``: every device's
    gathered shard rows (the kernel function of
    :func:`captured_ring_allgather`)."""
    n, rows, f = xs.shape
    return ring_allgather(xs).reshape(n, n * rows, f)


def _gather_rows_peer(devices, operands, results) -> PeerRingProgram:
    """The peer form of :func:`gather_rows` in a peer step: one
    :class:`PeerRingProgram` over each logical device's ``(1, rows, f)``
    operand view and ``(1, n·rows, f)`` result view, one launch a card,
    each shard pushed into every replica."""
    (xs,), (outs,) = operands, results
    _, rows, f = xs[0].shape
    n = len(devices)
    return PeerRingProgram(rows, f, xs[0].dtype, devices,
                           x=[x[0] for x in xs],
                           out=[o.view(n, rows, f) for o in outs])


gather_rows.peer_program = _gather_rows_peer


def captured_ring_allgather(cap, x, num_devices: int, *,
                            name: str = "ring_allgather", telemetry=None):
    """Record the ring all-gather kernel on a ``session.capture`` step.

    ``x`` is a capture ref with local shape ``(rows, f)``; returns the
    gathered ``(num_devices * rows, f)`` ref (every device holds the full
    result). One compute node with the declared result spec and ``flops``
    0 (wire work); on a peer session its kernel runs in its peer form, one
    ``ring_allgather`` launch a card; ``cost_ns`` is stamped from ``telemetry``'s recorded
    median for ``name`` when a recorder is passed (0 without one), so its
    measured duration occupies the lane model's compute lane.
    """
    from repro_torch.comm.capture import BufferSpec
    spec = cap.buffers[cap._resolve(x)]
    rows, f = spec.shape
    cost = int(telemetry.kernel_cost_ns(name)) if telemetry is not None \
        else 0
    return cap.kernel(gather_rows, x, name=name,
                      out=BufferSpec((num_devices * rows, f), spec.dtype),
                      cost_ns=cost)
