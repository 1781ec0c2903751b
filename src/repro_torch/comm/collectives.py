"""Multipath-striped collectives over device-stacked tensors.

The port of the reference's bidirectional-ring collectives (the paper's §6
future work: stripe a collective across both ring directions, as a
point-to-point message is striped across idle links). Every function takes
a **device-stacked** tensor whose dim 0 is the logical device, where the
reference takes one device's local value inside ``shard_map``: a
``ppermute`` by ``+s`` becomes ``torch.roll(x, s, dims=0)`` and
``axis_index`` becomes ``torch.arange(n)``.

The all-gather runs on the hand-written ``ring_allgather`` kernel on a CUDA
tensor (:mod:`repro_torch.kernels.ring_allgather`), on its plain version on
the CPU. The reductions keep the reference's order of additions —
``acc = roll(acc) + blk(...)`` step by step — so float32 sums are bit-equal
to the reference ring, not just close.

Hierarchy (DESIGN §3.1): :func:`two_level_all_reduce` decomposes an
all-reduce over ``(islands, per_island, ...)`` into an intra-island
reduce-scatter, an inter-island all-reduce of the shards and an
intra-island all-gather; :func:`modeled_all_reduce_s` prices both layouts
under the §4.4 tier model and :func:`select_all_reduce_strategy`
arbitrates. The tier model is pure Python and gives the reference's
numbers.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.topology import HOST, Topology
from repro_torch.kernels.ring_allgather.ops import ring_allgather


def _devices(xs: torch.Tensor) -> torch.Tensor:
    return torch.arange(xs.shape[0], device=xs.device)


def bidir_ring_all_gather(xs: torch.Tensor) -> torch.Tensor:
    """All-gather of the stacked shards ``xs: (n, s, ...)`` using both ring
    directions; returns ``(n, n*s, ...)``, every row holding the tiled
    gather in device order.

    The first half of the last axis travels clockwise and the second half
    counter-clockwise (one direction when the last axis has one element),
    through the ``ring_allgather`` kernel on a CUDA tensor.
    """
    n = xs.shape[0]
    if n == 1:
        return xs
    local = xs.shape[1:]
    f = local[-1]
    gathered = ring_allgather(xs.reshape(n, -1, f))
    return gathered.reshape((n, n * local[0]) + tuple(local[1:]))


def bidir_ring_reduce_scatter(xs: torch.Tensor) -> torch.Tensor:
    """Reduce-scatter (sum) of ``xs: (n, n*s, ...)`` using both ring
    directions; returns ``(n, s, ...)``, row *i* holding the sum over
    devices of block *i*.

    The first half of the last axis accumulates clockwise, the second
    counter-clockwise; a 1-D local operand, or one whose last axis has one
    element, takes the single-direction ring.
    """
    n = xs.shape[0]
    if n == 1:
        return xs
    s = xs.shape[1] // n
    local_ndim = xs.dim() - 1
    blocks = xs.reshape((n, n, s) + tuple(xs.shape[2:]))
    dev = _devices(xs)
    f = xs.shape[-1] if local_ndim > 1 else 1
    f0 = f // 2 if local_ndim > 1 else 0

    def blk(offset: int, lo: int | None = None, hi: int | None = None):
        # device i's block (i + offset) mod n, optionally a feature range
        b = blocks[dev, (dev + offset) % n]
        return b if lo is None else b[..., lo:hi]

    if f0 == 0:
        # Single-direction ring (narrow features).
        acc = blk(-1)
        for t in range(1, n):
            acc = torch.roll(acc, 1, dims=0) + blk(-t - 1)
        return acc

    acc0 = blk(-1, 0, f0)
    acc1 = blk(1, f0, None)
    for t in range(1, n):
        acc0 = torch.roll(acc0, 1, dims=0) + blk(-t - 1, 0, f0)
        acc1 = torch.roll(acc1, -1, dims=0) + blk(t + 1, f0, None)
    return torch.cat([acc0, acc1], dim=-1)


def multipath_all_reduce(xs: torch.Tensor) -> torch.Tensor:
    """All-reduce = bidirectional reduce-scatter + bidirectional
    all-gather of ``xs: (n, n*s, ...)``; returns the same shape, every row
    the sum over devices. The local dim 0 must be divisible by ``n``."""
    n = xs.shape[0]
    if n == 1:
        return xs
    return bidir_ring_all_gather(bidir_ring_reduce_scatter(xs))


def multipath_all_to_all(xs: torch.Tensor) -> torch.Tensor:
    """All-to-all of ``xs: (n, n, ...)`` (device *i*'s block *j* is bound
    for device *j*); returns the same shape with ``out[i, j]`` = device
    *j*'s block *i*. Shifts ``+s`` and ``+(n - s)`` travel opposite ring
    directions, as in the reference's step pairing."""
    n = xs.shape[0]
    if n == 1:
        return xs
    dev = _devices(xs)
    out = torch.zeros_like(xs)
    out[dev, dev] = xs[dev, dev]
    for s in range(1, n):
        block = xs[dev, (dev + s) % n]
        out[dev, (dev - s) % n] = torch.roll(block, s, dims=0)
    return out


def psum_via_multipath(xs: torch.Tensor) -> torch.Tensor:
    """Sum of arbitrary-shape operands ``xs: (n, *shape)`` over devices;
    returns ``(n, *shape)``.

    Flattens, pads to a multiple of ``2n``, all-reduces as two feature
    columns (``(-1, 2)``: a single column would fall back to the
    one-directional ring) and restores the shape.
    """
    n = xs.shape[0]
    if n == 1:
        return xs
    size = xs[0].numel()
    flat = xs.reshape(n, -1)
    pad = (-size) % (2 * n)
    if pad:
        flat = F.pad(flat, (0, pad))
    red = multipath_all_reduce(flat.reshape(n, -1, 2))
    return red.reshape(n, -1)[:, :size].reshape(xs.shape)


def two_level_all_reduce(xs: torch.Tensor) -> torch.Tensor:
    """Hierarchical all-reduce of ``xs: (islands, per_island, n_i*s, ...)``
    (dim 0 the slow inter-island axis, dim 1 the fast intra-island axis):
    intra-island reduce-scatter, inter-island :func:`psum_via_multipath` of
    the shards, intra-island all-gather. Returns the same shape, every
    device holding the sum over all devices."""
    islands, per = xs.shape[:2]
    shard = torch.stack([bidir_ring_reduce_scatter(xs[k])
                         for k in range(islands)])
    shard = torch.stack([psum_via_multipath(shard[:, p])
                         for p in range(per)], dim=1)
    return torch.stack([bidir_ring_all_gather(shard[k])
                        for k in range(islands)])


# -- §4.4 tier model: flat ring vs two-level decomposition -------------------

def tier_bandwidths_gbps(topo: Topology) -> tuple[float, float | None]:
    """Bottleneck bandwidth per tier: ``(intra_gbps, inter_gbps)``.

    Minimum directional-link bandwidth inside islands and across them
    (``None`` when the topology has no inter-island links). Host links
    are excluded — host staging is not a collective tier. Bandwidths are
    read through :meth:`~repro_torch.core.topology.Topology.link`.
    """
    intra: list[float] = []
    inter: list[float] = []
    for key in topo.links:
        if HOST in key:
            continue
        link = topo.link(*key)
        (inter if topo.is_inter_island(*key) else intra).append(
            link.bandwidth_gbps)
    if not intra:
        raise ValueError(f"topology {topo.name} has no device links")
    return min(intra), (min(inter) if inter else None)


def modeled_all_reduce_s(topo: Topology, nbytes: int,
                         strategy: str = "flat") -> float:
    """Modeled seconds for an ``nbytes`` all-reduce over all devices.

    ``strategy="flat"`` prices the bidirectional ring over every device:
    ``2(N-1)`` steps of ``nbytes / 2N`` each, bottlenecked by the slowest
    tier the ring must cross (the inter-node tier on hierarchical
    topologies, plus
    :data:`~repro_torch.core.pipelining.INTER_NODE_LATENCY_NS` per step).
    ``strategy="two_level"`` prices the :func:`two_level_all_reduce`
    decomposition — intra steps at the intra tier, only the ``nbytes / M``
    shard crossing islands — and is ``inf`` when islands are
    disconnected.
    """
    from repro_torch.core.pipelining import INTER_NODE_LATENCY_NS

    if nbytes <= 0:
        raise ValueError("nbytes must be positive")
    n = topo.num_devices
    if n <= 1:
        return 0.0
    bw_intra, bw_inter = tier_bandwidths_gbps(topo)
    islands = topo.islands()
    num_islands = len(islands)
    lat = INTER_NODE_LATENCY_NS / 1e9 if num_islands > 1 else 0.0
    if strategy == "flat":
        bottleneck = bw_inter if (num_islands > 1 and bw_inter) else bw_intra
        steps = 2 * (n - 1)
        return steps * ((nbytes / (2 * n)) / (bottleneck * 1e9) + lat)
    if strategy != "two_level":
        raise ValueError(f"unknown all-reduce strategy {strategy!r}")
    if num_islands == 1:
        return modeled_all_reduce_s(topo, nbytes, "flat")
    if bw_inter is None:
        return float("inf")
    m = max(len(devs) for devs in islands)
    t_intra = 2 * (m - 1) * (nbytes / (2 * m)) / (bw_intra * 1e9)
    shard = nbytes / m
    t_inter = 2 * (num_islands - 1) * (
        (shard / (2 * num_islands)) / (bw_inter * 1e9) + lat)
    return t_intra + t_inter


def select_all_reduce_strategy(topo: Topology, nbytes: int,
                               strategy: str = "auto"
                               ) -> tuple[str, dict[str, float]]:
    """Pick the all-reduce layout for ``topo``: ``(chosen, times_s)``.

    ``strategy="auto"``: flat on single-island topologies; on hierarchical
    ones the two-level decomposition wins iff it models strictly faster
    under :func:`modeled_all_reduce_s`. ``"flat"`` / ``"two_level"`` force
    the layout but still return both modeled times. A forced
    ``"two_level"`` falls back to ``"flat"`` when the two-level
    decomposition models infinite time (every egress link of some island
    has failed).
    """
    times = {"flat": modeled_all_reduce_s(topo, nbytes, "flat"),
             "two_level": modeled_all_reduce_s(topo, nbytes, "two_level")}
    if strategy == "two_level" and times["two_level"] == float("inf"):
        return "flat", times
    if strategy in ("flat", "two_level"):
        return strategy, times
    if strategy != "auto":
        raise ValueError(f"unknown all-reduce strategy {strategy!r}")
    if topo.num_islands > 1 and times["two_level"] < times["flat"]:
        return "two_level", times
    return "flat", times
