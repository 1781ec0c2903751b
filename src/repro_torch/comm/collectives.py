"""Multipath-striped collectives over device-stacked tensors or per-device lists.

The port of the reference's bidirectional-ring collectives (the paper's §6
future work: stripe a collective across both ring directions, as a
point-to-point message is striped across idle links). Each collective is
written once, over a **ring**: where the reference takes one device's
local value inside ``shard_map``, a ring holds every logical device's part
and gives the steps that reach across devices — a ``ppermute`` by ``+s``
is :meth:`shift`, the all-gather half :meth:`gather`, and a device's
block picked by ``axis_index`` :meth:`pick`/:meth:`put`. Shape-only and
elementwise work runs through :meth:`each` on dims counted from the end,
which are one device's whatever lies before them.

* :class:`StackedRing` (the default): a **device-stacked** tensor whose
  dim 0 is the logical device; a shift is ``torch.roll``, a pick batched
  indexing, the gather the hand-written ``ring_allgather`` kernel on a
  CUDA tensor (:mod:`repro_torch.kernels.ring_allgather`), its plain
  version on the CPU.
* :class:`PeerRing`: a peer session's logical devices
  (``CommSession(devices=[...])``), a **list** of ``n`` tensors, ``xs[d]``
  on device *d*'s ``torch.device``; a shift is one per-device
  ``multipath_dma`` table of the ring's messages ``d → d + s``, the gather
  the peer ``ring_allgather``, and the adds run on each device after its
  launch. :class:`LockstepRing` drives a peer ring's run over every card
  from one host thread a card (:func:`run_in_lockstep`).

The reductions keep the reference's order of additions —
``acc = shift(acc) + blk(...)`` step by step — so float32 and bfloat16
sums are bit-equal to the reference ring, not just close, in both forms.

Hierarchy (DESIGN §3.1): :func:`two_level_all_reduce` decomposes an
all-reduce over ``(islands, per_island, ...)`` into an intra-island
reduce-scatter, an inter-island all-reduce of the shards and an
intra-island all-gather; :func:`modeled_all_reduce_s` prices both layouts
under the §4.4 tier model and :func:`select_all_reduce_strategy`
arbitrates. The tier model is pure Python and gives the reference's
numbers.
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
import weakref
from typing import Callable

import torch
import torch.nn.functional as F

from repro_torch.core.topology import HOST, Topology
from repro_torch.kernels.ring_allgather.kernel import PeerRingProgram
from repro_torch.kernels.ring_allgather.ops import ring_allgather


def _local(x: torch.Tensor, k: int, shape: tuple) -> torch.Tensor:
    """``x`` with its last ``k`` dims (one device's part) reshaped to
    ``shape``, and any device dim before them kept."""
    return x.reshape(tuple(x.shape[:x.dim() - k]) + tuple(shape))


def _first(parts: list) -> torch.Tensor:
    return next(p for p in parts if p is not None)


class StackedRing:
    """The ring of a device-stacked operand ``(n, ...)``: a part is one
    tensor whose dim 0 is the logical device."""

    def __init__(self, xs: torch.Tensor):
        self.n = xs.shape[0]
        self.device = xs.device

    @functools.cached_property
    def _dev(self) -> torch.Tensor:
        return torch.arange(self.n, device=self.device)

    def local_shape(self, xs: torch.Tensor) -> tuple:
        return tuple(xs.shape[1:])

    def each(self, fn: Callable, *parts):
        """``fn`` on every device's part at once."""
        return fn(*parts)

    def pick(self, xs: torch.Tensor, offset: int) -> torch.Tensor:
        """Device *d*'s block ``(d + offset) mod n`` of its part."""
        return xs[self._dev, (self._dev + offset) % self.n]

    def put(self, xs: torch.Tensor, offset: int, values) -> None:
        """Write ``values`` into device *d*'s block ``(d + offset) mod n``."""
        xs[self._dev, (self._dev + offset) % self.n] = values

    def shift(self, *sends: tuple) -> list:
        """Each ``(parts, s)``: device *d*'s part goes to *d* + *s*."""
        return [torch.roll(parts, s, dims=0) for parts, s in sends]

    def gather(self, shards: torch.Tensor) -> torch.Tensor:
        """The all-gather of ``(n, rows, f)``: ``(n, n, rows, f)``, through
        the ``ring_allgather`` kernel (each shard read once and stored into
        every replica) on a CUDA tensor."""
        return ring_allgather(shards)


class ListRing:
    """A ring whose parts are lists of ``n`` tensors, one a logical device
    (``None`` where a run does not hold the device: the devices of other
    cards, in a one-card run of :class:`PeerRing`). Subclasses give
    ``n``, :meth:`shift` and :meth:`gather`."""

    n: int

    def held(self, d: int) -> bool:
        return True

    def local_shape(self, xs: list) -> tuple:
        return tuple(_first(xs).shape)

    def each(self, fn: Callable, *parts) -> list:
        """``fn`` device by device."""
        return [None if any(a is None for a in args) else fn(*args)
                for args in zip(*parts)]

    def pick(self, xs: list, offset: int) -> list:
        return [None if x is None else x[(d + offset) % self.n]
                for d, x in enumerate(xs)]

    def put(self, xs: list, offset: int, values: list) -> None:
        for d, (x, v) in enumerate(zip(xs, values)):
            if x is not None:
                x[(d + offset) % self.n] = v


class PeerRing(ListRing):
    """The ring steps over a peer engine's logical devices
    (``engine.devices``; a card may hold several).

    * :meth:`shift` moves its sends, each one part a device going
      ``d → d + s``, as the messages of ONE per-device ``multipath_dma``
      table (:meth:`~repro_torch.comm.engine.MultiPathTransfer.step_program`),
      one launch a card;
    * :meth:`gather` is one peer ``ring_allgather``
      (:class:`~repro_torch.kernels.ring_allgather.kernel.PeerRingProgram`):
      each device's shard pushed into every device's replica, one launch
      a card.

    Programs are made resident at their first use and taken in call order
    on every later run, so each step of a collective has buffers of its
    own: no buffer is written twice in one execution, although a sender
    may run several steps ahead of its receiver. Results are views of the
    programs' buffers, which the next run overwrites. :meth:`begin` starts
    a run over every card (``card=None``: each program orders the cards
    and launches on all of them, or runs its plain version on the CPU) or
    over one card alone (``card=c``: stage and launch card ``c``'s share
    only, the body of one CUDA graph a card, whose caller orders the
    cards once an execution; the parts of other cards' devices are
    ``None``). The ring holds its engine weakly: it lives in the engine's
    plan cache."""

    def __init__(self, engine):
        self._engine = weakref.ref(engine)
        self.devices = engine.devices
        self.n = len(self.devices)
        self.cards = tuple(dict.fromkeys(self.devices))
        self.card_of = [self.cards.index(d) for d in self.devices]
        self.card: int | None = None
        self.programs: list = []
        self._next = 0

    def begin(self, card: int | None = None) -> None:
        """Start a run of the collective: over every card, or one."""
        self.card = card
        self._next = 0

    def held(self, d: int) -> bool:
        """Whether this run computes logical device ``d``'s parts."""
        return self.card is None or self.card_of[d] == self.card

    def _program(self, build: Callable):
        if self._next == len(self.programs):
            if self.card is not None:
                raise RuntimeError("a one-card run replays the programs of "
                                   "a run over every card")
            self.programs.append(build())
        prog = self.programs[self._next]
        self._next += 1
        if self.card is None:
            return prog, prog.run
        return prog, functools.partial(prog.run_card, self.card)

    def shift(self, *sends: tuple[list, int]) -> list[list]:
        """Move every ``(parts, s)`` send one ring shift: ``parts[d]`` (one
        shape and dtype for all ``d``) goes from device ``d`` to ``d + s``.
        Returns, per send, the parts received: device ``d``'s is the part
        of ``d - s``."""
        n = self.n
        refs = [_first(parts) for parts, _ in sends]
        prog, execute = self._program(lambda: self._engine().step_program(
            [(d, (d + s) % n, ref.numel(), ref.dtype)
             for (_, s), ref in zip(sends, refs) for d in range(n)]))
        bufs = prog.inputs()
        for k, ((parts, _), ref) in enumerate(zip(sends, refs)):
            for d, part in enumerate(parts):
                if part is not None:
                    bufs[k * n + d][d].view(ref.shape).copy_(part)
        execute()
        outs = prog.outputs()
        return [[outs[k * n + (d - s) % n][d].view(ref.shape)
                 if self.held(d) else None for d in range(n)]
                for k, ((_, s), ref) in enumerate(zip(sends, refs))]

    def gather(self, shards: list) -> list:
        """The peer all-gather of ``shards[d]: (rows, f)``: each device's
        replica ``(n, rows, f)``, every shard pushed into every replica."""
        ref = _first(shards)
        prog, execute = self._program(lambda: PeerRingProgram(
            *ref.shape, ref.dtype, self.devices))
        for d, x in enumerate(shards):
            if x is not None:
                prog.x[d].copy_(x)
        execute()
        return [out if self.held(d) else None
                for d, out in enumerate(prog.out)]


#: Seconds a card's thread waits at a :class:`LockstepRing` step for the
#: others before the run fails (a body that stopped short of a step).
LOCKSTEP_TIMEOUT_S = 120.0


class LockstepRing(ListRing):
    """A :class:`PeerRing`'s run over every card, driven by one host thread
    a card (:func:`run_in_lockstep`): each card's thread computes its own
    logical devices' parts, and at every shift or gather the threads meet
    at a barrier, where one of them runs the peer ring's step over every
    card at once on the parts they brought. No card's launch then waits on
    a card whose host thread is blocked (a caching allocator's retry, a
    read back), as one thread enqueueing each card's whole share in turn
    would risk. The peer ring must have begun a run over every card
    (``ring.begin()``); the programs it builds are those a one-card run of
    each card then replays."""

    def __init__(self, ring: PeerRing):
        self.ring = ring
        self.n = ring.n
        self.card_of = ring.card_of
        self.cards = len(ring.cards)
        self._local = threading.local()
        self._lock = threading.Lock()
        self._pending: tuple | None = None
        self._result: list | None = None
        self.barrier = threading.Barrier(self.cards, action=self._act,
                                         timeout=LOCKSTEP_TIMEOUT_S)

    def enter(self, card: int) -> None:
        """Make this thread card ``card``'s."""
        self._local.card = card

    def held(self, d: int) -> bool:
        return self.card_of[d] == self._local.card

    def _meet(self, step: Callable, parts: list[list]) -> list:
        """Bring this card's parts (None elsewhere) to the barrier; one
        thread runs ``step`` on every card's, and each gets its result."""
        with self._lock:
            if self._pending is None:
                self._pending = (step, [[None] * self.n for _ in parts])
            merged = self._pending[1]
            for k, row in enumerate(parts):
                for d, part in enumerate(row):
                    if part is not None:
                        merged[k][d] = part
        self.barrier.wait()
        return self._result

    def _act(self) -> None:
        step, merged = self._pending
        self._pending = None
        self._result = step(merged)

    def _mine(self, full: list) -> list:
        return [full[d] if self.held(d) else None for d in range(self.n)]

    def shift(self, *sends: tuple[list, int]) -> list[list]:
        offsets = [s for _, s in sends]
        full = self._meet(lambda merged: self.ring.shift(
            *zip(merged, offsets)), [parts for parts, _ in sends])
        return [self._mine(recv) for recv in full]

    def gather(self, shards: list) -> list:
        (full,) = self._meet(lambda merged: [self.ring.gather(merged[0])],
                             [shards])
        return self._mine(full)


def run_in_lockstep(ring: LockstepRing, bodies: list) -> None:
    """Run ``bodies``, one ``(device, fn)`` a card (``fn(card)``), each on
    a host thread of its own with ``device`` current, meeting at
    ``ring``'s steps; the first error of any body is raised once every
    thread has ended (a failed body breaks the barrier the others wait
    at)."""
    errors: list[BaseException] = []

    def work(card: int, device: torch.device, fn: Callable) -> None:
        try:
            ring.enter(card)
            ctx = (torch.cuda.device(device) if device.type == "cuda"
                   else contextlib.nullcontext())
            with ctx:
                fn(card)
        except BaseException as exc:    # noqa: BLE001 - re-raised below
            errors.append(exc)
            ring.barrier.abort()

    threads = [threading.Thread(target=work, args=(c, dev, fn))
               for c, (dev, fn) in enumerate(bodies)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise next((e for e in errors
                    if not isinstance(e, threading.BrokenBarrierError)),
                   errors[0])


def _ring(xs, ring):
    return StackedRing(xs) if ring is None else ring


def bidir_ring_all_gather(xs, ring=None):
    """All-gather of the shards ``(s, ...)`` of ``ring``'s devices using
    both ring directions: every device gets the tiled gather in device
    order, ``(n*s, ...)``. Stacked (the default ring): ``xs: (n, s, ...)``
    → ``(n, n*s, ...)``.

    The result is the reference's, whose ring carries the first half of
    the last axis clockwise and the second half counter-clockwise. The
    gather runs through the ``ring_allgather`` kernel on CUDA tensors,
    which reads each shard once and stores it into every replica.
    """
    ring = _ring(xs, ring)
    n = ring.n
    if n == 1:
        return xs
    local = ring.local_shape(xs)
    k, f = len(local), local[-1]
    replicas = ring.gather(ring.each(lambda x: _local(x, k, (-1, f)), xs))
    return ring.each(
        lambda r: _local(r, 3, (n * local[0],) + local[1:]), replicas)


def bidir_ring_reduce_scatter(xs, ring=None):
    """Reduce-scatter (sum) of the operands ``(n*s, ...)`` of ``ring``'s
    devices using both ring directions: device *i* gets the sum over
    devices of block *i*, ``(s, ...)``. Stacked: ``xs: (n, n*s, ...)`` →
    ``(n, s, ...)``.

    The first half of the last axis accumulates clockwise, the second
    counter-clockwise; a 1-D local operand, or one whose last axis has one
    element, takes the single-direction ring.
    """
    ring = _ring(xs, ring)
    n = ring.n
    if n == 1:
        return xs
    local = ring.local_shape(xs)
    k = len(local)
    s = local[0] // n
    f = local[-1] if k > 1 else 1
    f0 = f // 2 if k > 1 else 0
    blocks = ring.each(lambda x: _local(x, k, (n, s) + local[1:]), xs)

    def blk(offset: int, lo: int | None = None, hi: int | None = None):
        # device d's block (d + offset) mod n, optionally a feature range
        b = ring.pick(blocks, offset)
        return b if lo is None else ring.each(lambda v: v[..., lo:hi], b)

    if f0 == 0:
        # Single-direction ring (narrow features).
        acc = blk(-1)
        for t in range(1, n):
            (recv,) = ring.shift((acc, 1))
            acc = ring.each(torch.add, recv, blk(-t - 1))
        return acc

    acc0 = blk(-1, 0, f0)
    acc1 = blk(1, f0, None)
    for t in range(1, n):
        recv0, recv1 = ring.shift((acc0, 1), (acc1, -1))
        acc0 = ring.each(torch.add, recv0, blk(-t - 1, 0, f0))
        acc1 = ring.each(torch.add, recv1, blk(t + 1, f0, None))
    return ring.each(lambda a, b: torch.cat([a, b], dim=-1), acc0, acc1)


def multipath_all_reduce(xs, ring=None):
    """All-reduce = bidirectional reduce-scatter + bidirectional
    all-gather: every device gets the sum over devices, in its operand's
    shape, whose dim 0 must be divisible by ``n`` (stacked: ``xs: (n,
    n*s, ...)``)."""
    ring = _ring(xs, ring)
    if ring.n == 1:
        return xs
    return bidir_ring_all_gather(bidir_ring_reduce_scatter(xs, ring), ring)


def multipath_all_to_all(xs, ring=None):
    """All-to-all of the operands ``(n, ...)`` of ``ring``'s devices
    (device *i*'s block *j* is bound for device *j*): device *i* gets
    ``out[j]`` = device *j*'s block *i* (stacked: ``xs: (n, n, ...)``, the
    same shape out). Shifts ``+s`` and ``+(n - s)`` travel opposite ring
    directions, as in the reference's step pairing; over peers step *s*'s
    ``n`` blocks ``d → d + s`` are one table."""
    ring = _ring(xs, ring)
    n = ring.n
    if n == 1:
        return xs
    out = ring.each(torch.zeros_like, xs)
    ring.put(out, 0, ring.pick(xs, 0))
    for s in range(1, n):
        (recv,) = ring.shift((ring.pick(xs, s), s))
        ring.put(out, -s, recv)
    return out


def psum_via_multipath(xs, ring=None):
    """Sum of arbitrary-shape operands over ``ring``'s devices, each
    device's in its own shape (stacked: ``xs: (n, *shape)``).

    Flattens, pads to a multiple of ``2n``, all-reduces as two feature
    columns (``(-1, 2)``: a single column would fall back to the
    one-directional ring) and restores the shape.
    """
    ring = _ring(xs, ring)
    n = ring.n
    if n == 1:
        return xs
    local = ring.local_shape(xs)
    k = len(local)
    size = math.prod(local)
    pad = (-size) % (2 * n)

    def flat(x):
        x = _local(x, k, (-1,))
        return _local(F.pad(x, (0, pad)) if pad else x, 1, (-1, 2))

    red = multipath_all_reduce(ring.each(flat, xs), ring)
    return ring.each(
        lambda r: _local(_local(r, 2, (-1,))[..., :size], 1, local), red)


#: Each collective by its session name.
FORMS = {"all_gather": bidir_ring_all_gather,
         "reduce_scatter": bidir_ring_reduce_scatter,
         "all_reduce": multipath_all_reduce,
         "all_to_all": multipath_all_to_all,
         "psum": psum_via_multipath}


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
