"""The ``ring_allgather`` kernel: a bidirectional-ring all-gather in one launch.

Replaces the Pallas kernel ``build_ring_allgather`` of the reference package
(``src/repro/kernels/ring_allgather/kernel.py``). There, each chip holds one
shard ``(rows, f)`` and, over ``N - 1`` ring steps, forwards the first half
of the features clockwise and the second half counter-clockwise with remote
DMAs. Here the logical devices are rows of one stacked tensor
``xs: (n, rows, f)`` on one card, and device ``d``'s replica of the gather
is ``out[d]: (n, rows, f)``; the ring's copies run between replicas.

:func:`ring_allgather_cuda` launches the hand-written kernel
(``csrc/ring_allgather.cu``, built by :mod:`repro_torch.kernels._build`);
:func:`ring_allgather_plain` replays the same ring step by step with
``torch.roll`` and slice writes, the plain PyTorch version used for CPU
tensors and as the check of the kernel on the card. :data:`LAUNCHES` counts
kernel launches. A meta tensor, which a cost count
(:mod:`repro_torch.launch.cost`) passes, gets the CUDA wrapper's checks
and an empty output, launching nothing.

The peer form runs the reference's ring across cards: logical device *d*
holds its shard ``(rows, f)`` and its replica ``(n, rows, f)`` on its own
``torch.device``, and each card launches once over the items it executes
(the sender pushes each tile into the receiver's memory, under
epoch-stamped flags on the receiver's card; :func:`peer_card_items` is
the kernel's decode). :class:`PeerRingProgram` keeps its buffers,
pointer tables and state words resident (one body a card for a CUDA
graph), :func:`ring_allgather_peer_cuda` runs one made for the call on
per-device CUDA tensors, and :func:`ring_allgather_peer_plain` is its
plain version.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._graph import GraphProgram
from repro_torch.launch import cost

#: Largest tile, in bytes, that one block copies in one work item.
TILE_BYTES = 128 << 10
#: Blocks per SM of the persistent grid.
_BLOCKS_PER_SM = 2
#: State words of a card before its flags in the peer form: ticket,
#: completed copy items, replay epoch, one spare (``csrc/ring_allgather.cu``).
PEER_STATE_HEADER = 4

#: Kernel launches so far.
LAUNCHES = 0


def ring_half(f: int) -> int:
    """Width of the clockwise half: ``f // 2``, or ``f`` when that is 0
    (the narrow case runs one direction only)."""
    return f // 2 or f


def ring_allgather_plain(xs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``xs: (n, rows, f)`` → ``(n, n, rows, f)``,
    where ``out[d]`` is device ``d``'s replica of the tiled gather.

    Replays the ring: each step rolls the travelling halves one device on
    (clockwise for ``[..., :half]``, counter-clockwise for the rest) and
    writes them into the block they carry."""
    n, rows, f = xs.shape
    half = ring_half(f)
    out = xs.new_zeros((n, n, rows, f))
    dev = torch.arange(n, device=xs.device)
    out[dev, dev] = xs
    cur0, cur1 = xs[..., :half], xs[..., half:]
    for step in range(1, n):
        cur0 = torch.roll(cur0, 1, dims=0)        # d receives from d - 1
        out[dev, (dev - step) % n, :, :half] = cur0
        if half < f:
            cur1 = torch.roll(cur1, -1, dims=0)   # d receives from d + 1
            out[dev, (dev + step) % n, :, half:] = cur1
    return out


@dataclasses.dataclass(frozen=True)
class RingGeometry:
    """The kernel's work decomposition for one ``(n, rows, f)`` shape:
    items are ``(phase, device, direction, tile)`` with ``rtiles × ctiles``
    tiles of at most ``rpt`` rows by ``cc`` columns per direction."""

    n: int
    rows: int
    f: int
    itemsize: int
    half: int
    ndir: int
    rpt: int
    cc: int
    rtiles: int
    ctiles: int

    @classmethod
    def for_shape(cls, n: int, rows: int, f: int, itemsize: int,
                  tile_bytes: int = TILE_BYTES) -> "RingGeometry":
        half = ring_half(f)
        ndir = 2 if half < f else 1
        widest = max(half, f - half)
        cc = max(1, min(widest, tile_bytes // itemsize))
        rpt = max(1, tile_bytes // (cc * itemsize))
        return cls(n, rows, f, itemsize, half, ndir, rpt, cc,
                   -(-rows // rpt), -(-widest // cc))

    @property
    def num_items(self) -> int:
        return self.n * self.n * self.ndir * self.rtiles * self.ctiles

    def bytes_moved(self) -> tuple[int, int]:
        """(bytes read, bytes written) by the ring: every block of every
        replica is written once and read once (from the input shard or a
        neighbour's replica)."""
        block = self.rows * self.f * self.itemsize
        return self.n * self.n * block, self.n * self.n * block


def _lib():
    lib = _build.load("ring_allgather")
    fn = lib.ring_allgather_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 11
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    peer = lib.ring_allgather_peer_launch
    peer.argtypes = ([ctypes.c_void_p] + [ctypes.c_int64] * 13
                     + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    peer.restype = ctypes.c_int
    return lib


def ring_allgather_cuda(xs: torch.Tensor, *,
                        state: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor ``xs: (n, rows, f)``; returns a
    new ``(n, n, rows, f)`` tensor. ``state``, when given, receives the
    kernel's state words (``state[1]`` = completed items after the run);
    it must hold at least ``2 + num_items`` int32 words. A meta tensor
    gets the same checks and an empty output, and launches nothing; both
    report the kernel's bytes to the cost counter
    (:func:`~repro_torch.launch.cost.record_kernel`)."""
    global LAUNCHES
    if xs.device.type not in ("cuda", "meta"):
        raise ValueError(f"ring_allgather kernel needs a CUDA tensor, got "
                         f"{xs.device}")
    if xs.dim() != 3 or xs.numel() == 0:
        raise ValueError(f"xs must be a non-empty (n, rows, f) tensor, got "
                         f"{tuple(xs.shape)}")
    xs = xs.contiguous()
    n, rows, f = xs.shape
    g = RingGeometry.for_shape(n, rows, f, xs.element_size())
    out = torch.empty((n, n, rows, f), dtype=xs.dtype, device=xs.device)
    if state is None:
        state = torch.empty(2 + g.num_items, dtype=torch.int32,
                            device=xs.device)
    elif (state.dtype != torch.int32 or state.device != xs.device
          or state.numel() < 2 + g.num_items):
        raise ValueError("state must be int32 on the input's device with "
                         f"at least {2 + g.num_items} words")
    state.zero_()
    if xs.device.type == "cuda":
        sms = torch.cuda.get_device_properties(
            xs.device).multi_processor_count
        grid = max(1, min(g.num_items, _BLOCKS_PER_SM * sms))
        rc = _lib().ring_allgather_launch(
                    xs.data_ptr(), out.data_ptr(), state.data_ptr(), g.n,
                    g.rows, g.f, g.itemsize, g.half, g.ndir, g.rpt, g.cc,
                    g.rtiles, g.ctiles, g.num_items, grid,
                    torch.cuda.current_stream(xs.device).cuda_stream)
        _build.check(rc, "ring_allgather")
        LAUNCHES += 1
    cost.record_kernel("ring_allgather", 0, (xs,), (out,))
    return out


# -- across cards: one shard and one replica a logical device ----------------

def ring_allgather_peer_plain(shards: Sequence[torch.Tensor]
                              ) -> list[torch.Tensor]:
    """Plain PyTorch version of the peer form: ``shards[d]: (rows, f)`` on
    logical device *d*'s device → ``out[d]: (n, rows, f)`` on the same
    device, *d*'s replica. Replays the ring: each step copies the
    travelling halves from the neighbours' replicas (clockwise
    ``[..., :half]`` from *d* − 1, the rest from *d* + 1) into the block
    they carry, as :func:`ring_allgather_plain` does on stacked shards."""
    n = len(shards)
    rows, f = shards[0].shape
    half = ring_half(f)
    outs = [x.new_zeros((n, rows, f)) for x in shards]
    for d, x in enumerate(shards):
        outs[d][d] = x
    for step in range(1, n):
        for d, out in enumerate(outs):
            b = (d - step) % n
            out[b, :, :half] = outs[(d - 1) % n][b, :, :half].to(out.device)
            if half < f:
                b = (d + step) % n
                out[b, :, half:] = outs[(d + 1) % n][b, :, half:].to(
                    out.device)
    return outs


def peer_card_items(g: RingGeometry, mine: Sequence[int]) -> np.ndarray:
    """One card's tickets in the peer form, as ``csrc/ring_allgather.cu``
    decodes them, for the card that holds logical devices ``mine``: rows
    of ``(phase, sender, receiver, direction, tile, item, wait)``.

    Phases run 0..n−1 and then a wait-only phase n; within a phase the
    card's own devices, directions and tiles. ``item`` is the global
    index ``((phase·n + receiver)·ndir + direction)·tiles + tile`` whose
    flag the item sets on the receiver's card (−1 for phase n's waits);
    ``wait`` the global index of the flag it waits on, on its own card
    (−1: phase 0 waits on nothing). Phase 0 copies the shard of its own
    device, a later phase's sender pushes into its neighbour."""
    n = g.n
    tiles = g.rtiles * g.ctiles

    def index(p, d, dr, t):
        return ((p * n + d) * g.ndir + dr) * tiles + t

    rows = []
    for p in range(n + 1):
        for e in mine:
            for dr in range(g.ndir):
                for t in range(tiles):
                    if p == n:
                        rows.append((p, e, e, dr, t, -1,
                                     index(n - 1, e, dr, t)))
                        continue
                    d = e if p == 0 else ((e - 1) % n if dr else (e + 1) % n)
                    wait = -1 if p == 0 else index(p - 1, e, dr, t)
                    rows.append((p, e, d, dr, t, index(p, d, dr, t), wait))
    return np.asarray(rows, dtype=np.int64).reshape(-1, 7)


class CardLaunch(NamedTuple):
    """One card's share of the peer form: its index among the cards, its
    space table (on the card), state words, logical devices and grid."""

    card: int
    table: torch.Tensor
    state: torch.Tensor
    num_devices: int
    grid: int


def _placement(devices: Sequence[torch.device]
               ) -> tuple[tuple[torch.device, ...], list[int]]:
    """The distinct cards in first-use order and each device's card."""
    cards = tuple(dict.fromkeys(devices))
    return cards, [cards.index(d) for d in devices]


def _card_launches(g: RingGeometry, xs: Sequence[torch.Tensor],
                   outs: Sequence[torch.Tensor]) -> list[CardLaunch]:
    """Every card's space table (``x`` and ``out`` pointers, every card's
    state words, each device's card, the card's own devices) and fresh
    state words (epoch 0, flags 0), one launch a card."""
    cards, card_of = _placement([x.device for x in xs])
    states = [torch.zeros(PEER_STATE_HEADER + g.num_items,
                          dtype=torch.int32, device=c) for c in cards]
    common = ([x.data_ptr() for x in xs] + [o.data_ptr() for o in outs]
              + [s.data_ptr() for s in states] + card_of)
    launches = []
    for c, card in enumerate(cards):
        mine = [d for d, k in enumerate(card_of) if k == c]
        tickets = (g.n + 1) * len(mine) * g.ndir * g.rtiles * g.ctiles
        sms = torch.cuda.get_device_properties(card).multi_processor_count
        launches.append(CardLaunch(
            c, torch.tensor(common + mine, dtype=torch.int64).to(card),
            states[c], len(mine), max(1, min(tickets, _BLOCKS_PER_SM * sms))))
    return launches


def _launch_card(g: RingGeometry, launch: CardLaunch, ncards: int) -> None:
    global LAUNCHES
    card = launch.state.device
    with torch.cuda.device(card):        # the stream's own card
        rc = _lib().ring_allgather_peer_launch(
            launch.table.data_ptr(), ncards, launch.num_devices, launch.card,
            g.n, g.rows, g.f, g.itemsize, g.half, g.ndir, g.rpt, g.cc,
            g.rtiles, g.ctiles, launch.state.data_ptr(), launch.grid,
            torch.cuda.current_stream(card).cuda_stream)
    _build.check(rc, "ring_allgather")
    LAUNCHES += 1


def _check_shards(shards: Sequence[torch.Tensor]) -> tuple[int, int]:
    if not shards:
        raise ValueError("the peer ring needs at least one shard")
    rows_f = tuple(shards[0].shape)
    if len(rows_f) != 2 or shards[0].numel() == 0:
        raise ValueError(f"each shard must be a non-empty (rows, f) tensor, "
                         f"got {rows_f}")
    for x in shards:
        if tuple(x.shape) != rows_f or x.dtype != shards[0].dtype:
            raise ValueError("the shards must share one shape and dtype")
    return rows_f


def _enable_peers(cards: Sequence[torch.device]) -> None:
    if len(cards) > 1:
        from repro_torch.kernels.multipath_dma.kernel import enable_peers
        enable_peers(cards)


def ring_allgather_peer_cuda(shards: Sequence[torch.Tensor]
                             ) -> list[torch.Tensor]:
    """Launch the peer form once on per-device CUDA tensors, through a
    :class:`PeerRingProgram` made for the call: ``shards[d]: (rows, f)``
    on logical device *d*'s card (a card may hold several) → new replicas
    ``(n, rows, f)``, each on its shard's card. Meta shards get the checks
    and empty replicas and launch nothing; both report the kernel's bytes
    to the cost counter."""
    kinds = {x.device.type for x in shards}
    if not kinds <= {"cuda", "meta"} or len(kinds) != 1:
        raise ValueError(f"the peer ring_allgather kernel needs CUDA "
                         f"tensors, got {[str(x.device) for x in shards]}")
    rows, f = _check_shards(shards)
    if kinds == {"meta"}:
        outs = [torch.empty((len(shards), rows, f), dtype=x.dtype,
                            device=x.device) for x in shards]
    else:
        prog = PeerRingProgram(rows, f, shards[0].dtype,
                               [x.device for x in shards])
        for buf, x in zip(prog.x, shards):
            buf.copy_(x)
        prog.run()
        outs = prog.out
    cost.record_kernel("ring_allgather", 0, shards, outs)
    return outs


class PeerRingProgram(GraphProgram):
    """The peer form made resident on its logical devices: one shard
    ``(rows, f)`` and one replica ``(n, rows, f)`` a logical device on
    ``devices[d]`` (``inputs()``/``outputs()``: one list each), and on
    CUDA one space table and state words a card.

    :meth:`run` orders the cards and launches each card's share (the
    plain version on the CPU); :meth:`run_card` launches one card's share
    alone, for a caller that orders the cards itself (a program of
    several steps, recorded one graph a card); :meth:`bodies` gives one
    such launch a card to :meth:`~GraphProgram.record`. The state words'
    epochs persist, so every execution must run on every card."""

    def __init__(self, rows: int, f: int, dtype: torch.dtype,
                 devices: Sequence[torch.device | str]):
        self.devices = tuple(torch.device(d) for d in devices)
        self._cards, _ = _placement(self.devices)
        self.device = self._cards[0]
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        n = len(self.devices)
        self.geometry = RingGeometry.for_shape(n, rows, f, dtype.itemsize)
        self.x = [torch.zeros((rows, f), dtype=dtype, device=d)
                  for d in self.devices]
        self.out = [torch.zeros((n, rows, f), dtype=dtype, device=d)
                    for d in self.devices]
        self.launches: list[CardLaunch] = []
        if self.device.type == "cuda":
            _enable_peers(self._cards)
            self.launches = _card_launches(self.geometry, self.x, self.out)

    @property
    def cards(self) -> tuple[torch.device, ...]:
        return self._cards

    def inputs(self) -> list[list[torch.Tensor]]:
        return [self.x]

    def outputs(self) -> list[list[torch.Tensor]]:
        return [self.out]

    def run_card(self, card: int) -> None:
        """Launch card ``card``'s share (no ordering across cards)."""
        _launch_card(self.geometry, self.launches[card], len(self._cards))

    def bodies(self) -> list[tuple[torch.device, Callable[[], None]]]:
        return [(self._cards[launch.card],
                 functools.partial(self.run_card, launch.card))
                for launch in self.launches]

    def run(self) -> None:
        if self.device.type != "cuda":
            for out, want in zip(self.out, ring_allgather_peer_plain(self.x)):
                out.copy_(want)
            return
        self.order()
        for launch in self.launches:
            self.run_card(launch.card)

    def completed_items(self) -> int:
        """Copy items the last execution completed, summed over the cards
        (synchronises; equal to ``geometry.num_items`` after a whole
        execution)."""
        return sum(int(launch.state[1].item()) for launch in self.launches)
