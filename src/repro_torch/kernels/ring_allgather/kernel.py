"""The ``ring_allgather`` kernel: an all-gather in one launch, each shard read
once and pushed straight into every replica.

Replaces the Pallas kernel ``build_ring_allgather`` of the reference package
(``src/repro/kernels/ring_allgather/kernel.py``). There, each chip holds one
shard ``(rows, f)`` and, over ``N - 1`` ring steps, forwards the first half
of the features clockwise and the second half counter-clockwise with remote
DMAs, a schedule for a TPU torus. Here the logical devices are rows of one
stacked tensor ``xs: (n, rows, f)`` on one card, and device ``d``'s replica
of the gather is ``out[d]: (n, rows, f)``. The kernel computes the same
function without the ring: its work items are (shard, chunk), a chunk a
contiguous range of the shard, loaded once and stored into every replica
(:class:`RingGeometry`), so it reads ``n·S`` and writes ``n²·S`` bytes.

:func:`ring_allgather_cuda` launches the hand-written kernel
(``csrc/ring_allgather.cu``, built by :mod:`repro_torch.kernels._build`);
:func:`ring_allgather_plain` replays the reference's ring step by step with
``torch.roll`` and slice writes, the plain PyTorch version used for CPU
tensors and as the check of the kernel on the card. :data:`LAUNCHES` counts
kernel launches. A meta tensor, which a cost count
(:mod:`repro_torch.launch.cost`) passes, gets the CUDA wrapper's checks
and an empty output, launching nothing.

The peer form runs across cards: logical device *d* holds its shard
``(rows, f)`` and its replica ``(n, rows, f)`` on its own ``torch.device``,
and each card launches once over the items of its own logical devices,
each chunk pushed into every receiver's memory, then waits on the
epoch-stamped flags that every sender sets on its card
(:func:`peer_card_items` is the kernel's decode). :class:`PeerRingProgram`
keeps its buffers, pointer tables and state words resident (one body a
card for a CUDA graph), :func:`ring_allgather_peer_cuda` runs one made for
the call on per-device CUDA tensors, and :func:`ring_allgather_peer_plain`
is its plain version.
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

#: Largest chunk, in bytes, of a shard that one block pushes in one item.
TILE_BYTES = 128 << 10
#: Smallest chunk the default geometry halves its chunks down to.
MIN_TILE_BYTES = 16 << 10
#: Items the default geometry halves its chunks to reach: about three for
#: each block of the persistent grid on a 132-SM card (264 blocks), so
#: that blocks end within a chunk of each other.
TARGET_ITEMS = 768
#: Blocks per SM of the persistent grid.
_BLOCKS_PER_SM = 2
#: Threads of a block (``csrc/ring_allgather.cu``): a wait ticket of the
#: peer form covers this many flags, one a thread.
THREADS = 512
#: State words of the stacked kernel: ticket, completed items.
STATE_WORDS = 2
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
    """The kernel's work decomposition for ``n`` shards of ``shard_bytes``:
    items are (shard, chunk), ``chunks`` contiguous chunks of at most
    ``chunk_bytes`` a shard, each read once and stored into all ``n``
    replicas."""

    n: int
    shard_bytes: int
    chunk_bytes: int

    @classmethod
    def for_shape(cls, n: int, rows: int, f: int, itemsize: int,
                  tile_bytes: int | None = None) -> "RingGeometry":
        """Chunks of ``tile_bytes``, or by default of :data:`TILE_BYTES`
        halved while the items number fewer than :data:`TARGET_ITEMS`
        (down to :data:`MIN_TILE_BYTES`)."""
        shard = rows * f * itemsize
        if tile_bytes is None:
            tile_bytes = TILE_BYTES
            while (tile_bytes > MIN_TILE_BYTES
                   and n * -(-shard // tile_bytes) < TARGET_ITEMS):
                tile_bytes //= 2
        return cls(n, shard, tile_bytes)

    @property
    def chunks(self) -> int:
        return -(-self.shard_bytes // self.chunk_bytes)

    @property
    def num_items(self) -> int:
        return self.n * self.chunks

    def chunk(self, c: int) -> tuple[int, int]:
        """(byte offset, bytes) of chunk ``c`` within a shard."""
        off = c * self.chunk_bytes
        return off, min(self.chunk_bytes, self.shard_bytes - off)

    def bytes_moved(self) -> tuple[int, int]:
        """(bytes read, bytes written): each shard is read once and
        written into every replica."""
        return (self.n * self.shard_bytes,
                self.n * self.n * self.shard_bytes)


@functools.cache
def _lib():
    lib = _build.load("ring_allgather")
    fn = lib.ring_allgather_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 4
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    peer = lib.ring_allgather_peer_launch
    peer.argtypes = ([ctypes.c_void_p] + [ctypes.c_int64] * 7
                     + [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    peer.restype = ctypes.c_int
    return lib


@functools.cache
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def ring_allgather_cuda(xs: torch.Tensor, *,
                        state: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor ``xs: (n, rows, f)``; returns a
    new ``(n, n, rows, f)`` tensor. ``state``, when given, receives the
    kernel's state words (``state[1]`` = completed items after the run);
    it must hold at least :data:`STATE_WORDS` int32 words. A meta tensor
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
        state = torch.empty(STATE_WORDS, dtype=torch.int32,
                            device=xs.device)
    elif (state.dtype != torch.int32 or state.device != xs.device
          or state.numel() < STATE_WORDS):
        raise ValueError("state must be int32 on the input's device with "
                         f"at least {STATE_WORDS} words")
    state.zero_()
    if xs.device.type == "cuda":
        grid = max(1, min(g.num_items, _BLOCKS_PER_SM * _sms(xs.device)))
        rc = _lib().ring_allgather_launch(
            xs.data_ptr(), out.data_ptr(), state.data_ptr(), g.n,
            g.shard_bytes, g.chunk_bytes, g.chunks, grid,
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


class CardTickets(NamedTuple):
    """One card's tickets in the peer form, in ticket order: ``copies``
    first, rows of ``(sender, chunk, flag)``, then ``waits``, rows of
    ``(first flag, end flag)``."""

    copies: np.ndarray
    waits: np.ndarray


def peer_card_items(g: RingGeometry, mine: Sequence[int]) -> CardTickets:
    """One card's tickets in the peer form, as ``csrc/ring_allgather.cu``
    decodes them, for the card that holds logical devices ``mine``.

    A copy ticket pushes chunk ``chunk`` of ``sender``'s shard into every
    logical device's replica, then sets flag ``sender·chunks + chunk`` on
    every card; it waits on nothing. A wait ticket waits on the card's
    flags ``[first, end)``, :data:`THREADS` of the ``n·chunks`` at most,
    one a thread."""
    copies = [(e, c, e * g.chunks + c)
              for e in mine for c in range(g.chunks)]
    nflags = g.n * g.chunks
    waits = [(f, min(f + THREADS, nflags)) for f in range(0, nflags, THREADS)]
    return CardTickets(np.asarray(copies, dtype=np.int64).reshape(-1, 3),
                       np.asarray(waits, dtype=np.int64).reshape(-1, 2))


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
    state words, the card's own devices) and fresh state words (epoch 0,
    flags 0), one launch a card."""
    cards, card_of = _placement([x.device for x in xs])
    states = [torch.zeros(PEER_STATE_HEADER + g.num_items,
                          dtype=torch.int32, device=c) for c in cards]
    common = ([x.data_ptr() for x in xs] + [o.data_ptr() for o in outs]
              + [s.data_ptr() for s in states])
    launches = []
    for c, card in enumerate(cards):
        mine = [d for d, k in enumerate(card_of) if k == c]
        tickets = sum(map(len, peer_card_items(g, mine)))
        launches.append(CardLaunch(
            c, torch.tensor(common + mine, dtype=torch.int64).to(card),
            states[c], len(mine),
            max(1, min(tickets, _BLOCKS_PER_SM * _sms(card)))))
    return launches


def _launch_card(g: RingGeometry, launch: CardLaunch, ncards: int) -> None:
    global LAUNCHES
    card = launch.state.device
    with torch.cuda.device(card):        # the stream's own card
        rc = _lib().ring_allgather_peer_launch(
            launch.table.data_ptr(), ncards, launch.num_devices, launch.card,
            g.n, g.shard_bytes, g.chunk_bytes, g.chunks,
            launch.state.data_ptr(), launch.grid,
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
    epochs persist, so every execution must run on every card. ``x`` and
    ``out``, when given, are the shards and replicas (contiguous, one a
    logical device on its device: a peer step's arena views), and the
    program allocates none."""

    def __init__(self, rows: int, f: int, dtype: torch.dtype,
                 devices: Sequence[torch.device | str], *,
                 x: Sequence[torch.Tensor] | None = None,
                 out: Sequence[torch.Tensor] | None = None):
        self.devices = tuple(torch.device(d) for d in devices)
        self._cards, _ = _placement(self.devices)
        self.device = self._cards[0]
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device}")
        n = len(self.devices)
        self.geometry = RingGeometry.for_shape(n, rows, f, dtype.itemsize)
        self.x = list(x) if x is not None else [
            torch.zeros((rows, f), dtype=dtype, device=d)
            for d in self.devices]
        self.out = list(out) if out is not None else [
            torch.zeros((n, rows, f), dtype=dtype, device=d)
            for d in self.devices]
        for t, shape in ((self.x[0], (rows, f)), (self.out[0], (n, rows, f))):
            if tuple(t.shape) != shape or not t.is_contiguous():
                raise ValueError(f"buffers must be contiguous {shape}, got "
                                 f"{tuple(t.shape)}")
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
