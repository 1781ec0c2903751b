"""The ``multipath_dma`` kernel: one transfer graph, one launch a card.

Replaces the Pallas kernel ``build_multipath_dma`` of the reference package
(``src/repro/kernels/multipath_dma/kernel.py``). There, each copy node of a
plan is a remote DMA between chips. Here the logical devices are laid out
one of two ways:

* **stacked**: the rows of one operand ``(window, num_devices, nelems)`` on
  one card, so each copy node moves bytes from one row (or staging slot)
  to another (:class:`DmaProgram`);
* **per device**: each logical device holds its own operand, output and
  staging buffer, ``(window, nelems)`` a message, on its own
  ``torch.device`` (:class:`PeerDmaProgram`). With peer access between the
  cards, a copy node is a store from one card into another card's memory;
  logical devices that share a card are distinct allocations on it.

The host side builds a **work table** from a scheduled
:class:`~repro_torch.comm.graph.TransferGraph` (:func:`build_node_table`):

* *fill* items cover every output that is not a destination: zeros
  (the engine's contract, every non-destination output reads zero) or a
  copy of the input (the identity contract of
  :func:`ops.multipath_dma_transfer
  <repro_torch.kernels.multipath_dma.ops.multipath_dma_transfer>`);
* *copy* items are the graph's copy nodes in index (dispatch) order, each
  cut into tiles of at most :data:`TILE_BYTES`; a staged hop's tile names
  the previous hop's tile as its predecessor, and every non-terminal node
  owns one staging slot (per device: on the hop's via, as the reference's
  VMEM slots are).

Every item names the logical device that executes it, the reference's
push roles: a fill on its own device, a direct or hop-1 tile on the
message's src, a hop-2 tile on its via. :func:`card_tables` splits a
per-device table into one table a card, with the flags that carry hop
edges across cards and a wait item on the landing card for every tile
another card writes that no item of the table waits on (a terminal tile,
or a stage whose hop 2 a later run of a captured step reads), and it
spreads each card's fills
among the card's copy tiles into another card, so that a src's fill of
its own output (HBM writes) runs under its sends (bound by NVLink) rather
than before them.

:class:`DmaProgram` and :class:`PeerDmaProgram` hold the tables and the
byte buffers they address. On CUDA they launch the hand-written kernel
(``csrc/multipath_dma.cu``, built by :mod:`repro_torch.kernels._build`),
directly or as one captured ``torch.cuda.CUDAGraph`` a card; on the CPU
they run :func:`run_node_table_plain`, the plain PyTorch version, a loop
of slice copies over the whole table in order. :data:`LAUNCHES` counts
kernel launches (one a card that runs items), direct and replayed.

The kernel (its source note has the details) is a persistent grid of
:func:`grid_size` blocks taking items by ticket, each item's bytes copied
by the block's threads in 16-byte vectors through registers (4-byte or
single-byte copies where source and destination disagree mod 16, and for
the head and tail). What bounds it is bytes: on one card HBM (bytes read
+ written at 3.35 TB/s), across cards dst's NVLink ingress (the bytes dst
receives at 450 GB/s, shared by every path into dst). A design that moved
the payload through shared memory with TMA bulk copies was measured on
four H100s and not taken: it tied on a single-path send and lost on the
three-path plan (``PERF.md`` §6).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import TYPE_CHECKING, Callable, NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.topology import HOST
from repro_torch.kernels import _build
from repro_torch.kernels._graph import GraphProgram

if TYPE_CHECKING:
    from repro_torch.comm.graph import TransferGraph

#: Item columns (must match ``csrc/multipath_dma.cu``). ``C_PRED`` and
#: ``C_EXEC`` are read on the host only: the predecessor item in the whole
#: table and the logical device that executes the item.
ITEM_COLS = 14
(C_SRC_SPACE, C_SRC_OFF, C_DST_SPACE, C_DST_OFF, C_NBYTES, C_PRED, C_NODE,
 C_NODE_TILES, C_SRC_DEV, C_DST_DEV, C_EXEC, C_WAIT, C_SIG_CARD,
 C_SIG_IDX) = range(ITEM_COLS)
#: Byte spaces an item reads or writes.
SPACE_ZERO, SPACE_IN, SPACE_OUT, SPACE_STAGE = range(4)
#: State words of a card before its flags: ticket, completed copy nodes,
#: replay epoch, flag count (``csrc/multipath_dma.cu``).
STATE_HEADER = 4
#: Largest tile of one copy node or fill region taken by one block.
TILE_BYTES = 256 << 10
#: Alignment of each message's region in the operand buffers.
_ALIGN = 256
#: Blocks per SM of the persistent grid (``tools/peer_smoke.py --sweep``).
_BLOCKS_PER_SM = 2

#: Kernel launches so far: direct launches and replays of captured graphs.
LAUNCHES = 0


def _align(n: int, a: int) -> int:
    return -(-n // a) * a


@dataclasses.dataclass(frozen=True)
class MessageLayout:
    """Where one message lives in the operand and output byte buffers:
    ``(window, num_devices, nelems)`` elements of ``itemsize`` bytes,
    row-major, starting at byte ``base`` of the operand and ``out_base``
    of the output; with ``per_device`` ``(window, nelems)`` at byte
    ``at[d] = (operand, output)`` of logical device *d*'s own buffers, −1
    where *d* holds no such buffer (``base`` and ``out_base`` are −1)."""

    src: int
    dst: int
    window: int
    num_devices: int
    nelems: int
    itemsize: int
    base: int
    out_base: int
    per_device: bool = False
    at: tuple[tuple[int, int], ...] = ()

    @property
    def row_bytes(self) -> int:
        return self.nelems * self.itemsize

    @property
    def rows(self) -> int:
        """Rows of the message in one buffer."""
        return 1 if self.per_device else self.num_devices

    @property
    def nbytes(self) -> int:
        return self.window * self.rows * self.row_bytes

    def _row(self, window: int, row: int) -> int:
        return (window * self.rows + (0 if self.per_device else row)) \
            * self.row_bytes

    def row_offset(self, window: int, row: int) -> int:
        base = self.at[row][0] if self.per_device else self.base
        return base + self._row(window, row)

    def out_row_offset(self, window: int, row: int) -> int:
        base = self.at[row][1] if self.per_device else self.out_base
        return base + self._row(window, row)


@dataclasses.dataclass(frozen=True)
class NodeTable:
    """The kernel's work table and the buffer sizes it addresses (when
    ``per_device``, the largest of any logical device's, and each
    device's own in ``device_bytes``)."""

    items: np.ndarray            # (nitems, ITEM_COLS) int64
    messages: tuple[MessageLayout, ...]
    num_copy_nodes: int
    io_bytes: int                # size of the operand and output buffers
    stage_bytes: int
    per_device: bool = False
    num_devices: int = 1
    #: Per logical device: (operand, output, staging) bytes.
    device_bytes: tuple[tuple[int, int, int], ...] = ()

    @property
    def num_items(self) -> int:
        return int(self.items.shape[0])

    def bytes_moved(self) -> tuple[int, int]:
        """(bytes read, bytes written) by one execution: every item
        writes its bytes, every item that is not a zero fill reads them."""
        nb = self.items[:, C_NBYTES]
        reads = int(nb[self.items[:, C_SRC_SPACE] != SPACE_ZERO].sum())
        return reads, int(nb.sum())


def _tiles(nbytes: int, tile: int) -> list[tuple[int, int]]:
    return [(off, min(tile, nbytes - off)) for off in range(0, nbytes, tile)]


def build_node_table(graph: TransferGraph, nelems: Sequence[int],
                     itemsizes: Sequence[int], num_devices: int, *,
                     fill: str = "zero",
                     tile_bytes: int = TILE_BYTES,
                     nodes: Sequence[int] | None = None,
                     bases: Sequence | None = None,
                     slots: dict[int, int] | None = None,
                     stage_base: int | Sequence[int] = 0,
                     per_device: bool = False) -> NodeTable:
    """Turn a scheduled transfer graph into the kernel's work table.

    ``nelems[m]``/``itemsizes[m]`` give message *m*'s row length and
    element size; each message occupies ``(graph.window, num_devices,
    nelems[m])`` elements of the operand and output buffers, packed one
    after the other unless ``bases[m] = (operand byte, output byte)``
    places them (a captured step's arena, where both buffers are one).
    With ``per_device`` it occupies ``(graph.window, nelems[m])`` of the
    buffers of the logical devices the table reads or writes it on
    instead, each device's packed on their own (``MessageLayout.at``):
    the operand of its src (of every device when the fill copies), the
    output of its dst (of every device when there is a fill), unless
    ``bases[m]`` gives one ``(operand byte, output byte)`` pair a logical
    device (a peer step's arenas, each device's its own); staging slots
    are allocated on each hop's via. ``fill`` is ``"zero"`` (every
    non-destination output reads zero, the engine's contract),
    ``"copy"`` (it keeps the input, the identity contract) or ``"none"``
    (no fill items: non-destination outputs keep what they held, for a
    caller that reads destinations only). Copy nodes
    keep the graph's index order, which is topological. Every item names
    the logical device that executes it (``C_EXEC``: a fill its own
    device, a copy its link's source).

    ``nodes`` restricts the table to those copy nodes (one run of a
    captured step, default: every node). A message's fill goes in the
    table that holds its first node, before the copies. Staging slots are
    allocated from ``stage_base`` on (per device: one base a logical
    device, or one for all) and recorded in ``slots`` (node index →
    staging byte), which runs of one step share: a hop whose predecessor
    sits in an earlier table reads that slot with no predecessor item.
    On one card stream order orders the two launches; across cards
    :func:`card_tables` makes the via's launch of the earlier run wait
    for the stage to land. A stacked table's flags are set for its one
    card (:func:`card_tables`). Raises ``ValueError`` for host hops,
    compute nodes and chunks that are not element-aligned.
    """
    # imported here, not with the module: repro_torch.comm imports this
    # module, so importing it first must not import comm
    from repro_torch.comm.graph import CopyNode

    if fill not in ("zero", "copy", "none"):
        raise ValueError(f"fill must be 'zero', 'copy' or 'none', got "
                         f"{fill!r}")
    flows = graph.flows()
    if len(flows) != graph.num_messages or len(nelems) != len(flows):
        raise ValueError(f"graph has {graph.num_messages} messages, got "
                         f"{len(nelems)} sizes")
    messages = []
    base = 0
    ends = [[0, 0] for _ in range(num_devices)]    # per device: in, out
    for m, ((src, dst), n, isz) in enumerate(zip(flows, nelems, itemsizes)):
        if per_device:
            nbytes = graph.window * int(n) * int(isz)
            at = []
            for d, end in enumerate(ends):
                if bases is not None:
                    at.append(tuple(int(b) for b in bases[m][d]))
                    for k in range(2):
                        end[k] = max(end[k], at[-1][k] + nbytes)
                    continue
                held = (d == src or fill == "copy", d == dst or fill != "none")
                at.append(tuple(end[k] if h else -1
                                for k, h in enumerate(held)))
                for k, h in enumerate(held):
                    if h:
                        end[k] = _align(end[k] + nbytes, _ALIGN)
            lay = MessageLayout(src, dst, graph.window, num_devices, int(n),
                                int(isz), -1, -1, True, tuple(at))
        elif bases is None:
            lay = MessageLayout(src, dst, graph.window, num_devices, int(n),
                                int(isz), base, base)
            base = _align(base + lay.nbytes, _ALIGN)
        else:
            lay = MessageLayout(src, dst, graph.window, num_devices, int(n),
                                int(isz), *bases[m])
            base = max(base, lay.base + lay.nbytes, lay.out_base + lay.nbytes)
        messages.append(lay)
    io_bytes = max(max(e) for e in ends) if per_device else base
    if nodes is None:
        nodes = range(graph.num_nodes)
    run = set(nodes)
    first_node: dict[int, int] = {}
    for idx, node in enumerate(graph.nodes):
        if isinstance(node, CopyNode):
            first_node.setdefault(node.msg_idx, idx)
    rows: list[list[int]] = []

    def add(src_space, src_off, dst_space, dst_off, nbytes, pred=-1,
            node=-1, node_tiles=0, src_dev=0, dst_dev=0, exe=0):
        rows.append([src_space, src_off, dst_space, dst_off, nbytes, pred,
                     node, node_tiles, src_dev, dst_dev, exe, -1, -1, -1])

    src_fill = SPACE_ZERO if fill == "zero" else SPACE_IN
    for m, lay in enumerate(messages):
        if fill == "none" or first_node.get(m) not in run:
            continue
        for w in range(lay.window):
            if per_device:
                spans = [(d, d + 1) for d in range(num_devices)
                         if d != lay.dst]
            else:
                spans = [(0, lay.dst), (lay.dst + 1, num_devices)]
            for lo, hi in spans:
                if hi <= lo:
                    continue
                dev = lo if per_device else 0
                start = lay.row_offset(w, lo) if fill == "copy" else 0
                out_start = lay.out_row_offset(w, lo)
                for off, size in _tiles((hi - lo) * lay.row_bytes,
                                        tile_bytes):
                    add(src_fill, start + off if fill == "copy" else 0,
                        SPACE_OUT, out_start + off, size, src_dev=dev,
                        dst_dev=dev, exe=dev)

    preds = graph.hop_predecessor
    terminals = graph.terminal_nodes
    first_item: dict[int, int] = {}
    slot = {} if slots is None else slots
    if isinstance(stage_base, int):
        stage = stage_base
        stage_at = [stage_base] * num_devices   # per device
    elif per_device and len(stage_base) == num_devices:
        stage = max(stage_base, default=0)
        stage_at = [int(b) for b in stage_base]
    else:
        raise ValueError("stage_base is one int, or one a logical device "
                         "of a per-device table")
    count = 0
    for idx in nodes:
        node = graph.nodes[idx]
        if not isinstance(node, CopyNode):
            raise ValueError("the multipath_dma kernel executes copy nodes "
                             "only; a captured step runs compute nodes "
                             "between its tables")
        if HOST in node.link:
            raise ValueError("host-staged path is not executable on the "
                             "device (DESIGN.md §2); plan with "
                             "include_host=False")
        lay = messages[node.msg_idx]
        isz = lay.itemsize
        if node.offset % isz or node.nbytes % isz:
            raise ValueError("chunk bounds not element-aligned; pass "
                             "granularity=itemsize to planner.plan()")
        here, there = node.link
        dev_src, dev_dst = (here, there) if per_device else (0, 0)
        pred = preds.get(idx)
        if pred is None:
            src_space = SPACE_IN
            src_off = lay.row_offset(node.window, here) + node.offset
        else:
            src_space, src_off = SPACE_STAGE, slot[pred]
        if idx in terminals:
            dst_space = SPACE_OUT
            dst_off = (lay.out_row_offset(node.window, there)
                       + node.offset)
        else:
            # Keep the slot congruent to the source mod 16 so the 16-byte
            # path applies to every hop of the chain.
            dst_space = SPACE_STAGE
            cursor = stage_at[there] if per_device else stage
            dst_off = _align(cursor, 16) + src_off % 16
            slot[idx] = dst_off
            if per_device:
                stage_at[there] = dst_off + node.nbytes
            else:
                stage = dst_off + node.nbytes
        tiles = _tiles(node.nbytes, tile_bytes)
        first_item[idx] = len(rows)
        pred_item = first_item.get(pred)
        for t, (off, size) in enumerate(tiles):
            add(src_space, src_off + off, dst_space, dst_off + off, size,
                -1 if pred_item is None else pred_item + t, count,
                len(tiles), dev_src, dev_dst, here if per_device else 0)
        count += 1
    items = np.asarray(rows, dtype=np.int64).reshape(-1, ITEM_COLS)
    if not per_device:
        (items,) = card_tables(items, [0])
    device_bytes = (tuple((i, o, st) for (i, o), st in zip(ends, stage_at))
                    if per_device else ())
    return NodeTable(items, tuple(messages), count, io_bytes,
                     max(stage_at) if per_device else stage, per_device,
                     num_devices, device_bytes)


def _spread_fills(rows: np.ndarray, remote: np.ndarray) -> np.ndarray:
    """A card's rows with its fill items spread evenly among its copy
    tiles into another card (``remote``): fill *i* of *F* just before
    remote copy *i·R // F* of *R*, every copy's order kept. Where the card
    sends nothing to another card (one card's tables), the fills stay
    first: there every item shares the card's HBM, and the fill first
    measured faster. Fill and copy regions are disjoint, so any order is
    correct, and no row index changes meaning (``C_PRED`` indexes the
    whole table, host-side only)."""
    fill = rows[:, C_NODE] < 0
    anchors = np.flatnonzero(~fill & remote)
    fills = np.flatnonzero(fill)
    if not len(anchors) or not len(fills):
        return rows
    key = np.arange(len(rows), dtype=np.float64)
    key[fills] = anchors[np.arange(len(fills)) * len(anchors)
                         // len(fills)] - 0.5
    return rows[np.argsort(key, kind="stable")]


def card_tables(items: np.ndarray, card_of: Sequence[int]
                ) -> list[np.ndarray]:
    """Split a table over the cards its logical devices live on
    (``card_of[d]``: the card of logical device *d*, cards numbered from
    0): one table a card, its copies in the whole table's order, its
    fills spread among its copies into other cards
    (:func:`_spread_fills`), with the flags set.

    An item with a predecessor waits on a flag of its own card
    (``C_WAIT``) that the predecessor sets (``C_SIG_CARD``,
    ``C_SIG_IDX``). A tile that lands on another card than the one
    executing it, and that no item of this table waits on, sets a flag of
    the landing card, and that card's table ends with a wait item on it
    (no bytes), so the landing card's launch ends only once the tile is
    there: a terminal tile into its destination's output, and a hop-1
    tile into its via's staging whose hop 2 sits in a later run of a
    captured step (:func:`build_node_table` with ``nodes``), which the
    via's launch of that run then reads in stream order.
    """
    items = items.copy()
    items[:, C_WAIT:] = -1
    cards = np.asarray(card_of, dtype=np.int64)
    exec_card = cards[items[:, C_EXEC]]
    dst_card = cards[items[:, C_DST_DEV]]
    waiter = items[:, C_PRED] >= 0
    awaited = np.zeros(len(items), dtype=bool)
    awaited[items[waiter, C_PRED]] = True
    lands_remote = ((items[:, C_NODE] >= 0)
                       & ((items[:, C_DST_SPACE] == SPACE_OUT)
                          | ((items[:, C_DST_SPACE] == SPACE_STAGE)
                             & ~awaited))
                       & (dst_card != exec_card))
    ncards = int(cards.max()) + 1
    waits = []
    for card in range(ncards):
        hops = np.flatnonzero(waiter & (exec_card == card))
        flags = np.arange(len(hops))
        items[hops, C_WAIT] = flags
        items[items[hops, C_PRED], C_SIG_CARD] = card
        items[items[hops, C_PRED], C_SIG_IDX] = flags
        landing = np.flatnonzero(lands_remote & (dst_card == card))
        flags = len(hops) + np.arange(len(landing))
        items[landing, C_SIG_CARD] = card
        items[landing, C_SIG_IDX] = flags
        rows = np.zeros((len(landing), ITEM_COLS), dtype=np.int64)
        rows[:, [C_SRC_SPACE, C_DST_SPACE]] = SPACE_ZERO
        rows[:, C_PRED] = landing
        rows[:, C_NODE] = -1
        rows[:, [C_SRC_DEV, C_DST_DEV, C_EXEC]] = \
            items[landing, C_DST_DEV][:, None]
        rows[:, C_WAIT] = flags
        rows[:, [C_SIG_CARD, C_SIG_IDX]] = -1
        waits.append(rows)
    # every card's flags are set before any table is cut
    return [np.concatenate([
        _spread_fills(items[exec_card == card],
                      dst_card[exec_card == card] != card), waits[card]])
        for card in range(ncards)]


def num_flags(items: np.ndarray) -> int:
    """Flag words a card's table waits on."""
    return int(items[:, C_WAIT].max()) + 1 if len(items) else 0


def run_node_table_plain(items: np.ndarray, x, y, stage) -> int:
    """Plain PyTorch version of the kernel: execute the whole table in
    order with slice copies on the byte buffers. ``x``, ``y`` and
    ``stage`` are one buffer each (stacked) or one per logical device
    (indexed by an item's ``C_SRC_DEV``/``C_DST_DEV``). Returns the number
    of copy nodes completed (the kernel's completion counters, summed)."""
    spaces = {SPACE_IN: x, SPACE_OUT: y, SPACE_STAGE: stage}

    def buf(space, dev):
        b = spaces[space]
        return b[dev] if isinstance(b, (list, tuple)) else b

    done: dict[int, int] = {}
    completed = 0
    for row in items.tolist():
        (s_space, s_off, d_space, d_off, nb, _, node, node_tiles, s_dev,
         d_dev) = row[:C_EXEC]
        dst = buf(d_space, d_dev)[d_off:d_off + nb]
        if s_space == SPACE_ZERO:
            dst.zero_()
        else:
            dst.copy_(buf(s_space, s_dev)[s_off:s_off + nb])
        if node >= 0:
            done[node] = done.get(node, 0) + 1
            completed += done[node] == node_tiles
    return completed


def _lib():
    lib = _build.load("multipath_dma")
    fn = lib.multipath_dma_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    peers = lib.multipath_dma_enable_peers
    peers.argtypes = [ctypes.c_int, ctypes.c_void_p]
    peers.restype = ctypes.c_int
    if lib.multipath_dma_item_cols() != ITEM_COLS:
        raise RuntimeError("multipath_dma item layout mismatch")
    return lib


def grid_size(num_items: int, device: torch.device) -> int:
    """Blocks of the persistent grid for a table of ``num_items``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(num_items, _BLOCKS_PER_SM * sms))


def new_state(items: np.ndarray, num_copy_nodes: int,
              device: torch.device | str) -> torch.Tensor:
    """The state words of one card's table: the header (epoch 0, the
    flag count), the flags and a finished-tile count a copy node."""
    nflags = num_flags(items)
    state = torch.zeros(STATE_HEADER + nflags + num_copy_nodes,
                        dtype=torch.int32)
    state[3] = nflags
    return state.to(device)


def enable_peers(devices: Sequence[torch.device]) -> None:
    """Enable peer access between every pair of the distinct CUDA
    ``devices``; raises when a pair cannot reach each other."""
    idx = [torch.device(d).index for d in devices]
    arr = (ctypes.c_int * len(idx))(*idx)
    rc = _lib().multipath_dma_enable_peers(len(idx), arr)
    if rc != 0:
        raise RuntimeError(f"peer access between cards {idx} failed: CUDA "
                           f"error {rc}")


def _launch(items: torch.Tensor, x, y, stage, peer, ndev: int, card: int,
            state: torch.Tensor, grid: int) -> None:
    global LAUNCHES
    if items.device.type != "cuda":
        raise ValueError(f"multipath_dma kernel needs CUDA tensors, got "
                         f"{items.device}")
    ptr = (lambda t: 0 if t is None else t.data_ptr())
    with torch.cuda.device(items.device):   # the stream's own card
        rc = _lib().multipath_dma_launch(
            items.data_ptr(), items.shape[0], ptr(x), ptr(y), ptr(stage),
            ptr(peer), ndev, card, state.data_ptr(), state.numel(), grid,
            torch.cuda.current_stream(items.device).cuda_stream)
    _build.check(rc, "multipath_dma")
    LAUNCHES += 1


def launch_table(items: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 stage: torch.Tensor, state: torch.Tensor, grid: int) -> None:
    """Launch the kernel over the stacked work table ``items`` (int64, on
    the card) on the current stream, its prologue first (a new epoch,
    counters zeroed). ``x`` and ``y`` are the operand and output byte
    buffers (they may be one buffer, the arena of a captured step);
    ``state`` comes from :func:`new_state`."""
    _launch(items, x, y, stage, None, 0, 0, state, grid)


class DmaProgram(GraphProgram):
    """One stacked node table made resident on a device, with its buffers.

    ``inputs()``/``outputs()`` are typed ``(window, num_devices, nelems)``
    views of the operand and output byte buffers, one per message. The
    operand starts as zeros; with ``operand=False`` the program holds
    none, and every :meth:`run` is given the caller's. :meth:`run`
    executes the table once: the kernel on a CUDA device, the plain
    version on the CPU. :meth:`capture` records one run into a CUDA graph;
    :meth:`replay` launches it.
    """

    def __init__(self, table: NodeTable, dtypes: Sequence[torch.dtype],
                 device: torch.device | str, *, operand: bool = True):
        if table.per_device:
            raise ValueError("a per-device table runs in a PeerDmaProgram")
        self.table = table
        self.dtypes = tuple(dtypes)
        self.device = torch.device(device)
        dev = self.device
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {dev}")
        self.x = torch.zeros(table.io_bytes, dtype=torch.uint8,
                             device=dev) if operand else None
        self.y = torch.zeros(table.io_bytes, dtype=torch.uint8, device=dev)
        self.stage = torch.empty(max(table.stage_bytes, 16),
                                 dtype=torch.uint8, device=dev)
        self.items = torch.from_numpy(table.items).to(dev)
        self.state = new_state(table.items, table.num_copy_nodes, dev)
        self._completed = 0
        self._grid = grid_size(table.num_items, dev) \
            if dev.type == "cuda" else 0

    def _views(self, buf: torch.Tensor) -> list[torch.Tensor]:
        out = []
        for lay, dt in zip(self.table.messages, self.dtypes):
            raw = buf[lay.base:lay.base + lay.nbytes]
            out.append(raw.view(dt).view(lay.window, lay.num_devices,
                                         lay.nelems))
        return out

    def inputs(self) -> list[torch.Tensor]:
        return self._views(self.x)

    def outputs(self) -> list[torch.Tensor]:
        return self._views(self.y)

    def run(self, x: torch.Tensor | None = None) -> None:
        """Execute the table once (no graph) on the operand byte buffer
        ``x``, the program's own by default."""
        x = self.x if x is None else x
        if self.device.type == "cuda":
            launch_table(self.items, x, self.y, self.stage, self.state,
                         self._grid)
        else:
            self._completed = run_node_table_plain(
                self.table.items, x, self.y, self.stage)

    def completed_nodes(self) -> int:
        """Copy nodes the last execution completed (synchronises)."""
        if self.device.type == "cuda":
            return int(self.state[1].item())
        return self._completed


class CardLaunch(NamedTuple):
    """One card's share of a per-device program: its index among the
    program's cards, its table, state words, space table and grid."""

    card: int
    items: torch.Tensor
    state: torch.Tensor
    space: torch.Tensor
    grid: int


class PeerDmaProgram(GraphProgram):
    """One per-device node table made resident on its logical devices.

    ``devices[d]`` is logical device *d*'s ``torch.device``; a card may
    hold several. Every logical device gets its own operand, output and
    staging buffer on its card, sized to the messages the table reads or
    writes there (``NodeTable.device_bytes``). ``inputs()``/``outputs()``
    give, per message, one ``(window, nelems)`` view a logical device,
    ``None`` where that device holds no such buffer. ``buffers``, when
    given, are the ``(operand, output, staging)`` byte buffers, one a
    logical device on its device, at least ``table.device_bytes`` long
    (a peer step's arenas): the program then allocates none.

    On CUDA every card runs its share of the table (:func:`card_tables`)
    as one launch, with a space table of every logical device's buffers
    and every card's state words; distinct cards get peer access first
    (:func:`enable_peers`, which raises when a pair has none). One
    execution first orders the cards (every card's stream waits for what
    every other card has enqueued so far: the previous execution, its
    result copies and this one's staging), then launches each card's
    share; :meth:`~GraphProgram.record` captures one graph a card and
    :meth:`~GraphProgram.replay` replays them after the same ordering. On
    the CPU the plain version runs the whole table in order.
    """

    def __init__(self, table: NodeTable, dtypes: Sequence[torch.dtype],
                 devices: Sequence[torch.device | str], *,
                 buffers: tuple[Sequence, Sequence, Sequence] | None = None):
        if not table.per_device:
            raise ValueError("a stacked table runs in a DmaProgram")
        self.table = table
        self.dtypes = tuple(dtypes)
        self.devices = tuple(torch.device(d) for d in devices)
        if len(self.devices) != table.num_devices:
            raise ValueError(f"table has {table.num_devices} logical "
                             f"devices, got {len(self.devices)} devices")
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
            raise ValueError(f"devices must be all CUDA or all CPU, got "
                             f"{[str(d) for d in self.devices]}")
        self._cards = tuple(dict.fromkeys(self.devices))
        self.device = self._cards[0]
        card_of = [self._cards.index(d) for d in self.devices]
        on_cuda = self.device.type == "cuda"
        if on_cuda and len(self.cards) > 1:
            enable_peers(self.cards)
        if buffers is None:
            sizes = [[max(b, 16) for b in own]
                     for own in table.device_bytes]
            buffers = (
                [torch.zeros(own[0], dtype=torch.uint8, device=d)
                 for own, d in zip(sizes, self.devices)],
                [torch.zeros(own[1], dtype=torch.uint8, device=d)
                 for own, d in zip(sizes, self.devices)],
                [torch.empty(own[2], dtype=torch.uint8, device=d)
                 for own, d in zip(sizes, self.devices)])
        self.x, self.y, self.stage = (list(b) for b in buffers)
        self._completed = 0
        #: One launch a card that runs items.
        self.launches: list[CardLaunch] = []
        if not on_cuda:
            return
        ptrs = []
        for d in range(len(self.devices)):
            ptrs += [self.x[d].data_ptr(), self.y[d].data_ptr(),
                     self.stage[d].data_ptr()]
        tables = card_tables(table.items, card_of)
        states = [new_state(t, table.num_copy_nodes, card)
                  for t, card in zip(tables, self.cards)]
        ptrs += [s.data_ptr() for s in states]
        for c, (card, items, state) in enumerate(zip(self.cards, tables,
                                                     states)):
            if not len(items):
                continue
            space = torch.tensor(ptrs, dtype=torch.int64).to(card)
            self.launches.append(CardLaunch(
                c, torch.from_numpy(items).to(card), state, space,
                grid_size(len(items), card)))

    @property
    def cards(self) -> tuple[torch.device, ...]:
        """The distinct devices of the logical devices, in first-use
        order."""
        return self._cards

    def _views(self, bufs: list[torch.Tensor], k: int) -> list[list]:
        out = []
        for lay, dt in zip(self.table.messages, self.dtypes):
            out.append([None if at[k] < 0 else b[at[k]:at[k] + lay.nbytes]
                        .view(dt).view(lay.window, lay.nelems)
                        for at, b in zip(lay.at, bufs)])
        return out

    def inputs(self) -> list[list[torch.Tensor | None]]:
        return self._views(self.x, 0)

    def outputs(self) -> list[list[torch.Tensor | None]]:
        return self._views(self.y, 1)

    def _run_card(self, launch: CardLaunch) -> None:
        _launch(launch.items, None, None, None, launch.space,
                len(self.devices), launch.card, launch.state, launch.grid)

    def run_card(self, card: int) -> None:
        """Launch card ``card``'s share alone (nothing if it runs no
        items), for a caller that orders the cards itself: a program of
        several steps, recorded one graph a card."""
        for launch in self.launches:
            if launch.card == card:
                self._run_card(launch)

    def bodies(self) -> list[tuple[torch.device, Callable[[], None]]]:
        """One body a card that runs items: its launch."""
        return [(self._cards[launch.card],
                 functools.partial(self._run_card, launch))
                for launch in self.launches]

    def run(self) -> None:
        """Execute the table once (no graph)."""
        if self.device.type != "cuda":
            self._completed = run_node_table_plain(
                self.table.items, self.x, self.y, self.stage)
            return
        self.order()
        for launch in self.launches:
            self._run_card(launch)

    def completed_nodes(self) -> int:
        """Copy nodes the last execution completed, summed over the cards
        (synchronises)."""
        if self.device.type != "cuda":
            return self._completed
        return sum(int(launch.state[1].item()) for launch in self.launches)
