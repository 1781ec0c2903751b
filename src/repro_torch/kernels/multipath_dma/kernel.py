"""The ``multipath_dma`` kernel: one transfer graph, one launch.

Replaces the Pallas kernel ``build_multipath_dma`` of the reference package
(``src/repro/kernels/multipath_dma/kernel.py``). There, each copy node of a
plan is a remote DMA between chips. Here the logical devices are rows of
one operand ``(window, num_devices, nelems)`` on one card, so each copy node
moves bytes from one row (or staging slot) to another.

The host side builds a **work table** from a scheduled
:class:`~repro_torch.comm.graph.TransferGraph` (:func:`build_node_table`):

* *fill* items cover every output row that is not a destination: zeros
  (the engine's contract, every non-destination row reads zero) or a copy
  of the input row (the identity contract of :func:`ops.multipath_dma_transfer
  <repro_torch.kernels.multipath_dma.ops.multipath_dma_transfer>`);
* *copy* items are the graph's copy nodes in index (dispatch) order, each
  cut into tiles of at most :data:`TILE_BYTES`; a staged hop's tile names
  the previous hop's tile as its predecessor, and every non-terminal node
  owns one staging slot.

:class:`DmaProgram` holds the table and the byte buffers it addresses.
On a CUDA device it launches the hand-written kernel
(``csrc/multipath_dma.cu``, built by :mod:`repro_torch.kernels._build`),
directly or as one node of a captured ``torch.cuda.CUDAGraph``; on the CPU
it runs :func:`run_node_table_plain`, the plain PyTorch version, a loop of
slice copies over the same table. :data:`LAUNCHES` counts kernel launches,
direct and replayed.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.comm.graph import CopyNode, TransferGraph
from repro_torch.core.topology import HOST
from repro_torch.kernels import _build
from repro_torch.kernels._graph import GraphProgram

#: Item columns (must match ``csrc/multipath_dma.cu``).
ITEM_COLS = 8
C_SRC_SPACE, C_SRC_OFF, C_DST_SPACE, C_DST_OFF, C_NBYTES, C_PRED, C_NODE, \
    C_NODE_TILES = range(ITEM_COLS)
#: Byte spaces an item reads or writes.
SPACE_ZERO, SPACE_IN, SPACE_OUT, SPACE_STAGE = range(4)
#: Largest tile of one copy node or fill region taken by one block.
TILE_BYTES = 256 << 10
#: Alignment of each message's region in the operand buffers.
_ALIGN = 256
#: Blocks per SM of the persistent grid.
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
    of the output."""

    src: int
    dst: int
    window: int
    num_devices: int
    nelems: int
    itemsize: int
    base: int
    out_base: int

    @property
    def row_bytes(self) -> int:
        return self.nelems * self.itemsize

    @property
    def nbytes(self) -> int:
        return self.window * self.num_devices * self.row_bytes

    def row_offset(self, window: int, row: int) -> int:
        return self.base + (window * self.num_devices + row) * self.row_bytes

    def out_row_offset(self, window: int, row: int) -> int:
        return (self.out_base
                + (window * self.num_devices + row) * self.row_bytes)


@dataclasses.dataclass(frozen=True)
class NodeTable:
    """The kernel's work table and the buffer sizes it addresses."""

    items: np.ndarray            # (nitems, ITEM_COLS) int64
    messages: tuple[MessageLayout, ...]
    num_copy_nodes: int
    io_bytes: int                # size of the operand and output buffers
    stage_bytes: int

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
                     bases: Sequence[tuple[int, int]] | None = None,
                     slots: dict[int, int] | None = None,
                     stage_base: int = 0) -> NodeTable:
    """Turn a scheduled transfer graph into the kernel's work table.

    ``nelems[m]``/``itemsizes[m]`` give message *m*'s row length and
    element size; each message occupies ``(graph.window, num_devices,
    nelems[m])`` elements of the operand and output buffers, packed one
    after the other unless ``bases[m] = (operand byte, output byte)``
    places them (a captured step's arena, where both buffers are one).
    ``fill`` is ``"zero"`` (every non-destination row of the output reads
    zero, the engine's contract) or ``"copy"`` (it keeps the input row,
    the identity contract). Copy nodes keep the graph's index order, which
    is topological.

    ``nodes`` restricts the table to those copy nodes (one run of a
    captured step, default: every node). A message's fill goes in the
    table that holds its first node. Staging slots are allocated from
    ``stage_base`` on and recorded in ``slots`` (node index → staging
    byte), which runs of one step share: a hop whose predecessor sits in
    an earlier table reads that slot with no predecessor item, because
    stream order already orders the two launches. Raises ``ValueError``
    for host hops, compute nodes and chunks that are not element-aligned.
    """
    if fill not in ("zero", "copy"):
        raise ValueError(f"fill must be 'zero' or 'copy', got {fill!r}")
    flows = graph.flows()
    if len(flows) != graph.num_messages or len(nelems) != len(flows):
        raise ValueError(f"graph has {graph.num_messages} messages, got "
                         f"{len(nelems)} sizes")
    messages = []
    base = 0
    for m, ((src, dst), n, isz) in enumerate(zip(flows, nelems, itemsizes)):
        if bases is None:
            lay = MessageLayout(src, dst, graph.window, num_devices, int(n),
                                int(isz), base, base)
            base = _align(base + lay.nbytes, _ALIGN)
        else:
            lay = MessageLayout(src, dst, graph.window, num_devices, int(n),
                                int(isz), *bases[m])
            base = max(base, lay.base + lay.nbytes, lay.out_base + lay.nbytes)
        messages.append(lay)
    io_bytes = base
    if nodes is None:
        nodes = range(graph.num_nodes)
    run = set(nodes)
    first_node: dict[int, int] = {}
    for idx, node in enumerate(graph.nodes):
        if isinstance(node, CopyNode):
            first_node.setdefault(node.msg_idx, idx)
    rows: list[list[int]] = []

    def add(src_space, src_off, dst_space, dst_off, nbytes, pred=-1,
            node=-1, node_tiles=0):
        rows.append([src_space, src_off, dst_space, dst_off, nbytes, pred,
                     node, node_tiles])

    src_fill = SPACE_ZERO if fill == "zero" else SPACE_IN
    for m, lay in enumerate(messages):
        if first_node.get(m) not in run:
            continue
        for w in range(lay.window):
            for lo, hi in ((0, lay.dst), (lay.dst + 1, num_devices)):
                if hi <= lo:
                    continue
                start = lay.row_offset(w, lo)
                out_start = lay.out_row_offset(w, lo)
                for off, size in _tiles((hi - lo) * lay.row_bytes,
                                        tile_bytes):
                    add(src_fill, start + off if fill == "copy" else 0,
                        SPACE_OUT, out_start + off, size)

    preds = graph.hop_predecessor
    terminals = graph.terminal_nodes
    first_item: dict[int, int] = {}
    slot = {} if slots is None else slots
    stage = stage_base
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
        pred = preds.get(idx)
        if pred is None:
            src_space = SPACE_IN
            src_off = lay.row_offset(node.window, node.link[0]) + node.offset
        else:
            src_space, src_off = SPACE_STAGE, slot[pred]
        if idx in terminals:
            dst_space = SPACE_OUT
            dst_off = (lay.out_row_offset(node.window, node.link[1])
                       + node.offset)
        else:
            # Keep the slot congruent to the source mod 16 so the 16-byte
            # path applies to every hop of the chain.
            dst_space = SPACE_STAGE
            dst_off = _align(stage, 16) + src_off % 16
            slot[idx] = dst_off
            stage = dst_off + node.nbytes
        tiles = _tiles(node.nbytes, tile_bytes)
        first_item[idx] = len(rows)
        pred_item = first_item.get(pred)
        for t, (off, size) in enumerate(tiles):
            add(src_space, src_off + off, dst_space, dst_off + off, size,
                -1 if pred_item is None else pred_item + t, count,
                len(tiles))
        count += 1
    items = np.asarray(rows, dtype=np.int64).reshape(-1, ITEM_COLS)
    return NodeTable(items, tuple(messages), count, io_bytes, stage)


def run_node_table_plain(items: np.ndarray, x: torch.Tensor, y: torch.Tensor,
                         stage: torch.Tensor) -> int:
    """Plain PyTorch version of the kernel: execute the table in order
    with slice copies on the byte buffers. Returns the number of copy
    nodes completed (the kernel's completion counter)."""
    spaces = {SPACE_IN: x, SPACE_OUT: y, SPACE_STAGE: stage}
    done: dict[int, int] = {}
    completed = 0
    for row in items.tolist():
        s_space, s_off, d_space, d_off, nb, _, node, node_tiles = row
        dst = spaces[d_space][d_off:d_off + nb]
        if s_space == SPACE_ZERO:
            dst.zero_()
        else:
            dst.copy_(spaces[s_space][s_off:s_off + nb])
        if node >= 0:
            done[node] = done.get(node, 0) + 1
            completed += done[node] == node_tiles
    return completed


def _lib():
    lib = _build.load("multipath_dma")
    fn = lib.multipath_dma_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if lib.multipath_dma_item_cols() != ITEM_COLS:
        raise RuntimeError("multipath_dma item layout mismatch")
    return lib


def grid_size(num_items: int, device: torch.device) -> int:
    """Blocks of the persistent grid for a table of ``num_items``."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(num_items, _BLOCKS_PER_SM * sms))


def launch_table(items: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                 stage: torch.Tensor, state: torch.Tensor, grid: int) -> None:
    """Zero the state words and launch the kernel over the work table
    ``items`` (int64, on the card) on the current stream. ``x`` and ``y``
    are the operand and output byte buffers (they may be one buffer, the
    arena of a captured step); ``state`` holds ``2 + items + copy nodes``
    int32 words."""
    global LAUNCHES
    if items.device.type != "cuda":
        raise ValueError(f"multipath_dma kernel needs CUDA tensors, got "
                         f"{items.device}")
    state.zero_()
    rc = _lib().multipath_dma_launch(
        items.data_ptr(), items.shape[0], x.data_ptr(), y.data_ptr(),
        stage.data_ptr(), state.data_ptr(), grid,
        torch.cuda.current_stream(items.device).cuda_stream)
    _build.check(rc, "multipath_dma")
    LAUNCHES += 1


class DmaProgram(GraphProgram):
    """One node table made resident on a device, with its buffers.

    ``inputs()``/``outputs()`` are typed ``(window, num_devices, nelems)``
    views of the operand and output byte buffers, one per message. The
    operand starts as zeros; with ``operand=False`` the program holds
    none, and every :meth:`run` is given the caller's. :meth:`run`
    executes the table once: the kernel on a CUDA device (state words
    zeroed on the same stream first), the plain version on the CPU.
    :meth:`capture` records one run into a CUDA graph; :meth:`replay`
    launches it.
    """

    def __init__(self, table: NodeTable, dtypes: Sequence[torch.dtype],
                 device: torch.device | str, *, operand: bool = True):
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
        self.state = torch.zeros(2 + table.num_items + table.num_copy_nodes,
                                 dtype=torch.int32, device=dev)
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
