"""Whole-iteration step capture: one heterogeneous graph per iteration.

The paper's CUDA-graph thesis is "capture once, launch many"; the rest of
:mod:`repro_torch.comm` applies it to *communication* only — each transfer
is one replay, but an iteration is still a chain of separate kernel
launches with transfer dispatches between them. This module closes the
gap: a :class:`StepCapture` records a full step (kernel invocations +
multipath exchanges) against declared buffers, :func:`lower_step` lowers
the recording to ONE heterogeneous
:class:`~repro_torch.comm.graph.TransferGraph` — a
:class:`~repro_torch.comm.graph.CopyNode` per chunk per hop plus a
:class:`~repro_torch.comm.graph.ComputeNode` per kernel, coupled by
``"buffer"`` def-use edges — and the engine schedules it with the
ordinary §2.2 passes, makes it resident as one :class:`StepProgram`, and
launches the whole iteration as ONE dispatch: one ``torch.cuda.CUDAGraph``
replay on a CUDA device.

Contract highlights (the invariant obligations the §4.5 validator and
the cache layer rely on):

* **Buffers are SSA** — every buffer id is written exactly once (a step
  input, one kernel's result, or one exchange's reception); the lowering
  derives the ``"buffer"`` dependency edges from that def-use relation
  and :meth:`~repro_torch.comm.graph.TransferGraph.validate` re-checks
  them.
* **Kernel name is identity** — digests and ``GroupKey`` entries key
  compute work by its registered kernel name; registering a different
  function under a used name raises at capture time, because a silently
  swapped kernel would be served a stale executable.
* **Reception values are exact** — a reception buffer holds the message on
  its destination device and *zeros* on every other device, so summing
  the per-message reception buffers of a ring exchange reconstructs each
  device's received value exactly (adding zeros is exact in IEEE-754 up to
  the sign of zero) — the idiom :func:`captured_psum` and the captured
  Jacobi step build on.
* **Capture signature** — :meth:`StepCapture.signature` is the hashable
  request identity the engine's fast path memoizes resolutions under
  (together with the schedule name and planner epoch), and the scheduled
  graph's :meth:`~repro_torch.comm.graph.TransferGraph.digest` keys the
  resident program — two schedules of one captured step digest apart and
  can never cross-serve.

Every buffer is **device-stacked**: a kernel function takes and returns
``(num_devices, *local)`` tensors, one row per logical device, and finds
each row's logical device with :func:`axis_index` (the counterpart of
the reference's ``lax.axis_index``). Result specs come from running the
function on ``device="meta"`` tensors unless ``out=`` is given.

On a peer session (``CommSession(devices=[...])``) the same recording
runs as a :class:`PeerStepProgram`: every logical device holds its own
arena on its own ``torch.device`` with a ``(1, *local)`` view of every
buffer, a kernel function is called once a logical device on its views
(``axis_index`` gives ``[d]``), each run of copy nodes is one per-device
``multipath_dma`` table launched once a card, and on CUDA each card
records one graph. A kernel function that needs every device's operand
(a collective: ``captured_ring_allgather``, ``captured_multipath_dma``)
carries a peer form, an attribute ``peer_program(devices, operands,
results)`` that makes one program over the per-device views whose
``run_card(card)`` launches one card's share.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
from typing import Callable, Sequence

import torch

from repro_torch.comm.graph import (BUFFER_EDGE, HOP_EDGE, ComputeNode,
                                    CopyNode, DepEdge, TransferGraph)
from repro_torch.kernels._graph import GraphProgram
from repro_torch.kernels.multipath_dma.kernel import (NodeTable,
                                                      PeerDmaProgram,
                                                      build_node_table,
                                                      grid_size, launch_table,
                                                      new_state,
                                                      run_node_table_plain)

#: Alignment of each buffer in a step's arena.
_ALIGN = 256

#: The logical index of the current kernel call's rows in a peer program
#: (``None``: a stacked call, rows ``0 .. n-1``).
_AXIS_INDEX: torch.Tensor | None = None


def axis_index(like: torch.Tensor) -> torch.Tensor:
    """The logical device of each row of ``like``, a kernel function's
    stacked operand: an int64 ``(k,)`` tensor. ``arange(n)`` in a stacked
    program (and on meta tensors, while result specs are inferred);
    ``[d]`` in a :class:`PeerStepProgram`'s call for logical device *d*,
    a resident tensor on *d*'s device that the program sets around the
    call, so a CUDA graph records its address."""
    if _AXIS_INDEX is not None:
        return _AXIS_INDEX
    return torch.arange(like.shape[0], device=like.device)


@contextlib.contextmanager
def _indexed(index: torch.Tensor):
    global _AXIS_INDEX
    _AXIS_INDEX = index
    try:
        yield
    finally:
        _AXIS_INDEX = None


def as_dtype(dtype) -> torch.dtype:
    """A ``torch.dtype`` from a dtype or its name (``"float32"``)."""
    if isinstance(dtype, torch.dtype):
        return dtype
    out = getattr(torch, str(dtype), None)
    if not isinstance(out, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return out


def dtype_name(dtype) -> str:
    """The numpy-style name of a dtype (``"float32"``, ``"bfloat16"``) —
    what keys and signatures carry, comparable with the reference."""
    return str(as_dtype(dtype)).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class BufferSpec:
    """Static identity of one step buffer: per-device local shape, dtype
    (canonical string), and whether the step *input* arrives replicated.

    Part of the capture signature, so it must stay hashable and
    canonical: two captures with equal specs and ops resolve to the same
    fast-path entry. ``replicated`` only affects input staging — results
    and receptions are always per-device values.
    """

    shape: tuple[int, ...]
    dtype: str
    replicated: bool = False


@dataclasses.dataclass(frozen=True)
class BufferRef:
    """Opaque handle to a capture buffer (its id in the buffer table).

    Refs are how a step's dataflow is declared — the lowering turns the
    def-use relation over refs into the graph's validated ``"buffer"``
    edges, so holding a ref across captures (or forging ids) breaks the
    SSA contract and fails validation.
    """

    buf_id: int


class StepCapture:
    """Recorder for one iteration: inputs, kernels, exchanges.

    The builder half of ``session.capture(build_fn)``: ``build_fn``
    receives the capture, declares buffers/ops through the methods
    below, and returns the output ref(s). Nothing executes at capture
    time — the recording is lowered (:func:`lower_step`), scheduled, and
    made resident by the engine on first launch, then memoized by
    :meth:`signature` + planner epoch. ``num_devices`` is the leading
    size of the stacked meta tensors that infer result specs.

    Invariant obligations: buffers are SSA (each id written once),
    kernel names are identities (re-registering a different function
    under a used name raises), and exchanged payloads must be 1-D
    buffers produced by an input or a kernel (never a raw reception —
    pass receptions through a kernel first, which also gives the §4.5
    validator a compute producer for the next round's buffer edges).
    """

    def __init__(self, num_devices: int = 1):
        self.num_devices = int(num_devices)
        self.buffers: list[BufferSpec] = []
        self.inputs: list[int] = []
        self.ops: list[tuple] = []
        self.kernels: dict[str, Callable] = {}
        self._receptions: set[int] = set()

    def _new_buffer(self, spec: BufferSpec) -> int:
        self.buffers.append(spec)
        return len(self.buffers) - 1

    def _resolve(self, ref: BufferRef) -> int:
        if not isinstance(ref, BufferRef):
            raise TypeError(f"expected a BufferRef, got {type(ref)!r}")
        if not 0 <= ref.buf_id < len(self.buffers):
            raise ValueError(f"unknown buffer id {ref.buf_id} (refs are "
                             "capture-local; the SSA contract forbids "
                             "sharing them across captures)")
        return ref.buf_id

    def input(self, shape: Sequence[int], dtype=torch.float32, *,
              replicated: bool = False) -> BufferRef:
        """Declare one step input buffer and return its ref.

        ``shape`` is the per-device *local* shape. ``replicated=False``
        (default) means the caller passes a stacked ``(num_devices,
        *shape)`` tensor; ``replicated=True`` means one ``shape``-shaped
        tensor every device sees whole. Input order is call order — the
        launch contract aligns positional tensors with it.
        """
        bid = self._new_buffer(BufferSpec(tuple(int(s) for s in shape),
                                          dtype_name(dtype),
                                          bool(replicated)))
        self.inputs.append(bid)
        self.ops.append(("input", bid))
        return BufferRef(bid)

    def _infer(self, fn: Callable, kname: str, ops: tuple[int, ...]):
        n = self.num_devices
        args = [torch.empty((n,) + self.buffers[b].shape,
                            dtype=as_dtype(self.buffers[b].dtype),
                            device="meta") for b in ops]
        try:
            res = fn(*args)
        except (RuntimeError, ValueError, TypeError, IndexError,
                NotImplementedError) as exc:
            raise ValueError(
                f"could not infer result specs for kernel {kname!r} "
                f"(kernels that launch a CUDA kernel or read values must "
                f"pass out=): {exc}") from exc
        single = not isinstance(res, (tuple, list))
        specs = []
        for r in ((res,) if single else res):
            if r.dim() < 1 or r.shape[0] != n:
                raise ValueError(
                    f"kernel {kname!r} must return stacked (num_devices, "
                    f"...) tensors, got shape {tuple(r.shape)}")
            specs.append(BufferSpec(tuple(r.shape[1:]), dtype_name(r.dtype)))
        return single, specs

    def kernel(self, fn: Callable, *operands: BufferRef,
               out: BufferSpec | Sequence[BufferSpec] | None = None,
               name: str | None = None, flops: int = 0,
               cost_ns: int = 0):
        """Record one kernel invocation; returns the result ref(s).

        ``fn`` maps the operands' stacked tensors ``(num_devices,
        *local)`` to one stacked tensor (or a tuple of them). Result specs
        come from running ``fn`` on meta tensors unless ``out`` is given
        explicitly (required when ``fn`` launches a hand-written kernel,
        which takes no meta tensor). ``name`` (default ``fn.__name__``) is
        the kernel's *identity* — it reaches digests and cache keys, so
        registering a different function under a used name raises (the
        §2.2 identity contract). ``flops`` / ``cost_ns`` feed the cost
        model's :class:`~repro_torch.comm.graph.ComputeNode` pricing.
        """
        kname = name if name is not None else getattr(fn, "__name__",
                                                      "kernel")
        if kname == "<lambda>":
            raise ValueError("anonymous kernels need an explicit name= "
                             "(the name is the cache identity)")
        prior = self.kernels.get(kname)
        if prior is not None and prior is not fn:
            raise ValueError(
                f"kernel name {kname!r} already registered with a "
                f"different function — the name is the digest/cache "
                f"identity and must not be reused")
        ops = tuple(self._resolve(r) for r in operands)
        if out is None:
            single, specs = self._infer(fn, kname, ops)
        else:
            single = isinstance(out, BufferSpec)
            specs = [out] if single else list(out)
        results = tuple(self._new_buffer(s) for s in specs)
        self.kernels[kname] = fn
        self.ops.append(("kernel", kname, ops, results,
                         int(flops), int(cost_ns)))
        refs = tuple(BufferRef(b) for b in results)
        return refs[0] if single else refs

    def exchange(self, sends: Sequence[tuple[BufferRef, int, int]], *,
                 max_paths: int | None = None,
                 num_chunks: int | None = None) -> list[BufferRef]:
        """Record one fused multipath exchange; returns reception refs.

        ``sends`` is one ``(payload_ref, src, dst)`` per message; the
        exchange is planned *jointly* (the engine's ``plan_group``) and
        lowers to the group's copy nodes inside the step graph. Each
        message gets a fresh reception buffer: it holds the full payload
        on ``dst`` and exact zeros on every other device (the
        summable-receptions contract in the module docstring). Payloads
        must be 1-D and must not themselves be raw receptions (route
        them through a kernel first — preserves the SSA/def-use
        validation). ``max_paths`` / ``num_chunks`` pass through to the
        planner and are part of the capture signature.
        """
        if not sends:
            raise ValueError("exchange needs at least one message")
        rec: list[tuple[int, int, int]] = []
        results = []
        for (ref, src, dst) in sends:
            bid = self._resolve(ref)
            spec = self.buffers[bid]
            if len(spec.shape) != 1:
                raise ValueError(
                    f"exchange payloads must be 1-D buffers, got shape "
                    f"{spec.shape} (reshape inside a kernel first)")
            if bid in self._receptions:
                raise ValueError(
                    "cannot exchange a raw reception buffer — pass it "
                    "through a kernel first (def-use contract)")
            if src == dst:
                raise ValueError(f"self-send {src}->{dst} in exchange")
            rec.append((bid, int(src), int(dst)))
            rbuf = self._new_buffer(BufferSpec(spec.shape, spec.dtype))
            self._receptions.add(rbuf)
            results.append(rbuf)
        self.ops.append(("exchange", tuple(rec), max_paths, num_chunks,
                         tuple(results)))
        return [BufferRef(b) for b in results]

    def signature(self) -> tuple:
        """Hashable request identity of the recording — buffer table +
        op list (kernel *names*, not functions: the name-is-identity
        contract). Together with the schedule name and the planner
        epoch this keys the engine's fast-path memo, exactly like a
        transfer-group request signature.
        """
        return ("capture",
                tuple(dataclasses.astuple(b) for b in self.buffers),
                tuple(self.ops))


def lower_step(capture: StepCapture, plan_group_fn,
               topology_name: str) -> tuple[TransferGraph, tuple]:
    """Lower a recording to ONE heterogeneous transfer graph.

    Emits nodes in program order (a valid topological order): one
    :class:`~repro_torch.comm.graph.ComputeNode` per kernel invocation,
    and per exchange the jointly-planned group's copy nodes in the
    paper's Algorithm 1 wave order with *global* message indices.
    Dependency edges: ``"hop"`` within chunks, ``"buffer"`` for def-use
    (producer compute → first-hop copies of its payload's messages;
    terminal copies → consumer computes; compute → compute). The graph
    carries the ``messages`` table (msg → payload/reception buffer ids)
    and is §4.5-validated (byte cover per message, hop chains, buffer
    def-use) before being returned together with the flat plan tuple.
    ``plan_group_fn(specs, max_paths=, num_chunks=)`` is the engine's
    joint planner hook.
    """
    nodes: list = []
    edges: list[DepEdge] = []
    messages: list[tuple[int, int]] = []
    plans_all: list = []
    msg_nbytes: dict[int, int] = {}
    producer: dict[int, int] = {}        # buf -> compute node idx
    terminals_of: dict[int, list[int]] = {}   # reception buf -> copies
    for op in capture.ops:
        if op[0] == "input":
            continue
        if op[0] == "kernel":
            _, kname, operands, results, flops, cost_ns = op
            idx = len(nodes)
            compute_preds = set()
            for b in operands:
                p = producer.get(b)
                if p is not None:
                    compute_preds.add(p)
                for t in terminals_of.get(b, ()):
                    edges.append(DepEdge(t, idx, BUFFER_EDGE))
            for p in sorted(compute_preds):
                edges.append(DepEdge(p, idx, BUFFER_EDGE))
            nodes.append(ComputeNode(kname, 0, operands, results,
                                     flops, cost_ns))
            for r in results:
                producer[r] = idx
            continue
        # exchange
        _, sends, max_paths, num_chunks, results = op
        specs = []
        for (payload, src, dst) in sends:
            spec = capture.buffers[payload]
            specs.append((src, dst, spec.shape[0], as_dtype(spec.dtype)))
        group = plan_group_fn(specs, max_paths=max_paths,
                              num_chunks=num_chunks)
        for plan, (payload, _, _), rbuf in zip(group.plans, sends,
                                               results):
            m_idx = len(messages)
            messages.append((payload, rbuf))
            msg_nbytes[m_idx] = plan.nbytes
            plans_all.append(plan)
            flow = (plan.src, plan.dst)
            prod = producer.get(payload)
            terms = terminals_of.setdefault(rbuf, [])
            per_path = [(pa.route.directional_links(), pa.chunk_bounds())
                        for pa in plan.paths]
            waves = max((len(b) for _, b in per_path), default=0)
            for c_idx in range(waves):
                for p_idx, (links, bounds) in enumerate(per_path):
                    if c_idx >= len(bounds):
                        continue
                    off, size = bounds[c_idx]
                    first = len(nodes)
                    for h_idx, link in enumerate(links):
                        k = len(nodes)
                        nodes.append(CopyNode(flow, m_idx, p_idx, c_idx,
                                              h_idx, 0, link, off, size))
                        if h_idx:
                            edges.append(DepEdge(k - 1, k, HOP_EDGE))
                    if prod is not None:
                        edges.append(DepEdge(prod, first, BUFFER_EDGE))
                    terms.append(len(nodes) - 1)
    graph = TransferGraph(tuple(nodes), tuple(edges), 1, len(messages),
                          topology_name, tuple(messages))
    graph.validate(msg_nbytes, cross_flow_exclusive=False)
    return graph, tuple(plans_all)


@dataclasses.dataclass(frozen=True)
class CopyRun:
    """One maximal run of consecutive copy nodes of a scheduled step
    graph: one ``multipath_dma`` work table, launched once per
    execution."""

    nodes: tuple[int, ...]
    table: NodeTable
    items: torch.Tensor      # the table on the program's device
    state: torch.Tensor      # the kernel's state words
    grid: int


def _arena_layout(capture: StepCapture, rows: int
                  ) -> tuple[list[int], int]:
    """Each buffer's byte offset in an arena of ``rows`` logical devices'
    rows, and the arena's size."""
    bases, off = [], 0
    for spec in capture.buffers:
        bases.append(off)
        nbytes = rows * math.prod(spec.shape) * as_dtype(spec.dtype).itemsize
        off = -(-(off + nbytes) // _ALIGN) * _ALIGN
    return bases, max(off, 16)


def _arena_views(arena: torch.Tensor, capture: StepCapture,
                 bases: Sequence[int], rows: int) -> list[torch.Tensor]:
    """Buffer id → its ``(rows, *local)`` view of ``arena``."""
    return [arena[base:].view(as_dtype(spec.dtype))
            [:rows * math.prod(spec.shape)].view((rows,) + spec.shape)
            for spec, base in zip(capture.buffers, bases)]


def _message_sizes(graph: TransferGraph, capture: StepCapture
                   ) -> tuple[list[int], list[int]]:
    """Each message's element count and element size."""
    specs = [capture.buffers[payload] for payload, _ in graph.messages]
    return ([spec.shape[0] for spec in specs],
            [as_dtype(spec.dtype).itemsize for spec in specs])


def _segments(graph: TransferGraph):
    """The scheduled graph in index order: each compute node, and each
    maximal run of consecutive copy nodes as a ``range`` of indices."""
    idx = 0
    while idx < graph.num_nodes:
        if isinstance(graph.nodes[idx], ComputeNode):
            yield graph.nodes[idx]
            idx += 1
            continue
        end = idx
        while (end < graph.num_nodes
               and isinstance(graph.nodes[end], CopyNode)):
            end += 1
        yield range(idx, end)
        idx = end


def _store(node: ComputeNode, res, views: Sequence[torch.Tensor]) -> None:
    """Copy a kernel function's result(s) into the node's result views,
    checking their count and shapes."""
    res = res if isinstance(res, (tuple, list)) else (res,)
    if len(res) != len(node.results):
        raise ValueError(f"kernel {node.kernel!r} returned {len(res)} "
                         f"results, declared {len(node.results)}")
    for b, value, view in zip(node.results, res, views):
        if tuple(value.shape) != tuple(view.shape):
            raise ValueError(
                f"kernel {node.kernel!r} returned shape "
                f"{tuple(value.shape)} for buffer {b}, declared "
                f"{tuple(view.shape)}")
        view.copy_(value)


class StepProgram(GraphProgram):
    """One scheduled step graph made resident on a device — the executor
    of a captured step, with ``DmaProgram``'s interface (``device``,
    :meth:`capture`, :meth:`replay`, :meth:`inputs`, :meth:`outputs`), so
    :func:`~repro_torch.comm.cache.compile_plan` serves it unchanged.

    Every step buffer is a stacked ``(num_devices, *local)`` view of ONE
    byte arena. :meth:`run` walks the SCHEDULED graph in index order: a
    compute node calls its kernel function on the operand views and
    copies each result into its own view; each maximal run of
    consecutive copy nodes is one ``multipath_dma`` launch over a work
    table of that run, whose operand and output are both the arena (the
    payload's ``src`` row → the reception's ``dst`` row, the zero fill of
    the reception's other rows in the run holding the message's first
    node). A hop whose predecessor sits in an earlier run reads its slot
    in the staging buffer all runs share. On a CUDA device the whole walk
    is captured into ONE ``torch.cuda.CUDAGraph``; on the CPU it runs
    eagerly with the plain versions.
    """

    def __init__(self, graph: TransferGraph, capture: StepCapture,
                 outputs: Sequence[int], num_devices: int,
                 device: torch.device | str):
        self.device = dev = torch.device(device)
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {dev}")
        self.graph = graph
        self.kernels = dict(capture.kernels)
        self.input_ids = tuple(capture.inputs)
        self.output_ids = tuple(outputs)
        n = num_devices
        bases, size = _arena_layout(capture, n)
        self.arena = torch.zeros(size, dtype=torch.uint8, device=dev)
        #: buffer id → its stacked ``(n, *local)`` view of the arena
        self.views = _arena_views(self.arena, capture, bases, n)
        nelems, itemsizes = _message_sizes(graph, capture)
        msg_bases = [(bases[payload], bases[reception])
                     for payload, reception in graph.messages]
        slots: dict[int, int] = {}
        stage_end = 0
        self.walk: list[ComputeNode | CopyRun] = []
        for seg in _segments(graph):
            if isinstance(seg, ComputeNode):
                self.walk.append(seg)
                continue
            table = build_node_table(graph, nelems, itemsizes, n,
                                     nodes=seg, bases=msg_bases,
                                     slots=slots, stage_base=stage_end)
            stage_end = table.stage_bytes
            self.walk.append(CopyRun(
                tuple(seg), table, torch.from_numpy(table.items).to(dev),
                new_state(table.items, table.num_copy_nodes, dev),
                grid_size(table.num_items, dev) if dev.type == "cuda"
                else 0))
        self.stage = torch.empty(max(stage_end, 16), dtype=torch.uint8,
                                 device=dev)

    @property
    def copy_runs(self) -> list[CopyRun]:
        """The step's ``multipath_dma`` tables, in walk order."""
        return [w for w in self.walk if isinstance(w, CopyRun)]

    def inputs(self) -> list[torch.Tensor]:
        return [self.views[b] for b in self.input_ids]

    def outputs(self) -> list[torch.Tensor]:
        return [self.views[b] for b in self.output_ids]

    def _compute(self, node: ComputeNode) -> None:
        res = self.kernels[node.kernel](*[self.views[b]
                                          for b in node.operands])
        _store(node, res, [self.views[b] for b in node.results])

    def run(self) -> None:
        """Execute the walk once (no graph)."""
        for step in self.walk:
            if isinstance(step, ComputeNode):
                self._compute(step)
            elif self.device.type == "cuda":
                launch_table(step.items, self.arena, self.arena, self.stage,
                             step.state, step.grid)
            else:
                run_node_table_plain(step.table.items, self.arena,
                                     self.arena, self.stage)


@dataclasses.dataclass(frozen=True)
class PeerCopyRun:
    """One maximal run of consecutive copy nodes of a peer step: one
    per-device ``multipath_dma`` table over the step's arenas, launched
    once a card per execution."""

    nodes: tuple[int, ...]
    table: NodeTable
    program: PeerDmaProgram


@dataclasses.dataclass(frozen=True)
class PeerNode:
    """A compute node of a peer step whose kernel function has a peer
    form: one program over every logical device's views, launched once a
    card."""

    node: ComputeNode
    program: GraphProgram


class PeerStepProgram(GraphProgram):
    """One scheduled step graph made resident on a peer session's logical
    devices, ``devices[d]`` for device *d* (a card may hold several), with
    :class:`StepProgram`'s interface: ``inputs()`` and ``outputs()`` give,
    per buffer, one ``(1, *local)`` view a logical device.

    Every logical device holds its own arena on its device, zeroed once
    when it is made: the copy tables have no fill (buffers are SSA, so no
    other write reaches a reception), and a reception keeps exact zeros on
    every device but its destination, the summable-receptions contract.
    The walk is the scheduled graph's, in index order: a compute node
    calls its kernel function once a logical device on that device's
    views (:func:`axis_index` gives ``[d]``), or, for a function with a
    peer form, runs that form's program; each maximal run of copy nodes
    is one per-device table (payload on its src's arena → reception on
    its dst's, staging slots on each hop's via, unique across the step's
    runs), a :class:`~repro_torch.kernels.multipath_dma.kernel.PeerDmaProgram`
    over the arenas. A stage that lands on another card for a hop 2 of a
    later run is awaited by the via card's launch of its own run
    (:func:`~repro_torch.kernels.multipath_dma.kernel.card_tables`).

    On CUDA :meth:`bodies` gives one body a card (its devices' compute,
    its share of each table and of each peer form, in walk order),
    recorded as one graph each; :meth:`~GraphProgram.order` runs before
    every execution. On the CPU the walk runs eagerly with the plain
    versions.
    """

    def __init__(self, graph: TransferGraph, capture: StepCapture,
                 outputs: Sequence[int],
                 devices: Sequence[torch.device | str]):
        self.devices = tuple(torch.device(d) for d in devices)
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
            raise ValueError(f"devices must be all CUDA or all CPU, got "
                             f"{[str(d) for d in self.devices]}")
        self._cards = tuple(dict.fromkeys(self.devices))
        self.device = self._cards[0]
        #: card index → the logical devices it holds
        self.held = [[d for d, dev in enumerate(self.devices) if dev == card]
                     for card in self._cards]
        self.graph = graph
        self.kernels = dict(capture.kernels)
        self.input_ids = tuple(capture.inputs)
        self.output_ids = tuple(outputs)
        n = len(self.devices)
        bases, size = _arena_layout(capture, 1)
        self.arenas = [torch.zeros(size, dtype=torch.uint8, device=d)
                       for d in self.devices]
        per_device = [_arena_views(a, capture, bases, 1)
                      for a in self.arenas]
        #: buffer id → its ``(1, *local)`` view on each logical device
        self.views = [list(vs) for vs in zip(*per_device)]
        self._index = [torch.tensor([d], dtype=torch.int64, device=dev)
                       for d, dev in enumerate(self.devices)]
        nelems, itemsizes = _message_sizes(graph, capture)
        msg_bases = [((bases[payload], bases[reception]),) * n
                     for payload, reception in graph.messages]
        dtypes = [as_dtype(capture.buffers[payload].dtype)
                  for payload, _ in graph.messages]
        slots: dict[int, int] = {}
        stage_at = [0] * n
        runs = []
        for seg in _segments(graph):
            if isinstance(seg, ComputeNode):
                runs.append(seg)
                continue
            table = build_node_table(graph, nelems, itemsizes, n,
                                     fill="none", nodes=seg,
                                     bases=msg_bases, slots=slots,
                                     stage_base=stage_at, per_device=True)
            stage_at = [own[2] for own in table.device_bytes]
            runs.append((tuple(seg), table))
        self.stages = [torch.empty(max(nb, 16), dtype=torch.uint8, device=d)
                       for nb, d in zip(stage_at, self.devices)]
        self.walk: list[ComputeNode | PeerNode | PeerCopyRun] = []
        for step in runs:
            if isinstance(step, ComputeNode):
                form = getattr(self.kernels[step.kernel], "peer_program",
                               None)
                self.walk.append(step if form is None else PeerNode(
                    step, form(self.devices,
                               [self.views[b] for b in step.operands],
                               [self.views[b] for b in step.results])))
                continue
            nodes, table = step
            self.walk.append(PeerCopyRun(nodes, table, PeerDmaProgram(
                table, dtypes, self.devices,
                buffers=(self.arenas, self.arenas, self.stages))))

    @property
    def cards(self) -> tuple[torch.device, ...]:
        """The distinct devices of the logical devices, in first-use
        order."""
        return self._cards

    @property
    def copy_runs(self) -> list[PeerCopyRun]:
        """The step's per-device ``multipath_dma`` tables, in walk
        order."""
        return [w for w in self.walk if isinstance(w, PeerCopyRun)]

    def inputs(self) -> list[list[torch.Tensor]]:
        return [self.views[b] for b in self.input_ids]

    def outputs(self) -> list[list[torch.Tensor]]:
        return [self.views[b] for b in self.output_ids]

    def _compute(self, node: ComputeNode, d: int) -> None:
        with _indexed(self._index[d]):
            res = self.kernels[node.kernel](*[self.views[b][d]
                                              for b in node.operands])
        _store(node, res, [self.views[b][d] for b in node.results])

    def _run_step(self, step, card: int) -> None:
        """Card ``card``'s part of one walk step."""
        if isinstance(step, ComputeNode):
            for d in self.held[card]:
                self._compute(step, d)
        else:
            step.program.run_card(card)

    def _run_card(self, card: int) -> None:
        for step in self.walk:
            self._run_step(step, card)

    def bodies(self) -> list[tuple[torch.device, Callable[[], None]]]:
        """One body a card: its part of the walk."""
        return [(card, functools.partial(self._run_card, c))
                for c, card in enumerate(self._cards)]

    def run(self) -> None:
        """Execute the walk once (no graph). On CUDA, ordered across the
        cards, each walk step enqueued on every card before the next
        (a launch that waits on another card's launch of the same table
        never sits ahead of a host-blocking call of its own card); on the
        CPU in walk order with the plain versions."""
        if self.device.type == "cuda":
            self.order()
            for step in self.walk:
                for c, card in enumerate(self._cards):
                    with torch.cuda.device(card):
                        self._run_step(step, c)
            return
        for step in self.walk:
            if isinstance(step, ComputeNode):
                for d in range(len(self.devices)):
                    self._compute(step, d)
            elif isinstance(step, PeerNode):
                step.program.run()
            else:
                run_node_table_plain(step.table.items, self.arenas,
                                     self.arenas, self.stages)


class CapturedStep:
    """Launchable handle for one captured iteration.

    Calling it stages the inputs and launches the resident program ONCE —
    ``session.stats()["dispatches"]`` increments by exactly one per call,
    the acceptance invariant of whole-iteration capture. Outputs come back
    device-stacked ``(num_devices, *local_shape)``, as fresh tensors; on a
    peer session as one list a declared output, ``local_shape`` tensor
    *d* on ``devices[d]``.
    Resolution rides the engine's fast path: the capture
    :meth:`~StepCapture.signature` + schedule name + planner epoch memoize
    the lowered/scheduled/resident entry, and the scheduled graph digest
    keys the program — two schedules of the same capture digest apart and
    never cross-serve.
    """

    def __init__(self, engine, capture: StepCapture,
                 outputs: Sequence[BufferRef],
                 schedule: str | None = None):
        self.engine = engine
        self.capture = capture
        self.outputs = tuple(capture._resolve(r) for r in outputs)
        self.schedule = schedule

    def resolve(self, schedule: str | None = None):
        """Resolve (lower → schedule → validate → capture → memoize)
        without launching; returns the fast-path entry whose ``graph``
        (scheduled, digest-keyed) the §2.2 contract checked."""
        return self.engine.resolve_step(
            self, schedule if schedule is not None else self.schedule)

    def __call__(self, *tensors, schedule: str | None = None,
                 block: bool = True) -> list[torch.Tensor]:
        """Run one captured iteration as ONE dispatch; ``tensors`` align
        with the capture's declared inputs (stacked inputs are
        ``(num_devices, *local)``, on a peer session lists of
        ``num_devices`` local tensors, tensor *d* for ``devices[d]``;
        replicated inputs are bare local tensors, copied to every device,
        or on a peer session also a list of ``num_devices`` local tensors,
        tensor *d* on ``devices[d]``, each staged by a copy on its own
        device; a list with a wrong device or shape raises
        ``ValueError``). Each device's kernels read their own copy of a
        replicated list (the captured DP step's replicas, fed back)."""
        return self.engine.run_step(
            self, tensors,
            schedule=schedule if schedule is not None else self.schedule,
            block=block)


def _joined(received) -> torch.Tensor:
    """A device's received value: the exact zero-sum of the receptions."""
    got = received[0]
    for x in received[1:]:
        got = got + x
    return got


def _ring_round(acc_v, *received):
    got = _joined(received)
    return acc_v + got, got


def _tree_forward(acc_v, *received):
    return acc_v, _joined(received)


def _tree_close(acc_v, *received):
    total = acc_v + _joined(received)
    return total, total


def _tree_closes(n: int) -> set[int]:
    """The rounds of a tree psum over ``n`` devices (a power of two) that
    close a level: level *l* forwards for ``n / 2**(l+1)`` rounds and
    adds what the last of them brings."""
    closes, r, span = set(), -1, n // 2
    while span:
        r += span
        closes.add(r)
        span //= 2
    return closes


def captured_psum(cap: StepCapture, ref: BufferRef, num_devices: int, *,
                  max_paths: int | None = None,
                  num_chunks: int | None = None,
                  name: str | None = None,
                  tree: bool = False) -> BufferRef:
    """Express a ring all-reduce *sum* of a 1-D buffer as capture ops.

    ``num_devices - 1`` rounds; each round is one fused multipath
    exchange of every device's running value to its right neighbor plus
    one combine kernel that joins the receptions by exact zero-sum (the
    module-docstring contract) and accumulates. The whole collective
    therefore lives inside the SAME step graph as the compute that
    produced ``ref``. Divide by ``num_devices`` afterwards for a pmean.

    By default every device adds the others' values in its own ring
    order, so the devices' sums may differ in their last bits. With
    ``tree=True`` (``num_devices`` a power of two) the same exchanges and
    kernels add in one halving-tree order instead: a level of distance
    *D* forwards what it receives for *D* rounds, and its last round adds
    the value *D* devices to the left, ``((x0 + x2) + (x1 + x3))`` at 4
    devices. Every device's sum then has the same bits. The rounds'
    kernels are named ``{name}_r{r}`` either way (the names the digest
    keys): a tree sum and a ring sum in one session take different names.
    """
    n = int(num_devices)
    if n < 2:
        return ref
    if tree and n & (n - 1):
        raise ValueError(f"a tree psum needs a power-of-two device count, "
                         f"got {n}")
    prefix = name if name is not None else (
        f"{'treesum' if tree else 'psum'}{len(cap.ops)}")
    nelems = cap.buffers[cap._resolve(ref)].shape[0]
    closes = _tree_closes(n) if tree else set()
    acc, cur = ref, ref
    for r in range(n - 1):
        recvs = cap.exchange([(cur, i, (i + 1) % n) for i in range(n)],
                             max_paths=max_paths, num_chunks=num_chunks)
        combine = (_ring_round if not tree else
                   _tree_close if r in closes else _tree_forward)
        acc, cur = cap.kernel(combine, acc, *recvs,
                              name=f"{prefix}_r{r}",
                              flops=(n + 1) * nelems)
    return acc
