"""TransferGraph — the first-class copy-node DAG (the CUDA Graph analogue).

The paper's core artifact is the CUDA Graph itself: explicit memcpy nodes
with dependency edges, instantiated once and replayed. This module makes
that graph a first-class IR for the repo: a single lowering pass
(:func:`lower`) turns a :class:`~repro_torch.comm.plan.TransferPlan` or a
:class:`~repro_torch.comm.plan.TransferGroup` into a :class:`TransferGraph` —
one :class:`CopyNode` per chunk per hop per window round, plus explicit
dependency edges — and every downstream layer consumes the same graph:

* the executable engine (:mod:`repro_torch.comm.engine`) turns the nodes,
  in index order, into the work table of the ``multipath_dma`` kernel,
* the analytic model (:mod:`repro_torch.core.pipelining`) evaluates wire time
  as the critical path over the DAG and launch overhead from the node
  count,
* the §4.5 validators check disjoint byte cover, directional-link
  exclusivity, and connected hop chains on nodes/edges,
* compiled-program cache keys derive from the canonical
  :meth:`TransferGraph.digest`.

Because the model, the validator, and the executable are all views over
ONE lowering, they can no longer silently disagree about what a plan
means (the PR-2 mid-route-host bug was exactly such a divergence).

The IR is **heterogeneous** (whole-iteration capture): alongside
:class:`CopyNode` the graph may carry :class:`ComputeNode` entries —
one per SPMD kernel invocation — so a full iteration (stencil sweep + halo
exchange, grad compute + multipath pmean) is ONE graph scheduled by the
same passes and launched as ONE compiled program. Compute nodes declare
the *buffer ids* they read (``operands``) and write (``results``);
dataflow between compute and copies is stored as ``"buffer"`` edges and
validated as part of §4.5 (def-use consistency against the graph's
``messages`` table).

Edge kinds:

* ``"hop"`` — hop order within a chunk (hop *i+1* consumes hop *i*'s
  value; the CUDA Graph dependency edge),
* ``"window"`` — replay ordering between window rounds of the same chunk
  (round *w+1* re-sends the chunk after round *w* completed),
* ``"buffer"`` — def-use dataflow through a named buffer: producer
  compute → first-hop copy of a message whose payload it wrote, terminal
  copy → consumer compute of the message's reception buffer, or compute
  → compute directly.

Per-link serialization between consecutive chunks of one path is *not*
stored — it is derivable (:meth:`TransferGraph.serialization_edges`) and
only the time model needs it; storing it would bloat digests without
adding information.

**Dispatch order is node-index order.** The lowering emits nodes in the
paper's Algorithm 1 round-robin interleave (chunk waves across paths);
chunk-interleaving schedulers (:mod:`repro_torch.comm.passes`) are graph→graph
rewrites that renumber nodes into a different dispatch order between
:func:`lower` and the emitter, preserving the §4.5 invariants (byte cover
and hop chains fixed, serialization order free) while :meth:`digest`
distinguishes the schedules. See DESIGN.md §2.2 for the pass contract.
"""

from __future__ import annotations

import dataclasses
import hashlib
import heapq
from functools import cached_property, lru_cache

from repro_torch.comm.plan import TransferGroup, TransferPlan

#: Edge kinds (see module docstring).
HOP_EDGE = "hop"
WINDOW_EDGE = "window"
BUFFER_EDGE = "buffer"


@dataclasses.dataclass(frozen=True)
class CopyNode:
    """One copy node: one chunk of one message crossing one link.

    The CUDA-Graph memcpy-node analogue (paper Fig. 13/14). ``offset`` /
    ``nbytes`` are the chunk's byte range *within its message* — constant
    along the chunk's hop chain, so every node knows exactly which bytes
    it moves.

    Invariant obligations (§4.5, checked by :meth:`TransferGraph.validate`):
    nodes of one message must cover ``[0, nbytes)`` disjointly at their
    terminal hops, and a node's ``(flow, msg_idx, path_idx, chunk_idx,
    hop_idx, window, link, offset, nbytes)`` tuple is its identity — a
    scheduler pass may renumber node *indices* but must never alter the
    tuple itself (byte cover and hop chains are fixed).
    """

    flow: tuple[int, int]      # (src, dst) of the owning message
    msg_idx: int               # message index within the group
    path_idx: int              # horizontal split index within the message
    chunk_idx: int             # vertical split index within the path
    hop_idx: int               # position along the route's hop chain
    window: int                # replay round (0-based)
    link: tuple[int, int]      # directional link traversed
    offset: int                # byte offset into the message
    nbytes: int                # chunk size in bytes


@dataclasses.dataclass(frozen=True)
class ComputeNode:
    """One SPMD kernel invocation inside a heterogeneous graph.

    The CUDA-Graph kernel-node analogue: ``kernel`` is the registered
    kernel name (its *identity* — digests, cache keys, and telemetry
    signatures all key on it, so re-registering a different function
    under the same name is a contract breach exactly like mutating a
    cached plan). ``operands`` / ``results`` are buffer ids in the
    owning capture's buffer table; the §4.5 validator checks that every
    :data:`BUFFER_EDGE` touching this node is consistent with them
    (def-use edges must name buffers the node actually reads/writes).

    Invariant obligations (§2.2): like :class:`CopyNode`, the tuple
    ``(kernel, window, operands, results, flops, cost_ns)`` is the
    node's identity — scheduler passes may renumber indices but must
    preserve the tuple (unless they declare ``allows_rewrite``).
    ``flops`` / ``cost_ns`` feed the cost model: ``cost_ns`` (measured)
    wins when non-zero, else declared ``flops`` are priced at the
    :data:`repro_torch.core.pipelining.COMPUTE_GFLOPS` rate.
    """

    kernel: str                 # registered kernel name (identity)
    window: int                 # replay round (0-based)
    operands: tuple[int, ...]   # buffer ids read
    results: tuple[int, ...]    # buffer ids written
    flops: int = 0              # declared work (model input)
    cost_ns: int = 0            # measured time; overrides flops if set


@dataclasses.dataclass(frozen=True)
class DepEdge:
    """A dependency edge between node indices (``src`` before ``dst``).

    Invariant obligations: index order is dispatch order, so every stored
    edge must point forward (``src < dst`` after any scheduler pass — the
    §2.2 contract; :meth:`TransferGraph.topological_order` re-validates
    acyclicity). ``kind`` is :data:`HOP_EDGE` (dataflow: hop *i+1*
    consumes hop *i*'s value), :data:`WINDOW_EDGE` (replay ordering), or
    :data:`BUFFER_EDGE` (def-use dataflow through a named buffer, the
    compute↔copy coupling in heterogeneous graphs); passes may not add,
    drop, or re-kind edges, only renumber endpoints (unless they declare
    ``allows_rewrite`` — see DESIGN §2.2).
    """

    src: int
    dst: int
    kind: str  # HOP_EDGE | WINDOW_EDGE


def canonical_digest(payload: object) -> str:
    """Stable hex digest of a canonical (repr-able) payload.

    Used by :meth:`TransferGraph.digest` and by non-P2P cache keys (the
    collective keys) so every compiled-program key in the plan cache is
    derived the same way. The payload must already be canonical — the
    caller's invariant obligation is that two semantically identical
    inputs ``repr`` identically (sort any unordered parts first).
    """
    return hashlib.sha256(repr(payload).encode()).hexdigest()[:32]


@dataclasses.dataclass(frozen=True)
class TransferGraph:
    """The copy-node DAG for one message or one fused transfer group.

    Node-index order is the dispatch schedule: the emitter walks indices
    (via :meth:`topological_order`), the model serializes same-link chunks
    in index order, and :meth:`digest` — the cache-key ingredient — hashes
    nodes *in order*, so two schedules of one plan digest apart. The §4.5
    invariants live in :meth:`validate`; scheduler passes must preserve
    them and leave the node/edge *content* untouched (DESIGN.md §2.2).
    """

    nodes: tuple[CopyNode | ComputeNode, ...]
    edges: tuple[DepEdge, ...]
    window: int
    num_messages: int
    topology_name: str
    #: msg_idx → (payload buffer id, reception buffer id) for captured
    #: graphs; empty for pure-comm lowerings. Needed by the §4.5 buffer
    #: def-use validation and the heterogeneous emitter.
    messages: tuple[tuple[int, int], ...] = ()

    # -- basic shape --------------------------------------------------------
    @property
    def num_nodes(self) -> int:
        """Total node count (copies + computes) — invariant under every
        non-rewriting scheduler pass (the equal-graph acceptance: executed
        copy nodes + kernel calls equal this)."""
        return len(self.nodes)

    @property
    def num_copy_nodes(self) -> int:
        """:class:`CopyNode` count — equals the copy nodes the
        ``multipath_dma`` kernel completes per launch; invariant under
        non-rewriting passes (§2.2)."""
        return sum(1 for n in self.nodes if isinstance(n, CopyNode))

    @property
    def num_compute_nodes(self) -> int:
        """:class:`ComputeNode` count — equals the traced kernel-call
        count; invariant under non-rewriting passes (§2.2)."""
        return sum(1 for n in self.nodes if isinstance(n, ComputeNode))

    @property
    def num_edges(self) -> int:
        """Stored dependency-edge count (hop + window + buffer;
        serialization edges are derived, not stored) — invariant under
        passes."""
        return len(self.edges)

    def flows(self) -> tuple[tuple[int, int], ...]:
        """Per-message (src, dst), aligned with ``msg_idx``. Compute
        nodes carry no flow and are skipped; the §4.5 per-message
        invariants apply to copy nodes only."""
        seen: dict[int, tuple[int, int]] = {}
        for n in self.nodes:
            if isinstance(n, CopyNode):
                seen.setdefault(n.msg_idx, n.flow)
        return tuple(seen[i] for i in sorted(seen))

    # -- dataflow structure -------------------------------------------------
    @cached_property
    def hop_predecessor(self) -> dict[int, int]:
        """Node index → its hop-chain predecessor (data dependency)."""
        return {e.dst: e.src for e in self.edges if e.kind == HOP_EDGE}

    @cached_property
    def terminal_nodes(self) -> frozenset[int]:
        """Copy nodes with no outgoing hop edge — each chunk's landing
        copy (compute nodes are never terminals; the §4.5 byte-cover
        invariant is checked over exactly this set)."""
        non_terminal = {e.src for e in self.edges if e.kind == HOP_EDGE}
        return frozenset(
            i for i, n in enumerate(self.nodes)
            if isinstance(n, CopyNode)) - non_terminal

    def topological_order(self) -> list[int]:
        """Kahn's algorithm over the stored edges, lowest index first.

        The lowering emits nodes in a valid topological order already;
        running Kahn's keeps that a checked property rather than a
        convention (a cycle raises ``ValueError``).
        """
        succs: dict[int, list[int]] = {}
        indeg = [0] * self.num_nodes
        for e in self.edges:
            succs.setdefault(e.src, []).append(e.dst)
            indeg[e.dst] += 1
        ready = [i for i, d in enumerate(indeg) if d == 0]
        heapq.heapify(ready)
        order: list[int] = []
        while ready:
            i = heapq.heappop(ready)
            order.append(i)
            for j in succs.get(i, ()):
                indeg[j] -= 1
                if indeg[j] == 0:
                    heapq.heappush(ready, j)
        if len(order) != self.num_nodes:
            raise ValueError("dependency cycle in transfer graph")
        return order

    def serialization_edges(self) -> list[tuple[int, int]]:
        """Implicit per-link serialization edges (not stored, derived).

        Consecutive chunks of one (message, path, window) traverse the
        same directional link at the same hop position and serialize on
        it **in dispatch (node-index) order** — so a scheduler pass that
        renumbers nodes reorders exactly these edges, which is the only
        freedom the §2.2 pass contract grants. The critical-path
        evaluations in :mod:`repro_torch.core.pipelining` add these to the hop
        and window edges. Compute nodes all share one ``("compute",)``
        slot — kernels execute serially on the device's compute stream
        in dispatch order, which is the resource the §2.2 schedulers
        trade against link serialization when they interleave copies
        into compute gaps.
        """
        by_slot: dict[tuple, list[int]] = {}
        for i, n in enumerate(self.nodes):
            if isinstance(n, ComputeNode):
                by_slot.setdefault(("compute",), []).append(i)
            else:
                by_slot.setdefault(
                    (n.msg_idx, n.path_idx, n.window, n.hop_idx),
                    []).append(i)
        out: list[tuple[int, int]] = []
        for slot in by_slot.values():
            out.extend(zip(slot, slot[1:]))
        return out

    def critical_path_nodes(self) -> int:
        """Longest chain length (in nodes) over hop + serialization +
        window edges — the depth of the DAG the scheduler must respect."""
        depth = [1] * self.num_nodes
        succs: dict[int, list[int]] = {}
        for e in self.edges:
            succs.setdefault(e.src, []).append(e.dst)
        for a, b in self.serialization_edges():
            succs.setdefault(a, []).append(b)
        for i in reversed(self.topological_order()):
            for j in succs.get(i, ()):
                depth[i] = max(depth[i], 1 + depth[j])
        return max(depth, default=0)

    # -- identity -----------------------------------------------------------
    @cached_property
    def _digest(self) -> str:
        """Memoized hash body — computed once per (frozen) instance.

        Nodes/edges are immutable, so the digest is a pure function of
        the instance; before this memo every ``_group_key`` construction
        re-hashed the whole graph on the dispatch hot path. The §2.2
        invariant that passes return *new* graphs (never mutate) is what
        makes per-instance caching sound. Nodes are tagged with their
        type name so heterogeneous graphs canonicalize unambiguously —
        a :class:`CopyNode` and a :class:`ComputeNode` can never collide
        even if their field tuples happened to match.
        """
        return canonical_digest((
            tuple((type(n).__name__,) + dataclasses.astuple(n)
                  for n in self.nodes),
            tuple(sorted(dataclasses.astuple(e) for e in self.edges)),
            self.window, self.num_messages, self.messages))

    def digest(self) -> str:
        """Canonical content hash — THE cache-key ingredient.

        Two lowerings digest equal iff they have identical nodes *in the
        same dispatch order*, the same edge set, and the same window
        count, regardless of how the source plan objects were assembled;
        compiled-program keys (:class:`repro_torch.comm.engine.GroupKey`) are
        derived from this instead of hand-assembled plan signatures.

        Node order is significant on purpose — it IS the schedule, so two
        scheduler passes over one plan digest apart and can never
        cross-serve executables. Edge *storage* order is not semantic
        (edges are a set) and is sorted before hashing, so a pass that
        renumbers nodes and re-sorts edges digests equal to any other
        pass producing the same dispatch order. Memoized on the instance
        (graphs are frozen): repeat calls — e.g. steady-state dispatch
        re-deriving a ``GroupKey`` — hash nothing.
        """
        return self._digest

    # -- invariants (§4.5, checked on nodes/edges) --------------------------
    def validate(self, nbytes_per_message: dict[int, int] | None = None,
                 *, cross_flow_exclusive: bool = True) -> None:
        """Assert the §4.5 integrity invariants on the graph itself.

        1. **Disjoint byte cover** — per message, terminal-node chunk
           ranges are disjoint and (when ``nbytes_per_message`` is given)
           exactly cover ``[0, nbytes)``.
        2. **Directional-link exclusivity** — within one message no two
           paths share a link; across messages no link carries two
           *distinct* flows (same-flow messages legitimately share their
           flow's routes). ``cross_flow_exclusive=False`` skips the
           cross-message half (the planner's shared fallback trades it
           away deliberately).
        3. **Connected hop chains** — every chunk's links chain
           ``flow.src → ... → flow.dst`` in hop order.
        4. **Buffer def-use consistency** (heterogeneous graphs) — every
           :data:`BUFFER_EDGE` names real dataflow: compute→compute
           edges share a buffer id between the producer's ``results``
           and the consumer's ``operands``; compute→copy edges land on a
           first-hop copy of a message whose payload buffer the producer
           wrote; copy→compute edges leave a terminal copy of a message
           whose reception buffer the consumer reads (resolved through
           the graph's ``messages`` table).

        Raises ``ValueError`` on any breach.
        """
        # (2) link exclusivity, on copy nodes
        link_paths: dict[tuple[int, tuple[int, int]], int] = {}
        link_flow: dict[tuple[int, int], tuple[int, int]] = {}
        for n in self.nodes:
            if not isinstance(n, CopyNode):
                continue
            prev_path = link_paths.setdefault((n.msg_idx, n.link),
                                              n.path_idx)
            if prev_path != n.path_idx:
                raise ValueError(
                    f"directional link {n.link} shared by paths")
            if cross_flow_exclusive:
                prev_flow = link_flow.setdefault(n.link, n.flow)
                if prev_flow != n.flow:
                    raise ValueError(
                        f"directional link {n.link} shared across flows "
                        f"{prev_flow} and {n.flow} (group-level §4.5 "
                        f"exclusivity breach)")
        # (3) connected hop chains, on hop edges
        chains: dict[tuple[int, int, int, int], list[CopyNode]] = {}
        for n in self.nodes:
            if not isinstance(n, CopyNode):
                continue
            chains.setdefault(
                (n.msg_idx, n.path_idx, n.chunk_idx, n.window),
                []).append(n)
        for chain in chains.values():
            chain.sort(key=lambda n: n.hop_idx)
            links = [n.link for n in chain]
            flow = chain[0].flow
            if links[0][0] != flow[0] or links[-1][1] != flow[1]:
                raise ValueError(f"route endpoints wrong: {links}")
            for (a, b), (c, d) in zip(links, links[1:]):
                if b != c:
                    raise ValueError(f"disconnected hops {links}")
        # (1) disjoint cover, on terminal nodes of window 0 (messages that
        # lowered to no nodes still get their coverage checked)
        per_msg: dict[int, list[tuple[int, int]]] = {
            m: [] for m in range(self.num_messages)}
        for i in self.terminal_nodes:
            n = self.nodes[i]
            if n.window:
                continue
            per_msg.setdefault(n.msg_idx, []).append((n.offset, n.nbytes))
        for msg_idx, intervals in per_msg.items():
            intervals.sort()
            pos = 0
            for off, size in intervals:
                if off != pos:
                    raise ValueError(
                        f"gap/overlap at byte {pos} (chunk at {off})")
                if size <= 0:
                    raise ValueError("empty chunk")
                pos = off + size
            if nbytes_per_message is not None:
                want = nbytes_per_message[msg_idx]
                if pos != want:
                    raise ValueError(
                        f"coverage ends at {pos}, message is {want}")
        # (4) buffer def-use consistency, on buffer edges
        for e in self.edges:
            if e.kind != BUFFER_EDGE:
                continue
            src_n, dst_n = self.nodes[e.src], self.nodes[e.dst]
            if isinstance(src_n, ComputeNode) and isinstance(
                    dst_n, ComputeNode):
                if not set(src_n.results) & set(dst_n.operands):
                    raise ValueError(
                        f"buffer edge {e.src}->{e.dst} names no shared "
                        f"buffer between producer results and consumer "
                        f"operands")
                continue
            if not self.messages:
                raise ValueError(
                    "buffer edge touches a copy node but the graph has "
                    "no messages table")
            if isinstance(src_n, ComputeNode):
                if not isinstance(dst_n, CopyNode) or dst_n.hop_idx != 0:
                    raise ValueError(
                        f"compute->copy buffer edge {e.src}->{e.dst} "
                        f"must land on a first-hop copy")
                payload, _ = self.messages[dst_n.msg_idx]
                if payload not in src_n.results:
                    raise ValueError(
                        f"copy {e.dst} reads payload buffer {payload} "
                        f"that compute {e.src} does not write")
            elif isinstance(dst_n, ComputeNode):
                if e.src not in self.terminal_nodes:
                    raise ValueError(
                        f"copy->compute buffer edge {e.src}->{e.dst} "
                        f"must leave a terminal copy")
                _, result = self.messages[src_n.msg_idx]
                if result not in dst_n.operands:
                    raise ValueError(
                        f"compute {e.dst} does not read reception "
                        f"buffer {result} written by copy {e.src}")
            else:
                raise ValueError(
                    f"buffer edge {e.src}->{e.dst} joins two copy nodes")


@lru_cache(maxsize=256)
def lower(obj: TransferPlan | TransferGroup, window: int = 1
          ) -> TransferGraph:
    """THE lowering pass: plan/group → copy-node DAG.

    One :class:`CopyNode` per chunk per hop per window round, emitted in
    the paper's Algorithm 1 **round-robin dispatch order**: window-major,
    then message, then chunk *waves* interleaved across paths (chunk 0 of
    every path, chunk 1 of every path, …), hops innermost. This emission
    order is a valid topological order and is exactly what the
    ``round_robin`` scheduler pass (:mod:`repro_torch.comm.passes`) reproduces
    — applying it to a fresh lowering is the identity (same digest).
    Edges: hop order within each chunk (``"hop"``), and replay ordering
    between a chunk's last hop in round *w* and its first hop in round
    *w+1* (``"window"``). So for any lowering::

        num_nodes == window * Σ_paths chunks·hops
        num_edges == window * Σ_chunks (hops−1) + (window−1) · Σ chunks

    Plans and groups are frozen/hashable, so lowerings are memoized —
    the engine, the model, and the validator all get the *same* graph
    object for the same source, and the invariant checks
    (:meth:`TransferGraph.validate`) apply to the one graph they share.
    """
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if isinstance(obj, TransferPlan):
        plans: tuple[TransferPlan, ...] = (obj,)
        topo_name = obj.topology_name
        num_messages = 1
    else:
        plans = tuple(obj.plans)
        topo_name = obj.topology_name
        num_messages = len(plans)

    nodes: list[CopyNode] = []
    edges: list[DepEdge] = []
    # (msg, path, chunk) → (first-hop idx, last-hop idx) of previous window
    prev_round: dict[tuple[int, int, int], tuple[int, int]] = {}
    for w in range(window):
        for m_idx, plan in enumerate(plans):
            flow = (plan.src, plan.dst)
            per_path = [(pa.route.directional_links(), pa.chunk_bounds())
                        for pa in plan.paths]
            waves = max((len(bounds) for _, bounds in per_path), default=0)
            for c_idx in range(waves):
                for p_idx, (links, bounds) in enumerate(per_path):
                    if c_idx >= len(bounds):
                        continue
                    off, size = bounds[c_idx]
                    first = len(nodes)
                    for h_idx, link in enumerate(links):
                        idx = len(nodes)
                        nodes.append(CopyNode(
                            flow, m_idx, p_idx, c_idx, h_idx, w,
                            link, off, size))
                        if h_idx:
                            edges.append(DepEdge(idx - 1, idx, HOP_EDGE))
                    last = len(nodes) - 1
                    chunk_key = (m_idx, p_idx, c_idx)
                    if chunk_key in prev_round:
                        edges.append(DepEdge(prev_round[chunk_key][1],
                                             first, WINDOW_EDGE))
                    prev_round[chunk_key] = (first, last)
    return TransferGraph(tuple(nodes), tuple(edges), window,
                         num_messages, topo_name)
