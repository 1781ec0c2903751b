"""Graph-pass pipeline: pluggable chunk-interleaving schedulers.

The paper's Algorithm 1 distributes chunks across paths in one fixed
round-robin order; its CUDA-Graph formulation makes dispatch order a
property of the *captured graph*. In this repo that property is the
node-index order of the :class:`~repro_torch.comm.graph.TransferGraph`, so a
scheduler is a pure ``TransferGraph -> TransferGraph`` rewrite applied
between :func:`repro_torch.comm.graph.lower` and the emitter
(:func:`repro_torch.comm.engine.emit_graph`) — a *graph pass*.

**The pass contract (DESIGN.md §2.2).** A pass may renumber node indices
(the dispatch order, and with it the derived per-link serialization
edges); it must NOT change anything else:

* the node multiset is fixed — byte cover, hop chains, flows, chunking
  are §4.5 invariants the pass inherits and must preserve,
* the stored edge *set* (hop dataflow + window replay + buffer def-use,
  identified by the node content at each endpoint) is fixed; only
  endpoint indices are remapped,
* index order must remain a valid topological order (every stored edge
  points forward), so the emitter's walk IS the schedule,
* the scheduled graph must still pass
  :meth:`~repro_torch.comm.graph.TransferGraph.validate`, and its
  :meth:`~repro_torch.comm.graph.TransferGraph.digest` is recomputed from the
  new node order — cache keys (``GroupKey``) therefore distinguish
  schedules and can never cross-serve executables.

**The ``allows_rewrite`` capability flag.** A pass that sets a truthy
``allows_rewrite`` attribute opts out of the node-multiset and edge-set
freezes — it may rewrite node *content* (e.g. the ROADMAP host-staged
pricing pass replacing host hops with a simulated stage). The rest of
the contract still binds: metadata fixed, every stored edge forward, and
the §4.5 validation re-run on the output. :func:`check_pass` reads the
flag; passes that don't declare it get the full freeze.

Graphs may be **heterogeneous** (whole-iteration capture): the shipped
schedulers are compute-aware — :class:`~repro_torch.comm.graph.ComputeNode`
entries serialize on one shared compute slot while ready copies are dispatched
ahead of ready computes, so copies slot into compute gaps and the
emitter overlaps communication with kernel execution.

:func:`apply_schedule` enforces all of this after every pass
(:func:`check_pass`), so a buggy custom pass fails loudly at schedule
time rather than corrupting a compiled program.

Shipped schedulers (:data:`repro_torch.comm.config.SCHEDULE_NAMES`):

* ``round_robin`` — the paper's Alg. 1 order, i.e. today's lowering
  emission (chunk waves interleaved across paths). Identity on a fresh
  lowering: same nodes, same digest.
* ``depth_first`` — drain each path's whole chunk chain before switching
  to the next path (minimizes per-link switchover at the cost of late
  path starts).
* ``critical_path`` — greedy list scheduling under the §4.4 weighted
  model (:func:`repro_torch.core.pipelining.scheduled_time_s` semantics):
  repeatedly dispatch the ready node that finishes earliest, ties to the
  node with the most downstream work. Reorders serialization edges to
  shorten the DAG's modeled critical path (remainder chunks really are
  bigger, so order matters on staged paths).
* ``overlap`` — list scheduling over the resource-lane makespan model
  (:func:`repro_torch.core.pipelining.lane_intervals_s`): link-exclusive
  transfer lanes plus one SPMD compute lane, copies issued as early as
  their deps allow so they run *behind* compute on the modeled
  timeline. Falls back to the input order whenever its greedy order
  does not model strictly faster (list-scheduling anomaly guard), so
  ``overlap(g)`` never models worse than ``g``.
* ``auto`` — scores every candidate order with
  :func:`~repro_torch.core.pipelining.scheduled_time_s` and picks the winner
  before compiling; ties (and any tie with the baseline) resolve to
  ``round_robin``, so ``auto`` never selects a schedule the model scores
  worse than ``round_robin``. Candidate scores are memoized on
  ``(graph digest, topology epoch)`` — the same keying the engine's
  schedule memo uses — surfaced as the ``schedule_scores`` stat.
"""

from __future__ import annotations

import dataclasses
import heapq
from collections import OrderedDict
from typing import Iterable, Protocol, Sequence, runtime_checkable

from repro_torch.comm.config import SCHEDULE_NAMES
from repro_torch.comm.graph import ComputeNode, DepEdge, TransferGraph
from repro_torch.core.topology import Topology


@runtime_checkable
class GraphPass(Protocol):
    """Protocol for a transfer-graph pass: a named pure rewrite.

    Implementations must honor the §2.2 pass contract (module docstring):
    preserve the node multiset and edge set — the §4.5 invariants ride on
    them — keep index order topologically valid, and return a graph whose
    ``digest()`` reflects the new dispatch order. ``__call__`` must be
    deterministic (same input graph → same output graph) or compiled-plan
    cache keys would churn.
    """

    name: str

    def __call__(self, graph: TransferGraph) -> TransferGraph:
        ...


def _node_id(node) -> tuple:
    """Content identity of a node — what a non-rewriting pass may never
    change. Type-tagged so heterogeneous node kinds cannot collide."""
    return (type(node).__name__,) + dataclasses.astuple(node)


def reindex(graph: TransferGraph, order: Sequence[int]) -> TransferGraph:
    """Rebuild ``graph`` with nodes renumbered into dispatch order
    ``order`` (``order[k]`` = old index of the node dispatched k-th).

    The §2.2 mechanical core every scheduler shares: nodes are permuted,
    stored edges are endpoint-remapped and canonically sorted (edge
    storage order is not semantic — ``digest()`` sorts it anyway), and
    the result is returned unchanged (same object, same digest) when
    ``order`` is the identity. Raises ``ValueError`` if ``order`` is not
    a permutation or breaks topological validity (a stored edge would
    point backward) — such an order is not a schedule of this DAG.
    """
    n = graph.num_nodes
    if sorted(order) != list(range(n)):
        raise ValueError("order is not a permutation of node indices")
    if list(order) == list(range(n)):
        return graph
    old_to_new = {old: new for new, old in enumerate(order)}
    nodes = tuple(graph.nodes[old] for old in order)
    for e in graph.edges:
        src, dst = old_to_new[e.src], old_to_new[e.dst]
        if src >= dst:
            raise ValueError(
                f"schedule violates dependency {e.kind} edge "
                f"{e.src}->{e.dst}: dispatch order must stay topological")
    edges = tuple(sorted(
        (DepEdge(old_to_new[e.src], old_to_new[e.dst], e.kind)
         for e in graph.edges),
        key=lambda e: (e.src, e.dst, e.kind)))
    return TransferGraph(nodes, edges, graph.window, graph.num_messages,
                         graph.topology_name, graph.messages)


def check_pass(before: TransferGraph, after: TransferGraph,
               *, allows_rewrite: bool = False) -> None:
    """Assert the §2.2 pass contract between a pass's input and output.

    Raises ``ValueError`` if the pass changed anything beyond dispatch
    order: node multiset (byte cover / hop chains / chunking), the edge
    set (by node content), graph metadata, or topological validity of the
    index order. Also re-runs the §4.5 graph invariants
    (:meth:`TransferGraph.validate`) on the output.
    ``apply_schedule`` calls this after every pass; pass authors get it
    for free in tests via the hypothesis property suite.

    ``allows_rewrite=True`` is the §2.2 capability flag: the node-multiset
    and edge-set freezes are waived for passes that declare node
    *rewrites* (e.g. host-staged pricing), while metadata, forward-edge
    topology, and the §4.5 validation still apply.
    """
    if (after.window != before.window
            or after.num_messages != before.num_messages
            or after.topology_name != before.topology_name):
        raise ValueError("pass changed graph metadata "
                         "(window/num_messages/topology)")
    if not allows_rewrite:
        if after.messages != before.messages:
            raise ValueError(
                "pass changed the buffer messages table — def-use "
                "semantics are fixed by the §2.2 contract")
        if sorted(map(_node_id, after.nodes)) != sorted(map(
                _node_id, before.nodes)):
            raise ValueError(
                "pass changed the node multiset — byte cover and hop "
                "chains are fixed by the §2.2 contract; only dispatch "
                "order is free (declare allows_rewrite to opt out)")
        def edge_set(g: TransferGraph) -> set:
            return {(_node_id(g.nodes[e.src]), _node_id(g.nodes[e.dst]),
                     e.kind) for e in g.edges}
        if edge_set(after) != edge_set(before):
            raise ValueError(
                "pass changed the dependency-edge set — passes may only "
                "renumber edge endpoints (declare allows_rewrite to opt "
                "out)")
    for e in after.edges:
        if e.src >= e.dst:
            raise ValueError("pass broke topological index order "
                             f"({e.kind} edge {e.src}->{e.dst})")
    # §4.5 on the scheduled graph itself. Cross-flow exclusivity is a
    # planner-level property (the shared fallback trades it away on
    # purpose), so the scheduled graph is held to the same per-message
    # standard the lowering was.
    after.validate(cross_flow_exclusive=False)


def _constrained_order(graph: TransferGraph, key) -> list[int]:
    """Min-key Kahn's algorithm: dispatch the ready node with the
    smallest ``key(node, index)``.

    On a pure-comm lowering whose sort order is already topological
    (both shipped sort keys are monotone along hop/window edges) this
    yields exactly the globally sorted order, so ``round_robin`` stays
    the identity on a fresh lowering. On heterogeneous graphs the buffer
    edges gate compute nodes behind their operands while ready copies
    keep flowing — the compute-aware interleave.
    """
    n = graph.num_nodes
    succs: dict[int, list[int]] = {}
    indeg = [0] * n
    for e in graph.edges:
        succs.setdefault(e.src, []).append(e.dst)
        indeg[e.dst] += 1
    ready = [(key(graph.nodes[i], i), i)
             for i in range(n) if indeg[i] == 0]
    heapq.heapify(ready)
    order: list[int] = []
    while ready:
        _, i = heapq.heappop(ready)
        order.append(i)
        for j in succs.get(i, ()):
            indeg[j] -= 1
            if indeg[j] == 0:
                heapq.heappush(ready, (key(graph.nodes[j], j), j))
    if len(order) != n:
        raise ValueError("dependency cycle in transfer graph")
    return order


def _rr_key(n, i: int) -> tuple:
    """Round-robin priority: chunk waves across paths; ready copies
    dispatch before ready computes (class marker 0 < 1) so copies slot
    into compute gaps — part of the §2.2 compute-aware contract."""
    if isinstance(n, ComputeNode):
        return (n.window, 1, i, 0, 0, 0)
    return (n.window, 0, n.msg_idx, n.chunk_idx, n.path_idx, n.hop_idx)


def _serialization_slot(nd) -> tuple:
    """The resource a node serializes on: its per-link slot for copies,
    the one shared compute stream for kernels (mirrors
    :meth:`TransferGraph.serialization_edges` — the two must agree or
    the greedy would optimize a different objective than the validator
    derives)."""
    if isinstance(nd, ComputeNode):
        return ("compute",)
    return (nd.msg_idx, nd.path_idx, nd.window, nd.hop_idx)


def _lane_key(nd) -> tuple:
    """The resource lane a node occupies in the lane makespan model: its
    directional link for copies (link-exclusive transfer engine), the
    shared SPMD compute lane for kernels (mirrors
    :func:`repro_torch.core.pipelining.lane_intervals_s` — the ``overlap``
    greedy and the ``auto`` scorer must price the same objective)."""
    if isinstance(nd, ComputeNode):
        return ("compute",)
    return ("link",) + tuple(nd.link)


def _df_key(n, i: int) -> tuple:
    """Depth-first priority: drain each path's chunk chain; compute
    nodes follow ready copies in original index order (same §2.2
    compute-aware rule as :func:`_rr_key`)."""
    if isinstance(n, ComputeNode):
        return (n.window, 1, i, 0, 0, 0)
    return (n.window, 0, n.msg_idx, n.path_idx, n.chunk_idx, n.hop_idx)


class RoundRobinSchedule:
    """The paper's Algorithm 1 dispatch order — chunk waves interleaved
    across paths — which is exactly the lowering's emission order.

    Identity on a fresh lowering (same graph object, same digest): this
    pass exists so the ordering is *owned by the pipeline* rather than
    baked into the emitter, and so other passes have a baseline to be
    scored against. Compute-aware on heterogeneous graphs: ready copies
    dispatch before ready compute nodes, which serialize in program
    order. Preserves every §4.5 invariant trivially.
    """

    name = "round_robin"

    def __call__(self, graph: TransferGraph) -> TransferGraph:
        """Renumber into round-robin order (identity on a fresh
        pure-comm lowering — same object, same digest; §2.2)."""
        return reindex(graph, _constrained_order(graph, _rr_key))


class DepthFirstSchedule:
    """Drain each path's entire chunk chain before switching paths.

    Minimizes per-link switchover (each directional link is serviced in
    one contiguous burst per window round) at the cost of starting path
    *k* only after all of path *k−1*'s copies have been issued — the
    modeled issue chain prices that delay, which is why ``auto`` rarely
    picks it on multi-path plans. Compute-aware like ``round_robin``.
    Preserves the §4.5 invariants: only node indices (and thus
    serialization-edge order) change.
    """

    name = "depth_first"

    def __call__(self, graph: TransferGraph) -> TransferGraph:
        """Renumber into depth-first order under the stored-edge
        constraints (§2.2: content untouched, digest reflects order)."""
        return reindex(graph, _constrained_order(graph, _df_key))


class CriticalPathSchedule:
    """Greedy list scheduling: dispatch the ready node that finishes
    earliest under the §4.4 weighted model, ties to the most downstream
    work (longest-remaining-chain first).

    Reorders serialization edges — the only §2.2 freedom — to shorten
    the scheduled DAG's modeled critical path
    (:func:`repro_torch.core.pipelining.scheduled_time_s`): e.g. a remainder
    chunk on a staged path is dispatched where its extra bytes overlap
    other paths' steady state instead of tailing the pipeline.
    Construct with the :class:`~repro_torch.core.topology.Topology` to weight
    nodes by contended link bandwidth; without one, weights fall back to
    raw chunk bytes (uniform links). Deterministic; preserves the node
    multiset, edge set, and §4.5 invariants (enforced by ``check_pass``).
    """

    name = "critical_path"

    def __init__(self, topology: Topology | None = None):
        self.topology = topology

    def _weights(self, graph: TransferGraph) -> tuple[list[float], float]:
        """(per-node seconds, per-issue-slot seconds) — the §4.4 model.

        With a topology this is exactly
        :func:`repro_torch.core.pipelining.graph_node_weights_s` plus the
        compiled per-node launch cost, so the greedy optimizes the same
        objective :func:`~repro_torch.core.pipelining.scheduled_time_s` (the
        ``auto`` arbiter) scores it on — and when the topology carries a
        live calibration profile (DESIGN §4.4c) both terms are the
        *fitted* ones: bandwidths via the topology's calibrated link
        overlay, the issue slot via
        :func:`~repro_torch.core.pipelining.launch_model_for`. Without a
        topology, weights degrade to raw chunk bytes on uniform links
        (compute nodes to their declared cost) and the issue term
        vanishes — invariants are preserved either way, only the
        heuristic's objective coarsens.
        """
        if self.topology is not None:
            from repro_torch.core.pipelining import (graph_node_weights_s,
                                               launch_model_for)
            launch = launch_model_for(self.topology)
            return (graph_node_weights_s(graph, self.topology),
                    launch.graph_launch_per_node_ns / 1e9)
        return [float(n.cost_ns or n.flops)
                if isinstance(n, ComputeNode) else float(n.nbytes)
                for n in graph.nodes], 0.0

    def __call__(self, graph: TransferGraph) -> TransferGraph:
        n = graph.num_nodes
        if n == 0:
            return graph
        weight, issue_s = self._weights(graph)
        succs: dict[int, list[int]] = {}
        indeg = [0] * n
        for e in graph.edges:
            succs.setdefault(e.src, []).append(e.dst)
            indeg[e.dst] += 1
        # downstream work along stored edges (each node has at most one
        # hop successor and one window successor), for tie-breaking
        down = list(weight)
        for i in reversed(graph.topological_order()):
            for j in succs.get(i, ()):
                down[i] = max(down[i], weight[i] + down[j])
        canonical = {
            i: ((nd.window, 1, i, 0, 0, 0)
                if isinstance(nd, ComputeNode) else
                (nd.window, 0, nd.msg_idx, nd.chunk_idx, nd.path_idx,
                 nd.hop_idx))
            for i, nd in enumerate(graph.nodes)}
        slot_free: dict[tuple, float] = {}   # per-link serialization slot
        finish: dict[int, float] = {}
        preds: dict[int, list[int]] = {}
        for e in graph.edges:
            preds.setdefault(e.dst, []).append(e.src)
        ready = {i for i in range(n) if indeg[i] == 0}
        order: list[int] = []
        while ready:
            k = len(order)
            best, best_key = None, None
            for i in ready:
                nd = graph.nodes[i]
                slot = _serialization_slot(nd)
                start = max((finish[p] for p in preds.get(i, ())),
                            default=0.0)
                start = max(start, slot_free.get(slot, 0.0), k * issue_s)
                key = (start + weight[i], -down[i], canonical[i])
                if best_key is None or key < best_key:
                    best, best_key = i, key
            i = best
            nd = graph.nodes[i]
            slot = _serialization_slot(nd)
            start = max((finish[p] for p in preds.get(i, ())), default=0.0)
            start = max(start, slot_free.get(slot, 0.0), k * issue_s)
            finish[i] = slot_free[slot] = start + weight[i]
            order.append(i)
            ready.remove(i)
            for j in succs.get(i, ()):
                indeg[j] -= 1
                if indeg[j] == 0:
                    ready.add(j)
        return reindex(graph, order)


class OverlapSchedule(CriticalPathSchedule):
    """List scheduling over the resource-lane makespan model: hide
    copies behind compute (§2.2 reorder-only pass, no ``allows_rewrite``).

    Simulates the lane model of
    :func:`repro_torch.core.pipelining.lane_intervals_s` — each directional
    link an exclusive FIFO transfer lane, all kernels one SPMD compute
    lane, per-node launch cost charged to the executing lane — and
    repeatedly dispatches the ready node with the earliest feasible
    start (ties to earliest finish, then most downstream work). Copies
    whose deps are satisfied are therefore issued *before* later compute
    and make progress behind it on the modeled timeline. If the greedy
    order does not model strictly faster than the input order (list-
    scheduling anomalies are real), the input order is returned
    unchanged — ``overlap`` never models worse than its input, which is
    what keeps ``auto`` never-worse-than-``round_robin`` under the lane
    objective. Deterministic; preserves the node multiset, edge set, and
    §4.5 invariants (enforced by ``check_pass``). Construct with a
    :class:`~repro_torch.core.topology.Topology` for §4.4-priced (and
    calibrated, §4.4c/§4.4d) durations; without one, weights degrade to
    raw bytes / declared compute cost.
    """

    name = "overlap"

    def _lane_makespan(self, graph: TransferGraph, order: Sequence[int],
                       weight: Sequence[float], issue_s: float,
                       preds: dict[int, list[int]]) -> float:
        """Lane-model makespan of dispatching ``graph`` in ``order``
        (must be topological); mirrors
        :func:`repro_torch.core.pipelining.lane_intervals_s` so the pass
        optimizes exactly the objective ``auto`` scores it on."""
        lane_free: dict[tuple, float] = {}
        finish: dict[int, float] = {}
        makespan = 0.0
        for old in order:
            lane = _lane_key(graph.nodes[old])
            start = max((finish[p] for p in preds.get(old, ())),
                        default=0.0)
            start = max(start, lane_free.get(lane, 0.0))
            finish[old] = lane_free[lane] = start + weight[old] + issue_s
            makespan = max(makespan, finish[old])
        return makespan

    def __call__(self, graph: TransferGraph) -> TransferGraph:
        """Renumber into the greedy lane-model order when it models
        strictly faster; identity otherwise (§2.2 contract either way)."""
        n = graph.num_nodes
        if n == 0:
            return graph
        weight, issue_s = self._weights(graph)
        succs: dict[int, list[int]] = {}
        indeg = [0] * n
        preds: dict[int, list[int]] = {}
        for e in graph.edges:
            succs.setdefault(e.src, []).append(e.dst)
            preds.setdefault(e.dst, []).append(e.src)
            indeg[e.dst] += 1
        down = list(weight)
        for i in reversed(graph.topological_order()):
            for j in succs.get(i, ()):
                down[i] = max(down[i], weight[i] + down[j])
        canonical = {
            i: ((nd.window, 1, i, 0, 0, 0)
                if isinstance(nd, ComputeNode) else
                (nd.window, 0, nd.msg_idx, nd.chunk_idx, nd.path_idx,
                 nd.hop_idx))
            for i, nd in enumerate(graph.nodes)}
        lane_free: dict[tuple, float] = {}
        finish: dict[int, float] = {}
        ready = {i for i in range(n) if indeg[i] == 0}
        order: list[int] = []
        while ready:
            best, best_key = None, None
            for i in ready:
                start = max((finish[p] for p in preds.get(i, ())),
                            default=0.0)
                start = max(start,
                            lane_free.get(_lane_key(graph.nodes[i]), 0.0))
                key = (start, start + weight[i], -down[i], canonical[i])
                if best_key is None or key < best_key:
                    best, best_key = i, key
            i = best
            lane = _lane_key(graph.nodes[i])
            start = max((finish[p] for p in preds.get(i, ())), default=0.0)
            start = max(start, lane_free.get(lane, 0.0))
            finish[i] = lane_free[lane] = start + weight[i] + issue_s
            order.append(i)
            ready.remove(i)
            for j in succs.get(i, ()):
                indeg[j] -= 1
                if indeg[j] == 0:
                    ready.add(j)
        greedy = self._lane_makespan(graph, order, weight, issue_s, preds)
        identity = self._lane_makespan(graph, range(n), weight, issue_s,
                                       preds)
        if greedy >= identity:          # anomaly guard: never model worse
            return graph
        return reindex(graph, order)


class AutoSchedule:
    """Score every candidate dispatch order with the scheduled-DAG model
    and pick the winner BEFORE compiling.

    Candidates are the shipped concrete schedulers (``round_robin``
    first, ``overlap`` last); :func:`repro_torch.core.pipelining.scheduled_time_s`
    arbitrates — the serialized chain on pure-comm graphs, the lane
    makespan on heterogeneous ones — and a strict improvement is
    required to displace an earlier candidate, so ``auto`` can never
    select a schedule the model scores worse than ``round_robin``.
    Requires a :class:`~repro_torch.core.topology.Topology` (the model needs
    link bandwidths). The §4.5 invariants hold because every candidate
    is a contract-checked pass output. Candidate scores are memoized on
    ``(graph digest, topology epoch)`` — any topology mutation or
    calibration (re)attachment bumps the epoch and re-scores — with
    hit/miss counters surfaced via :meth:`score_stats` (the engine's
    ``schedule_scores`` stat).
    """

    name = "auto"

    #: Class-level score memo shared by every instance (mirrors the
    #: engine's schedule memo keying); bounded LRU.
    _memo: OrderedDict = OrderedDict()
    _memo_capacity = 256
    _stats = {"hits": 0, "misses": 0}

    def __init__(self, topology: Topology):
        self.topology = topology
        self.candidates: tuple[GraphPass, ...] = (
            RoundRobinSchedule(), DepthFirstSchedule(),
            CriticalPathSchedule(topology), OverlapSchedule(topology))

    @classmethod
    def score_stats(cls, reset: bool = False) -> dict[str, int]:
        """Hit/miss counters of the candidate-score memo (the
        ``schedule_scores`` stat); measurements only — never feed cache
        keys. ``reset=True`` zeroes them after reading."""
        out = dict(cls._stats)
        if reset:
            cls._stats.update(hits=0, misses=0)
        return out

    def select(self, graph: TransferGraph
               ) -> tuple[str, TransferGraph, dict[str, float]]:
        """(winner name, scheduled graph, per-candidate modeled seconds).

        Memoized on ``(graph.digest(), topology.epoch)`` — re-scoring
        every candidate on every miss is pure waste when neither the
        graph content nor the model terms changed."""
        from repro_torch.core.pipelining import scheduled_time_s

        epoch = getattr(self.topology, "epoch", None)
        key = (graph.digest(), epoch) if epoch is not None else None
        if key is not None:
            hit = AutoSchedule._memo.get(key)
            if hit is not None:
                AutoSchedule._memo.move_to_end(key)
                AutoSchedule._stats["hits"] += 1
                return hit
            AutoSchedule._stats["misses"] += 1
        scores: dict[str, float] = {}
        best_name, best_graph, best_t = None, None, float("inf")
        for cand in self.candidates:
            scheduled = cand(graph)
            check_pass(graph, scheduled)
            t = scheduled_time_s(scheduled, self.topology)
            scores[cand.name] = t
            if t < best_t:                      # strict: ties keep earlier
                best_name, best_graph, best_t = cand.name, scheduled, t
        assert best_graph is not None
        result = (best_name, best_graph, scores)
        if key is not None:
            AutoSchedule._memo[key] = result
            while len(AutoSchedule._memo) > AutoSchedule._memo_capacity:
                AutoSchedule._memo.popitem(last=False)
        return result

    def __call__(self, graph: TransferGraph) -> TransferGraph:
        """Apply the winning candidate (see :meth:`select`); the result
        is a contract-checked §2.2 pass output."""
        return self.select(graph)[1]


def make_schedule(name: str, topology: Topology | None = None) -> GraphPass:
    """Resolve a scheduler name from :data:`SCHEDULE_NAMES` to a pass.

    ``topology`` feeds the model-weighted passes (``critical_path``
    weights, ``auto`` scoring) and is required for ``auto``. The returned
    object satisfies :class:`GraphPass` and the §2.2 contract.
    """
    if name == RoundRobinSchedule.name:
        return RoundRobinSchedule()
    if name == DepthFirstSchedule.name:
        return DepthFirstSchedule()
    if name == CriticalPathSchedule.name:
        return CriticalPathSchedule(topology)
    if name == OverlapSchedule.name:
        return OverlapSchedule(topology)
    if name == AutoSchedule.name:
        if topology is None:
            raise ValueError("schedule 'auto' needs a topology to score "
                             "candidate orders")
        return AutoSchedule(topology)
    raise ValueError(f"unknown schedule {name!r}; expected one of "
                     f"{SCHEDULE_NAMES}")


def apply_schedule(graph: TransferGraph,
                   schedule: str | GraphPass = "round_robin",
                   topology: Topology | None = None
                   ) -> tuple[TransferGraph, str]:
    """Apply one scheduler between ``lower()`` and the emitter.

    The ONE entry point the engine, ``session.describe``, the dry-run,
    and the benchmarks share: resolves ``schedule`` (name or pass
    object), applies it, enforces the §2.2 contract (:func:`check_pass`)
    so §4.5 invariants and digest semantics cannot be silently broken,
    and returns ``(scheduled graph, concrete schedule name)`` — for
    ``auto`` the name of the candidate the model actually picked. A pass
    declaring the ``allows_rewrite`` capability is checked under the
    relaxed contract (node rewrites allowed, §4.5 still enforced).
    """
    sched = (make_schedule(schedule, topology)
             if isinstance(schedule, str) else schedule)
    if isinstance(sched, AutoSchedule):
        name, scheduled, _ = sched.select(graph)   # candidates pre-checked
        return scheduled, name
    scheduled = sched(graph)
    if scheduled is not graph:     # identity (e.g. default round_robin on
        check_pass(graph, scheduled,  # a fresh lowering) is a provable no-op
                   allows_rewrite=bool(getattr(sched, "allows_rewrite",
                                               False)))
    return scheduled, sched.name


def run_pipeline(graph: TransferGraph,
                 passes: Iterable[str | GraphPass],
                 topology: Topology | None = None) -> TransferGraph:
    """Run a sequence of passes, contract-checked after each stage.

    The general pass-pipeline hook (future passes — e.g. the host-staged
    pricing rewrite on the ROADMAP — chain here ahead of a scheduler);
    every stage is held to the §2.2 contract via :func:`apply_schedule`,
    so invariants are re-validated and the final digest reflects the
    composed schedule.
    """
    for p in passes:
        graph, _ = apply_schedule(graph, p, topology)
    return graph
