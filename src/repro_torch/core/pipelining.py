"""2-D pipelining engine: chunk schedules + the analytic pipeline-time model.

The engine performs the paper's two splits (§4.3):

* **horizontal** — the message is partitioned across the selected paths
  (done by the :class:`~repro_torch.comm.planner.PathPlanner` via its
  :class:`~repro_torch.comm.policy.PathPolicy`, shares ∝ bandwidth),
* **vertical** — each path's share is split into chunks that flow through the
  path's hops in a pipelined fashion (hop-2 of chunk *i* overlaps hop-1 of
  chunk *i+1*).

As of the transfer-graph IR (DESIGN.md §2.1), everything in this module is
a *view over* or an *evaluation of* the :class:`~repro_torch.comm.graph.\
TransferGraph` produced by the single lowering pass
:func:`repro_torch.comm.graph.lower` — the same copy-node DAG the executable
engine walks:

* :func:`build_schedule` flattens graph nodes into dispatch-ordered
  :class:`ChunkTask` views,
* :func:`validate_plan` / :func:`validate_group` are the §4.5 invariants
  checked on graph nodes/edges (:meth:`TransferGraph.validate`),
* :func:`wire_time_s` / :func:`estimate_transfer_time_s` /
  :func:`estimate_group_time_s` evaluate the **critical path** of the DAG
  (hop edges + per-link serialization edges), and the launch-overhead
  model prices per-node launch cost × graph node count,
* :func:`scheduled_time_s` is the schedule-*aware* variant: an exact
  weighted longest path over a (possibly pass-reordered) graph, the
  arbiter the ``auto`` scheduler in :mod:`repro_torch.comm.passes` uses to
  pick a dispatch order before compiling (DESIGN.md §2.2).

The time model is analytic (its constants are model parameters, not
measurements of any card); it captures exactly the effects the
paper measures: pipelined staged hops (fill + steady-state),
per-directional-link exclusivity (§4.5) and host-node capacity contention
(the paper's "host path hurts BIBW" finding), and per-copy-node launch
overhead vs amortized compiled-plan (CUDA Graph) launch overhead including
first-iteration construction costs (paper Fig. 13/14).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import TYPE_CHECKING, Sequence

from repro_torch.core.topology import HOST, Topology

if TYPE_CHECKING:  # pragma: no cover - typing only (avoids an import cycle)
    from repro_torch.comm.graph import TransferGraph
    from repro_torch.comm.plan import TransferGroup, TransferPlan


@dataclasses.dataclass(frozen=True)
class ChunkTask:
    """One chunk flowing along one route — ``num_hops`` copy nodes.

    A thin dispatch-ordered *view* over the transfer graph: ``hops`` is
    the chunk's copy-node chain collapsed into its link sequence.
    """

    path_idx: int
    chunk_idx: int
    offset: int
    nbytes: int
    hops: tuple[tuple[int, int], ...]  # directional links, in order


# -- launch-overhead calibration (model constants; the lifecycle benchmark
# would measure them) ---------------------------------------------------
LAUNCH_NS_PER_NODE = 6_000          # one async-copy launch (no graphs)
GRAPH_LAUNCH_BASE_NS = 7_000        # cudaGraphLaunch fixed cost analogue
GRAPH_LAUNCH_PER_NODE_NS = 300      # marginal per-node launch cost in a graph
GRAPH_INSTANTIATE_BASE_NS = 90_000  # one-time instantiation (first iter)
GRAPH_INSTANTIATE_PER_NODE_NS = 85_000
SYNC_NS_PER_PATH = 2_000            # event record + stream-wait per path
COMPUTE_GFLOPS = 50.0               # declared-FLOP pricing rate for
                                    # ComputeNodes without a measured cost
INTER_NODE_LATENCY_NS = 1_500       # per-chunk hop latency on inter-node
                                    # links (RDMA/DCN tier, DESIGN §3.1)


def compute_time_s(node, topo: "Topology | None" = None) -> float:
    """Modeled seconds for one :class:`~repro_torch.comm.graph.ComputeNode`.

    Pricing precedence (DESIGN §4.4d): a *fitted* per-kernel term from
    the topology's live calibration profile wins (keyed by the node's
    ``kernel`` name — measured execute aggregation, see
    ``TimelineRecorder.record_kernel``), then a stamped ``cost_ns``,
    then declared ``flops`` at the nominal :data:`COMPUTE_GFLOPS` rate.
    Shared by the critical-path weights, the lane simulation, and the
    scheduled-DAG arbiter so ``auto`` stays honest about compute.
    """
    prof = getattr(topo, "calibration", None)
    fitted = getattr(prof, "kernel_cost_ns", None)
    if fitted:
        ns = fitted.get(node.kernel)
        if ns:
            return ns / 1e9
    if node.cost_ns:
        return node.cost_ns / 1e9
    return node.flops / (COMPUTE_GFLOPS * 1e9)


@dataclasses.dataclass(frozen=True)
class LaunchModel:
    """The §4.4 launch-overhead terms as one swappable value.

    Defaults are the module's nominal constants; a fitted instance comes
    from :class:`repro_torch.comm.calibration.CalibrationProfile` and reaches
    every estimator through :func:`launch_model_for` (DESIGN §4.4c) —
    the model never reads the bare constants once a profile is live.
    """

    launch_ns_per_node: float = LAUNCH_NS_PER_NODE
    graph_launch_base_ns: float = GRAPH_LAUNCH_BASE_NS
    graph_launch_per_node_ns: float = GRAPH_LAUNCH_PER_NODE_NS
    graph_instantiate_base_ns: float = GRAPH_INSTANTIATE_BASE_NS
    graph_instantiate_per_node_ns: float = GRAPH_INSTANTIATE_PER_NODE_NS
    sync_ns_per_path: float = SYNC_NS_PER_PATH


#: The nominal (uncalibrated) launch model — exactly the constants above.
DEFAULT_LAUNCH_MODEL = LaunchModel()


def launch_model_for(topo: Topology | None) -> LaunchModel:
    """Resolve the launch model in force for ``topo``.

    Returns the fitted :class:`LaunchModel` of the topology's live
    calibration profile when one is attached (and carries launch terms),
    else :data:`DEFAULT_LAUNCH_MODEL`. Accepts ``None`` so legacy
    call sites that never knew about calibration keep their exact
    constant-based behaviour.
    """
    prof = getattr(topo, "calibration", None)
    fitted = getattr(prof, "launch", None)
    return fitted if fitted is not None else DEFAULT_LAUNCH_MODEL


def _calibrated_bw(bw: dict[tuple[int, int], float],
                   topo: Topology | None) -> dict[tuple[int, int], float]:
    """Overlay fitted per-link bandwidths onto a plan-embedded map.

    Plans embed the nominal ``Link`` objects that existed when they were
    planned; when ``topo`` carries a live calibration profile the model
    must price measured bandwidths instead, so each entry is re-read
    through :meth:`Topology.link` (which serves the calibrated shadow).
    No-op without a profile.
    """
    if getattr(topo, "calibration", None) is None:
        return bw
    out = dict(bw)
    for key in out:
        link = topo.link(*key)
        if link is not None:
            out[key] = link.bandwidth_gbps
    return out


def _lower(obj, window: int = 1) -> "TransferGraph":
    # Local import: repro_torch.core must stay importable without repro_torch.comm
    # (the comm package itself imports core.topology).
    from repro_torch.comm.graph import lower
    return lower(obj, window)


def _as_group(group: "TransferGroup | Sequence[TransferPlan]"
              ) -> "TransferGroup":
    from repro_torch.comm.plan import TransferGroup
    if isinstance(group, TransferGroup):
        return group
    plans = tuple(group)
    name = plans[0].topology_name if plans else ""
    return TransferGroup(plans, name)


def build_schedule(plan: TransferPlan) -> list[ChunkTask]:
    """Flatten the plan's transfer graph into chunk tasks, round-robin
    across paths.

    The paper distributes chunks across paths one-by-one (Alg. 1 note); the
    round-robin order is the dispatch order — data dependencies (hop order
    within a chunk, §4.5) are carried in each task's ``hops``, which is the
    chunk's copy-node chain from the graph.
    """
    graph = _lower(plan)
    chains: dict[tuple[int, int], list] = {}
    for node in graph.nodes:
        chains.setdefault((node.path_idx, node.chunk_idx), []).append(node)
    per_path: dict[int, list[ChunkTask]] = defaultdict(list)
    for (p_idx, c_idx) in sorted(chains):
        nodes = sorted(chains[(p_idx, c_idx)], key=lambda n: n.hop_idx)
        per_path[p_idx].append(ChunkTask(
            p_idx, c_idx, nodes[0].offset, nodes[0].nbytes,
            tuple(n.link for n in nodes)))
    schedule: list[ChunkTask] = []
    paths = [per_path[p] for p in sorted(per_path)]
    for wave in range(max((len(t) for t in paths), default=0)):
        for tasks in paths:
            if wave < len(tasks):
                schedule.append(tasks[wave])
    return schedule


def validate_plan(plan: TransferPlan) -> None:
    """Assert the §4.5 integrity invariants. Raises ``ValueError`` on breach.

    Checked on the plan's transfer graph (:meth:`TransferGraph.validate`):

    1. chunk byte ranges are disjoint and exactly cover ``[0, nbytes)``,
    2. no two paths share a directional link (contention avoidance),
    3. every staged route's hops are connected (src → via → dst).
    """
    _lower(plan).validate({0: plan.nbytes})


def validate_group(group: "TransferGroup | Sequence[TransferPlan]") -> None:
    """Assert the group-level §4.5 invariants. Raises ``ValueError``.

    Checked on the fused group's transfer graph:

    1. every message individually satisfies :func:`validate_plan`
       (disjoint cover of its own message, within-plan link exclusivity),
    2. **cross-flow link exclusivity** — no directional link is used by
       plans of two *distinct* flows (src, dst). Plans of the same flow
       (e.g. the leaves of one pytree migration) legitimately share that
       flow's routes and are exempt.
    """
    g = _as_group(group)
    _lower(g).validate({i: p.nbytes for i, p in enumerate(g.plans)})


def _launch_overhead_from_counts(num_nodes: int, num_paths: int, *,
                                 compiled_plan: bool,
                                 first_iteration: bool = False,
                                 launch: LaunchModel = DEFAULT_LAUNCH_MODEL
                                 ) -> float:
    if not compiled_plan:
        return (num_nodes * launch.launch_ns_per_node
                + num_paths * launch.sync_ns_per_path)
    cost = (launch.graph_launch_base_ns
            + num_nodes * launch.graph_launch_per_node_ns)
    if first_iteration:
        cost += (launch.graph_instantiate_base_ns
                 + num_nodes * launch.graph_instantiate_per_node_ns)
    return float(cost)


def launch_overhead_ns(plan: TransferPlan, *, compiled_plan: bool,
                       first_iteration: bool = False,
                       topo: Topology | None = None) -> float:
    """CPU-side overhead for dispatching the plan once (paper §5.5):
    per-node launch cost × graph node count. Pass ``topo`` to price the
    fitted :class:`LaunchModel` of its live calibration profile."""
    return _launch_overhead_from_counts(
        _lower(plan).num_nodes, len(plan.paths),
        compiled_plan=compiled_plan, first_iteration=first_iteration,
        launch=launch_model_for(topo))


def group_launch_overhead_ns(plans: Sequence[TransferPlan], *,
                             compiled_plan: bool,
                             first_iteration: bool = False,
                             fused: bool = True,
                             topo: Topology | None = None) -> float:
    """CPU-side overhead for a transfer group.

    ``fused=True`` models the group as ONE graph launch (the fused SPMD
    program the engine compiles): a single base launch cost amortized over
    the fused graph's node count, and one instantiation on the first
    iteration. ``fused=False`` models the legacy dispatch loop — one
    launch (and one first-iteration instantiation) per message. ``topo``
    selects the fitted launch model as in :func:`launch_overhead_ns`.
    """
    if fused:
        return _launch_overhead_from_counts(
            _lower(_as_group(plans)).num_nodes,
            sum(len(p.paths) for p in plans),
            compiled_plan=compiled_plan, first_iteration=first_iteration,
            launch=launch_model_for(topo))
    return sum(launch_overhead_ns(p, compiled_plan=compiled_plan,
                                  first_iteration=first_iteration, topo=topo)
               for p in plans)


# -- critical-path evaluation over the transfer graph ------------------------

def _contention(plans: Sequence[TransferPlan]
                ) -> tuple[dict[tuple[int, int], int], int]:
    """Directional-link use counts + host-staged flow count across plans."""
    counts: dict[tuple[int, int], int] = defaultdict(int)
    host_flows = 0
    for p in plans:
        for pa in p.paths:
            for link in pa.route.directional_links():
                counts[link] += 1
            if pa.route.via == HOST:
                host_flows += 1
    return counts, host_flows


def _bandwidth_map(plans: Sequence[TransferPlan]
                   ) -> dict[tuple[int, int], float]:
    """Directional link → GB/s, from the links embedded in the plans."""
    bw: dict[tuple[int, int], float] = {}
    for p in plans:
        for pa in p.paths:
            for link in pa.route.hops:
                bw[(link.src, link.dst)] = link.bandwidth_gbps
    return bw


def _inter_latency_s(topo: Topology | None
                     ) -> "dict[tuple[int, int], float]":
    """Per-link latency surcharge for the inter-node tier (DESIGN §3.1).

    Flat topologies (one island) get an empty map — the §4.4 model is
    then bitwise-identical to the pre-hierarchy model. On hierarchical
    topologies every inter-island directional link costs an extra
    :data:`INTER_NODE_LATENCY_NS` per chunk hop, so the tuner/arbiter
    naturally prefer fewer, larger chunks across node boundaries.
    """
    if topo is None or getattr(topo, "num_islands", 1) <= 1:
        return {}
    lat = INTER_NODE_LATENCY_NS / 1e9
    return {key: lat for key in topo.links
            if topo.is_inter_island(*key)}


def _graph_message_times_s(graph: "TransferGraph",
                           bw_gbps: dict[tuple[int, int], float],
                           contention: dict[tuple[int, int], int],
                           host_flows: int,
                           latency_s: "dict[tuple[int, int], float] | None"
                           = None) -> dict[int, float]:
    """Per-message critical-path wire time over the copy-node DAG.

    The relevant DAG per (message, path) is the chunks × hops grid: hop
    edges within each chunk plus the per-link serialization edges between
    consecutive chunks (:meth:`TransferGraph.serialization_edges`). Its
    longest weighted path runs along the bottleneck link, which for the
    uniform steady-state chunk weight the model prices reduces to the
    closed form ``fill + (n_chunks − 1) · max(hop_times)`` — evaluated
    here per path directly from the graph's nodes/edges structure.

    Node weights: steady-state chunk bytes over the link's contended
    bandwidth. A directional link shared by several concurrent paths is
    time-shared; flows staging through the host additionally split the
    host's aggregate copy bandwidth (paper §5.3 obs. 6). ``latency_s``
    (from :func:`_inter_latency_s`) adds a per-chunk-hop surcharge on
    inter-node links — the tier-aware term of the hierarchical model.
    """
    # per (msg, path): hop link sequence + chunk count + total bytes,
    # read off window-0 nodes (windows replay the identical round).
    hops: dict[tuple[int, int], dict[int, tuple[int, int]]] = {}
    totals: dict[tuple[int, int], int] = defaultdict(int)
    chunks: dict[tuple[int, int], int] = defaultdict(int)
    for node in graph.nodes:
        if hasattr(node, "kernel"):   # ComputeNode: no wire time
            continue
        if node.window:
            continue
        key = (node.msg_idx, node.path_idx)
        hops.setdefault(key, {})[node.hop_idx] = node.link
        if node.hop_idx == 0:
            totals[key] += node.nbytes
            chunks[key] += 1
    times: dict[int, float] = {m: 0.0 for m in range(graph.num_messages)}
    latency_s = latency_s or {}
    for key, link_by_hop in hops.items():
        n = max(1, chunks[key])
        chunk_bytes = totals[key] / n
        hop_times = []
        for h in sorted(link_by_hop):
            link = link_by_hop[h]
            bw = bw_gbps[link] * 1e9
            share = max(1, contention.get(link, 1))
            if HOST in link and host_flows > 1:
                share = max(share, host_flows)
            hop_times.append(chunk_bytes / (bw / share)
                             + latency_s.get(link, 0.0))
        fill = sum(hop_times)                 # first chunk: all hop edges
        steady = (n - 1) * max(hop_times)     # serialization on bottleneck
        times[key[0]] = max(times[key[0]], fill + steady)
    return times


def wire_time_s(plan: TransferPlan, topo: Topology, *,
                concurrent_plans: Sequence[TransferPlan] = ()) -> float:
    """Pure wire time (no launch overhead) for one message: the critical
    path of its transfer graph.

    ``concurrent_plans`` are other transfers in flight at the same time
    (e.g. the reverse direction of a bidirectional test, or the other
    messages of a transfer group): any directional link they share with
    ``plan`` is time-shared, and host-staged flows contend on host
    capacity.
    """
    all_plans = (plan, *concurrent_plans)
    contention, host_flows = _contention(all_plans)
    times = _graph_message_times_s(
        _lower(plan), _calibrated_bw(_bandwidth_map(all_plans), topo),
        contention, host_flows, _inter_latency_s(topo))
    return times[0]


def estimate_transfer_time_s(
        plan: TransferPlan, topo: Topology, *,
        compiled_plan: bool = True,
        first_iteration: bool = False,
        concurrent_plans: Sequence[TransferPlan] = ()) -> float:
    """Analytic end-to-end time for one message under the pipeline model.

    See :func:`wire_time_s` for the ``concurrent_plans`` contention
    semantics; launch overhead is added per §5.5.
    """
    return wire_time_s(plan, topo, concurrent_plans=concurrent_plans) + (
        launch_overhead_ns(plan, compiled_plan=compiled_plan,
                           first_iteration=first_iteration, topo=topo) / 1e9)


def estimate_group_time_s(
        group: "TransferGroup | Sequence[TransferPlan]", topo: Topology, *,
        compiled_plan: bool = True,
        first_iteration: bool = False,
        fused: bool = True) -> float:
    """Analytic makespan of a set of concurrent transfers: critical-path
    evaluation over the fused group's transfer graph.

    ``fused=True`` is the transfer-group execution model: one compiled
    launch covering every message, so the makespan is a single (fused)
    launch overhead plus the DAG's critical path — the slowest message's
    wire time, each message priced with every other group member as
    concurrent traffic.

    ``fused=False`` is the legacy dispatch loop (one compiled program per
    message, launched back-to-back without blocking): the CPU serializes
    the launches, so message *i* cannot start before launches ``1..i``
    have issued, while the wires still contend. This is the baseline
    `exchange()` is measured against.
    """
    g = _as_group(group)
    plans = g.plans
    if not plans:
        return 0.0
    contention, host_flows = _contention(plans)
    times = _graph_message_times_s(
        _lower(g), _calibrated_bw(_bandwidth_map(plans), topo),
        contention, host_flows, _inter_latency_s(topo))
    wires = [times[i] for i in range(len(plans))]
    if fused:
        return max(wires) + group_launch_overhead_ns(
            plans, compiled_plan=compiled_plan,
            first_iteration=first_iteration, fused=True, topo=topo) / 1e9
    makespan, dispatched = 0.0, 0.0
    for plan, wire in zip(plans, wires):
        dispatched += launch_overhead_ns(
            plan, compiled_plan=compiled_plan,
            first_iteration=first_iteration, topo=topo) / 1e9
        makespan = max(makespan, dispatched + wire)
    return makespan


def graph_node_weights_s(graph: "TransferGraph", topo: Topology
                         ) -> list[float]:
    """Per-node copy time in seconds: actual chunk bytes over the link's
    contended bandwidth — THE §4.4 node-weight model.

    Contention is derived from the graph itself: one share per (message,
    path) using a directional link, host capacity split across
    host-staged paths — the same counting :func:`_contention` derives
    from plans. Shared by :func:`scheduled_time_s` (the arbiter) and the
    ``critical_path`` scheduler in :mod:`repro_torch.comm.passes`, so the
    greedy pass optimizes exactly the objective the ``auto`` scorer
    rates it on. Raises ``ValueError`` when a graph link is absent from
    ``topo`` (the graph and topology must agree). Heterogeneous graphs:
    compute nodes are priced by :func:`compute_time_s` (measured
    ``cost_ns`` or declared FLOPs) and use no link.
    """
    paths_on: dict[tuple[int, int], set] = defaultdict(set)
    host_paths: set = set()
    for node in graph.nodes:
        if hasattr(node, "kernel"):   # ComputeNode: uses no link
            continue
        paths_on[node.link].add((node.msg_idx, node.path_idx))
        if HOST in node.link:
            host_paths.add((node.msg_idx, node.path_idx))
    latency_s = _inter_latency_s(topo)
    weight = []
    for node in graph.nodes:
        if hasattr(node, "kernel"):
            weight.append(compute_time_s(node, topo))
            continue
        link = topo.link(*node.link)
        if link is None:
            raise ValueError(f"graph link {node.link} not in topology "
                             f"{topo.name}")
        share = max(1, len(paths_on[node.link]))
        if HOST in node.link and len(host_paths) > 1:
            share = max(share, len(host_paths))
        weight.append(node.nbytes / (link.bandwidth_gbps * 1e9 / share)
                      + latency_s.get(node.link, 0.0))
    return weight


def _graph_base_s(graph: "TransferGraph", launch: LaunchModel, *,
                  compiled_plan: bool, first_iteration: bool) -> float:
    """Fixed per-dispatch cost shared by both scheduling models."""
    n = graph.num_nodes
    if compiled_plan:
        base = launch.graph_launch_base_ns
        if first_iteration:
            base += (launch.graph_instantiate_base_ns
                     + n * launch.graph_instantiate_per_node_ns)
    else:
        num_paths = len({(nd.msg_idx, nd.path_idx) for nd in graph.nodes
                         if not hasattr(nd, "kernel")})
        base = num_paths * launch.sync_ns_per_path
    return base / 1e9


def _lane_of(node) -> tuple:
    """Resource lane a node occupies: its directional link for a copy
    (link-exclusive transfer engine), the shared SPMD compute lane for a
    kernel (every device's compute lane advances in lockstep)."""
    if hasattr(node, "kernel"):
        return ("compute",)
    return ("link",) + tuple(node.link)


def lane_intervals_s(graph: "TransferGraph", topo: Topology, *,
                     compiled_plan: bool = True
                     ) -> list[tuple[float, float]]:
    """Per-node ``(start, finish)`` seconds under the resource-lane
    simulation (no fixed base cost included).

    The lane model: each (src, dst) directional link is an exclusive
    transfer lane, all compute shares one SPMD compute lane, a node
    occupies its lane for its §4.4-priced duration plus the per-node
    launch cost, lanes drain in dispatch (node-index) order — CUDA-
    stream-style head-of-line FIFO, which is what makes *order* matter
    to a reorder-only pass — and stored hop/window/buffer edges gate
    start times. Makespan replaces the serialized issue chain.
    """
    n = graph.num_nodes
    weight = graph_node_weights_s(graph, topo)
    launch = launch_model_for(topo)
    per_node_s = (launch.graph_launch_per_node_ns if compiled_plan
                  else launch.launch_ns_per_node) / 1e9
    preds: dict[int, list[int]] = defaultdict(list)
    for e in graph.edges:
        preds[e.dst].append(e.src)
    lane_free: dict[tuple, float] = defaultdict(float)
    out: list[tuple[float, float]] = [(0.0, 0.0)] * n
    for idx in range(n):          # dispatch order IS lane-enqueue order
        lane = _lane_of(graph.nodes[idx])
        start = lane_free[lane]
        for p in preds[idx]:
            start = max(start, out[p][1])
        finish = start + weight[idx] + per_node_s
        lane_free[lane] = finish
        out[idx] = (start, finish)
    return out


def scheduled_time_s(graph: "TransferGraph", topo: Topology, *,
                     compiled_plan: bool = True,
                     first_iteration: bool = False,
                     mode: str | None = None) -> float:
    """Modeled end-to-end time of a *scheduled* transfer graph (§2.2).

    Unlike the closed-form :func:`wire_time_s` (which is schedule-blind —
    it reduces the DAG to per-path chunk counts), this is an exact
    evaluation over the scheduled DAG, which is how a chunk-interleaving
    pass becomes visible to the model. Two objectives share the entry
    point, selected by ``mode``:

    * ``"serialized"`` — the degenerate single-lane model (the historic
      objective): stored hop + window edges, the derived per-slot
      serialization edges, and a global issue chain (node *i* cannot
      start before ``i × per-node launch cost``). Pure-comm digests and
      arbitration are scored exactly as before.
    * ``"lanes"`` — the resource-lane makespan (:func:`lane_intervals_s`):
      link-exclusive transfer lanes plus one SPMD compute lane, per-node
      launch cost charged to the executing lane instead of a global
      chain, so copies on independent links make concurrent progress and
      can *hide* behind compute.
    * ``None`` (default) — dispatch on graph content: heterogeneous
      graphs (any ComputeNode) are priced by lanes, pure-comm graphs by
      the serialized chain. The default therefore *reduces* to the
      serialized chain on every pure-comm graph — numerically identical
      scores, digest-stable arbitration — which is the invariant the
      PR 5/6 acceptance gates rely on. (Explicit ``mode="lanes"`` on a
      single-path pure-comm chain differs from serialized by exactly
      ``num_nodes × per-node launch``: the lane model charges issue
      cost into lane occupancy rather than a global chain.)

    Used by the ``auto`` scheduler and ``session.describe`` to score
    candidate dispatch orders of the SAME lowering against each other;
    absolute values are comparable to :func:`estimate_transfer_time_s`
    but not identical (that closed form prices uniform chunk sizes).
    """
    n = graph.num_nodes
    if n == 0:
        return 0.0
    if mode is None:
        mode = "lanes" if graph.num_compute_nodes else "serialized"
    if mode not in ("serialized", "lanes"):
        raise ValueError(f"unknown scheduling model {mode!r}; expected "
                         "'serialized', 'lanes', or None")
    launch = launch_model_for(topo)
    base = _graph_base_s(graph, launch, compiled_plan=compiled_plan,
                         first_iteration=first_iteration)
    if mode == "lanes":
        intervals = lane_intervals_s(graph, topo,
                                     compiled_plan=compiled_plan)
        return max(f for _, f in intervals) + base
    weight = graph_node_weights_s(graph, topo)
    preds: dict[int, list[int]] = defaultdict(list)
    for e in graph.edges:
        preds[e.dst].append(e.src)
    for a, b in graph.serialization_edges():
        preds[b].append(a)
    per_node_ns = (launch.graph_launch_per_node_ns if compiled_plan
                   else launch.launch_ns_per_node)
    finish = [0.0] * n
    for idx in graph.topological_order():
        start = idx * per_node_ns / 1e9          # serialized issue chain
        for p in preds[idx]:
            start = max(start, finish[p])
        finish[idx] = start + weight[idx]
    return max(finish) + base


def hidden_copy_time_s(graph: "TransferGraph", topo: Topology, *,
                       compiled_plan: bool = True) -> float:
    """Modeled copy seconds that run *behind* compute on the lane
    timeline: Σ over copy nodes of the overlap between the copy's
    ``(start, finish)`` interval and the union of compute-lane busy
    intervals (:func:`lane_intervals_s`). Zero on pure-comm graphs.

    This is the quantity the ``overlap`` scheduler exists to maximize
    and what ``session.describe()["overlap"]`` reports.
    """
    if not graph.num_compute_nodes or not graph.num_copy_nodes:
        return 0.0
    intervals = lane_intervals_s(graph, topo, compiled_plan=compiled_plan)
    busy = sorted(iv for iv, nd in zip(intervals, graph.nodes)
                  if hasattr(nd, "kernel"))
    merged: list[list[float]] = []
    for s, f in busy:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], f)
        else:
            merged.append([s, f])
    hidden = 0.0
    for (s, f), nd in zip(intervals, graph.nodes):
        if hasattr(nd, "kernel"):
            continue
        for bs, bf in merged:
            hidden += max(0.0, min(f, bf) - max(s, bs))
    return hidden


def effective_bandwidth_gbps(plan: TransferPlan, topo: Topology, *,
                             compiled_plan: bool = True,
                             concurrent_plans: Sequence[TransferPlan] = (),
                             ) -> float:
    t = estimate_transfer_time_s(plan, topo, compiled_plan=compiled_plan,
                                 concurrent_plans=concurrent_plans)
    return plan.nbytes / t / 1e9


def windowed_bandwidth_gbps(plan: TransferPlan, topo: Topology, *,
                            window: int, compiled_plan: bool = True) -> float:
    """OMB-style windowed bandwidth: ``window`` back-to-back messages.

    Launch overheads of messages 2..W overlap the wire time of earlier
    messages (the paper's window-size effect, §5.3 obs. 3): with compiled
    plans the CPU can run ahead, so per-message cost approaches pure wire
    time; without, per-node launches serialize on the CPU.
    """
    wire = wire_time_s(plan, topo)
    launch = launch_overhead_ns(plan, compiled_plan=compiled_plan,
                                topo=topo) / 1e9
    # CPU dispatch pipeline: total = first launch + max(wire, launch)*(W-1)
    # + wire of the last message's tail.
    total = launch + window * wire if launch <= wire else (
        window * launch + wire)
    return plan.nbytes * window / total / 1e9
