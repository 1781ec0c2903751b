"""PathPlanner: route enumeration + per-message path configuration.

Implements the paper's Multi-Path Communication Handler + ``GetPathConfig``
(Algorithm 1, lines 4–11) and the offline topology tuner (§4.4):

* enumerate the direct route and all 2-hop staged routes (via idle peer
  devices, and optionally via the host),
* delegate route *selection* and share assignment to a pluggable
  :class:`~repro_torch.comm.policy.PathPolicy` (greedy bandwidth-proportional by
  default — the paper's behavior),
* split each share into pipeline chunks (vertical split — chunk count is the
  tunable the paper fixes via offline tuning; default target chunk 1 MB,
  capped at ``max_chunks``).

Configuration comes from a :class:`~repro_torch.comm.config.CommConfig`
(constructor keyword arguments override individual fields); the legacy
``REPRO_MP_*`` environment variables are honored through
``CommConfig.from_env()``, which is the default when no config is given.

Measured feedback (DESIGN §4.4c): every bandwidth the planner reads —
route enumeration via :meth:`Topology.link`, policy shares via
``Route.bottleneck_gbps``, and the §4.4 arbitration of candidate path
counts / exclusive-vs-shared groups via ``estimate_transfer_time_s`` /
``estimate_group_time_s`` — flows through the topology's calibrated link
overlay when a :class:`~repro_torch.comm.calibration.CalibrationProfile` is
attached, so the contention derate prices fitted terms, not nominal
constants. Attaching a profile bumps the topology epoch, which bumps the
planner :attr:`PathPlanner.epoch`, so no pre-calibration plan survives.

Hierarchy (DESIGN §3.1): on multi-island topologies the planner preserves
the island-routing invariants — intra-island plans never touch an
inter-node link, and every cross-island route stages through exactly one
inter-node hop (fan-out / inter-hop / fan-in), with §4.5 link-disjointness
claimed across both tiers.
"""

from __future__ import annotations

from typing import Sequence

from repro_torch.comm.config import CommConfig
from repro_torch.comm.plan import (PathAssignment, TransferGroup, TransferPlan,
                             TransferRequest)
from repro_torch.comm.policy import (GreedyBandwidthPolicy, PathPolicy,
                               contention_scaled, make_policy)
from repro_torch.core.topology import HOST, Route, Topology
from repro_torch.core.topology import _UID_SOURCE

_GREEDY = GreedyBandwidthPolicy()

#: Planner attributes whose reassignment changes what :meth:`PathPlanner.plan`
#: would return for an identical request — each bump invalidates every
#: fast-path entry stamped with an older epoch.
_EPOCH_ATTRS = frozenset({
    "topology", "config", "max_paths", "chunk_bytes", "max_chunks",
    "include_host", "multipath_threshold", "policy", "quarantined"})


class PathPlanner:
    """Selects routes and builds :class:`TransferPlan` objects.

    Mutating any planning input after construction (``max_paths``,
    ``policy``, ``topology``, …) bumps the planner's :attr:`epoch`, the
    plan-validity token the dispatch fast path
    (:class:`repro_torch.comm.cache.FastPathCache`) stamps its entries with —
    so a policy change always forces a re-plan instead of serving a stale
    executable. Every plan preserves the §4.5 invariants (disjoint byte
    coverage, link-disjoint routes), island-aware on hierarchical
    topologies: intra-island traffic never crosses an inter-node link and
    cross-island routes carry exactly one inter-node hop each.
    """

    def __init__(self, topology: Topology, *,
                 max_paths: int | None = None,
                 chunk_bytes: int | None = None,
                 max_chunks: int | None = None,
                 include_host: bool | None = None,
                 multipath_threshold: int | None = None,
                 policy: PathPolicy | None = None,
                 config: CommConfig | None = None):
        self._uid = next(_UID_SOURCE)
        self._epoch = 0
        if config is None:
            config = CommConfig.from_env()
        self.topology = topology
        self.config = config
        self.max_paths = (config.max_paths if max_paths is None
                          else max_paths)
        self.chunk_bytes = (config.chunk_bytes if chunk_bytes is None
                            else chunk_bytes)
        self.max_chunks = (config.max_chunks if max_chunks is None
                           else max_chunks)
        self.include_host = (config.include_host if include_host is None
                             else include_host)
        # Paper §5.3: multi-pathing engages at 2 MB; below that the single
        # direct path wins (launch overhead dominates).
        self.multipath_threshold = (
            config.multipath_threshold if multipath_threshold is None
            else multipath_threshold)
        self.policy = policy if policy is not None else make_policy(
            config.policy)
        #: Directional links excluded from route admission (DESIGN §4.6):
        #: the health monitor quarantines suspect links here; reassignment
        #: bumps :attr:`epoch`, so every fast-path entry routed over a
        #: newly-quarantined link is invalidated on the next lookup.
        self.quarantined: frozenset[tuple[int, int]] = frozenset()
        self._track_mutations = True

    def __setattr__(self, name: str, value) -> None:
        object.__setattr__(self, name, value)
        if name in _EPOCH_ATTRS and getattr(self, "_track_mutations", False):
            self._epoch += 1

    @property
    def epoch(self) -> tuple[int, ...]:
        """Plan-validity token: ``(planner uid, planner mutations,
        topology uid, topology mutations)``.

        Changes whenever a planning input is reassigned on this planner or
        the topology's link set mutates
        (:meth:`repro_torch.core.topology.Topology.bump_epoch`) — the dispatch
        fast path compares it on every lookup, so a stale plan can never
        be served. Mutating the *internals* of an attached policy object
        is not observable; swap the ``policy`` attribute (or call
        ``topology.bump_epoch()``) to invalidate explicitly.
        """
        return (self._uid, self._epoch, *self.topology.epoch)

    # -- quarantine (link health, DESIGN §4.6) ------------------------------
    def quarantine(self, *links: tuple[int, int]) -> None:
        """Exclude directional links from route admission.

        Quarantine is planner-level suspicion, distinct from a topology
        ``fail_link`` (the link still physically exists — health probes
        may traverse it via ``admit_quarantined=True``). Reassigning the
        set bumps :attr:`epoch`, invalidating every cached plan routed
        over a newly-quarantined link; a no-op call (links already
        quarantined) preserves the epoch.
        """
        add = frozenset(tuple(link) for link in links)
        if add - self.quarantined:
            self.quarantined = self.quarantined | add

    def readmit(self, *links: tuple[int, int]) -> None:
        """Re-admit quarantined links into route admission.

        The inverse of :meth:`quarantine` — called by the health
        monitor after the probe contract is met (consecutive healthy
        probes). Bumps :attr:`epoch` when the set actually shrinks, so
        degraded-mode plans are invalidated and steady-state traffic
        returns to the full route set (and its pre-fault plan digest).
        """
        drop = frozenset(tuple(link) for link in links)
        if drop & self.quarantined:
            self.quarantined = self.quarantined - drop

    # -- route enumeration --------------------------------------------------
    def enumerate_routes(self, src: int, dst: int,
                         include_host: bool | None = None, *,
                         admit_quarantined: bool = False) -> list[Route]:
        """All 1- and 2-hop routes src→dst, best (direct, then by bw) first.

        Staged routes never reuse a directional link of the direct route, so
        per-link exclusivity (§4.5 contention avoidance) holds by construction.

        Island-aware (DESIGN §3.1): when the topology reports more than
        one island, intra-island requests only ever stage through
        same-island devices (and optionally the host) — no intra plan
        touches an inter-node link — while cross-island requests delegate
        to the staged enumeration (fan-out to an egress device, exactly
        one inter-node hop, fan-in), see :meth:`cross_island_routes`.

        Quarantined links (DESIGN §4.6) are treated as absent — no
        admitted route crosses one, the degraded-mode exclusion
        invariant — unless ``admit_quarantined=True`` (health probes
        must be able to traverse the very link under suspicion).
        """
        if src == dst:
            raise ValueError("src == dst")
        topo = self.topology
        include_host = (self.include_host if include_host is None
                        else include_host)
        quarantined = (frozenset() if admit_quarantined
                       else self.quarantined)

        def usable(a: int, b: int):
            return None if (a, b) in quarantined else topo.link(a, b)

        hierarchical = topo.num_islands > 1
        if hierarchical and topo.node_of(src) != topo.node_of(dst):
            return self.cross_island_routes(
                src, dst, admit_quarantined=admit_quarantined)
        island = topo.node_of(src) if hierarchical else None

        def in_island(dev: int) -> bool:
            return (not hierarchical or dev == HOST
                    or topo.node_of(dev) == island)

        routes: list[Route] = []
        direct = usable(src, dst)
        if direct is not None:
            routes.append(Route(src, dst, None, (direct,),
                                direct.bandwidth_gbps))
        vias = [d for d in topo.devices()
                if d not in (src, dst) and in_island(d)]
        if include_host:
            vias.append(HOST)
        for via in vias:
            h1, h2 = usable(src, via), usable(via, dst)
            if h1 is None or h2 is None:
                continue
            routes.append(Route(src, dst, via, (h1, h2),
                                min(h1.bandwidth_gbps, h2.bandwidth_gbps)))
        if len(routes) < self.max_paths:
            # Torus case: adjacent chips share no common neighbour (girth
            # 4), so alternative routes are 3-hop detours through a
            # perpendicular axis (src→v1→v2→dst) — the TPU analogue of the
            # paper's staged-GPU path (DESIGN.md §2). Only link-disjoint
            # detours (vs routes found so far) are admitted.
            used = {l for r in routes for l in r.directional_links()}
            for v1 in topo.neighbors(src):
                if v1 in (dst, src) or not in_island(v1):
                    continue
                if v1 == HOST and not include_host:
                    # neighbors() includes the PCIe host node; a detour
                    # staged through it must honor the caller's host
                    # constraint just like the 2-hop host route does.
                    continue
                for v2 in topo.neighbors(dst):
                    if v2 in (src, dst, v1) or not in_island(v2):
                        continue
                    if v2 == HOST and not include_host:
                        continue
                    h1, h2, h3 = (usable(src, v1), usable(v1, v2),
                                  usable(v2, dst))
                    if h1 is None or h2 is None or h3 is None:
                        continue
                    links = {(src, v1), (v1, v2), (v2, dst)}
                    if links & used:
                        continue
                    used |= links
                    routes.append(Route(
                        src, dst, v1, (h1, h2, h3),
                        min(h.bandwidth_gbps for h in (h1, h2, h3))))
        # direct first, then staged by hop count and bandwidth, host last
        # (paper: the host path is the marginal contributor).
        routes.sort(key=lambda r: (r.via is not None,
                                   r.via == HOST,
                                   r.num_hops,
                                   -r.bottleneck_gbps))
        return routes

    def cross_island_routes(self, src: int, dst: int, *,
                            admit_quarantined: bool = False) -> list[Route]:
        """Staged routes across a node boundary, best-first (§4.4/§3.1).

        One candidate per inter-node link whose endpoints sit in the
        source/destination islands: an optional intra-island hop to the
        egress device, the inter-node hop, and an optional intra-island
        hop from the ingress device — so every route crosses **exactly
        one** inter-node link (the hierarchical-routing invariant the
        property suite validates). Candidates are filtered best-first to
        a link-disjoint set, preserving the §4.5 exclusivity contract
        policies assume of their route lists. Quarantined links are
        excluded like failed ones (DESIGN §4.6) unless
        ``admit_quarantined=True``.
        """
        topo = self.topology
        src_island, dst_island = topo.node_of(src), topo.node_of(dst)
        if src_island == dst_island:
            raise ValueError(f"{src}->{dst} is intra-island "
                             f"(island {src_island})")
        quarantined = (frozenset() if admit_quarantined
                       else self.quarantined)

        def usable(a: int, b: int):
            return None if (a, b) in quarantined else topo.link(a, b)

        cands: list[Route] = []
        for (a, b) in topo.links:
            if a == HOST or b == HOST:
                continue
            if topo.node_of(a) != src_island or topo.node_of(b) != dst_island:
                continue
            inter = usable(a, b)
            if inter is None:
                continue
            hops = []
            if a != src:
                fan_out = usable(src, a)
                if fan_out is None:
                    continue
                hops.append(fan_out)
            hops.append(inter)
            if b != dst:
                fan_in = usable(b, dst)
                if fan_in is None:
                    continue
                hops.append(fan_in)
            via = a if a != src else (b if b != dst else None)
            cands.append(Route(src, dst, via, tuple(hops),
                               min(h.bandwidth_gbps for h in hops)))
        cands.sort(key=lambda r: (-r.bottleneck_gbps, r.num_hops))
        routes: list[Route] = []
        used: set[tuple[int, int]] = set()
        for route in cands:
            links = set(route.directional_links())
            if links & used:
                continue
            used |= links
            routes.append(route)
        return routes

    # -- plan construction ---------------------------------------------------
    def compose(self, src: int, dst: int, nbytes: int,
                shares: Sequence[tuple[Route, int]], *,
                num_chunks: int | None = None,
                granularity: int = 1) -> TransferPlan:
        """Turn policy-assigned (route, share) pairs into a checked plan.

        Zero shares are dropped; offsets are assigned cumulatively so the
        byte ranges are disjoint and cover ``[0, nbytes)`` (§4.5); chunking
        follows the planner's ``chunk_bytes``/``max_chunks`` unless an
        explicit ``num_chunks`` is forced.
        """
        paths: list[PathAssignment] = []
        offset = 0
        for route, share in shares:
            if share <= 0:
                continue
            if num_chunks is not None:
                chunks = num_chunks
            else:
                chunks = max(1, min(self.max_chunks,
                                    -(-share // self.chunk_bytes)))
            chunks = min(chunks, max(1, share // granularity))
            paths.append(PathAssignment(route, offset, share, chunks,
                                        granularity))
            offset += share
        return TransferPlan(src, dst, nbytes, tuple(paths),
                            self.topology.name)

    def plan(self, src: int, dst: int, nbytes: int, *,
             max_paths: int | None = None,
             include_host: bool | None = None,
             num_chunks: int | None = None,
             granularity: int = 1,
             policy: PathPolicy | None = None,
             admit_quarantined: bool = False) -> TransferPlan:
        """Build the 2-D transfer plan (Algorithm 1 lines 4–11).

        ``policy`` overrides the planner's strategy for this call only
        (used by the tuner to score greedy candidates without recursing).
        ``admit_quarantined=True`` lifts the §4.6 quarantine exclusion
        for this call — the health-probe escape hatch; every other plan
        preserves the invariant that no route crosses a quarantined
        link.
        """
        if nbytes <= 0:
            raise ValueError("nbytes must be positive")
        if nbytes % granularity:
            raise ValueError(f"nbytes {nbytes} not a multiple of "
                             f"granularity {granularity}")
        if max_paths is not None and max_paths < 1:
            raise ValueError(f"max_paths must be >= 1, got {max_paths}")
        if max_paths is None:
            max_paths = self.max_paths
        include_host = (self.include_host if include_host is None
                        else include_host)
        routes = self.enumerate_routes(src, dst, include_host=include_host,
                                       admit_quarantined=admit_quarantined)
        if not routes:
            raise ValueError(
                f"no route {src}->{dst} in topology {self.topology.name}")
        if nbytes < self.multipath_threshold:
            routes = routes[:1]
        policy = policy if policy is not None else self.policy
        return policy.build(self, src, dst, nbytes, routes=routes,
                            max_paths=max_paths, num_chunks=num_chunks,
                            granularity=granularity,
                            include_host=include_host)

    # -- group planning (concurrent messages) ---------------------------------
    def plan_group(self, requests: Sequence[TransferRequest | tuple], *,
                   max_paths: int | None = None,
                   include_host: bool | None = None,
                   num_chunks: int | None = None,
                   exclusive: bool = False) -> TransferGroup:
        """Jointly plan a set of concurrent messages (a transfer group).

        ``requests`` are :class:`TransferRequest` objects or plain
        ``(src, dst, nbytes)`` tuples. Unlike N independent ``plan()``
        calls, the group planner prices cross-message link sharing. Two
        candidate groups are built and the §4.4 analytic model picks:

        * **exclusive** — distinct flows claim routes round-robin
          (best-first), a route only while all of its directional links
          are unclaimed, so flows end up link-disjoint whenever the
          topology has the capacity (the group-level §4.5 invariant,
          ``TransferGroup.exclusive``). Optimal for exchange patterns
          (bidirectional, halo) where full disjointness exists.
        * **shared** — every flow keeps its full route set with bandwidths
          derated by the traffic already planned
          (:func:`~repro_torch.comm.policy.contention_scaled`), so shares
          reflect the capacity each path will actually see. Optimal when
          flows converge (fan-in) and partitioning links would starve
          someone.

        In both candidates, each message's path count is chosen by scoring
        plans under :func:`~repro_torch.core.pipelining.estimate_transfer_time_s`
        with every previously-planned group member as ``concurrent_plans``
        — never in isolation. ``exclusive=True`` forces the exclusive
        candidate and raises if some flow has no link-disjoint route.

        Messages of the same flow share that flow's routes — they ride one
        fused program and serialize per link, which the model prices as
        contention.
        """
        reqs = [r if isinstance(r, TransferRequest) else TransferRequest(*r)
                for r in requests]
        if not reqs:
            return TransferGroup((), self.topology.name)
        for r in reqs:
            if r.src == r.dst:
                raise ValueError(f"src == dst in group request {r}")
            if r.nbytes <= 0:
                raise ValueError(f"nbytes must be positive in {r}")
            if r.nbytes % r.granularity:
                raise ValueError(f"nbytes {r.nbytes} not a multiple of "
                                 f"granularity {r.granularity} in {r}")
        max_paths = self.max_paths if max_paths is None else max_paths
        if max_paths < 1:
            raise ValueError(f"max_paths must be >= 1, got {max_paths}")
        include_host = (self.include_host if include_host is None
                        else include_host)

        # Phase 1: round-robin route claiming per distinct flow.
        flows = list(dict.fromkeys(r.flow for r in reqs))
        largest = {f: max(r.nbytes for r in reqs if r.flow == f)
                   for f in flows}
        candidates = {f: self.enumerate_routes(*f, include_host=include_host)
                      for f in flows}
        for f in flows:
            if not candidates[f]:
                raise ValueError(f"no route {f[0]}->{f[1]} in topology "
                                 f"{self.topology.name}")
        want = {f: (1 if largest[f] < self.multipath_threshold else max_paths)
                for f in flows}
        claimed: dict[tuple[int, int], list[Route]] = {f: [] for f in flows}
        used_links: set[tuple[int, int]] = set()
        progress = True
        while progress:
            progress = False
            for f in flows:
                if len(claimed[f]) >= want[f]:
                    continue
                for route in candidates[f]:
                    links = set(route.directional_links())
                    if links & used_links:
                        continue
                    claimed[f].append(route)
                    used_links |= links
                    progress = True
                    break
        starved = [f for f in flows if not claimed[f]]
        if starved and exclusive:
            raise ValueError(
                f"cannot plan link-exclusive group: flows {starved} have no "
                f"route disjoint from the rest of the group on topology "
                f"{self.topology.name}; drop exclusive=True to share links "
                f"with contention-aware splitting")
        link_flow_count = {l: 1 for l in used_links}

        # Phase 2: per-message configuration, scored under the §4.4 model
        # with the rest of the group as concurrent traffic.
        from repro_torch.core.pipelining import (estimate_group_time_s,
                                           estimate_transfer_time_s)

        policy = (self.policy if getattr(self.policy, "honors_routes", False)
                  else _GREEDY)

        def build_message(r: TransferRequest, routes: Sequence[Route],
                          prior: list[TransferPlan]) -> TransferPlan:
            if r.nbytes < self.multipath_threshold:
                routes = routes[:1]
            best, best_t = None, float("inf")
            for k in range(1, min(max_paths, len(routes)) + 1):
                cand = policy.build(
                    self, r.src, r.dst, r.nbytes, routes=routes[:k],
                    max_paths=k, num_chunks=num_chunks,
                    granularity=r.granularity, include_host=include_host)
                t = estimate_transfer_time_s(cand, self.topology,
                                             concurrent_plans=prior)
                if t < best_t:
                    best, best_t = cand, t
            assert best is not None
            return best

        def link_counts(plans: Sequence[TransferPlan]
                        ) -> dict[tuple[int, int], int]:
            counts: dict[tuple[int, int], int] = {}
            for p in plans:
                for link in p.directional_links():
                    counts[link] = counts.get(link, 0) + 1
            return counts

        # Candidate A: link-exclusive flows (starved flows fall back to
        # contention-derated sharing so the candidate is always complete).
        plans_ex: list[TransferPlan] = []
        for r in reqs:
            routes = claimed[r.flow] or contention_scaled(
                candidates[r.flow], link_flow_count)
            plans_ex.append(build_message(r, routes, plans_ex))
        group_ex = TransferGroup(tuple(plans_ex), self.topology.name)
        if exclusive:
            return group_ex

        # Candidate B: shared routes with contention-derated shares.
        plans_sh: list[TransferPlan] = []
        for r in reqs:
            routes = contention_scaled(candidates[r.flow],
                                       link_counts(plans_sh))
            plans_sh.append(build_message(r, routes, plans_sh))
        group_sh = TransferGroup(tuple(plans_sh), self.topology.name)

        # The model arbitrates; ties prefer the exclusive candidate (a
        # contention-free wire is the paper's §4.5 default).
        t_ex = estimate_group_time_s(group_ex, self.topology)
        t_sh = estimate_group_time_s(group_sh, self.topology)
        return group_ex if t_ex <= t_sh else group_sh

    # -- offline tuner (paper §4.4) -------------------------------------------
    def tune(self, src: int, dst: int, nbytes: int, *,
             path_counts: tuple[int, ...] = (1, 2, 3, 4),
             chunk_counts: tuple[int, ...] = (1, 2, 4, 8, 16),
             include_host_options: tuple[bool, ...] = (False, True),
             use_compiled_plans: bool = True,
             granularity: int = 1) -> TransferPlan:
        """Exhaustive offline search for the best (paths × chunks × host)
        configuration under the analytic pipeline model.

        The paper tunes separately for CUDA-Graph and non-graph modes because
        launch overheads differ; ``use_compiled_plans`` toggles which launch
        overhead model is applied. Candidates are greedy plans regardless of
        the planner's own policy (the tuner searches the paper handler's
        configuration space).
        """
        from repro_torch.core.pipelining import estimate_transfer_time_s

        best_plan, best_t = None, float("inf")
        for host in include_host_options:
            if host and not any(l.src == HOST or l.dst == HOST
                                for l in self.topology.links.values()):
                continue
            for npaths in path_counts:
                for nchunks in chunk_counts:
                    plan = self.plan(src, dst, nbytes, max_paths=npaths,
                                     include_host=host, num_chunks=nchunks,
                                     granularity=granularity,
                                     policy=_GREEDY)
                    t = estimate_transfer_time_s(
                        plan, self.topology,
                        compiled_plan=use_compiled_plans)
                    if t < best_t:
                        best_plan, best_t = plan, t
        assert best_plan is not None
        return best_plan
