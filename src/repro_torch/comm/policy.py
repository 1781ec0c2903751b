"""PathPolicy — pluggable path-selection strategies (Algorithm 1, line 6).

The planner owns route *enumeration* and chunking mechanics; a policy
decides which of the enumerated routes carry the message and how many bytes
each gets. Three strategies ship:

* :class:`GreedyBandwidthPolicy` — the paper's ``GetPathConfig``: take the
  best ``max_paths`` routes and split shares proportionally to each route's
  bottleneck bandwidth. This reproduces the pre-refactor ``PathPlanner.plan``
  byte-for-byte.
* :class:`RoundRobinPolicy` — uniform striping: equal shares across the
  selected routes. Deliberately deterministic (no per-call rotation — a
  rotating route order would give every message a distinct plan signature
  and defeat the compiled-plan cache).
* :class:`TunerPolicy` — offline-tuner backed (paper §4.4): exhaustively
  searches (paths × chunks × host) under the analytic pipeline model and
  memoizes the winner per (src, dst, nbytes) so steady-state planning stays
  cheap.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Mapping, Protocol, Sequence, \
    runtime_checkable

from repro_torch.core.topology import HOST, Route

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.comm.planner import PathPlanner
    from repro_torch.comm.plan import TransferPlan


def contention_scaled(routes: Sequence[Route],
                      link_flows: Mapping[tuple[int, int], int]
                      ) -> list[Route]:
    """Derate each route's bottleneck bandwidth by group contention.

    ``link_flows`` counts how many other flows of the group already use
    each directional link; a link carrying *k* other flows contributes
    ``bandwidth / (1 + k)`` to the route's bottleneck — the same
    equal-share model :func:`repro_torch.core.pipelining.wire_time_s` applies.
    Routes are re-sorted best-first under the derated bandwidths (host
    last, as in enumeration) so bandwidth-proportional share splitting
    sees the *effective* capacities instead of the nominal ones.
    """
    out = []
    for r in routes:
        eff = min(h.bandwidth_gbps / (1 + link_flows.get((h.src, h.dst), 0))
                  for h in r.hops)
        out.append(dataclasses.replace(r, bottleneck_gbps=eff))
    out.sort(key=lambda r: (r.via == HOST, -r.bottleneck_gbps, r.num_hops))
    return out


@runtime_checkable
class PathPolicy(Protocol):
    """Strategy protocol: build a plan from the enumerated candidate routes.

    ``routes`` arrive best-first (direct, then staged by hop count and
    bandwidth, host last) and already truncated to a single route when the
    message is below the planner's multipath threshold. Implementations
    normally call :meth:`PathPlanner.compose` to apply the shared chunking
    rules so the §4.5 invariants hold by construction.
    """

    name: str
    #: True when ``build`` selects among exactly the ``routes`` it is given.
    #: Group planning (``PathPlanner.plan_group``) relies on this to keep
    #: its contention-filtered route sets authoritative; policies that
    #: replan from scratch (the tuner) are swapped for greedy inside a
    #: group.
    honors_routes: bool

    def build(self, planner: "PathPlanner", src: int, dst: int, nbytes: int,
              *, routes: Sequence[Route], max_paths: int,
              num_chunks: int | None, granularity: int,
              include_host: bool) -> "TransferPlan":
        ...


class GreedyBandwidthPolicy:
    """Bandwidth-proportional shares over the best ``max_paths`` routes."""

    name = "greedy"
    honors_routes = True

    def build(self, planner: "PathPlanner", src: int, dst: int, nbytes: int,
              *, routes: Sequence[Route], max_paths: int,
              num_chunks: int | None, granularity: int,
              include_host: bool) -> "TransferPlan":
        routes = list(routes)[:max_paths]
        total_bw = sum(r.bottleneck_gbps for r in routes)
        shares: list[tuple[Route, int]] = []
        assigned = 0
        for i, route in enumerate(routes):
            if i == len(routes) - 1:
                share = nbytes - assigned  # remainder absorbs rounding (§4.5)
            else:
                share = (int(nbytes * route.bottleneck_gbps / total_bw)
                         // granularity * granularity)
            shares.append((route, share))
            assigned += share
        return planner.compose(src, dst, nbytes, shares,
                               num_chunks=num_chunks, granularity=granularity)


class RoundRobinPolicy:
    """Equal shares across the selected routes (uniform striping)."""

    name = "round_robin"
    honors_routes = True

    def build(self, planner: "PathPlanner", src: int, dst: int, nbytes: int,
              *, routes: Sequence[Route], max_paths: int,
              num_chunks: int | None, granularity: int,
              include_host: bool) -> "TransferPlan":
        routes = list(routes)[:max_paths]
        k = len(routes)
        base = (nbytes // k) // granularity * granularity
        shares = [(route, base) for route in routes[:-1]]
        shares.append((routes[-1], nbytes - base * (k - 1)))
        return planner.compose(src, dst, nbytes, shares,
                               num_chunks=num_chunks, granularity=granularity)


class TunerPolicy:
    """Offline-tuned plans (paper §4.4), memoized per message signature.

    The search itself runs the greedy policy over the candidate grid (so the
    tuner explores exactly the configurations the paper's handler would
    build), scored by the analytic pipeline model.
    """

    name = "tuner"
    honors_routes = False

    def __init__(self, *, path_counts: tuple[int, ...] = (1, 2, 3, 4),
                 chunk_counts: tuple[int, ...] = (1, 2, 4, 8, 16),
                 include_host_options: tuple[bool, ...] = (False, True),
                 use_compiled_plans: bool = True):
        self.path_counts = path_counts
        self.chunk_counts = chunk_counts
        self.include_host_options = include_host_options
        self.use_compiled_plans = use_compiled_plans
        self._memo: dict[tuple, "TransferPlan"] = {}

    def build(self, planner: "PathPlanner", src: int, dst: int, nbytes: int,
              *, routes: Sequence[Route], max_paths: int,
              num_chunks: int | None, granularity: int,
              include_host: bool) -> "TransferPlan":
        # Key on the topology OBJECT (identity hash): names are non-unique
        # defaults (full_mesh() is always "beluga4"), and a policy shared
        # across sessions must not serve one topology's plan to another.
        key = (planner.topology, src, dst, nbytes, num_chunks,
               granularity, max_paths, include_host)
        plan = self._memo.get(key)
        if plan is None:
            chunk_counts = (self.chunk_counts if num_chunks is None
                            else (num_chunks,))
            path_counts = tuple(p for p in self.path_counts
                                if p <= max_paths) or (max_paths,)
            # The caller's host constraint is a hard cap: a host-staged
            # plan handed to the engine would be rejected as unexecutable.
            host_options = tuple(h for h in self.include_host_options
                                 if include_host or not h) or (False,)
            plan = planner.tune(src, dst, nbytes,
                                path_counts=path_counts,
                                chunk_counts=chunk_counts,
                                include_host_options=host_options,
                                use_compiled_plans=self.use_compiled_plans,
                                granularity=granularity)
            self._memo[key] = plan
        return plan


def make_policy(name: str, **kwargs) -> PathPolicy:
    """Resolve a policy name from :data:`repro_torch.comm.config.POLICY_NAMES`."""
    registry = {
        GreedyBandwidthPolicy.name: GreedyBandwidthPolicy,
        RoundRobinPolicy.name: RoundRobinPolicy,
        TunerPolicy.name: TunerPolicy,
    }
    try:
        cls = registry[name]
    except KeyError:
        raise ValueError(f"unknown path policy {name!r}; expected one of "
                         f"{sorted(registry)}") from None
    return cls(**kwargs)
