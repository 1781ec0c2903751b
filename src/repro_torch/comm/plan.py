"""Transfer-plan data model: the 2-D (horizontal × vertical) split.

Moved from ``repro/core/paths.py`` as part of the ``repro_torch.comm`` API
consolidation; pure data, shared by policies, the planner, the pipelining
time model, and the executable engine.

Beyond the single-message :class:`TransferPlan`, this module holds the
*group* data model: a :class:`TransferRequest` describes one message of a
set planned jointly, and a :class:`TransferGroup` is the jointly-planned
result — one plan per message, produced by
:meth:`~repro_torch.comm.planner.PathPlanner.plan_group` so that cross-message
link sharing is priced (and, where feasible, avoided) instead of ignored.
"""

from __future__ import annotations

import dataclasses

from repro_torch.core.topology import Route


@dataclasses.dataclass(frozen=True)
class PathAssignment:
    """One path of a transfer: a route, its byte range, and its chunking.

    ``granularity`` keeps every chunk boundary aligned (e.g. to the dtype
    itemsize when the engine moves typed arrays rather than raw bytes).
    """

    route: Route
    offset: int          # byte offset into the message (disjoint, §4.5)
    nbytes: int          # share of the message on this path
    num_chunks: int      # vertical split (pipelining)
    granularity: int = 1

    def chunk_bounds(self) -> list[tuple[int, int]]:
        """Disjoint (offset, size) per chunk; last chunk absorbs remainder."""
        if self.nbytes == 0:
            return []
        g = self.granularity
        base = (self.nbytes // self.num_chunks) // g * g
        bounds = []
        off = self.offset
        for i in range(self.num_chunks):
            size = base if i < self.num_chunks - 1 else (
                self.nbytes - base * (self.num_chunks - 1))
            bounds.append((off, size))
            off += size
        return bounds


@dataclasses.dataclass(frozen=True)
class TransferPlan:
    """The full 2-D plan for one P2P message (horizontal × vertical split)."""

    src: int
    dst: int
    nbytes: int
    paths: tuple[PathAssignment, ...]
    topology_name: str

    @property
    def num_paths(self) -> int:
        return len(self.paths)

    @property
    def num_nodes(self) -> int:
        """Copy-node count of the equivalent CUDA Graph (paper Fig. 13/14):
        one node per chunk per hop."""
        return sum(p.num_chunks * p.route.num_hops for p in self.paths)

    def covered_bytes(self) -> int:
        return sum(p.nbytes for p in self.paths)

    def directional_links(self) -> set[tuple[int, int]]:
        """All directional links used by any path of this plan."""
        return {link for pa in self.paths
                for link in pa.route.directional_links()}


@dataclasses.dataclass(frozen=True)
class TransferRequest:
    """One message of a jointly-planned transfer group.

    ``granularity`` keeps chunk boundaries aligned per message (dtype
    itemsize when the engine moves typed arrays) — messages of a group may
    have different dtypes, so it is per-request rather than per-group.
    """

    src: int
    dst: int
    nbytes: int
    granularity: int = 1

    @property
    def flow(self) -> tuple[int, int]:
        return (self.src, self.dst)


@dataclasses.dataclass(frozen=True)
class TransferGroup:
    """A set of concurrent P2P messages planned as one unit.

    Produced by :meth:`~repro_torch.comm.planner.PathPlanner.plan_group`: plans
    are aligned with the requests, and route selection accounted for every
    other message of the group. Distinct flows (``(src, dst)`` pairs) get
    link-disjoint routes whenever the topology permits; messages of the
    *same* flow share that flow's routes (they serialize per link, which
    the analytic model prices as contention). The engine fuses the whole
    group into one compiled SPMD program and one launch.
    """

    plans: tuple[TransferPlan, ...]
    topology_name: str

    @property
    def num_messages(self) -> int:
        return len(self.plans)

    @property
    def num_nodes(self) -> int:
        """Total copy-node count of the fused program (one CUDA Graph)."""
        return sum(p.num_nodes for p in self.plans)

    @property
    def total_nbytes(self) -> int:
        return sum(p.nbytes for p in self.plans)

    def link_flows(self) -> dict[tuple[int, int], set[tuple[int, int]]]:
        """Directional link → set of flows (src, dst) that use it."""
        out: dict[tuple[int, int], set[tuple[int, int]]] = {}
        for plan in self.plans:
            for link in plan.directional_links():
                out.setdefault(link, set()).add((plan.src, plan.dst))
        return out

    def shared_links(self) -> set[tuple[int, int]]:
        """Directional links carrying more than one flow (contended)."""
        return {link for link, flows in self.link_flows().items()
                if len(flows) > 1}

    @property
    def exclusive(self) -> bool:
        """True when no directional link is shared across distinct flows —
        the group-level §4.5 invariant, feasible for exchange patterns
        (bidirectional, halo) but not e.g. many messages into one device."""
        return not self.shared_links()
