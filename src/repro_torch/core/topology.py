"""Hardware topology model: devices, links, and multi-path route enumeration.

A transcription of the reference package's Base Module (DESIGN.md §2/§3):
a declarative link model (a Beluga/Narval-like NVLink full mesh, a 2-D
torus, or islands of either) exposing the link graph that the
:class:`~repro_torch.comm.planner.PathPlanner` enumerates routes over.

Bandwidths are unidirectional per directional link, GB/s, and are model
parameters of the fixtures, not measurements of any card. On one GPU the
logical devices are rows of one operand, so these links are a planning
model only; mapping devices to distinct peer GPUs is a later slice.

Hierarchy (DESIGN.md §3.1): every device belongs to exactly one *island*
(node). Flat topologies put all devices in island 0; :meth:`Topology.\
hierarchical` builds N islands of intra-node links joined by per-tier
inter-node links (e.g. ``"nvlink"`` inside, ``"ib"``/``"dcn"`` between).
The island assignment is part of the structural :meth:`Topology.digest`
and therefore of the plan-validity epoch: two topologies with identical
links but different node boundaries can never cross-serve cached plans or
calibration profiles.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
from typing import Any, Iterable, Mapping

HOST = -1  # sentinel device id for the host (PCIe-staged) node

#: Process-wide source of topology/planner instance ids. Epoch tokens pair
#: a uid with a mutation counter so tokens from two different instances can
#: never collide (an ``id()``-based token could be reused after GC).
_UID_SOURCE = itertools.count()

#: Default per-link bandwidth parameter of the :meth:`Topology.torus2d` and
#: torus-island fixtures. Plan and digest equality with the reference
#: package depend on this literal; it is a fixture parameter, not a
#: measured rate.
TORUS_LINK_GBPS = 50.0


@dataclasses.dataclass(frozen=True)
class Link:
    """A directional link ``src -> dst`` with unidirectional bandwidth.

    Validated at construction (positive bandwidth, no self-links); the
    §4.4 model reads every bandwidth through links, so the invariant
    "a registered link is usable" holds everywhere downstream. ``kind``
    is the bandwidth class/tier — intra-node (``"nvlink"``, ``"ici"``),
    host (``"pcie"``) or inter-node (``"ib"``, ``"dcn"``).
    """

    src: int
    dst: int
    kind: str  # "ici" | "nvlink" | "pcie" | "ib" | "dcn"
    bandwidth_gbps: float

    def __post_init__(self) -> None:
        if self.bandwidth_gbps <= 0:
            raise ValueError(f"non-positive bandwidth on {self}")
        if self.src == self.dst:
            raise ValueError(f"self-link {self}")


@dataclasses.dataclass(frozen=True)
class Route:
    """A path from ``src`` to ``dst``: one hop (direct) or two (staged).

    ``via`` is the staging device (or :data:`HOST`); ``None`` means direct.
    ``bottleneck_gbps`` is the min link bandwidth along the route — the
    paper's per-path ``share[p]`` is proportional to it (§4.4). Routes in
    one plan are link-disjoint (the §4.5 contention invariant the
    planner preserves by construction).
    """

    src: int
    dst: int
    via: int | None
    hops: tuple[Link, ...]
    bottleneck_gbps: float

    @property
    def kind(self) -> str:
        """Route class: ``"direct"``, ``"staged_host"`` or
        ``"staged_device"`` (derived from ``via``)."""
        if self.via is None:
            return "direct"
        return "staged_host" if self.via == HOST else "staged_device"

    @property
    def num_hops(self) -> int:
        """Number of hops (links) along the route."""
        return len(self.hops)

    def directional_links(self) -> tuple[tuple[int, int], ...]:
        """The ``(src, dst)`` directional-link keys along the route, in
        hop order — the unit of §4.5 link-exclusivity accounting."""
        return tuple((h.src, h.dst) for h in self.hops)


class Topology:
    """Directed link graph over ``num_devices`` accelerators (+ host).

    Structural identity (links **and** island assignment) is captured by
    :meth:`digest`; any mutation bumps the :attr:`epoch` plan-validity
    token, so every cached plan / fast-path entry / calibration profile
    derived from a previous shape is invalidated, never silently reused.
    """

    def __init__(self, num_devices: int, links: Iterable[Link],
                 name: str = "custom",
                 grid_shape: tuple[int, ...] | None = None,
                 node_assignment: Iterable[int] | None = None):
        self.num_devices = int(num_devices)
        self.name = name
        self.grid_shape = grid_shape
        self._uid = next(_UID_SOURCE)
        self._epoch = 0
        self._links: dict[tuple[int, int], Link] = {}
        #: Island (node) membership, device -> island id. Flat topologies
        #: keep every device in island 0; the tuple is part of digest().
        self._node_assignment = self._check_assignment(node_assignment)
        #: Measured-feedback overlay (DESIGN §4.4c): a calibration profile
        #: attached via :meth:`set_calibration` plus the per-link ``Link``
        #: shadows :meth:`link` serves while it is live.
        self._calibration: Any | None = None
        self._calibrated_links: dict[tuple[int, int], Link] = {}
        #: Fault-model state (DESIGN §4.6): failed links are *removed*
        #: from the nominal set (stashed here for :meth:`restore_link`),
        #: degraded links keep their nominal entry but :meth:`link`
        #: serves a bandwidth-scaled shadow, and flaky marks are advisory
        #: metadata the health monitor reads for re-admission hysteresis.
        self._failed: dict[tuple[int, int], Link] = {}
        self._degraded: dict[tuple[int, int], float] = {}
        self._flaky: set[tuple[int, int]] = set()
        for link in links:
            self._register(link)

    def _check_assignment(self, node_assignment: Iterable[int] | None
                          ) -> tuple[int, ...]:
        if node_assignment is None:
            return (0,) * self.num_devices
        assignment = tuple(int(n) for n in node_assignment)
        if len(assignment) != self.num_devices:
            raise ValueError(
                f"node_assignment length {len(assignment)} != "
                f"num_devices {self.num_devices}")
        if any(n < 0 for n in assignment):
            raise ValueError(f"negative island id in {assignment}")
        return assignment

    def _register(self, link: Link) -> None:
        key = (link.src, link.dst)
        if key in self._links:
            # Multiple sublinks between a pair (e.g. 2 NVLinks on Beluga)
            # aggregate into one logical link with summed bandwidth.
            old = self._links[key]
            link = Link(link.src, link.dst, old.kind,
                        old.bandwidth_gbps + link.bandwidth_gbps)
        self._links[key] = link

    # -- mutation & epoch --------------------------------------------------
    @property
    def epoch(self) -> tuple[int, int]:
        """Plan-validity token ``(uid, mutations)`` for this topology.

        Cached plans and compiled fast-path entries
        (:class:`repro_torch.comm.cache.FastPathCache`) are stamped with the
        epoch in force when they were built; any link mutation
        (:meth:`add_link`, :meth:`remove_link`, :meth:`bump_epoch`)
        changes the token, so stale routes can never be served.
        """
        return (self._uid, self._epoch)

    def bump_epoch(self) -> None:
        """Invalidate every plan derived from this topology.

        Call after mutating link state out-of-band (e.g. poking
        ``_links`` directly); :meth:`add_link` / :meth:`remove_link` call
        it for you. If a calibration profile is attached and the
        structural :meth:`digest` no longer matches it (links were added
        or removed), the profile is dropped — fitted terms for a topology
        that no longer exists must never survive a mutation.
        """
        self._epoch += 1
        if (self._calibration is not None
                and self._calibration.topology_digest != self.digest()):
            self._calibration = None
            self._calibrated_links = {}

    def add_link(self, link: Link) -> None:
        """Register a directional link after construction (aggregating
        sublinks like the constructor does) and bump the plan epoch.
        Re-adding a currently-failed pair drops the failure stash — the
        explicit registration supersedes the fault record, preserving
        the invariant that a key is never both live and failed."""
        self._failed.pop((link.src, link.dst), None)
        self._register(link)
        self.bump_epoch()

    def remove_link(self, src: int, dst: int) -> None:
        """Drop the directional link ``src -> dst`` permanently (unlike
        :meth:`fail_link` there is no restore stash) and bump the plan
        epoch; any droop/flaky overlay for the pair is cleared so no
        fault state outlives the link. Raises ``KeyError`` if absent."""
        del self._links[(src, dst)]
        self._degraded.pop((src, dst), None)
        self._flaky.discard((src, dst))
        self.bump_epoch()

    # -- calibration (measured-feedback overlay, DESIGN §4.4c) -------------
    def digest(self) -> str:
        """Structural identity of this topology: a stable hash over the
        *nominal* link set ``(num_devices, node assignment,
        sorted (src, dst, kind, bw))``.

        Calibration profiles are keyed by this digest so fitted terms can
        never be applied to a different machine shape. The island
        assignment is part of the payload: two topologies with identical
        links but different node boundaries route differently, so their
        plans/profiles must never cross-serve. Deliberately ignores the
        calibrated overlay — attaching a profile does not change what
        machine this is.
        """
        payload = (self.num_devices,
                   self._node_assignment,
                   tuple(sorted((k[0], k[1], ln.kind,
                                 round(ln.bandwidth_gbps, 6))
                                for k, ln in self._links.items())))
        return hashlib.sha256(repr(payload).encode()).hexdigest()[:32]

    @property
    def calibration(self) -> Any | None:
        """The live calibration profile, or ``None`` when the model runs
        on nominal constants. Set via :meth:`set_calibration`."""
        return self._calibration

    def set_calibration(self, profile: Any | None) -> None:
        """Attach (or with ``None`` detach) a calibration profile.

        ``profile`` duck-types :class:`repro_torch.comm.calibration.\
        CalibrationProfile`: it must carry ``topology_digest``,
        ``link_bandwidth_gbps`` (``(src, dst) -> GB/s``) and ``launch``.
        Raises ``ValueError`` if the profile's digest does not match this
        topology's :meth:`digest` (fitted terms from another machine
        shape are refused, never silently misapplied). Attaching bumps
        the plan epoch: every cached plan and fast-path entry priced on
        the previous terms is invalidated.
        """
        if profile is not None:
            if profile.topology_digest != self.digest():
                raise ValueError(
                    f"calibration profile digest "
                    f"{profile.topology_digest!r} does not match topology "
                    f"{self.name!r} digest {self.digest()!r}")
            shadows = {}
            for key, bw in profile.link_bandwidth_gbps.items():
                nominal = self._links.get(tuple(key))
                if nominal is not None and bw > 0:
                    shadows[tuple(key)] = Link(
                        nominal.src, nominal.dst, nominal.kind, float(bw))
            self._calibration = profile
            self._calibrated_links = shadows
        else:
            self._calibration = None
            self._calibrated_links = {}
        self._epoch += 1  # not bump_epoch(): digest unchanged, keep profile

    # -- fault model (link health, DESIGN §4.6) ----------------------------
    def fail_link(self, src: int, dst: int) -> None:
        """Take the directional link ``src -> dst`` down (hard failure).

        The link leaves the nominal set entirely — :meth:`link`,
        :attr:`links`, :meth:`neighbors`, :meth:`egress_devices` and
        :meth:`digest` all see the surviving machine shape, so every
        planner/model consumer routes around it without special cases —
        and is stashed so :meth:`restore_link` can reinstate it
        *identically* (the digest-returns-to-pre-fault-value contract).
        Bumps the plan epoch: no cached plan or fast-path entry built on
        the failed link can ever be served again. Raises ``KeyError`` if
        the link is absent or already failed.
        """
        key = (src, dst)
        self._failed[key] = self._links.pop(key)
        self.bump_epoch()

    def restore_link(self, src: int, dst: int) -> None:
        """Bring a faulted link back to nominal health.

        Reinstates a failed link exactly as stashed by :meth:`fail_link`
        (so :meth:`digest` returns to its pre-fault value when no other
        mutation happened) and clears any degradation ratio and flaky
        mark — restore means full nominal re-admission at the hardware
        layer; quarantine re-admission stays the health monitor's probe
        decision. Bumps the plan epoch so degraded-mode plans are
        invalidated. Raises ``KeyError`` if the link carries no fault
        state at all.
        """
        key = (src, dst)
        if (key not in self._failed and key not in self._degraded
                and key not in self._flaky):
            raise KeyError(f"link {key} has no fault state to restore")
        if key in self._failed:
            self._register(self._failed.pop(key))
        self._degraded.pop(key, None)
        self._flaky.discard(key)
        self.bump_epoch()

    def degrade_link(self, src: int, dst: int, ratio: float) -> None:
        """Droop the link's effective bandwidth to ``ratio`` × nominal.

        A performance overlay in the :meth:`set_calibration` mold: the
        nominal link stays registered (structural :meth:`digest`
        unchanged, an attached calibration profile survives) but
        :meth:`link` serves a bandwidth-scaled shadow, so every model
        read — planner shares, §4.4 arbitration, collective tier
        bandwidths — prices the droop automatically. Bumps the plan
        epoch directly; ``ratio == 1.0`` clears the droop. Raises
        ``ValueError`` for ratios outside ``(0, 1]`` and ``KeyError``
        if the link is absent (or currently failed).
        """
        if not 0.0 < ratio <= 1.0:
            raise ValueError(f"degrade ratio must be in (0, 1], got {ratio}")
        key = (src, dst)
        if key not in self._links:
            raise KeyError(f"no link {key} to degrade")
        if ratio == 1.0:
            self._degraded.pop(key, None)
        else:
            self._degraded[key] = float(ratio)
        self._epoch += 1  # digest unchanged: droop is an overlay

    def mark_flaky(self, src: int, dst: int, flaky: bool = True) -> None:
        """Mark (or clear) a link as flaky — advisory fault metadata.

        A flaky link routes normally, but the health monitor demands a
        longer consecutive-healthy probe streak before re-admitting it
        from quarantine (hysteresis against flapping). Bumps the plan
        epoch conservatively so monitors keyed on fault state observe
        the change; the structural digest is preserved. Raises
        ``KeyError`` if the link is absent from the nominal set.
        """
        key = (src, dst)
        if key not in self._links and key not in self._failed:
            raise KeyError(f"no link {key} to mark flaky")
        if flaky:
            self._flaky.add(key)
        else:
            self._flaky.discard(key)
        self._epoch += 1  # digest unchanged: advisory overlay

    @property
    def failed_links(self) -> Mapping[tuple[int, int], Link]:
        """Links currently failed (``(src, dst) -> stashed nominal
        Link``) — invisible to every query until restored; the engine's
        degraded-mode dispatch validates entries against this set."""
        return self._failed

    @property
    def degraded_links(self) -> Mapping[tuple[int, int], float]:
        """Live droop overlay ``(src, dst) -> ratio``; :meth:`link`
        serves ``ratio × (calibrated or nominal)`` bandwidth while an
        entry is present (structural digest preserved)."""
        return self._degraded

    @property
    def flaky_links(self) -> frozenset:
        """Links marked flaky — the health monitor's re-admission
        hysteresis set (contract: advisory only, routing unchanged)."""
        return frozenset(self._flaky)

    def link_state(self, src: int, dst: int) -> str:
        """Fault-model state of the directional link: ``"failed"``,
        ``"degraded"``, ``"up"`` or ``"absent"`` — the single predicate
        health probes validate a link against."""
        key = (src, dst)
        if key in self._failed:
            return "failed"
        if key in self._degraded:
            return "degraded"
        return "up" if key in self._links else "absent"

    # -- hierarchy (islands / node boundaries, DESIGN §3.1) ----------------
    @property
    def num_islands(self) -> int:
        """Number of distinct islands (nodes); 1 for flat topologies."""
        return len(set(self._node_assignment))

    def node_of(self, dev: int) -> int:
        """Island (node) id of device ``dev``.

        Raises ``ValueError`` for out-of-range ids, including
        :data:`HOST` — the host is a staging point, not an island member
        (host hops never count as inter-island; see
        :meth:`is_inter_island`).
        """
        if not 0 <= dev < self.num_devices:
            raise ValueError(f"device {dev} has no island "
                             f"(num_devices={self.num_devices})")
        return self._node_assignment[dev]

    def islands(self) -> tuple[tuple[int, ...], ...]:
        """Device ids grouped per island, ordered by island id.

        The grouping is derived from the same node assignment that
        :meth:`digest` folds in, so models keyed on it share the plan
        epoch's validity.
        """
        groups: dict[int, list[int]] = {}
        for dev, island in enumerate(self._node_assignment):
            groups.setdefault(island, []).append(dev)
        return tuple(tuple(groups[i]) for i in sorted(groups))

    def is_inter_island(self, src: int, dst: int) -> bool:
        """True iff ``src -> dst`` crosses a node boundary.

        :data:`HOST` endpoints are never inter-island (the host belongs
        to no island); the §4.4 tier-aware costing and the planner's
        route invariants both key off this predicate.
        """
        if src == HOST or dst == HOST:
            return False
        return self.node_of(src) != self.node_of(dst)

    def egress_devices(self, island: int) -> tuple[int, ...]:
        """Devices of ``island`` owning at least one inter-island link —
        the fan-out targets of staged cross-island routes (§4.4)."""
        out = []
        for dev, isl in enumerate(self._node_assignment):
            if isl != island:
                continue
            for (s, d) in self._links:
                if s == dev and self.is_inter_island(s, d):
                    out.append(dev)
                    break
        return tuple(out)

    def set_node_assignment(self, node_assignment: Iterable[int] | None
                            ) -> None:
        """Reassign node boundaries (``None`` flattens to one island) and
        bump the plan epoch — the digest changes, so any attached
        calibration profile is dropped and every cached plan derived from
        the previous island layout is invalidated."""
        self._node_assignment = self._check_assignment(node_assignment)
        self.bump_epoch()

    # -- queries ----------------------------------------------------------
    @property
    def links(self) -> Mapping[tuple[int, int], Link]:
        """The nominal directional-link map ``(src, dst) -> Link``."""
        return self._links

    def link(self, src: int, dst: int) -> Link | None:
        """The directional link ``src -> dst`` (or ``None``). When a
        calibration profile is live, returns the fitted-bandwidth shadow
        of the nominal link — every model evaluation that reads
        bandwidths through here consumes measured terms automatically.
        A live droop overlay (:meth:`degrade_link`) scales the served
        bandwidth on top, and a failed link is ``None`` until restored —
        the fault model's invariant that no consumer can price or route
        over a link that is down."""
        key = (src, dst)
        base = None
        if self._calibrated_links:
            base = self._calibrated_links.get(key)
        if base is None:
            base = self._links.get(key)
        if base is not None and self._degraded:
            ratio = self._degraded.get(key)
            if ratio is not None:
                return Link(base.src, base.dst, base.kind,
                            base.bandwidth_gbps * ratio)
        return base

    def has_link(self, src: int, dst: int) -> bool:
        """True iff the nominal directional link ``src -> dst`` exists."""
        return (src, dst) in self._links

    def neighbors(self, dev: int) -> list[int]:
        """Devices (possibly :data:`HOST`) reachable from ``dev`` over
        one directional link, sorted."""
        return sorted({d for (s, d) in self._links if s == dev})

    def devices(self) -> list[int]:
        """All accelerator device ids, ``[0, num_devices)``."""
        return list(range(self.num_devices))

    # -- constructors ------------------------------------------------------
    @classmethod
    def full_mesh(cls, num_devices: int = 4, sublinks_per_pair: int = 2,
                  sublink_gbps: float = 25.0, host_gbps: float = 12.0,
                  with_host: bool = True, name: str = "beluga4") -> "Topology":
        """Beluga-like node: ``num_devices`` GPUs, NVLink full mesh + PCIe host.

        Beluga: 4×V100, 2 NVLink sublinks/pair (~25 GB/s each).
        Narval: 4×A100, pass ``sublinks_per_pair=4`` (name="narval4").
        """
        links = []
        for a, b in itertools.permutations(range(num_devices), 2):
            for _ in range(sublinks_per_pair):
                links.append(Link(a, b, "nvlink", sublink_gbps))
        if with_host:
            for d in range(num_devices):
                links.append(Link(d, HOST, "pcie", host_gbps))
                links.append(Link(HOST, d, "pcie", host_gbps))
        return cls(num_devices, links, name=name,
                   grid_shape=(num_devices,))

    @classmethod
    def torus2d(cls, nx: int, ny: int, link_gbps: float = TORUS_LINK_GBPS,
                name: str | None = None) -> "Topology":
        """2-D torus: every device has ±x, ±y ICI links (wraparound).

        For degenerate axes (size 2) the wraparound link is folded into the
        single neighbour link (doubled bandwidth), matching real ICI cabling.
        """
        links = _torus_links(nx, ny, link_gbps)
        return cls(nx * ny, links, name=name or f"torus{nx}x{ny}",
                   grid_shape=(nx, ny))

    @classmethod
    def hierarchical(cls, num_islands: int = 2, devices_per_island: int = 4,
                     *, intra: str = "mesh",
                     sublinks_per_pair: int = 2, sublink_gbps: float = 25.0,
                     torus_shape: tuple[int, int] | None = None,
                     intra_gbps: float = TORUS_LINK_GBPS,
                     inter_gbps: float = 12.5, inter_kind: str = "ib",
                     egress_per_island: int = 1,
                     name: str | None = None) -> "Topology":
        """Multi-node topology: islands of fast intra-node links joined by
        a slower inter-node tier (De Sensi et al.; DESIGN §3.1).

        Each island is either an NVLink full mesh (``intra="mesh"``,
        ``sublinks_per_pair`` × ``sublink_gbps`` per pair) or an ICI
        2-D torus (``intra="torus"`` with ``torus_shape``,
        ``intra_gbps``/link). The first ``egress_per_island`` devices of
        every island are its egress points: egress ``e`` of island ``a``
        links to egress ``e`` of island ``b`` (both directions, all island
        pairs, ``inter_kind``/``inter_gbps``) — so every cross-island
        route has exactly one inter-node hop, the invariant the planner's
        staged routing preserves. No host links: a shared host would be a
        hidden cross-island wormhole; add PCIe links explicitly if an
        experiment wants host staging.
        """
        if num_islands < 1:
            raise ValueError(f"num_islands must be >= 1, got {num_islands}")
        if devices_per_island < 1:
            raise ValueError(f"devices_per_island must be >= 1, "
                             f"got {devices_per_island}")
        if not 1 <= egress_per_island <= devices_per_island:
            raise ValueError(
                f"egress_per_island must be in [1, {devices_per_island}], "
                f"got {egress_per_island}")
        links: list[Link] = []
        for island in range(num_islands):
            base = island * devices_per_island
            if intra == "mesh":
                for a, b in itertools.permutations(
                        range(devices_per_island), 2):
                    for _ in range(sublinks_per_pair):
                        links.append(Link(base + a, base + b, "nvlink",
                                          sublink_gbps))
            elif intra == "torus":
                if torus_shape is None or (
                        torus_shape[0] * torus_shape[1]
                        != devices_per_island):
                    raise ValueError(
                        f"intra='torus' needs torus_shape with product "
                        f"{devices_per_island}, got {torus_shape}")
                links.extend(_torus_links(*torus_shape, intra_gbps,
                                          base=base))
            else:
                raise ValueError(f"unknown intra island kind {intra!r}")
        for a, b in itertools.permutations(range(num_islands), 2):
            for e in range(egress_per_island):
                links.append(Link(a * devices_per_island + e,
                                  b * devices_per_island + e,
                                  inter_kind, inter_gbps))
        assignment = [island for island in range(num_islands)
                      for _ in range(devices_per_island)]
        return cls(num_islands * devices_per_island, links,
                   name=name or f"hier{num_islands}x{devices_per_island}",
                   node_assignment=assignment)

    def coords(self, dev: int) -> tuple[int, ...]:
        """Grid coordinates of ``dev`` (2-D tori), else ``(dev,)``."""
        if self.grid_shape is None or len(self.grid_shape) != 2:
            return (dev,)
        ny = self.grid_shape[1]
        return (dev // ny, dev % ny)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"Topology(name={self.name!r}, devices={self.num_devices}, "
                f"islands={self.num_islands}, links={len(self._links)})")


def _torus_links(nx: int, ny: int, link_gbps: float,
                 base: int = 0) -> list[Link]:
    """ICI link list for a 2-D torus whose device ids start at ``base``."""
    links: list[Link] = []

    def dev(x: int, y: int) -> int:
        return base + (x % nx) * ny + (y % ny)

    for x in range(nx):
        for y in range(ny):
            s = dev(x, y)
            nbrs = []
            if nx > 1:
                nbrs += [dev(x + 1, y), dev(x - 1, y)]
            if ny > 1:
                nbrs += [dev(x, y + 1), dev(x, y - 1)]
            for n in nbrs:
                if n != s:
                    links.append(Link(s, n, "ici", link_gbps))
    return links
