"""Link-fault subsystem: injection, health monitoring, quarantine, and
the degraded-mode dispatch ladder (DESIGN §4.6).

A production multipath plan is only as good as its sickest link (De
Sensi et al. document per-link droop and intermittent failure that a
static topology model ignores). This module closes the loop over the
sensing and invalidation machinery the port already has:

* the **fault model** lives on
  :class:`repro_torch.core.topology.Topology` (``fail_link`` /
  ``degrade_link`` / ``restore_link`` / ``mark_flaky``) — every
  mutation bumps the plan epoch, so the §2.3 fast-path invalidation and
  the §4.4c calibration-shadow machinery do the cache work for free: no
  stale captured graph is ever replayed over a faulted link;
* :class:`FaultInjector` is the deterministic chaos harness
  (schedule/seed-driven: down-at-dispatch-N, droop-for-K-dispatches,
  flap, injected dispatch drops) usable from tests, benchmarks, and the
  ``REPRO_MP_FAULTS`` environment knob;
* :class:`HealthMonitor` watches the telemetry stream for per-link
  residuals against the calibrated §4.4 model, quarantines links that
  breach the droop threshold for M consecutive samples (via
  :meth:`repro_torch.comm.planner.PathPlanner.quarantine` — an
  epoch-bumping exclusion, so re-plans validate against the surviving
  link set), and re-admits them on consecutive healthy probes, each a
  captured ``multipath_dma`` send over exactly the probed link;
* the engine walks the documented **degradation ladder** (:data:`LADDER`:
  full multipath → surviving-paths multipath → single best path →
  staged host relay through pinned host memory), retrying with bounded
  exponential backoff and never raising to the caller until the ladder
  is exhausted (:class:`CommFaultError`); every successful dispatch
  preserves the §4.5 integrity invariants — degraded plans are
  validated exactly like healthy ones.
"""

from __future__ import annotations

import dataclasses
import random
import re
from typing import TYPE_CHECKING, Iterable, Sequence

import torch

from repro_torch.comm.cache import FastPathEntry
from repro_torch.comm.calibration import modeled_sample_time_s
from repro_torch.core.topology import HOST, Topology

if TYPE_CHECKING:  # pragma: no cover - typing only, avoids engine cycle
    from repro_torch.comm.engine import MultiPathTransfer
    from repro_torch.comm.planner import PathPlanner
    from repro_torch.comm.telemetry import DispatchSample

#: The §4.6 degradation ladder, least to most degraded. Rung 0 is the
#: full multipath plan as requested; rung 1 re-plans over the surviving
#: (non-failed, non-quarantined) links at the same path count; rung 2
#: falls back to the single best surviving path; rung 3 stages through
#: the host (PCIe round-trip — delivery over bandwidth). The engine
#: records the rung of the last successful dispatch in
#: ``HealthStats.ladder_level`` and only raises :class:`CommFaultError`
#: once every rung is exhausted — the never-raise-early contract.
LADDER = ("multipath", "surviving_multipath", "single_path", "staged_host")

_ACTIONS = ("fail", "degrade", "restore", "drop", "flap")

_SPEC = re.compile(
    r"^(?P<action>fail|degrade|restore|drop|flap)"
    r"@(?P<at>\d+)"
    r"(?:~(?P<period>\d+))?"
    r"(?:x(?P<count>\d+))?"
    r":(?P<src>-?\d+)-(?P<dst>-?\d+)"
    r"(?:\*(?P<ratio>[0-9.]+))?$")


class LinkFaultError(RuntimeError):
    """A dispatch hit a faulted link (injected drop, or an entry that
    still routes over a failed/quarantined link).

    Internal to the degraded dispatch loop: the engine catches it,
    quarantines ``links``, retries with backoff, and re-plans — it only
    escapes to the caller wrapped in :class:`CommFaultError` after the
    whole ladder is exhausted, preserving the §4.6 never-raise-early
    contract.
    """

    def __init__(self, links: Iterable[tuple[int, int]], reason: str):
        self.links = tuple(tuple(link) for link in links)
        self.reason = reason
        super().__init__(f"{reason}: links {self.links}")


class CommFaultError(RuntimeError):
    """The degradation ladder is exhausted: no surviving multipath,
    single-path, or host-staged route can deliver the request.

    Raised only after every :data:`LADDER` rung failed (the §4.6
    contract that degraded mode never gives up while any route
    survives); carries the per-rung failure history for diagnosis.
    """

    def __init__(self, message: str, history: Sequence[str] = ()):
        self.history = tuple(history)
        detail = ("; ".join(self.history)) if self.history else ""
        super().__init__(message + (f" [{detail}]" if detail else ""))


@dataclasses.dataclass
class HealthStats:
    """Engine-level degraded-mode counters (DESIGN §4.6), surfaced as
    the ``health`` section of ``session.stats()``.

    ``retries``/``replans``/``faults_seen``/``host_relays`` are windowed
    (zeroed by ``stats(reset=True)``, the windowed-stats contract);
    ``ladder_level`` is state — the :data:`LADDER` rung of the most
    recent successful dispatch — and survives a window reset, as does
    the ``events`` log (drained explicitly via
    ``session.drain_health_events()``).
    """

    retries: int = 0
    replans: int = 0
    faults_seen: int = 0
    host_relays: int = 0
    ladder_level: int = 0
    events: list = dataclasses.field(default_factory=list)

    def note(self, kind: str, **payload) -> None:
        """Append one health event (``{"kind": kind, **payload}``) to
        the log — the record ``ResilientTrainLoop`` drains so comm-layer
        faults surface in its event history instead of as opaque step
        exceptions (the §4.6 observability contract)."""
        self.events.append({"kind": kind, **payload})

    def reset_window(self) -> None:
        """Zero the windowed counters (retries/replans/faults_seen/
        host_relays) while preserving ``ladder_level`` and the event
        log — the same windowed-vs-state split ``PlanLifecycle``
        validates for its own counters."""
        self.retries = 0
        self.replans = 0
        self.faults_seen = 0
        self.host_relays = 0

    def snapshot(self, quarantined: int, enabled: bool) -> dict:
        """The stats-schema dict for this window. ``quarantined`` is the
        current planner quarantine count and ``enabled`` whether a
        monitor is attached — both state, not windowed; the returned
        shape is pinned by test_fastpath's stats-shape contract."""
        return {"enabled": enabled,
                "retries": self.retries,
                "replans": self.replans,
                "faults_seen": self.faults_seen,
                "host_relays": self.host_relays,
                "ladder_level": self.ladder_level,
                "quarantined_links": quarantined}


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault-model mutation, fired when the engine's
    dispatch counter reaches ``at`` (deterministic by construction — the
    injector's reproducibility contract).

    ``action`` is one of ``fail`` / ``degrade`` / ``restore`` / ``drop``;
    ``ratio`` is the droop factor for ``degrade``; ``duration`` is the
    auto-restore horizon for ``degrade`` (droop-for-K-dispatches) or the
    window length for ``drop`` (launches blamed on ``link`` for K
    dispatches, exercising the retry/backoff path).
    """

    at: int
    action: str
    link: tuple[int, int]
    ratio: float = 0.0
    duration: int = 0

    def __post_init__(self) -> None:
        if self.action not in ("fail", "degrade", "restore", "drop"):
            raise ValueError(f"unknown fault action {self.action!r}")
        if self.at < 0:
            raise ValueError(f"negative dispatch index {self.at}")
        if self.action == "degrade" and not 0.0 < self.ratio <= 1.0:
            raise ValueError(f"degrade ratio must be in (0, 1], "
                             f"got {self.ratio}")


class FaultInjector:
    """Deterministic chaos harness: applies a schedule of
    :class:`FaultEvent` mutations keyed on the engine's dispatch
    counter.

    The injector is the *only* nondeterminism-free way to exercise the
    §4.6 degraded path: given the same schedule (or the same seed via
    :meth:`seeded`) and the same traffic, every run fails, droops, and
    drops the same links at the same dispatches — the reproducibility
    contract chaos tests and the ``REPRO_MP_FAULTS`` env knob rely on.
    Attached to an engine (``session`` wires it from
    ``CommConfig.faults``), ``on_dispatch`` fires due events before each
    dispatch resolves, so the epoch bump always precedes the re-plan and
    no stale executable is validated against the mutated topology.
    """

    def __init__(self, events: Iterable[FaultEvent] = ()):
        self._events = sorted(events, key=lambda e: e.at)
        self._idx = 0
        self._drops: list[tuple[int, int, tuple[int, int]]] = []
        self.applied: list[dict] = []

    @classmethod
    def from_spec(cls, spec: str) -> "FaultInjector":
        """Parse the ``REPRO_MP_FAULTS`` grammar into an injector.

        Entries are ``;``/``,``-separated, each
        ``ACTION@AT[~PERIOD][xCOUNT]:SRC-DST[*RATIO]``:

        * ``fail@12:0-1`` — link (0, 1) down at dispatch 12;
        * ``degrade@20x8:2-3*0.25`` — droop (2, 3) to 25 % nominal at
          dispatch 20, auto-restore 8 dispatches later;
        * ``restore@40:0-1`` — restore (0, 1) at dispatch 40;
        * ``drop@5x2:0-1`` — blame launches on (0, 1) for 2 dispatches
          starting at 5 (exercises retry/backoff without a topology
          mutation);
        * ``flap@30~4x3:0-1`` — 3 fail/restore cycles of period 4
          starting at dispatch 30 (the flaky-link mode).

        Raises ``ValueError`` on malformed entries — a chaos schedule
        that silently half-parses would invalidate the determinism
        contract.
        """
        events: list[FaultEvent] = []
        for raw in re.split(r"[;,]", spec):
            raw = raw.strip()
            if not raw:
                continue
            m = _SPEC.match(raw)
            if m is None:
                raise ValueError(
                    f"malformed fault spec entry {raw!r}; expected "
                    f"ACTION@AT[~PERIOD][xCOUNT]:SRC-DST[*RATIO] with "
                    f"ACTION in {_ACTIONS}")
            action = m.group("action")
            at = int(m.group("at"))
            link = (int(m.group("src")), int(m.group("dst")))
            count = int(m.group("count") or 1)
            period = m.group("period")
            ratio = float(m.group("ratio") or 0.0)
            if action == "flap":
                if period is None:
                    raise ValueError(
                        f"flap entry {raw!r} needs a ~PERIOD")
                step = int(period)
                for cycle in range(count):
                    t = at + 2 * cycle * step
                    events.append(FaultEvent(t, "fail", link))
                    events.append(FaultEvent(t + step, "restore", link))
            elif action == "degrade":
                events.append(FaultEvent(at, "degrade", link, ratio=ratio,
                                         duration=count if count > 1
                                         else 0))
            elif action == "drop":
                events.append(FaultEvent(at, "drop", link, duration=count))
            else:
                events.append(FaultEvent(at, action, link))
        return cls(events)

    @classmethod
    def seeded(cls, topology: Topology, seed: int, *, events: int = 2,
               start: int = 2, spacing: int = 6) -> "FaultInjector":
        """Seed-driven schedule: ``events`` fail/restore cycles over
        device-device links chosen by ``random.Random(seed)``.

        Deterministic for a (topology digest, seed) pair — the same
        seed always faults the same links at the same dispatches, the
        property chaos tests' reproducibility contract.
        """
        rng = random.Random(seed)
        keys = sorted(k for k in topology.links
                      if HOST not in k)
        if not keys:
            raise ValueError("topology has no device-device links to fault")
        out: list[FaultEvent] = []
        t = start
        for _ in range(events):
            link = keys[rng.randrange(len(keys))]
            out.append(FaultEvent(t, "fail", link))
            out.append(FaultEvent(t + max(1, spacing // 2), "restore", link))
            t += spacing
        return cls(out)

    @property
    def active(self) -> bool:
        """True while events are still pending or a drop window may be
        live — the engine's hazard gate: an exhausted injector costs the
        healthy dispatch path nothing beyond one boolean (the
        zero-overhead-off contract health monitoring shares with
        telemetry)."""
        return self._idx < len(self._events) or bool(self._drops)

    def on_dispatch(self, engine: "MultiPathTransfer") -> list[dict]:
        """Apply every event due at the engine's current dispatch count.

        Fires *before* the dispatch resolves, so the topology epoch bump
        invalidates the fast path ahead of planning — the injector can
        never make the engine validate a stale executable against a
        mutated link set. Unapplicable events (failing an already-failed
        link, restoring a healthy one) are recorded as skipped rather
        than raised: a chaos schedule races real recovery by design.
        Returns the events applied this call.
        """
        fired: list[dict] = []
        topo = engine.topology
        while (self._idx < len(self._events)
               and self._events[self._idx].at <= engine.dispatches):
            ev = self._events[self._idx]
            self._idx += 1
            record = {"kind": "inject", "action": ev.action,
                      "link": ev.link, "at": ev.at,
                      "dispatch": engine.dispatches}
            try:
                if ev.action == "fail":
                    topo.fail_link(*ev.link)
                elif ev.action == "restore":
                    topo.restore_link(*ev.link)
                elif ev.action == "degrade":
                    topo.degrade_link(*ev.link, ev.ratio)
                    if ev.duration:
                        self._push(FaultEvent(ev.at + ev.duration,
                                              "restore", ev.link))
                elif ev.action == "drop":
                    self._drops.append(
                        (ev.at, ev.at + max(1, ev.duration), ev.link))
            except KeyError:
                record["skipped"] = True
            fired.append(record)
            self.applied.append(record)
            engine.health.faults_seen += 1
            engine.health.note(**record)
        return fired

    def _push(self, event: FaultEvent) -> None:
        """Insert a follow-up event (droop auto-restore) keeping the
        schedule sorted by dispatch index."""
        self._events.append(event)
        self._events.sort(key=lambda e: e.at)
        if self._idx and self._events[self._idx - 1].at > event.at:
            # Never resurrect already-applied events; the pointer only
            # needs to stay behind unapplied ones.
            self._idx -= 1

    def dropped_link(self, dispatch: int,
                     links: Iterable[tuple[int, int]]
                     ) -> tuple[int, int] | None:
        """The link an active drop window blames for this dispatch, or
        ``None``. Expired windows are pruned; a drop only fires when its
        link is actually part of the entry being launched — an injected
        NIC timeout on a link the plan does not use must not fail the
        dispatch (the blame-attribution invariant retries rely on)."""
        self._drops = [d for d in self._drops if d[1] > dispatch]
        link_set = set(links)
        for start, end, link in self._drops:
            if start <= dispatch < end and link in link_set:
                return link
        return None


class HealthMonitor:
    """Telemetry-driven link health: droop detection, quarantine, and
    probe-based re-admission (DESIGN §4.6).

    ``observe`` prices each
    :class:`~repro_torch.comm.telemetry.DispatchSample` against the §4.4
    model (:func:`repro_torch.comm.calibration.modeled_sample_time_s`,
    calibrated overlay included) and attributes the measured/modeled
    residual to the sample's links; a link breaching ``droop_threshold`` for
    ``droop_samples`` consecutive samples is quarantined through the
    planner (an epoch-bumping exclusion — every cached plan over the
    link is invalidated, the §4.6 safety contract). Residual watching
    requires an attached calibration profile by default
    (``require_calibration``): residuals against nominal constants on a
    different machine are noise, and auto-quarantine from noise would
    violate the do-no-harm contract. Re-admission is probe-based:
    ``probe_healthy`` consecutive healthy probes (``flaky_factor`` ×
    more for links marked flaky) readmit the link, restoring the
    pre-fault plan digest in steady state.
    """

    def __init__(self, topology: Topology, planner: "PathPlanner", *,
                 droop_threshold: float = 2.0, droop_samples: int = 3,
                 probe_healthy: int = 2, recovery_ratio: float = 0.5,
                 probe_interval: int = 16, flaky_factor: int = 2,
                 require_calibration: bool = True):
        self.topology = topology
        self.planner = planner
        self.droop_threshold = float(droop_threshold)
        self.droop_samples = int(droop_samples)
        self.probe_healthy = int(probe_healthy)
        self.recovery_ratio = float(recovery_ratio)
        self.probe_interval = int(probe_interval)
        self.flaky_factor = int(flaky_factor)
        self.require_calibration = bool(require_calibration)
        self.events: list[dict] = []
        self.observed = 0
        self.quarantines = 0
        self.readmissions = 0
        self._streaks: dict[tuple[int, int], int] = {}
        self._probe_streaks: dict[tuple[int, int], int] = {}
        self._last_probe = -1

    @property
    def quarantined(self) -> frozenset:
        """The planner's live quarantine set — the monitor never keeps a
        private copy, so the exclusion the planner validates routes
        against and the set probes work through cannot diverge."""
        return self.planner.quarantined

    def quarantine_link(self, link: tuple[int, int], reason: str,
                        dispatch: int | None = None) -> bool:
        """Quarantine one link (idempotent) and log the event.

        Routed through :meth:`PathPlanner.quarantine`, so the epoch bump
        invalidates every fast-path entry over the link before the next
        resolve — the no-stale-executable contract. Returns True when
        the link was newly quarantined.
        """
        link = tuple(link)
        if link in self.planner.quarantined:
            return False
        self.planner.quarantine(link)
        self.quarantines += 1
        self._probe_streaks[link] = 0
        self.events.append({"kind": "quarantine", "link": link,
                            "reason": reason, "dispatch": dispatch})
        return True

    def observe(self, sample: "DispatchSample") -> float | None:
        """Price one dispatch sample against the calibrated model and
        update per-link droop streaks.

        Returns the measured/modeled ratio, or ``None`` when the sample
        cannot be judged (no calibration while ``require_calibration``,
        a captured step that runs kernels, or a degenerate modeled time).
        A step's measured time includes its kernels, which the model does
        not price: on healthy links it reads 12-16x (path I of
        ``chip_smoke.py``), so judging it quarantined every link of its
        routes and the next replay found no route. The reference judges
        it. A ratio above ``droop_threshold``
        bumps the streak of every link the sample crossed; hitting
        ``droop_samples`` consecutive breaches quarantines the link. A
        healthy sample resets its links' streaks — the M-*consecutive*
        contract, not M-cumulative.
        """
        if self.require_calibration and self.topology.calibration is None:
            return None
        if sample.compute:
            return None
        modeled = modeled_sample_time_s(sample, self.topology,
                                        self.topology.calibration)
        measured = sample.measured_s
        if modeled <= 0 or measured <= 0:
            return None
        self.observed += 1
        ratio = measured / modeled
        breach = ratio > self.droop_threshold
        for link in sample.links:
            if breach:
                streak = self._streaks.get(link, 0) + 1
                self._streaks[link] = streak
                if streak >= self.droop_samples:
                    self.quarantine_link(link, reason="droop")
            else:
                self._streaks.pop(link, None)
        return ratio

    def probe(self, link: tuple[int, int],
              engine: "MultiPathTransfer | None" = None,
              nelems: int = 256) -> bool:
        """Probe one link and feed the verdict to :meth:`note_probe`.

        The verdict is deterministic against the fault model: a failed
        or absent link is unhealthy; otherwise the link's *served*
        bandwidth (droop + calibration overlays included, read through
        ``Topology.link``) must be at least ``recovery_ratio`` × nominal
        — and, when an engine is given, a small single-path transfer
        routed over exactly this link (quarantine bypassed via
        ``admit_quarantined``) must deliver its payload intact. Returns
        the verdict.
        """
        link = tuple(link)
        state = self.topology.link_state(*link)
        if state in ("failed", "absent"):
            ok = False
        else:
            served = self.topology.link(*link)
            nominal = self.topology.links[link]
            ok = (served is not None
                  and served.bandwidth_gbps
                  >= self.recovery_ratio * nominal.bandwidth_gbps)
            if ok and engine is not None and HOST not in link:
                ok = self._probe_transfer(engine, link, nelems)
        self.note_probe(link, ok)
        return ok

    def _probe_transfer(self, engine: "MultiPathTransfer",
                        link: tuple[int, int], nelems: int) -> bool:
        """One captured single-path send over exactly ``link`` with the
        quarantine exclusion lifted; healthy iff the payload arrives
        intact (compared element-wise). The program is looked up under the
        engine's placed key, so a later send of the same plan is a cache
        hit on either layout; the payload starts on ``src``'s device and is
        compared on the device the copy arrived on."""
        src, dst = link
        dtype = torch.float32
        plan = engine.planner.plan(
            src, dst, nelems * dtype.itemsize, max_paths=1,
            include_host=False, granularity=dtype.itemsize,
            admit_quarantined=True)
        hops = plan.paths[0].route.directional_links()
        if len(plan.paths) != 1 or hops != (link,):
            # The direct link was not admitted (e.g. raced a fail_link);
            # the model verdict above stands on its own.
            return True
        graph, chosen = engine._group_graph((plan,), 1, "round_robin")
        shapes = ((nelems, dtype),)
        key = engine._group_key(graph, (plan,), shapes, 1)
        compiled = engine.cache.get_or_build(
            engine._placed(key),
            lambda: engine._compile_group(key, graph, shapes))
        entry = FastPathEntry(plans=(plan,), graph=graph,
                              digest=key.digest, key=key,
                              compiled=compiled, schedule=chosen)
        msg = torch.arange(nelems, dtype=dtype, device=engine._home(src))
        out = engine._launch(entry, [msg], block=True)[0]
        return bool(torch.equal(out, msg.to(out.device)))

    def note_probe(self, link: tuple[int, int], ok: bool) -> None:
        """Fold one probe verdict into the re-admission streak.

        ``probe_healthy`` consecutive healthy probes (× ``flaky_factor``
        for links marked flaky — the hysteresis contract against
        flapping) readmit the link through the planner, bumping the
        epoch so steady-state plans return to the full route set; a
        failed probe resets the streak.
        """
        link = tuple(link)
        if link not in self.planner.quarantined:
            return
        if not ok:
            self._probe_streaks[link] = 0
            self.events.append({"kind": "probe_failed", "link": link})
            return
        streak = self._probe_streaks.get(link, 0) + 1
        self._probe_streaks[link] = streak
        needed = self.probe_healthy * (
            self.flaky_factor if link in self.topology.flaky_links else 1)
        self.events.append({"kind": "probe_ok", "link": link,
                            "streak": streak, "needed": needed})
        if streak >= needed:
            self.planner.readmit(link)
            self.readmissions += 1
            self._streaks.pop(link, None)
            self._probe_streaks.pop(link, None)
            self.events.append({"kind": "readmit", "link": link})

    def probe_all(self, engine: "MultiPathTransfer | None" = None,
                  nelems: int = 256) -> dict:
        """Probe every quarantined link once (sorted order — the
        deterministic sweep contract) and return ``{link: verdict}``."""
        return {link: self.probe(link, engine=engine, nelems=nelems)
                for link in sorted(self.planner.quarantined)}

    def maybe_probe(self, engine: "MultiPathTransfer") -> None:
        """Probe quarantined links at the ``probe_interval`` dispatch
        cadence — the engine's degraded dispatch loop calls this so
        re-admission needs no explicit operator action; a no-op (one
        comparison) when nothing is quarantined, preserving the
        zero-overhead-off contract."""
        if not self.planner.quarantined:
            return
        if engine.dispatches - self._last_probe < self.probe_interval:
            return
        self._last_probe = engine.dispatches
        self.probe_all(engine)

    def snapshot(self) -> dict:
        """JSON-able monitor state for ``session.describe()['health']``:
        quarantined links, droop/probe streaks, and lifetime counters —
        the observability surface the acceptance chaos tests validate."""
        return {
            "quarantined": [list(link)
                            for link in sorted(self.planner.quarantined)],
            "observed": self.observed,
            "quarantines": self.quarantines,
            "readmissions": self.readmissions,
            "droop_threshold": self.droop_threshold,
            "droop_samples": self.droop_samples,
            "probe_healthy": self.probe_healthy,
            "recovery_ratio": self.recovery_ratio,
        }
