"""Per-dispatch timeline telemetry — the measurement half of DESIGN §4.4c.

The §4.4 analytic model arbitrates schedules and path splits from
calibration constants; this module records what the machine *actually*
did so :mod:`repro_torch.comm.calibration` can fit those terms from evidence.
The engine attributes each dispatch's wall time to pipeline stages
(plan / lower / schedule / compile / staging / launch / execute) in a
:class:`StageTimings`, tags it with the route/chunk/schedule identity it
ran under (:class:`DispatchSample`), and appends it to a ring-buffered
:class:`TimelineRecorder`.

Every stage is host wall time. On a CUDA device ``launch`` is the
captured graph's ``replay()`` until control returns (the
``cudaGraphLaunch``) and ``execute`` the tail until the device
synchronize returns; ``staging`` is the host enqueue of the staging
copies, whose device time lands in ``execute``. On the CPU the plain
executor runs inside ``launch``, so ``execute`` reads about 0.

Contract (the observability invariant): telemetry is *passive*. Samples
are measurements only — they must never feed cache keys, plan digests,
or epoch tokens, and recording must preserve dispatch behaviour exactly.
When the recorder is disabled (the default; enable with
``REPRO_MP_TELEMETRY=1``) the engine's only cost is one boolean check
per dispatch, which is what keeps the §2.3 fast path's setup cost
unchanged.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Iterable

from repro_torch.comm.config import _env_bool

#: Environment toggle read by :class:`TimelineRecorder` when ``enabled``
#: is not given explicitly. Off by default — the zero-overhead contract.
TELEMETRY_ENV = "REPRO_MP_TELEMETRY"

#: Default ring capacity: old samples are dropped, never the dispatch.
DEFAULT_CAPACITY = 2048

#: Stage names in pipeline order — the attribution schema (§4.4c).
STAGES = ("plan", "lower", "schedule", "compile", "staging", "launch",
          "execute")


@dataclasses.dataclass
class StageTimings:
    """Wall time of one dispatch attributed to pipeline stages, in ns.

    The attribution invariant: every field is measured around exactly one
    stage of the §2.3 dispatch pipeline, so ``plan+lower+schedule+compile``
    is the (fast-path-skippable) setup cost and ``staging+launch+execute``
    the per-dispatch cost. Fast-path hits preserve zeros in the setup
    fields — that is evidence, not a gap. Mutable on purpose: the engine
    fills stages in as the dispatch proceeds, then freezes the result
    into a :class:`DispatchSample`.
    """

    plan_ns: int = 0      # planner: route enumeration + path split
    lower_ns: int = 0     # graph lowering (plan -> copy-node DAG)
    schedule_ns: int = 0  # scheduler pass (§2.2 pipeline)
    compile_ns: int = 0   # table build + capture + instantiate (build_ns)
    staging_ns: int = 0   # host enqueue of the staging copies
    launch_ns: int = 0    # graph replay until control returns
    execute_ns: int = 0   # device-synchronize tail after the replay

    @property
    def total_ns(self) -> int:
        """Sum over every stage — the invariant check that attribution
        covers the dispatch: stages are disjoint, so their sum is the
        attributed wall time."""
        return (self.plan_ns + self.lower_ns + self.schedule_ns
                + self.compile_ns + self.staging_ns + self.launch_ns
                + self.execute_ns)

    def as_dict(self) -> dict[str, int]:
        """Stage name -> ns, in :data:`STAGES` order — the stable schema
        contract that ``session.describe()`` / ``--json`` benchmark rows
        serialize."""
        return {name: getattr(self, f"{name}_ns") for name in STAGES}


@dataclasses.dataclass(frozen=True)
class DispatchSample:
    """One dispatch's identity + measured stage timings (frozen record).

    ``routes`` is the per-message, per-path shape the calibration fitter
    prices: each path is ``(directional_links, nbytes, num_chunks)``.
    The identity invariant: two samples with equal :attr:`signature` ran
    the *same* routed/chunked/scheduled transfer, so the fitter may pool
    them (warmup dropping, medians) — the sample must therefore preserve
    everything the §4.4 model needs to re-price it, and nothing tied to
    live objects (no plans, no graphs, no topology references).

    ``compute`` is the compute-node identity of a captured-step dispatch
    — one ``(kernel, flops, cost_ns)`` triple per
    :class:`~repro_torch.comm.graph.ComputeNode` — and is part of
    :attr:`signature`, so the calibration fitter can never pool a
    captured-step sample (whose execute time includes kernel work) with
    a pure-comm sample of the same route shape.
    """

    routes: tuple[tuple[tuple[tuple[tuple[int, int], ...], int, int],
                        ...], ...]
    nbytes: int
    num_nodes: int
    window: int
    schedule: str
    stages: StageTimings
    fastpath_hit: bool
    compute: tuple[tuple[str, int, int], ...] = ()

    @property
    def signature(self) -> tuple:
        """Hashable pooling key ``(routes, window, schedule, compute)``
        — the contract key the fitter groups warmup/median statistics
        by. Compute identity keeps captured-step samples apart from
        pure-comm samples with the same routes (§4.4c invariant)."""
        return (self.routes, self.window, self.schedule, self.compute)

    @property
    def num_paths(self) -> int:
        """Total path count across the sample's messages (validates the
        §4.4 sync-per-path pricing against the recorded shape)."""
        return sum(len(msg) for msg in self.routes)

    @property
    def links(self) -> tuple[tuple[int, int], ...]:
        """Sorted distinct directional links the sample exercised — the
        per-link attribution domain the bandwidth fitter updates."""
        seen = {ln for msg in self.routes for (lns, _, _) in msg
                for ln in lns}
        return tuple(sorted(seen))

    @property
    def measured_s(self) -> float:
        """Measured end-to-end dispatch seconds (launch + execute) — the
        quantity modeled estimates are validated against."""
        return (self.stages.launch_ns + self.stages.execute_ns) / 1e9


class TimelineRecorder:
    """Ring-buffered dispatch-sample sink with a hard zero-cost-off contract.

    * **Off** (default, or ``REPRO_MP_TELEMETRY`` falsy): :attr:`enabled`
      is ``False`` and :meth:`record` is never even called by the engine
      — the dispatch path pays one boolean check. This invariant is what
      the CI overhead smoke assertion enforces.
    * **On**: samples append to a bounded ``deque``; when full, the
      *oldest* sample is dropped (counted in :attr:`dropped`) so memory
      stays bounded on long-running sessions. Recording never raises into
      the dispatch path and never mutates the sample.
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 enabled: bool | None = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self.capacity = capacity
        self.enabled = (_env_bool(TELEMETRY_ENV, False)
                        if enabled is None else bool(enabled))
        self._ring: deque[DispatchSample] = deque(maxlen=capacity)
        self._kernels: dict[str, deque[float]] = {}
        self.recorded = 0
        self.dropped = 0
        #: Optional observer fired with each recorded sample — the hook
        #: the health monitor's droop detection rides (DESIGN §4.6). It
        #: runs AFTER the enabled check, preserving the zero-cost-off
        #: contract, and its exceptions are swallowed: observation must
        #: never fail a dispatch.
        self.on_record = None

    def record(self, sample: DispatchSample) -> None:
        """Append one sample (no-op while disabled). Preserves the ring
        bound: at capacity the oldest sample is evicted and counted in
        :attr:`dropped` — the dispatch is never blocked or failed. Fires
        :attr:`on_record` (when set) with the sample; observer errors
        are contained here."""
        if not self.enabled:
            return
        if len(self._ring) == self._ring.maxlen:
            self.dropped += 1
        self._ring.append(sample)
        self.recorded += 1
        if self.on_record is not None:
            try:
                self.on_record(sample)
            except Exception:
                pass  # observation must never fail the dispatch

    def record_kernel(self, name: str, execute_ns: float) -> None:
        """Append one per-kernel execute measurement (no-op while
        disabled — the same zero-cost-off contract as :meth:`record`).
        Measurements accumulate per kernel name in bounded rings
        (``capacity`` each, oldest dropped) so the calibration fitter
        can replace the ``COMPUTE_GFLOPS`` guess with a fitted
        per-kernel compute term. Non-positive durations are ignored —
        a clock misread must never poison the fit."""
        if not self.enabled:
            return
        if execute_ns <= 0:
            return
        ring = self._kernels.get(name)
        if ring is None:
            ring = self._kernels[name] = deque(maxlen=self.capacity)
        ring.append(float(execute_ns))

    def kernel_samples(self) -> dict[str, tuple[float, ...]]:
        """Snapshot ``{kernel name: (execute_ns, ...)}`` oldest first —
        the evidence channel ``CalibrationFitter.fit(kernels=...)``
        consumes. Deliberately separate from :meth:`samples`: kernel
        timings are compute-side measurements and must never pool with
        transfer-stage :class:`DispatchSample` records (§4.4c)."""
        return {name: tuple(ring) for name, ring in self._kernels.items()
                if ring}

    def kernel_cost_ns(self, name: str) -> float:
        """Median recorded execute time for ``name`` in ns, or ``0.0``
        when nothing was recorded — the value capture adopters stamp
        into ``ComputeNode.cost_ns`` so the lane model prices measured
        rather than guessed kernel durations."""
        ring = self._kernels.get(name)
        if not ring:
            return 0.0
        ordered = sorted(ring)
        mid = len(ordered) // 2
        if len(ordered) % 2:
            return ordered[mid]
        return (ordered[mid - 1] + ordered[mid]) / 2.0

    def samples(self) -> tuple[DispatchSample, ...]:
        """Snapshot of retained samples, oldest first (chronological —
        the order the fitter's exponential-decay update contract
        requires)."""
        return tuple(self._ring)

    def clear(self) -> None:
        """Drop retained samples and zero the counters (the windowed
        ``stats(reset=True)`` semantics; capacity/enabled preserved).
        Per-kernel execute rings are cleared too."""
        self._ring.clear()
        self._kernels.clear()
        self.recorded = 0
        self.dropped = 0

    def stats(self) -> dict:
        """Counter snapshot ``{enabled, capacity, retained, recorded,
        dropped}`` — the stable schema ``session.stats()`` embeds."""
        return {"enabled": self.enabled, "capacity": self.capacity,
                "retained": len(self._ring), "recorded": self.recorded,
                "dropped": self.dropped}

    def extend(self, samples: Iterable[DispatchSample]) -> None:
        """Bulk :meth:`record` (test/benchmark convenience; preserves
        the same ring-bound and disabled-no-op contract)."""
        for s in samples:
            self.record(s)

    def __len__(self) -> int:
        return len(self._ring)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"TimelineRecorder(enabled={self.enabled}, "
                f"retained={len(self._ring)}/{self.capacity}, "
                f"recorded={self.recorded})")
