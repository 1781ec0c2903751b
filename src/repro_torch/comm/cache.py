"""TransferPlanCache — the CUDA-Graph cache (paper §4.2).

The paper caches instantiated ``cudaGraphExec_t`` objects in a fixed-size
LRU hash table keyed on (src, dst, size, path config). The port does the
same: a :class:`CompiledPlan` holds one scheduled transfer graph made
resident as a :class:`~repro_torch.kernels.multipath_dma.kernel.DmaProgram`
(a :class:`~repro_torch.kernels.multipath_dma.kernel.PeerDmaProgram` over
peer cards) and, on CUDA, its one-kernel ``torch.cuda.CUDAGraph`` (one a
card over peers):

=================  ==============================================
paper (CUDA)       this port
=================  ==============================================
creation           building the kernel's work table (``trace_ns``)
construction       warm-up launch + stream capture (``lower_ns``)
instantiation      graph instantiation + first replay (``compile_ns``)
launch             ``CUDAGraph.replay`` (``launches``)
=================  ==============================================

On the CPU a :class:`CompiledPlan` wraps the eager plain executor and
keeps the same fields (the capture stages read 0).

Steady-state dispatch additionally fronts this cache with a
:class:`FastPathCache` (DESIGN.md §2.3): entries memoize the *entire*
plan→lower→schedule→digest pipeline keyed on the request signature and an
explicit planner/topology epoch, so a repeat transfer is one dict lookup +
one staging write + one graph replay.
"""

from __future__ import annotations

import dataclasses
import time
from collections import OrderedDict
from typing import Any, Callable, Hashable

from repro_torch.comm.config import _env_int


@dataclasses.dataclass
class PlanLifecycle:
    """Nanosecond timings of each lifecycle stage for one cached plan.

    The per-stage attribution the paper's Fig. 13/14 overhead analysis
    needs (and ucTrace-style layered profiling motivates): build stages
    are one-time, ``launches``/``total_launch_ns`` accumulate steady
    state, ``staging_ns`` isolates the host-side *dispatch* of operand
    staging (staging execution overlaps the launch via dataflow and is
    accounted in the launch timings), and ``fastpath_hits`` counts
    dispatches that skipped the whole plan→lower→digest pipeline.
    Timings are measurements, not semantics — they carry no §4.5
    invariant obligations and must never feed cache keys (digest-derived
    keys only).
    """

    trace_ns: int = 0        # work-table build ("creation")
    lower_ns: int = 0        # warm-up + capture ("construction")
    compile_ns: int = 0      # instantiation + first replay
    launches: int = 0
    total_launch_ns: int = 0
    num_nodes: int = 0       # copy-node count (chunks × hops)
    #: Dispatches of this executable served by the FastPathCache — the
    #: launches whose setup cost was one dict lookup.
    fastpath_hits: int = 0
    #: Cumulative nanoseconds spent dispatching operand staging (host-
    #: side enqueue) across every launch of this executable.
    staging_ns: int = 0
    #: Launch attempts of this executable that raised a link fault and
    #: were retried on a re-planned route (DESIGN §4.6). Windowed like
    #: ``launches``; a healthy window reports 0.
    retries: int = 0

    @property
    def build_ns(self) -> int:
        """One-time cost: table build + capture + instantiation (the
        paper's graph creation/construction/instantiation, amortized over
        launches)."""
        return self.trace_ns + self.lower_ns + self.compile_ns

    @property
    def mean_launch_ns(self) -> float:
        """Steady-state cost per launch (0.0 before the first launch)."""
        return self.total_launch_ns / self.launches if self.launches else 0.0

    def reset_window(self) -> None:
        """Zero the *per-window* accumulators (launches,
        ``total_launch_ns``, ``staging_ns``, ``fastpath_hits``,
        ``retries``) so
        long-running sessions can report rates instead of lifetime sums
        — the ``stats(reset=True)`` windowed-counter contract. The
        one-time build timings (trace/lower/compile) are preserved:
        they are identity facts of the executable, not a window."""
        self.launches = 0
        self.total_launch_ns = 0
        self.staging_ns = 0
        self.fastpath_hits = 0
        self.retries = 0


@dataclasses.dataclass
class CompiledPlan:
    """An instantiated transfer graph: the resident program, its captured
    CUDA graph (on a CUDA device), and lifecycle stats.

    The ``cudaGraphExec_t`` analogue. ``key`` must be digest-derived
    (:class:`~repro_torch.comm.engine.GroupKey`, placed on its cards over
    peers) so the graph can never outlive the graph identity it was
    captured for. ``program`` is a
    :class:`~repro_torch.kernels.multipath_dma.kernel.DmaProgram` (a
    ``PeerDmaProgram`` over peer cards: every call spans its cards); its
    operand and output buffers are static — every replay reads and
    overwrites the same memory, so callers copy results out before the
    next replay.
    """

    key: Hashable
    program: Any             # repro_torch.kernels.multipath_dma DmaProgram
    lifecycle: PlanLifecycle

    def inputs(self) -> list:
        """The static operand views, ``(window, num_devices, nelems)``
        (over peer cards, one ``(window, nelems)`` view a logical device
        for each message, ``None`` where the table reads none)."""
        return self.program.inputs()

    def outputs(self) -> list:
        """The static output views, overwritten by every replay."""
        return self.program.outputs()

    def _sync(self) -> None:
        self.program.synchronize()

    def _stage(self, args) -> None:
        for buf, arg in zip(self.inputs(), args):
            if isinstance(buf, list):
                for b, a in zip(buf, arg):
                    if b is not None:     # else the table reads none there
                        b.copy_(a)
            else:
                buf.copy_(arg)

    def __call__(self, *args):
        """Copy ``args`` (if any) into the static operands, replay once
        and wait for it; returns the static output views."""
        t0 = time.perf_counter_ns()
        self._stage(args)
        self.program.replay()
        self._sync()
        self.lifecycle.launches += 1
        self.lifecycle.total_launch_ns += time.perf_counter_ns() - t0
        return self.outputs()

    def dispatch(self, *args):
        """Launch without waiting (pure launch-overhead measurement)."""
        t0 = time.perf_counter_ns()
        self._stage(args)
        self.program.replay()
        self.lifecycle.launches += 1
        self.lifecycle.total_launch_ns += time.perf_counter_ns() - t0
        return self.outputs()

    def timed_call(self, *args) -> tuple[list, int, int]:
        """:meth:`__call__` with its wall time split into ``(outputs,
        launch_ns, execute_ns)`` for telemetry (§4.4c): launch is the
        staging of ``args`` plus ``replay()`` until control returns (on a
        CUDA device the ``cudaGraphLaunch``), execute the tail until the
        device synchronize returns. Both are host clock: the fitter
        regresses wall time. Lifecycle accounting is that of
        :meth:`__call__` (one launch, total = launch + execute)."""
        t0 = time.perf_counter_ns()
        self._stage(args)
        self.program.replay()
        t1 = time.perf_counter_ns()
        self._sync()
        t2 = time.perf_counter_ns()
        self.lifecycle.launches += 1
        self.lifecycle.total_launch_ns += t2 - t0
        return self.outputs(), t1 - t0, t2 - t1


def compile_plan(key: Hashable, build: Callable[[], Any],
                 num_nodes: int = 0) -> CompiledPlan:
    """Run the whole lifecycle with per-stage timing: ``build()`` makes the
    resident program (creation), then on a CUDA device the program is
    warmed up, captured and instantiated, and replayed once."""
    life = PlanLifecycle(num_nodes=num_nodes)
    t0 = time.perf_counter_ns()
    program = build()
    life.trace_ns = time.perf_counter_ns() - t0
    if program.device.type == "cuda":
        life.lower_ns, inst_ns = program.capture()
        t1 = time.perf_counter_ns()
        program.replay()
        program.synchronize()
        life.compile_ns = inst_ns + time.perf_counter_ns() - t1
    return CompiledPlan(key, program, life)


class TransferPlanCache:
    """Fixed-capacity LRU cache of :class:`CompiledPlan` objects.

    Capacity defaults to ``REPRO_PLAN_CACHE_SIZE`` (paper: tunable via
    environment variables). Eviction counts are exposed for the overhead
    analysis: an eviction forces a re-instantiation on the next use, the
    dominant first-iteration cost. Keys must be digest-derived
    (§2.2: schedules digest apart, so two dispatch orders of one plan can
    never cross-serve executables); the cache itself never inspects
    them.
    """

    def __init__(self, capacity: int | None = None):
        self.capacity = capacity if capacity is not None else _env_int(
            "REPRO_PLAN_CACHE_SIZE", 64)
        if self.capacity <= 0:
            raise ValueError("cache capacity must be positive")
        self._store: OrderedDict[Hashable, CompiledPlan] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._store

    def get(self, key: Hashable) -> CompiledPlan | None:
        """Look up a compiled plan, counting the hit/miss and refreshing
        LRU recency."""
        plan = self._store.get(key)
        if plan is None:
            self.misses += 1
            return None
        self._store.move_to_end(key)
        self.hits += 1
        return plan

    def put(self, key: Hashable, plan: CompiledPlan) -> None:
        """Insert (or refresh) an entry, evicting the LRU tail past
        capacity."""
        if key in self._store:
            self._store.move_to_end(key)
        self._store[key] = plan
        if len(self._store) > self.capacity:
            self._store.popitem(last=False)
            self.evictions += 1

    def get_or_build(self, key: Hashable,
                     builder: Callable[[], CompiledPlan]) -> CompiledPlan:
        """LaunchGraph's lookup-or-create (Algorithm 1 lines 25–28)."""
        plan = self.get(key)
        if plan is None:
            plan = builder()
            self.put(key, plan)
        return plan

    def keys(self) -> list[Hashable]:
        """Current keys, least-recently-used first (eviction order)."""
        return list(self._store)

    def values(self) -> list[CompiledPlan]:
        """Current programs in the order of :meth:`keys`; reading them
        counts no hit and moves nothing."""
        return list(self._store.values())

    def stats(self, reset: bool = False) -> dict[str, int]:
        """Hit/miss/eviction counters plus current size and capacity.

        ``reset=True`` returns the snapshot then zeroes the counters and
        every cached plan's windowed lifecycle accumulators
        (:meth:`PlanLifecycle.reset_window`) — the windowed-stats
        contract for long-running sessions. Entries themselves are
        preserved: resetting a window must never force a rebuild."""
        out = {"hits": self.hits, "misses": self.misses,
               "evictions": self.evictions, "size": len(self._store),
               "capacity": self.capacity}
        if reset:
            self.hits = self.misses = self.evictions = 0
            for plan in self._store.values():
                plan.lifecycle.reset_window()
        return out

    def clear(self) -> None:
        """Drop every entry (counters are kept; they are cumulative —
        use ``stats(reset=True)`` for windowed counters)."""
        self._store.clear()


@dataclasses.dataclass
class FastPathEntry:
    """One memoized resolution of the plan→lower→schedule→digest pipeline.

    Everything steady-state dispatch needs without re-running any setup
    stage: the resolved plans, the SCHEDULED transfer graph (kept so
    ``REPRO_MP_VALIDATE=always`` can re-run ``graph.validate()`` on
    hits), its post-pass digest, the digest-derived plan-cache key, the
    compiled executable, and the concrete schedule name that was chosen.
    The §4.5 invariants were checked when the entry was built; the epoch
    stamp in :class:`FastPathCache` is what keeps that check valid —
    served entries are byte-identical to what the slow path would
    rebuild, or they are invalidated.
    """

    plans: tuple            # tuple[TransferPlan, ...]
    graph: Any              # the scheduled TransferGraph
    digest: str             # post-pass graph digest (cache-key ingredient)
    key: Hashable           # the GroupKey the executable is cached under
    compiled: CompiledPlan
    schedule: str           # concrete scheduler name resolved at build


class FastPathCache:
    """Front cache for steady-state dispatch (DESIGN.md §2.3).

    Maps a *request signature* — ``(mode, (src, dst, nelems, dtype)…,
    window, schedule name, planner knobs, device count)`` — to a
    :class:`FastPathEntry`, each stamped with the
    :attr:`~repro.comm.planner.PathPlanner.epoch` in force when it was
    built. Lookups compare the stamp against the live epoch: a mismatch
    (any planner/topology mutation since) drops the entry and counts an
    ``invalidation``, so a stale plan can never be served — the §4.5
    validity of a served entry is exactly the validity of its epoch.
    LRU-bounded like the plan cache; entries hold strong references to
    their executables, so eviction order follows use order.
    """

    def __init__(self, capacity: int = 256):
        if capacity <= 0:
            raise ValueError("fast-path cache capacity must be positive")
        self.capacity = capacity
        self._store: OrderedDict[Hashable,
                                 tuple[tuple, FastPathEntry]] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._store)

    def __contains__(self, signature: Hashable) -> bool:
        return signature in self._store

    def get(self, signature: Hashable, epoch: tuple) -> FastPathEntry | None:
        """Return the entry for ``signature`` iff its epoch stamp matches
        the live ``epoch``; a stale stamp is dropped and counted as an
        invalidation (plus a miss — the caller re-plans)."""
        rec = self._store.get(signature)
        if rec is None:
            self.misses += 1
            return None
        stamped, entry = rec
        if stamped != epoch:
            del self._store[signature]
            self.invalidations += 1
            self.misses += 1
            return None
        self._store.move_to_end(signature)
        self.hits += 1
        return entry

    def put(self, signature: Hashable, epoch: tuple,
            entry: FastPathEntry) -> None:
        """Memoize a freshly-built resolution under its epoch stamp,
        evicting the LRU tail past capacity."""
        if signature in self._store:
            self._store.move_to_end(signature)
        self._store[signature] = (epoch, entry)
        if len(self._store) > self.capacity:
            self._store.popitem(last=False)
            self.evictions += 1

    def stats(self, reset: bool = False) -> dict[str, int]:
        """Hit/miss/invalidation/eviction counters plus size and
        capacity — surfaced as ``session.stats()["fastpath"]``.
        ``reset=True`` snapshots then zeroes the counters (windowed
        semantics; entries and their epoch stamps are preserved, so the
        §4.5 staleness check is unaffected)."""
        out = {"hits": self.hits, "misses": self.misses,
               "invalidations": self.invalidations,
               "evictions": self.evictions, "size": len(self._store),
               "capacity": self.capacity}
        if reset:
            self.hits = self.misses = 0
            self.invalidations = self.evictions = 0
        return out

    def clear(self) -> None:
        """Drop every entry (counters are kept; they are cumulative —
        use ``stats(reset=True)`` for windowed counters)."""
        self._store.clear()
