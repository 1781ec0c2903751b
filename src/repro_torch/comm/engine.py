"""MultiPathTransfer — executable multi-path transfers on CUDA devices.

The port of the reference engine's main path. One or more
:class:`~repro_torch.comm.plan.TransferPlan` objects lower to ONE
:class:`~repro_torch.comm.graph.TransferGraph`, the configured
chunk-interleaving scheduler pass runs over it
(:mod:`repro_torch.comm.passes`, DESIGN.md §2.2), and the SCHEDULED graph
becomes the work table of the hand-written ``multipath_dma`` kernel
(:mod:`repro_torch.kernels.multipath_dma`), in the graph's index order.
The kernel launch is captured once into a ``torch.cuda.CUDAGraph`` and
cached in a :class:`~repro_torch.comm.cache.TransferPlanCache` keyed on the
scheduled graph's canonical digest: the paper's graph cache.

Logical devices are the rows of each message's operand
``(window, num_devices, nelems)``, all on one ``torch.device`` (stacked),
or with ``devices=[...]`` each its own ``torch.device``, the reference's
devices of a mesh: a message then occupies ``(window, nelems)`` of every
logical device's own buffers, each card launches the kernel over its own
share of the table (a
:class:`~repro_torch.kernels.multipath_dma.kernel.PeerDmaProgram`, peer
pointers into the other cards) and the result lands in ``devices[dst]``'s
memory. One dispatch is one graph replay:

1. stage each message into its operand's ``src`` row (``src``'s own
   operand), for every window;
2. replay the captured graph (the kernel writes the message into each
   window's ``dst`` row of the output and zeros into every other row — the
   reference ``emit_graph`` contract);
3. return *copies* of ``y[0, dst]`` (on ``devices[dst]``): the output is a
   static graph buffer that the next replay overwrites.

A **transfer group** (:meth:`MultiPathTransfer.transfer_group`) fuses a
set of concurrent messages into one graph, one cache entry and one
replay. Steady state takes the **dispatch fast path** (DESIGN.md §2.3):
the whole plan→lower→schedule→digest resolution is memoized per request
signature in an epoch-stamped :class:`~repro_torch.comm.cache.FastPathCache`,
so repeat traffic is one dict lookup + one staging copy + one replay.

**Whole-iteration capture** (:meth:`MultiPathTransfer.capture`) lowers a
recorded step of kernels and exchanges to ONE heterogeneous graph, makes
it resident as a :class:`~repro_torch.comm.capture.StepProgram` (kernels
and ``multipath_dma`` runs over one byte arena) and replays the whole
iteration as ONE CUDA graph per call, keyed and memoized like a transfer
group. Over peers it is a
:class:`~repro_torch.comm.capture.PeerStepProgram` (one arena a logical
device, one graph a card) under a :class:`PlacedKey`, with the same
digest and ``GroupKey``.

With a :class:`~repro_torch.comm.telemetry.TimelineRecorder` enabled,
every dispatch records one
:class:`~repro_torch.comm.telemetry.DispatchSample`: its setup stages
(plan / lower / schedule / compile, zeros on a fast-path hit), the staging
copies' host enqueue time, and the replay split into launch and execute
by the host clock (:meth:`~repro_torch.comm.cache.CompiledPlan.timed_call`).
Disabled, the dispatch pays one boolean check.

Under fault state (a live :class:`~repro_torch.comm.health.FaultInjector`,
quarantined or failed links) a dispatch walks the §4.6 degradation
ladder (:data:`~repro_torch.comm.health.LADDER`): re-plans over the
surviving links, then the single best path, each a new captured graph,
and last a relay through pinned host memory. The healthy path pays the
few boolean reads of :meth:`MultiPathTransfer._hazard`.

:func:`multipath_send_local` runs one plan's scheduled graph on a
stacked operand outside the engine: one ``multipath_dma`` launch, no
fast-path entry and no graph of its own, so a caller's capture records
it (the reference runs it inside its own ``shard_map`` program).

On the CPU the same entries run the kernels' plain versions eagerly.
"""

from __future__ import annotations

import dataclasses
import os
import time
from functools import lru_cache
from typing import Hashable, Sequence

import torch

from repro_torch.comm.cache import (CompiledPlan, FastPathCache,
                                    FastPathEntry, TransferPlanCache,
                                    compile_plan)
from repro_torch.comm.capture import (CapturedStep, PeerStepProgram,
                                      StepCapture, StepProgram, as_dtype,
                                      dtype_name, lower_step)
from repro_torch.comm.config import VALIDATE_MODES, _env_bool
from repro_torch.comm.graph import ComputeNode, TransferGraph, lower
from repro_torch.comm.health import (LADDER, CommFaultError, FaultInjector,
                                     HealthMonitor, HealthStats,
                                     LinkFaultError)
from repro_torch.comm.passes import AutoSchedule, GraphPass, apply_schedule
from repro_torch.comm.plan import TransferGroup, TransferPlan, TransferRequest
from repro_torch.comm.planner import PathPlanner
from repro_torch.comm.telemetry import (DispatchSample, StageTimings,
                                        TimelineRecorder)
from repro_torch.core.pipelining import validate_plan
from repro_torch.core.topology import HOST, Topology
from repro_torch.kernels.multipath_dma.kernel import (DmaProgram,
                                                      PeerDmaProgram,
                                                      build_node_table,
                                                      launch_table,
                                                      run_node_table_plain)

@dataclasses.dataclass(frozen=True)
class GroupKey:
    """Graph-cache key for a fused transfer group.

    ``digest`` is the canonical content hash of the SCHEDULED
    :class:`~repro_torch.comm.graph.TransferGraph` (nodes in dispatch
    order + edges + window), so the key can never diverge from the work
    table that was captured. ``entries`` adds the per-message element
    type/count (``(src, dst, nelems, dtype name)``), which the byte-level
    graph does not carry but the operand layout depends on;
    ``num_devices`` is the row count of every operand.

    Captured whole-iteration steps reuse this key: ``digest`` is the
    scheduled heterogeneous graph's digest (compute nodes included) and
    ``entries`` carries the capture signature plus one
    ``(kernel, flops, cost_ns)`` triple per compute node, so the key
    covers compute identity as well as routes.
    """

    digest: str
    entries: tuple   # ((src, dst, nelems, dtype_str), ...) per message
    window: int = 1
    num_devices: int = 0


@dataclasses.dataclass(frozen=True)
class PlacedKey:
    """Plan-cache key of a program whose logical devices live on
    ``devices`` (one ``torch.device`` name each): a :class:`GroupKey` (or
    a session's ``CollectiveKey``) identifies the graph, the placement the
    buffers. The digest and the key stay the reference's; only the
    program lookup carries the placement, so a cache shared by a stacked
    and a peer session never serves one the other's program."""

    key: Hashable
    devices: tuple[str, ...]


@dataclasses.dataclass
class _StepEntry:
    """Fast-path entry for a captured whole-iteration step.

    Same shape as :class:`~repro_torch.comm.cache.FastPathEntry` (the
    front cache stores entries opaquely) plus the recording itself
    (``program`` — needed to rebuild the resident program if the plan
    cache evicts it under us) and the step's output buffer ids.
    """

    plans: tuple
    graph: TransferGraph
    digest: str
    key: GroupKey
    compiled: CompiledPlan
    schedule: str
    program: StepCapture
    outputs: tuple


def plan_signature(plan: TransferPlan) -> tuple:
    """Human-readable per-path summary ((links, chunks, bytes), ...).

    Informational/diagnostic — cache keys use the graph digest instead.
    """
    return tuple((p.route.directional_links(), p.num_chunks, p.nbytes)
                 for p in plan.paths)


def group_signature(group: TransferGroup) -> tuple:
    """Per-plan (src, dst, nbytes, plan signature) for the whole group."""
    return tuple((p.src, p.dst, p.nbytes, plan_signature(p))
                 for p in group.plans)


@lru_cache(maxsize=256)
def _scheduled_graph(graph: TransferGraph, schedule: str,
                     topology: Topology,
                     topology_epoch: tuple) -> tuple[TransferGraph, str]:
    """Memoized schedule application for name-addressed schedulers.

    ``lower()`` memoizes the lowering, so steady-state launches reuse the
    same graph object; without this cache every cache-hit dispatch would
    re-run the pass AND the full §2.2 contract check. ``topology_epoch``
    is part of the key: ``Topology`` hashes by identity, so a link
    mutation must not serve a model-weighted scheduler a stale order.
    """
    return apply_schedule(graph, schedule, topology)


class NoRouteError(ValueError):
    """The planner refused a request: no admissible route over the
    surviving links, or a plan that failed its §4.5 checks. The
    degradation ladder escalates on this error alone; a ``ValueError``
    raised while a graph is lowered, a program built or a replay issued
    propagates to the caller."""


def _check_executable(plan: TransferPlan) -> None:
    for pa in plan.paths:
        for link in pa.route.hops:
            if HOST in (link.src, link.dst):
                # Checked per HOP, not per route.via: a 3-hop detour can
                # stage through the host mid-route while its recorded via
                # is a device.
                raise ValueError(
                    "host-staged path is not executable on the device "
                    "(DESIGN.md §2); plan with include_host=False")


#: Work tables of :func:`multipath_send_local` made resident, keyed on
#: (scheduled graph digest, row length, dtype, device count, device): the
#: upload of a table cannot be recorded into a caller's CUDA graph, so it
#: happens at the first call (a capture's warm-up) and never again.
_LOCAL_PROGRAMS: dict[tuple, DmaProgram] = {}


def multipath_send_local(x: torch.Tensor, plan: TransferPlan, *,
                         schedule: str | GraphPass = "round_robin",
                         topology: Topology | None = None) -> torch.Tensor:
    """Execute ``plan`` on the stacked operand ``x: (num_devices,
    nelems)``, its ``src`` row holding the message (the other rows are
    not read). Returns a new ``(num_devices, nelems)`` tensor holding the
    message on the ``dst`` row and zeros elsewhere.

    The plan is lowered, put through the ``schedule`` pass (§2.2; pass
    ``topology`` beside a model-weighted scheduler) and run as ONE
    ``multipath_dma`` launch of its work table, the plain version on a
    CPU tensor. Nothing goes through the engine's caches and no CUDA
    graph is made, so a caller's capture records the launch; the table
    is made resident once per (graph, shape, dtype, device)."""
    _check_executable(plan)
    if x.dim() != 2:
        raise ValueError(f"x must be (num_devices, nelems), got "
                         f"{tuple(x.shape)}")
    ndev, nelems = x.shape
    graph, _ = apply_schedule(lower(plan), schedule, topology)
    key = (graph.digest(), nelems, x.dtype, ndev, x.device)
    prog = _LOCAL_PROGRAMS.get(key)
    if prog is None:
        table = build_node_table(graph, (nelems,), (x.element_size(),),
                                 ndev, fill="zero")
        prog = _LOCAL_PROGRAMS[key] = DmaProgram(table, (x.dtype,),
                                                 x.device, operand=False)
    y = torch.empty_like(prog.y)
    operand = x.contiguous().reshape(-1).view(torch.uint8)
    if x.device.type == "cuda":
        launch_table(prog.items, operand, y, prog.stage, prog.state,
                     prog._grid)
    else:
        run_node_table_plain(prog.table.items, operand, y, prog.stage)
    (out,) = prog._views(y)
    return out[0]


class MultiPathTransfer:
    """Build, cache, and replay captured multi-path transfer graphs."""

    def __init__(self, device: torch.device | str | None = None, *,
                 devices: Sequence[torch.device | str] | None = None,
                 topology: Topology | None = None,
                 planner: PathPlanner | None = None,
                 cache: TransferPlanCache | None = None,
                 schedule: str | GraphPass = "round_robin",
                 fastpath: bool | None = None,
                 validate: str | None = None,
                 fastpath_cache: FastPathCache | None = None,
                 telemetry: TimelineRecorder | None = None,
                 monitor: HealthMonitor | None = None,
                 faults: FaultInjector | None = None,
                 retry_limit: int = 2,
                 backoff_base_s: float = 0.001):
        if (device is None) == (devices is None):
            raise ValueError("pass one of device= (stacked) or devices= "
                             "(one device a logical device)")
        #: One ``torch.device`` a logical device (``None``: stacked rows on
        #: ``device``).
        self.devices = (None if devices is None
                        else tuple(torch.device(d) for d in devices))
        self.device = (torch.device(device) if devices is None
                       else self.devices[0])
        if topology is None:
            topology = Topology.full_mesh(
                4 if devices is None else len(self.devices), with_host=True)
        self.topology = topology
        self.num_devices = topology.num_devices
        if devices is not None and len(self.devices) != self.num_devices:
            raise ValueError(f"{len(self.devices)} devices for a topology "
                             f"of {self.num_devices}")
        # `if ... is None` (not `or`): an *empty* TransferPlanCache is falsy
        # via __len__, and `or` would silently replace a caller's cache.
        self.planner = planner if planner is not None else PathPlanner(
            topology)
        self.cache = cache if cache is not None else TransferPlanCache()
        #: Default chunk-interleaving scheduler (DESIGN.md §2.2) applied
        #: to every lowering before the work table is built.
        self.schedule = schedule
        #: Steady-state dispatch fast path (DESIGN.md §2.3);
        #: ``REPRO_MP_FASTPATH=0`` (or ``fastpath=False``) turns it off.
        self.fastpath = (_env_bool("REPRO_MP_FASTPATH", True)
                         if fastpath is None else fastpath)
        #: ``"miss"`` validates plans/graphs only when they are (re)built;
        #: ``"always"`` re-validates on every dispatch (§4.5).
        self.validate = (os.environ.get("REPRO_MP_VALIDATE", "miss")
                         if validate is None else validate)
        if self.validate not in VALIDATE_MODES:
            raise ValueError(f"unknown validate mode {self.validate!r}; "
                             f"expected one of {VALIDATE_MODES}")
        self._fastpath = (fastpath_cache if fastpath_cache is not None
                          else FastPathCache())
        #: Optional dispatch-timeline recorder (DESIGN §4.4c). ``None``
        #: or a disabled recorder keeps the dispatch path at one boolean
        #: check — the zero-overhead-off telemetry contract.
        self.telemetry = telemetry
        # Per-dispatch telemetry carried from _resolve to _launch (the
        # two halves of one dispatch; the engine is not thread-safe).
        self._pending_stages: StageTimings | None = None
        self._pending_hit = False
        #: Cumulative nanoseconds spent staging messages into the static
        #: operands (host-side enqueue of the copies).
        self.staging_ns = 0
        #: Concrete schedule name → dispatch/compile calls resolved to it.
        self.schedule_counts: dict[str, int] = {}
        #: Graph replays issued (one per transfer or per fused group).
        self.dispatches = 0
        #: Copy nodes / dependency edges across every graph this engine
        #: captured (cache misses only).
        self.nodes_compiled = 0
        self.edges_compiled = 0
        self.copy_nodes_compiled = 0
        self.compute_nodes_compiled = 0
        #: Degraded-mode accounting (DESIGN §4.6): retries/replans/ladder
        #: level, surfaced as the ``health`` stats section. Always
        #: present so counters exist whether or not a monitor is wired.
        self.health = HealthStats()
        #: Optional telemetry-driven link health monitor; when attached,
        #: dispatch faults quarantine through it (events logged) and the
        #: degraded loop probes quarantined links on its cadence.
        self.monitor = monitor
        #: Optional deterministic chaos injector (``REPRO_MP_FAULTS``);
        #: fires before each dispatch resolves so epoch bumps always
        #: precede planning — no stale graph survives an injection.
        self.faults = faults
        #: Retries per degradation-ladder rung before escalating, and
        #: the bounded exponential backoff base between them (§4.6).
        self.retry_limit = retry_limit
        self.backoff_base_s = backoff_base_s

    # -- planning -----------------------------------------------------------
    def plan_for(self, src: int, dst: int, nelems: int,
                 dtype=torch.float32, **plan_kwargs) -> TransferPlan:
        itemsize = as_dtype(dtype).itemsize
        try:
            plan = self.planner.plan(src, dst, nelems * itemsize,
                                     granularity=itemsize,
                                     include_host=plan_kwargs.pop(
                                         "include_host", False),
                                     **plan_kwargs)
            validate_plan(plan)
        except ValueError as exc:
            raise NoRouteError(str(exc)) from exc
        return plan

    def plan_group_for(self, specs: Sequence[tuple], *,
                       max_paths: int | None = None,
                       num_chunks: int | None = None,
                       exclusive: bool = False) -> TransferGroup:
        """Jointly plan executable messages; ``specs`` holds one
        ``(src, dst, nelems, dtype)`` tuple per message. Host paths are
        never admitted."""
        requests = []
        for (src, dst, nelems, dtype) in specs:
            itemsize = as_dtype(dtype).itemsize
            requests.append(TransferRequest(src, dst, nelems * itemsize,
                                            granularity=itemsize))
        try:
            group = self.planner.plan_group(requests, max_paths=max_paths,
                                            include_host=False,
                                            num_chunks=num_chunks,
                                            exclusive=exclusive)
            for plan in group.plans:
                validate_plan(plan)
                _check_executable(plan)
        except ValueError as exc:
            raise NoRouteError(str(exc)) from exc
        return group

    # -- program construction -----------------------------------------------
    def _group_graph(self, plans: Sequence[TransferPlan], window: int,
                     schedule: str | GraphPass | None = None,
                     stages: StageTimings | None = None
                     ) -> tuple[TransferGraph, str]:
        """Lower the fused group and run the scheduler pass (§2.2).

        Returns the SCHEDULED graph — the one the work table is built from
        AND the one ``_group_key`` digests — plus the concrete schedule
        name that was chosen. ``stages`` (telemetry only) receives the
        lower/schedule wall time.
        """
        for p in plans:
            _check_executable(p)
        t0 = time.perf_counter_ns()
        graph = lower(TransferGroup(tuple(plans), self.topology.name),
                      window)
        t1 = time.perf_counter_ns()
        sched = self.schedule if schedule is None else schedule
        if isinstance(sched, str):
            out = _scheduled_graph(graph, sched, self.topology,
                                   self.topology.epoch)
        else:
            out = apply_schedule(graph, sched, self.topology)
        if stages is not None:
            stages.lower_ns = t1 - t0
            stages.schedule_ns = time.perf_counter_ns() - t1
        return out

    def _count_schedule(self, chosen: str) -> None:
        self.schedule_counts[chosen] = self.schedule_counts.get(chosen,
                                                                0) + 1

    def _placed(self, key: GroupKey):
        """The plan-cache key of ``key``'s program on this engine: the key
        itself when stacked, with the placement over peer devices."""
        if self.devices is None:
            return key
        return PlacedKey(key, tuple(str(d) for d in self.devices))

    def _compile_group(self, key: GroupKey, graph: TransferGraph,
                       shapes: Sequence[tuple[int, torch.dtype]]
                       ) -> CompiledPlan:
        nelems = [n for n, _ in shapes]
        dtypes = [d for _, d in shapes]
        itemsizes = [d.itemsize for d in dtypes]
        peer = self.devices is not None

        def build() -> DmaProgram | PeerDmaProgram:
            table = build_node_table(graph, nelems, itemsizes,
                                     self.num_devices, fill="zero",
                                     per_device=peer)
            if peer:
                return PeerDmaProgram(table, dtypes, self.devices)
            return DmaProgram(table, dtypes, self.device)

        self.nodes_compiled += graph.num_nodes
        self.edges_compiled += graph.num_edges
        self.copy_nodes_compiled += graph.num_copy_nodes
        self.compute_nodes_compiled += graph.num_compute_nodes
        return compile_plan(self._placed(key), build,
                            num_nodes=graph.num_nodes)

    def step_program(self, specs: Sequence[tuple]) -> PeerDmaProgram:
        """A resident per-device program of one concurrent group of
        messages (``specs`` as in :meth:`plan_group_for`), each on one path
        (``max_paths=1``: the direct link unless faults reroute it):
        planned, lowered and scheduled as a transfer group, built with no
        fill (its caller reads destinations only) and kept out of the plan
        cache and the dispatch counters. A ring step of the peer
        collectives runs on one
        (:class:`~repro_torch.comm.collectives.PeerRing`)."""
        if self.devices is None:
            raise ValueError("step programs hold per-device buffers; this "
                             "engine is stacked")
        group = self.plan_group_for(specs, max_paths=1)
        graph, _ = self._group_graph(group.plans, 1)
        dtypes = [as_dtype(dtype) for *_, dtype in specs]
        table = build_node_table(graph, [nelems for _, _, nelems, _ in specs],
                                 [d.itemsize for d in dtypes],
                                 self.num_devices, fill="none",
                                 per_device=True)
        return PeerDmaProgram(table, dtypes, self.devices)

    def _group_key(self, graph: TransferGraph, plans: Sequence[TransferPlan],
                   shapes: Sequence[tuple[int, torch.dtype]],
                   window: int) -> GroupKey:
        entries = tuple(
            (p.src, p.dst, nelems, dtype_name(dtype))
            for p, (nelems, dtype) in zip(plans, shapes))
        return GroupKey(graph.digest(), entries, window, self.num_devices)

    # -- steady-state dispatch (DESIGN.md §2.3) -----------------------------
    def _request_signature(self, mode: str, specs: Sequence[tuple],
                           window: int, schedule: str,
                           max_paths: int | None, num_chunks: int | None,
                           exclusive: bool) -> tuple:
        """Request identity for the fast path: everything that determines
        the resolved plans + graph BESIDES planner/topology state (which
        the epoch stamp covers)."""
        return (mode,
                tuple((src, dst, nelems, dtype_name(dtype))
                      for src, dst, nelems, dtype in specs),
                window, schedule, max_paths, num_chunks, exclusive,
                self.num_devices)

    def _take_pending(self) -> tuple[StageTimings | None, bool]:
        """The stages and fast-path flag ``_resolve`` left for this
        dispatch (reset for the next one)."""
        stages, hit = self._pending_stages, self._pending_hit
        self._pending_stages, self._pending_hit = None, False
        return stages, hit

    @staticmethod
    def _replay(compiled: CompiledPlan, stages: StageTimings | None,
                staging: int, *, block: bool) -> list:
        """Replay ``compiled`` once. With telemetry on (``stages`` given)
        also fill in ``staging`` and the launch/execute split of
        :meth:`CompiledPlan.timed_call` when ``block``, else the replay's
        host time alone as launch."""
        if stages is None:
            return compiled() if block else compiled.dispatch()
        stages.staging_ns = staging
        if block:
            ys, stages.launch_ns, stages.execute_ns = compiled.timed_call()
        else:
            t0 = time.perf_counter_ns()
            ys = compiled.dispatch()
            stages.launch_ns = time.perf_counter_ns() - t0
        return ys

    def _record(self, entry, stages: StageTimings, hit: bool, window: int,
                compute: tuple = ()) -> None:
        """Record one :class:`DispatchSample` of a finished dispatch, its
        routes from each path's directional links."""
        routes = tuple(
            tuple((pa.route.directional_links(), pa.nbytes, pa.num_chunks)
                  for pa in p.paths)
            for p in entry.plans)
        self.telemetry.record(DispatchSample(
            routes=routes, nbytes=sum(p.nbytes for p in entry.plans),
            num_nodes=entry.graph.num_nodes, window=window,
            schedule=entry.schedule, stages=stages, fastpath_hit=hit,
            compute=compute))

    def _launch(self, entry: FastPathEntry, messages: Sequence[torch.Tensor],
                *, block: bool) -> list[torch.Tensor]:
        """Stage the messages into the static operands and replay ONCE;
        returns copies of each message's ``y[0, dst]`` (over peers, of
        ``devices[dst]``'s output, on that device). Staging only enqueues
        the copies on a CUDA device: ``staging_ns`` is their host enqueue
        time and their device time lands in the replay's execute tail."""
        stages, hit = self._take_pending()
        compiled = entry.compiled
        peer = self.devices is not None
        t0 = time.perf_counter_ns()
        for buf, m, p in zip(compiled.inputs(), messages, entry.plans):
            (buf[p.src] if peer else buf[:, p.src]).copy_(m)
        staging = time.perf_counter_ns() - t0
        self.staging_ns += staging
        compiled.lifecycle.staging_ns += staging
        ys = self._replay(compiled, stages, staging, block=block)
        if stages is not None:
            self._record(entry, stages, hit, entry.graph.window)
        self.dispatches += 1
        if peer:
            return [y[p.dst][0].clone() for y, p in zip(ys, entry.plans)]
        return [y[0, p.dst].clone() for y, p in zip(ys, entry.plans)]

    def _resolve(self, specs: Sequence[tuple], *, window: int,
                 max_paths: int | None, num_chunks: int | None,
                 exclusive: bool, schedule: str | GraphPass | None,
                 single: bool) -> FastPathEntry:
        """Resolve a request to a launchable :class:`FastPathEntry`.

        Fast path (hit): one dict lookup against the epoch-stamped
        :class:`FastPathCache`; the plan cache is still consulted by
        stored key so LRU stats stay coherent (and an evicted graph is
        recaptured from the memoized scheduled graph without
        re-planning). Slow path (miss): the full pipeline, then the
        resolution is memoized under the current planner epoch. Custom
        :class:`GraphPass` objects bypass the fast path.
        """
        sched = self.schedule if schedule is None else schedule
        sched_name = sched if isinstance(sched, str) else None
        use_fast = self.fastpath and sched_name is not None
        stages = self._new_stages()
        shapes = [(nelems, as_dtype(dtype))
                  for (_, _, nelems, dtype) in specs]
        sig = epoch = None
        if use_fast:
            sig = self._request_signature(
                "plan" if single else "plan_group", specs, window,
                sched_name, max_paths, num_chunks, exclusive)
            epoch = self.planner.epoch
            entry = self._fastpath.get(sig, epoch)
            if entry is not None:
                compiled = self.cache.get(self._placed(entry.key))
                if compiled is None:   # evicted under us: recapture only
                    compiled = self._compile_group(entry.key, entry.graph,
                                                   shapes)
                    self.cache.put(compiled.key, compiled)
                    if stages is not None:
                        stages.compile_ns = compiled.lifecycle.build_ns
                entry.compiled = compiled
                if self.validate == "always":
                    for p in entry.plans:
                        validate_plan(p)
                    entry.graph.validate(
                        {i: p.nbytes for i, p in enumerate(entry.plans)},
                        cross_flow_exclusive=False)
                compiled.lifecycle.fastpath_hits += 1
                self._count_schedule(entry.schedule)
                self._pending_hit = True
                return entry
        t0 = time.perf_counter_ns()
        if single:
            (src, dst, nelems, dtype) = specs[0]
            plans: tuple[TransferPlan, ...] = (self.plan_for(
                src, dst, nelems, dtype, max_paths=max_paths,
                num_chunks=num_chunks),)
        else:
            plans = self.plan_group_for(specs, max_paths=max_paths,
                                        num_chunks=num_chunks,
                                        exclusive=exclusive).plans
        if stages is not None:
            stages.plan_ns = time.perf_counter_ns() - t0
        graph, chosen = self._group_graph(plans, window, sched,
                                          stages=stages)
        self._count_schedule(chosen)
        key = self._group_key(graph, plans, shapes, window)
        compiled = self._get_or_build(
            self._placed(key), lambda: self._compile_group(key, graph,
                                                           shapes), stages)
        entry = FastPathEntry(plans=tuple(plans), graph=graph,
                              digest=key.digest, key=key,
                              compiled=compiled, schedule=chosen)
        if use_fast:
            self._fastpath.put(sig, epoch, entry)
        return entry

    def _new_stages(self) -> StageTimings | None:
        """Open this dispatch's :class:`StageTimings` (``None`` with
        telemetry off: no object is made) and clear the fast-path flag;
        ``_launch``/``_launch_step`` take both."""
        tel = self.telemetry
        stages = (StageTimings() if tel is not None and tel.enabled
                  else None)
        self._pending_stages, self._pending_hit = stages, False
        return stages

    def _get_or_build(self, key, build, stages: StageTimings | None
                      ) -> CompiledPlan:
        """``cache.get_or_build``; with telemetry on, a build this call
        made sets ``stages.compile_ns`` to its lifecycle's ``build_ns``
        (table build, warm-up, capture, instantiation, first replay)."""
        built = []

        def builder() -> CompiledPlan:
            built.append(build())
            return built[0]

        compiled = self.cache.get_or_build(key, builder)
        if stages is not None and built:
            stages.compile_ns = compiled.lifecycle.build_ns
        return compiled

    # -- degraded-mode dispatch (DESIGN §4.6) -------------------------------
    def _hazard(self) -> bool:
        """True while any fault state can affect dispatch: a live
        injector, quarantined links, or failed topology links. The
        healthy path costs exactly these boolean reads — the §4.6
        zero-overhead-off contract."""
        return ((self.faults is not None and self.faults.active)
                or bool(self.planner.quarantined)
                or bool(self.topology.failed_links))

    def _fault_check(self, entry) -> None:
        """Validate a resolved entry against the live fault state.

        Raises :class:`~repro_torch.comm.health.LinkFaultError` when the
        entry still routes over a failed or quarantined link (a fault
        landed between resolve and launch) or when the injector's active
        drop window blames one of the entry's links — the §4.6 invariant
        that no replay is ever issued onto a link known to be down.
        """
        links = tuple({link for p in entry.plans
                       for link in p.directional_links()})
        failed = self.topology.failed_links
        quarantined = self.planner.quarantined
        bad = [link for link in links
               if link in failed or link in quarantined]
        if bad:
            raise LinkFaultError(bad, "entry routes over faulted links")
        if self.faults is not None:
            link = self.faults.dropped_link(self.dispatches, links)
            if link is not None:
                raise LinkFaultError((link,), "injected dispatch drop")

    def _note_fault(self, exc: LinkFaultError, rung: int) -> None:
        """Account one failed attempt: bump the retry counter, log the
        event, and quarantine the blamed links (through the monitor when
        attached, so the event stream stays unified) — the epoch bump
        this causes is what makes the following re-resolve a re-plan
        over surviving links."""
        hs = self.health
        hs.retries += 1
        hs.note("retry", rung=LADDER[min(rung, len(LADDER) - 1)],
                links=list(exc.links), reason=exc.reason,
                dispatch=self.dispatches)
        for link in exc.links:
            if link in self.topology.failed_links:
                continue  # physically gone; quarantine is for suspects
            if self.monitor is not None:
                self.monitor.quarantine_link(link, reason=exc.reason,
                                             dispatch=self.dispatches)
            else:
                self.planner.quarantine(link)

    def _steady_rung(self, rung: int) -> int:
        """The :data:`~repro_torch.comm.health.LADDER` level to record for
        a successful dispatch at ``rung``: multipath rungs report
        ``surviving_multipath`` whenever fault state constrained the
        route set (the invariant that ``ladder_level == 0`` means the
        full healthy plan)."""
        if rung >= 2:
            return rung
        if self.planner.quarantined or self.topology.failed_links:
            return 1
        return 0

    def _note_rung(self, rung: int) -> None:
        """Record a successful dispatch at ``rung``: log a ``ladder``
        event when the level moved, then let the monitor probe on its
        cadence."""
        hs = self.health
        level = self._steady_rung(rung)
        if hs.ladder_level != level:
            hs.note("ladder", level=level, rung=LADDER[level],
                    dispatch=self.dispatches)
        hs.ladder_level = level
        if self.monitor is not None:
            self.monitor.maybe_probe(self)

    def _backoff(self, delay: float) -> float:
        """Sleep the bounded exponential backoff; returns the next
        delay (doubled, capped at 50 ms)."""
        if delay > 0:
            time.sleep(delay)
            delay = min(delay * 2, 0.05)
        return delay

    def _host_relay(self, specs: Sequence[tuple],
                    messages: Sequence[torch.Tensor],
                    history: Sequence[str], *,
                    block: bool) -> list[torch.Tensor]:
        """Last ladder rung: deliver each message through a host (PCIe)
        round trip outside the captured graphs. A message on a CUDA
        device is copied into a pinned host buffer and from it into a
        new tensor on the destination's device (``block`` waits for both
        copies); a message on the CPU is copied on the host.

        Delivery over bandwidth: payloads arrive intact (the §4.5
        integrity contract still holds) at host-link speed. Requires
        nominal host links on both endpoints; raises
        :class:`~repro_torch.comm.health.CommFaultError` (the ladder is
        exhausted) when any message lacks them. Then the monitor probes
        on its cadence, as after a device rung: while every device route
        is quarantined all traffic relays, and without probes here no
        quarantined link would ever be readmitted (the reference does not
        probe here).
        """
        topo = self.topology
        for (src, dst, _, _) in specs:
            if (topo.link(src, HOST) is None
                    or topo.link(HOST, dst) is None):
                raise CommFaultError(
                    f"degradation ladder exhausted for {src}->{dst}: no "
                    f"surviving device route and no host-staged route",
                    history)
        outs = []
        for (_, dst, _, _), m in zip(specs, messages):
            target = self._home(dst)
            if m.device.type == "cuda":
                staged = torch.empty(m.shape, dtype=m.dtype,
                                     pin_memory=True)
                staged.copy_(m, non_blocking=True)      # pull to host
                if target != m.device:                  # push after pull
                    pulled = torch.cuda.Event()
                    pulled.record(torch.cuda.current_stream(m.device))
                    torch.cuda.current_stream(target).wait_event(pulled)
                out = torch.empty(m.shape, dtype=m.dtype, device=target)
                out.copy_(staged, non_blocking=True)    # push to dst
            else:
                out = m.clone()
            outs.append(out)
        if block:
            for card in dict.fromkeys(self.devices or (self.device,)):
                if card.type == "cuda":
                    torch.cuda.synchronize(card)
        hs = self.health
        hs.host_relays += 1
        hs.ladder_level = 3
        hs.note("host_relay", messages=len(specs),
                dispatch=self.dispatches)
        self.dispatches += 1
        if self.monitor is not None:
            self.monitor.maybe_probe(self)
        return outs

    def _dispatch(self, specs: Sequence[tuple],
                  messages: Sequence[torch.Tensor], *, window: int,
                  max_paths: int | None, num_chunks: int | None,
                  exclusive: bool, schedule: str | GraphPass | None,
                  single: bool, block: bool) -> list[torch.Tensor]:
        """Resolve + replay one request, degradation-aware (§4.6).

        Healthy state (no injector activity, no quarantine, no failed
        links) is the unchanged fast path: resolve, replay, done —
        exceptions propagate exactly as before, preserving every
        caller-visible contract (e.g. ``exclusive=True`` starvation
        raises). Under fault state the request walks
        :data:`~repro_torch.comm.health.LADDER` instead.
        """
        if self.faults is not None:
            self.faults.on_dispatch(self)
        if not self._hazard():
            hs = self.health
            if hs.ladder_level:
                hs.ladder_level = 0  # fully recovered
            entry = self._resolve(specs, window=window,
                                  max_paths=max_paths,
                                  num_chunks=num_chunks,
                                  exclusive=exclusive, schedule=schedule,
                                  single=single)
            return self._launch(entry, messages, block=block)
        return self._dispatch_degraded(
            specs, messages, window=window, max_paths=max_paths,
            num_chunks=num_chunks, exclusive=exclusive, schedule=schedule,
            single=single, block=block)

    def _dispatch_degraded(self, specs: Sequence[tuple],
                           messages: Sequence[torch.Tensor], *,
                           window: int, max_paths: int | None,
                           num_chunks: int | None, exclusive: bool,
                           schedule: str | GraphPass | None,
                           single: bool, block: bool) -> list[torch.Tensor]:
        """Walk the §4.6 degradation ladder until the request delivers.

        Rung 0 resolves the request as asked; each
        :class:`~repro_torch.comm.health.LinkFaultError` quarantines the
        blamed links (an epoch bump — the next resolve IS a re-plan over
        surviving links, and a new captured graph), sleeps the bounded
        exponential backoff, and retries up to ``retry_limit`` times per
        rung. A rung with no admissible route (a :class:`NoRouteError`
        from planning: the planner found none, or a plan failed its
        checks) escalates immediately: surviving multipath → single best
        path → host-staged relay. Whatever lowering, the program build or
        the replay raises propagates as on the healthy path — a fault of
        the port's own is never delivered through the host instead.
        Degraded rungs drop the
        ``exclusive`` guarantee (delivery over exclusivity — DESIGN
        §4.6); every replayed plan still passes the same §4.5 validation
        as healthy traffic. Only when every rung is exhausted does
        :class:`~repro_torch.comm.health.CommFaultError` reach the
        caller.
        """
        hs = self.health
        delay = self.backoff_base_s
        history: list[str] = []
        failed_once = False
        rungs = ((0, max_paths, 1),
                 (1, max_paths, self.retry_limit + 1),
                 (2, 1, self.retry_limit + 1))
        for rung, rung_paths, attempts in rungs:
            for _ in range(attempts):
                if failed_once:
                    hs.replans += 1
                try:
                    entry = self._resolve(
                        specs, window=window, max_paths=rung_paths,
                        num_chunks=num_chunks,
                        exclusive=exclusive and rung == 0,
                        schedule=schedule, single=single)
                except NoRouteError as exc:
                    failed_once = True
                    history.append(f"{LADDER[rung]}: {exc}")
                    break  # no admissible route at this rung: escalate
                try:
                    self._fault_check(entry)
                except LinkFaultError as exc:
                    failed_once = True
                    history.append(f"{LADDER[rung]}: {exc}")
                    entry.compiled.lifecycle.retries += 1
                    self._note_fault(exc, rung)
                    delay = self._backoff(delay)
                    continue
                out = self._launch(entry, messages, block=block)
                self._note_rung(rung)
                return out
        return self._host_relay(specs, messages, history,
                                block=block)

    def _home(self, rank: int) -> torch.device:
        """The ``torch.device`` that holds logical device ``rank``."""
        return self.device if self.devices is None else self.devices[rank]

    def _as_message(self, message, src: int) -> torch.Tensor:
        """``message`` on the device of its source ``src``."""
        m = torch.as_tensor(message)
        home = self._home(src)
        if m.device != home:
            m = m.to(home)
        return m

    # -- public API ---------------------------------------------------------
    def transfer(self, message: torch.Tensor, src: int, dst: int, *,
                 window: int = 1, max_paths: int | None = None,
                 num_chunks: int | None = None,
                 schedule: str | GraphPass | None = None,
                 block: bool = True) -> torch.Tensor:
        """Move ``message`` (1-D tensor) from logical device ``src`` to
        ``dst``; returns the received message (a fresh tensor).
        ``block=False`` replays without waiting; the caller syncs."""
        message = self._as_message(message, src)
        if message.dim() != 1:
            raise ValueError("message must be 1-D; reshape first")
        return self._dispatch(
            [(src, dst, message.shape[0], message.dtype)], [message],
            window=window, max_paths=max_paths, num_chunks=num_chunks,
            exclusive=False, schedule=schedule, single=True,
            block=block)[0]

    def transfer_group(self, messages: Sequence[torch.Tensor],
                       pairs: Sequence[tuple[int, int]], *,
                       window: int = 1, max_paths: int | None = None,
                       num_chunks: int | None = None,
                       exclusive: bool = False,
                       schedule: str | GraphPass | None = None,
                       block: bool = True) -> list[torch.Tensor]:
        """Move ``messages[i]`` (1-D) from ``pairs[i][0]`` to
        ``pairs[i][1]`` — all of them in ONE graph replay.

        The set is planned jointly, lowered to one transfer graph, and
        cached under a :class:`GroupKey`. Message order is canonicalized
        by ``(src, dst, nelems, dtype)`` (stable) before planning, so
        permuted twins share one entry; results come back in the
        caller's order.
        """
        if len(messages) != len(pairs):
            raise ValueError(f"{len(messages)} messages vs {len(pairs)} "
                             f"pairs")
        msgs = [self._as_message(m, src)
                for m, (src, _) in zip(messages, pairs)]
        if not msgs:
            return []
        for m in msgs:
            if m.dim() != 1:
                raise ValueError("messages must be 1-D; reshape first")
        specs = [(src, dst, m.shape[0], m.dtype)
                 for m, (src, dst) in zip(msgs, pairs)]
        order = sorted(range(len(msgs)),
                       key=lambda i: (specs[i][0], specs[i][1],
                                      specs[i][2], dtype_name(specs[i][3])))
        outs = self._dispatch([specs[i] for i in order],
                              [msgs[i] for i in order], window=window,
                              max_paths=max_paths, num_chunks=num_chunks,
                              exclusive=exclusive, schedule=schedule,
                              single=False, block=block)
        inverse = {i: k for k, i in enumerate(order)}
        return [outs[inverse[i]] for i in range(len(msgs))]

    def compiled_for(self, src: int, dst: int, nelems: int,
                     dtype=torch.float32, *, window: int = 1,
                     max_paths: int | None = None,
                     num_chunks: int | None = None,
                     schedule: str | GraphPass | None = None,
                     ) -> tuple[CompiledPlan, TransferPlan]:
        """AOT handle for benchmarks: returns (captured graph, plan).
        ``compiled(x)`` copies a staged ``(window, num_devices, nelems)``
        operand in, replays once and returns the static outputs."""
        plan = self.plan_for(src, dst, nelems, dtype, max_paths=max_paths,
                             num_chunks=num_chunks)
        graph, chosen = self._group_graph((plan,), window, schedule)
        self._count_schedule(chosen)
        shapes = ((nelems, as_dtype(dtype)),)
        key = self._group_key(graph, (plan,), shapes, window)
        compiled = self.cache.get_or_build(
            self._placed(key), lambda: self._compile_group(key, graph,
                                                           shapes))
        return compiled, plan

    def compiled_for_group(self, specs: Sequence[tuple], *,
                           window: int = 1, max_paths: int | None = None,
                           num_chunks: int | None = None,
                           exclusive: bool = False,
                           schedule: str | GraphPass | None = None,
                           ) -> tuple[CompiledPlan, TransferGroup]:
        """AOT handle for a fused group; ``specs`` as in
        :meth:`plan_group_for`, taken in the caller's order. Returns
        (captured graph, group)."""
        group = self.plan_group_for(specs, max_paths=max_paths,
                                    num_chunks=num_chunks,
                                    exclusive=exclusive)
        graph, chosen = self._group_graph(group.plans, window, schedule)
        self._count_schedule(chosen)
        shapes = [(nelems, as_dtype(dtype))
                  for (_, _, nelems, dtype) in specs]
        key = self._group_key(graph, group.plans, shapes, window)
        compiled = self.cache.get_or_build(
            self._placed(key), lambda: self._compile_group(key, graph,
                                                           shapes))
        return compiled, group

    # -- whole-iteration capture (heterogeneous graphs) ---------------------
    def capture(self, build_fn, *, schedule: str | None = None
                ) -> CapturedStep:
        """Record one iteration and return a launchable
        :class:`~repro_torch.comm.capture.CapturedStep`.

        ``build_fn(cap)`` declares the step against a fresh
        :class:`~repro_torch.comm.capture.StepCapture` and returns the
        output ref(s). Nothing is planned or captured here — resolution
        happens on first launch (or :meth:`CapturedStep.resolve`) and is
        memoized on the fast path. On a peer engine the step runs as a
        :class:`~repro_torch.comm.capture.PeerStepProgram`, taking and
        returning per-device lists.
        """
        cap = StepCapture(self.num_devices)
        outputs = build_fn(cap)
        if not isinstance(outputs, (tuple, list)):
            outputs = (outputs,)
        return CapturedStep(self, cap, tuple(outputs), schedule=schedule)

    def _compile_step(self, key: GroupKey, graph: TransferGraph,
                      program: StepCapture, outputs: tuple) -> CompiledPlan:
        """Make one scheduled step resident (and captured, on a CUDA
        device) as a :class:`~repro_torch.comm.capture.StepProgram`, or
        over peers a :class:`~repro_torch.comm.capture.PeerStepProgram`
        (placed under ``key``'s :class:`PlacedKey`)."""
        self.nodes_compiled += graph.num_nodes
        self.edges_compiled += graph.num_edges
        self.copy_nodes_compiled += graph.num_copy_nodes
        self.compute_nodes_compiled += graph.num_compute_nodes

        def build() -> StepProgram | PeerStepProgram:
            if self.devices is not None:
                return PeerStepProgram(graph, program, outputs, self.devices)
            return StepProgram(graph, program, outputs, self.num_devices,
                               self.device)

        return compile_plan(self._placed(key), build,
                            num_nodes=graph.num_nodes)

    def resolve_step(self, step: CapturedStep,
                     schedule: str | GraphPass | None = None) -> _StepEntry:
        """Resolve a captured step to a launchable entry.

        Mirrors :meth:`_resolve`: a fast-path hit is one dict lookup keyed
        on (capture signature, outputs, schedule name, device count) under
        the planner epoch; a miss runs lower_step → scheduler pass → §4.5
        validation (inside lowering) → resident program, keyed on the
        scheduled graph digest + capture signature + per-kernel compute
        identity, then memoizes. Two schedules of the same capture digest
        apart and never cross-serve programs. Over peers the program is
        looked up under the key's :class:`PlacedKey`.
        """
        program = step.capture
        sched = self.schedule if schedule is None else schedule
        sched_name = sched if isinstance(sched, str) else None
        use_fast = self.fastpath and sched_name is not None
        stages = self._new_stages()
        sig = epoch = None
        if use_fast:
            sig = ("capture_step", program.signature(), step.outputs,
                   sched_name, self.num_devices)
            epoch = self.planner.epoch
            entry = self._fastpath.get(sig, epoch)
            if entry is not None:
                compiled = self.cache.get(self._placed(entry.key))
                if compiled is None:   # evicted under us: rebuild only
                    compiled = self._compile_step(
                        entry.key, entry.graph, entry.program,
                        entry.outputs)
                    self.cache.put(self._placed(entry.key), compiled)
                    if stages is not None:
                        stages.compile_ns = compiled.lifecycle.build_ns
                entry.compiled = compiled
                if self.validate == "always":
                    for p in entry.plans:
                        validate_plan(p)
                    entry.graph.validate(
                        {i: p.nbytes for i, p in enumerate(entry.plans)},
                        cross_flow_exclusive=False)
                compiled.lifecycle.fastpath_hits += 1
                self._count_schedule(entry.schedule)
                self._pending_hit = True
                return entry
        t0 = time.perf_counter_ns()
        graph, plans = lower_step(program, self.plan_group_for,
                                  self.topology.name)
        t1 = time.perf_counter_ns()
        scheduled, chosen = apply_schedule(graph, sched, self.topology)
        if stages is not None:
            stages.lower_ns = t1 - t0
            stages.schedule_ns = time.perf_counter_ns() - t1
        self._count_schedule(chosen)
        compute_id = tuple((n.kernel, n.flops, n.cost_ns)
                           for n in scheduled.nodes
                           if isinstance(n, ComputeNode))
        key = GroupKey(scheduled.digest(),
                       entries=(program.signature(), step.outputs)
                       + compute_id,
                       window=1, num_devices=self.num_devices)
        compiled = self._get_or_build(
            self._placed(key), lambda: self._compile_step(
                key, scheduled, program, step.outputs), stages)
        entry = _StepEntry(plans=plans, graph=scheduled, digest=key.digest,
                           key=key, compiled=compiled, schedule=chosen,
                           program=program, outputs=step.outputs)
        if use_fast:
            self._fastpath.put(sig, epoch, entry)
        return entry

    def _check_rows(self, bid: int, spec, t) -> None:
        """A peer step's per-device input for buffer ``bid``: a list of
        ``num_devices`` tensors of the local shape, else ``ValueError``. A
        replicated buffer's list must also place tensor *d* on
        ``devices[d]``, so that staging it copies on each device and
        nothing crosses a card."""
        if (not isinstance(t, (list, tuple)) or len(t) != self.num_devices
                or any(tuple(td.shape) != spec.shape for td in t)):
            raise ValueError(
                f"input for buffer {bid} must be a list of "
                f"{self.num_devices} tensors of shape {spec.shape} (one a "
                f"logical device)")
        if spec.replicated and any(td.device != d
                                   for td, d in zip(t, self.devices)):
            raise ValueError(
                f"replicated input for buffer {bid} given as a list must "
                f"hold tensor d on devices[d] "
                f"({[str(d) for d in self.devices]}), got "
                f"{[str(td.device) for td in t]}")

    def _launch_step(self, entry: _StepEntry,
                     tensors: Sequence[torch.Tensor], *,
                     block: bool) -> list[torch.Tensor]:
        """Stage the step inputs into the resident program's static
        buffers and replay it ONCE; returns copies of the outputs (over
        peers, one list an output, each device's on its device). With
        telemetry on, records one sample whose ``compute`` holds each
        compute node's ``(kernel, flops, cost_ns)``."""
        stages, hit = self._take_pending()
        program = entry.program
        if len(tensors) != len(program.inputs):
            raise ValueError(f"captured step takes {len(program.inputs)} "
                             f"input tensors, got {len(tensors)}")
        compiled = entry.compiled
        peer = self.devices is not None
        t0 = time.perf_counter_ns()
        for bid, t, buf in zip(program.inputs, tensors, compiled.inputs()):
            spec = program.buffers[bid]
            if peer and (not spec.replicated
                         or isinstance(t, (list, tuple))):
                self._check_rows(bid, spec, t)
                for view, td in zip(buf, t):
                    view[0].copy_(td)
                continue
            t = torch.as_tensor(t)
            want = (spec.shape if spec.replicated
                    else (self.num_devices,) + spec.shape)
            if tuple(t.shape) != want:
                raise ValueError(
                    f"input for buffer {bid} must have shape {want} "
                    f"({'replicated' if spec.replicated else 'stacked'}), "
                    f"got {tuple(t.shape)}")
            if peer:
                for view in buf:
                    view[0].copy_(t)
            else:
                buf.copy_(t)
        staging = time.perf_counter_ns() - t0
        self.staging_ns += staging
        compiled.lifecycle.staging_ns += staging
        ys = self._replay(compiled, stages, staging, block=block)
        if stages is not None:
            compute = tuple((n.kernel, n.flops, n.cost_ns)
                            for n in entry.graph.nodes
                            if isinstance(n, ComputeNode))
            self._record(entry, stages, hit, 1, compute)
        self.dispatches += 1
        if peer:
            return [[view[0].clone() for view in y] for y in ys]
        return [y.clone() for y in ys]

    def run_step(self, step: CapturedStep, tensors: Sequence[torch.Tensor],
                 *, schedule: str | GraphPass | None = None,
                 block: bool = True) -> list[torch.Tensor]:
        """Resolve + launch one captured iteration as ONE dispatch.

        Returns the step outputs device-stacked ``(num_devices,
        *local_shape)``, aligned with the capture's declared outputs (over
        peers, one list of ``num_devices`` local tensors an output).

        Under fault state (§4.6 hazard: live injector, quarantined or
        failed links) the captured step retries with bounded backoff —
        each :class:`~repro_torch.comm.health.LinkFaultError` quarantines
        the blamed links so the re-resolve re-plans over surviving
        routes and captures the step anew (``plan_group_for`` naturally
        narrows the path set; there is no host rung for captured
        steps). A resolve with no admissible route (a
        :class:`NoRouteError`), and exhaustion, raise
        :class:`~repro_torch.comm.health.CommFaultError` with the attempt
        history; what lowering, the build or the replay raises
        propagates; the healthy path is unchanged.
        """
        if self.faults is not None:
            self.faults.on_dispatch(self)
        if not self._hazard():
            entry = self.resolve_step(step, schedule)
            return self._launch_step(entry, tensors, block=block)
        hs = self.health
        delay = self.backoff_base_s
        history: list[str] = []
        for attempt in range(self.retry_limit + 2):
            if attempt:
                hs.replans += 1
            try:
                entry = self.resolve_step(step, schedule)
            except NoRouteError as exc:
                history.append(f"step: {exc}")
                raise CommFaultError(
                    f"captured-step ladder exhausted: {exc}",
                    history) from exc
            try:
                self._fault_check(entry)
            except LinkFaultError as exc:
                history.append(f"step: {exc}")
                self._note_fault(exc, 1)
                delay = self._backoff(delay)
                continue
            out = self._launch_step(entry, tensors, block=block)
            self._note_rung(0)
            return out
        raise CommFaultError(
            "captured-step dispatch failed after retries", history)

    # -- introspection ------------------------------------------------------
    def stats(self, reset: bool = False) -> dict:
        """Engine-level accounting: replays, plan-cache counters, fast-
        path counters, cumulative staging time, captured graph totals,
        per-schedule resolution counts, the §4.6 ``health`` section
        (windowed retries/replans/faults/host relays; ladder level and
        quarantine count are state) and, with a recorder, its counters
        (``telemetry``). ``reset=True`` returns the snapshot then zeroes
        every windowed counter; telemetry samples survive a reset (they
        feed calibration; ``telemetry.clear()`` drops them)."""
        out = {
            "dispatches": self.dispatches,
            "cache": self.cache.stats(reset=reset),
            "fastpath": {"enabled": self.fastpath,
                         "validate": self.validate,
                         "staging_ns": self.staging_ns,
                         **self._fastpath.stats(reset=reset)},
            "graph": {"nodes_compiled": self.nodes_compiled,
                      "edges_compiled": self.edges_compiled,
                      "copy_nodes_compiled": self.copy_nodes_compiled,
                      "compute_nodes_compiled":
                          self.compute_nodes_compiled},
            "schedules": dict(self.schedule_counts),
            "schedule_scores": AutoSchedule.score_stats(reset=reset),
            "health": self.health.snapshot(
                len(self.planner.quarantined), self.monitor is not None),
        }
        if self.telemetry is not None:
            out["telemetry"] = self.telemetry.stats()
        if reset:
            self.dispatches = 0
            self.staging_ns = 0
            self.nodes_compiled = 0
            self.edges_compiled = 0
            self.copy_nodes_compiled = 0
            self.compute_nodes_compiled = 0
            self.schedule_counts = {}
            self.health.reset_window()
        return out
