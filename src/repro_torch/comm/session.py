"""CommSession — the single typed entry point for multi-path communication.

The paper's handler owns path selection, graph construction, and graph
caching behind one send/recv call (Algorithm 1). ``CommSession`` is that
handler: it owns one :class:`~repro_torch.core.topology.Topology`, one
:class:`~repro_torch.comm.planner.PathPlanner` (with its pluggable
:class:`~repro_torch.comm.policy.PathPolicy`), one
:class:`~repro_torch.comm.cache.TransferPlanCache`, and the engine on one
``torch.device`` or, with ``devices=[...]``, one ``torch.device`` a
logical device:

* ``session.send(x, src, dst)`` / ``session.bidirectional(...)`` —
  multi-path P2P through the ``multipath_dma`` kernel in a captured CUDA
  graph,
* ``session.exchange([(x, src, dst), ...])`` — a *transfer group*: a set
  of concurrent messages planned jointly, fused into one graph, one cache
  entry, one replay; ``session.send_pytree`` moves every leaf of a nested
  dict/list of tensors (a KV cache) as one such group,
* ``session.all_gather/reduce_scatter/all_reduce/all_to_all/psum(...)`` —
  driver-level bidirectional-ring collectives over global tensors, each
  captured once per (op, shape, dtype) into one CUDA graph and cached in
  the *same* plan cache (the all-gather runs the ``ring_allgather``
  kernel),
* ``session.collectives`` — the same collectives over device-stacked
  tensors (over a peer session, per-device lists), for use inside a
  captured step's kernels,
* ``session.capture(build_fn)`` — whole-iteration capture: kernels and
  fused exchanges of one iteration replayed as ONE CUDA graph per call,
* ``session.plan(...)`` / ``session.tune(...)`` / ``session.plan_group``
  — planning and the offline tuner (paper §4.4),
* ``session.telemetry`` / ``session.calibrate()`` — the measured-feedback
  loop (DESIGN §4.4c): with ``CommConfig.telemetry`` (or
  ``REPRO_MP_TELEMETRY=1``) every dispatch records a
  :class:`~repro_torch.comm.telemetry.DispatchSample`, and ``calibrate``
  fits the §4.4 terms from them into a
  :class:`~repro_torch.comm.calibration.CalibrationProfile` that the
  planner and schedulers then read; ``CommConfig.profile_dir`` loads the
  profile of this topology on init and is where ``persist=True`` writes.

``device=None`` means ``cuda`` and raises when no GPU is present; pass
``device="cpu"`` to run the kernels' plain versions. Logical devices are
then rows of each operand on that one device, and without a topology the
session models the paper's Beluga node (``Topology.full_mesh(4)``): one
card has no device count to read the size from.

``devices=[...]`` (the counterpart of the reference's ``mesh=``; not
beside ``device=``) puts logical device *i* on ``devices[i]``: each holds
its own buffers, a send lands in ``devices[dst]``'s memory, and without a
topology the session builds ``Topology.full_mesh(len(devices))``. Distinct
CUDA cards must reach each other (peer access), else the session raises;
the ``multipath_dma`` kernel then runs one launch a card with peer
pointers, and nothing falls back to the plain table on CUDA. A card may
be named more than once: its logical devices are distinct allocations on
it (one card checks this code). ``devices=["cpu"] * n`` runs the plain
version. ``send``, ``bidirectional``, ``exchange``, ``send_pytree`` and
the collectives run over peers: a driver-level collective takes the
stacked session's global tensor and returns its result on
``devices[0]``, through one program over the cards (the ring's shifts
per-device ``multipath_dma`` tables, its all-gather the peer
``ring_allgather``, one CUDA graph a card); ``session.collectives`` takes
and returns per-device lists. ``capture`` records the same step as on a stacked
session (the same digest and ``GroupKey``) and runs it with one arena a
logical device and one CUDA graph a card: a non-replicated input is a
list of ``n`` local tensors, tensor *d* on ``devices[d]``, a replicated
one a single tensor staged to every device or such a list, and each
declared output comes back as such a list. The training side passes
lists: the DP steps (``make_dp_train_step``,
``make_captured_dp_train_step``), the pipeline and the compressed mean.

Link faults (DESIGN §4.6): ``CommConfig.health`` (on by default) attaches
a :class:`~repro_torch.comm.health.HealthMonitor` that watches the
telemetry for droop, quarantines suspect links and readmits them after
healthy probes (``session.probe_links()``); ``CommConfig.faults`` (or
``REPRO_MP_FAULTS``) attaches a deterministic
:class:`~repro_torch.comm.health.FaultInjector`. Under fault state every
dispatch walks the degradation ladder instead of raising;
``session.drain_health_events()`` returns what happened and
``session.describe(src, dst, nbytes)`` reports a request's plan, graph,
modeled costs and the fault state it was planned under.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import warnings
import weakref
from typing import Callable, Sequence

import torch

from repro_torch.comm import collectives as coll
from repro_torch.comm.cache import (CompiledPlan, FastPathCache,
                                    TransferPlanCache, compile_plan)
from repro_torch.comm.calibration import (CalibrationFitter,
                                          CalibrationProfile,
                                          modeled_vs_measured)
from repro_torch.comm.capture import CapturedStep, dtype_name
from repro_torch.comm.config import CommConfig
from repro_torch.comm.engine import MultiPathTransfer, PlacedKey
from repro_torch.comm.graph import canonical_digest, lower
from repro_torch.comm.health import FaultInjector, HealthMonitor, HealthStats
from repro_torch.comm.passes import (AutoSchedule, GraphPass, apply_schedule,
                                     make_schedule)
from repro_torch.comm.plan import TransferPlan
from repro_torch.comm.planner import PathPlanner
from repro_torch.comm.policy import PathPolicy, make_policy
from repro_torch.comm.telemetry import TimelineRecorder
from repro_torch.core import pipelining as pl
from repro_torch.core.topology import Topology
from repro_torch.kernels._graph import GraphProgram
from repro_torch.launch import cost


def resolve_device(device: torch.device | str | None, *,
                   allow_meta: bool = False) -> torch.device:
    """``None`` → ``cuda`` (raises when no GPU is present). ``meta`` is
    accepted only where the caller allows it (a step built to be counted,
    :mod:`repro_torch.launch.cost`), and only when asked for by name."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CommSession() runs on a CUDA device and none is "
                "available; pass device='cpu' for the plain versions")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type == "meta" and allow_meta:
        return device
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def on_device(device: torch.device):
    """A context in which ``device`` is the current card (its stream takes
    the launches); nothing for a CPU device."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class CollectiveKey:
    """Plan-cache key for a captured collective.

    The digest keys the device count along with op/shape/dtype/axis: a
    cache shared across sessions of different sizes must not serve one
    size's program to the other. Like
    :class:`~repro_torch.comm.engine.GroupKey`, the key's identity is a
    canonical digest (:func:`repro_torch.comm.graph.canonical_digest`),
    equal to the reference's for the same ``(op, shape, dtype, axis,
    n)``.
    """

    op: str
    digest: str

    @classmethod
    def for_collective(cls, op: str, shape: tuple, dtype: str, axis: str,
                       num_devices: int) -> "CollectiveKey":
        return cls(op, canonical_digest(
            ("collective", op, tuple(shape), dtype, axis, num_devices)))


#: Per collective: the kind a cost count records it as, whether its
#: driver-level operand is replicated (else cut along dim 0 into the
#: devices' rows), and its graph's nodes a ring step (times n − 1).
_COLLECTIVES = {"all_gather": ("all-gather", False, 2),
                "reduce_scatter": ("reduce-scatter", True, 2),
                "all_reduce": ("all-reduce", True, 4),
                "all_to_all": ("all-to-all", False, 1),
                "psum": ("all-reduce", True, 4)}


def resolve_devices(devices: Sequence[torch.device | str]
                    ) -> tuple[torch.device, ...]:
    """Each of ``devices`` resolved (:func:`resolve_device`): all CUDA or
    all CPU. Distinct CUDA cards must have peer access to each other,
    else ``RuntimeError``."""
    out = tuple(resolve_device(d) for d in devices)
    if not out:
        raise ValueError("devices= needs at least one device")
    kinds = {d.type for d in out}
    if len(kinds) != 1:
        raise ValueError(f"devices must be all CUDA or all CPU, got "
                         f"{[str(d) for d in out]}")
    cards = list(dict.fromkeys(out))
    if out[0].type == "cuda":
        for a in cards:
            for b in cards:
                if a != b and not torch.cuda.can_device_access_peer(a, b):
                    raise RuntimeError(
                        f"{a} cannot access {b} (no peer access): a peer "
                        f"session needs every pair of its cards joined")
    return out


@dataclasses.dataclass(frozen=True)
class BoundCollectives:
    """Multipath collectives over device-stacked tensors ``(n, ...)``,
    bound to a session's axis name (part of the collective keys). For use
    inside a captured step's kernels; the driver-level captured
    counterparts over global tensors live on :class:`CommSession`. Each
    call is one collective record of a cost count
    (:func:`~repro_torch.launch.cost.stacked_collective`); the eager
    compositions run on meta tensors too."""

    axis_name: str

    def _run(self, op: str, xs):
        cost.stacked_collective(_COLLECTIVES[op][0], xs)
        return coll.FORMS[op](xs)

    def all_gather(self, xs):
        return self._run("all_gather", xs)

    def reduce_scatter(self, xs):
        return self._run("reduce_scatter", xs)

    def all_reduce(self, xs):
        return self._run("all_reduce", xs)

    def all_to_all(self, xs):
        return self._run("all_to_all", xs)

    def psum(self, xs):
        return self._run("psum", xs)

    def pmean(self, xs):
        return self.psum(xs) / xs.shape[0]


class CollectiveProgram(GraphProgram):
    """One collective made resident: a static stacked input buffer and
    the collective's body, replayed as one CUDA graph on a CUDA device
    (the body's result, allocated inside the graph, is the static output)
    and run eagerly on the CPU."""

    def __init__(self, body: Callable[[torch.Tensor], torch.Tensor],
                 in_shape: tuple, dtype: torch.dtype,
                 device: torch.device):
        self.device = device
        self.body = body
        self.x = torch.zeros(in_shape, dtype=dtype, device=device)
        self.y: torch.Tensor | None = None

    def run(self) -> None:
        self.y = None                    # free the last result first
        self.y = self.body(self.x)

    def inputs(self) -> list[torch.Tensor]:
        return [self.x]

    def outputs(self) -> list[torch.Tensor]:
        return [self.y]


class PeerCollectiveProgram(GraphProgram):
    """One collective over a peer session's logical devices made
    resident: one static input a logical device on its own device, and
    the collective's per-device form run through the program's own
    :class:`~repro_torch.comm.collectives.PeerRing`. On CUDA one graph a
    card, each card's body staging, launching and adding for the devices
    it holds, the cards ordered by events before each replay; on the CPU
    the form runs eagerly. Outputs: one list of per-device results."""

    def __init__(self, form: Callable, local_shape: tuple,
                 dtype: torch.dtype, ring: coll.PeerRing):
        self.form = form
        self.ring = ring
        self._cards = ring.cards
        self.device = ring.cards[0]
        self.x = [torch.zeros(local_shape, dtype=dtype, device=d)
                  for d in ring.devices]
        self.y: list = [None] * len(ring.devices)

    @property
    def cards(self) -> tuple[torch.device, ...]:
        return self._cards

    def run(self) -> None:
        self.y = [None] * len(self.y)     # free the last result first
        self.ring.begin()
        self.y = list(self.form(self.x, self.ring))

    def _run_card(self, card: int) -> None:
        self.ring.begin(card)
        xs = [x if self.ring.held(d) else None
              for d, x in enumerate(self.x)]
        for d, y in enumerate(self.form(xs, self.ring)):
            if y is not None:
                self.y[d] = y

    def bodies(self) -> list[tuple[torch.device, Callable[[], None]]]:
        return [(card, functools.partial(self._run_card, c))
                for c, card in enumerate(self._cards)]

    def inputs(self) -> list[list[torch.Tensor]]:
        return [self.x]

    def outputs(self) -> list[list[torch.Tensor]]:
        return [self.y]


@dataclasses.dataclass(frozen=True)
class PeerCollectives(BoundCollectives):
    """``session.collectives`` of a peer session: the same collectives
    over per-device lists, ``xs[d]`` on ``devices[d]``, each returning a
    new list in the same placement whose rows are bit for bit the stacked
    forms'. A call runs the session's program of its driver-level
    counterpart on the list's tensors (:meth:`CommSession._run_rows`: one
    plan-cache entry a signature, one dispatch a call). A stacked operand
    raises ``ValueError``: the list form is the only one. Each call is one
    collective record of a cost count, as the stacked form's.
    The session, which holds its collectives, is held weakly."""

    session: weakref.ref = dataclasses.field(repr=False, compare=False)

    def _run(self, op: str, xs) -> list[torch.Tensor]:
        session = self.session()
        devices = session.devices
        if not isinstance(xs, (list, tuple)):
            raise ValueError(
                f"{op} on a peer session takes a list of one tensor a "
                f"logical device (xs[d] on devices[d]), not a stacked "
                f"{tuple(getattr(xs, 'shape', ()))} operand")
        if len(xs) != len(devices) or any(
                x.device != d for x, d in zip(xs, devices)):
            raise ValueError(f"{op} on a peer session takes one tensor on "
                             f"each of {[str(d) for d in devices]}")
        cost.stacked_collective(_COLLECTIVES[op][0], xs)
        return [y.clone() for y in session._run_rows(op, list(xs))]

    def pmean(self, xs) -> list[torch.Tensor]:
        return [y / len(xs) for y in self.psum(xs)]


class CommSession:
    """Facade owning topology, planner, policy, engine, and plan cache."""

    def __init__(self, config: CommConfig | None = None, *,
                 device: torch.device | str | None = None,
                 devices: Sequence[torch.device | str] | None = None,
                 topology: Topology | None = None,
                 policy: PathPolicy | None = None,
                 cache: TransferPlanCache | None = None,
                 schedule: str | None = None):
        self.config = config if config is not None else CommConfig.from_env()
        if schedule is not None:
            self.config = self.config.replace(schedule=schedule)
        if devices is not None and device is not None:
            raise ValueError("pass device= (stacked rows on one device) or "
                             "devices= (one device a logical device), not "
                             "both")
        #: One ``torch.device`` a logical device, or ``None`` (stacked).
        self.devices = (None if devices is None
                        else resolve_devices(devices))
        self.device = (resolve_device(device) if devices is None
                       else self.devices[0])
        if topology is None:
            topology = Topology.full_mesh(
                4 if devices is None else len(self.devices), with_host=True)
        elif devices is not None and topology.num_devices != len(
                self.devices):
            raise ValueError(f"topology has {topology.num_devices} devices, "
                             f"got {len(self.devices)}")
        self.topology = topology
        self.policy = policy if policy is not None else make_policy(
            self.config.policy)
        self.planner = PathPlanner(topology, config=self.config,
                                   policy=self.policy)
        self.cache = cache if cache is not None else TransferPlanCache(
            self.config.cache_capacity)
        self._engine: MultiPathTransfer | None = None
        self.collectives = (BoundCollectives(self.config.axis_name)
                            if devices is None
                            else PeerCollectives(self.config.axis_name,
                                                 weakref.ref(self)))
        #: Dispatch-timeline recorder (DESIGN §4.4c). ``config.telemetry``
        #: force-enables it; otherwise ``REPRO_MP_TELEMETRY`` decides
        #: (default off — one boolean per dispatch).
        self.telemetry = TimelineRecorder(
            capacity=self.config.telemetry_capacity,
            enabled=True if self.config.telemetry else None)
        #: Link-health monitor (DESIGN §4.6): watches telemetry residuals
        #: for droop, quarantines suspect links on the planner, and
        #: re-admits them after healthy probes. ``config.health`` /
        #: ``REPRO_MP_HEALTH`` gates construction — with it off the
        #: session carries no monitor and dispatch pays nothing.
        self.monitor: HealthMonitor | None = None
        if self.config.health:
            self.monitor = HealthMonitor(
                self.topology, self.planner,
                droop_threshold=self.config.droop_threshold,
                droop_samples=self.config.droop_samples,
                probe_healthy=self.config.probe_healthy,
                recovery_ratio=self.config.recovery_ratio,
                probe_interval=self.config.probe_interval)
            # Droop detection rides the telemetry ring's observer hook
            # (fires only while telemetry is enabled).
            self.telemetry.on_record = self.monitor.observe
        #: Deterministic chaos injector parsed from ``config.faults`` /
        #: ``REPRO_MP_FAULTS`` (empty spec → no injector, no hazard).
        self.faults: FaultInjector | None = (
            FaultInjector.from_spec(self.config.faults)
            if self.config.faults else None)
        if self.config.profile_dir:
            self._load_calibration(self.config.profile_dir)

    def _load_calibration(self, profiles_dir: str) -> None:
        """Load-on-init: attach the persisted calibration profile whose
        digest matches this session's topology, if one exists. A corrupt
        or version-mismatched file degrades to a warning (the session
        runs on nominal constants) rather than failing construction."""
        try:
            profile = CalibrationProfile.load_for(self.topology,
                                                  profiles_dir)
        except (ValueError, OSError) as exc:
            warnings.warn(f"ignoring calibration profile in "
                          f"{profiles_dir!r}: {exc}", stacklevel=3)
            return
        if profile is not None:
            self.topology.set_calibration(profile)

    @property
    def engine(self) -> MultiPathTransfer:
        """The executable transfer engine (built on first use)."""
        if self._engine is None:
            self._engine = MultiPathTransfer(
                None if self.devices is not None else self.device,
                devices=self.devices,
                topology=self.topology,
                planner=self.planner,
                cache=self.cache,
                schedule=self.config.schedule,
                fastpath=self.config.fastpath,
                validate=self.config.validate,
                telemetry=self.telemetry,
                monitor=self.monitor,
                faults=self.faults,
                retry_limit=self.config.retry_limit,
                backoff_base_s=self.config.backoff_base_s)
        return self._engine

    @property
    def num_devices(self) -> int:
        return self.topology.num_devices

    # -- planning and tuning ------------------------------------------------
    def plan(self, src: int, dst: int, nbytes: int, **kwargs) -> TransferPlan:
        """Plan one P2P message (Algorithm 1 lines 4–11) via the policy."""
        return self.planner.plan(src, dst, nbytes, **kwargs)

    def plan_for(self, src: int, dst: int, nelems: int,
                 dtype=torch.float32, **kwargs) -> TransferPlan:
        """Element-granular plan for a typed 1-D message."""
        return self.engine.plan_for(src, dst, nelems, dtype, **kwargs)

    def tune(self, src: int, dst: int, nbytes: int, **kwargs) -> TransferPlan:
        """Offline tuner (paper §4.4): best (paths × chunks × host) config."""
        return self.planner.tune(src, dst, nbytes, **kwargs)

    def plan_group(self, requests, **kwargs):
        """Jointly plan concurrent messages without executing
        (:meth:`PathPlanner.plan_group`)."""
        return self.planner.plan_group(requests, **kwargs)

    # -- point-to-point -----------------------------------------------------
    def send(self, x: torch.Tensor, src: int, dst: int, *,
             window: int | None = None, max_paths: int | None = None,
             num_chunks: int | None = None,
             schedule: str | GraphPass | None = None,
             block: bool = True) -> torch.Tensor:
        """Send 1-D ``x`` from logical device ``src`` to ``dst``; returns
        the received message. Captured graphs are cached per (src, dst,
        size, config, dispatch schedule). A cost count records it as one
        collective-permute of the message's bytes."""
        cost.record_collective("collective-permute",
                               x.numel() * x.element_size(),
                               self.num_devices)
        return self.engine.transfer(
            x, src, dst, window=self.config.window if window is None
            else window, max_paths=max_paths, num_chunks=num_chunks,
            schedule=schedule, block=block)

    def bidirectional(self, x: torch.Tensor, src: int, dst: int, *,
                      window: int | None = None,
                      max_paths: int | None = None,
                      num_chunks: int | None = None,
                      schedule: str | GraphPass | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
        """Simultaneous src→dst and dst→src of the same message (OMB
        BIBW), as one 2-message group; returns ``(forward, reverse)``."""
        fwd, rev = self.exchange(
            [(x, src, dst), (x, dst, src)],
            window=self.config.window if window is None else window,
            max_paths=max_paths, num_chunks=num_chunks, schedule=schedule)
        return fwd, rev

    def exchange(self, items, *, window: int | None = None,
                 max_paths: int | None = None,
                 num_chunks: int | None = None,
                 exclusive: bool = False,
                 schedule: str | GraphPass | None = None,
                 block: bool = True) -> list[torch.Tensor]:
        """Execute a transfer group: ``items`` is a sequence of
        ``(x, src, dst)`` triples moved *concurrently* in ONE replay.

        Tensors may be any shape/dtype (flattened on the wire, restored on
        return). ``src == dst`` and empty tensors are per-item no-ops
        returned unchanged. ``exclusive=True`` demands group-level link
        exclusivity and raises if the topology cannot provide it. A cost
        count records each moved message as one collective-permute of its
        bytes.
        """
        items = list(items)
        results: list[torch.Tensor | None] = [None] * len(items)
        live = []
        for i, (x, src, dst) in enumerate(items):
            x = torch.as_tensor(x)
            if src == dst or x.numel() == 0:
                results[i] = x
                continue
            live.append((i, x, src, dst))
            cost.record_collective("collective-permute",
                                   x.numel() * x.element_size(),
                                   self.num_devices)
        if live:
            outs = self.engine.transfer_group(
                [x.reshape(-1) for _, x, _, _ in live],
                [(src, dst) for _, _, src, dst in live],
                window=self.config.window if window is None else window,
                max_paths=max_paths, num_chunks=num_chunks,
                exclusive=exclusive, schedule=schedule, block=block)
            for (i, x, _, _), out in zip(live, outs):
                results[i] = out.reshape(x.shape)
        return results  # type: ignore[return-value]

    def compiled_for(self, src: int, dst: int, nelems: int,
                     dtype=torch.float32, **kwargs
                     ) -> tuple[CompiledPlan, TransferPlan]:
        """AOT (captured graph, plan) handle for benchmarks."""
        return self.engine.compiled_for(src, dst, nelems, dtype, **kwargs)

    def capture(self, build_fn, *, schedule: str | None = None
                ) -> CapturedStep:
        """Capture one whole iteration (kernels + multipath exchanges) as
        ONE heterogeneous transfer graph; returns a launchable
        :class:`~repro_torch.comm.capture.CapturedStep`.

        ``build_fn(cap)`` declares the step against a
        :class:`~repro_torch.comm.capture.StepCapture` — inputs, kernel
        invocations over stacked tensors, fused exchanges — and returns
        the output ref(s). The recording lowers to one graph of copy AND
        compute nodes, the session's chunk-interleaving scheduler (§2.2)
        orders it, and every call replays ONE CUDA graph:
        ``stats()["dispatches"]`` increments by exactly one per captured
        iteration, however many kernels and messages it carries.
        Resolution rides the §2.3 fast path (memoized per capture
        signature + schedule + planner epoch). A peer session runs the
        same recording as a
        :class:`~repro_torch.comm.capture.PeerStepProgram` (one arena a
        logical device on its device, one graph a card): its step takes a
        list of ``num_devices`` local tensors for each non-replicated
        input (tensor *d* on ``devices[d]``), one tensor for a replicated
        one (copied to every device) or such a list (each tensor on its
        own device already), and returns one such list a declared output.
        """
        return self.engine.capture(build_fn, schedule=schedule)

    def send_pytree(self, tree, src: int, dst: int):
        """Move every tensor leaf of ``tree`` (nested dicts, lists and
        tuples) from ``src`` to ``dst``; returns the same structure.

        All leaves are fused into ONE transfer group: one captured graph
        covering every leaf (one plan-cache entry keyed on all leaf
        plans, not one per leaf) and one replay — steady-state KV
        migration is a single dispatch regardless of leaf count, and a
        second migration of the same shapes one fast-path hit. Zero-size
        leaves and ``src == dst`` are per-leaf no-ops.
        """
        leaves: list = []

        def flatten(t):
            if isinstance(t, dict):
                return {k: flatten(t[k]) for k in sorted(t)}
            if isinstance(t, (list, tuple)):
                return type(t)(flatten(v) for v in t)
            leaves.append(t)
            return len(leaves) - 1

        skeleton = flatten(tree)
        moved = self.exchange([(leaf, src, dst) for leaf in leaves])

        def unflatten(s):
            if isinstance(s, dict):
                return {k: unflatten(v) for k, v in s.items()}
            if isinstance(s, (list, tuple)):
                return type(s)(unflatten(v) for v in s)
            return moved[s]

        return unflatten(skeleton)

    # -- driver-level collectives ------------------------------------------
    def _collective_key(self, op: str, shape: tuple,
                        dtype: torch.dtype) -> CollectiveKey:
        return CollectiveKey.for_collective(
            op, tuple(shape), dtype_name(dtype), self.config.axis_name,
            self.num_devices)

    def _run_collective(self, op: str, x: torch.Tensor):
        """Stage ``x`` into the cached program of ``(op, shape, dtype)``
        (built and captured on a miss) as the stacked operand — every
        device's row a copy of ``x`` when the collective's operand is
        replicated, else ``x`` cut along dim 0 — replay once, and return
        the stacked result (a static buffer: callers copy out). On a peer
        session the rows go through :meth:`_run_rows`, and the result is
        one list of per-device rows."""
        n = self.num_devices
        _, replicated, per_step = _COLLECTIVES[op]
        stacked = ((n,) + tuple(x.shape) if replicated
                   else (n, x.shape[0] // n) + tuple(x.shape[1:]))
        if self.devices is not None:
            return self._run_rows(op, [x] * n if replicated
                                  else list(x.reshape(stacked).unbind(0)))
        key = self._collective_key(op, x.shape, x.dtype)
        compiled = self.cache.get_or_build(key, lambda: compile_plan(
            key, lambda: CollectiveProgram(getattr(self.collectives, op),
                                           stacked, x.dtype, self.device),
            num_nodes=per_step * (n - 1)))
        (y,) = compiled(x if replicated else x.reshape(stacked))
        return y

    def _run_rows(self, op: str, rows: list[torch.Tensor]) -> list:
        """One call of a peer session's program of ``op`` on the logical
        devices' operands ``rows`` (one shape and dtype): looked up under
        the driver-level key of the global operand they make, placed on
        the session's devices (a :class:`PeerCollectiveProgram`, built and
        captured on a miss), staged, replayed over the cards, one
        dispatch. Returns the per-device results (static buffers: callers
        copy out)."""
        n = self.num_devices
        _, replicated, per_step = _COLLECTIVES[op]
        local, dtype = tuple(rows[0].shape), rows[0].dtype
        shape = local if replicated else (n * local[0],) + local[1:]
        key = PlacedKey(self._collective_key(op, shape, dtype),
                        tuple(str(d) for d in self.devices))
        compiled = self.cache.get_or_build(key, lambda: compile_plan(
            key, lambda: PeerCollectiveProgram(
                coll.FORMS[op], local, dtype, coll.PeerRing(self.engine)),
            num_nodes=per_step * (n - 1)))
        (ys,) = compiled(rows)
        self.engine.dispatches += 1
        return ys

    def _joined(self, y, shape: tuple) -> torch.Tensor:
        """A collective's per-device rows as one new global tensor of
        ``shape`` on the session's device."""
        if isinstance(y, list):
            return torch.cat([t.to(self.device) for t in y]).reshape(shape)
        return y.reshape(shape).clone()

    def _as_input(self, x) -> torch.Tensor:
        x = torch.as_tensor(x)
        return x if x.device == self.device else x.to(self.device)

    def _check_ring_divisible(self, op: str, x: torch.Tensor,
                              n: int) -> None:
        if x.dim() == 0 or x.shape[0] % n:
            raise ValueError(
                f"{op} needs dim 0 divisible by the axis size {n}, got "
                f"{tuple(x.shape)[:1]}; pad upstream or use psum for "
                f"arbitrary shapes")

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        """Bidirectional-ring all-gather of ``x`` sharded on dim 0 (device
        *i* holds rows ``[i*s, (i+1)*s)``).

        Returns the same global tensor, as every device's replica holds
        it — both ring directions carry half the features each step,
        through the ``ring_allgather`` kernel on a CUDA device.
        """
        x = self._as_input(x)
        self._check_ring_divisible("all_gather", x, self.num_devices)
        return self._run_collective("all_gather", x)[0].clone()

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Bidirectional-ring reduce-scatter of a replicated operand; the
        result is sharded on dim 0 (device i owns the reduced block i)."""
        x = self._as_input(x)
        self._check_ring_divisible("reduce_scatter", x, self.num_devices)
        return self._joined(self._run_collective("reduce_scatter", x),
                            x.shape)

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce (sum over the devices) of a replicated operand whose
        dim 0 is divisible by the device count; use :meth:`psum`
        otherwise."""
        x = self._as_input(x)
        self._check_ring_divisible("all_reduce", x, self.num_devices)
        return self._run_collective("all_reduce", x)[0].clone()

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """All-to-all: ``x`` sharded on dim 0, one destination block per
        device pair — global dim 0 must be exactly n² (block payload goes
        in the trailing dims)."""
        x = self._as_input(x)
        n = self.num_devices
        if x.dim() == 0 or x.shape[0] != n * n:
            raise ValueError(
                f"all_to_all needs global dim 0 == n²={n * n} (one block "
                f"per device pair), got {tuple(x.shape)[:1]}; put "
                f"multi-row block payloads in the trailing dims")
        return self._joined(self._run_collective("all_to_all", x), x.shape)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum a replicated arbitrary-shape operand over the devices (pads
        and stripes through the bidirectional ring)."""
        return self._run_collective("psum", self._as_input(x))[0].clone()

    # -- calibration (DESIGN §4.4c) -----------------------------------------
    def calibrate(self, *, fitter: CalibrationFitter | None = None,
                  attach: bool = True, persist: bool | str = False,
                  **fit_kwargs) -> CalibrationProfile:
        """Fit a :class:`CalibrationProfile` from the session's recorded
        telemetry samples and (by default) attach it to the topology.

        Attaching goes through
        :meth:`~repro_torch.core.topology.Topology.set_calibration`, so
        the plan epoch bumps and every later estimate, ``auto``
        arbitration and path split reads the fitted terms.
        ``persist=True`` saves under ``config.profile_dir`` (a string
        persists under that directory instead); ``fit_kwargs`` go to
        :class:`CalibrationFitter` (min_samples / warmup / decay /
        max_ratio). The recorder's per-kernel execute channel is passed
        too, so kernels timed into it get a fitted compute term. Raises
        ``ValueError`` when no samples were recorded (enable
        ``REPRO_MP_TELEMETRY`` and run traffic first).
        """
        samples = self.telemetry.samples()
        if not samples:
            raise ValueError(
                "no telemetry samples recorded — enable REPRO_MP_TELEMETRY "
                "(or CommConfig.telemetry) and dispatch traffic before "
                "calibrating")
        if fitter is None:
            fitter = CalibrationFitter(self.topology, **fit_kwargs)
        elif fit_kwargs:
            raise ValueError("pass fit_kwargs or a fitter, not both")
        profile = fitter.fit(samples,
                             kernels=self.telemetry.kernel_samples())
        if attach:
            self.topology.set_calibration(profile)
        if persist:
            out_dir = (persist if isinstance(persist, str)
                       else self.config.profile_dir)
            if not out_dir:
                raise ValueError("persist=True needs config.profile_dir "
                                 "(or pass persist=<dir>)")
            profile.save(out_dir)
        return profile

    # -- introspection ------------------------------------------------------
    def describe(self, src: int, dst: int, nbytes: int, *,
                 window: int | None = None,
                 schedule: str | GraphPass | None = None,
                 **plan_kwargs) -> dict:
        """Plan one message and report its transfer graph + model costs.

        Pure planning — no device work, no capture — so it is the dry-run
        surface. Returns the SCHEDULED graph's shape (copy nodes,
        dependency edges, critical-path depth, canonical post-pass
        digest — the cache-key ingredient) and the analytic model's
        costs, all derived from the SAME lowering + scheduler pass the
        engine would capture. The ``"schedule"`` section reports the
        requested scheduler, the concrete order chosen (``auto`` resolves
        to its winner), its modeled time, and the delta vs the
        ``round_robin`` baseline (≤ 0 when the chosen order is modeled
        faster); for ``auto`` it additionally carries the per-candidate
        ``"candidates"`` scores its selection already computed.
        """
        window = self.config.window if window is None else window
        requested = self.config.schedule if schedule is None else schedule
        plan = self.plan(src, dst, nbytes, **plan_kwargs)
        base_graph = lower(plan, window)
        sched = (make_schedule(requested, self.topology)
                 if isinstance(requested, str) else requested)
        candidates = None
        if isinstance(sched, AutoSchedule):
            # Reuse the scores auto's selection computes anyway instead
            # of re-evaluating the winner and the baseline.
            chosen, graph, candidates = sched.select(base_graph)
            scheduled_t = candidates[chosen]
            baseline_t = candidates["round_robin"]
        else:
            graph, chosen = apply_schedule(base_graph, sched,
                                           self.topology)
            scheduled_t = pl.scheduled_time_s(graph, self.topology)
            baseline_t = (scheduled_t if graph is base_graph else
                          pl.scheduled_time_s(base_graph, self.topology))
        wire = pl.wire_time_s(plan, self.topology)
        schedule_info = {
            "requested": (requested if isinstance(requested, str)
                          else requested.name),
            "chosen": chosen,
            "scheduled_time_s": scheduled_t,
            "round_robin_time_s": baseline_t,
            "delta_vs_round_robin_s": scheduled_t - baseline_t,
        }
        if candidates is not None:
            schedule_info["candidates"] = candidates
        out = {
            "src": src, "dst": dst, "nbytes": nbytes, "window": window,
            "topology": self.topology.name,
            "num_paths": plan.num_paths,
            "schedule": schedule_info,
            # Steady-state dispatch (§2.3): whether repeat traffic for
            # this request would skip the pipeline just run above, and
            # the epoch stamp such an entry would be keyed under.
            "fastpath": {
                "enabled": self.config.fastpath,
                "validate": self.config.validate,
                "epoch": list(self.planner.epoch),
            },
            "graph": {
                "digest": graph.digest(),
                "nodes": graph.num_nodes,
                "copy_nodes": graph.num_copy_nodes,
                "compute_nodes": graph.num_compute_nodes,
                "edges": graph.num_edges,
                "critical_path_nodes": graph.critical_path_nodes(),
            },
            "model": {
                "wire_time_s": wire,
                "time_s": pl.estimate_transfer_time_s(plan, self.topology),
                "time_first_iter_s": pl.estimate_transfer_time_s(
                    plan, self.topology, first_iteration=True),
                "launch_overhead_ns": pl.launch_overhead_ns(
                    plan, compiled_plan=True, topo=self.topology),
                "launch_overhead_nograph_ns": pl.launch_overhead_ns(
                    plan, compiled_plan=False, topo=self.topology),
                "effective_gbps": pl.effective_bandwidth_gbps(
                    plan, self.topology),
            },
            # Lane-model view (§2.2): how the scheduled order prices
            # under the resource-lane simulation vs the serialized
            # chain, and how many modeled copy seconds hide behind
            # compute. Zero hidden time on a pure-comm describe.
            "overlap": self._overlap_info(graph),
            # Measured feedback (§4.4c): which terms the model sections
            # above actually consumed, plus modeled-vs-measured residuals
            # over the recorded samples so drift is visible.
            "calibration": self._calibration_info(),
            # Island structure (§3.1): whether this request crosses a
            # node boundary, and the flat-vs-two-level modeled
            # all-reduce delta for a payload of this size.
            "hierarchy": self._hierarchy_info(src, dst, nbytes),
            # Fault state (§4.6): failed / degraded / quarantined links
            # and the monitor's thresholds, so a dry-run shows whether
            # this plan was produced under degradation.
            "health": self._health_info(),
        }
        if self.devices is not None:
            # Over peers: the physical device of every logical device.
            out["devices"] = [str(d) for d in self.devices]
        return out

    def _overlap_info(self, graph) -> dict:
        """The ``describe()['overlap']`` section: lane vs serialized
        makespans of the scheduled graph plus modeled hidden-copy
        seconds and the fraction of total copy time hidden — the
        §2.2 overlap-visibility contract."""
        lane = pl.scheduled_time_s(graph, self.topology, mode="lanes")
        serialized = pl.scheduled_time_s(graph, self.topology,
                                         mode="serialized")
        hidden = pl.hidden_copy_time_s(graph, self.topology)
        weights = pl.graph_node_weights_s(graph, self.topology)
        copy_s = sum(w for nd, w in zip(graph.nodes, weights)
                     if not hasattr(nd, "kernel"))
        return {"lane_makespan_s": lane,
                "serialized_makespan_s": serialized,
                "hidden_copy_s": hidden,
                "hidden_copy_fraction": (hidden / copy_s
                                         if copy_s > 0 else 0.0)}

    def _hierarchy_info(self, src: int, dst: int, nbytes: int) -> dict:
        """The ``describe()['hierarchy']`` section: island count, the
        request's island endpoints, and — on >1-island topologies — the
        §4.4 tier model's flat vs two-level all-reduce times for this
        payload plus the layout ``config.collective_strategy`` resolves
        to."""
        topo = self.topology
        info: dict = {"islands": topo.num_islands,
                      "src_island": topo.node_of(src),
                      "dst_island": topo.node_of(dst),
                      "cross_island": topo.is_inter_island(src, dst)}
        if topo.num_islands > 1:
            chosen, times = coll.select_all_reduce_strategy(
                topo, nbytes, self.config.collective_strategy)
            info["all_reduce"] = {
                "chosen": chosen,
                "flat_time_s": times["flat"],
                "two_level_time_s": times["two_level"],
                "delta_two_level_vs_flat_s": (times["two_level"]
                                              - times["flat"]),
            }
        return info

    def _health_info(self) -> dict:
        """The ``describe()['health']`` section: whether monitoring is
        enabled, the topology's failed/degraded link overlays, the
        planner's quarantine set, and — when a monitor is attached — its
        counters and thresholds. Pure state, JSON-able, no side effects:
        the §4.6 visibility contract for dry-runs and reports."""
        topo = self.topology
        info: dict = {
            "enabled": self.monitor is not None,
            "failed": sorted(list(k) for k in topo.failed_links),
            "degraded": {f"{a}-{b}": r
                         for (a, b), r in sorted(
                             topo.degraded_links.items())},
            "quarantined": sorted(list(k)
                                  for k in self.planner.quarantined),
        }
        if self.monitor is not None:
            info["monitor"] = self.monitor.snapshot()
        return info

    # -- link health (DESIGN §4.6) ------------------------------------------
    def probe_links(self, nelems: int = 256) -> dict:
        """Actively probe every quarantined link (DESIGN §4.6 recovery).

        Each probe checks the link's served bandwidth against the
        recovery threshold AND sends a payload over exactly that link
        through a captured ``multipath_dma`` graph, checking it arrives
        intact (the §4.5 integrity contract applied to re-admission). A
        link is re-admitted only after ``probe_healthy`` consecutive
        healthy probes (doubled for flaky-marked links). Returns
        ``{(src, dst): ok}`` keyed by the probed links; empty when
        nothing is quarantined or health is off.
        """
        if self.monitor is None:
            return {}
        return self.monitor.probe_all(self.engine, nelems=nelems)

    def drain_health_events(self) -> list[dict]:
        """Return and clear the accumulated health event log — injector
        firings, retries, quarantines, probes, re-admissions, ladder
        moves — the engine's first, then the monitor's. Draining
        preserves counters (``stats()['health']`` windows are
        unaffected); it exists so supervisors like ``ServeEngine`` can
        fold comm-fault history into their own event stream without
        double-reporting."""
        events: list[dict] = []
        eng = self._engine
        if eng is not None:
            events.extend(eng.health.events)
            eng.health.events.clear()
        if self.monitor is not None:
            events.extend(self.monitor.events)
            self.monitor.events.clear()
        return events

    def _calibration_info(self) -> dict:
        """The calibration section ``describe()`` reports: live-profile
        summary and modeled-vs-measured residuals (constant vs fitted)
        over the telemetry ring — the §4.4c drift-visibility contract."""
        profile = self.topology.calibration
        info: dict = {"active": profile is not None}
        if profile is not None:
            info["profile"] = profile.summary()
        samples = self.telemetry.samples()
        if samples:
            info["residuals"] = modeled_vs_measured(
                samples, self.topology, profile)
        return info

    def stats(self, reset: bool = False) -> dict:
        """Cache hits/misses, replays (``dispatches`` — a fused group is
        ONE dispatch), fast-path counters, captured graph totals,
        schedule counts, policy, topology, the §4.6 ``health`` ledger
        (``retries`` / ``replans`` / ``faults_seen`` / ``host_relays``
        windowed; ``ladder_level`` and ``quarantined_links`` state that
        survives a reset), the telemetry recorder's counters and whether
        a calibration profile is live. ``fastpath``
        ``staging_ns`` is the host enqueue time of the staging copies
        (their device time lands in the replays). ``reset=True`` returns
        the snapshot then zeroes every windowed counter; telemetry
        samples survive a reset (they feed :meth:`calibrate`; drop them
        with ``session.telemetry.clear()``)."""
        eng = self._engine
        if eng is not None:
            es = eng.stats(reset=reset)
        else:
            es = {"dispatches": 0,
                  "cache": self.cache.stats(reset=reset),
                  "fastpath": {"enabled": self.config.fastpath,
                               "validate": self.config.validate,
                               "staging_ns": 0, **FastPathCache().stats()},
                  "graph": {"nodes_compiled": 0, "edges_compiled": 0,
                            "copy_nodes_compiled": 0,
                            "compute_nodes_compiled": 0},
                  "schedules": {},
                  "schedule_scores": AutoSchedule.score_stats(reset=reset),
                  "health": HealthStats().snapshot(
                      len(self.planner.quarantined),
                      self.monitor is not None)}
        out = {
            "cache": es["cache"],
            "dispatches": es["dispatches"],
            "fastpath": es["fastpath"],
            "graph": es["graph"],
            "policy": self.policy.name,
            "schedule": self.config.schedule,
            "schedules": es["schedules"],
            "schedule_scores": es["schedule_scores"],
            "health": es["health"],
            "topology": self.topology.name,
            "num_devices": self.topology.num_devices,
            "device": str(self.device),
            "telemetry": self.telemetry.stats(),
            "calibration": {
                "active": self.topology.calibration is not None},
        }
        if self.devices is not None:
            out["devices"] = [str(d) for d in self.devices]
        return out

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        where = (f"device={self.device}" if self.devices is None else
                 f"devices={[str(d) for d in self.devices]}")
        return (f"CommSession(topology={self.topology.name!r}, "
                f"policy={self.policy.name!r}, "
                f"devices={self.topology.num_devices}, {where})")
