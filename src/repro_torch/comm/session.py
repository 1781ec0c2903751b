"""CommSession — the single typed entry point for multi-path communication.

The paper's handler owns path selection, graph construction, and graph
caching behind one send/recv call (Algorithm 1). ``CommSession`` is that
handler: it owns one :class:`~repro_torch.core.topology.Topology`, one
:class:`~repro_torch.comm.planner.PathPlanner` (with its pluggable
:class:`~repro_torch.comm.policy.PathPolicy`), one
:class:`~repro_torch.comm.cache.TransferPlanCache`, and the engine on one
``torch.device``:

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
  tensors, for use inside a captured step's kernels,
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
rows of each operand on that one device. Without a topology the session
models the paper's Beluga node (``Topology.full_mesh(4)``): one card has
no device count to read the size from.

``faults``, whose subsystem is ported in a later slice, raises
``NotImplementedError`` instead of being ignored. ``health`` (on by
default) is accepted: no monitor watches the telemetry yet, and every
dispatch under fault state raises ``NotImplementedError`` naming the
health slice.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Callable

import torch

from repro_torch.comm import collectives as coll
from repro_torch.comm.cache import (CompiledPlan, FastPathCache,
                                    TransferPlanCache, compile_plan)
from repro_torch.comm.calibration import (CalibrationFitter,
                                          CalibrationProfile,
                                          modeled_vs_measured)
from repro_torch.comm.capture import CapturedStep, dtype_name
from repro_torch.comm.config import CommConfig
from repro_torch.comm.engine import MultiPathTransfer
from repro_torch.comm.graph import canonical_digest
from repro_torch.comm.passes import AutoSchedule, GraphPass
from repro_torch.comm.plan import TransferPlan
from repro_torch.comm.planner import PathPlanner
from repro_torch.comm.policy import PathPolicy, make_policy
from repro_torch.comm.telemetry import TimelineRecorder
from repro_torch.core.topology import Topology
from repro_torch.kernels._graph import GraphProgram


def resolve_device(device: torch.device | str | None) -> torch.device:
    """``None`` → ``cuda`` (raises when no GPU is present)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CommSession() runs on a CUDA device and none is "
                "available; pass device='cpu' for the plain versions")
        return torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


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


@dataclasses.dataclass(frozen=True)
class BoundCollectives:
    """Multipath collectives over device-stacked tensors ``(n, ...)``,
    bound to a session's axis name (part of the collective keys). For use
    inside a captured step's kernels; the driver-level captured
    counterparts over global tensors live on :class:`CommSession`."""

    axis_name: str

    def all_gather(self, xs: torch.Tensor) -> torch.Tensor:
        return coll.bidir_ring_all_gather(xs)

    def reduce_scatter(self, xs: torch.Tensor) -> torch.Tensor:
        return coll.bidir_ring_reduce_scatter(xs)

    def all_reduce(self, xs: torch.Tensor) -> torch.Tensor:
        return coll.multipath_all_reduce(xs)

    def all_to_all(self, xs: torch.Tensor) -> torch.Tensor:
        return coll.multipath_all_to_all(xs)

    def psum(self, xs: torch.Tensor) -> torch.Tensor:
        return coll.psum_via_multipath(xs)

    def pmean(self, xs: torch.Tensor) -> torch.Tensor:
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


class CommSession:
    """Facade owning topology, planner, policy, engine, and plan cache."""

    def __init__(self, config: CommConfig | None = None, *,
                 device: torch.device | str | None = None,
                 topology: Topology | None = None,
                 policy: PathPolicy | None = None,
                 cache: TransferPlanCache | None = None,
                 schedule: str | None = None):
        self.config = config if config is not None else CommConfig.from_env()
        if schedule is not None:
            self.config = self.config.replace(schedule=schedule)
        if self.config.faults:
            raise NotImplementedError(
                "CommConfig.faults is not ported yet; it comes with the "
                "health slice")
        self.device = resolve_device(device)
        if topology is None:
            topology = Topology.full_mesh(4, with_host=True)
        self.topology = topology
        self.policy = policy if policy is not None else make_policy(
            self.config.policy)
        self.planner = PathPlanner(topology, config=self.config,
                                   policy=self.policy)
        self.cache = cache if cache is not None else TransferPlanCache(
            self.config.cache_capacity)
        self._engine: MultiPathTransfer | None = None
        self.collectives = BoundCollectives(self.config.axis_name)
        #: Dispatch-timeline recorder (DESIGN §4.4c). ``config.telemetry``
        #: force-enables it; otherwise ``REPRO_MP_TELEMETRY`` decides
        #: (default off — one boolean per dispatch).
        self.telemetry = TimelineRecorder(
            capacity=self.config.telemetry_capacity,
            enabled=True if self.config.telemetry else None)
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
                self.device,
                topology=self.topology,
                planner=self.planner,
                cache=self.cache,
                schedule=self.config.schedule,
                fastpath=self.config.fastpath,
                validate=self.config.validate,
                telemetry=self.telemetry)
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
        size, config, dispatch schedule)."""
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
        exclusivity and raises if the topology cannot provide it.
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
        signature + schedule + planner epoch).
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
    def _run_collective(self, op: str, x: torch.Tensor,
                        body: Callable[[torch.Tensor], torch.Tensor],
                        stacked: tuple, num_nodes: int, *,
                        replicated: bool) -> torch.Tensor:
        """Stage ``x`` into the cached program of ``(op, shape, dtype)``
        (built and captured on a miss) as the stacked operand of shape
        ``stacked`` — every device's row a copy of ``x`` when
        ``replicated``, else ``x`` cut along dim 0 — replay once, and
        return the stacked result (a static buffer: callers copy out)."""
        key = CollectiveKey.for_collective(
            op, tuple(x.shape), dtype_name(x.dtype), self.config.axis_name,
            self.num_devices)

        def build() -> CompiledPlan:
            return compile_plan(
                key, lambda: CollectiveProgram(body, stacked, x.dtype,
                                               self.device),
                num_nodes=num_nodes)

        compiled = self.cache.get_or_build(key, build)
        (y,) = compiled(x if replicated else x.reshape(stacked))
        return y

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
        n = self.num_devices
        self._check_ring_divisible("all_gather", x, n)
        y = self._run_collective(
            "all_gather", x, self.collectives.all_gather,
            (n, x.shape[0] // n) + tuple(x.shape[1:]),
            num_nodes=2 * (n - 1), replicated=False)
        return y[0].clone()

    def reduce_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """Bidirectional-ring reduce-scatter of a replicated operand; the
        result is sharded on dim 0 (device i owns the reduced block i)."""
        x = self._as_input(x)
        n = self.num_devices
        self._check_ring_divisible("reduce_scatter", x, n)
        y = self._run_collective(
            "reduce_scatter", x, self.collectives.reduce_scatter,
            (n,) + tuple(x.shape), num_nodes=2 * (n - 1), replicated=True)
        return y.reshape(x.shape).clone()

    def all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        """All-reduce (sum over the devices) of a replicated operand whose
        dim 0 is divisible by the device count; use :meth:`psum`
        otherwise."""
        x = self._as_input(x)
        n = self.num_devices
        self._check_ring_divisible("all_reduce", x, n)
        y = self._run_collective(
            "all_reduce", x, self.collectives.all_reduce,
            (n,) + tuple(x.shape), num_nodes=4 * (n - 1), replicated=True)
        return y[0].clone()

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
        y = self._run_collective(
            "all_to_all", x, self.collectives.all_to_all,
            (n, n) + tuple(x.shape[1:]), num_nodes=n - 1, replicated=False)
        return y.reshape(x.shape).clone()

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum a replicated arbitrary-shape operand over the devices (pads
        and stripes through the bidirectional ring)."""
        x = self._as_input(x)
        n = self.num_devices
        y = self._run_collective(
            "psum", x, self.collectives.psum, (n,) + tuple(x.shape),
            num_nodes=4 * (n - 1), replicated=True)
        return y[0].clone()

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

    # -- introspection ------------------------------------------------------
    def stats(self, reset: bool = False) -> dict:
        """Cache hits/misses, replays (``dispatches`` — a fused group is
        ONE dispatch), fast-path counters, captured graph totals,
        schedule counts, policy, topology, the telemetry recorder's
        counters and whether a calibration profile is live. ``fastpath``
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
                  "schedule_scores": AutoSchedule.score_stats(reset=reset)}
        return {
            "cache": es["cache"],
            "dispatches": es["dispatches"],
            "fastpath": es["fastpath"],
            "graph": es["graph"],
            "policy": self.policy.name,
            "schedule": self.config.schedule,
            "schedules": es["schedules"],
            "schedule_scores": es["schedule_scores"],
            "topology": self.topology.name,
            "num_devices": self.topology.num_devices,
            "device": str(self.device),
            "telemetry": self.telemetry.stats(),
            "calibration": {
                "active": self.topology.calibration is not None},
        }

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"CommSession(topology={self.topology.name!r}, "
                f"policy={self.policy.name!r}, "
                f"devices={self.topology.num_devices}, "
                f"device={self.device})")
