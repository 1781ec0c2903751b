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
  entry, one replay,
* ``session.plan(...)`` / ``session.tune(...)`` / ``session.plan_group``
  — planning and the offline tuner (paper §4.4).

``device=None`` means ``cuda`` and raises when no GPU is present; pass
``device="cpu"`` to run the kernels' plain versions. Logical devices are
rows of each message's operand on that one device. Without a topology
the session models the paper's Beluga node (``Topology.full_mesh(4)``):
one card has no device count to read the size from.

Options whose subsystems are ported in later slices raise
``NotImplementedError`` instead of being ignored: ``telemetry``
(telemetry/calibration slice), ``profile_dir`` (telemetry/calibration),
``faults`` (health slice) and ``capture`` (capture slice). ``health``
(on by default) is accepted: with no telemetry and no fault state the
monitor has nothing to watch, and every dispatch under fault state raises
``NotImplementedError`` naming the health slice.
"""

from __future__ import annotations

import torch

from repro_torch.comm.cache import (CompiledPlan, FastPathCache,
                                    TransferPlanCache)
from repro_torch.comm.config import CommConfig, _env_bool
from repro_torch.comm.engine import MultiPathTransfer
from repro_torch.comm.passes import AutoSchedule, GraphPass
from repro_torch.comm.plan import TransferPlan
from repro_torch.comm.planner import PathPlanner
from repro_torch.comm.policy import PathPolicy, make_policy
from repro_torch.core.topology import Topology

_LATER = {
    "telemetry": "the telemetry/calibration slice",
    "profile_dir": "the telemetry/calibration slice",
    "faults": "the health slice",
}


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
        for field, slice_name in _LATER.items():
            if getattr(self.config, field):
                raise NotImplementedError(
                    f"CommConfig.{field} is not ported yet; it comes with "
                    f"{slice_name}")
        if _env_bool("REPRO_MP_TELEMETRY", False):
            raise NotImplementedError(
                "REPRO_MP_TELEMETRY is not ported yet; it comes with the "
                "telemetry/calibration slice")
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
                validate=self.config.validate)
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

    def capture(self, build_fn, *, schedule: str | None = None):
        """Whole-iteration capture — not ported yet."""
        raise NotImplementedError(
            "session.capture is not ported yet; it comes with the capture "
            "slice (with make_captured_jacobi_step)")

    # -- introspection ------------------------------------------------------
    def stats(self, reset: bool = False) -> dict:
        """Cache hits/misses, replays (``dispatches`` — a fused group is
        ONE dispatch), fast-path counters, captured graph totals,
        schedule counts, policy and topology. ``reset=True`` returns the
        snapshot then zeroes every windowed counter."""
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
        }

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return (f"CommSession(topology={self.topology.name!r}, "
                f"policy={self.policy.name!r}, "
                f"devices={self.topology.num_devices}, "
                f"device={self.device})")
