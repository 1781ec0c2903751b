"""CommConfig — the single typed configuration for the comm session API.

Absorbs the ``REPRO_MP_*`` environment parsing that used to be inlined in
``repro/core/paths.py`` (and ``REPRO_PLAN_CACHE_SIZE`` from
``repro/core/plan_cache.py``). New code constructs a :class:`CommConfig`
explicitly (or via :meth:`CommConfig.from_env`) and hands it to a
:class:`~repro_torch.comm.session.CommSession`; the environment variables remain
supported only through :meth:`from_env` (paper §4.4 "Environment
Configuration").

Environment variables read by :meth:`from_env`:

* ``REPRO_MP_MAX_PATHS``   — max concurrent paths (default 4)
* ``REPRO_MP_CHUNK_BYTES`` — target chunk size (default 1 MiB, paper §4.3)
* ``REPRO_MP_MAX_CHUNKS``  — max chunks per path (default 8)
* ``REPRO_MP_HOST_PATH``   — "1"/"0" include the host-staged path
* ``REPRO_MP_THRESHOLD``   — multipath engagement threshold (default 2 MiB,
  paper §5.3: below it the single direct path wins)
* ``REPRO_MP_WINDOW``      — default message window for ``session.send``
* ``REPRO_MP_POLICY``      — path policy name (greedy | round_robin | tuner)
* ``REPRO_MP_SCHEDULE``    — chunk-interleaving scheduler applied to the
  lowered transfer graph (round_robin | depth_first | critical_path |
  overlap | auto; DESIGN.md §2.2)
* ``REPRO_MP_FASTPATH``    — "1"/"0" steady-state dispatch fast path
  (default on; DESIGN.md §2.3): repeat traffic skips planner, lowering,
  scheduler pass, validation, and digest entirely
* ``REPRO_MP_VALIDATE``    — "miss" (default) validates plans/graphs only
  when the fast path misses; "always" re-validates on every dispatch,
  fast-path hits included (the §4.5 safety escape hatch)
* ``REPRO_PLAN_CACHE_SIZE``— compiled-plan LRU capacity (default 64)
* ``REPRO_MP_TELEMETRY``   — "1"/"0" per-dispatch stage-timing telemetry
  (default off; DESIGN.md §4.4c — off costs one boolean per dispatch)
* ``REPRO_MP_TELEMETRY_CAPACITY`` — telemetry ring-buffer size (2048)
* ``REPRO_MP_PROFILE_DIR`` — calibration-profile directory; when set, the
  session loads the profile matching its topology digest on init and
  ``session.calibrate(persist=True)`` writes there
* ``REPRO_MP_COLLECTIVES`` — all-reduce layout on hierarchical
  topologies (auto | flat | two_level; DESIGN §3.1 — ``auto`` lets the
  §4.4 tier model arbitrate, flat is forced on single-island topologies)
* ``REPRO_MP_HEALTH``      — "1"/"0" link-health monitoring + degraded-mode
  dispatch (default on; DESIGN §4.6 — off skips monitor construction; the
  healthy dispatch path costs one boolean either way)
* ``REPRO_MP_FAULTS``      — chaos schedule applied by a
  :class:`repro_torch.comm.health.FaultInjector`
  (e.g. ``"fail@12:0-1;restore@40:0-1"``; empty = no injector)
* ``REPRO_MP_DROOP_THRESHOLD`` — measured/modeled residual ratio above
  which a sample counts as a droop breach (default 2.0)
* ``REPRO_MP_DROOP_SAMPLES``   — consecutive breaches before quarantine (3)
* ``REPRO_MP_RETRY_LIMIT``     — dispatch retries per ladder rung (2)
* ``REPRO_MP_BACKOFF_S``       — base of the bounded exponential retry
  backoff, seconds (default 0.001; doubles per retry, capped at 50 ms)
* ``REPRO_MP_PROBE_HEALTHY``   — consecutive healthy probes to readmit (2)
* ``REPRO_MP_PROBE_INTERVAL``  — dispatches between automatic probes (16)
* ``REPRO_MP_RECOVERY_RATIO``  — served/nominal bandwidth floor a probe
  accepts as healthy (default 0.5)
"""

from __future__ import annotations

import dataclasses
import os

_MiB = 1 << 20

#: Policy names accepted by :func:`repro_torch.comm.policy.make_policy`.
POLICY_NAMES = ("greedy", "round_robin", "tuner")

#: Scheduler (graph-pass) names accepted by
#: :func:`repro_torch.comm.passes.make_schedule` — ``round_robin`` is today's
#: lowering order (identity pass), ``overlap`` list-schedules over the
#: resource-lane makespan model to hide copies behind compute, ``auto``
#: model-scores every candidate order and picks the winner before
#: compiling (DESIGN.md §2.2).
SCHEDULE_NAMES = ("round_robin", "depth_first", "critical_path",
                  "overlap", "auto")

#: All-reduce layout names (DESIGN §3.1): ``auto`` lets the §4.4 tier
#: model pick per topology, ``flat``/``two_level`` force the layout (the
#: two-level decomposition only differs on >1-island topologies).
COLLECTIVE_STRATEGIES = ("auto", "flat", "two_level")

#: Validation modes for compiled dispatch (DESIGN.md §4.5): ``miss``
#: validates a plan/graph only when it is (re)built — the fast path trusts
#: epoch-stamped entries — while ``always`` re-runs ``validate_plan`` and
#: ``graph.validate()`` on every dispatch, fast-path hits included.
VALIDATE_MODES = ("miss", "always")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _env_bool(name: str, default: bool) -> bool:
    v = os.environ.get(name)
    if v is None:
        return default
    return v.strip() not in ("0", "false", "False", "")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


@dataclasses.dataclass(frozen=True)
class CommConfig:
    """Frozen configuration for one :class:`~repro_torch.comm.session.CommSession`.

    The defaults reproduce the paper's tuned settings (§4.3/§4.4): up to 4
    concurrent paths, ~1 MiB pipeline chunks capped at 8 per path, host path
    off, multipath engaging at 2 MiB.
    """

    max_paths: int = 4
    chunk_bytes: int = _MiB
    max_chunks: int = 8
    include_host: bool = False
    multipath_threshold: int = 2 * _MiB
    window: int = 1
    policy: str = "greedy"
    schedule: str = "round_robin"
    fastpath: bool = True
    validate: str = "miss"
    cache_capacity: int = 64
    axis_name: str = "dev"
    telemetry: bool = False
    telemetry_capacity: int = 2048
    profile_dir: str = ""
    collective_strategy: str = "auto"
    health: bool = True
    faults: str = ""
    droop_threshold: float = 2.0
    droop_samples: int = 3
    retry_limit: int = 2
    backoff_base_s: float = 0.001
    probe_healthy: int = 2
    probe_interval: int = 16
    recovery_ratio: float = 0.5

    def __post_init__(self) -> None:
        if self.max_paths < 1:
            raise ValueError(f"max_paths must be >= 1, got {self.max_paths}")
        if self.chunk_bytes < 1:
            raise ValueError(
                f"chunk_bytes must be >= 1, got {self.chunk_bytes}")
        if self.max_chunks < 1:
            raise ValueError(
                f"max_chunks must be >= 1, got {self.max_chunks}")
        if self.multipath_threshold < 0:
            raise ValueError("multipath_threshold must be >= 0, got "
                             f"{self.multipath_threshold}")
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window}")
        if self.cache_capacity < 1:
            raise ValueError(
                f"cache_capacity must be >= 1, got {self.cache_capacity}")
        if self.policy not in POLICY_NAMES:
            raise ValueError(f"unknown policy {self.policy!r}; "
                             f"expected one of {POLICY_NAMES}")
        if self.schedule not in SCHEDULE_NAMES:
            raise ValueError(f"unknown schedule {self.schedule!r}; "
                             f"expected one of {SCHEDULE_NAMES}")
        if self.validate not in VALIDATE_MODES:
            raise ValueError(f"unknown validate mode {self.validate!r}; "
                             f"expected one of {VALIDATE_MODES}")
        if not self.axis_name:
            raise ValueError("axis_name must be non-empty")
        if self.telemetry_capacity < 1:
            raise ValueError("telemetry_capacity must be >= 1, got "
                             f"{self.telemetry_capacity}")
        if self.collective_strategy not in COLLECTIVE_STRATEGIES:
            raise ValueError(
                f"unknown collective strategy {self.collective_strategy!r}; "
                f"expected one of {COLLECTIVE_STRATEGIES}")
        if self.droop_threshold <= 0:
            raise ValueError("droop_threshold must be > 0, got "
                             f"{self.droop_threshold}")
        if self.droop_samples < 1:
            raise ValueError(
                f"droop_samples must be >= 1, got {self.droop_samples}")
        if self.retry_limit < 0:
            raise ValueError(
                f"retry_limit must be >= 0, got {self.retry_limit}")
        if self.backoff_base_s < 0:
            raise ValueError(
                f"backoff_base_s must be >= 0, got {self.backoff_base_s}")
        if self.probe_healthy < 1:
            raise ValueError(
                f"probe_healthy must be >= 1, got {self.probe_healthy}")
        if self.probe_interval < 1:
            raise ValueError(
                f"probe_interval must be >= 1, got {self.probe_interval}")
        if not 0.0 < self.recovery_ratio <= 1.0:
            raise ValueError("recovery_ratio must be in (0, 1], got "
                             f"{self.recovery_ratio}")

    @classmethod
    def from_env(cls, **overrides) -> "CommConfig":
        """Build a config from the legacy ``REPRO_MP_*`` environment.

        Keyword ``overrides`` take precedence over the environment, which
        takes precedence over the defaults.
        """
        values = dict(
            max_paths=_env_int("REPRO_MP_MAX_PATHS", cls.max_paths),
            chunk_bytes=_env_int("REPRO_MP_CHUNK_BYTES", cls.chunk_bytes),
            max_chunks=_env_int("REPRO_MP_MAX_CHUNKS", cls.max_chunks),
            include_host=_env_bool("REPRO_MP_HOST_PATH", cls.include_host),
            multipath_threshold=_env_int("REPRO_MP_THRESHOLD",
                                         cls.multipath_threshold),
            window=_env_int("REPRO_MP_WINDOW", cls.window),
            policy=os.environ.get("REPRO_MP_POLICY", cls.policy),
            schedule=os.environ.get("REPRO_MP_SCHEDULE", cls.schedule),
            fastpath=_env_bool("REPRO_MP_FASTPATH", cls.fastpath),
            validate=os.environ.get("REPRO_MP_VALIDATE", cls.validate),
            cache_capacity=_env_int("REPRO_PLAN_CACHE_SIZE",
                                    cls.cache_capacity),
            telemetry=_env_bool("REPRO_MP_TELEMETRY", cls.telemetry),
            telemetry_capacity=_env_int("REPRO_MP_TELEMETRY_CAPACITY",
                                        cls.telemetry_capacity),
            profile_dir=os.environ.get("REPRO_MP_PROFILE_DIR",
                                       cls.profile_dir),
            collective_strategy=os.environ.get("REPRO_MP_COLLECTIVES",
                                               cls.collective_strategy),
            health=_env_bool("REPRO_MP_HEALTH", cls.health),
            faults=os.environ.get("REPRO_MP_FAULTS", cls.faults),
            droop_threshold=_env_float("REPRO_MP_DROOP_THRESHOLD",
                                       cls.droop_threshold),
            droop_samples=_env_int("REPRO_MP_DROOP_SAMPLES",
                                   cls.droop_samples),
            retry_limit=_env_int("REPRO_MP_RETRY_LIMIT", cls.retry_limit),
            backoff_base_s=_env_float("REPRO_MP_BACKOFF_S",
                                      cls.backoff_base_s),
            probe_healthy=_env_int("REPRO_MP_PROBE_HEALTHY",
                                   cls.probe_healthy),
            probe_interval=_env_int("REPRO_MP_PROBE_INTERVAL",
                                    cls.probe_interval),
            recovery_ratio=_env_float("REPRO_MP_RECOVERY_RATIO",
                                      cls.recovery_ratio),
        )
        values.update(overrides)
        return cls(**values)

    def replace(self, **changes) -> "CommConfig":
        return dataclasses.replace(self, **changes)
