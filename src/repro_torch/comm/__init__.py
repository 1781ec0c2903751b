"""repro_torch.comm — the communication API (paper Algorithm 1).

* :mod:`repro_torch.comm.config`  — :class:`CommConfig` (+ ``from_env``)
* :mod:`repro_torch.comm.plan`    — transfer-plan data model
* :mod:`repro_torch.comm.graph`   — :class:`TransferGraph` DAG IR
* :mod:`repro_torch.comm.passes`  — chunk-interleaving scheduler passes
* :mod:`repro_torch.comm.policy`  — pluggable :class:`PathPolicy` strategies
* :mod:`repro_torch.comm.planner` — route enumeration + plan construction
* :mod:`repro_torch.comm.cache`   — captured-graph LRU + dispatch fast path
* :mod:`repro_torch.comm.telemetry` — per-dispatch stage-timing recorder (§4.4c)
* :mod:`repro_torch.comm.calibration` — §4.4 terms fitted from the samples
* :mod:`repro_torch.comm.capture` — whole-iteration step capture
* :mod:`repro_torch.comm.collectives` — bidirectional-ring collectives
* :mod:`repro_torch.comm.health`  — link faults, health monitor (§4.6)
* :mod:`repro_torch.comm.engine`  — the engine on the ``multipath_dma`` kernel
* :mod:`repro_torch.comm.session` — :class:`CommSession` facade
"""

from repro_torch.comm.config import (  # noqa: F401
    POLICY_NAMES, SCHEDULE_NAMES, VALIDATE_MODES, CommConfig)
from repro_torch.comm.plan import (  # noqa: F401
    PathAssignment, TransferGroup, TransferPlan, TransferRequest)
from repro_torch.comm.graph import (  # noqa: F401
    ComputeNode, CopyNode, DepEdge, TransferGraph, canonical_digest, lower)
from repro_torch.comm.passes import (  # noqa: F401
    AutoSchedule, CriticalPathSchedule, DepthFirstSchedule, GraphPass,
    RoundRobinSchedule, apply_schedule, check_pass, make_schedule,
    reindex, run_pipeline)
from repro_torch.comm.policy import (  # noqa: F401
    GreedyBandwidthPolicy, PathPolicy, RoundRobinPolicy, TunerPolicy,
    contention_scaled, make_policy)
from repro_torch.comm.planner import PathPlanner  # noqa: F401
from repro_torch.comm.cache import (  # noqa: F401
    CompiledPlan, FastPathCache, FastPathEntry, PlanLifecycle,
    TransferPlanCache, compile_plan)
from repro_torch.comm.telemetry import (  # noqa: F401
    DispatchSample, StageTimings, TimelineRecorder)
from repro_torch.comm.calibration import (  # noqa: F401
    PROFILE_VERSION, CalibrationFitter, CalibrationProfile,
    modeled_sample_time_s, modeled_vs_measured)
from repro_torch.comm.capture import (  # noqa: F401
    BufferRef, BufferSpec, CapturedStep, StepCapture, StepProgram,
    captured_psum, lower_step)
from repro_torch.comm.collectives import (  # noqa: F401
    bidir_ring_all_gather, bidir_ring_reduce_scatter, modeled_all_reduce_s,
    multipath_all_reduce, multipath_all_to_all, psum_via_multipath,
    select_all_reduce_strategy, tier_bandwidths_gbps, two_level_all_reduce)
from repro_torch.comm.health import (  # noqa: F401
    LADDER, CommFaultError, FaultEvent, FaultInjector, HealthMonitor,
    HealthStats, LinkFaultError)
from repro_torch.comm.engine import (  # noqa: F401
    GroupKey, MultiPathTransfer, group_signature, multipath_send_local,
    plan_signature)
from repro_torch.comm.session import (  # noqa: F401
    BoundCollectives, CollectiveKey, CommSession)
