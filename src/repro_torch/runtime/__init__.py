"""Fault tolerance: heartbeats, straggler detection, the resilient loop."""

from repro_torch.runtime.fault_tolerance import (  # noqa: F401
    HeartbeatMonitor, ResilientLoopConfig, ResilientTrainLoop,
    StragglerDetector, WorkerState)
