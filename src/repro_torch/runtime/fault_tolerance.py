"""Fault-tolerance runtime: failure detection, straggler mitigation,
elastic restart.

The counterpart of the reference's ``repro/runtime/fault_tolerance.py``.

At thousand-node scale the mean time between failures is shorter than a
training run, so the loop must (a) detect dead/slow workers, (b) restore
from the latest checkpoint, and (c) continue on a *different* device count
when spares are unavailable. This module provides those mechanics; on this
CPU container the "cluster" is simulated (heartbeats are injected by tests
/ the elastic driver re-creates meshes of different sizes), but every code
path — detection thresholds, EWMA straggler scoring, resumable data
streams, reshard-on-restore — is the real logic.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

from repro_torch.checkpoint.manager import CheckpointManager


# ------------------------------ heartbeats --------------------------------
@dataclasses.dataclass
class WorkerState:
    last_beat: float
    alive: bool = True


class HeartbeatMonitor:
    """Deadline-based failure detector over worker heartbeats."""

    def __init__(self, workers: list[str], timeout_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout_s = timeout_s
        self._clock = clock
        now = clock()
        self.workers = {w: WorkerState(last_beat=now) for w in workers}

    def beat(self, worker: str, at: float | None = None) -> None:
        st = self.workers[worker]
        st.last_beat = self._clock() if at is None else at
        st.alive = True

    def check(self, at: float | None = None) -> list[str]:
        """Returns newly-failed workers (missed deadline)."""
        now = self._clock() if at is None else at
        failed = []
        for name, st in self.workers.items():
            if st.alive and now - st.last_beat > self.timeout_s:
                st.alive = False
                failed.append(name)
        return failed

    def alive(self) -> list[str]:
        return [w for w, st in self.workers.items() if st.alive]


# --------------------------- straggler mitigation ---------------------------
class StragglerDetector:
    """EWMA step-time tracker; flags steps slower than ``factor`` × median.

    Mitigation at scale = re-dispatch the work or drop the slow participant
    from the synchronous group; the hook receives the decision.
    """

    def __init__(self, window: int = 32, factor: float = 3.0):
        self.window = window
        self.factor = factor
        self.history: deque[float] = deque(maxlen=window)
        self.flagged: list[tuple[int, float]] = []

    def observe(self, step: int, duration_s: float) -> bool:
        is_straggler = False
        if len(self.history) >= max(4, self.window // 4):
            med = sorted(self.history)[len(self.history) // 2]
            is_straggler = duration_s > self.factor * med
            if is_straggler:
                self.flagged.append((step, duration_s))
        self.history.append(duration_s)
        return is_straggler

    @property
    def median_s(self) -> float:
        if not self.history:
            return 0.0
        return sorted(self.history)[len(self.history) // 2]


# ------------------------------ elastic loop --------------------------------
@dataclasses.dataclass
class ResilientLoopConfig:
    checkpoint_every: int = 50
    keep_checkpoints: int = 3
    max_restarts: int = 5


class ResilientTrainLoop:
    """Checkpointed training loop with crash/elastic restart.

    ``build_fn(num_devices, ckpt)`` must return ``(step_fn, state,
    loader)`` for ``num_devices`` devices, restoring from the latest checkpoint
    if one exists (the CheckpointManager is passed in). The loop catches
    worker failures (exceptions from ``step_fn`` or injected via the
    monitor), re-builds at the surviving device count, and resumes from the
    checkpointed step — the data pipeline is deterministic in step, so the
    stream is replayed exactly.
    """

    def __init__(self, ckpt: CheckpointManager,
                 cfg: ResilientLoopConfig | None = None,
                 comm=None):
        self.ckpt = ckpt
        self.cfg = cfg or ResilientLoopConfig()
        self.straggler = StragglerDetector()
        self.events: list[dict] = []
        #: Optional CommSession: when attached, the loop drains its
        #: health event log (link faults, retries, quarantines,
        #: re-admissions — DESIGN §4.6) into ``self.events`` each step,
        #: so one timeline interleaves training failures with comm
        #: degradation.
        self.comm = comm

    def _drain_comm_events(self, step: int) -> None:
        """Fold the comm session's pending health events into the loop's
        event stream, stamped with the training step. Draining clears
        the session's log (no double-reporting) and preserves its
        counters — the ``stats()['health']`` window contract."""
        if self.comm is None:
            return
        for ev in self.comm.drain_health_events():
            self.events.append({"kind": "comm_health", "step": step,
                                "event": ev})

    def run(self, build_fn, total_steps: int,
            fail_at: dict[int, int] | None = None,
            num_devices: int | None = None):
        """``fail_at``: {step: new_device_count} injected failures (tests).
        ``num_devices``: the first build's device count (default: the
        attached session's, else 1).

        Returns (final_state, losses, events).
        """
        fail_at = dict(fail_at or {})
        if num_devices is None:
            num_devices = self.comm.num_devices if self.comm is not None \
                else 1
        restarts = 0
        losses = []
        step_fn, state, loader = build_fn(num_devices, self.ckpt)
        step = int(state["opt"]["step"])
        while step < total_steps:
            if step in fail_at and fail_at[step] is not None:
                # injected failure: shrink the cluster and restart
                new_n = fail_at.pop(step)
                restarts += 1
                if restarts > self.cfg.max_restarts:
                    # Terminal path must not lose state: flush pending
                    # checkpoint writes and record the exhaustion BEFORE
                    # raising, so post-mortem tooling sees a complete
                    # event log and a consistent checkpoint directory.
                    self.events.append({"kind": "exhausted", "step": step,
                                        "restarts": restarts,
                                        "budget": self.cfg.max_restarts})
                    self._drain_comm_events(step)
                    self.ckpt.wait()
                    raise RuntimeError("restart budget exhausted")
                self.events.append({"kind": "failure", "step": step,
                                    "devices": new_n})
                self.ckpt.wait()
                num_devices = new_n
                step_fn, state, loader = build_fn(num_devices, self.ckpt)
                step = int(state["opt"]["step"])
                continue
            batch = loader(step)
            t0 = time.monotonic()
            state, metrics = step_fn(state, batch)
            loss = float(metrics["loss"])
            dt = time.monotonic() - t0
            if self.straggler.observe(step, dt):
                self.events.append({"kind": "straggler", "step": step,
                                    "duration_s": dt})
            self._drain_comm_events(step)
            losses.append(loss)
            step += 1
            if step % self.cfg.checkpoint_every == 0 or step == total_steps:
                self.ckpt.save(step, state, metadata={"loss": loss})
                self.events.append({"kind": "checkpoint", "step": step})
        self.ckpt.wait()
        return state, losses, self.events
