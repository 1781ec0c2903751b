"""The port's fault-tolerance runtime against the reference's.

The same train loop runs on both packages: a reduced SmolLM-360M from the
reference's weights, checkpoints every 5 steps, and the same injected
failure schedule (``fail_at``). The loops must record the same events at
the same steps (straggler events, which depend on wall time, aside), the
same number of losses, each within rtol 1e-5, and end at the same step.
The heartbeat monitor and straggler detector give the same decisions on
the same sequences, and an attached session's health events are folded
into the loop's timeline once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.comm import CommConfig as JCommConfig
from repro.comm import CommSession as JCommSession
from repro.configs import get_config as jget_config
from repro.core import Topology as JTopology
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticDataset as JSyntheticDataset
from repro.optim import OptimConfig as JOptimConfig
from repro.runtime import HeartbeatMonitor as JHeartbeatMonitor
from repro.runtime import ResilientLoopConfig as JResilientLoopConfig
from repro.runtime import ResilientTrainLoop as JResilientTrainLoop
from repro.runtime import StragglerDetector as JStragglerDetector
from repro.training import TrainStepConfig as JTrainStepConfig
from repro.training import init_state as jinit_state
from repro.training import make_train_step as jmake_train_step

from repro_torch.carry import state_from_numpy
from repro_torch.checkpoint import CheckpointManager
from repro_torch.comm import CommConfig, CommSession
from repro_torch.configs import get_config
from repro_torch.core.topology import Topology
from repro_torch.data import DataConfig, SyntheticDataset, batch_to
from repro_torch.optim import OptimConfig
from repro_torch.runtime import (HeartbeatMonitor, ResilientLoopConfig,
                                 ResilientTrainLoop, StragglerDetector)
from repro_torch.training import TrainStepConfig, make_train_step

OPT = dict(learning_rate=1e-3, warmup_steps=2, total_steps=20)


def reference_loop(tmp_path, total, fail_at):
    cfg = jget_config("smollm_360m").reduced()
    opt = JOptimConfig(**OPT)
    ds = JSyntheticDataset(cfg, JDataConfig(seq_len=16, global_batch=4))
    init = jinit_state(cfg, opt)

    def build(num_devices, ckpt):
        step_fn = jax.jit(jmake_train_step(cfg, JTrainStepConfig(), opt))
        state = init
        restored = ckpt.restore_latest(jax.eval_shape(lambda: state))
        if restored is not None:
            state = restored[0]
        return (step_fn, state,
                lambda s: {k: jnp.asarray(v)
                           for k, v in ds.batch_at(s).items()})

    ckpt = JCheckpointManager(str(tmp_path / "ref"), keep=2,
                              async_save=False)
    loop = JResilientTrainLoop(ckpt, JResilientLoopConfig(
        checkpoint_every=5))
    state, losses, events = loop.run(build, total_steps=total,
                                     fail_at=dict(fail_at))
    return init, state, losses, events


def port_loop(tmp_path, init, total, fail_at):
    cfg = get_config("smollm_360m").reduced()
    opt = OptimConfig(**OPT)
    ds = SyntheticDataset(cfg, DataConfig(seq_len=16, global_batch=4))
    builds = []

    def build(num_devices, ckpt):
        builds.append(num_devices)
        step_fn = make_train_step(cfg, TrainStepConfig(), opt, device="cpu")
        state = state_from_numpy(jax.tree.map(np.asarray, init))
        restored = ckpt.restore_latest(state)
        if restored is not None:
            state = restored[0]
        return step_fn, state, lambda s: batch_to(ds.batch_at(s), "cpu")

    ckpt = CheckpointManager(str(tmp_path / "port"), keep=2,
                             async_save=False)
    loop = ResilientTrainLoop(ckpt, ResilientLoopConfig(checkpoint_every=5))
    state, losses, events = loop.run(build, total_steps=total,
                                     fail_at=dict(fail_at), num_devices=8)
    return state, losses, events, builds


def timeline(events):
    return [{k: v for k, v in e.items() if k != "duration_s"}
            for e in events if e["kind"] != "straggler"]


@pytest.mark.parametrize("fail_at", [{6: 4}, {3: 4, 9: 2}])
def test_resilient_loop_matches_the_reference(tmp_path, fail_at):
    init, jstate, jlosses, jevents = reference_loop(tmp_path, 12, fail_at)
    state, losses, events, builds = port_loop(tmp_path, init, 12, fail_at)
    assert timeline(events) == timeline(jevents)
    assert builds == [8] + [fail_at[s] for s in sorted(fail_at)]
    assert len(losses) == len(jlosses) >= 12
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 12


def fake_build(step_type):
    def build(num_devices, ckpt):
        state = {"opt": {"step": step_type(0)}}

        def step_fn(st, batch):
            return ({"opt": {"step": st["opt"]["step"] + 1}},
                    {"loss": step_type(1)})
        return step_fn, state, lambda s: {}
    return build


def test_exhaustion_records_before_raising(tmp_path):
    jloop = JResilientTrainLoop(JCheckpointManager(
        str(tmp_path / "a"), async_save=False),
        JResilientLoopConfig(max_restarts=0))
    loop = ResilientTrainLoop(CheckpointManager(
        str(tmp_path / "b"), async_save=False),
        ResilientLoopConfig(max_restarts=0))
    with pytest.raises(RuntimeError, match="restart budget exhausted"):
        jloop.run(fake_build(lambda x: jnp.asarray(x, jnp.int32)),
                  total_steps=8, fail_at={2: 4})
    with pytest.raises(RuntimeError, match="restart budget exhausted"):
        loop.run(fake_build(lambda x: torch.tensor(x, dtype=torch.int32)),
                 total_steps=8, fail_at={2: 4})
    assert timeline(loop.events) == timeline(jloop.events)


def test_loop_drains_comm_health_events(tmp_path):
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("dev",))
    jsess = JCommSession(JCommConfig(multipath_threshold=1),
                         mesh=mesh, topology=JTopology.full_mesh(4))
    sess = CommSession(CommConfig(multipath_threshold=1), device="cpu",
                       topology=Topology.full_mesh(4))
    jsess.monitor.quarantine_link((0, 1), reason="droop")
    sess.monitor.quarantine_link((0, 1), reason="droop")
    jloop = JResilientTrainLoop(JCheckpointManager(
        str(tmp_path / "a"), async_save=False), comm=jsess)
    loop = ResilientTrainLoop(CheckpointManager(
        str(tmp_path / "b"), async_save=False), comm=sess)
    jloop.run(fake_build(lambda x: jnp.asarray(x, jnp.int32)), total_steps=2)
    loop.run(fake_build(lambda x: torch.tensor(x, dtype=torch.int32)),
             total_steps=2)
    kinds = lambda evs: [(e["kind"], e["step"], e.get("event", {}).get(
        "kind"), e.get("event", {}).get("link")) for e in evs]
    assert kinds(loop.events) == kinds(jloop.events)
    comm = [e for e in loop.events if e["kind"] == "comm_health"]
    assert comm and tuple(comm[0]["event"]["link"]) == (0, 1)
    assert sess.drain_health_events() == []


def test_heartbeat_monitor_matches():
    t = [0.0]
    jmon = JHeartbeatMonitor(["w0", "w1", "w2"], timeout_s=5.0,
                             clock=lambda: t[0])
    mon = HeartbeatMonitor(["w0", "w1", "w2"], timeout_s=5.0,
                           clock=lambda: t[0])
    for now, beats in ((1.0, ["w0"]), (4.0, ["w1"]), (6.5, ["w0"]),
                       (9.5, []), (10.0, ["w2"]), (16.0, [])):
        t[0] = now
        for w in beats:
            jmon.beat(w)
            mon.beat(w)
        assert mon.check() == jmon.check()
        assert mon.alive() == jmon.alive()


def test_straggler_detector_matches():
    rs = np.random.RandomState(0)
    times = list(rs.rand(40) + 1.0)
    times[20] = times[33] = 9.0
    jdet, det = JStragglerDetector(window=16), StragglerDetector(window=16)
    for i, dt in enumerate(times):
        assert det.observe(i, dt) == jdet.observe(i, dt)
    assert det.flagged == jdet.flagged and det.median_s == jdet.median_s
