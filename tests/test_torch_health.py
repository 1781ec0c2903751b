"""The port's link-fault subsystem against the reference's (DESIGN §4.6).

Every case runs the same fault schedule and the same traffic, made from
a seed with numpy, through a reference ``CommSession`` on 4 CPU devices
and a port ``CommSession(device="cpu")``, each on its own copy of one
topology (``carry.topology_from_spec``). After every operation the two
must agree exactly: the drained health event logs (kind, link, dispatch,
rung, reason, ...), ``stats()["health"]``, the digests of the graphs each
dispatch launched (probe sends included), and the delivered bytes.

Covered: the ``REPRO_MP_FAULTS`` grammar (malformed entries, ``flap``
expansion, ``seeded``), fail / degrade / restore / drop / flap schedules
over ``send``, ``exchange`` and ``bidirectional``, droop quarantine and
probe readmission, the host-relay rung and ``CommFaultError``, the
healthy path's contracts, captured steps through a failed link,
``ServeEngine`` surfacing a ``ladder`` event, the stats schema, and that
a ``ValueError`` from a replay or a program build is never relayed
through the host.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import CommConfig as JCommConfig
from repro.comm import CommSession as JCommSession
from repro.comm import health as jhealth
from repro.comm import telemetry as jtel
from repro.comm.planner import PathPlanner as JPathPlanner
from repro.configs import REGISTRY as JREGISTRY
from repro.configs import load_all as jload_all
from repro.core import Link as JLink
from repro.core import Topology as JTopology
from repro.models import transformer as jtfm
from repro.serving import ServeEngine as JServeEngine
from repro.serving.engine import (
    make_captured_decode_step as jmake_captured_decode_step)

from repro_torch import carry
from repro_torch.comm import (LADDER, CommConfig, CommFaultError,
                              CommSession, FaultEvent, FaultInjector,
                              HealthMonitor, HealthStats, LinkFaultError)
from repro_torch.comm import health
from repro_torch.comm import engine as tengine
from repro_torch.comm import telemetry as ttel
from repro_torch.comm.engine import NoRouteError
from repro_torch.comm.planner import PathPlanner
from repro_torch.configs import get_config
from repro_torch.core.topology import Topology
from repro_torch.serving import ServeEngine, make_captured_decode_step

MiB = 1 << 20


def jmesh(n):
    return jax.sharding.Mesh(np.array(jax.devices()[:n]), ("dev",))


def port_topology(jtopo):
    return carry.topology_from_spec(carry.topology_spec(jtopo))


def payload(seed, n):
    """(numpy, torch, jax) of one seeded float32 message."""
    x = np.random.RandomState(seed).randn(n).astype(np.float32)
    return x, torch.from_numpy(x.copy()), jnp.asarray(x)


def as_numpy(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def launched_digests(engine):
    """Record the digest of every entry ``engine`` launches (sends,
    groups, probes and captured steps) into the returned list."""
    log = []
    launch, launch_step = engine._launch, engine._launch_step

    def rec(entry, messages, *, block):
        log.append(entry.digest)
        return launch(entry, messages, block=block)

    def rec_step(entry, arrays, *, block):
        log.append(entry.digest)
        return launch_step(entry, arrays, block=block)

    engine._launch, engine._launch_step = rec, rec_step
    return log


class Pair:
    """A reference session and a port session on copies of one topology,
    driven in lockstep and compared after every operation.

    ``layout`` places the port session's logical devices: ``"stacked"``
    (``device="cpu"``, rows of one operand) or ``"peer"``
    (``devices=["cpu"] * n``, one device a logical device). The class
    attribute is the default, so a module can run these cases on peers.
    """

    layout = "stacked"

    def __init__(self, jtopo, *, defaults: bool = False,
                 layout: str | None = None, **cfg):
        if not defaults:
            cfg.setdefault("multipath_threshold", 1)
            cfg.setdefault("max_paths", 3)
        self.j = JCommSession(JCommConfig(**cfg),
                              mesh=jmesh(jtopo.num_devices),
                              topology=jtopo)
        layout = layout or self.layout
        place = ({"device": "cpu"} if layout == "stacked"
                 else {"devices": ["cpu"] * jtopo.num_devices})
        self.t = CommSession(CommConfig(**cfg), topology=port_topology(jtopo),
                             **place)
        self.jlog = launched_digests(self.j.engine)
        self.tlog = launched_digests(self.t.engine)
        self.events = []

    def mutate(self, method, *args):
        """Apply one topology fault-model call to both copies."""
        getattr(self.j.topology, method)(*args)
        getattr(self.t.topology, method)(*args)

    def check(self, jout=(), tout=()):
        for a, b in zip(jout, tout):
            np.testing.assert_array_equal(as_numpy(b), as_numpy(a))
        assert self.t.stats()["health"] == self.j.stats()["health"]
        jev, tev = self.j.drain_health_events(), self.t.drain_health_events()
        assert tev == jev
        self.events += tev
        assert self.tlog == self.jlog
        assert self.t.planner.quarantined == self.j.planner.quarantined

    def placed(self, out, dst):
        """``out`` was delivered on the port device holding ``dst``."""
        assert out.device == self.t.engine._home(dst)

    def send(self, seed, n, src, dst, **kw):
        x, tx, jx = payload(seed, n)
        tout = self.t.send(tx, src, dst, **kw)
        jout = self.j.send(jx, src, dst, **kw)
        np.testing.assert_array_equal(as_numpy(tout), x)
        self.placed(tout, dst)
        self.check([jout], [tout])

    def exchange(self, seed, n, pairs, **kw):
        msgs = [payload(seed + i, n) for i in range(len(pairs))]
        tout = self.t.exchange([(m[1], s, d)
                                for m, (s, d) in zip(msgs, pairs)], **kw)
        jout = self.j.exchange([(m[2], s, d)
                                for m, (s, d) in zip(msgs, pairs)], **kw)
        for m, o, (_, d) in zip(msgs, tout, pairs):
            np.testing.assert_array_equal(as_numpy(o), m[0])
            self.placed(o, d)
        self.check(jout, tout)

    def bidirectional(self, seed, n, src, dst, **kw):
        x, tx, jx = payload(seed, n)
        tout = self.t.bidirectional(tx, src, dst, **kw)
        jout = self.j.bidirectional(jx, src, dst, **kw)
        for o, d in zip(tout, (dst, src)):
            np.testing.assert_array_equal(as_numpy(o), x)
            self.placed(o, d)
        self.check(jout, tout)

    def probe(self):
        assert self.t.probe_links() == self.j.probe_links()
        self.check()


# ------------------------------ the grammar ----------------------------------

SPECS = [
    "fail@3:0-1; degrade@5x4:0-2*0.25, restore@9:0-1",
    "flap@2~3x2:0-1",
    "drop@5x2:0-1;fail@1:2-3",
    "degrade@4:1-2*0.5",
    "fail@0:-1-0",
    "",
    "explode@1:0-1",
    "fail:0-1",
    "flap@2x2:0-1",
    "degrade@1:0-1*1.5",
    "degrade@1:0-1",
    "fail@1:0-1;bogus",
]


def _events(inj):
    return [(e.at, e.action, e.link, e.ratio, e.duration)
            for e in inj._events]


def _parse(mod, spec):
    try:
        return _events(mod.FaultInjector.from_spec(spec))
    except ValueError as exc:
        return ("ValueError", str(exc))


@pytest.mark.parametrize("spec", SPECS)
def test_from_spec_equals_reference(spec):
    assert _parse(health, spec) == _parse(jhealth, spec)


def test_flap_expands_to_cycles():
    inj = FaultInjector.from_spec("flap@2~3x2:0-1")
    assert [(e.at, e.action) for e in inj._events] == [
        (2, "fail"), (5, "restore"), (8, "fail"), (11, "restore")]


@pytest.mark.parametrize("seed", range(5))
def test_seeded_schedule_equals_reference(seed):
    jtopo = JTopology.full_mesh(4)
    a = FaultInjector.seeded(port_topology(jtopo), seed, events=3)
    b = jhealth.FaultInjector.seeded(jtopo, seed, events=3)
    assert _events(a) == _events(b) and a.active


@pytest.mark.parametrize("kw", [dict(at=-1, action="fail"),
                                dict(at=0, action="nope"),
                                dict(at=0, action="degrade", ratio=0.0)])
def test_fault_event_validation_equals_reference(kw):
    for mod in (health, jhealth):
        with pytest.raises(ValueError):
            mod.FaultEvent(link=(0, 1), **kw)
    assert FaultEvent(at=1, action="degrade", link=(0, 1),
                      ratio=0.5).ratio == 0.5


# ------------------------- schedules over traffic ----------------------------

SCHEDULES = [
    "fail@1:0-1;restore@4:0-1",
    "degrade@1x3:0-1*0.25",
    "restore@2:0-1;fail@3:1-0",
    "drop@2x2:0-1",
    "flap@1~2x2:0-1",
    "drop@2x2:0-2;degrade@4x3:0-3*0.25;flap@5~1x1:0-1",
]


def _traffic(pair, kind, i):
    if kind == "send":
        pair.send(i, 4096, 0, 1)
    elif kind == "exchange":
        pair.exchange(10 * i, 4096, [(0, 1), (2, 3), (1, 0)])
    else:
        pair.bidirectional(i, 4096, 0, 1)


@pytest.mark.parametrize("spec", SCHEDULES)
@pytest.mark.parametrize("kind", ["send", "exchange", "bidirectional"])
def test_schedule_equals_reference(spec, kind):
    """Every dispatch delivers bitwise; events, health stats and launched
    digests equal the reference's after each one."""
    pair = Pair(JTopology.full_mesh(4), faults=spec)
    for i in range(8):
        _traffic(pair, kind, i)
    assert any(e["kind"] == "inject" for e in pair.events)
    assert pair.t.faults.applied == pair.j.faults.applied


def test_chip_schedule_counts():
    """The schedule ``chip_smoke.py`` path I drives: 20 sends of 16 MiB
    with ``max_paths=3`` on default settings. Its counts are pinned (the
    card must give the same) and equal the reference's."""
    spec = "drop@2x2:0-2;degrade@6x4:0-3*0.25;flap@12~2x2:0-1"
    pair = Pair(JTopology.full_mesh(4), defaults=True, faults=spec)
    for i in range(20):
        pair.send(i, 4 * MiB, 0, 1, max_paths=3)
    h = pair.t.stats()["health"]
    assert {k: h[k] for k in ("retries", "replans", "faults_seen")} == {
        "retries": 1, "replans": 1, "faults_seen": 7}
    kinds = [e["kind"] for e in pair.events]
    assert kinds.count("inject") == 7 and "probe_ok" in kinds


def test_midtraffic_failure_restores_the_pre_fault_digest():
    """The acceptance scenario: a mid-traffic failure re-plans around
    (0, 1) at ladder level 1; after restore the steady-state plan digest
    is the pre-fault one and the graph comes from the plan cache."""
    pair = Pair(JTopology.full_mesh(4))
    pair.exchange(0, 4096, [(0, 1), (2, 3)])
    pre = pair.t.describe(0, 1, 4096 * 4)["graph"]["digest"]
    assert pre == pair.j.describe(0, 1, 4096 * 4)["graph"]["digest"]
    pair.mutate("fail_link", 0, 1)
    pair.exchange(0, 4096, [(0, 1), (2, 3)])
    assert pair.t.stats()["health"]["ladder_level"] == 1
    for p in pair.t.plan(0, 1, 4096 * 4).paths:
        assert (0, 1) not in p.route.directional_links()
    pair.mutate("restore_link", 0, 1)
    for _ in range(3):
        pair.probe()
    size = pair.t.stats()["cache"]["size"]
    pair.exchange(0, 4096, [(0, 1), (2, 3)])
    assert pair.t.stats()["cache"]["size"] == size      # no new capture
    assert pair.t.describe(0, 1, 4096 * 4)["graph"]["digest"] == pre
    assert pair.t.stats()["health"]["ladder_level"] == 0


def test_injected_drop_quarantines_and_probes_readmit():
    """A drop quarantines the blamed link; probes readmit it after the
    healthy streak, each probe one captured send over exactly the link."""
    pair = Pair(JTopology.full_mesh(4), faults="drop@1x1:0-1")
    pair.send(0, 1024, 0, 1)
    pair.send(1, 1024, 0, 1)
    assert pair.t.planner.quarantined == {(0, 1)}
    s = pair.t.stats(reset=True)["health"]
    assert s == pair.j.stats(reset=True)["health"]
    assert s["retries"] >= 1 and s["quarantined_links"] == 1
    s2 = pair.t.stats()["health"]
    assert s2["retries"] == 0 and s2["quarantined_links"] == 1
    n = len(pair.tlog)
    pair.probe()
    assert len(pair.tlog) == n + 1                      # one probe send
    pair.probe()
    assert pair.t.planner.quarantined == frozenset()
    assert [e["kind"] for e in pair.events[-3:]] == [
        "probe_ok", "probe_ok", "readmit"]
    pair.send(2, 1024, 0, 1)


def test_flaky_link_probe_needs_a_longer_streak():
    pair = Pair(JTopology.full_mesh(4))
    pair.mutate("mark_flaky", 0, 1)
    for sess in (pair.t, pair.j):
        sess.monitor.quarantine_link((0, 1), reason="flap")
    for _ in range(3):
        pair.probe()
    assert pair.t.planner.quarantined == {(0, 1)}      # 3 < 2 × 2
    pair.probe()
    assert pair.t.planner.quarantined == frozenset()


def test_probe_of_a_failed_or_drooping_link_fails():
    pair = Pair(JTopology.full_mesh(4))
    for sess in (pair.t, pair.j):
        sess.monitor.quarantine_link((0, 1), reason="droop")
    pair.mutate("fail_link", 0, 1)
    pair.probe()
    pair.mutate("restore_link", 0, 1)
    pair.mutate("degrade_link", 0, 1, 0.25)
    pair.probe()
    assert [e["kind"] for e in pair.events[-2:]] == ["probe_failed"] * 2
    pair.mutate("degrade_link", 0, 1, 1.0)
    pair.probe()
    pair.probe()
    assert pair.t.planner.quarantined == frozenset()


# ------------------------------ the monitor ----------------------------------

def _sample(mod, links, measured_ns, nbytes=MiB):
    routes = (((tuple(sorted(links)), nbytes, 1),),)
    return mod.DispatchSample(routes=routes, nbytes=nbytes, num_nodes=1,
                              window=1, schedule="round_robin",
                              stages=mod.StageTimings(execute_ns=measured_ns),
                              fastpath_hit=True)


def _monitors(**kw):
    jtopo = JTopology.full_mesh(4)
    topo = port_topology(jtopo)
    return ((HealthMonitor(topo, PathPlanner(topo), **kw), ttel),
            (jhealth.HealthMonitor(jtopo, JPathPlanner(jtopo), **kw), jtel))


def test_droop_quarantines_after_m_consecutive_breaches():
    runs = []
    for mon, mod in _monitors(droop_threshold=2.0, droop_samples=3,
                              require_calibration=False):
        slow = _sample(mod, [(0, 1)], int(1e9))
        fast = _sample(mod, [(0, 1)], 1000)
        ratios = [mon.observe(s) for s in
                  (slow, slow, fast, slow, slow)]
        assert mon.planner.quarantined == frozenset()  # consecutive only
        ratios.append(mon.observe(slow))
        assert mon.planner.quarantined == {(0, 1)}
        runs.append((ratios, mon.events, mon.snapshot()))
    assert runs[0] == runs[1]
    assert runs[0][1] == [{"kind": "quarantine", "link": (0, 1),
                           "reason": "droop", "dispatch": None}]


def test_droop_needs_a_calibration_by_default():
    for mon, mod in _monitors():
        assert mon.observe(_sample(mod, [(0, 1)], int(1e9))) is None
        assert mon.observed == 0


def test_droop_does_not_judge_captured_steps_with_kernels():
    """A captured step that runs kernels is not judged: its measured time
    includes compute the comm model does not price (healthy steps read
    12-16x on the card), so the port's monitor returns None and keeps no
    streak, where the reference's quarantines the step's links after
    ``droop_samples`` such samples. Pure-comm samples over the same link
    are still judged and quarantine it."""
    (mon, mod), (jmon, jmod) = _monitors(droop_threshold=2.0,
                                         droop_samples=3,
                                         require_calibration=False)
    routes = _sample(mod, [(0, 1)], 1).routes
    for m, md in ((mon, mod), (jmon, jmod)):
        step = md.DispatchSample(routes=routes, nbytes=MiB, num_nodes=1,
                                 window=1, schedule="round_robin",
                                 stages=md.StageTimings(execute_ns=int(1e9)),
                                 fastpath_hit=True,
                                 compute=(("flash_attention", 1, 0),))
        for _ in range(3):
            m.observe(step)
    assert jmon.planner.quarantined == {(0, 1)}
    assert mon.observed == 0 and mon.planner.quarantined == frozenset()
    assert mon.events == []
    slow = _sample(mod, [(0, 1)], int(1e9))
    assert all(mon.observe(slow) > 2.0 for _ in range(3))
    assert mon.planner.quarantined == {(0, 1)}


def test_session_droop_rides_the_telemetry_hook():
    """On a session the recorder's ``on_record`` feeds the monitor: with
    calibration required and none attached, healthy traffic is observed
    by nothing and quarantines nothing."""
    sess = CommSession(CommConfig(telemetry=True), device="cpu")
    assert sess.telemetry.on_record == sess.monitor.observe
    x = torch.arange(4096, dtype=torch.float32)
    for _ in range(4):
        sess.send(x, 0, 1)
    assert sess.monitor.observed == 0 and not sess.planner.quarantined
    sess.monitor.require_calibration = False
    sess.monitor.droop_threshold = 0.0                 # every sample breaches
    for _ in range(3):
        sess.send(x, 0, 1)
    assert sess.monitor.observed == 3
    assert sess.monitor.quarantined == {(0, 1)}
    assert torch.equal(sess.send(x, 0, 1), x)
    assert sess.stats()["health"]["ladder_level"] == 1


# ------------------------------ the last rungs -------------------------------

def test_host_relay_delivers_when_no_device_route():
    pair = Pair(JTopology.full_mesh(2))
    pair.send(0, 128, 0, 1)
    pair.mutate("fail_link", 0, 1)
    pair.send(1, 128, 0, 1)
    s = pair.t.stats()["health"]
    assert s["host_relays"] == 1 and s["ladder_level"] == 3
    assert [e["kind"] for e in pair.events][-1] == "host_relay"
    pair.exchange(5, 64, [(0, 1), (1, 0)])             # (1, 0) survives


def test_host_relay_probes_so_quarantined_links_come_back():
    """While every device route is quarantined, sends relay through the
    host and the monitor still probes on its cadence: after
    ``probe_healthy`` sweeps the healthy link is readmitted and sends take
    the device again. The reference's relay does not probe, so its link
    stays quarantined and every send keeps relaying."""
    pair = Pair(JTopology.full_mesh(2))
    for sess in (pair.t, pair.j):
        sess.monitor.quarantine_link((0, 1), reason="droop")
    x = np.arange(64, dtype=np.float32)
    mon = pair.t.monitor
    rounds = mon.probe_interval * mon.probe_healthy + 1
    for _ in range(rounds):
        assert torch.equal(pair.t.send(torch.from_numpy(x), 0, 1),
                           torch.from_numpy(x))
        pair.j.send(jnp.asarray(x), 0, 1)
    assert pair.t.planner.quarantined == frozenset()
    assert mon.readmissions == 1
    assert pair.j.planner.quarantined == {(0, 1)}
    relays = pair.t.stats()["health"]["host_relays"]
    assert relays < rounds == pair.j.stats()["health"]["host_relays"]
    pair.t.send(torch.from_numpy(x), 0, 1)
    assert pair.t.stats()["health"]["host_relays"] == relays
    assert pair.t.stats()["health"]["ladder_level"] == 0


def test_exhausted_ladder_raises_with_history():
    pair = Pair(JTopology.full_mesh(2, with_host=False, name="mesh2"))
    pair.send(0, 128, 0, 1)
    pair.mutate("fail_link", 0, 1)
    x = np.arange(128, dtype=np.float32)
    with pytest.raises(CommFaultError) as got:
        pair.t.send(torch.from_numpy(x), 0, 1)
    with pytest.raises(jhealth.CommFaultError) as want:
        pair.j.send(jnp.asarray(x), 0, 1)
    assert got.value.history == want.value.history
    assert len(got.value.history) == 3
    assert str(got.value) == str(want.value)
    pair.check()


def test_replay_value_error_propagates_under_fault_state():
    """A ``ValueError`` raised by the replay itself (a kernel refusing a
    message) under fault state reaches the caller as it is, and nothing
    is relayed through the host."""
    sess = CommSession(CommConfig(multipath_threshold=1), device="cpu")
    sess.topology.fail_link(0, 2)
    eng = sess.engine

    def refuse(entry, messages, *, block):
        raise ValueError("the kernel refuses this message")

    eng._launch = refuse
    with pytest.raises(ValueError, match="refuses"):
        sess.send(torch.arange(64, dtype=torch.float32), 0, 1)
    health_ = sess.stats()["health"]
    assert health_["host_relays"] == 0 and health_["ladder_level"] == 0
    assert sess.drain_health_events() == []


@pytest.mark.parametrize("what", ["send", "step"])
def test_build_value_error_propagates_under_fault_state(monkeypatch, what):
    """A ``ValueError`` raised while a program is built (the work table
    refusing a plan, a step program refusing its graph) under fault
    state reaches the caller as it is: no retry, no escalation, nothing
    relayed through the host, and a captured step does not turn it into
    ``CommFaultError``."""
    sess = CommSession(CommConfig(multipath_threshold=1), device="cpu")
    sess.topology.fail_link(0, 2)

    def refuse(*args, **kwargs):
        raise ValueError("the build refuses this graph")

    if what == "send":
        monkeypatch.setattr(tengine, "build_node_table", refuse)
        call = lambda: sess.send(torch.arange(64, dtype=torch.float32), 0, 1)
    else:
        monkeypatch.setattr(tengine, "StepProgram", refuse)
        step = sess.capture(lambda cap: cap.kernel(
            torch.neg, cap.input((8,), torch.float32), name="neg"))
        call = lambda: step(torch.zeros(sess.num_devices, 8))
    with pytest.raises(ValueError, match="refuses") as got:
        call()
    assert not isinstance(got.value, NoRouteError)
    health_ = sess.stats()["health"]
    assert health_["host_relays"] == 0 and health_["ladder_level"] == 0
    assert health_["retries"] == 0 and health_["replans"] == 0
    assert sess.stats()["dispatches"] == 0
    assert sess.drain_health_events() == []


def test_no_route_is_a_value_error_from_planning():
    """Planning with no admissible route raises ``NoRouteError``, a
    ``ValueError``, as the reference's planner raises ``ValueError``;
    under fault state it is what sends the ladder to its next rung."""
    sess = CommSession(device="cpu",
                       topology=Topology.full_mesh(2, with_host=True))
    sess.topology.fail_link(0, 1)
    with pytest.raises(NoRouteError) as got:
        sess.engine.plan_for(0, 1, 64)
    assert isinstance(got.value, ValueError)
    with pytest.raises(NoRouteError):
        sess.engine.plan_group_for([(0, 1, 64, torch.float32)])
    x = torch.arange(64, dtype=torch.float32)
    assert torch.equal(sess.send(x, 0, 1), x)
    assert sess.stats()["health"]["host_relays"] == 1


def test_healthy_path_keeps_the_exclusive_contract():
    """With health on and no fault state, ``exclusive=True`` starvation
    still raises ``ValueError`` in both packages (chain 2—0—1)."""
    links = [JLink(a, b, "nvlink", 25.0)
             for (a, b) in ((0, 1), (1, 0), (2, 0), (0, 2))]
    pair = Pair(JTopology(3, links, name="chain3"), multipath_threshold=0)
    x, tx, jx = payload(0, 256)
    with pytest.raises(ValueError, match="link-exclusive"):
        pair.t.exchange([(tx, 0, 1), (tx, 2, 1)], exclusive=True)
    with pytest.raises(ValueError, match="link-exclusive"):
        pair.j.exchange([(jx, 0, 1), (jx, 2, 1)], exclusive=True)
    pair.exchange(0, 256, [(0, 1), (2, 1)])
    pair.check()


def test_health_off_has_no_monitor():
    pair = Pair(JTopology.full_mesh(4), health=False)
    assert pair.t.monitor is None and pair.t.probe_links() == {}
    assert pair.t.telemetry.on_record is None
    pair.send(0, 64, 0, 1)
    assert pair.t.stats()["health"]["enabled"] is False
    pair.mutate("fail_link", 0, 1)
    pair.send(1, 64, 0, 1)                              # the ladder still
    assert pair.t.stats()["health"]["ladder_level"] == 1


# --------------------------- captured traffic --------------------------------

def test_captured_decode_step_survives_link_failure():
    """The captured decode step keeps serving through a failure of the
    link its KV migration rides: re-resolved (and re-captured) on the
    surviving routes, with the reference step's digests and numbers."""
    pair = Pair(JTopology.full_mesh(4))
    kw = dict(batch=1, heads=2, kv_len=16, head_dim=8, kv_chunk=4096,
              src=0, dst=2)
    step = make_captured_decode_step(pair.t, **kw)
    jstep = jmake_captured_decode_step(pair.j, **kw)
    rng = np.random.default_rng(0)
    q, k, v = (rng.random((4, 1, 2, 16, 8)).astype(np.float32)
               for _ in range(3))
    kv = rng.random((4, 4096)).astype(np.float32)
    want_kv = kv.copy()
    want_kv[2] = kv[0]

    def call():
        attn, new_kv = step(*(torch.from_numpy(a) for a in (q, k, v, kv)))
        jattn, jnew_kv = jstep(q, k, v, kv)
        np.testing.assert_array_equal(new_kv.numpy(), want_kv)
        np.testing.assert_array_equal(np.asarray(jnew_kv), want_kv)
        np.testing.assert_allclose(attn.numpy(), np.asarray(jattn),
                                   atol=2e-5, rtol=0)
        pair.check()
        assert step.resolve().digest == jstep.resolve().digest

    call()
    pair.mutate("fail_link", 0, 2)
    call()
    for p in step.resolve().plans:
        assert (0, 2) not in p.directional_links()
    assert pair.t.stats()["health"]["ladder_level"] == 1
    pair.mutate("restore_link", 0, 2)
    call()
    # a healthy captured step leaves the level as it is; a send resets it
    assert pair.t.stats()["health"]["ladder_level"] == 1
    pair.send(0, 64, 0, 2)
    assert pair.t.stats()["health"]["ladder_level"] == 0


def test_captured_step_drop_retries_and_quarantines():
    """An injected drop on the step's link: one retry, the link
    quarantined, the step re-captured around it."""
    def build(cap, mod):
        x = cap.input((4096,), torch.float32 if mod == "t" else jnp.float32)
        (r,) = cap.exchange([(x, 0, 1)], max_paths=2)
        return r

    pair = Pair(JTopology.full_mesh(4), faults="drop@0x1:0-1")
    step = pair.t.capture(lambda cap: build(cap, "t"))
    jstep = pair.j.capture(lambda cap: build(cap, "j"))
    xs = np.random.RandomState(0).randn(4, 4096).astype(np.float32)
    (out,) = step(torch.from_numpy(xs))
    (jout,) = jstep(xs)
    np.testing.assert_array_equal(out.numpy()[1], xs[0])
    pair.check([jout], [out])
    assert pair.t.stats()["health"]["retries"] == 1
    assert pair.t.planner.quarantined == {(0, 1)}


def test_serve_engine_surfaces_health_events():
    """``migrate_kv`` under a failed link delivers the cache bitwise and
    leaves the reference's ``ladder`` event in ``health_events``."""
    jload_all()
    jcfg = JREGISTRY["smollm_360m"].reduced()
    jparams = jtfm.init_params(jax.random.key(0), jcfg)
    params = carry.params_from_numpy(jax.tree.map(np.asarray, jparams))
    pair = Pair(JTopology.full_mesh(4))
    engine = ServeEngine(get_config("smollm_360m").reduced(), params,
                         max_len=32, kv_chunks=2, comm=pair.t)
    jengine = JServeEngine(jcfg, jparams, max_len=32, kv_chunks=2,
                           comm=pair.j)
    _, cache = engine.prefill(torch.ones((1, 4), dtype=torch.long))
    _, jcache = jengine.prefill(jnp.ones((1, 4), jnp.int32))
    pair.mutate("fail_link", 0, 1)
    moved = engine.migrate_kv(cache, 0, 1)
    jengine.migrate_kv(jcache, 0, 1)
    assert all(torch.equal(moved[k], cache[k]) for k in cache)
    assert engine.health_events == jengine.health_events
    assert "ladder" in {e["kind"] for e in engine.health_events}
    assert pair.t.drain_health_events() == []          # drained once
    assert pair.tlog == pair.jlog


# ------------------------------- the schema ----------------------------------

def test_health_stats_schema_and_reset():
    snaps = []
    for cls in (HealthStats, jhealth.HealthStats):
        hs = cls()
        hs.retries, hs.replans, hs.ladder_level = 2, 1, 1
        hs.note("retry", rung=LADDER[1], links=[(0, 1)], reason="x")
        snap = hs.snapshot(quarantined=1, enabled=True)
        hs.reset_window()
        snaps.append((snap, hs.retries, hs.ladder_level, hs.events))
    assert snaps[0] == snaps[1]
    assert snaps[0][0] == {"enabled": True, "retries": 2, "replans": 1,
                           "faults_seen": 0, "host_relays": 0,
                           "ladder_level": 1, "quarantined_links": 1}
    assert snaps[0][1:3] == (0, 1)                     # state survives


def test_session_stats_health_before_and_after_the_engine():
    jtopo = JTopology.full_mesh(4)
    jsess = JCommSession(JCommConfig(), mesh=jmesh(4), topology=jtopo)
    sess = CommSession(device="cpu", topology=port_topology(jtopo))
    for s in (sess, jsess):
        s.planner.quarantine((0, 1))
    assert sess._engine is None and jsess._engine is None
    assert (sess.stats()["health"] == jsess.stats()["health"]
            == {"enabled": True, "retries": 0, "replans": 0,
                "faults_seen": 0, "host_relays": 0, "ladder_level": 0,
                "quarantined_links": 1})
    x = torch.arange(256, dtype=torch.float32)
    assert torch.equal(sess.send(x, 0, 1), x)
    assert sess.stats(reset=True)["health"]["ladder_level"] == 1
    after = sess.stats()["health"]
    assert after["ladder_level"] == 1 and after["quarantined_links"] == 1


def test_errors_and_ladder_names():
    err = LinkFaultError([(0, 1)], "injected")
    assert err.links == ((0, 1),) and str(err) == str(
        jhealth.LinkFaultError([(0, 1)], "injected"))
    assert str(CommFaultError("x", ["a", "b"])) == str(
        jhealth.CommFaultError("x", ["a", "b"]))
    assert LADDER == jhealth.LADDER


def test_an_exhausted_injector_costs_no_hazard():
    sess = CommSession(CommConfig(faults="fail@0:0-1;restore@1:0-1"),
                       device="cpu")
    x = torch.arange(64, dtype=torch.float32)
    for _ in range(3):
        assert torch.equal(sess.send(x, 0, 1), x)
    assert not sess.faults.active and not sess.engine._hazard()
    assert sess.stats()["health"]["ladder_level"] == 0
    assert isinstance(FaultInjector.from_spec(""), FaultInjector)
