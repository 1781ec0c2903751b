"""The §4.6 health ladder on a peer session against the reference and the
stacked session (DESIGN §4.6).

Every fault case of ``test_torch_health.py`` that drives a ``Pair`` runs
here with the port session on ``CommSession(devices=["cpu"] * n)``: one
logical device a device, each with its own buffers, as a session over
peer cards runs. The reference session runs on ``n`` CPU devices as
there, and after every operation the drained health events,
``stats()["health"]``, the launched digests (probe sends included), the
quarantine set and the delivered bytes must equal the reference's, and
each delivered tensor must be on ``devices[dst]``. The captured-step
cases pass per-device lists, as a peer capture takes them.

Peer-only cases: a ``ValueError`` from a replay or a build under fault
state propagates and is never relayed through the host; probes look their
program up under the engine's :class:`PlacedKey`, so every key of a peer
engine's plan cache is one and the send of a probed plan is a cache hit,
with cache statistics equal to a stacked session's driven in lockstep.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_health as th
from repro.core import Topology as JTopology
from repro.serving.engine import (
    make_captured_decode_step as jmake_captured_decode_step)

from repro_torch.comm import CommConfig, CommSession
from repro_torch.comm import engine as tengine
from repro_torch.comm.capture import PeerStepProgram
from repro_torch.comm.engine import GroupKey, NoRouteError, PlacedKey
from repro_torch.core.topology import Topology
from repro_torch.serving import make_captured_decode_step

N = 4


@pytest.fixture(autouse=True)
def peer_layout(monkeypatch):
    """Every ``Pair`` made in this module puts its port session on peers."""
    monkeypatch.setattr(th.Pair, "layout", "peer")


def peer_session(n=N, **cfg):
    return CommSession(CommConfig(**cfg), devices=["cpu"] * n)


def test_pair_runs_on_peers():
    pair = th.Pair(JTopology.full_mesh(N))
    assert pair.t.devices == (torch.device("cpu"),) * N
    assert pair.t.engine.devices == pair.t.devices


# ------------------------- schedules over traffic ----------------------------

@pytest.mark.parametrize("spec", th.SCHEDULES)
@pytest.mark.parametrize("kind", ["send", "exchange", "bidirectional"])
def test_schedule_equals_reference_on_peers(spec, kind):
    th.test_schedule_equals_reference(spec, kind)


def test_chip_schedule_counts_on_peers():
    th.test_chip_schedule_counts()


def test_midtraffic_failure_restores_the_pre_fault_digest_on_peers():
    th.test_midtraffic_failure_restores_the_pre_fault_digest()


def test_injected_drop_quarantines_and_probes_readmit_on_peers():
    th.test_injected_drop_quarantines_and_probes_readmit()


def test_flaky_link_probe_needs_a_longer_streak_on_peers():
    th.test_flaky_link_probe_needs_a_longer_streak()


def test_probe_of_a_failed_or_drooping_link_fails_on_peers():
    th.test_probe_of_a_failed_or_drooping_link_fails()


# ------------------------------ the monitor ----------------------------------

def test_session_droop_quarantines_on_peers_as_stacked():
    """The droop monitor riding the telemetry hook quarantines the same
    link on a peer session as on a stacked one, and the next send takes
    the same re-planned route at ladder level 1."""
    x = torch.arange(4096, dtype=torch.float32)
    peer = peer_session(telemetry=True)
    stacked = CommSession(CommConfig(telemetry=True), device="cpu")
    sessions = (peer, stacked)
    for sess in sessions:
        assert sess.telemetry.on_record == sess.monitor.observe
        for _ in range(4):
            sess.send(x, 0, 1)
        assert sess.monitor.observed == 0 and not sess.planner.quarantined
        sess.monitor.require_calibration = False
        sess.monitor.droop_threshold = 0.0             # every sample breaches
        for _ in range(3):
            sess.send(x, 0, 1)
    digests = []
    for sess in sessions:
        assert sess.monitor.observed == 3
        assert sess.monitor.quarantined == {(0, 1)}
        out = sess.send(x, 0, 1)
        assert torch.equal(out, x) and out.device == sess.engine._home(1)
        assert sess.stats()["health"]["ladder_level"] == 1
        digests.append(sess.describe(0, 1, x.numel() * 4)["graph"]["digest"])
    assert digests[0] == digests[1]
    assert peer.drain_health_events() == stacked.drain_health_events()


# ------------------------------ the last rungs -------------------------------

def test_host_relay_delivers_when_no_device_route_on_peers():
    th.test_host_relay_delivers_when_no_device_route()


def test_host_relay_probes_so_quarantined_links_come_back_on_peers():
    th.test_host_relay_probes_so_quarantined_links_come_back()


def test_exhausted_ladder_raises_with_history_on_peers():
    th.test_exhausted_ladder_raises_with_history()


def test_healthy_path_keeps_the_exclusive_contract_on_peers():
    th.test_healthy_path_keeps_the_exclusive_contract()


def test_health_off_has_no_monitor_on_peers():
    th.test_health_off_has_no_monitor()


def test_replay_value_error_propagates_under_fault_state_on_peers():
    """A ``ValueError`` from the replay on a peer session reaches the
    caller as it is; nothing is relayed through the host."""
    sess = peer_session(multipath_threshold=1)
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
def test_build_value_error_propagates_under_fault_state_on_peers(
        monkeypatch, what):
    """A ``ValueError`` while a peer program is built (the per-device
    work table, the ``PeerStepProgram``) reaches the caller as it is: no
    retry, no escalation, no host relay, no ``CommFaultError``."""
    sess = peer_session(multipath_threshold=1)
    sess.topology.fail_link(0, 2)

    def refuse(*args, **kwargs):
        raise ValueError("the build refuses this graph")

    if what == "send":
        monkeypatch.setattr(tengine, "build_node_table", refuse)
        call = lambda: sess.send(torch.arange(64, dtype=torch.float32), 0, 1)
    else:
        monkeypatch.setattr(tengine, "PeerStepProgram", refuse)
        step = sess.capture(lambda cap: cap.kernel(
            torch.neg, cap.input((8,), torch.float32), name="neg"))
        call = lambda: step([torch.zeros(8) for _ in range(N)])
    with pytest.raises(ValueError, match="refuses") as got:
        call()
    assert not isinstance(got.value, NoRouteError)
    health_ = sess.stats()["health"]
    assert health_["host_relays"] == 0 and health_["ladder_level"] == 0
    assert health_["retries"] == 0 and health_["replans"] == 0
    assert sess.stats()["dispatches"] == 0
    assert sess.drain_health_events() == []


def test_no_route_relays_through_the_host_on_peers():
    sess = CommSession(devices=["cpu"] * 2,
                       topology=Topology.full_mesh(2, with_host=True))
    sess.topology.fail_link(0, 1)
    with pytest.raises(NoRouteError):
        sess.engine.plan_for(0, 1, 64)
    x = torch.arange(64, dtype=torch.float32)
    out = sess.send(x, 0, 1)
    assert torch.equal(out, x) and out.device == sess.devices[1]
    assert sess.stats()["health"]["host_relays"] == 1


def test_an_exhausted_injector_costs_no_hazard_on_peers():
    sess = CommSession(CommConfig(faults="fail@0:0-1;restore@1:0-1"),
                       devices=["cpu"] * N)
    x = torch.arange(64, dtype=torch.float32)
    for _ in range(3):
        assert torch.equal(sess.send(x, 0, 1), x)
    assert not sess.faults.active and not sess.engine._hazard()
    assert sess.stats()["health"]["ladder_level"] == 0


# --------------------------- captured traffic --------------------------------

def test_captured_decode_step_survives_link_failure_on_peers():
    """The captured decode step on peers, inputs one list a buffer:
    re-resolved around a failed (0, 2) as a new ``PeerStepProgram``, with
    the reference step's digests, events and numbers."""
    pair = th.Pair(JTopology.full_mesh(N))
    kw = dict(batch=1, heads=2, kv_len=16, head_dim=8, kv_chunk=4096,
              src=0, dst=2)
    step = make_captured_decode_step(pair.t, **kw)
    jstep = jmake_captured_decode_step(pair.j, **kw)
    rng = np.random.default_rng(0)
    q, k, v = (rng.random((N, 1, 2, 16, 8)).astype(np.float32)
               for _ in range(3))
    kv = rng.random((N, 4096)).astype(np.float32)
    want_kv = kv.copy()
    want_kv[2] = kv[0]

    def call():
        attn, new_kv = step(*([torch.from_numpy(r.copy()) for r in a]
                              for a in (q, k, v, kv)))
        jattn, jnew_kv = jstep(q, k, v, kv)
        assert [t.device for t in new_kv] == list(pair.t.devices)
        np.testing.assert_array_equal(torch.stack(new_kv).numpy(), want_kv)
        np.testing.assert_array_equal(np.asarray(jnew_kv), want_kv)
        np.testing.assert_allclose(torch.stack(attn).numpy(),
                                   np.asarray(jattn), atol=2e-5, rtol=0)
        pair.check()
        entry = step.resolve()
        assert entry.digest == jstep.resolve().digest
        assert isinstance(entry.compiled.program, PeerStepProgram)
        assert entry.compiled.key == PlacedKey(
            entry.key, tuple(str(d) for d in pair.t.devices))

    call()
    pair.mutate("fail_link", 0, 2)
    call()
    for p in step.resolve().plans:
        assert (0, 2) not in p.directional_links()
    assert pair.t.stats()["health"]["ladder_level"] == 1
    pair.mutate("restore_link", 0, 2)
    call()
    assert pair.t.stats()["health"]["ladder_level"] == 1
    pair.send(0, 64, 0, 2)
    assert pair.t.stats()["health"]["ladder_level"] == 0


def test_captured_step_drop_retries_and_quarantines_on_peers():
    def build(cap, dtype):
        x = cap.input((4096,), dtype)
        (r,) = cap.exchange([(x, 0, 1)], max_paths=2)
        return r

    pair = th.Pair(JTopology.full_mesh(N), faults="drop@0x1:0-1")
    step = pair.t.capture(lambda cap: build(cap, torch.float32))
    jstep = pair.j.capture(lambda cap: build(cap, jnp.float32))
    xs = np.random.RandomState(0).randn(N, 4096).astype(np.float32)
    (out,) = step([torch.from_numpy(r.copy()) for r in xs])
    (jout,) = jstep(xs)
    np.testing.assert_array_equal(out[1].numpy(), xs[0])
    pair.check([jout], [torch.stack(out)])
    assert pair.t.stats()["health"]["retries"] == 1
    assert pair.t.planner.quarantined == {(0, 1)}


def test_serve_engine_surfaces_health_events_on_peers():
    th.test_serve_engine_surfaces_health_events()


# ----------------------------- the probe's key -------------------------------

def _quarantine_and_probe(sess, link=(0, 1)):
    """Quarantine ``link`` and probe until it is readmitted."""
    sess.monitor.quarantine_link(link, reason="droop")
    for _ in range(sess.monitor.probe_healthy):
        sess.probe_links()
    assert not sess.planner.quarantined


def test_probe_caches_under_the_placed_key():
    """A probe's program is looked up under the peer engine's placed key,
    as every send's is: after probes every key of the plan cache is a
    ``PlacedKey`` over the session's devices, none a bare ``GroupKey``."""
    sess = peer_session(multipath_threshold=1, max_paths=3)
    sess.send(torch.arange(512, dtype=torch.float32), 0, 2)
    _quarantine_and_probe(sess)
    keys = list(sess.engine.cache._store)
    assert len(keys) == 2
    placement = tuple(str(d) for d in sess.devices)
    for key in keys:
        assert isinstance(key, PlacedKey) and key.devices == placement
        assert isinstance(key.key, GroupKey)


@pytest.mark.parametrize("link", [(0, 1), (2, 1), (3, 0)])
def test_send_after_probe_hits_the_probed_program(link):
    """The send of a probed plan (256 float32 over the link, one path) is
    a cache hit on a peer session as on a stacked one: driven in
    lockstep, the two sessions' ``stats()["cache"]`` agree after every
    step, and the send replays the probe's program."""
    cfg = dict(multipath_threshold=1, max_paths=3)
    peer = peer_session(**cfg)
    stacked = CommSession(CommConfig(**cfg), device="cpu")
    x = torch.arange(256, dtype=torch.float32)
    for sess in (peer, stacked):
        _quarantine_and_probe(sess, link)
    probed = peer.stats()["cache"]
    assert probed == stacked.stats()["cache"]
    assert probed["size"] == 1 and probed["misses"] == 1
    for i in range(2):
        outs = [sess.send(x, *link, max_paths=1) for sess in (peer, stacked)]
        assert all(torch.equal(o, x) for o in outs)
        assert outs[0].device == peer.devices[link[1]]
        cache = peer.stats()["cache"]
        assert cache == stacked.stats()["cache"]
        assert (cache["size"], cache["misses"]) == (1, 1)
        assert cache["hits"] == probed["hits"] + i + 1
    assert peer.drain_health_events() == stacked.drain_health_events()
