"""The port's dispatch telemetry against the reference's (DESIGN §4.4c).

The recorder's behaviours of the reference's ``tests/test_telemetry.py``
run on both packages with the same inputs and must give equal results;
the session-level ones run on the port's ``CommSession`` on the CPU
(where the plain executor runs inside ``launch``, so ``execute`` reads
about 0). The same request sequence (sends, repeated sends, a window,
an ``exchange``, ``bidirectional`` and a captured step with compute
nodes) through a reference session on 4 CPU devices and a port session
must record samples whose identities (routes, bytes, node count, window,
schedule, compute, fast-path flag) are EQUAL in order, with zero setup
stages on every fast-path hit. The capture adopters stamp the same
``cost_ns`` from a filled recorder as the reference's, so path F's
captured decode step digests equal to the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import CommConfig as JCommConfig
from repro.comm import CommSession as JCommSession
from repro.comm import StepCapture as JStepCapture
from repro.comm import telemetry as jtel
from repro.comm.cache import PlanLifecycle as JPlanLifecycle
from repro.comm.capture import lower_step as jlower_step
from repro.core import Topology as JTopology
from repro.kernels.flash_attention.ops import (
    captured_flash_attention as jcaptured_flash_attention)
from repro.kernels.ring_allgather.ops import (
    captured_ring_allgather as jcaptured_ring_allgather)
from repro.serving.engine import (
    make_captured_decode_step as jmake_captured_decode_step)

import repro_torch.serving.engine as serving_engine
from repro_torch.comm import CommConfig, CommSession, StepCapture, lower_step
from repro_torch.comm import engine as engine_mod
from repro_torch.comm import telemetry as ttel
from repro_torch.comm.cache import PlanLifecycle
from repro_torch.core.topology import Topology
from repro_torch.kernels.flash_attention.ops import captured_flash_attention
from repro_torch.kernels.ring_allgather.ops import captured_ring_allgather
from repro_torch.serving import make_captured_decode_step

PACKAGES = {"reference": jtel, "port": ttel}


def _sample(mod, i: int = 0, **stage_ns):
    """The reference test's synthetic sample, built from ``mod``."""
    route = ((((0, 1),), 1024 + i, 2),)
    return mod.DispatchSample(routes=(route,), nbytes=1024 + i, num_nodes=2,
                              window=1, schedule="round_robin",
                              stages=mod.StageTimings(**stage_ns),
                              fastpath_hit=False)


def _session(**cfg):
    return CommSession(CommConfig(multipath_threshold=64, **cfg),
                       device="cpu",
                       topology=Topology.full_mesh(4, with_host=False))


def both(fn):
    """``fn(mod)`` on the reference's and the port's telemetry module;
    the two results must be equal, and the port's is returned."""
    ref, port = fn(jtel), fn(ttel)
    assert port == ref
    return port


# ------------------------- recorder semantics -------------------------------

def test_recorder_disabled_by_default(monkeypatch):
    monkeypatch.delenv(ttel.TELEMETRY_ENV, raising=False)
    assert ttel.TELEMETRY_ENV == jtel.TELEMETRY_ENV

    def run(mod):
        rec = mod.TimelineRecorder()
        rec.record(_sample(mod))
        return rec.enabled, len(rec), rec.samples(), rec.stats()

    assert both(run) == (False, 0, (), {
        "enabled": False, "capacity": ttel.DEFAULT_CAPACITY, "retained": 0,
        "recorded": 0, "dropped": 0})
    assert ttel.DEFAULT_CAPACITY == jtel.DEFAULT_CAPACITY


@pytest.mark.parametrize("value,expect", [
    ("1", True), ("on", True), ("0", False), ("false", False), ("", False)])
def test_recorder_env_toggle(monkeypatch, value, expect):
    monkeypatch.setenv(ttel.TELEMETRY_ENV, value)
    assert both(lambda mod: (mod.TimelineRecorder().enabled,
                             mod.TimelineRecorder(
                                 enabled=not expect).enabled)) == (
        expect, not expect)


def test_ring_buffer_bounds_memory():
    def run(mod):
        rec = mod.TimelineRecorder(capacity=4, enabled=True)
        for i in range(10):
            rec.record(_sample(mod, i))
        kept = [s.nbytes for s in rec.samples()]
        st = rec.stats()
        rec.clear()
        return kept, st, len(rec), rec.stats()["recorded"]

    kept, st, after, recorded = both(run)
    assert kept == [1030, 1031, 1032, 1033]
    assert st == {"enabled": True, "capacity": 4, "retained": 4,
                  "recorded": 10, "dropped": 6}
    assert (after, recorded) == (0, 0)


def test_recorder_capacity_validation():
    for mod in PACKAGES.values():
        with pytest.raises(ValueError, match="capacity"):
            mod.TimelineRecorder(capacity=0)


def test_stage_timings_cover_every_stage():
    assert ttel.STAGES == jtel.STAGES

    def run(mod):
        st = mod.StageTimings(plan_ns=1, lower_ns=2, schedule_ns=3,
                              compile_ns=4, staging_ns=5, launch_ns=6,
                              execute_ns=7)
        return tuple(st.as_dict().items()), st.total_ns

    items, total = both(run)
    assert tuple(k for k, _ in items) == ttel.STAGES
    assert total == sum(v for _, v in items) == 28


def test_dispatch_sample_derived_views():
    def run(mod):
        s = _sample(mod, launch_ns=2_000, execute_ns=3_000)
        return s.signature, s.num_paths, s.links, s.measured_s

    sig, paths, links, measured = both(run)
    assert sig[1:] == (1, "round_robin", ())
    assert paths == 1 and links == ((0, 1),)
    assert measured == pytest.approx(5e-6)


def test_on_record_observer_fires_and_contains_errors():
    def run(mod):
        rec = mod.TimelineRecorder(enabled=True)
        seen = []
        rec.on_record = seen.append
        rec.record(_sample(mod, 1))

        def boom(sample):
            raise RuntimeError("observer failure")

        rec.on_record = boom
        rec.record(_sample(mod, 2))             # swallowed, still kept
        off = mod.TimelineRecorder(enabled=False)
        off.on_record = boom
        off.record(_sample(mod, 3))             # never fires while off
        return [s.nbytes for s in seen], len(rec), len(off)

    assert both(run) == ([1025], 2, 0)


# ------------------------- session integration ------------------------------

def test_session_attributes_stage_time(monkeypatch):
    monkeypatch.delenv(ttel.TELEMETRY_ENV, raising=False)
    sess = _session(telemetry=True)
    msg = torch.arange(4096, dtype=torch.float32)
    for _ in range(3):
        assert torch.equal(sess.send(msg, 0, 1, num_chunks=2), msg)
    samples = sess.telemetry.samples()
    assert len(samples) == 3
    cold, warm = samples[0], samples[-1]
    assert not cold.fastpath_hit
    assert cold.stages.plan_ns > 0
    assert cold.stages.lower_ns > 0
    assert cold.stages.compile_ns > 0           # the program's build_ns
    assert cold.stages.launch_ns > 0
    assert warm.fastpath_hit
    assert warm.stages.plan_ns == warm.stages.lower_ns == 0
    assert warm.stages.schedule_ns == warm.stages.compile_ns == 0
    assert warm.stages.launch_ns > 0
    assert warm.nbytes == 4096 * 4
    assert warm.num_nodes == cold.num_nodes
    st = sess.stats()
    assert st["telemetry"]["recorded"] == 3
    assert st["calibration"] == {"active": False}
    assert sess.engine.stats()["telemetry"] == st["telemetry"]


def test_session_telemetry_off_records_nothing(monkeypatch):
    monkeypatch.delenv(ttel.TELEMETRY_ENV, raising=False)

    def no_stages(*args, **kwargs):
        raise AssertionError("a StageTimings was made with telemetry off")

    # zero overhead off: the dispatch path makes no StageTimings at all
    monkeypatch.setattr(engine_mod, "StageTimings", no_stages)
    sess = _session()
    msg = torch.arange(4096, dtype=torch.float32)
    for _ in range(2):
        assert torch.equal(sess.send(msg, 0, 1), msg)
    step = sess.capture(lambda cap: cap.kernel(
        torch.neg, cap.input((8,), torch.float32), name="neg"))
    step(torch.ones(4, 8))
    assert len(sess.telemetry) == 0
    assert sess.stats()["telemetry"]["enabled"] is False


def test_config_env_wiring(monkeypatch):
    from repro.comm import CommConfig as JConfig

    monkeypatch.setenv(ttel.TELEMETRY_ENV, "1")
    monkeypatch.setenv("REPRO_MP_TELEMETRY_CAPACITY", "16")
    monkeypatch.setenv("REPRO_MP_PROFILE_DIR", "/nonexistent/profiles")
    cfg = CommConfig.from_env()
    assert cfg.telemetry is True
    assert cfg.telemetry_capacity == 16
    assert cfg.profile_dir == "/nonexistent/profiles"
    assert dataclasses.asdict(cfg) == dataclasses.asdict(JConfig.from_env())
    with pytest.raises(ValueError, match="telemetry_capacity"):
        CommConfig(telemetry_capacity=0)
    # an env-built session records (no profile under that directory)
    sess = CommSession(device="cpu")
    assert sess.telemetry.enabled and sess.telemetry.capacity == 16
    sess.send(torch.ones(64), 0, 1)
    assert len(sess.telemetry) == 1


def test_stats_reset_rewinds_window_not_build_costs(monkeypatch):
    monkeypatch.delenv(ttel.TELEMETRY_ENV, raising=False)
    sess = _session(telemetry=True)
    msg = torch.arange(4096, dtype=torch.float32)
    for _ in range(4):
        sess.send(msg, 0, 1)
    st = sess.stats(reset=True)
    assert st["dispatches"] == 4
    assert st["fastpath"]["hits"] == 3
    st2 = sess.stats()
    assert st2["dispatches"] == 0
    assert st2["fastpath"]["hits"] == st2["fastpath"]["misses"] == 0
    assert st2["cache"]["hits"] == st2["cache"]["misses"] == 0
    assert st2["fastpath"]["staging_ns"] == 0
    (compiled,) = sess.cache._store.values()
    assert compiled.lifecycle.build_ns > 0
    assert compiled.lifecycle.launches == 0
    assert len(sess.telemetry) == 4
    sess.send(msg, 0, 1)
    assert sess.stats()["dispatches"] == 1


def test_timed_call_keeps_the_lifecycle_of_call():
    sess = _session()
    msg = torch.arange(256, dtype=torch.float32)
    sess.send(msg, 0, 1)
    (compiled,) = sess.cache._store.values()
    life = compiled.lifecycle
    before = (life.launches, life.total_launch_ns)
    outs, launch_ns, execute_ns = compiled.timed_call()
    assert launch_ns > 0 and execute_ns >= 0
    assert life.launches == before[0] + 1
    assert life.total_launch_ns - before[1] >= launch_ns + execute_ns
    assert torch.equal(outs[0][0, 1], msg)


def test_unblocked_dispatch_records_launch_alone(monkeypatch):
    monkeypatch.delenv(ttel.TELEMETRY_ENV, raising=False)
    sess = _session(telemetry=True)
    msg = torch.arange(1024, dtype=torch.float32)
    assert torch.equal(sess.send(msg, 0, 1, block=False), msg)
    (s,) = sess.telemetry.samples()
    assert s.stages.launch_ns > 0 and s.stages.execute_ns == 0


# ------------------- per-kernel execute channel (§4.4d) ---------------------

def test_record_kernel_noop_while_disabled(monkeypatch):
    monkeypatch.delenv(ttel.TELEMETRY_ENV, raising=False)

    def run(mod):
        rec = mod.TimelineRecorder()
        rec.record_kernel("flash_attention", 1_000.0)
        return rec.kernel_samples(), rec.kernel_cost_ns("flash_attention")

    assert both(run) == ({}, 0.0)


def test_record_kernel_aggregates_and_bounds():
    def run(mod):
        rec = mod.TimelineRecorder(capacity=4, enabled=True)
        for ns in (100.0, 200.0, 300.0, 400.0, 500.0):
            rec.record_kernel("attn", ns)
        rec.record_kernel("sweep", 50.0)
        return (rec.kernel_samples(), rec.kernel_cost_ns("attn"),
                rec.kernel_cost_ns("sweep"),
                rec.kernel_cost_ns("unmeasured"), rec.stats())

    samples, attn, sweep, unmeasured, stats = both(run)
    assert samples == {"attn": (200.0, 300.0, 400.0, 500.0),
                       "sweep": (50.0,)}
    assert attn == pytest.approx(350.0)
    assert (sweep, unmeasured) == (50.0, 0.0)
    assert stats == {"enabled": True, "capacity": 4, "retained": 0,
                     "recorded": 0, "dropped": 0}


def test_record_kernel_ignores_nonpositive_and_clears():
    def run(mod):
        rec = mod.TimelineRecorder(capacity=4, enabled=True)
        rec.record_kernel("attn", 0.0)
        rec.record_kernel("attn", -5.0)
        first = rec.kernel_samples()
        rec.record_kernel("attn", 10.0)
        rec.clear()
        return first, rec.kernel_samples(), rec.kernel_cost_ns("attn")

    assert both(run) == ({}, {}, 0.0)


def test_lifecycle_reset_window_unit():
    def run(cls):
        lc = cls(trace_ns=10, lower_ns=20, compile_ns=30, num_nodes=7)
        lc.launches = 5
        lc.total_launch_ns = 500
        lc.staging_ns = 50
        lc.fastpath_hits = 3
        lc.reset_window()
        return ((lc.launches, lc.total_launch_ns, lc.staging_ns,
                 lc.fastpath_hits), (lc.trace_ns, lc.lower_ns,
                                     lc.compile_ns), lc.build_ns,
                lc.num_nodes)

    assert run(PlanLifecycle) == run(JPlanLifecycle) == (
        (0, 0, 0, 0), (10, 20, 30), 60, 7)


# ------------------- sample identities against the reference ----------------

@pytest.fixture(scope="module")
def jmesh4():
    return jax.sharding.Mesh(np.array(jax.devices()[:4]), ("dev",))


def sample_ids(samples) -> list[tuple]:
    """Each sample's identity: everything but its times."""
    return [(s.routes, s.nbytes, s.num_nodes, s.window, s.schedule,
             s.compute, s.fastpath_hit) for s in samples]


def _jstep_build(cap):
    x = cap.input((2048,), jnp.float32)
    y = cap.kernel(lambda v: v * 2.0, x, name="double", flops=2048)
    (r,) = cap.exchange([(y, 0, 1)], max_paths=2, num_chunks=2)
    return cap.kernel(lambda v: v + 1.0, r, name="inc", flops=2048)


def _step_build(cap):
    x = cap.input((2048,), torch.float32)
    y = cap.kernel(lambda v: v * 2.0, x, name="double", flops=2048)
    (r,) = cap.exchange([(y, 0, 1)], max_paths=2, num_chunks=2)
    return cap.kernel(lambda v: v + 1.0, r, name="inc", flops=2048)


def identity_traffic(sess, port: bool) -> None:
    """One request sequence on either package's session."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal(5000).astype(np.float32)
    b = rng.standard_normal(3001).astype(np.float32)
    c = rng.standard_normal((3, 100)).astype(np.float32)
    wrap = torch.from_numpy if port else jnp.asarray
    for _ in range(2):
        sess.send(wrap(a), 0, 1, max_paths=3)
    sess.send(wrap(b), 2, 3, num_chunks=3)
    sess.send(wrap(a), 3, 1, window=2, max_paths=2)
    sess.send(wrap(a), 0, 1, max_paths=3)
    items = [(wrap(c), 0, 1), (wrap(b), 1, 3), (wrap(a), 2, 0)]
    for _ in range(2):
        sess.exchange(items, max_paths=3)
    sess.bidirectional(wrap(b), 0, 2, max_paths=3)
    step = sess.capture(_step_build if port else _jstep_build)
    x = np.tile(np.arange(2048, dtype=np.float32), (4, 1))
    for _ in range(2):
        step(wrap(x))


@pytest.mark.parametrize("cache_capacity", [64, 1])
def test_sample_identities_equal_reference(jmesh4, cache_capacity):
    """Same requests → equal sample identities in order; a capacity of 1
    evicts every program, so fast-path hits rebuild it (compile > 0)."""
    knobs = dict(telemetry=True, multipath_threshold=64,
                 cache_capacity=cache_capacity)
    jsess = JCommSession(JCommConfig(health=False, **knobs), mesh=jmesh4,
                         topology=JTopology.full_mesh(4, with_host=False))
    sess = CommSession(CommConfig(**knobs), device="cpu",
                       topology=Topology.full_mesh(4, with_host=False))
    identity_traffic(jsess, port=False)
    identity_traffic(sess, port=True)
    jsamples, samples = jsess.telemetry.samples(), sess.telemetry.samples()
    assert len(samples) == sess.stats()["dispatches"] == 10
    assert sample_ids(samples) == sample_ids(jsamples)
    assert [s.fastpath_hit for s in samples] == [
        False, True, False, False, True, False, True, False, False, True]
    assert [s.compute for s in samples if s.compute] == [
        (("double", 2048, 0), ("inc", 2048, 0))] * 2
    rebuilt = []
    for s, js in zip(samples, jsamples):
        if s.fastpath_hit:
            for x in (s, js):
                assert (x.stages.plan_ns, x.stages.lower_ns,
                        x.stages.schedule_ns) == (0, 0, 0)
            # an evicted program is rebuilt: its build is the compile
            assert (s.stages.compile_ns > 0) == (js.stages.compile_ns > 0)
            rebuilt.append(s.stages.compile_ns > 0)
        else:
            # a captured step plans inside its lowering
            assert (s.stages.plan_ns > 0) == (not s.compute)
            assert s.stages.lower_ns > 0 and s.stages.schedule_ns > 0
            assert s.stages.compile_ns > 0
        assert s.stages.launch_ns > 0
    # the hit after the windowed send finds its program evicted
    assert rebuilt == [False, cache_capacity == 1, False, False]


# ------------------- capture adopters and path F's digest -------------------

def test_captured_flash_attention_stamps_the_reference_cost():
    def stamped(mod_rec, capture, adopter, dtype):
        cap = capture()
        q = cap.input((1, 2, 8, 8), dtype)
        adopter(cap, q, q, q, telemetry=mod_rec)
        (op,) = [o for o in cap.ops if o[0] == "kernel"]
        return op[-1]

    jrec, rec = (mod.TimelineRecorder(enabled=True) for mod in (jtel, ttel))
    for r in (jrec, rec):
        for ns in (900.0, 100.0, 300.0, 250.5):
            r.record_kernel("flash_attention", ns)
    got = stamped(rec, StepCapture, captured_flash_attention, torch.float32)
    want = stamped(jrec, JStepCapture, jcaptured_flash_attention,
                   jnp.float32)
    assert got == want == int(rec.kernel_cost_ns("flash_attention")) == 275
    empty = ttel.TimelineRecorder(enabled=True)
    assert stamped(empty, StepCapture, captured_flash_attention,
                   torch.float32) == 0
    assert stamped(None, StepCapture, captured_flash_attention,
                   torch.float32) == 0


def test_captured_ring_allgather_stamps_the_reference_cost():
    jrec, rec = (mod.TimelineRecorder(enabled=True) for mod in (jtel, ttel))
    for r in (jrec, rec):
        for ns in (5_000.0, 1_234.0, 4_321.0):
            r.record_kernel("ring_allgather", ns)
    cap, jcap = StepCapture(4), JStepCapture()
    out = captured_ring_allgather(cap, cap.input((2, 4), torch.float32), 4,
                                  telemetry=rec)
    jcaptured_ring_allgather(jcap, jcap.input((2, 4), jnp.float32), 4,
                             telemetry=jrec)
    (op,) = [o for o in cap.ops if o[0] == "kernel"]
    (jop,) = [o for o in jcap.ops if o[0] == "kernel"]
    assert op[1] == jop[1] == "ring_allgather"
    assert op[-1] == jop[-1] == 4321
    assert cap.buffers[out.buf_id].shape == (8, 4)
    assert cap.signature() == jcap.signature()


DECODE = dict(batch=1, heads=2, kv_len=16, head_dim=8, kv_chunk=4096,
              src=0, dst=2)


def decode_digests(dev_mesh):
    """(reference, port) lowered digests of the captured decode step, each
    session's recorder holding the same ``flash_attention`` samples."""
    jsess = JCommSession(JCommConfig(telemetry=True), mesh=dev_mesh)
    sess = CommSession(CommConfig(telemetry=True), device="cpu",
                       topology=Topology.full_mesh(8, with_host=True))
    for s in (jsess, sess):
        for ns in (40_000.0, 52_000.0, 47_500.0):
            s.telemetry.record_kernel("flash_attention", ns)
    jcap = jmake_captured_decode_step(jsess, **DECODE).capture
    cap = make_captured_decode_step(sess, **DECODE).capture
    jgraph, _ = jlower_step(jcap, jsess.engine.plan_group_for,
                            jsess.topology.name)
    graph, _ = lower_step(cap, sess.engine.plan_group_for,
                          sess.topology.name)
    (attn,) = [n for n in graph.nodes
               if getattr(n, "kernel", None) == "flash_attention"]
    return jgraph.digest(), graph.digest(), attn.cost_ns


def test_decode_step_digest_equal_reference_with_a_filled_recorder(
        dev_mesh, monkeypatch):
    jdigest, digest, cost = decode_digests(dev_mesh)
    assert cost == 47_500
    assert digest == jdigest
    # without the repair (the recorder not passed on) the digests part
    plain = serving_engine.captured_flash_attention
    monkeypatch.setattr(
        serving_engine, "captured_flash_attention",
        lambda cap, q, k, v, telemetry=None: plain(cap, q, k, v))
    jdigest, digest, cost = decode_digests(dev_mesh)
    assert cost == 0
    assert digest != jdigest
