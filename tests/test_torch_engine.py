"""The port's CommSession against the reference CommSession.

The same traffic, with the same numpy inputs, goes through the reference
session on 4 CPU devices and through the port's session on the CPU (the
kernel's plain version). Received arrays must be EQUAL bit for bit (a copy
does no arithmetic), the scheduled-graph digests behind every cached entry
equal, and the dispatch/cache/fast-path counters equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import CommConfig as JCommConfig
from repro.comm import CommSession as JCommSession

from repro_torch import carry
from repro_torch.comm import CommConfig, CommSession
from repro_torch.comm.engine import _check_executable, dtype_name
from repro_torch.core.topology import Topology

KiB = 1 << 10


@pytest.fixture(scope="module")
def jmesh4():
    return jax.sharding.Mesh(np.array(jax.devices()[:4]), ("dev",))


def payload(seed, shape, dtype):
    """(numpy bits, torch tensor, jax array) of one random message;
    bfloat16 payloads are raw uint16 bits shared by both sides."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if dtype == "float32":
        return x, torch.from_numpy(x.copy()), jnp.asarray(x)
    b = (x.view(np.uint32) >> 16).astype(np.uint16)
    return (b, torch.from_numpy(b.view(np.int16).copy()).view(torch.bfloat16),
            jnp.asarray(b).view(jnp.bfloat16))


def as_bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a.view(jnp.uint16) if a.dtype == jnp.bfloat16 else a)
    return a


def traffic(sess, side):
    """The same requests on either session; returns received bits."""
    pick = 1 if side == "port" else 2
    out = []
    a = payload(0, (5000,), "float32")
    for _ in range(2):                                 # second: fast path
        out.append(sess.send(a[pick], 0, 1, max_paths=3))
    b = payload(1, (3001,), "bfloat16")
    out.append(sess.send(b[pick], 2, 3, num_chunks=3))
    out.append(sess.send(a[pick], 3, 1, window=2, max_paths=2))
    c = payload(2, (2000,), "float32")
    out.extend(sess.bidirectional(c[pick], 0, 2, max_paths=3))
    items = [(payload(3, (3, 100), "float32")[pick], 0, 1),
             (payload(4, (50,), "bfloat16")[pick], 1, 3),
             (payload(5, (7000,), "float32")[pick], 2, 0),
             (payload(6, (10,), "float32")[pick], 3, 3),
             (payload(7, (0,), "float32")[pick], 0, 1)]
    for _ in range(2):
        out.extend(sess.exchange(items, max_paths=3))
    return [as_bits(o) for o in out]


def entries(sess):
    return sorted((e.digest, e.schedule, e.key.entries, e.key.window,
                   e.key.num_devices)
                  for _, e in sess.engine._fastpath._store.values())


def counters(stats):
    return (stats["dispatches"], stats["cache"]["hits"],
            stats["cache"]["misses"], stats["cache"]["size"],
            stats["fastpath"]["hits"], stats["fastpath"]["misses"],
            stats["graph"], stats["schedules"])


@pytest.mark.parametrize("knobs", [
    dict(schedule="auto"),
    dict(schedule="critical_path", validate="always"),
    dict(schedule="round_robin", fastpath=False)])
def test_session_matches_reference(jmesh4, knobs):
    knobs = dict(knobs, multipath_threshold=4 * KiB, chunk_bytes=4 * KiB)
    jsess = JCommSession(JCommConfig(**knobs), mesh=jmesh4)
    psess = CommSession(CommConfig(**knobs), device="cpu")
    assert psess.topology.digest() == jsess.topology.digest()
    want = traffic(jsess, "ref")
    got = traffic(psess, "port")
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert counters(psess.stats()) == counters(jsess.stats())
    if knobs.get("fastpath", True):
        assert entries(psess) == entries(jsess)


def test_dispatch_is_one_replay_with_all_copy_nodes():
    sess = CommSession(CommConfig(multipath_threshold=0), device="cpu",
                       topology=Topology.torus2d(4, 4))
    x = torch.randn(4099)
    for _ in range(3):
        assert torch.equal(sess.send(x, 0, 1, max_paths=3, num_chunks=2), x)
    (_, entry), = sess.engine._fastpath._store.values()
    assert max(pa.route.num_hops for pa in entry.plans[0].paths) == 3
    assert entry.compiled.program.completed_nodes() == \
        entry.graph.num_copy_nodes
    life = entry.compiled.lifecycle
    assert (life.launches, life.fastpath_hits) == (3, 2)
    stats = sess.stats()
    assert (stats["dispatches"], stats["fastpath"]["hits"]) == (3, 2)
    assert dtype_name(torch.bfloat16) == "bfloat16"
    assert dtype_name("float32") == "float32"


def test_compiled_for_replays_static_buffers():
    sess = CommSession(device="cpu")
    compiled, plan = sess.compiled_for(0, 3, 1000, torch.bfloat16,
                                       window=2, max_paths=2)
    assert sess.compiled_for(0, 3, 1000, torch.bfloat16, window=2,
                             max_paths=2)[0] is compiled
    msg = torch.randn(1000).to(torch.bfloat16)
    operand = torch.zeros(2, 4, 1000, dtype=torch.bfloat16)
    operand[:, 0] = msg
    (y,) = compiled(operand)
    assert torch.equal(y[1, 3], msg) and not y[:, :3].any()
    assert compiled.lifecycle.launches == 1
    assert sess.stats()["cache"]["size"] == 1


def test_session_needs_cuda_or_an_explicit_device():
    if torch.cuda.is_available():
        assert CommSession().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CommSession()
    with pytest.raises(ValueError):
        CommSession(device="meta")
    stats = CommSession(device="cpu").stats()
    assert stats["dispatches"] == 0 and stats["num_devices"] == 4
    assert stats["topology"] == "beluga4"


@pytest.mark.parametrize("knob", [dict(faults="fail@1:0-1")])
def test_unported_options_raise(knob):
    """A ``faults`` session constructs and delivers through the fault it
    injects: dispatch 1 fails (0, 1) and re-plans around it."""
    sess = CommSession(CommConfig(**knob), device="cpu")
    assert sess.faults is not None and sess.faults.active
    x = torch.arange(8, dtype=torch.float32)
    for _ in range(3):
        assert torch.equal(sess.send(x, 0, 1), x)
    assert (0, 1) in sess.topology.failed_links
    health = sess.stats()["health"]
    assert health["faults_seen"] == 1 and health["ladder_level"] == 1


def test_unported_paths_raise():
    """A send and a captured step under a quarantined link deliver
    bitwise on the surviving routes, at ladder level 1."""
    sess = CommSession(device="cpu")
    step = sess.capture(lambda cap: cap.kernel(
        torch.neg, cap.input((8,), torch.float32), name="neg"))
    sess.planner.quarantine((0, 1))
    x = torch.arange(8, dtype=torch.float32)
    assert torch.equal(sess.send(x, 0, 1), x)
    assert sess.stats()["health"]["ladder_level"] == 1
    xs = torch.arange(32, dtype=torch.float32).reshape(4, 8)
    (out,) = step(xs)
    assert torch.equal(out, -xs)
    assert sess.stats()["health"]["ladder_level"] == 1


def test_host_routes_stay_rejected(bridge3):
    topo = carry.topology_from_spec(carry.topology_spec(bridge3))
    sess = CommSession(CommConfig(multipath_threshold=0, include_host=True),
                       device="cpu", topology=topo)
    plan = sess.plan(0, 1, 4096, max_paths=2, include_host=True)
    assert any(-1 in (h.src, h.dst) for pa in plan.paths
               for h in pa.route.hops)
    with pytest.raises(ValueError, match="host"):
        _check_executable(plan)
    x = torch.arange(1024, dtype=torch.float32)
    assert torch.equal(sess.send(x, 0, 1, max_paths=2), x)
