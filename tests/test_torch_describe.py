"""The port's ``CommSession.describe`` against the reference's.

``describe`` is pure planning: it plans one message, lowers and
schedules it exactly as the engine would, and reports the scheduled
graph, the §4.4 model's costs, the lane-model overlap, the calibration
in force, the island structure and the fault state. The same request on
a reference session and a port session, each on its own copy of one
topology (``carry.topology_from_spec``), must give the same dict: equal
keys, digests, counts and names, and modeled times within 1e-12
relative. The plan epoch carries per-process identities, so only its
mutation counts are compared. Requests: flat, ``overlap``, ``auto`` and
the other schedulers, two-island, with a window, ``max_paths`` and a
host path, before and under a failed, degraded or quarantined link, with
health on and off, and with a calibration profile and samples attached.
"""

import math

import pytest

from repro.comm import CommConfig as JCommConfig
from repro.comm import CommSession as JCommSession
from repro.comm import calibration as jcal
from repro.comm import telemetry as jtel
from repro.core import Topology as JTopology
from repro.core import pipelining as jpl

from repro_torch import carry
from repro_torch.comm import CommConfig, CommSession
from repro_torch.comm import calibration as tcal
from repro_torch.comm import telemetry as ttel
from repro_torch.core import pipelining as tpl

MiB = 1 << 20

TOPOLOGIES = {
    "beluga4": lambda: JTopology.full_mesh(4),
    "mesh4": lambda: JTopology.full_mesh(4, with_host=False, name="mesh4"),
    "two_island": lambda: JTopology.hierarchical(2, 4, name="two_island"),
}

# (topology, src, dst) of each request
REQUESTS = [("beluga4", 0, 1), ("mesh4", 2, 3), ("two_island", 1, 7),
            ("two_island", 1, 3)]

SCHEDULES = ["round_robin", "depth_first", "critical_path", "overlap",
             "auto"]


def assert_same(got, want, where="describe"):
    """Equal structure and exact leaves, floats within 1e-12 relative."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (a, b) in enumerate(zip(got, want)):
            assert_same(a, b, f"{where}[{i}]")
    elif isinstance(want, float):
        assert isinstance(got, float), where
        if got != want:
            assert math.isfinite(want) and abs(got - want) <= 1e-12 * abs(
                want), f"{where}: {got!r} != {want!r}"
    else:
        assert type(got) is type(want) and got == want, \
            f"{where}: {got!r} != {want!r}"


def sessions(topo_name, **cfg):
    jtopo = TOPOLOGIES[topo_name]()
    jsess = JCommSession(JCommConfig(**cfg), topology=jtopo)
    sess = CommSession(CommConfig(**cfg), device="cpu",
                       topology=carry.topology_from_spec(
                           carry.topology_spec(jtopo)))
    return jsess, sess


def both(jsess, sess, fn):
    fn(jsess)
    fn(sess)


def compare(jsess, sess, src, dst, nbytes, **kw):
    got = sess.describe(src, dst, nbytes, **kw)
    want = jsess.describe(src, dst, nbytes, **kw)
    (_, *a), (_, *b) = (d["fastpath"].pop("epoch") for d in (got, want))
    assert (a[0], a[2]) == (b[0], b[2])            # mutation counts
    assert_same(got, want)
    assert sess._engine is None                    # pure planning
    return got


FAULTS = {
    "healthy": lambda s: None,
    "failed": lambda s: s.topology.fail_link(0, 1),
    "degraded": lambda s: s.topology.degrade_link(0, 2, 0.25),
    "quarantined": lambda s: s.planner.quarantine((0, 3)),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("request_", REQUESTS,
                         ids=[f"{t}-{s}-{d}" for t, s, d in REQUESTS])
def test_describe_equals_reference(request_, schedule, fault):
    topo, src, dst = request_
    jsess, sess = sessions(topo, multipath_threshold=256, schedule=schedule)
    both(jsess, sess, FAULTS[fault])
    for nbytes in (4096, 8 * MiB):
        d = compare(jsess, sess, src, dst, nbytes)
    assert d["schedule"]["requested"] == schedule
    assert ("candidates" in d["schedule"]) == (schedule == "auto")
    assert ("all_reduce" in d["hierarchy"]) == (topo == "two_island")


@pytest.mark.parametrize("kw", [dict(window=2), dict(max_paths=2),
                                dict(num_chunks=3),
                                dict(include_host=True, max_paths=4),
                                dict(schedule="overlap", window=3)])
def test_describe_options_equal_reference(kw):
    jsess, sess = sessions("beluga4", multipath_threshold=0)
    compare(jsess, sess, 0, 1, 3 * MiB, **kw)
    both(jsess, sess, lambda s: s.topology.fail_link(0, 1))
    compare(jsess, sess, 0, 1, 3 * MiB, **kw)


def test_describe_health_section_under_faults():
    jsess, sess = sessions("beluga4")
    both(jsess, sess, lambda s: s.topology.fail_link(0, 1))
    both(jsess, sess, lambda s: s.topology.degrade_link(2, 3, 0.5))
    both(jsess, sess, lambda s: s.monitor.quarantine_link((0, 2), "droop"))
    h = compare(jsess, sess, 0, 1, 8 * MiB)["health"]
    assert h["failed"] == [[0, 1]] and h["degraded"] == {"2-3": 0.5}
    assert h["quarantined"] == [[0, 2]]
    assert h["monitor"]["quarantines"] == 1


def test_describe_with_health_off():
    jsess, sess = sessions("beluga4", health=False)
    h = compare(jsess, sess, 0, 1, MiB)["health"]
    assert h["enabled"] is False and "monitor" not in h


@pytest.mark.parametrize("strategy", ["auto", "flat", "two_level"])
def test_describe_two_island_strategies(strategy):
    jsess, sess = sessions("two_island", multipath_threshold=256,
                           collective_strategy=strategy)
    ar = compare(jsess, sess, 1, 7, 8 * MiB)["hierarchy"]["all_reduce"]
    assert ar["chosen"] == ("two_level" if strategy == "auto"
                            else strategy)


def test_describe_digest_returns_after_restore():
    """Restoring a failed link restores the request's pre-fault digest."""
    jsess, sess = sessions("beluga4", multipath_threshold=256)
    pre = compare(jsess, sess, 0, 1, 8 * MiB)["graph"]["digest"]
    both(jsess, sess, lambda s: s.topology.fail_link(0, 1))
    assert compare(jsess, sess, 0, 1, 8 * MiB)["graph"]["digest"] != pre
    both(jsess, sess, lambda s: s.topology.restore_link(0, 1))
    assert compare(jsess, sess, 0, 1, 8 * MiB)["graph"]["digest"] == pre


def _profile(cal, pl, digest):
    return cal.CalibrationProfile(
        topology_digest=digest,
        link_bandwidth_gbps={(0, 1): 400.0, (0, 2): 210.5},
        launch=pl.LaunchModel(graph_launch_base_ns=26000.0,
                              graph_launch_per_node_ns=55.0),
        link_samples={(0, 1): 9, (0, 2): 4}, launch_samples=12)


def _samples(tel):
    out = []
    for i in range(6):
        routes = (((((0, 1),), 4096 << i, 2), (((0, 2), (2, 1)), 2048, 1)),)
        out.append(tel.DispatchSample(
            routes=routes, nbytes=(4096 << i) + 2048, num_nodes=3,
            window=1, schedule="round_robin",
            stages=tel.StageTimings(launch_ns=20000 + 100 * i,
                                    execute_ns=5000 * (i + 1)),
            fastpath_hit=i > 0))
    return out


def test_describe_calibration_section_equals_reference():
    jsess, sess = sessions("beluga4", multipath_threshold=256,
                           telemetry=True)
    for s, tel in ((jsess, jtel), (sess, ttel)):
        for smp in _samples(tel):
            s.telemetry.record(smp)
    before = compare(jsess, sess, 0, 1, 8 * MiB)
    assert before["calibration"]["active"] is False
    jsess.topology.set_calibration(
        _profile(jcal, jpl, jsess.topology.digest()))
    sess.topology.set_calibration(
        _profile(tcal, tpl, sess.topology.digest()))
    after = compare(jsess, sess, 0, 1, 8 * MiB)
    assert after["calibration"]["active"] is True
    assert "residuals" in after["calibration"]
    assert after["model"]["time_s"] != before["model"]["time_s"]
