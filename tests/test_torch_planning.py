"""The port's planning layer against the reference, on identical inputs.

Every fixture topology of ``conftest.py`` is rebuilt in the port through
``repro_torch.carry.topology_from_spec``; plans, lowered-graph digests,
the digest after each of the five schedulers, and the analytic model's
times must be EQUAL (not close): the planning layer is a transcription,
so any difference is a fault of the port.
"""

import dataclasses

import pytest

from repro.comm import CommConfig as JCommConfig
from repro.comm import PathPlanner as JPathPlanner
from repro.comm.graph import lower as jlower
from repro.comm.passes import apply_schedule as japply
from repro.comm.plan import TransferRequest as JRequest
from repro.core import Topology as JTopology
from repro.core import pipelining as jpl

from repro_torch import carry
from repro_torch.comm.config import CommConfig, SCHEDULE_NAMES
from repro_torch.comm.graph import lower
from repro_torch.comm.passes import apply_schedule
from repro_torch.comm.plan import TransferRequest
from repro_torch.comm.planner import PathPlanner
from repro_torch.core import pipelining as pl
from repro_torch.core.topology import Topology

FIXTURES = ("beluga4", "mesh4", "mesh8", "torus4x4", "bridge3", "two_island")
KiB = 1 << 10
#: Small chunk/threshold knobs so multipath and chunking engage at test
#: sizes; the same config goes to both packages.
KNOBS = dict(multipath_threshold=4 * KiB, chunk_bytes=16 * KiB,
             max_chunks=4)


def plan_key(plan) -> tuple:
    """Structural identity of a plan from either package."""
    return (plan.src, plan.dst, plan.nbytes, plan.topology_name, tuple(
        (pa.route.src, pa.route.dst, pa.route.via,
         tuple((h.src, h.dst, h.kind, h.bandwidth_gbps)
               for h in pa.route.hops),
         pa.route.bottleneck_gbps, pa.offset, pa.nbytes, pa.num_chunks,
         pa.granularity)
        for pa in plan.paths))


def pairs_of(n: int) -> list[tuple[int, int]]:
    return sorted({(0, 1), (0, n - 1), (1, n // 2), (n - 1, 0)}
                  - {(a, a) for a in range(n)})


def both(request, name):
    jt = request.getfixturevalue(name)
    pt = carry.topology_from_spec(carry.topology_spec(jt))
    jp = JPathPlanner(jt, config=JCommConfig(**KNOBS))
    pp = PathPlanner(pt, config=CommConfig(**KNOBS))
    return jt, pt, jp, pp


def sweep(topo):
    hosty = any(-1 in k for k in topo.links)
    for src, dst in pairs_of(topo.num_devices):
        for nbytes in (3 * KiB, 96 * KiB + 12):
            for max_paths in (1, 2, 4):
                for num_chunks in (None, 3):
                    for host in ((False, True) if hosty else (False,)):
                        yield (src, dst, nbytes,
                               dict(max_paths=max_paths,
                                    num_chunks=num_chunks,
                                    include_host=host, granularity=4))


@pytest.mark.parametrize("name", FIXTURES)
def test_topology_digest_carries(request, name):
    jt, pt, _, _ = both(request, name)
    assert pt.digest() == jt.digest()
    assert pt.num_islands == jt.num_islands
    assert pt.islands() == jt.islands()


@pytest.mark.parametrize("build", [
    lambda T: T.full_mesh(4), lambda T: T.full_mesh(8, with_host=False),
    lambda T: T.full_mesh(4, sublinks_per_pair=4, name="narval4"),
    lambda T: T.torus2d(4, 4), lambda T: T.torus2d(2, 4),
    lambda T: T.hierarchical(2, 4),
    lambda T: T.hierarchical(2, 4, intra="torus", torus_shape=(2, 2),
                             egress_per_island=2)])
def test_constructors_digest_equal(build):
    assert build(Topology).digest() == build(JTopology).digest()


@pytest.mark.parametrize("name", FIXTURES)
def test_plans_and_model_equal(request, name):
    jt, pt, jp, pp = both(request, name)
    n = 0
    for src, dst, nbytes, kw in sweep(jt):
        try:
            jplan = jp.plan(src, dst, nbytes, **kw)
        except ValueError as exc:
            with pytest.raises(ValueError, match=str(exc)[:20]):
                pp.plan(src, dst, nbytes, **kw)
            continue
        pplan = pp.plan(src, dst, nbytes, **kw)
        assert plan_key(pplan) == plan_key(jplan)
        for compiled in (True, False):
            assert pl.estimate_transfer_time_s(
                pplan, pt, compiled_plan=compiled) == \
                jpl.estimate_transfer_time_s(jplan, jt,
                                             compiled_plan=compiled)
        assert pl.wire_time_s(pplan, pt) == jpl.wire_time_s(jplan, jt)
        assert pl.launch_overhead_ns(pplan, compiled_plan=True, topo=pt) \
            == jpl.launch_overhead_ns(jplan, compiled_plan=True, topo=jt)
        n += 1
    assert n > 0


@pytest.mark.parametrize("schedule", SCHEDULE_NAMES)
@pytest.mark.parametrize("name", FIXTURES)
def test_schedules_digest_equal(request, name, schedule):
    jt, pt, jp, pp = both(request, name)
    for src, dst, nbytes, kw in sweep(jt):
        if kw["include_host"] or kw["max_paths"] == 2:
            continue
        try:
            jplan = jp.plan(src, dst, nbytes, **kw)
        except ValueError:
            continue
        pplan = pp.plan(src, dst, nbytes, **kw)
        for window in (1, 2):
            jg, pg = jlower(jplan, window), lower(pplan, window)
            assert pg.digest() == jg.digest()
            assert pg.num_copy_nodes == jg.num_copy_nodes
            jsg, jchosen = japply(jg, schedule, jt)
            psg, pchosen = apply_schedule(pg, schedule, pt)
            assert pchosen == jchosen
            assert psg.digest() == jsg.digest()
            assert pl.scheduled_time_s(psg, pt) == \
                jpl.scheduled_time_s(jsg, jt)


@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("name", FIXTURES)
def test_plan_group_equal(request, name, exclusive):
    jt, pt, jp, pp = both(request, name)
    n = jt.num_devices
    flows = [(i, (i + 1) % n) for i in range(n)] + [(0, n - 1), (0, 1)]
    reqs = [(s, d, (64 + 16 * i) * KiB, 4) for i, (s, d) in enumerate(flows)]
    try:
        jgroup = jp.plan_group([JRequest(*r) for r in reqs],
                               exclusive=exclusive)
    except ValueError:
        with pytest.raises(ValueError):
            pp.plan_group([TransferRequest(*r) for r in reqs],
                          exclusive=exclusive)
        return
    pgroup = pp.plan_group([TransferRequest(*r) for r in reqs],
                           exclusive=exclusive)
    assert [plan_key(p) for p in pgroup.plans] == \
        [plan_key(p) for p in jgroup.plans]
    assert pl.estimate_group_time_s(pgroup, pt) == \
        jpl.estimate_group_time_s(jgroup, jt)
    for window in (1, 2):
        assert lower(pgroup, window).digest() == \
            jlower(jgroup, window).digest()


@pytest.mark.parametrize("name", ["beluga4", "torus4x4"])
def test_tune_equal(request, name):
    jt, pt, jp, pp = both(request, name)
    for nbytes in (8 * KiB, 512 * KiB):
        assert plan_key(pp.tune(0, 1, nbytes, granularity=4)) == \
            plan_key(jp.tune(0, 1, nbytes, granularity=4))


def test_config_from_env_equal(monkeypatch):
    env = {"REPRO_MP_MAX_PATHS": "3", "REPRO_MP_CHUNK_BYTES": "65536",
           "REPRO_MP_MAX_CHUNKS": "5", "REPRO_MP_HOST_PATH": "1",
           "REPRO_MP_THRESHOLD": "1024", "REPRO_MP_WINDOW": "2",
           "REPRO_MP_POLICY": "round_robin", "REPRO_MP_SCHEDULE": "auto",
           "REPRO_MP_FASTPATH": "0", "REPRO_MP_VALIDATE": "always",
           "REPRO_PLAN_CACHE_SIZE": "7", "REPRO_MP_DROOP_THRESHOLD": "3.5",
           "REPRO_MP_RETRY_LIMIT": "bogus"}
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = dataclasses.asdict(CommConfig.from_env(window=3))
    want = dataclasses.asdict(JCommConfig.from_env(window=3))
    assert got == want
    assert carry.config_from_dict(want) == CommConfig.from_env(window=3)
    with pytest.raises(TypeError):
        carry.config_from_dict({"mesh": None})


def test_carry_keeps_digest_after_mutation(two_island):
    """A topology mutated on the reference side carries its new shape,
    and a port topology round-trips through its own spec."""
    two_island.fail_link(0, 4)
    pt = carry.topology_from_spec(carry.topology_spec(two_island))
    assert pt.digest() == two_island.digest()
    again = carry.topology_from_spec(carry.topology_spec(pt))
    assert again.digest() == pt.digest() and again.name == pt.name
