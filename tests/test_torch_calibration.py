"""The port's calibration layer against the reference's (DESIGN §4.4c).

The behaviours of the reference's ``tests/test_calibration.py`` run on
the port (the session ones on a port ``CommSession`` on the CPU, with
``_calibration_info()`` in place of ``describe()``, which a later slice
ports). Against the reference, on the same inputs:

* the same seeded synthetic ``DispatchSample`` streams through both
  fitters give EQUAL profile payloads (the fitter rounds bandwidths to
  1e-6), and ``modeled_sample_time_s`` / ``modeled_vs_measured`` agree
  within 1e-12 relative;
* a profile saved by either package loads in the other, by file and
  through a session's ``profile_dir``;
* with one profile attached to both topologies, plans, lowered-graph
  digests, the model's estimates and ``auto``'s choice and scores are
  equal over a sweep of sizes and ``max_paths``, the reference's
  arbitration flip included.
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro.comm import calibration as jcal
from repro.comm import telemetry as jtel
from repro.comm.graph import lower as jlower
from repro.comm.passes import make_schedule as jmake_schedule
from repro.comm.planner import PathPlanner as JPathPlanner
from repro.core import Topology as JTopology
from repro.core import pipelining as jpl

from repro_torch.comm import (PROFILE_VERSION, CalibrationFitter,
                              CalibrationProfile, CommConfig, CommSession,
                              PathPlanner, modeled_sample_time_s,
                              modeled_vs_measured)
from repro_torch.comm import telemetry as ttel
from repro_torch.comm.graph import ComputeNode, lower
from repro_torch.comm.passes import make_schedule
from repro_torch.core import pipelining as tpl
from repro_torch.core.pipelining import (COMPUTE_GFLOPS, DEFAULT_LAUNCH_MODEL,
                                         LaunchModel, compute_time_s,
                                         estimate_transfer_time_s,
                                         launch_model_for)
from repro_torch.core.topology import Topology

MiB = 1 << 20


@pytest.fixture()
def topo():
    return Topology.full_mesh(4, with_host=False, name="m4")


def _profile(topo, bw=None, launch=None, cls=CalibrationProfile):
    return cls(topology_digest=topo.digest(),
               link_bandwidth_gbps=bw or {}, launch=launch,
               link_samples={k: 5 for k in (bw or {})}, launch_samples=5)


def _sample(routes, *, window=1, schedule="round_robin", launch_ns=20_000,
            execute_ns=100_000, compile_ns=0, num_nodes=4):
    stages = ttel.StageTimings(launch_ns=launch_ns, execute_ns=execute_ns,
                               compile_ns=compile_ns)
    nbytes = sum(r[1] for plan in routes for r in plan)
    return ttel.DispatchSample(routes=routes, nbytes=nbytes,
                               num_nodes=num_nodes, window=window,
                               schedule=schedule, stages=stages,
                               fastpath_hit=compile_ns == 0)


def _direct_routes(nbytes=4 * MiB, chunks=4):
    return (((((0, 1),), nbytes, chunks),),)


# ------------------------- profile persistence ------------------------------

def test_profile_payload_round_trip(topo):
    launch = dataclasses.replace(DEFAULT_LAUNCH_MODEL,
                                 graph_launch_base_ns=12345)
    prof = _profile(topo, bw={(0, 1): 17.5, (2, 3): 40.0}, launch=launch)
    clone = CalibrationProfile.from_payload(prof.to_payload())
    assert clone.topology_digest == prof.topology_digest
    assert clone.link_bandwidth_gbps == prof.link_bandwidth_gbps
    assert clone.launch == prof.launch
    assert clone.version == PROFILE_VERSION == jcal.PROFILE_VERSION == 1
    assert clone.link_samples == prof.link_samples
    jprof = jcal.CalibrationProfile.from_payload(prof.to_payload())
    assert jprof.to_payload() == prof.to_payload()
    assert jprof.filename() == prof.filename()
    assert jprof.summary() == prof.summary()


def test_profile_version_mismatch_rejected(topo):
    payload = _profile(topo).to_payload()
    payload["version"] = PROFILE_VERSION + 1
    with pytest.raises(ValueError, match="version"):
        CalibrationProfile.from_payload(payload)


def test_profile_save_load_for(tmp_path, topo):
    prof = _profile(topo, bw={(0, 1): 21.0})
    path = prof.save(str(tmp_path))
    assert os.path.basename(path) == prof.filename()
    loaded = CalibrationProfile.load_for(topo, str(tmp_path))
    assert loaded is not None
    assert loaded.link_bandwidth_gbps == {(0, 1): 21.0}
    other = Topology.full_mesh(8, with_host=False)
    assert CalibrationProfile.load_for(other, str(tmp_path)) is None


def test_load_for_refuses_digest_mismatch(tmp_path, topo):
    other = Topology.full_mesh(8, with_host=False)
    payload = _profile(other).to_payload()
    target = tmp_path / CalibrationProfile(
        topology_digest=topo.digest()).filename()
    target.write_text(json.dumps(payload))
    with pytest.raises(ValueError, match="digest"):
        CalibrationProfile.load_for(topo, str(tmp_path))


def test_set_calibration_refuses_digest_mismatch(topo):
    other = Topology.full_mesh(8, with_host=False)
    with pytest.raises(ValueError, match="digest"):
        topo.set_calibration(_profile(other))


def test_structural_mutation_drops_profile(topo):
    prof = _profile(topo, bw={(0, 1): 9.0})
    topo.set_calibration(prof)
    assert topo.calibration is prof
    assert topo.link(0, 1).bandwidth_gbps == 9.0
    topo.remove_link(2, 3)
    assert topo.calibration is None
    assert topo.link(0, 1).bandwidth_gbps != 9.0


def test_detach_restores_nominal(topo):
    nominal = topo.link(0, 1).bandwidth_gbps
    topo.set_calibration(_profile(topo, bw={(0, 1): 3.0}))
    epoch = topo.epoch
    assert topo.link(0, 1).bandwidth_gbps == 3.0
    topo.set_calibration(None)
    assert topo.link(0, 1).bandwidth_gbps == nominal
    assert topo.epoch != epoch


# ------------------------- fitter gating ------------------------------------

def test_fitter_min_sample_gate(topo):
    fitter = CalibrationFitter(topo, min_samples=5, warmup=1)
    prof = fitter.fit([_sample(_direct_routes()) for _ in range(3)])
    assert prof.link_bandwidth_gbps == {}
    assert prof.launch is None
    assert prof.topology_digest == topo.digest()


def test_fitter_drops_warmup(topo):
    warm = _sample(_direct_routes(), execute_ns=500_000_000)
    rest = [_sample(_direct_routes()) for _ in range(6)]
    fitted = CalibrationFitter(topo, min_samples=3, warmup=1).fit(
        [warm] + rest)
    with_warm = CalibrationFitter(topo, min_samples=3, warmup=0).fit(
        [warm] + rest)
    assert (fitted.link_bandwidth_gbps[(0, 1)]
            > with_warm.link_bandwidth_gbps[(0, 1)])


@pytest.mark.parametrize("kwargs,match", [
    (dict(min_samples=0), "min_samples"), (dict(warmup=-1), "warmup"),
    (dict(decay=1.5), "decay"), (dict(max_ratio=0.5), "max_ratio")])
def test_fitter_validation(topo, kwargs, match):
    with pytest.raises(ValueError, match=match):
        CalibrationFitter(topo, **kwargs)


def test_fitted_profile_strictly_closer_on_synthetic_slowdown(topo):
    nominal = topo.link(0, 1).bandwidth_gbps
    nbytes = 4 * MiB
    wire_ns = nbytes / (nominal / 10 * 1e9) * 1e9
    samples = [_sample(_direct_routes(nbytes), launch_ns=30_000,
                       execute_ns=int(wire_ns)) for _ in range(8)]
    prof = CalibrationFitter(topo, min_samples=3, warmup=1).fit(samples)
    assert prof.link_bandwidth_gbps[(0, 1)] < nominal
    res = modeled_vs_measured(samples, topo, profile=prof)
    assert res["fitted"]["mean_rel_err"] < res["constant"]["mean_rel_err"]
    fitted_t = modeled_sample_time_s(samples[-1], topo, profile=prof)
    cold_t = modeled_sample_time_s(samples[-1], topo)
    measured = samples[-1].measured_s
    assert abs(fitted_t - measured) < abs(cold_t - measured)


# ------------------------- fitted-term consumption --------------------------

def _skewed_profile(topo, cls=CalibrationProfile, model=DEFAULT_LAUNCH_MODEL):
    """The reference test's profile: the direct link 25x slower than
    nominal and a µs-scale per-node launch, under which ``auto`` flips
    from ``critical_path`` to ``round_robin``."""
    bw = {k: 50.0 for k in topo.links}
    bw[(0, 1)] = 2.0
    launch = dataclasses.replace(model, graph_launch_per_node_ns=100_000)
    return _profile(topo, bw=bw, launch=launch, cls=cls)


def test_auto_arbitration_flips_on_fitted_terms(topo):
    planner = PathPlanner(topo, multipath_threshold=256)
    plan = planner.plan(0, 1, 8 * MiB + 12_288, max_paths=3, num_chunks=4,
                        granularity=4)
    graph = lower(plan)
    auto = make_schedule("auto", topo)
    cold_name, _, cold_scores = auto.select(graph)
    assert cold_name == "critical_path"
    topo.set_calibration(_skewed_profile(topo))
    fit_name, _, fit_scores = auto.select(graph)
    assert fit_name == "round_robin"
    assert fit_scores[fit_name] < fit_scores["critical_path"]
    assert fit_scores != cold_scores


def test_estimates_consume_fitted_bandwidth(topo):
    plan = PathPlanner(topo, multipath_threshold=256).plan(0, 1, 8 * MiB,
                                                           max_paths=3)
    cold = estimate_transfer_time_s(plan, topo)
    topo.set_calibration(_skewed_profile(topo))
    assert estimate_transfer_time_s(plan, topo) > cold


def test_launch_model_for_prefers_fitted(topo):
    assert launch_model_for(topo) is DEFAULT_LAUNCH_MODEL
    custom = dataclasses.replace(DEFAULT_LAUNCH_MODEL,
                                 graph_launch_base_ns=1)
    topo.set_calibration(_profile(topo, launch=custom))
    assert launch_model_for(topo) == custom
    assert isinstance(launch_model_for(topo), LaunchModel)


# ------------------------- session integration ------------------------------

def _session(**cfg):
    return CommSession(CommConfig(multipath_threshold=64, **cfg),
                       device="cpu",
                       topology=Topology.full_mesh(4, with_host=False))


def test_session_calibrate_requires_samples():
    with pytest.raises(ValueError, match="telemetry"):
        _session().calibrate()
    sess = _session(telemetry=True)
    sess.send(torch.ones(64), 0, 1)
    with pytest.raises(ValueError, match="fitter"):
        sess.calibrate(fitter=CalibrationFitter(sess.topology), warmup=0)
    with pytest.raises(ValueError, match="profile_dir"):
        sess.calibrate(warmup=0, min_samples=1, persist=True)


def test_session_calibrate_end_to_end(tmp_path):
    """CPU traffic → fitted profile → strictly closer model, attached
    (plans re-derived) with every later send still bitwise. The droop
    monitor is off: under the fitted profile the larger sends read
    2.5–4.5× their modeled time on the CPU, so host noise on one more
    send quarantines every route 0→1, and this host-less mesh has no
    relay rung left (the monitor is tested in ``test_torch_health.py``)."""
    sess = _session(telemetry=True, health=False)
    msg = torch.arange(1 << 14, dtype=torch.float32)
    for _ in range(6):
        assert torch.equal(sess.send(msg, 0, 1, max_paths=3,
                                     num_chunks=2), msg)
    epoch = sess.planner.epoch
    prof = sess.calibrate(min_samples=2, warmup=1, persist=str(tmp_path))
    assert sess.topology.calibration is prof
    assert sess.planner.epoch != epoch
    assert sess.stats()["calibration"]["active"] is True
    res = modeled_vs_measured(sess.telemetry.samples(), sess.topology,
                              profile=prof)
    assert res["fitted"]["mean_rel_err"] < res["constant"]["mean_rel_err"]
    info = sess._calibration_info()
    assert info["active"] is True and info["profile"] == prof.summary()
    assert info["residuals"]["fitted"]["mean_rel_err"] == pytest.approx(
        res["fitted"]["mean_rel_err"])
    reloaded = CalibrationProfile.load_for(sess.topology, str(tmp_path))
    assert reloaded is not None
    assert reloaded.to_payload() == prof.to_payload()
    for n in (1 << 14, 12_345, 1 << 18):
        m = torch.randn(n, generator=torch.Generator().manual_seed(n))
        for _ in range(2):
            assert torch.equal(sess.send(m, 0, 1, max_paths=3), m)


def test_session_loads_profile_on_init(tmp_path):
    topo = Topology.full_mesh(4, with_host=False)
    CalibrationProfile(topology_digest=topo.digest(),
                       link_bandwidth_gbps={(0, 1): 4.0}, launch=None,
                       link_samples={(0, 1): 9},
                       launch_samples=0).save(str(tmp_path))
    sess = _session(profile_dir=str(tmp_path))
    assert sess.topology.calibration is not None
    assert sess.topology.link(0, 1).bandwidth_gbps == 4.0
    assert sess.stats()["calibration"]["active"] is True
    assert sess._calibration_info() == {
        "active": True, "profile": sess.topology.calibration.summary()}


def test_session_warns_and_runs_on_corrupt_profile(tmp_path):
    topo = Topology.full_mesh(4, with_host=False)
    bad = tmp_path / CalibrationProfile(
        topology_digest=topo.digest()).filename()
    bad.write_text("{not json")
    with pytest.warns(UserWarning, match="calibration"):
        sess = _session(profile_dir=str(tmp_path))
    assert sess.topology.calibration is None
    msg = torch.arange(256, dtype=torch.float32)
    assert torch.equal(sess.send(msg, 0, 1), msg)


# ------------------- per-kernel compute term (§4.4d) ------------------------

def test_fitter_kernel_channel_gates_and_fits(topo):
    fitter = CalibrationFitter(topo, min_samples=3, warmup=1)
    kernels = {"attn": (999_999.0, 100.0, 300.0, 200.0),
               "sparse": (10.0, 20.0),
               "zeros": (5.0, 0.0, -1.0, 0.0)}
    prof = fitter.fit([_sample(_direct_routes()) for _ in range(6)],
                      kernels=kernels)
    assert prof.kernel_cost_ns == {"attn": 200.0}
    assert prof.kernel_samples == {"attn": 3}
    assert prof.summary()["kernels_fitted"] == 1


def test_profile_payload_round_trips_kernels(topo):
    prof = CalibrationProfile(
        topology_digest=topo.digest(),
        kernel_cost_ns={"attn": 123.5}, kernel_samples={"attn": 7})
    clone = CalibrationProfile.from_payload(prof.to_payload())
    assert clone.kernel_cost_ns == {"attn": 123.5}
    assert clone.kernel_samples == {"attn": 7}
    payload = prof.to_payload()
    del payload["kernels"]
    legacy = CalibrationProfile.from_payload(payload)
    assert legacy.kernel_cost_ns == {} and legacy.kernel_samples == {}


def test_compute_time_precedence(topo):
    by_flops = ComputeNode(kernel="attn", window=0, operands=(0,),
                           results=(1,), flops=5_000_000, cost_ns=0)
    stamped = dataclasses.replace(by_flops, cost_ns=2_000)
    assert compute_time_s(by_flops, topo) == pytest.approx(
        5_000_000 / (COMPUTE_GFLOPS * 1e9))
    assert compute_time_s(stamped, topo) == pytest.approx(2e-6)
    topo.set_calibration(CalibrationProfile(
        topology_digest=topo.digest(),
        kernel_cost_ns={"attn": 7_000.0}, kernel_samples={"attn": 4}))
    assert compute_time_s(by_flops, topo) == pytest.approx(7e-6)
    assert compute_time_s(stamped, topo) == pytest.approx(7e-6)
    other = dataclasses.replace(stamped, kernel="sweep")
    assert compute_time_s(other, topo) == pytest.approx(2e-6)


def test_session_calibrate_forwards_kernel_channel():
    sess = _session(telemetry=True)
    msg = torch.arange(1 << 12, dtype=torch.float32)
    for _ in range(4):
        sess.send(msg, 0, 1)
    for ns in (900.0, 100.0, 200.0, 300.0):
        sess.telemetry.record_kernel("attn", ns)
    prof = sess.calibrate(min_samples=2, warmup=1)
    assert prof.kernel_cost_ns == {"attn": 200.0}
    assert sess.topology.calibration is prof


# ------------------- against the reference, same inputs ---------------------

def topologies(with_host: bool) -> tuple:
    """(reference, port) copies of one 4-device full mesh."""
    jt = JTopology.full_mesh(4, with_host=with_host, name="m4")
    pt = Topology.full_mesh(4, with_host=with_host, name="m4")
    assert jt.digest() == pt.digest()
    return jt, pt


def seeded_stream(seed: int, topo) -> list[dict]:
    """A seeded synthetic sample stream over ``topo``'s links: one- and
    two-hop routes (through the host where it has one), 1–3 messages of
    1–3 paths, windows 1–2, some with compute identities; 12 signatures,
    each dispatched 2–7 times, with noisy launch/execute/compile times."""
    rng = np.random.default_rng(seed)
    links = sorted(topo.links)
    sigs = []
    for _ in range(12):
        msgs = []
        for _ in range(int(rng.integers(1, 4))):
            paths = []
            for _ in range(int(rng.integers(1, 4))):
                a, b = links[int(rng.integers(len(links)))]
                hops = [(a, b)]
                onward = [ln for ln in links if ln[0] == b and ln[1] != a]
                if onward and rng.random() < 0.5:
                    hops.append(onward[int(rng.integers(len(onward)))])
                paths.append((tuple(hops), int(rng.integers(1, 64 * MiB)),
                              int(rng.integers(1, 9))))
            msgs.append(tuple(paths))
        compute = ((("attn", int(rng.integers(0, 10 ** 9)),
                     int(rng.integers(0, 10 ** 6))),)
                   if rng.random() < 0.25 else ())
        nodes = sum(len(h) * c for m in msgs for h, _, c in m)
        sigs.append(dict(routes=tuple(msgs), window=int(rng.integers(1, 3)),
                         schedule=("round_robin", "critical_path")[
                             int(rng.integers(2))],
                         num_nodes=nodes, compute=compute,
                         reps=int(rng.integers(2, 8))))
    stream = []
    for _ in range(max(s["reps"] for s in sigs)):
        for i in rng.permutation(len(sigs)):
            s = sigs[int(i)]
            seen = sum(x["sig"] == int(i) for x in stream)
            if seen >= s["reps"]:
                continue
            launch = 7_000 + 300 * s["num_nodes"] + rng.normal(0, 800)
            stream.append(dict(
                sig=int(i), routes=s["routes"], window=s["window"],
                schedule=s["schedule"], num_nodes=s["num_nodes"],
                compute=s["compute"],
                nbytes=sum(b for m in s["routes"] for _, b, _ in m),
                launch_ns=max(1, int(launch)),
                execute_ns=int(rng.integers(-2, 5_000_000)),
                compile_ns=(int(90_000 + 85_000 * s["num_nodes"]
                                * rng.uniform(0.5, 2.0))
                            if seen == 0 else 0),
                staging_ns=int(rng.integers(0, 50_000))))
    return stream


def build(stream, mod) -> list:
    """``stream``'s samples as ``mod``'s ``DispatchSample`` objects."""
    return [mod.DispatchSample(
        routes=s["routes"], nbytes=s["nbytes"], num_nodes=s["num_nodes"],
        window=s["window"], schedule=s["schedule"],
        stages=mod.StageTimings(compile_ns=s["compile_ns"],
                                staging_ns=s["staging_ns"],
                                launch_ns=s["launch_ns"],
                                execute_ns=s["execute_ns"]),
        fastpath_hit=s["compile_ns"] == 0, compute=s["compute"])
        for s in stream]


def seeded_kernels(seed: int) -> dict:
    rng = np.random.default_rng(seed + 100)
    return {"flash_attention": tuple(rng.uniform(-10, 5e5, 9).tolist()),
            "ring_allgather": tuple(rng.uniform(1e5, 9e5, 2).tolist())}


FITS = [dict(), dict(min_samples=3, warmup=2),
        dict(min_samples=1, warmup=0, decay=1.0, max_ratio=4.0),
        dict(decay=0.2, max_ratio=64.0)]


def assert_rel(a: float, b: float) -> None:
    assert a == pytest.approx(b, rel=1e-12, abs=0.0)


@pytest.mark.parametrize("with_host", [False, True])
@pytest.mark.parametrize("fit", range(len(FITS)))
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fitters_agree_on_seeded_streams(seed, fit, with_host):
    jt, pt = topologies(with_host)
    stream = seeded_stream(seed, pt)
    jsamples, samples = build(stream, jtel), build(stream, ttel)
    kernels = seeded_kernels(seed)
    jprof = jcal.CalibrationFitter(jt, **FITS[fit]).fit(jsamples,
                                                        kernels=kernels)
    prof = CalibrationFitter(pt, **FITS[fit]).fit(samples, kernels=kernels)
    assert prof.to_payload() == jprof.to_payload()
    assert prof.link_bandwidth_gbps           # every case fits some links
    for s, js in zip(samples, jsamples):
        for p, jp in ((None, None), (prof, jprof)):
            assert_rel(modeled_sample_time_s(s, pt, p),
                       jcal.modeled_sample_time_s(js, jt, jp))
    for p, jp in ((None, None), (prof, jprof)):
        res = modeled_vs_measured(samples, pt, p)
        jres = jcal.modeled_vs_measured(jsamples, jt, jp)
        assert res["num_samples"] == jres["num_samples"]
        for side in ("constant", "fitted"):
            assert (res[side] is None) == (jres[side] is None)
            for key in (res[side] or {}):
                assert_rel(res[side][key], jres[side][key])


@pytest.mark.parametrize("direction", ["reference_to_port",
                                       "port_to_reference"])
def test_profiles_load_across_packages(tmp_path, direction):
    jt, pt = topologies(with_host=True)
    stream = seeded_stream(0, pt)
    if direction == "reference_to_port":
        saved = jcal.CalibrationFitter(jt).fit(build(stream, jtel),
                                               kernels=seeded_kernels(0))
        loaded = CalibrationProfile.load_for(pt, str(tmp_path / "p"))
        assert loaded is None                   # nothing saved yet
        path = saved.save(str(tmp_path / "p"))
        loaded = CalibrationProfile.load_for(pt, str(tmp_path / "p"))
        # and a session on that directory attaches it on init
        sess = CommSession(CommConfig(profile_dir=str(tmp_path / "p")),
                           device="cpu",
                           topology=Topology.full_mesh(4, with_host=True,
                                                       name="m4"))
        assert (sess.topology.calibration.to_payload()
                == saved.to_payload())
    else:
        saved = CalibrationFitter(pt).fit(build(stream, ttel),
                                          kernels=seeded_kernels(0))
        path = saved.save(str(tmp_path / "p"))
        loaded = jcal.CalibrationProfile.load_for(jt, str(tmp_path / "p"))
    assert os.path.basename(path) == f"profile-{pt.digest()}.json"
    assert loaded is not None
    assert loaded.to_payload() == saved.to_payload()
    assert loaded.launch is not None and loaded.kernel_cost_ns


def plan_key(plan) -> tuple:
    """Structural identity of a plan from either package."""
    return (plan.src, plan.dst, plan.nbytes, plan.topology_name, tuple(
        (pa.route.src, pa.route.dst, pa.route.via,
         tuple((h.src, h.dst, h.kind, h.bandwidth_gbps)
               for h in pa.route.hops),
         pa.route.bottleneck_gbps, pa.offset, pa.nbytes, pa.num_chunks,
         pa.granularity)
        for pa in plan.paths))


def attach(kind: str, jt, pt) -> None:
    """Attach one profile (as each package's object) to both topologies:
    the reference test's skewed profile, or one fitted from a seeded
    stream."""
    if kind == "skewed":
        jprof = _skewed_profile(jt, cls=jcal.CalibrationProfile,
                                model=jpl.DEFAULT_LAUNCH_MODEL)
    else:
        jprof = jcal.CalibrationFitter(jt, min_samples=2).fit(
            build(seeded_stream(1, pt), jtel), kernels=seeded_kernels(1))
    prof = CalibrationProfile.from_payload(jprof.to_payload())
    jt.set_calibration(jprof)
    pt.set_calibration(prof)


@pytest.mark.parametrize("kind", ["none", "skewed", "fitted"])
def test_plans_digests_and_auto_equal_under_one_profile(kind):
    jt, pt = topologies(with_host=False)
    if kind != "none":
        attach(kind, jt, pt)
    jplanner = JPathPlanner(jt, multipath_threshold=256)
    planner = PathPlanner(pt, multipath_threshold=256)
    jauto, auto = jmake_schedule("auto", jt), make_schedule("auto", pt)
    picks = set()
    for nbytes in (64 * 1024, MiB, 8 * MiB + 12_288, 64 * MiB):
        for max_paths in (1, 2, 3, None):
            for chunks in (None, 4):
                kw = dict(max_paths=max_paths, num_chunks=chunks,
                          granularity=4)
                jplan = jplanner.plan(0, 1, nbytes, **kw)
                plan = planner.plan(0, 1, nbytes, **kw)
                assert plan_key(plan) == plan_key(jplan)
                assert (estimate_transfer_time_s(plan, pt)
                        == jpl.estimate_transfer_time_s(jplan, jt))
                graph, jgraph = lower(plan), jlower(jplan)
                assert graph.digest() == jgraph.digest()
                name, sched, scores = auto.select(graph)
                jname, jsched, jscores = jauto.select(jgraph)
                assert (name, scores) == (jname, jscores)
                assert sched.digest() == jsched.digest()
                picks.add(name)
    # the reference's arbitration flip, in both packages
    kw = dict(max_paths=3, num_chunks=4, granularity=4)
    flip = {"none": "critical_path", "skewed": "round_robin"}.get(kind)
    plan = planner.plan(0, 1, 8 * MiB + 12_288, **kw)
    jplan = jplanner.plan(0, 1, 8 * MiB + 12_288, **kw)
    assert (auto.select(lower(plan))[0]
            == jauto.select(jlower(jplan))[0])
    if flip is not None:
        assert auto.select(lower(plan))[0] == flip
    assert (dataclasses.asdict(tpl.launch_model_for(pt))
            == dataclasses.asdict(jpl.launch_model_for(jt)))
