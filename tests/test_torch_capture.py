"""The port's whole-iteration capture against the reference capture.

The same steps are recorded on both packages: the captured Jacobi
iteration, the multipath build of the reference's capture tests, a
captured ring all-reduce (``captured_psum``) and ``captured_ring_allgather``.
Their lowered and scheduled graphs must digest equal under every
scheduler, ``overlap`` included. On the CPU the port's resident
``StepProgram`` runs the walk eagerly with the plain versions: the
captured Jacobi step must be bit-equal to the reference captured step
(the same adds in the same order) and to the port's eager ``jacobi_step``;
copies move bits and are held equal. One call is one dispatch, repeats
are fast-path hits, and two schedules never cross-serve.

``captured_multipath_dma`` is recorded on both packages (its graph
digests equal under every scheduler) and its captured step held bit for
bit to the eager composition. The §2.2 overlap contract runs on a seeded
sweep of the reference's mixed-graph generator: ``check_pass``, a
lane-model makespan no worse than ``round_robin``'s, and digests equal to
the reference's.
"""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import CommConfig as JCommConfig
from repro.comm import CommSession as JCommSession
from repro.comm import StepCapture as JStepCapture
from repro.comm import captured_psum as jcaptured_psum
from repro.comm.capture import lower_step as jlower_step
from repro.comm.passes import apply_schedule as japply_schedule
from repro.core import halo as jhalo
from repro.kernels.ring_allgather.ops import (
    captured_ring_allgather as jcaptured_ring_allgather)

from repro_torch.comm import (CommConfig, CommSession, StepCapture,
                              StepProgram, captured_psum, lower_step)
from repro_torch.comm.config import SCHEDULE_NAMES
from repro_torch.comm.passes import apply_schedule, reindex
from repro_torch.core import halo
from repro_torch.core.topology import Topology
from repro_torch.kernels.multipath_dma.kernel import (build_node_table,
                                                      run_node_table_plain)
from repro_torch.kernels.ring_allgather.ops import captured_ring_allgather

N = 8


def sessions(dev_mesh, threshold=None):
    """(reference session on the 8-device mesh, port session on the CPU
    with the matching 8-device topology)."""
    jcfg = JCommConfig() if threshold is None else JCommConfig(
        multipath_threshold=threshold)
    cfg = CommConfig() if threshold is None else CommConfig(
        multipath_threshold=threshold)
    return (JCommSession(jcfg, mesh=dev_mesh),
            CommSession(cfg, device="cpu",
                        topology=Topology.full_mesh(N, with_host=True)))


# -- the recordings, once per package -----------------------------------------

def jacobi_records(jsess, sess):
    return (jhalo.make_captured_jacobi_step(jsess, 8, 12, max_paths=2,
                                            num_chunks=2).capture,
            halo.make_captured_jacobi_step(sess, 8, 12, max_paths=2,
                                           num_chunks=2).capture)


def _jmultipath_build(cap):
    x = cap.input((1 << 20,), jnp.float32)
    y = cap.kernel(lambda v: v * 2.0, x, name="double")
    (r,) = cap.exchange([(y, 0, 1)], max_paths=2, num_chunks=4)
    return cap.kernel(lambda v: v + 1.0, r, name="inc")


def _multipath_build(cap):
    x = cap.input((1 << 20,), torch.float32)
    y = cap.kernel(lambda v: v * 2.0, x, name="double")
    (r,) = cap.exchange([(y, 0, 1)], max_paths=2, num_chunks=4)
    return cap.kernel(lambda v: v + 1.0, r, name="inc")


def multipath_records(jsess, sess):
    return (jsess.capture(_jmultipath_build).capture,
            sess.capture(_multipath_build).capture)


def psum_records(jsess, sess):
    def jbuild(cap):
        return jcaptured_psum(cap, cap.input((16,), jnp.float32), N,
                              num_chunks=2, name="ps")

    def build(cap):
        return captured_psum(cap, cap.input((16,), torch.float32), N,
                             num_chunks=2, name="ps")
    return jsess.capture(jbuild).capture, sess.capture(build).capture


def allgather_records(jsess, sess):
    def jbuild(cap):
        return jcaptured_ring_allgather(cap, cap.input((2, 4), jnp.float32),
                                        N)

    def build(cap):
        return captured_ring_allgather(cap, cap.input((2, 4), torch.float32),
                                       N)
    return jsess.capture(jbuild).capture, sess.capture(build).capture


RECORDS = {"jacobi": jacobi_records, "multipath": multipath_records,
           "psum": psum_records, "ring_allgather": allgather_records}


@pytest.mark.parametrize("threshold", [None, 64])
@pytest.mark.parametrize("record", sorted(RECORDS))
def test_lowered_and_scheduled_digests_equal_reference(dev_mesh, record,
                                                       threshold):
    jsess, sess = sessions(dev_mesh, threshold)
    jcap, cap = RECORDS[record](jsess, sess)
    assert cap.signature() == jcap.signature()
    jgraph, _ = jlower_step(jcap, jsess.engine.plan_group_for,
                            jsess.topology.name)
    graph, _ = lower_step(cap, sess.engine.plan_group_for,
                          sess.topology.name)
    assert graph.digest() == jgraph.digest()
    for sched in SCHEDULE_NAMES:
        jsched, jchosen = japply_schedule(jgraph, sched, jsess.topology)
        ours, chosen = apply_schedule(graph, sched, sess.topology)
        assert (ours.digest(), chosen) == (jsched.digest(), jchosen), sched


# -- numerics ----------------------------------------------------------------

@pytest.mark.parametrize("threshold,max_paths,num_chunks,schedule", [
    (None, None, None, None), (64, 3, 2, "overlap")])
def test_captured_jacobi_bitwise_reference_and_eager(dev_mesh, threshold,
                                                     max_paths, num_chunks,
                                                     schedule):
    jsess, sess = sessions(dev_mesh, threshold)
    u = np.random.default_rng(0).random((N, 8, 12), dtype=np.float32)
    kw = dict(max_paths=max_paths, num_chunks=num_chunks,
              schedule=schedule)
    (want,) = jhalo.make_captured_jacobi_step(jsess, 8, 12, **kw)(u)
    step = halo.make_captured_jacobi_step(sess, 8, 12, **kw)
    (got,) = step(torch.from_numpy(u))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    eager = halo.jacobi_step(torch.from_numpy(u), session=sess)
    assert torch.equal(got, eager)
    walk = step.resolve().compiled.program.walk
    assert [type(w).__name__ for w in walk] == [
        "ComputeNode", "CopyRun", "ComputeNode"]


def test_one_dispatch_per_call_and_fast_path_hits():
    sess = CommSession(device="cpu")
    n = sess.num_devices
    u = torch.from_numpy(np.random.default_rng(1).random(
        (n, 4, 8), dtype=np.float32))
    step = halo.make_captured_jacobi_step(sess, 4, 8)
    (out,) = step(u)
    assert sess.stats()["dispatches"] == 1
    (out2,) = step(out)
    assert sess.stats()["dispatches"] == 2
    assert sess.stats()["fastpath"]["hits"] >= 1
    assert torch.equal(out2, halo.jacobi_step(out, session=None))
    g = sess.stats()["graph"]
    assert g["compute_nodes_compiled"] == 2   # halo_slices + jacobi_sweep
    assert (g["nodes_compiled"]
            == g["copy_nodes_compiled"] + g["compute_nodes_compiled"])


def test_schedules_digest_apart_never_cross_serve():
    sess = CommSession(device="cpu")
    s_rr = sess.capture(_multipath_build, schedule="round_robin")
    s_df = sess.capture(_multipath_build, schedule="depth_first")
    e_rr, e_df = s_rr.resolve(), s_df.resolve()
    assert e_rr.graph.num_copy_nodes > 4   # genuinely multipath
    assert e_rr.digest != e_df.digest
    assert e_rr.key != e_df.key
    assert sess.stats()["cache"]["size"] == 2
    assert s_rr.resolve().compiled is e_rr.compiled
    assert s_df.resolve().compiled is e_df.compiled


def test_cross_schedule_numerics_and_one_dispatch_each():
    def build(cap):
        x = cap.input((4096,), torch.float32)
        y = cap.kernel(lambda v: v * 3.0, x, name="triple")
        (r,) = cap.exchange([(y, 0, 1)], num_chunks=2)
        return cap.kernel(lambda v: v - 1.0, r, name="dec")

    sess = CommSession(CommConfig(multipath_threshold=64), device="cpu")
    n = sess.num_devices
    x = torch.from_numpy(np.random.default_rng(3).random(
        (n, 4096), dtype=np.float32))
    for sched in ("round_robin", "depth_first", "critical_path", "overlap"):
        before = sess.stats()["dispatches"]
        (out,) = sess.capture(build, schedule=sched)(x)
        assert sess.stats()["dispatches"] == before + 1
        assert torch.equal(out[1], x[0] * 3.0 - 1.0)  # payload of device 0
        assert torch.equal(out[0], torch.full((4096,), -1.0))  # zeros - 1


def test_captured_psum_matches_sum():
    sess = CommSession(device="cpu")
    n = sess.num_devices
    x = torch.arange(n * 16, dtype=torch.float32).reshape(n, 16) + 1.0

    def build(cap):
        return captured_psum(cap, cap.input((16,), torch.float32), n,
                             name="ps")

    (out,) = sess.capture(build)(x)
    assert sess.stats()["dispatches"] == 1
    for d in range(n):
        assert torch.equal(out[d], x.sum(dim=0))


def test_captured_ring_allgather_then_compute_equals_eager():
    sess = CommSession(device="cpu")
    n = sess.num_devices
    xs = torch.randn(n, 3, 5)

    def build(cap):
        g = captured_ring_allgather(cap, cap.input((3, 5), torch.float32), n)
        return cap.kernel(lambda t: t * 2.0 + 1.0, g, name="affine")

    (out,) = sess.capture(build)(xs)
    gathered = xs.reshape(1, n * 3, 5).expand(n, -1, -1)
    assert torch.equal(out, gathered * 2.0 + 1.0)


def test_replicated_input_and_shape_errors():
    sess = CommSession(device="cpu")
    n = sess.num_devices

    def build(cap):
        w = cap.input((6,), torch.float32, replicated=True)
        return cap.kernel(lambda v: v + 1.0, w, name="inc")

    step = sess.capture(build)
    (out,) = step(torch.arange(6.0))
    assert torch.equal(out, (torch.arange(6.0) + 1.0).expand(n, 6))
    with pytest.raises(ValueError, match="shape"):
        step(torch.zeros(n, 6))
    with pytest.raises(ValueError, match="input tensors"):
        step()


def test_fault_state_raises_naming_the_health_slice():
    """A captured step whose exchange rides (0, 1) is re-resolved over
    the surviving routes when (0, 1) fails, and delivers bitwise."""
    sess = CommSession(device="cpu")
    step = sess.capture(_multipath_build)
    sess.topology.fail_link(0, 1)
    xs = torch.randn(sess.num_devices, 1 << 20,
                     generator=torch.Generator().manual_seed(0))
    (out,) = step(xs)
    want = torch.ones_like(xs)             # the exchange zeroes other rows
    want[1] = xs[0] * 2.0 + 1.0
    assert torch.equal(out, want)
    assert sess.stats()["health"]["ladder_level"] == 1
    for plan in step.resolve().plans:
        assert (0, 1) not in plan.directional_links()


# -- capture-surface contracts ------------------------------------------------

def _contract_sequence(cap_cls, dtype, arange):
    """The reference's contract sequence on one capture class; returns the
    exception type of every step (None where it passes)."""
    cap = cap_cls()
    x = cap.input((8,), dtype)
    out = []

    def attempt(fn):
        try:
            res = fn()
        except (ValueError, TypeError) as exc:
            out.append((type(exc).__name__, str(exc).split(" ")[0]))
            return None
        out.append(None)
        return res

    attempt(lambda: cap.kernel(lambda v: v, x))                 # anonymous
    y = attempt(lambda: cap.kernel(lambda v: v * 2, x, name="k"))
    attempt(lambda: cap.kernel(lambda v: v * 3, x, name="k"))   # name reuse
    m = attempt(lambda: cap.kernel(arange, x, name="mat"))
    attempt(lambda: cap.exchange([(m, 0, 1)]))                  # 2-D
    attempt(lambda: cap.exchange([(y, 1, 1)]))                  # self-send
    (r,) = attempt(lambda: cap.exchange([(y, 0, 1)]))
    attempt(lambda: cap.exchange([(r, 1, 2)]))                  # reception
    attempt(lambda: cap.exchange([]))                           # empty
    attempt(lambda: cap.kernel(lambda v: v, x.__class__(99), name="z"))
    attempt(lambda: cap.kernel(lambda v: v, 3, name="z2"))
    hash(cap.signature())
    return out


def test_contract_errors_where_the_reference_raises():
    ours = _contract_sequence(
        StepCapture, torch.float32, lambda v: v.reshape(v.shape[0], 2, 4))
    ref = _contract_sequence(JStepCapture, jnp.float32,
                             lambda v: v.reshape(2, 4))
    assert ours == ref
    assert ours.count(None) == 3


def test_result_specs_from_meta_tensors():
    cap = StepCapture(4)
    x = cap.input((6, 2), torch.float32)
    a, b = cap.kernel(lambda v: (v[:, :, 0], v.to(torch.bfloat16)), x,
                      name="split")
    assert cap.buffers[a.buf_id].shape == (6,)
    assert cap.buffers[b.buf_id].dtype == "bfloat16"
    with pytest.raises(ValueError, match="stacked"):
        cap.kernel(lambda v: v.sum(), x, name="scalar")
    with pytest.raises(ValueError, match="out="):
        cap.kernel(lambda v: halo.jacobi_ops.jacobi_sweep(v), x,
                   name="sweep")


def test_lower_step_heterogeneous_graph():
    sess = CommSession(device="cpu")
    cap = StepCapture(sess.num_devices)
    x = cap.input((1024,), torch.float32)
    y = cap.kernel(lambda v: v + 1, x, name="inc")
    (r,) = cap.exchange([(y, 0, 1)], num_chunks=2)
    cap.kernel(lambda v: v * 2, r, name="dbl")
    graph, plans = lower_step(cap, sess.engine.plan_group_for,
                              sess.topology.name)
    assert graph.num_compute_nodes == 2
    assert graph.num_copy_nodes == sum(
        len(pa.chunk_bounds()) * pa.route.num_hops
        for p in plans for pa in p.paths)
    kinds = [type(n).__name__ for n in graph.nodes]
    assert kinds[0] == "ComputeNode" and kinds[-1] == "ComputeNode"
    assert graph.messages == ((1, 2),)


# -- the executor ------------------------------------------------------------

def _staged_step():
    """A step whose exchange has 2-hop chains, plus a compute node that
    depends on nothing the exchange touches."""
    sess = CommSession(CommConfig(multipath_threshold=64), device="cpu")
    cap = StepCapture(sess.num_devices)
    x = cap.input((1 << 20,), torch.float32)
    z = cap.input((5,), torch.float32)
    y = cap.kernel(lambda v: v * 2.0, x, name="double")
    (r,) = cap.exchange([(y, 0, 1)], max_paths=3, num_chunks=2)
    w = cap.kernel(lambda v: v - 1.0, z, name="side")
    out = cap.kernel(lambda v: v + 1.0, r, name="inc")
    graph, _ = lower_step(cap, sess.engine.plan_group_for,
                          sess.topology.name)
    return sess, cap, graph, (out.buf_id, w.buf_id)


def test_hop_across_copy_runs_reads_the_shared_slot():
    """Moving an independent compute node between a hop-1 and its hop-2
    splits the copies into two multipath_dma runs; the hop-2 reads its
    slot in the staging buffer both runs share, and the result is the
    same as the unsplit walk's."""
    sess, cap, graph, outputs = _staged_step()
    n = sess.num_devices
    chain = next(e for e in graph.edges if e.kind == "hop")
    side = next(i for i, nd in enumerate(graph.nodes)
                if getattr(nd, "kernel", None) == "side")
    order = [i for i in range(graph.num_nodes) if i != side]
    order.insert(order.index(chain.dst), side)
    split = reindex(graph, order)
    x = torch.randn(n, 1 << 20)
    z = torch.randn(n, 5)
    results = []
    for g in (graph, split):
        prog = StepProgram(g, cap, outputs, n, "cpu")
        for buf, v in zip(prog.inputs(), (x, z)):
            buf.copy_(v)
        prog.replay()
        results.append([o.clone() for o in prog.outputs()])
        runs = prog.copy_runs
        assert sum(r.table.num_copy_nodes for r in runs) == g.num_copy_nodes
    assert len(StepProgram(split, cap, outputs, n, "cpu").copy_runs) == 2
    for a, b in zip(*results):
        assert torch.equal(a, b)
    expect = torch.zeros(n, 1 << 20)
    expect[1] = x[0] * 2.0
    assert torch.equal(results[1][0], expect + 1.0)
    assert torch.equal(results[1][1], z - 1.0)


@pytest.mark.parametrize("cut", [1, 3, 5])
def test_node_table_runs_compose_to_the_whole_table(cut):
    """Tables of consecutive runs with one shared slot map and staging
    buffer, executed in order, write what the one-table send writes."""
    from repro_torch.comm import PathPlanner, lower
    topo = Topology.full_mesh(4)
    plan = PathPlanner(topo, multipath_threshold=0).plan(
        0, 1, 4 * 1001, granularity=4, max_paths=3, num_chunks=3,
        include_host=False)
    graph = lower(plan)
    whole = build_node_table(graph, [1001], [4], 4)
    x = torch.randn(whole.io_bytes // 4).view(torch.uint8)
    y_whole = torch.zeros(whole.io_bytes, dtype=torch.uint8)
    run_node_table_plain(whole.items, x, y_whole,
                         torch.empty(max(whole.stage_bytes, 16),
                                     dtype=torch.uint8))
    slots: dict[int, int] = {}
    first = build_node_table(graph, [1001], [4], 4, nodes=range(cut),
                             slots=slots)
    second = build_node_table(graph, [1001], [4], 4,
                              nodes=range(cut, graph.num_nodes),
                              slots=slots, stage_base=first.stage_bytes)
    assert first.num_copy_nodes + second.num_copy_nodes == graph.num_nodes
    stage = torch.empty(max(second.stage_bytes, 16), dtype=torch.uint8)
    y = torch.zeros_like(y_whole)
    done = sum(run_node_table_plain(t.items, x, y, stage)
               for t in (first, second))
    assert done == graph.num_copy_nodes
    assert torch.equal(y, y_whole)


# -- captured_multipath_dma ---------------------------------------------------

def _dma_planners(threshold=64):
    """Reference and port planners on the 4-GPU full mesh, and the
    ``plan_group_fn`` of each (the reference test's)."""
    from repro.comm import PathPlanner as JPathPlanner
    from repro.comm import TransferRequest as JRequest
    from repro.core import Topology as JTopology
    from repro_torch.comm import PathPlanner, TransferRequest

    out = []
    for planner_cls, req_cls, topo in (
            (JPathPlanner, JRequest, JTopology.full_mesh(4)),
            (PathPlanner, TransferRequest, Topology.full_mesh(4))):
        planner = planner_cls(topo, multipath_threshold=threshold)

        def plan_group_fn(specs, *, max_paths=None, num_chunks=None,
                          planner=planner, req_cls=req_cls):
            reqs = [req_cls(s, d, ne * 4, granularity=4)
                    for (s, d, ne, _) in specs]
            return planner.plan_group(reqs, max_paths=max_paths,
                                      include_host=False,
                                      num_chunks=num_chunks)
        out.append((topo, planner, plan_group_fn))
    return out


def test_captured_multipath_dma_lowers_into_mixed_graph():
    """The reference's test on the port: the DMA adopter's compute node
    coexists with ``cap.exchange`` copies in one lowered graph, the lane
    model prices its recorded duration, ``overlap`` keeps the node
    multiset; and the lowered and every scheduled digest equal the
    reference's."""
    from repro.comm.telemetry import TimelineRecorder as JRecorder
    from repro.kernels.multipath_dma.ops import (
        captured_multipath_dma as jcaptured_multipath_dma)
    from repro_torch.comm.telemetry import TimelineRecorder
    from repro_torch.core.pipelining import compute_time_s
    from repro_torch.kernels.multipath_dma.ops import captured_multipath_dma

    (jtopo, jplanner, jfn), (topo, planner, fn) = _dma_planners()
    nelems = 256
    graphs = []
    for cap, rec, adopt, pl, dt, plan_fn, name in (
            (JStepCapture(), JRecorder(enabled=True),
             jcaptured_multipath_dma, jplanner, jnp.float32, jfn, jtopo.name),
            (StepCapture(4), TimelineRecorder(enabled=True),
             captured_multipath_dma, planner, torch.float32, fn, topo.name)):
        rec.record_kernel("multipath_dma", 25_000.0)
        plan = pl.plan(0, 2, nelems * 4, max_paths=2, num_chunks=2,
                       granularity=4)
        x = cap.input((nelems,), dt)
        y = adopt(cap, x, plan, 4, telemetry=rec)
        assert cap.buffers[y.buf_id].shape == (nelems,)
        cap.exchange([(y, 0, 1)], num_chunks=2)
        graphs.append((jlower_step if cap.__class__ is JStepCapture
                       else lower_step)(cap, plan_fn, name)[0])
    jgraph, graph = graphs
    assert graph.num_compute_nodes == 1 and graph.num_copy_nodes > 0
    (node,) = [nd for nd in graph.nodes if hasattr(nd, "kernel")]
    assert node.kernel == "multipath_dma" and node.cost_ns == 25_000
    assert node.flops == 0
    assert compute_time_s(node, topo) == pytest.approx(25e-6)
    scheduled, chosen = apply_schedule(graph, "overlap", topo)
    assert chosen == "overlap"
    assert scheduled.num_nodes == graph.num_nodes
    assert sorted(map(repr, scheduled.nodes)) == \
        sorted(map(repr, graph.nodes))
    assert graph.digest() == jgraph.digest()
    for sched in SCHEDULE_NAMES:
        jsched, jchosen = japply_schedule(jgraph, sched, jtopo)
        ours, chosen = apply_schedule(graph, sched, topo)
        assert (ours.digest(), chosen) == (jsched.digest(), jchosen), sched


def test_captured_multipath_dma_without_recorder_costs_zero():
    from repro_torch.kernels.multipath_dma.ops import captured_multipath_dma

    _, (_, planner, _) = _dma_planners()
    cap = StepCapture(4)
    plan = planner.plan(0, 3, 64 * 4, granularity=4)
    y = captured_multipath_dma(cap, cap.input((64,), torch.float32), plan, 4)
    (op,) = [o for o in cap.ops if o[0] == "kernel"]
    assert op[1] == "multipath_dma" and op[4:] == (0, 0)
    assert cap.buffers[y.buf_id].dtype == "float32"
    from repro_torch.comm import PathPlanner
    host = PathPlanner(Topology.full_mesh(4, with_host=True),
                       multipath_threshold=64).plan(
        0, 1, 1 << 22, include_host=True, max_paths=16, granularity=4)
    with pytest.raises(ValueError, match="host-staged"):
        captured_multipath_dma(cap, cap.input((1 << 20,), torch.float32),
                               host, 4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("paths,chunks", [(1, 1), (2, 2), (3, 4)])
def test_captured_multipath_dma_step_equals_eager(paths, chunks, dtype):
    """``captured_multipath_dma`` → ``cap.exchange`` → a compute node, one
    dispatch a call, bit for bit as the eager composition: the plan's
    ``multipath_dma_transfer``, then ``session.send``, then the
    kernel."""
    from repro_torch.kernels.multipath_dma.ops import (
        PlanKernel, captured_multipath_dma, multipath_dma_transfer)

    sess = CommSession(CommConfig(multipath_threshold=64), device="cpu")
    n, nelems = sess.num_devices, 3000
    plan = sess.plan(0, 2, nelems * dtype.itemsize, max_paths=paths,
                     num_chunks=chunks, granularity=dtype.itemsize)

    def build(cap):
        x = cap.input((nelems,), dtype)
        y = captured_multipath_dma(cap, x, plan, n)
        (r,) = cap.exchange([(y, 2, 1)], num_chunks=2)
        return cap.kernel(lambda v: v * 2.0, r, name="dbl")

    step = sess.capture(build)
    gen = torch.Generator().manual_seed(paths * 10 + chunks)
    for _ in range(2):
        xs = torch.randn(n, nelems, generator=gen).to(dtype)
        before = sess.stats()["dispatches"]
        (out,) = step(xs)
        assert sess.stats()["dispatches"] == before + 1
        moved = multipath_dma_transfer(xs, plan)
        want = torch.zeros_like(xs)
        want[1] = sess.send(moved[2], 2, 1)
        assert torch.equal(out, want * 2.0)
    walk = step.resolve().compiled.program.walk
    kern = [w for w in walk if type(w).__name__ == "ComputeNode"
            and w.kernel == "multipath_dma"]
    assert len(kern) == 1
    fn = step.resolve().compiled.program.kernels["multipath_dma"]
    assert isinstance(fn, PlanKernel)
    with pytest.raises(ValueError, match="expected"):
        fn(torch.zeros(n, nelems + 1, dtype=dtype))


# -- the §2.2 overlap contract on seeded mixed graphs ------------------------

#: The reference's Hypothesis generator (``tests/test_passes.py``) drawn
#: from ``random.Random(seed)``: 48 cases at its 2 MiB multipath threshold,
#: 16 more at 4 KiB, where larger payloads stripe over several paths.
OVERLAP_SEEDS = range(64)


def _mixed_case(seed):
    rnd = random.Random(seed)
    depth = rnd.randint(0, 3)
    nelems = rnd.randint(8, 1 << 14)
    n_msgs = rnd.randint(1, 3)
    chunks = rnd.randint(1, 3)
    flops = rnd.randint(0, 10_000_000)
    kflops = [rnd.randrange(0, 1_000_000) for _ in range(depth)]
    pairs = []
    while len(pairs) < n_msgs:
        s, d = rnd.randrange(8), rnd.randrange(8)
        if s != d:
            pairs.append((s, d))
    threshold = 2 * (1 << 20) if seed < 48 else 4096
    return depth, nelems, chunks, flops, kflops, pairs, threshold


def _lower_mixed(cap, dtype, planner_cls, req_cls, topo, lower_fn, case):
    depth, nelems, chunks, flops, kflops, pairs, threshold = case
    planner = planner_cls(topo, multipath_threshold=threshold)

    def plan_group_fn(specs, *, max_paths=None, num_chunks=None):
        reqs = [req_cls(s, d, ne * 4, granularity=4)
                for (s, d, ne, _) in specs]
        return planner.plan_group(reqs, max_paths=max_paths,
                                  include_host=False, num_chunks=num_chunks)

    x = cap.input((nelems,), dtype)
    y = cap.kernel(lambda v: v + 1.0, x, name="k0", flops=flops)
    for i in range(depth):
        y = cap.kernel(lambda v: v * 2.0, y, name=f"k{i + 1}",
                       flops=kflops[i])
    recvs = cap.exchange([(y, s, d) for s, d in pairs], num_chunks=chunks)
    cap.kernel(lambda *rs: sum(rs), *recvs, name="sink", flops=0)
    graph, _ = lower_fn(cap, plan_group_fn, topo.name)
    return graph


@pytest.mark.parametrize("seed", OVERLAP_SEEDS)
def test_overlap_contract_on_seeded_mixed_graphs(seed):
    """``OverlapSchedule`` passes ``check_pass`` on the mixed graph, its
    lane-model makespan is never worse than ``round_robin``'s, and the
    lowered and scheduled digests equal the reference's."""
    from repro.comm import PathPlanner as JPathPlanner
    from repro.comm import TransferRequest as JRequest
    from repro.comm.passes import OverlapSchedule as JOverlapSchedule
    from repro.core import Topology as JTopology
    from repro_torch.comm import PathPlanner, TransferRequest
    from repro_torch.comm.passes import OverlapSchedule, check_pass
    from repro_torch.core.pipelining import scheduled_time_s

    case = _mixed_case(seed)
    jtopo = JTopology.full_mesh(8, with_host=False, name="mesh8")
    topo = Topology.full_mesh(8, with_host=False, name="mesh8")
    jgraph = _lower_mixed(JStepCapture(), jnp.float32, JPathPlanner,
                          JRequest, jtopo, jlower_step, case)
    graph = _lower_mixed(StepCapture(), torch.float32, PathPlanner,
                         TransferRequest, topo, lower_step, case)
    assert graph.digest() == jgraph.digest()
    out = OverlapSchedule(topo)(graph)
    check_pass(graph, out)                              # §2.2 contract
    rr, _ = apply_schedule(graph, "round_robin", topo)
    assert (scheduled_time_s(out, topo, mode="lanes")
            <= scheduled_time_s(rr, topo, mode="lanes"))
    assert out.digest() == JOverlapSchedule(jtopo)(jgraph).digest()
    jsched, jchosen = japply_schedule(jgraph, "overlap", jtopo)
    ours, chosen = apply_schedule(graph, "overlap", topo)
    assert (ours.digest(), chosen) == (jsched.digest(), jchosen)


def test_overlap_sweep_covers_the_generator():
    cases = [_mixed_case(s) for s in OVERLAP_SEEDS]
    assert {c[0] for c in cases} == {0, 1, 2, 3}
    assert {len(c[5]) for c in cases} == {1, 2, 3}
    assert {c[2] for c in cases} == {1, 2, 3}
    assert sum(c[6] == 2 * (1 << 20) for c in cases) >= 48
    assert min(c[1] for c in cases) < 1024 < 8192 < max(c[1] for c in cases)
