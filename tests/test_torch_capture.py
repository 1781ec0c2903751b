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
"""

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
