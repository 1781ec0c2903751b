"""Whole-iteration capture on a peer session against the stacked session
and the reference.

``CommSession(devices=["cpu"] * 4)`` records a step exactly as the stacked
session does (the same capture signature, scheduled-graph digest and
``GroupKey``) and runs it as a ``PeerStepProgram``: one arena a logical
device, each kernel function called once a device on its ``(1, *local)``
views, each run of copy nodes one per-device ``multipath_dma`` table run
by the plain version. The same seeded numpy inputs go through the
reference's capture on a mesh of 4 CPU devices, the stacked port session
and the peer session: the captured Jacobi step under every scheduler with
one and two paths, ``captured_psum``, the migrating decode step,
``captured_ring_allgather`` followed by a compute node,
``captured_multipath_dma`` and a step with a replicated input. Copies move
bits, so the peer results equal the stacked ones bit for bit (attention
at the stacked step's tolerance); the Jacobi step is within 1e-5 of the
reference's captured step. Every call is one dispatch and repeats are
fast-path hits.

A copy run's per-card tables are checked where a hop-1 tile lands in
another card's staging and its hop 2 sits in a later run: the via card's
table of the earlier run ends in a wait on that tile's landing flag, and
an emulation of the kernel's flag protocol over both runs, cards
interleaved at random with stale staging poisoned, reproduces the plain
walk's bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import CommConfig as JCommConfig
from repro.comm import CommSession as JCommSession
from repro.comm import captured_psum as jcaptured_psum
from repro.core import halo as jhalo
from repro.kernels.ring_allgather.ops import (
    captured_ring_allgather as jcaptured_ring_allgather)
from repro.serving.engine import (
    make_captured_decode_step as jmake_captured_decode_step)

from repro_torch.comm import (CommConfig, CommSession, StepCapture,
                              StepProgram, TransferPlanCache, captured_psum,
                              lower_step)
from repro_torch.comm.capture import PeerStepProgram, axis_index
from repro_torch.comm.config import SCHEDULE_NAMES
from repro_torch.comm.engine import PlacedKey
from repro_torch.comm.passes import reindex
from repro_torch.core import halo
from repro_torch.kernels.multipath_dma import kernel as dk
from repro_torch.kernels.ring_allgather.ops import captured_ring_allgather
from repro_torch.serving.engine import make_captured_decode_step

N = 4
CPU4 = ["cpu"] * N


@pytest.fixture(scope="module")
def jmesh4():
    return jax.sharding.Mesh(np.array(jax.devices()[:N]), ("dev",))


def sessions(jmesh, threshold=None):
    """(reference session on the 4-device mesh, stacked port session,
    peer port session), all on the 4-device full mesh."""
    jcfg = JCommConfig() if threshold is None else JCommConfig(
        multipath_threshold=threshold)
    cfg = CommConfig() if threshold is None else CommConfig(
        multipath_threshold=threshold)
    return (JCommSession(jcfg, mesh=jmesh), CommSession(cfg, device="cpu"),
            CommSession(cfg, devices=CPU4))


def same_resolution(stacked_step, peer_step):
    """The peer step resolves to the stacked step's scheduled graph and
    key; only its program is placed on the peer devices."""
    a, b = stacked_step.resolve(), peer_step.resolve()
    assert (b.digest, b.key, b.schedule) == (a.digest, a.key, a.schedule)
    assert b.graph.digest() == a.graph.digest()
    assert isinstance(b.compiled.program, PeerStepProgram)
    assert isinstance(b.compiled.key, PlacedKey)
    assert b.compiled.key.key == a.key
    return a, b


def rows(t: torch.Tensor) -> list[torch.Tensor]:
    return [r.clone() for r in t.unbind(0)]


def assert_rows_equal(peer: list, stacked: torch.Tensor) -> None:
    assert len(peer) == stacked.shape[0]
    for d, (p, s) in enumerate(zip(peer, stacked.unbind(0))):
        assert p.device == torch.device("cpu")
        assert torch.equal(p, s), f"device {d}"


def one_dispatch_each(sess, step, *args, calls=2):
    """Call ``step`` ``calls`` times, feeding each call's outputs back
    where they are the inputs' shapes; every call one dispatch, later
    calls fast-path hits. Returns the last outputs."""
    outs = None
    for i in range(calls):
        before = sess.stats()
        outs = step(*args)
        after = sess.stats()
        assert after["dispatches"] == before["dispatches"] + 1
        if i:
            assert (after["fastpath"]["hits"]
                    == before["fastpath"]["hits"] + 1)
    return outs


# -- the captured Jacobi step -------------------------------------------------

@pytest.mark.parametrize("max_paths", [1, 2])
@pytest.mark.parametrize("schedule", SCHEDULE_NAMES)
def test_captured_jacobi_on_peers_bitwise_stacked_and_reference(
        jmesh4, schedule, max_paths):
    jsess, stacked, peer = sessions(jmesh4, threshold=64)
    u = np.random.default_rng(7).random((N, 8, 12), dtype=np.float32)
    kw = dict(schedule=schedule, max_paths=max_paths, num_chunks=2)
    (want,) = jhalo.make_captured_jacobi_step(jsess, 8, 12, **kw)(u)
    sstep = halo.make_captured_jacobi_step(stacked, 8, 12, **kw)
    pstep = halo.make_captured_jacobi_step(peer, 8, 12, **kw)
    (s_out,) = sstep(torch.from_numpy(u))
    (p_out,) = one_dispatch_each(peer, pstep, rows(torch.from_numpy(u)))
    assert_rows_equal(p_out, s_out)
    np.testing.assert_allclose(torch.stack(p_out).numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    eager = halo.jacobi_step(rows(torch.from_numpy(u)), session=peer)
    assert all(torch.equal(a, b) for a, b in zip(p_out, eager))
    # a second iteration from the first one's per-device result
    (p2,) = pstep(p_out)
    (s2,) = sstep(s_out)
    assert_rows_equal(p2, s2)
    a, b = same_resolution(sstep, pstep)
    assert b.digest == jsess.engine.resolve_step(
        jhalo.make_captured_jacobi_step(jsess, 8, 12, **kw),
        schedule).digest
    prog = b.compiled.program
    assert [type(w).__name__ for w in prog.walk] == [
        type(w).__name__.replace("CopyRun", "PeerCopyRun")
        for w in a.compiled.program.walk]
    assert sum(r.table.num_copy_nodes for r in prog.copy_runs) \
        == b.graph.num_copy_nodes


def test_captured_jacobi_on_peers_takes_and_returns_lists():
    peer = CommSession(devices=CPU4)
    step = halo.make_captured_jacobi_step(peer, 4, 6)
    u = rows(torch.rand(N, 4, 6, generator=torch.Generator().manual_seed(3)))
    (out,) = step(u)
    assert isinstance(out, list) and len(out) == N
    assert all(o.shape == (4, 6) for o in out)
    with pytest.raises(ValueError, match="list of 4 tensors"):
        step(torch.stack(u))
    with pytest.raises(ValueError, match="list of 4 tensors"):
        step(u[:3])
    with pytest.raises(ValueError, match="list of 4 tensors"):
        step([torch.zeros(4, 7)] * N)
    assert peer.stats()["dispatches"] == 1


# -- captured_psum --------------------------------------------------------------

@pytest.mark.parametrize("num_chunks", [None, 2])
def test_captured_psum_on_peers(jmesh4, num_chunks):
    jsess, stacked, peer = sessions(jmesh4)
    x = np.random.default_rng(11).standard_normal((N, 40)).astype(np.float32)

    def jbuild(cap):
        return jcaptured_psum(cap, cap.input((40,), jnp.float32), N,
                              num_chunks=num_chunks, name="ps")

    def build(cap):
        return captured_psum(cap, cap.input((40,), torch.float32), N,
                             num_chunks=num_chunks, name="ps")

    (want,) = jsess.capture(jbuild)(x)
    sstep, pstep = stacked.capture(build), peer.capture(build)
    (s_out,) = sstep(torch.from_numpy(x))
    (p_out,) = one_dispatch_each(peer, pstep, rows(torch.from_numpy(x)))
    assert_rows_equal(p_out, s_out)
    np.testing.assert_array_equal(torch.stack(p_out).numpy(),
                                  np.asarray(want))
    same_resolution(sstep, pstep)


# -- the migrating decode step -------------------------------------------------

DECODE = dict(batch=1, heads=2, kv_len=16, head_dim=8, kv_chunk=4096,
              src=0, dst=2)


@pytest.mark.parametrize("schedule", ["overlap", "auto", "round_robin"])
def test_migrating_decode_step_on_peers(jmesh4, schedule):
    jsess, stacked, peer = sessions(jmesh4)
    rng = np.random.default_rng(5)
    shp = (N, 1, 2, 16, 8)
    q, k, v = (rng.random(shp).astype(np.float32) for _ in range(3))
    kv = rng.random((N, 4096)).astype(np.float32)
    jattn, jnew = jmake_captured_decode_step(jsess, schedule=schedule,
                                             **DECODE)(q, k, v, kv)
    sstep = make_captured_decode_step(stacked, schedule=schedule, **DECODE)
    pstep = make_captured_decode_step(peer, schedule=schedule, **DECODE)
    args = [torch.from_numpy(a) for a in (q, k, v, kv)]
    s_attn, s_kv = sstep(*args)
    p_attn, p_kv = one_dispatch_each(peer, pstep,
                                     *[rows(a) for a in args])
    np.testing.assert_allclose(torch.stack(p_attn).numpy(), s_attn.numpy(),
                               atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(torch.stack(p_attn).numpy(),
                               np.asarray(jattn), atol=2e-5, rtol=2e-5)
    assert_rows_equal(p_kv, s_kv)
    expect = kv.copy()
    expect[2] = kv[0]
    np.testing.assert_array_equal(torch.stack(p_kv).numpy(), expect)
    np.testing.assert_array_equal(torch.stack(p_kv).numpy(),
                                  np.asarray(jnew))
    a, _ = same_resolution(sstep, pstep)
    assert a.digest == jsess.engine.resolve_step(
        jmake_captured_decode_step(jsess, schedule=schedule, **DECODE),
        schedule).digest


# -- the collective kernel nodes -------------------------------------------------

def test_captured_ring_allgather_then_compute_on_peers(jmesh4):
    jsess, stacked, peer = sessions(jmesh4)
    xs = np.random.default_rng(13).standard_normal((N, 3, 5)).astype(
        np.float32)

    def jbuild(cap):
        g = jcaptured_ring_allgather(cap, cap.input((3, 5), jnp.float32), N)
        return cap.kernel(lambda t: t * 2.0 + 1.0, g, name="affine")

    def build(cap):
        g = captured_ring_allgather(cap, cap.input((3, 5), torch.float32), N)
        return cap.kernel(lambda t: t * 2.0 + 1.0, g, name="affine")

    sstep, pstep = stacked.capture(build), peer.capture(build)
    (s_out,) = sstep(torch.from_numpy(xs))
    (p_out,) = one_dispatch_each(peer, pstep, rows(torch.from_numpy(xs)))
    assert_rows_equal(p_out, s_out)
    want = torch.from_numpy(xs).reshape(N * 3, 5) * 2.0 + 1.0
    assert all(torch.equal(o, want) for o in p_out)
    _, b = same_resolution(sstep, pstep)
    assert b.digest == jsess.capture(jbuild).resolve().digest
    kinds = [type(w).__name__ for w in b.compiled.program.walk]
    assert kinds == ["PeerNode", "ComputeNode"]


@pytest.mark.parametrize("paths,chunks", [(1, 1), (2, 2), (3, 4)])
def test_captured_multipath_dma_on_peers(jmesh4, paths, chunks):
    from repro.kernels.multipath_dma.ops import (
        captured_multipath_dma as jcaptured_multipath_dma)
    from repro_torch.kernels.multipath_dma.ops import (
        captured_multipath_dma, multipath_dma_transfer)

    jsess, stacked, peer = sessions(jmesh4, threshold=64)
    nelems = 3000
    plan = stacked.plan(0, 2, nelems * 4, max_paths=paths,
                        num_chunks=chunks, granularity=4)
    jplan = jsess.plan(0, 2, nelems * 4, max_paths=paths, num_chunks=chunks,
                       granularity=4)

    def jbuild(cap):
        y = jcaptured_multipath_dma(cap, cap.input((nelems,), jnp.float32),
                                    jplan, N)
        (r,) = cap.exchange([(y, 2, 1)], num_chunks=2)
        return cap.kernel(lambda v: v * 2.0, r, name="dbl")

    def build(cap):
        y = captured_multipath_dma(cap, cap.input((nelems,), torch.float32),
                                   plan, N)
        (r,) = cap.exchange([(y, 2, 1)], num_chunks=2)
        return cap.kernel(lambda v: v * 2.0, r, name="dbl")

    sstep, pstep = stacked.capture(build), peer.capture(build)
    gen = torch.Generator().manual_seed(paths * 10 + chunks)
    for _ in range(2):
        xs = torch.randn(N, nelems, generator=gen)
        (s_out,) = sstep(xs)
        (p_out,) = one_dispatch_each(peer, pstep, rows(xs), calls=1)
        assert_rows_equal(p_out, s_out)
        want = torch.zeros_like(xs)
        want[1] = multipath_dma_transfer(xs, plan)[2] * 2.0
        assert torch.equal(torch.stack(p_out), want)
    _, b = same_resolution(sstep, pstep)
    assert b.digest == jsess.capture(jbuild).resolve().digest
    (node,) = [w for w in b.compiled.program.walk
               if type(w).__name__ == "PeerNode"]
    assert node.node.kernel == "multipath_dma"
    assert isinstance(node.program, dk.PeerDmaProgram)
    assert node.program.table.num_copy_nodes == sum(
        pa.num_chunks * pa.route.num_hops for pa in plan.paths)


# -- inputs, keys, axis_index ---------------------------------------------------

def test_replicated_input_on_peers():
    stacked = CommSession(device="cpu")
    peer = CommSession(devices=CPU4)

    def build(cap):
        w = cap.input((6,), torch.float32, replicated=True)
        x = cap.input((6,), torch.float32)
        return cap.kernel(lambda a, b: a * b + 1.0, w, x, name="axpy")

    w = torch.arange(6.0)
    x = torch.randn(N, 6, generator=torch.Generator().manual_seed(2))
    (s_out,) = stacked.capture(build)(w, x)
    pstep = peer.capture(build)
    (p_out,) = one_dispatch_each(peer, pstep, w, rows(x))
    assert_rows_equal(p_out, s_out)
    with pytest.raises(ValueError, match="replicated"):
        pstep(torch.zeros(N, 6), rows(x))
    with pytest.raises(ValueError, match="input tensors"):
        pstep(w)
    same_resolution(stacked.capture(build), pstep)


def test_a_shared_cache_never_cross_serves_stacked_and_peer_steps():
    cache = TransferPlanCache()
    stacked = CommSession(device="cpu", cache=cache)
    peer = CommSession(devices=CPU4, cache=cache)
    u = torch.rand(N, 4, 6, generator=torch.Generator().manual_seed(9))
    sstep = halo.make_captured_jacobi_step(stacked, 4, 6)
    pstep = halo.make_captured_jacobi_step(peer, 4, 6)
    (s_out,) = sstep(u)
    (p_out,) = pstep(rows(u))
    assert_rows_equal(p_out, s_out)
    assert len(cache) == 2
    a, b = sstep.resolve(), pstep.resolve()
    assert a.key == b.key
    assert a.compiled is not b.compiled
    assert isinstance(a.compiled.program, StepProgram)
    assert b.compiled.key == PlacedKey(a.key, ("cpu",) * N)


def test_axis_index_on_both_programs():
    def build(cap):
        x = cap.input((3,), torch.float32)
        return cap.kernel(lambda v: v + axis_index(v).to(v.dtype)[:, None],
                          x, name="plus_rank")

    x = torch.zeros(N, 3)
    (s_out,) = CommSession(device="cpu").capture(build)(x)
    (p_out,) = CommSession(devices=CPU4).capture(build)(rows(x))
    want = torch.arange(N, dtype=torch.float32)[:, None].expand(N, 3)
    assert torch.equal(s_out, want)
    assert_rows_equal(p_out, want)
    meta = torch.empty(N, 3, device="meta")
    assert axis_index(meta).shape == (N,)
    assert axis_index(meta).device.type == "meta"
    assert torch.equal(axis_index(torch.zeros(5, 2)), torch.arange(5))
    # the peer program's resident index tensors, one a logical device
    prog = CommSession(devices=CPU4).capture(build).resolve().compiled.program
    assert [t.tolist() for t in prog._index] == [[d] for d in range(N)]


# -- a hop-1 tile landing on another card for a hop 2 of a later run -----------

def split_step():
    """A step whose single message has 2-hop chains, and an independent
    compute node moved between a hop-1 copy and its hop-2 copy, so the
    two hops fall in different runs. Returns (capture, split graph,
    outputs, the hop-1 node index, the hop-2 node index)."""
    sess = CommSession(CommConfig(multipath_threshold=64), devices=CPU4)
    cap = StepCapture(N)
    x = cap.input((1 << 20,), torch.float32)
    z = cap.input((5,), torch.float32)
    y = cap.kernel(lambda v: v * 2.0, x, name="double")
    (r,) = cap.exchange([(y, 0, 1)], max_paths=3, num_chunks=2)
    w = cap.kernel(lambda v: v - 1.0, z, name="side")
    out = cap.kernel(lambda v: v + 1.0, r, name="inc")
    graph, _ = lower_step(cap, sess.engine.plan_group_for,
                          sess.topology.name)
    chain = next(e for e in graph.edges if e.kind == "hop")
    side = next(i for i, nd in enumerate(graph.nodes)
                if getattr(nd, "kernel", None) == "side")
    order = [i for i in range(graph.num_nodes) if i != side]
    order.insert(order.index(chain.dst), side)
    split = reindex(graph, order)
    hop2 = order.index(chain.dst)
    return cap, split, (out.buf_id, w.buf_id), order.index(chain.src), hop2


def test_peer_step_split_across_runs_equals_stacked():
    cap, split, outputs, _, _ = split_step()
    x = torch.randn(N, 1 << 20, generator=torch.Generator().manual_seed(4))
    z = torch.randn(N, 5, generator=torch.Generator().manual_seed(5))
    stacked = StepProgram(split, cap, outputs, N, "cpu")
    peer = PeerStepProgram(split, cap, outputs, CPU4)
    assert len(peer.copy_runs) == 2
    for buf, v in zip(stacked.inputs(), (x, z)):
        buf.copy_(v)
    for bufs, v in zip(peer.inputs(), (x, z)):
        for view, row in zip(bufs, v.unbind(0)):
            view[0].copy_(row)
    for _ in range(2):
        stacked.replay()
        peer.replay()
        for s, p in zip(stacked.outputs(), peer.outputs()):
            assert_rows_equal([v[0] for v in p], s)
    expect = torch.zeros(N, 1 << 20)
    expect[1] = x[0] * 2.0
    assert_rows_equal([v[0] for v in peer.outputs()[0]], expect + 1.0)


@pytest.mark.parametrize("card_of", [[0, 1, 2, 3], [0, 0, 1, 1],
                                     [0, 0, 0, 0]])
def test_a_stage_for_a_later_run_is_awaited_by_its_via(card_of):
    """The via card's table of the earlier run ends in a wait on the
    hop-1 tile's landing flag (on one card, stream order orders them and
    there is no flag); an emulation of both runs over the cards (each
    card's runs in stream order, cards interleaved at random, the staging
    poisoned) writes what the plain walk writes."""
    cap, split, outputs, hop1, hop2 = split_step()
    peer = PeerStepProgram(split, cap, outputs, CPU4)
    first, second = peer.copy_runs
    assert hop1 in first.nodes and hop2 in second.nodes
    via = split.nodes[hop2].link[0]
    assert split.nodes[hop1].link == (0, via)
    tables = [dk.card_tables(r.table.items, card_of)
              for r in (first, second)]
    src_card, via_card = card_of[0], card_of[via]
    sent = tables[0][src_card]
    sent = sent[sent[:, dk.C_NODE] == first.nodes.index(hop1)]
    assert len(sent) and (sent[:, dk.C_DST_SPACE] == dk.SPACE_STAGE).all()
    if via_card == src_card:
        assert (sent[:, dk.C_SIG_CARD] < 0).all()
    else:
        assert (sent[:, dk.C_SIG_CARD] == via_card).all()
        via_rows = tables[0][via_card]
        tail = via_rows[via_rows[:, dk.C_NBYTES] == 0]
        assert set(sent[:, dk.C_SIG_IDX]) <= set(tail[:, dk.C_WAIT])
        assert via_rows[-1, dk.C_NBYTES] == 0
        assert via_rows[-1, dk.C_WAIT] >= 0
    # the hop 2 in the later run reads the slot with no flag of its own
    got = second.table.items[second.table.items[:, dk.C_NODE]
                             == second.nodes.index(hop2)]
    assert (got[:, dk.C_SRC_SPACE] == dk.SPACE_STAGE).all()
    assert (got[:, dk.C_PRED] < 0).all()
    assert (got[:, dk.C_EXEC] == via).all()

    nbytes = peer.arenas[0].numel()
    for seed in range(6):
        rng = np.random.RandomState(seed)
        x = [torch.from_numpy(rng.randint(0, 256, nbytes).astype(np.uint8))
             for _ in range(N)]
        want = [a.clone() for a in x]
        want_stage = [torch.full_like(st, 0xAB) for st in peer.stages]
        for r in (first, second):
            dk.run_node_table_plain(r.table.items, want, want, want_stage)
        got = [a.clone() for a in x]
        stage = [torch.full_like(st, 0xAB) for st in peer.stages]
        emulate_runs(tables, card_of, got, stage, rng)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def emulate_runs(tables, card_of, arenas, stage, rng):
    """Run each card's tables of consecutive runs as one stream a card
    does (a card starts its run r + 1 only once its run r has ended),
    cards interleaved at random, every flag a card's (one epoch, fresh
    flags). An item waits until its flag is set; a flagged item sets its
    signal after its copy."""
    ncards = max(card_of) + 1
    streams = [[(r, i) for r, run in enumerate(tables)
                for i in range(len(run[c]))] for c in range(ncards)]
    flags = [[np.zeros(max(dk.num_flags(run[c]), 1), bool)
              for c in range(ncards)] for run in tables]
    spaces = {dk.SPACE_IN: arenas, dk.SPACE_OUT: arenas,
              dk.SPACE_STAGE: stage}
    pos = [0] * ncards
    while any(p < len(s) for p, s in zip(pos, streams)):
        ready = []
        for c in range(ncards):
            if pos[c] < len(streams[c]):
                r, i = streams[c][pos[c]]
                wait = tables[r][c][i, dk.C_WAIT]
                if wait < 0 or flags[r][c][wait]:
                    ready.append(c)
        assert ready, "deadlock: every card waits"
        c = ready[rng.randint(len(ready))]
        r, i = streams[c][pos[c]]
        pos[c] += 1
        row = tables[r][c][i]
        nb = row[dk.C_NBYTES]
        if nb:
            dst = spaces[row[dk.C_DST_SPACE]][row[dk.C_DST_DEV]]
            src = spaces[row[dk.C_SRC_SPACE]][row[dk.C_SRC_DEV]]
            dst[row[dk.C_DST_OFF]:row[dk.C_DST_OFF] + nb].copy_(
                src[row[dk.C_SRC_OFF]:row[dk.C_SRC_OFF] + nb])
        if row[dk.C_SIG_CARD] >= 0:
            flags[r][row[dk.C_SIG_CARD]][row[dk.C_SIG_IDX]] = True


def test_a_whole_table_lands_its_terminal_tiles_only():
    """A whole graph's per-device table awaits no stage across runs: its
    landing waits are its remote terminal tiles, one each, as before."""
    from repro_torch.comm import lower
    sess = CommSession(CommConfig(multipath_threshold=64), devices=CPU4)
    plan = sess.plan(0, 1, 4 << 20, max_paths=3, num_chunks=2, granularity=4)
    assert any(pa.route.num_hops == 2 for pa in plan.paths)
    table = dk.build_node_table(lower(plan), [1 << 20], [4], N,
                                per_device=True)
    tables = dk.card_tables(table.items, [0, 1, 2, 3])
    landing = sum(int((t[:, dk.C_NBYTES] == 0).sum()) for t in tables)
    remote_terminal = sum(
        1 for r in table.items
        if r[dk.C_NODE] >= 0 and r[dk.C_DST_SPACE] == dk.SPACE_OUT
        and r[dk.C_DST_DEV] != r[dk.C_EXEC])
    assert landing == remote_terminal > 0
