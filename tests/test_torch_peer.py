"""A peer session (``CommSession(devices=[...])``) against the reference.

The reference runs every transfer across distinct devices: its session on
a mesh of 4 CPU devices. The port's peer session puts logical device *i*
on ``devices[i]``; here ``devices=["cpu"] * 4``, each logical device with
its own buffers, the per-device table run by the plain version. The same
numpy inputs go through both: received arrays EQUAL bit for bit (a copy
does no arithmetic), plans, scheduled-graph digests and ``GroupKey``s
equal, and the dispatch/cache/fast-path counters equal. Jacobi on
per-device blocks is held to the reference's ``jacobi_step`` at 1e-5 (the
same adds in the same order; the reference's sweep runs its Pallas kernel
in interpret mode).

The per-card tables (:func:`card_tables`) are checked by an emulation of
the card kernel's flag protocol, several executions in a row with random
interleavings of the cards: every wait is met, every flag is written once
an execution, and the outputs equal the plain run's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.comm import CommConfig as JCommConfig
from repro.comm import CommSession as JCommSession
from repro.compat import shard_map
from repro.core import halo as jhalo

from repro_torch.comm import CommConfig, CommSession, TransferPlanCache
from repro_torch.comm.engine import PlacedKey
from repro_torch.comm.graph import CopyNode
from repro_torch.comm.session import resolve_devices
from repro_torch.configs import get_config
from repro_torch.core import halo
from repro_torch.core.topology import Topology
from repro_torch.kernels.multipath_dma import kernel as dk
from repro_torch.optim import OptimConfig
from repro_torch.training import (TrainStepConfig, init_state,
                                  make_captured_dp_train_step)

KiB = 1 << 10
CPU4 = ["cpu"] * 4
KNOBS = dict(multipath_threshold=4 * KiB, chunk_bytes=4 * KiB)


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
    return np.asarray(a.view(jnp.uint16) if a.dtype == jnp.bfloat16 else a)


def traffic(sess, side, dtype, window, max_paths):
    """send (twice: the second a fast-path hit), bidirectional, a
    4-message exchange (each device to the next) and a pytree, on either
    session; returns the received bits."""
    pick = 1 if side == "port" else 2
    kw = dict(window=window, max_paths=max_paths)
    out = []
    a = payload(0, (5000,), dtype)
    for _ in range(2):
        out.append(sess.send(a[pick], 0, 1, **kw))
    c = payload(1, (300_001,), dtype)          # large enough to stage
    out.extend(sess.bidirectional(c[pick], 1, 3, **kw))
    items = [(payload(2 + i, (300_000 + 7 * i,), dtype)[pick], i,
              (i + 1) % 4) for i in range(4)]
    out.extend(sess.exchange(items, **kw))
    tree = {"k": payload(8, (3, 700), dtype)[pick],
            "v": [payload(9, (2100,), dtype)[pick],
                  payload(10, (2, 2, 50), dtype)[pick]]}
    moved = sess.send_pytree(tree, 2, 0)
    out.extend([moved["k"], *moved["v"]])
    return [as_bits(o) for o in out]


def entries(sess):
    return sorted((e.digest, e.schedule, e.key.entries, e.key.window,
                   e.key.num_devices)
                  for _, e in sess.engine._fastpath._store.values())


def plans(sess):
    return sorted(
        (e.digest, tuple((p.src, p.dst, p.nbytes,
                          tuple((pa.route.directional_links(), pa.nbytes,
                                 pa.num_chunks) for pa in p.paths))
                         for p in e.plans))
        for _, e in sess.engine._fastpath._store.values())


def counters(stats):
    return (stats["dispatches"], stats["cache"]["hits"],
            stats["cache"]["misses"], stats["cache"]["size"],
            stats["fastpath"]["hits"], stats["fastpath"]["misses"],
            stats["graph"], stats["schedules"])


@pytest.mark.parametrize("max_paths", [1, 2, 3])
@pytest.mark.parametrize("window", [1, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_peer_session_matches_reference(jmesh4, dtype, window, max_paths):
    jsess = JCommSession(JCommConfig(**KNOBS), mesh=jmesh4)
    psess = CommSession(CommConfig(**KNOBS), devices=CPU4)
    assert psess.topology.digest() == jsess.topology.digest()
    want = traffic(jsess, "ref", dtype, window, max_paths)
    got = traffic(psess, "port", dtype, window, max_paths)
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert entries(psess) == entries(jsess)
    assert plans(psess) == plans(jsess)
    assert counters(psess.stats()) == counters(jsess.stats())
    for _, e in psess.engine._fastpath._store.values():
        prog = e.compiled.program
        assert isinstance(prog, dk.PeerDmaProgram)
        assert e.compiled.key == PlacedKey(e.key, ("cpu",) * 4)
        assert prog.completed_nodes() == e.graph.num_copy_nodes


def test_peer_session_sizes_its_topology_and_lists_its_devices():
    sess = CommSession(devices=["cpu"] * 3)
    assert sess.num_devices == 3
    assert sess.topology.digest() == Topology.full_mesh(
        3, with_host=True).digest()
    assert sess.stats()["devices"] == ["cpu"] * 3
    assert sess.describe(0, 2, 1 << 20)["devices"] == ["cpu"] * 3
    assert "devices" not in CommSession(device="cpu").stats()
    assert "devices" not in CommSession(device="cpu").describe(0, 1, 4096)


@pytest.mark.parametrize("kwargs,err", [
    (dict(device="cpu", devices=CPU4), ValueError),
    (dict(devices=["cpu", "cuda:0"]), ValueError),
    (dict(devices=[]), ValueError),
    (dict(devices=CPU4, topology=Topology.full_mesh(8)), ValueError)])
def test_peer_session_rejects_bad_placements(kwargs, err):
    with pytest.raises(err):
        CommSession(**kwargs)


def test_distinct_cards_without_peer_access_raise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "can_device_access_peer",
                        lambda a, b: False)
    with pytest.raises(RuntimeError, match="peer access"):
        resolve_devices(["cuda:0", "cuda:1"])
    # one card named twice needs no peer access
    assert resolve_devices(["cuda:0", "cuda:0"]) == (
        torch.device("cuda", 0),) * 2


def graph_of(sess, specs, window, max_paths):
    """The scheduled graph and plans the engine builds for ``specs``."""
    group = sess.engine.plan_group_for(specs, max_paths=max_paths)
    graph, _ = sess.engine._group_graph(group.plans, window)
    return graph, group.plans


@pytest.mark.parametrize("max_paths", [2, 3])
@pytest.mark.parametrize("window", [1, 2])
def test_items_execute_on_the_reference_kernels_roles(jmesh4, window,
                                                      max_paths):
    """Each copy item runs where the reference kernel runs its DMA: a
    direct or hop-1 chunk on ``src`` (``my == src`` starts it), a hop-2
    chunk on the path's ``via`` (``my == via`` waits and starts it); every
    staged hop's predecessor runs on another device; fills run on their
    own device and never on a destination."""
    jsess = JCommSession(JCommConfig(multipath_threshold=0,
                                     chunk_bytes=4 * KiB), mesh=jmesh4)
    psess = CommSession(CommConfig(multipath_threshold=0,
                                   chunk_bytes=4 * KiB), devices=CPU4)
    specs = [(0, 1, 300_000, torch.float32), (2, 0, 300_001, torch.float32)]
    graph, pplans = graph_of(psess, specs, window, max_paths)
    jgroup = jsess.engine.plan_group_for(
        [(s, d, n, jnp.float32) for s, d, n, _ in specs],
        max_paths=max_paths)
    assert [[pa.route.via for pa in p.paths] for p in jgroup.plans] == \
        [[pa.route.via for pa in p.paths] for p in pplans]
    table = dk.build_node_table(graph, [300_000, 300_001], [4, 4], 4,
                                per_device=True)
    copies = [n for n in graph.nodes if isinstance(n, CopyNode)]
    staged = 0
    for i, row in enumerate(table.items):
        exe = row[dk.C_EXEC]
        if row[dk.C_NODE] < 0:
            out = [m.at[row[dk.C_DST_DEV]][1] for m in table.messages]
            msg = next(m for m, o in zip(table.messages, out)
                       if o <= row[dk.C_DST_OFF] < o + m.nbytes)
            assert exe == row[dk.C_DST_DEV] != msg.dst
            continue
        node = copies[row[dk.C_NODE]]
        jpath = jgroup.plans[node.msg_idx].paths[node.path_idx]
        want = node.flow[0] if node.hop_idx == 0 else jpath.route.via
        assert exe == want == node.link[0]
        if row[dk.C_PRED] >= 0:
            staged += 1
            assert table.items[row[dk.C_PRED], dk.C_EXEC] != exe
            assert row[dk.C_SRC_SPACE] == dk.SPACE_STAGE
            assert row[dk.C_SRC_DEV] == exe          # the via's own slot
    assert staged > 0


@pytest.mark.parametrize("fill", ["zero", "copy", "none"])
def test_per_device_buffers_hold_what_the_table_touches(fill):
    """A logical device holds a message's operand only where the table
    reads it (its src; every device when the fill copies) and its output
    only where the table writes it (its dst; every device when there is a
    fill); every item stays inside its device's buffers, and the program
    delivers each message under each fill."""
    sess = CommSession(CommConfig(multipath_threshold=0,
                                  chunk_bytes=4 * KiB), devices=CPU4)
    specs = [(0, 1, 3000, torch.float32), (2, 0, 3001, torch.float32),
             (1, 3, 500, torch.float32)]
    graph, _ = graph_of(sess, specs, 1, 3)
    table = dk.build_node_table(graph, [s[2] for s in specs], [4] * 3, 4,
                                fill=fill, per_device=True)
    for m in table.messages:
        for d in range(4):
            assert (m.at[d][0] >= 0) == (d == m.src or fill == "copy")
            assert (m.at[d][1] >= 0) == (d == m.dst or fill != "none")
    space_of = {dk.SPACE_IN: 0, dk.SPACE_OUT: 1, dk.SPACE_STAGE: 2}
    for row in table.items:
        nb = row[dk.C_NBYTES]
        for space, off, dev in ((row[dk.C_SRC_SPACE], row[dk.C_SRC_OFF],
                                 row[dk.C_SRC_DEV]),
                                (row[dk.C_DST_SPACE], row[dk.C_DST_OFF],
                                 row[dk.C_DST_DEV])):
            if space != dk.SPACE_ZERO:
                assert 0 <= off and off + nb <= \
                    table.device_bytes[dev][space_of[space]]
    prog = dk.PeerDmaProgram(table, [torch.float32] * 3, CPU4)
    payloads = []
    for k, views in enumerate(prog.inputs()):
        for d, v in enumerate(views):
            assert (v is None) == (table.messages[k].at[d][0] < 0)
            if v is not None:
                v.copy_(torch.randn(v.shape))
        payloads.append(views[table.messages[k].src].clone())
    prog.run()
    for k, (m, views) in enumerate(zip(table.messages, prog.outputs())):
        assert torch.equal(views[m.dst], payloads[k])
        for d, v in enumerate(views):
            if d == m.dst:
                continue
            if fill == "none":
                assert v is None
            elif fill == "zero":
                assert not v.any()
            else:
                assert torch.equal(v, prog.inputs()[k][d])


def emulate_cards(tables, card_of, x, y, stage, executions, seed):
    """Run per-card tables as the kernel's flag protocol does: each card
    has an epoch (one more an execution) and flags never zeroed; an item
    waits until its flag holds its card's epoch, and sets its signal flag
    to the epoch after its copy. Cards and items interleave at random
    (one block a card, in table order). Returns every execution's summed
    completion counters."""
    rng = np.random.RandomState(seed)
    flags = [np.zeros(max(dk.num_flags(t), 1), np.int64) for t in tables]
    done_counts = []
    spaces = {dk.SPACE_IN: x, dk.SPACE_OUT: y, dk.SPACE_STAGE: stage}
    for epoch in range(1, executions + 1):
        pos = [0] * len(tables)
        completed = 0
        tiles = {}
        while any(p < len(t) for p, t in zip(pos, tables)):
            ready = []
            for c, t in enumerate(tables):
                if pos[c] < len(t):
                    wait = t[pos[c], dk.C_WAIT]
                    if wait < 0 or flags[c][wait] >= epoch:
                        ready.append(c)
            assert ready, "deadlock: every card waits"
            c = ready[rng.randint(len(ready))]
            row = tables[c][pos[c]]
            pos[c] += 1
            nb = row[dk.C_NBYTES]
            if nb:
                dst = spaces[row[dk.C_DST_SPACE]][row[dk.C_DST_DEV]]
                dst = dst[row[dk.C_DST_OFF]:row[dk.C_DST_OFF] + nb]
                if row[dk.C_SRC_SPACE] == dk.SPACE_ZERO:
                    dst.zero_()
                else:
                    src = spaces[row[dk.C_SRC_SPACE]][row[dk.C_SRC_DEV]]
                    dst.copy_(src[row[dk.C_SRC_OFF]:row[dk.C_SRC_OFF] + nb])
            if row[dk.C_SIG_CARD] >= 0:
                f = flags[row[dk.C_SIG_CARD]]
                assert f[row[dk.C_SIG_IDX]] == epoch - 1   # once a run
                f[row[dk.C_SIG_IDX]] = epoch
            node = row[dk.C_NODE]
            if node >= 0:
                tiles[node] = tiles.get(node, 0) + 1
                completed += tiles[node] == row[dk.C_NODE_TILES]
        done_counts.append(completed)
    return done_counts


@pytest.mark.parametrize("card_of", [[0, 1, 2, 3], [0, 0, 1, 1],
                                     [0, 0, 0, 0], [0, 1, 0, 1]])
@pytest.mark.parametrize("max_paths,window", [(3, 1), (2, 2), (1, 1)])
def test_card_tables_run_the_flag_protocol(card_of, max_paths, window):
    sess = CommSession(CommConfig(multipath_threshold=0,
                                  chunk_bytes=4 * KiB), devices=CPU4)
    specs = [(i, (i + 1) % 4, 300_000 + 13 * i, torch.float32)
             for i in range(4)]
    graph, _ = graph_of(sess, specs, window, max_paths)
    table = dk.build_node_table(graph, [s[2] for s in specs], [4] * 4, 4,
                                per_device=True, tile_bytes=96 * KiB)
    tables = dk.card_tables(table.items, card_of)
    assert len(tables) == max(card_of) + 1
    # the cards' own rows, in order, are the whole table's
    own = [r for t in tables for r in t if r[dk.C_NBYTES] or
           r[dk.C_NODE] >= 0]
    assert sorted(map(tuple, own)) == sorted(
        map(tuple, np.concatenate(tables)[
            np.concatenate(tables)[:, dk.C_NBYTES] > 0]))
    assert sum(len(t) for t in tables) >= table.num_items
    for c, t in enumerate(tables):
        assert all(card_of[e] == c for e in t[:, dk.C_EXEC])
        waits = t[t[:, dk.C_WAIT] >= 0, dk.C_WAIT]
        assert sorted(waits.tolist()) == list(range(dk.num_flags(t)))
    # a wait item a terminal tile that lands on another card
    remote_terminal = sum(
        1 for r in table.items
        if r[dk.C_NODE] >= 0 and r[dk.C_DST_SPACE] == dk.SPACE_OUT
        and card_of[r[dk.C_DST_DEV]] != card_of[r[dk.C_EXEC]])
    extra = sum(int(((t[:, dk.C_NBYTES] == 0)
                     & (t[:, dk.C_NODE] < 0)).sum()) for t in tables)
    assert extra == remote_terminal
    rng = torch.Generator().manual_seed(1)
    x = [torch.randint(0, 256, (table.io_bytes,), generator=rng,
                       dtype=torch.uint8) for _ in range(4)]
    y_plain = [torch.full((table.io_bytes,), 7, dtype=torch.uint8)
               for _ in range(4)]
    stage = [torch.zeros(max(table.stage_bytes, 16), dtype=torch.uint8)
             for _ in range(4)]
    assert dk.run_node_table_plain(table.items, x, y_plain,
                                   stage) == graph.num_copy_nodes
    y = [torch.full((table.io_bytes,), 7, dtype=torch.uint8)
         for _ in range(4)]
    stage2 = [torch.zeros_like(s) for s in stage]
    counts = emulate_cards(tables, card_of, x, y, stage2, 3, seed=7)
    assert counts == [graph.num_copy_nodes] * 3
    for a, b in zip(y, y_plain):
        assert torch.equal(a, b)


def test_stacked_table_keeps_its_flags_on_one_card():
    sess = CommSession(CommConfig(multipath_threshold=0,
                                  chunk_bytes=4 * KiB), device="cpu")
    graph, _ = graph_of(sess, [(0, 1, 300_000, torch.float32)], 1, 3)
    table = dk.build_node_table(graph, [300_000], [4], 4)
    it = table.items
    assert (it[:, [dk.C_SRC_DEV, dk.C_DST_DEV, dk.C_EXEC]] == 0).all()
    staged = it[it[:, dk.C_PRED] >= 0]
    assert len(staged) and (staged[:, dk.C_WAIT] >= 0).all()
    for row in staged:
        assert tuple(it[row[dk.C_PRED], [dk.C_SIG_CARD, dk.C_SIG_IDX]]) == \
            (0, row[dk.C_WAIT])
    assert ((it[:, dk.C_SIG_CARD] >= 0).sum()
            == dk.num_flags(it) == len(staged))


def runs(flags: list[bool], value: bool) -> int:
    """The longest run of ``value`` in ``flags``."""
    best = cur = 0
    for f in flags:
        cur = cur + 1 if f == value else 0
        best = max(best, cur)
    return best


#: Cards that run fills beside copies into another card, by placement and
#: paths of a 0 -> 1 send: src's card, and each via's when it is not src's.
SPREAD_CARDS = {((0, 1, 2, 3), 1): 1, ((0, 1, 2, 3), 3): 3,
                ((0, 0, 1, 1), 1): 0, ((0, 0, 1, 1), 3): 2,
                ((0, 0, 0, 0), 1): 0, ((0, 0, 0, 0), 3): 0}


@pytest.mark.parametrize("fill", ["zero", "copy"])
@pytest.mark.parametrize("card_of", [(0, 1, 2, 3), (0, 0, 1, 1),
                                     (0, 0, 0, 0)])
@pytest.mark.parametrize("max_paths,window", [(1, 1), (3, 1), (3, 2)])
def test_card_tables_spread_fills_under_sends_to_other_cards(
        fill, card_of, max_paths, window):
    """A card's fill items sit evenly among its copy tiles into another
    card (no run of fills longer than ceil(F / R), of such copies longer
    than ceil(R / F)), so that src's fill of its own output goes out under
    its sends; a card that sends to no other card keeps its fills first,
    as the whole table has them; every card keeps the whole table's order
    of its copies, and the cards' tables write the whole table's bytes."""
    sess = CommSession(CommConfig(multipath_threshold=0,
                                  chunk_bytes=64 * KiB), devices=CPU4)
    graph, _ = graph_of(sess, [(0, 1, 300_000, torch.float32)], window,
                        max_paths)
    table = dk.build_node_table(graph, [300_000], [4], 4, fill=fill,
                                per_device=True, tile_bytes=16 * KiB)
    whole = table.items
    nfill = int((whole[:, dk.C_NODE] < 0).sum())
    assert nfill and (whole[:nfill, dk.C_NODE] < 0).all()
    cards = np.asarray(card_of)
    tables = dk.card_tables(whole, card_of)
    spread = 0
    for c, t in enumerate(tables):
        own = t[t[:, dk.C_NBYTES] > 0]                  # no wait items
        is_fill = own[:, dk.C_NODE] < 0
        mine = whole[(whole[:, dk.C_NODE] >= 0)
                     & (cards[whole[:, dk.C_EXEC]] == c)]
        cols = [dk.C_NODE, dk.C_SRC_OFF, dk.C_DST_OFF]
        assert np.array_equal(own[~is_fill][:, cols], mine[:, cols])
        remote = ~is_fill & (cards[own[:, dk.C_DST_DEV]] != c)
        f, r = int(is_fill.sum()), int(remote.sum())
        if f and not r:
            assert is_fill[:f].all()
        elif f:
            spread += 1
            seq = (own[is_fill | remote, dk.C_NODE] < 0).tolist()
            assert runs(seq, True) <= -(-f // r)
            assert runs(seq, False) <= -(-r // f)
    assert spread == SPREAD_CARDS[card_of, max_paths]
    rng = torch.Generator().manual_seed(3)
    x = [torch.randint(0, 256, (table.io_bytes,), generator=rng,
                       dtype=torch.uint8) for _ in range(4)]
    stage = [torch.zeros(max(table.stage_bytes, 16), dtype=torch.uint8)
             for _ in range(4)]
    y, want = ([torch.full((table.io_bytes,), 7, dtype=torch.uint8)
                for _ in range(4)] for _ in range(2))
    rows = np.concatenate(tables)
    assert dk.run_node_table_plain(rows[rows[:, dk.C_NBYTES] > 0], x, y,
                                   stage) == \
        dk.run_node_table_plain(whole, x, want, stage) == \
        graph.num_copy_nodes
    assert all(map(torch.equal, y, want))


def test_non_destination_outputs_read_zero():
    sess = CommSession(CommConfig(multipath_threshold=0), devices=CPU4)
    x = torch.randn(3000)
    assert torch.equal(sess.send(x, 2, 1, max_paths=3, window=2), x)
    (_, entry), = sess.engine._fastpath._store.values()
    prog = entry.compiled.program
    for y in prog.y:
        y.fill_(0xAB)                   # garbage from an earlier life
    prog.inputs()[0][2].copy_(x)
    prog.replay()
    (outs,) = prog.outputs()
    for d, out in enumerate(outs):
        assert out.shape == (2, 3000)
        if d == 1:
            assert torch.equal(out, x.expand(2, -1))
        else:
            assert not out.any()


def test_shared_cache_never_serves_one_placement_the_others_program():
    cache = TransferPlanCache()
    stacked = CommSession(CommConfig(multipath_threshold=0), device="cpu",
                          cache=cache)
    peer = CommSession(CommConfig(multipath_threshold=0), devices=CPU4,
                       cache=cache)
    x = torch.randn(4096)
    for sess in (stacked, peer, stacked, peer):
        assert torch.equal(sess.send(x, 0, 1, max_paths=3), x)
    assert len(cache) == 2
    (_, se), = stacked.engine._fastpath._store.values()
    (_, pe), = peer.engine._fastpath._store.values()
    assert se.key == pe.key                  # the reference's key, both
    assert isinstance(se.compiled.program, dk.DmaProgram)
    assert isinstance(pe.compiled.program, dk.PeerDmaProgram)
    assert se.compiled.key == se.key and pe.compiled.key != pe.key
    other = CommSession(CommConfig(multipath_threshold=0),
                        devices=["cpu"] * 4, cache=cache)
    assert torch.equal(other.send(x, 0, 1, max_paths=3), x)
    assert len(cache) == 2                   # same placement: a hit


def ref_steps(mesh, u, iters):
    step = jax.jit(shard_map(
        lambda ul: jhalo.jacobi_step(ul[0], "dev", use_kernel=True)[None],
        mesh=mesh, in_specs=P("dev"), out_specs=P("dev"), check_vma=False))
    for _ in range(iters):
        u = step(u)
    return np.asarray(u, np.float32)


@pytest.mark.parametrize("cols", [24, 31])
def test_per_device_jacobi_matches_reference(jmesh4, cols):
    u = np.random.RandomState(cols).randn(4, 8, cols).astype(np.float32)
    want = ref_steps(jmesh4, jnp.asarray(u), 3)
    sess = CommSession(devices=CPU4)
    blocks = [torch.from_numpy(u[i].copy()) for i in range(4)]
    for _ in range(3):
        blocks = halo.jacobi_step(blocks, session=sess)
    assert isinstance(blocks, list) and len(blocks) == 4
    got = torch.stack(blocks).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert sess.stats()["dispatches"] == 3     # one fused exchange a step
    stacked = torch.from_numpy(u.copy())
    ssess = CommSession(device="cpu")
    for _ in range(3):
        stacked = halo.jacobi_step(stacked, session=ssess)
    assert torch.equal(torch.stack(blocks), stacked)


def test_per_device_halo_exchange_equals_reference(jmesh4):
    u = np.random.RandomState(2).randn(4, 5, 9).astype(np.float32)
    jl, jr = jhalo.halo_exchange_group(JCommSession(mesh=jmesh4),
                                       jnp.asarray(u))
    pl, pr = halo.halo_exchange_group(
        CommSession(devices=CPU4), [torch.from_numpy(b.copy()) for b in u])
    assert len(pl) == len(pr) == 4
    np.testing.assert_array_equal(torch.stack(pl).numpy(), np.asarray(jl))
    np.testing.assert_array_equal(torch.stack(pr).numpy(), np.asarray(jr))


def test_per_device_jacobi_needs_a_session():
    with pytest.raises(ValueError, match="session"):
        halo.jacobi_step([torch.zeros(4, 6)] * 4)


def test_capture_on_a_peer_session_raises():
    """Capture runs on a peer session (``tests/test_torch_peer_capture.py``
    holds it to the stacked session), and so does the captured DP step
    (``tests/test_torch_peer_training.py``): it builds with the stacked
    step's key and returns one replica a device. What raises is a stacked
    operand to the peer collectives, which take lists only (the mesh's MoE
    combine passes one tensor a logical device)."""
    sess = CommSession(devices=CPU4)
    step = sess.capture(lambda cap: cap.input((4,), torch.float32))
    (out,) = step([torch.full((4,), float(d)) for d in range(4)])
    assert [o.tolist() for o in out] == [[float(d)] * 4 for d in range(4)]
    cfg = get_config("smollm_360m").reduced()
    opt = OptimConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    state = init_state(cfg, opt, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (8, 9),
                         generator=torch.Generator().manual_seed(0))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "mask": torch.ones(8, 8)}
    stacked = make_captured_dp_train_step(
        cfg, TrainStepConfig(), opt, CommSession(device="cpu"), state,
        batch)
    peer = make_captured_dp_train_step(cfg, TrainStepConfig(), opt, sess,
                                       state, batch)
    assert peer.capture.resolve().key == stacked.capture.resolve().key
    reps, metrics = peer(state, batch)
    assert len(reps) == 4 and all(r["opt"]["step"] == 1 for r in reps)
    assert torch.isfinite(metrics["loss"])
    with pytest.raises(ValueError, match="takes a list"):
        sess.collectives.psum(torch.randn(4, 5))


def test_compiled_for_stages_one_view_a_device():
    """The AOT handle over peers takes, per message, one ``(window,
    nelems)`` operand a logical device and returns one output a device."""
    sess = CommSession(CommConfig(multipath_threshold=0), devices=CPU4)
    compiled, plan = sess.compiled_for(3, 1, 2000, window=2, max_paths=3)
    assert plan.num_paths == 3
    x = torch.randn(2, 2000)
    operand = [x if d == 3 else torch.full((2, 2000), float(d))
               for d in range(4)]
    (outs,) = compiled(operand)
    assert len(outs) == 4
    assert torch.equal(outs[1], x)
    assert all(not outs[d].any() for d in (0, 2, 3))
    assert compiled.program.completed_nodes() == 2 * sum(
        pa.num_chunks * pa.route.num_hops for pa in plan.paths)
