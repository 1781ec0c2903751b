"""A peer session's collectives against the stacked session and the reference.

The reference runs its collectives over a mesh of 4 CPU devices, each
device with its own operand. The port's peer session
(``CommSession(devices=["cpu"] * 4)``) holds one tensor a logical device:
its ring shifts run per-device ``multipath_dma`` tables (their plain
version here), its all-gather the peer ``ring_allgather`` (its plain
version here). The same numpy inputs go through the reference, the stacked
session and the peer session, in float32 and bfloat16; both rings add in
the same order, so every result is held bit for bit, sums included. Plan
cache keys, digests and hit/miss counters are held to the reference's.

The peer ring kernel runs only on the card (``tests/test_torch_cuda.py``,
``-k peer``); here each card's tickets, as ``csrc/ring_allgather.cu``
decodes them (:func:`peer_card_items`), run through an emulation of a
persistent grid a card with random interleavings: no copy waits, every
wait is met, every flag is written once an execution, a card's replicas
are complete when its launch ends, and they equal the plain version.
The per-card bodies of a driver-level program (one CUDA graph a card,
the other cards' parts ``None``) run on threads, one a card, over a
ring that exchanges their parts, and give the all-card run's rows.
"""

import gc
import threading
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.comm import CommSession as JCommSession
from repro.comm import collectives as jcoll
from repro.comm.session import CollectiveKey as JCollectiveKey
from repro.compat import shard_map
from repro.kernels.ring_allgather import ops as jops

from repro_torch.comm import CollectiveKey, CommSession, TransferPlanCache
from repro_torch.comm import collectives as coll
from repro_torch.comm.engine import PlacedKey
from repro_torch.comm.session import CollectiveProgram, PeerCollectiveProgram
from repro_torch.kernels.multipath_dma import kernel as dk
from repro_torch.kernels.ring_allgather import kernel as rk
from repro_torch.kernels.ring_allgather import ops as rops
from repro_torch.launch import cost

N = 4
CPU4 = ["cpu"] * N


@pytest.fixture(scope="module")
def jmesh4():
    return jax.sharding.Mesh(np.array(jax.devices()[:N]), ("dev",))


def payload(seed, shape, dtype):
    """(torch tensor, jax array) of the same bits; bfloat16 from the top
    half of float32 bits."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if dtype == "float32":
        return torch.from_numpy(x.copy()), jnp.asarray(x)
    b = (x.view(np.uint32) >> 16).astype(np.uint16)
    return (torch.from_numpy(b.view(np.int16).copy()).view(torch.bfloat16),
            jnp.asarray(b).view(jnp.bfloat16))


def bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    return np.asarray(a.view(jnp.uint16) if a.dtype == jnp.bfloat16 else a)


# -- driver-level collectives ------------------------------------------------

CALLS = [
    ("all_gather", (16, 6)), ("all_gather", (16, 6)), ("all_gather", (8, 7)),
    ("all_gather", (8, 1)), ("reduce_scatter", (16, 8)),
    ("reduce_scatter", (8, 1)), ("all_reduce", (32, 8)),
    ("all_reduce", (32, 8)), ("all_reduce", (12, 7)), ("all_to_all", (16, 4)),
    ("all_to_all", (16, 3, 5)), ("psum", (5, 3)), ("psum", (5, 3)),
    ("psum", (7,)), ("psum", (2, 3, 3)),
]


def counters(stats):
    c = stats["cache"]
    return c["hits"], c["misses"], c["size"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_driver_level_collectives_equal_stacked_and_reference(jmesh4, dtype):
    jsess = JCommSession(mesh=jmesh4)
    stacked = CommSession(device="cpu")
    peer = CommSession(devices=CPU4)
    for k, (op, shape) in enumerate(CALLS):
        x, xj = payload(k, shape, dtype)
        want = bits(getattr(jsess, op)(xj))
        s = getattr(stacked, op)(x)
        p = getattr(peer, op)(x)
        assert p.shape == s.shape == want.shape and p.dtype == s.dtype
        np.testing.assert_array_equal(bits(s), want, err_msg=op)
        np.testing.assert_array_equal(bits(p), want, err_msg=op)
        assert counters(peer.stats()) == counters(jsess.stats()), op
    assert peer.stats()["dispatches"] == len(CALLS)
    assert stacked.stats()["cache"] == peer.stats()["cache"]
    placement = ("cpu",) * N
    assert [k.key for k in peer.cache.keys()] == stacked.cache.keys()
    assert all(k == PlacedKey(k.key, placement) for k in peer.cache.keys())
    assert ([k.key.digest for k in peer.cache.keys()]
            == [k.digest for k in jsess.cache.keys()])
    for compiled in peer.cache.values():
        assert isinstance(compiled.program, PeerCollectiveProgram)


def test_a_call_is_one_dispatch_and_a_repeat_one_hit():
    sess = CommSession(devices=CPU4)
    x = torch.randn(16, 6)
    out = sess.all_reduce(x)
    (compiled,) = sess.cache.values()
    assert sess.stats()["dispatches"] == 1
    assert compiled.lifecycle.launches == 1
    assert compiled.lifecycle.num_nodes == 4 * (N - 1)
    assert torch.equal(sess.all_reduce(x), out)
    stats = sess.stats()
    assert stats["dispatches"] == 2 and compiled.lifecycle.launches == 2
    assert (stats["cache"]["hits"], stats["cache"]["misses"]) == (1, 1)
    # a result is a new tensor on devices[0]: the next call leaves it alone
    held = sess.all_reduce(x)
    sess.all_reduce(2 * x)
    assert torch.equal(held, out) and held.device == sess.devices[0]


def test_shared_cache_never_serves_one_placement_the_others_collective():
    cache = TransferPlanCache()
    stacked = CommSession(device="cpu", cache=cache)
    peer = CommSession(devices=CPU4, cache=cache)
    x = torch.randn(16, 6)
    want = stacked.all_gather(x)
    for sess in (peer, stacked, peer):
        assert torch.equal(sess.all_gather(x), want)
    assert len(cache) == 2
    skey, pkey = cache.keys()
    assert isinstance(skey, CollectiveKey) and pkey == PlacedKey(
        skey, ("cpu",) * N)
    assert isinstance(cache.get(skey).program, CollectiveProgram)
    assert isinstance(cache.get(pkey).program, PeerCollectiveProgram)
    other = CommSession(devices=["cpu"] * N, cache=cache)
    assert torch.equal(other.all_gather(x), want)
    assert len(cache) == 2                  # same placement: a hit


@pytest.mark.parametrize("op,shape,dtype", [
    ("all_gather", (16, 6), "float32"), ("psum", (5, 3), "bfloat16"),
    ("all_to_all", (16, 4), "float32"), ("reduce_scatter", (8, 1),
                                         "bfloat16")])
def test_collective_key_digest_equals_reference(op, shape, dtype):
    ours = CollectiveKey.for_collective(op, shape, dtype, "dev", N)
    ref = JCollectiveKey.for_collective(op, shape, dtype, "dev", N)
    assert (ours.op, ours.digest) == (ref.op, ref.digest)


def test_driver_level_errors_are_the_stacked_sessions():
    sess = CommSession(devices=CPU4)
    for op in ("all_gather", "reduce_scatter", "all_reduce"):
        with pytest.raises(ValueError, match="divisible"):
            getattr(sess, op)(torch.zeros(6, 2))
    with pytest.raises(ValueError, match="n²"):
        sess.all_to_all(torch.zeros(8, 2))


# -- session.collectives: per-device lists -----------------------------------

LOCAL = {"all_gather": [(3, 7), (2, 1), (5, 8)],
         "reduce_scatter": [(8, 6), (8, 1), (12, 7)],
         "all_reduce": [(8, 6), (4, 1)],
         "all_to_all": [(N, 3), (N, 2, 5)],
         "psum": [(5, 3), (7,), (2, 3, 3)]}
REF_FORMS = {"all_gather": jcoll.bidir_ring_all_gather,
             "reduce_scatter": jcoll.bidir_ring_reduce_scatter,
             "all_reduce": jcoll.multipath_all_reduce,
             "all_to_all": jcoll.multipath_all_to_all,
             "psum": jcoll.psum_via_multipath}


def ref_rows(mesh, op, xj, local):
    """The reference's collective under ``shard_map``: each device's own
    operand; returns the per-device results stacked."""
    fn = jax.jit(shard_map(lambda v: REF_FORMS[op](v[0], "dev")[None],
                           mesh=mesh, in_specs=P("dev"), out_specs=P("dev"),
                           check_vma=False))
    return bits(fn(xj.reshape((N,) + local)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", sorted(LOCAL))
def test_session_collectives_equal_stacked_and_reference(jmesh4, op, dtype):
    stacked = CommSession(device="cpu")
    peer = CommSession(devices=CPU4)
    for k, local in enumerate(LOCAL[op]):
        x, xj = payload(10 + k, (N,) + local, dtype)
        want = ref_rows(jmesh4, op, xj, local)
        s = getattr(stacked.collectives, op)(x)
        for _ in range(2):              # the second call is a cache hit
            p = getattr(peer.collectives, op)(list(x.unbind(0)))
            assert isinstance(p, list) and len(p) == N
            np.testing.assert_array_equal(bits(torch.stack(p)), bits(s))
            np.testing.assert_array_equal(bits(torch.stack(p)), want)
    # one program a signature, in the session's plan cache; a call is one
    # dispatch, a repeat one hit
    stats = peer.stats()
    assert len(peer.cache) == len(LOCAL[op])
    assert stats["dispatches"] == 2 * len(LOCAL[op])
    assert stats["cache"]["hits"] == len(LOCAL[op])
    for compiled in peer.cache.values():
        assert isinstance(compiled.program, PeerCollectiveProgram)


def test_pmean_equals_stacked():
    stacked = CommSession(device="cpu")
    peer = CommSession(devices=CPU4)
    for dtype in ("float32", "bfloat16"):
        x, _ = payload(3, (N, 5, 3), dtype)
        got = peer.collectives.pmean(list(x.unbind(0)))
        assert torch.equal(torch.stack(got), stacked.collectives.pmean(x))


def test_each_ring_step_owns_its_programs():
    """A reduce-scatter's n − 1 shifts are n − 1 tables, each its own
    buffers, each message one direct copy with no fill; an all-reduce
    adds one peer ring program; a repeat reuses them all."""
    sess = CommSession(devices=CPU4)
    parts = list(torch.randn(N, 8, 6).unbind(0))
    sess.collectives.all_reduce(parts)
    (compiled,) = sess.cache.values()
    ring = compiled.program.ring
    shifts = [p for p in ring.programs if isinstance(p, dk.PeerDmaProgram)]
    rings = [p for p in ring.programs if isinstance(p, rk.PeerRingProgram)]
    assert len(shifts) == N - 1 and len(rings) == 1
    assert ring.programs[-1] is rings[0]
    ptrs = {y.data_ptr() for p in shifts for y in p.y}
    assert len(ptrs) == (N - 1) * N
    for p in shifts:
        items = p.table.items
        assert p.table.num_copy_nodes == 2 * N == len(p.table.messages)
        assert (items[:, dk.C_NODE] >= 0).all()       # no fill items
        assert all(m.dst == (m.src + (1 if i < N else -1)) % N
                   for i, m in enumerate(p.table.messages))
        # each device holds its two sends' operands and its two receipts'
        # outputs, not the ring's 2n messages
        for d in range(N):
            sends = [m for m in p.table.messages if m.src == d]
            recvs = [m for m in p.table.messages if m.dst == d]
            assert [m for m in p.table.messages if m.at[d][0] >= 0] == sends
            assert [m for m in p.table.messages if m.at[d][1] >= 0] == recvs
            assert p.x[d].numel() == sum(-(-m.nbytes // 256) * 256
                                         for m in sends)
            assert p.y[d].numel() == sum(-(-m.nbytes // 256) * 256
                                         for m in recvs)
    before = list(ring.programs)
    sess.collectives.all_reduce(parts)
    assert ring.programs == before


def test_dropping_a_peer_session_frees_its_programs():
    """Nothing holds a peer session or its programs in a reference cycle:
    without the cyclic collector, dropping the session frees its rings'
    buffers."""
    gc.disable()
    try:
        sess = CommSession(devices=CPU4)
        sess.collectives.all_reduce(list(torch.randn(N, 8, 6).unbind(0)))
        sess.psum(torch.randn(5, 3))
        (program, *_), _ = zip(*[(c.program, c) for c in sess.cache.values()])
        held = [weakref.ref(program), weakref.ref(sess)]
        buf = weakref.ref(program.ring.programs[0].y[0])
        del sess, program, _
        assert all(r() is None for r in held) and buf() is None
    finally:
        gc.enable()


def test_peer_collectives_refuse_stacked_and_misplaced_operands():
    sess = CommSession(devices=CPU4)
    with pytest.raises(ValueError, match="takes a list"):
        sess.collectives.psum(torch.randn(N, 5))
    with pytest.raises(ValueError, match="one tensor on each"):
        sess.collectives.psum([torch.randn(5)] * (N - 1))


def test_a_cost_count_records_one_collective_as_the_stacked_form():
    stacked = CommSession(device="cpu")
    peer = CommSession(devices=CPU4)
    x = torch.randn(N, 8, 6)
    for op in ("all_gather", "reduce_scatter", "all_reduce", "psum"):
        _, want = cost.count(getattr(stacked.collectives, op), x)
        _, got = cost.count(getattr(peer.collectives, op),
                            list(x.unbind(0)))
        assert got.collectives == want.collectives and len(got.collectives)


# -- the peer ring all-gather -----------------------------------------------

@pytest.mark.parametrize("rows,f", [(8, 128), (4, 64), (8, 7), (5, 9)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_peer_ring_plain_equals_stacked_and_reference_kernel(jmesh4, rows, f,
                                                             dtype):
    x, xj = payload(rows * f, (N * rows, f), dtype)
    want = bits(jops.ring_allgather(xj, jmesh4))
    shards = list(x.view(N, rows, f).unbind(0))
    got = rk.ring_allgather_peer_plain(shards)
    stacked = rk.ring_allgather_plain(x.view(N, rows, f))
    for d in range(N):
        assert got[d].shape == (N, rows, f) and got[d].dtype == x.dtype
        assert torch.equal(got[d], stacked[d])
        np.testing.assert_array_equal(bits(got[d].reshape(N * rows, f)),
                                      want)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
def test_peer_ring_plain_equals_stacked_plain_narrow(n):
    """f = 1 runs one direction (the reference's kernel refuses a zero-width
    half, so the stacked plain version is the oracle here)."""
    xs = torch.randn(n, 3, 1)
    got = rk.ring_allgather_peer_plain(list(xs.unbind(0)))
    assert torch.equal(torch.stack(got), rk.ring_allgather_plain(xs))


def test_peer_ring_program_on_the_cpu_runs_the_plain_version():
    shards = [torch.randn(5, 9) for _ in range(N)]
    prog = rk.PeerRingProgram(5, 9, torch.float32, CPU4)
    for buf, x in zip(prog.x, shards):
        buf.copy_(x)
    prog.replay()
    (outs,) = prog.outputs()
    want = rk.ring_allgather_peer_plain(shards)
    assert all(torch.equal(o, w) for o, w in zip(outs, want))
    assert prog.cards == (torch.device("cpu"),)


def test_peer_ring_wrapper_raises_instead_of_falling_back():
    shards = [torch.zeros(2, 8)] * N
    with pytest.raises(ValueError, match="CUDA"):
        rk.ring_allgather_peer_cuda(shards)
    launches = rk.LAUNCHES
    out = rk.ring_allgather_peer_cuda([s.to("meta") for s in shards])
    assert [tuple(o.shape) for o in out] == [(N, 2, 8)] * N
    assert all(o.device.type == "meta" for o in out)
    assert rk.LAUNCHES == launches
    with pytest.raises(ValueError, match="one shape"):
        rk.ring_allgather_peer_cuda([torch.zeros(2, 8, device="meta"),
                                     torch.zeros(2, 7, device="meta")])


def test_ops_take_a_list_of_shards_to_the_peer_form():
    shards = [torch.randn(3, 7) for _ in range(N)]
    got = rops.ring_allgather(shards)
    assert all(torch.equal(g, w) for g, w in
               zip(got, rk.ring_allgather_peer_plain(shards)))
    launches = rk.LAUNCHES
    meta = rops.ring_allgather([s.to("meta") for s in shards])
    assert [tuple(m.shape) for m in meta] == [(N, 3, 7)] * N
    assert rk.LAUNCHES == launches


def emulate_peer_ring(x: np.ndarray, card_of, tile_bytes, blocks, runs,
                      seed):
    """Run every card's tickets (:func:`peer_card_items`) as the kernel
    does, on the bytes of ``x: (n, rows, f)``: ``blocks`` persistent blocks
    a card claim tickets in order from the card's counter. A copy ticket
    stores its chunk into one receiver a move (receivers ``e, e + 1, ...``)
    and, in a move after its last store, sets its flag on every card; it
    never waits. A wait ticket holds its block until every flag it covers
    reaches the card's epoch; then each such chunk must be in every replica
    on the card. A random block that can move moves. Flags are never
    zeroed, a flag is written once an execution, each card's epoch is one
    more an execution, and when a card's last block ends, every replica on
    the card is complete. Returns each execution's replicas (bytes) and
    completed copy items."""
    n = x.shape[0]
    g = rk.RingGeometry.for_shape(n, *x.shape[1:], x.itemsize, tile_bytes)
    size, nflags = g.shard_bytes, g.n * g.chunks
    src = np.ascontiguousarray(x).view(np.uint8).reshape(n, size)
    ncards = max(card_of) + 1
    mine = [[d for d in range(n) if card_of[d] == c] for c in range(ncards)]
    tables = []
    for c in range(ncards):
        copies, waits = rk.peer_card_items(g, mine[c])
        assert copies.shape == (len(mine[c]) * g.chunks, 3)
        for e, ch, flag in copies:
            assert card_of[e] == c and flag == e * g.chunks + ch
        # the waits cover every flag of the card once, THREADS at most each
        assert waits[0, 0] == 0 and waits[-1, 1] == nflags
        assert (waits[1:, 0] == waits[:-1, 1]).all()
        assert (waits[:, 1] - waits[:, 0] <= rk.THREADS).all()
        tables.append([("copy", *r) for r in copies]
                      + [("wait", *r) for r in waits])
    flags = [np.zeros(nflags, np.int64) for _ in range(ncards)]
    rng = np.random.RandomState(seed)
    results = []
    for epoch in range(1, runs + 1):
        out = np.zeros((n, n * size), np.uint8)
        have = np.zeros((n, n * size), bool)
        ticket = [0] * ncards
        held = [[None] * blocks for _ in range(ncards)]
        done = [False] * ncards
        completed = 0
        while True:
            for c in range(ncards):
                if not done[c] and ticket[c] == len(tables[c]) and all(
                        h is None for h in held[c]):
                    done[c] = True          # the card's launch has ended
                    assert have[mine[c]].all(), "replica incomplete"
            moves = []
            for c in range(ncards):
                for b in range(blocks):
                    row = held[c][b]
                    if row is None:
                        if ticket[c] < len(tables[c]):
                            moves.append((c, b))
                    elif row[0] == "copy" or (
                            flags[c][row[1]:row[2]] >= epoch).all():
                        moves.append((c, b))
            if not moves:
                assert all(done), "deadlock"
                break
            c, b = moves[rng.randint(len(moves))]
            row = held[c][b]
            if row is None:
                held[c][b] = tables[c][ticket[c]] + (0,)
                ticket[c] += 1
            elif row[0] == "wait":
                for f in range(row[1], row[2]):
                    s_, ch = divmod(f, g.chunks)
                    off, length = g.chunk(ch)
                    lo = s_ * size + off
                    assert have[mine[c], lo:lo + length].all()
                held[c][b] = None
            else:
                _, e, ch, flag, j = row
                off, length = g.chunk(ch)
                if j < n:                       # one receiver's store
                    d, lo = (e + j) % n, e * size + off
                    out[d, lo:lo + length] = src[e, off:off + length]
                    have[d, lo:lo + length] = True
                    held[c][b] = row[:-1] + (j + 1,)
                    continue
                for fl in flags:                # one flag on every card
                    assert fl[flag] == epoch - 1, "flag written twice"
                    fl[flag] = epoch
                completed += 1
                held[c][b] = None
        results.append((out, completed))
    return results


@pytest.mark.parametrize("card_of", [[0, 1, 2, 3], [0, 0, 1, 1],
                                     [0, 0, 0, 0]])
@pytest.mark.parametrize("rows,f,tile_bytes,dtype", [
    (8, 12, 16, "float32"), (5, 7, 24, "float32"), (3, 1, 4, "float32"),
    (6, 9, 4096, "float32"), (65, 2, 4, "float32"), (64, 2, 48, "bfloat16"),
    (5, 3, 16, "bfloat16")])
def test_peer_ring_card_items_run_the_flag_protocol(card_of, rows, f,
                                                    tile_bytes, dtype):
    """(65, 2) at 4-byte chunks has 520 flags, two wait tickets a card;
    (rows, 2) shards are psum's; (5, 3) bf16 is 30 bytes, not a multiple
    of 16."""
    x, _ = payload(rows * f, (N * rows, f), dtype)
    x = x.view(N, rows, f)
    want = rk.ring_allgather_peer_plain(list(x.unbind(0)))
    xb = (x.view(torch.int16) if dtype == "bfloat16" else x).numpy()
    g = rk.RingGeometry.for_shape(N, rows, f, xb.itemsize, tile_bytes)
    for blocks in (1, 3):
        for out, completed in emulate_peer_ring(xb, card_of, tile_bytes,
                                                blocks, 3, seed=blocks):
            assert completed == g.num_items
            for d in range(N):
                assert np.array_equal(
                    out[d], want[d].contiguous().view(torch.uint8).numpy()
                    .reshape(-1))


# -- one CUDA graph a card: the per-card bodies ------------------------------

class ThreadRing(coll.ListRing):
    """Stands in for a :class:`PeerRing` in one-card runs: each card's
    body runs on a thread of its own, and every shift or gather exchanges
    the parts the cards hold through a barrier (as the kernels' flags
    join the cards' graphs)."""

    def __init__(self, card_of):
        self.card_of = card_of
        self.n = len(card_of)
        self.barrier = threading.Barrier(max(card_of) + 1, timeout=60)
        self.lock = threading.Lock()
        self.slots: dict[int, list] = {}
        self.local = threading.local()

    def held(self, d):
        return self.card_of[d] == self.local.card

    def _exchange(self, parts):
        k = self.local.step
        self.local.step += 1
        with self.lock:
            slot = self.slots.setdefault(k, [None] * self.n)
            for d, part in enumerate(parts):
                if part is not None:
                    assert self.held(d) and slot[d] is None
                    slot[d] = part.clone()
        self.barrier.wait()
        return self.slots[k]

    def shift(self, *sends):
        out = []
        for parts, s in sends:
            full = self._exchange(parts)
            out.append([full[(d - s) % self.n] if self.held(d) else None
                        for d in range(self.n)])
        return out

    def gather(self, shards):
        full = torch.stack(self._exchange(shards))
        return [full.clone() if self.held(d) else None
                for d in range(self.n)]


FORMS = [(coll.bidir_ring_all_gather, (3, 7)),
         (coll.bidir_ring_all_gather, (2, 1)),
         (coll.bidir_ring_reduce_scatter, (8, 6)),
         (coll.bidir_ring_reduce_scatter, (8, 1)),
         (coll.multipath_all_reduce, (8, 5)),
         (coll.multipath_all_to_all, (N, 3)),
         (coll.psum_via_multipath, (5, 3))]


@pytest.mark.parametrize("card_of", [[0, 1, 2, 3], [0, 0, 1, 1],
                                     [0, 1, 1, 1]])
@pytest.mark.parametrize("k", range(len(FORMS)))
def test_per_card_bodies_give_the_all_card_rows(card_of, k):
    form, local = FORMS[k]
    x = torch.from_numpy(np.random.RandomState(k).randn(
        N, *local).astype(np.float32))
    want = form(x)                      # the stacked form
    ring = ThreadRing(card_of)
    got = [None] * N
    errors = []

    def body(card):
        try:
            ring.local.card, ring.local.step = card, 0
            xs = [x[d] if card_of[d] == card else None for d in range(N)]
            for d, y in enumerate(form(xs, ring)):
                if y is not None:
                    assert card_of[d] == card and got[d] is None
                    got[d] = y
                else:
                    assert card_of[d] != card
        except BaseException as exc:            # pragma: no cover
            errors.append(exc)
            ring.barrier.abort()

    threads = [threading.Thread(target=body, args=(c,))
               for c in range(max(card_of) + 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert torch.equal(torch.stack(got), want)
