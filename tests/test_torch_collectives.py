"""The port's collectives against the reference collectives.

The reference functions run under ``shard_map`` on the 8-device CPU mesh,
each device with its OWN operand (the global array sharded on dim 0), so
the order of additions matters; the port runs the same functions on the
stacked operands ``(8, ...)`` on the CPU. Both rings add in the same order
(``acc = roll(acc) + blk``), so every result is held bit for bit, float32
sums included. The session-level collectives take the same global inputs
as the reference session's and must return the same global outputs with
the same plan-cache hit/miss sequence. The §4.4 tier model is pure Python
and must give equal numbers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.comm import CommSession as JCommSession
from repro.comm import collectives as jcoll
from repro.comm.session import CollectiveKey as JCollectiveKey
from repro.compat import make_mesh, shard_map
from repro.core.topology import Topology as JTopology

from repro_torch.comm import CollectiveKey, CommSession
from repro_torch.comm import collectives as coll
from repro_torch.core.topology import Topology

N = 8


def _run(fn, x, mesh, in_spec, out_spec):
    return np.asarray(jax.jit(shard_map(fn, mesh=mesh, in_specs=in_spec,
                                        out_specs=out_spec,
                                        check_vma=False))(x))


def stacked(seed, local_shape, n=N):
    """Per-device operands: numpy ``(n, *local)`` and the jax global
    array ``(n * local[0], *local[1:])`` that shards to them."""
    x = np.random.RandomState(seed).randn(n, *local_shape).astype(
        np.float32)
    return x, jnp.asarray(x.reshape((n * local_shape[0],)
                                    + tuple(local_shape[1:])))


@pytest.mark.parametrize("shape", [(8, 4), (8, 16), (16, 7), (8, 1)])
def test_all_gather(dev_mesh, shape):
    s = (shape[0] // N,) + shape[1:]
    x, xj = stacked(0, s)
    want = _run(lambda v: jcoll.bidir_ring_all_gather(v, "dev"), xj,
                dev_mesh, P("dev"), P(None))
    got = coll.bidir_ring_all_gather(torch.from_numpy(x))
    assert got.shape == (N,) + want.shape
    for d in range(N):
        np.testing.assert_array_equal(got[d].numpy(), want)


@pytest.mark.parametrize("shape", [(8, 4), (16, 8), (64, 6), (8, 1)])
def test_reduce_scatter(dev_mesh, shape):
    x, xj = stacked(1, shape)
    want = _run(lambda v: jcoll.bidir_ring_reduce_scatter(v, "dev"), xj,
                dev_mesh, P("dev"), P("dev"))
    got = coll.bidir_ring_reduce_scatter(torch.from_numpy(x))
    np.testing.assert_array_equal(got.reshape(want.shape).numpy(), want)


@pytest.mark.parametrize("shape", [(8, 4), (32, 8)])
def test_all_reduce(dev_mesh, shape):
    x, xj = stacked(2, shape)
    want = _run(lambda v: jcoll.multipath_all_reduce(v, "dev"), xj,
                dev_mesh, P("dev"), P("dev"))
    got = coll.multipath_all_reduce(torch.from_numpy(x))
    np.testing.assert_array_equal(got.reshape(want.shape).numpy(), want)


def test_all_to_all(dev_mesh):
    x, xj = stacked(3, (N, 1, 4))
    want = _run(lambda v: jcoll.multipath_all_to_all(v, "dev"), xj,
                dev_mesh, P("dev"), P("dev"))
    got = coll.multipath_all_to_all(torch.from_numpy(x))
    np.testing.assert_array_equal(got.reshape(want.shape).numpy(), want)


@pytest.mark.parametrize("shape", [(5, 3), (16,), (3, 3, 3)])
def test_psum_arbitrary_shapes(dev_mesh, shape):
    x, xj = stacked(4, shape)
    want = _run(lambda v: jcoll.psum_via_multipath(v, "dev"), xj,
                dev_mesh, P("dev"), P("dev"))
    got = coll.psum_via_multipath(torch.from_numpy(x))
    np.testing.assert_array_equal(got.reshape(want.shape).numpy(), want)


@pytest.mark.parametrize("local", [(8, 4), (4, 6)])
def test_two_level_all_reduce(local):
    mesh = make_mesh((2, 4), ("pod", "dev"))
    x, xj = stacked(5, local)
    spec = P(("pod", "dev"))
    want = _run(lambda v: jcoll.two_level_all_reduce(v, "pod", "dev"), xj,
                mesh, spec, spec)
    got = coll.two_level_all_reduce(
        torch.from_numpy(x).reshape((2, 4) + local))
    np.testing.assert_array_equal(got.reshape(want.shape).numpy(), want)


def test_bfloat16_gather_and_sum_keep_the_order(dev_mesh):
    x, _ = stacked(6, (8, 6))
    b = (x.view(np.uint32) >> 16).astype(np.uint16)
    xt = torch.from_numpy(b.view(np.int16).copy()).view(torch.bfloat16)
    xj = jnp.asarray(b.reshape(N * 8, 6)).view(jnp.bfloat16)
    for jfn, fn in ((jcoll.bidir_ring_reduce_scatter,
                     coll.bidir_ring_reduce_scatter),
                    (jcoll.multipath_all_reduce, coll.multipath_all_reduce)):
        want = _run(lambda v: jfn(v, "dev"), xj, dev_mesh, P("dev"),
                    P("dev"))
        got = fn(xt)
        np.testing.assert_array_equal(
            got.reshape(want.shape).view(torch.int16).numpy(),
            want.view(np.int16))


# -- tier model --------------------------------------------------------------

def _failed(topo_cls):
    topo = topo_cls.hierarchical(2, 4)
    inter = next(k for k in topo.links if topo.is_inter_island(*k))
    topo.fail_link(*inter)
    return topo


TOPOLOGIES = {
    "full_mesh4": lambda cls: cls.full_mesh(4),
    "hier2x4": lambda cls: cls.hierarchical(2, 4),
    "hier2x4_failed_inter": _failed,
}


@pytest.mark.parametrize("name", sorted(TOPOLOGIES))
@pytest.mark.parametrize("nbytes", [1 << 10, 1 << 20, 3 << 28])
def test_tier_model_equals_reference(name, nbytes):
    ours = TOPOLOGIES[name](Topology)
    ref = TOPOLOGIES[name](JTopology)
    assert coll.tier_bandwidths_gbps(ours) == jcoll.tier_bandwidths_gbps(ref)
    for strategy in ("flat", "two_level"):
        assert (coll.modeled_all_reduce_s(ours, nbytes, strategy)
                == jcoll.modeled_all_reduce_s(ref, nbytes, strategy))
    for strategy in ("auto", "flat", "two_level"):
        assert (coll.select_all_reduce_strategy(ours, nbytes, strategy)
                == jcoll.select_all_reduce_strategy(ref, nbytes, strategy))


def test_tier_model_errors():
    topo = Topology.full_mesh(4)
    with pytest.raises(ValueError, match="positive"):
        coll.modeled_all_reduce_s(topo, 0)
    with pytest.raises(ValueError, match="strategy"):
        coll.modeled_all_reduce_s(topo, 8, "ring")
    with pytest.raises(ValueError, match="strategy"):
        coll.select_all_reduce_strategy(topo, 8, "ring")


@pytest.mark.parametrize("op,shape,dtype", [
    ("all_gather", (8, 4), "float32"), ("psum", (5, 3), "bfloat16"),
    ("all_to_all", (64, 4), "float32")])
def test_collective_key_digest_equals_reference(op, shape, dtype):
    ours = CollectiveKey.for_collective(op, shape, dtype, "dev", 8)
    ref = JCollectiveKey.for_collective(op, shape, dtype, "dev", 8)
    assert (ours.op, ours.digest) == (ref.op, ref.digest)


# -- session-level collectives -----------------------------------------------

CALLS = [
    ("all_gather", (16, 6)), ("all_gather", (16, 6)),
    ("reduce_scatter", (16, 8)), ("all_reduce", (32, 8)),
    ("all_reduce", (32, 8)), ("all_to_all", (64, 4)), ("psum", (5, 3)),
    ("psum", (5, 3)), ("all_gather", (8, 1)), ("reduce_scatter", (16, 8)),
]


def test_session_collectives_equal_reference_session(dev_mesh):
    jsess = JCommSession(mesh=dev_mesh)
    sess = CommSession(device="cpu",
                       topology=Topology.full_mesh(8, with_host=True))
    for k, (op, shape) in enumerate(CALLS):
        x = np.random.RandomState(k).randn(*shape).astype(np.float32)
        want = np.asarray(getattr(jsess, op)(jnp.asarray(x)))
        got = getattr(sess, op)(torch.from_numpy(x))
        np.testing.assert_array_equal(got.numpy(), want, err_msg=op)
        j, p = jsess.stats()["cache"], sess.stats()["cache"]
        assert (p["hits"], p["misses"], p["size"]) == (
            j["hits"], j["misses"], j["size"]), op
    assert set(map(type, sess.cache.keys())) == {CollectiveKey}
    assert ([k.digest for k in sess.cache.keys()]
            == [k.digest for k in jsess.cache.keys()])


def test_session_repeat_is_one_replay_of_one_entry():
    sess = CommSession(device="cpu")
    x = torch.randn(8, 6)
    sess.all_gather(x)
    (compiled,) = [sess.cache.get(k) for k in sess.cache.keys()]
    launches = compiled.lifecycle.launches
    assert torch.equal(sess.all_gather(x), x)
    assert compiled.lifecycle.launches == launches + 1
    assert compiled.lifecycle.num_nodes == 2 * (4 - 1)


def test_session_divisibility_errors():
    sess = CommSession(device="cpu")
    for op in ("all_gather", "reduce_scatter", "all_reduce"):
        with pytest.raises(ValueError, match="divisible"):
            getattr(sess, op)(torch.zeros(6, 2))
    with pytest.raises(ValueError, match="n²"):
        sess.all_to_all(torch.zeros(8, 2))


def test_bound_collectives_pmean():
    sess = CommSession(device="cpu")
    xs = torch.from_numpy(
        np.random.RandomState(0).randn(4, 5, 3).astype(np.float32))
    got = sess.collectives.pmean(xs)
    assert sess.collectives.axis_name == "dev"
    np.testing.assert_allclose(got.numpy(), np.broadcast_to(
        xs.numpy().sum(0) / 4, xs.shape), rtol=1e-6)
