"""The port's sharding rules, logical meshes and device-stacked layout
against the reference, on the CPU.

* ``param_specs``, ``opt_state_specs`` (each config's own moment dtype,
  int8 included), ``batch_specs`` and ``cache_specs`` (a shardable batch
  and a batch of one) print as the reference's, leaf for leaf, for every
  registered config on the single-pod and multi-pod production meshes
  (the reference's ``abstract_mesh`` shapes of ``tests/test_sharding_data.py``);
* ``pick_kv_chunks`` over a grid of meshes, batches and lengths, and
  ``cache_shapes`` (shapes and dtypes), equal to the reference's;
* ``_safe`` and ``heads_shardable`` equal to the reference's ``pspec``;
* ``shard_tree``'s rows are the local shards the reference places on the
  devices of an 8-device mesh (bit for bit), ``unshard_tree`` gives the
  tree back bit for bit, and ``init_state(mesh=)`` is the sharded layout
  of the unsharded state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from repro.compat import abstract_mesh, make_mesh
from repro.compat import set_mesh as jset_mesh
from repro.configs import REGISTRY as JREGISTRY
from repro.configs import load_all as jload_all
from repro.models import pspec as jpspec
from repro.models import transformer as jtfm
from repro.optim import OptimConfig as JOptimConfig
from repro.serving.engine import pick_kv_chunks as jpick_kv_chunks
from repro.training import sharding as jshd
from repro.training.train_step import state_shapes as jstate_shapes

import torch

from repro_torch.configs import REGISTRY, get_config
from repro_torch.launch.mesh import (LogicalMesh, make_host_mesh,
                                     make_production_mesh,
                                     production_mesh_shape, set_mesh)
from repro_torch.models import pspec
from repro_torch.models import transformer as tfm
from repro_torch.optim import OptimConfig
from repro_torch.serving.engine import pick_kv_chunks
from repro_torch.training import init_state, state_shardings, state_shapes
from repro_torch.training import sharding as shd
from repro_torch.tree import leaves, leaves_with_paths

jload_all()
ALL = sorted(JREGISTRY)

JMESHES = {"single": abstract_mesh((16, 16), ("data", "model")),
           "multi": abstract_mesh((2, 16, 16), ("pod", "data", "model"))}
MESHES = {"single": make_production_mesh(),
          "multi": make_production_mesh(multi_pod=True)}


def printed(tree):
    """``(path, repr)`` of every spec of a port tree, in sorted-key order."""
    return [("/".join(map(str, p)), repr(s)) for p, s in
            leaves_with_paths(tree)]


def jprinted(tree):
    """The same for a reference tree of partition specs."""
    flat = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, JP))[0]
    return [("/".join(str(k.key) for k in path), repr(s))
            for path, s in flat]


def batch_shapes(cfg, b, s, port):
    """A training batch's shapes: meta tensors (port) or shape structs."""
    spec = {"labels": ((b, s), "int32"), "mask": ((b, s), "float32")}
    if cfg.frontend == "audio":
        spec["features"] = ((b, s, cfg.frontend_dim), "float32")
    else:
        spec["tokens"] = ((b, s), "int32")
    if port:
        return {k: torch.empty(sh, dtype=getattr(torch, dt), device="meta")
                for k, (sh, dt) in spec.items()}
    return {k: jax.ShapeDtypeStruct(sh, getattr(jnp, dt))
            for k, (sh, dt) in spec.items()}


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("name", ALL)
def test_specs_print_as_the_reference(name, mesh_name):
    jcfg, cfg = JREGISTRY[name], get_config(name)
    jmesh, mesh = JMESHES[mesh_name], MESHES[mesh_name]
    assert dict(jmesh.shape) == mesh.shape
    jopt = JOptimConfig(moment_dtype=jcfg.optimizer_dtype)
    opt = OptimConfig(moment_dtype=cfg.optimizer_dtype)
    jabs, abst = jstate_shapes(jcfg, jopt), state_shapes(cfg, opt)

    jp = jshd.param_specs(jcfg, jmesh, jabs["params"])
    p = shd.param_specs(cfg, mesh, abst["params"])
    assert printed(p) == jprinted(jp)
    assert printed(shd.opt_state_specs(cfg, mesh, abst["opt"], p)) \
        == jprinted(jshd.opt_state_specs(jcfg, jmesh, jabs["opt"], jp))
    specs, abstract = state_shardings(cfg, mesh, opt)
    assert printed(specs["params"]) == printed(p)
    assert all(t.device.type == "meta" for t in leaves(abstract))

    assert printed(shd.batch_specs(cfg, mesh, batch_shapes(cfg, 256, 512,
                                                           True))) \
        == jprinted(jshd.batch_specs(jcfg, jmesh, batch_shapes(
            jcfg, 256, 512, False)))
    if not cfg.causal:
        return                                  # an encoder has no cache
    spec = tfm.cache_spec(cfg, max_len=32768, kv_chunks=16)
    jspec = jtfm.cache_spec(jcfg, max_len=32768, kv_chunks=16)
    for b in (128, 1):
        assert printed(shd.cache_specs(
            cfg, mesh, tfm.cache_shapes(cfg, b, spec), b)) == jprinted(
            jshd.cache_specs(jcfg, jmesh, jtfm.cache_shapes(jcfg, b, jspec),
                             b))


@pytest.mark.parametrize("name", [n for n in ALL if n != "hubert_xlarge"])
def test_cache_shapes_match_the_reference(name):
    cfg, jcfg = get_config(name), JREGISTRY[name]
    for max_len, chunks in ((32768, 16), (100, 4)):
        got = tfm.cache_shapes(cfg, 8, tfm.cache_spec(cfg, max_len, chunks))
        want = jtfm.cache_shapes(jcfg, 8, jtfm.cache_spec(jcfg, max_len,
                                                          chunks))
        assert sorted(got) == sorted(want)
        for key in got:
            assert got[key].device.type == "meta"
            assert tuple(got[key].shape) == tuple(want[key].shape)
            assert str(got[key].dtype)[6:] == str(want[key].dtype)


def test_pick_kv_chunks_over_a_grid():
    cfg, jcfg = get_config("llama3_8b"), JREGISTRY["llama3_8b"]
    shapes = [((16, 16), ("data", "model")),
              ((2, 16, 16), ("pod", "data", "model")),
              ((2, 4), ("data", "model")), ((1, 8), ("data", "model")),
              ((4, 1), ("data", "model")), ((8,), ("model",))]
    cases = 0
    for shape, axes in shapes:
        jmesh = abstract_mesh(shape, axes)
        mesh = LogicalMesh(axes, shape)
        for b in (1, 2, 4, 6, 128):
            for max_len in (1, 7, 16, 100, 4096, 32768, 500000):
                assert pick_kv_chunks(cfg, mesh, b, max_len) \
                    == jpick_kv_chunks(jcfg, jmesh, b, max_len)
                cases += 1
    assert cases == 210


def test_safe_and_heads_shardable_match_pspec():
    jmesh = abstract_mesh((2, 4), ("data", "model"))
    mesh = make_host_mesh((2, 4), device="cpu")
    for shape, spec in (((8, 12), (pspec.DP, "model")),
                        ((6, 8, 3), (None, ("data", "model"), "model")),
                        ((3, 15), ("data", "model")),
                        ((4, 8), (("pod", "data"), None))):
        assert repr(pspec._safe(shape, spec, mesh)) \
            == repr(jpspec._safe(shape, JP(*spec), jmesh))
    assert pspec.heads_shardable(15)             # no ambient mesh
    with set_mesh(mesh), jset_mesh(make_mesh((2, 4), ("data", "model"))):
        for heads in (15, 16, 25, 32, 48):
            assert pspec.heads_shardable(heads) \
                == jpspec.heads_shardable(heads)


def test_meshes():
    for multi in (False, True):
        m = make_production_mesh(multi_pod=multi)
        shape, axes = production_mesh_shape(multi_pod=multi)
        assert (m.sizes, m.axis_names, m.session) == (shape, axes, None)
    host = make_host_mesh(device="cpu")
    assert host.shape == {"data": 1, "model": 4}
    assert host.session.num_devices == 4 and host.size == 4
    with pytest.raises(ValueError, match="session has 4 devices"):
        LogicalMesh(("data", "model"), (1, 8), host.session)


# -- the device-stacked layout --------------------------------------------------

def reduced_state(name, moment_dtype="float32"):
    cfg = get_config(name).reduced()
    opt = OptimConfig(moment_dtype=moment_dtype)
    g = torch.Generator().manual_seed(3)
    return cfg, opt, init_state(cfg, opt, generator=g, device="cpu")


@pytest.mark.parametrize("name,moments", [("llama3_8b", "float32"),
                                          ("mixtral_8x22b", "bfloat16"),
                                          ("kimi_k2_1t_a32b", "int8")])
def test_shard_tree_rows_are_the_reference_placement(name, moments):
    """Each row of ``shard_tree`` is the shard the reference puts on that
    device of a ``(2, 4)`` mesh of 8 CPU devices (row-major over the mesh
    axes), bit for bit; ``unshard_tree`` gives the tree back bit for bit."""
    cfg, opt, state = reduced_state(name, moments)
    jmesh = make_mesh((2, 4), ("data", "model"))
    mesh = make_host_mesh((2, 4), device="cpu")
    specs, _ = state_shardings(cfg, mesh, opt)
    stacked = shd.shard_tree(state, specs, mesh)
    back = shd.unshard_tree(stacked, specs, mesh)
    row_of = {dev.id: i for i, dev in enumerate(jmesh.devices.reshape(-1))}
    for (path, leaf), (_, spec), (_, rows), (_, again) in zip(
            leaves_with_paths(state), leaves_with_paths(specs),
            leaves_with_paths(stacked), leaves_with_paths(back)):
        assert torch.equal(again, leaf), path
        assert rows.shape[0] == 8, path
        src = leaf.float().numpy() if leaf.dtype == torch.bfloat16 \
            else leaf.numpy()
        placed = jax.device_put(jnp.asarray(src),
                                NamedSharding(jmesh, JP(*spec)))
        for shard in placed.addressable_shards:
            want = np.asarray(shard.data)
            got = rows[row_of[shard.device.id]]
            got = got.float().numpy() if got.dtype == torch.bfloat16 \
                else got.numpy()
            np.testing.assert_array_equal(got, want, err_msg=str(path))


def test_init_state_under_a_mesh_is_the_sharded_layout():
    cfg = get_config("mixtral_8x22b").reduced()
    opt = OptimConfig()
    mesh = make_host_mesh((1, 4), device="cpu")
    plain = init_state(cfg, opt, generator=torch.Generator().manual_seed(5),
                       device="cpu")
    sharded = init_state(cfg, opt, generator=torch.Generator().manual_seed(5),
                         device="cpu", mesh=mesh)
    specs, abstract = state_shardings(cfg, mesh, opt)
    assert [tuple(t.shape) for t in leaves(sharded)] == [
        (4,) + tuple(n // shd.axis_size(mesh, e) for n, e in zip(a.shape, s))
        for a, s in zip(leaves(abstract), leaves(specs))]
    for a, b in zip(leaves(shd.unshard_tree(sharded, specs, mesh)),
                    leaves(plain)):
        assert torch.equal(a, b)
    # on (1, 4) the experts split along one dim: views, not copies
    moe = sharded["params"]["layers"]["moe"]
    assert all(moe[k]._is_view() for k in ("w1", "w2", "w3"))
