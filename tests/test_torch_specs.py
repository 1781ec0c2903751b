"""The port's dry-run input specs against the reference's, on the CPU.

For every registered arch × non-skipped shape × both production meshes
(the reference's ``abstract_mesh`` shapes of
``tests/test_sharding_data.py``), ``input_specs`` gives the reference's
cell: every argument leaf's shape, dtype and partition spec, leaf for
leaf, and the description, equal. The port's arguments are meta tensors
(nothing allocated) beside a parallel tree of specs.
"""

import jax
import pytest
from jax.sharding import PartitionSpec as JP

from repro.compat import abstract_mesh
from repro.configs import REGISTRY as JREGISTRY
from repro.configs import load_all as jload_all
from repro.configs.shapes import SHAPES as JSHAPES
from repro.launch import specs as jspecs

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES, skip_reason
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_production_mesh

jload_all()
JMESHES = {"single": abstract_mesh((16, 16), ("data", "model")),
           "multi": abstract_mesh((2, 16, 16), ("pod", "data", "model"))}
MESHES = {"single": make_production_mesh(),
          "multi": make_production_mesh(multi_pod=True)}
CELLS = [(a, s) for a in sorted(JREGISTRY) for s in SHAPES
         if skip_reason(get_config(a), SHAPES[s]) is None]


def jleaves(cell):
    """(shape, dtype name, printed spec) of the reference's arguments."""
    flat = jax.tree_util.tree_flatten(cell.abstract_args)[0]
    return [(tuple(x.shape), str(x.dtype),
             None if x.sharding is None else repr(x.sharding.spec))
            for x in flat]


def leaves(cell):
    return [(tuple(t.shape), str(t.dtype)[6:],
             None if s is None else repr(s))
            for t, s in specs.leaf_specs(cell.abstract_args, cell.specs)]


@pytest.mark.parametrize("mesh_name", ["single", "multi"])
@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_the_reference(arch, shape, mesh_name):
    want = jspecs.input_specs(JREGISTRY[arch], JSHAPES[shape],
                              JMESHES[mesh_name])
    got = specs.input_specs(get_config(arch), SHAPES[shape],
                            MESHES[mesh_name])
    assert got.kind == want.kind == SHAPES[shape].kind
    assert got.description == want.description
    assert leaves(got) == jleaves(want)
    assert all(t.device.type == "meta"
               for t, _ in specs.leaf_specs(got.abstract_args, got.specs))
    assert all(isinstance(s, tuple) or s is None
               for _, s in specs.leaf_specs(got.abstract_args, got.specs))


def test_batch_abstract_and_optim_for_equal_the_reference():
    for name in sorted(JREGISTRY):
        cfg, jcfg = get_config(name), JREGISTRY[name]
        assert specs.optim_for(cfg).moment_dtype == \
            jspecs.optim_for(jcfg).moment_dtype
        tensors, sp = specs.batch_abstract(cfg, SHAPES["train_4k"],
                                           MESHES["multi"], seq_len=64,
                                           batch=4)
        want = jspecs.batch_abstract(jcfg, JSHAPES["train_4k"],
                                     JMESHES["multi"], seq_len=64, batch=4)
        assert sorted(tensors) == sorted(want) == sorted(sp)
        for key, t in tensors.items():
            assert tuple(t.shape) == tuple(want[key].shape)
            assert str(t.dtype)[6:] == str(want[key].dtype)
            assert repr(sp[key]) == repr(want[key].sharding.spec)
            assert isinstance(want[key].sharding.spec, JP)


def test_shard_bytes_divide_by_the_named_axes():
    mesh = MESHES["multi"]
    cell = specs.input_specs(get_config("llama3_8b"), SHAPES["train_4k"],
                             mesh)
    pairs = dict(((tuple(t.shape), repr(s)), (t, s)) for t, s in
                 specs.leaf_specs(cell.abstract_args, cell.specs))
    t, s = pairs[((256, 4096), "PartitionSpec(('pod', 'data'), None)")]
    assert specs.shard_bytes(t, s, mesh) == 256 * 4096 * 4 / 32
    embed = cell.abstract_args[0]["params"]["embed"]
    espec = cell.specs[0]["params"]["embed"]
    assert repr(espec) == "PartitionSpec('model', 'data')"
    assert specs.shard_bytes(embed, espec, mesh) == \
        embed.numel() * 2 / (16 * 16)
    assert specs.shard_bytes(embed, None, mesh) == embed.numel() * 2
