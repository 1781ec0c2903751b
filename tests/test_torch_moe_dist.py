"""The expert-parallel MoE, the mesh and ``multipath_send_local`` against
the reference, on the CPU.

* ``moe_apply_dist`` on reduced Mixtral-8x22B's MoE (4 experts, top 2,
  swiglu) at a ``(data 2, model 4)`` mesh (expert parallelism, one expert
  a row) and at ``(1, 8)`` (expert-TP: 4 experts on 8 rows), capacity-
  bound and dropless, with and without FSDP's weight gather, against the
  reference's ``moe_apply_dist`` under its mesh on 8 CPU devices: float32
  atol 1e-5, aux loss rtol 1e-6. Its combine is one session psum a data
  index (``ring_allgather`` on the plain path here), its gradients equal
  the single-shard layer's, and without a model axis it declines.
* The port's train step under a ``(2, 4)`` mesh against the reference's
  unsharded step (``tests/test_sharding_data.py``'s tolerances: loss 2e-3,
  params 5e-3) and the port's own unsharded step; its decode under the
  mesh against the unsharded decode (2e-3), for llama3_8b, rwkv6_1_6b and
  (the case the mesh changes) mixtral_8x22b.
* ``multipath_send_local`` bit for bit against the reference's inside
  ``shard_map`` on 4 devices, for three schedules and two dtypes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.comm.engine import multipath_send_local as jsend_local
from repro.comm.planner import PathPlanner as JPathPlanner
from repro.compat import make_mesh, set_mesh as jset_mesh, shard_map
from repro.configs import get_config as jget_config
from repro.core import Topology as JTopology
from repro.models import moe as jmoe
from repro.models import moe_dist as jmoe_dist
from repro.models import transformer as jtfm
from repro.optim import OptimConfig as JOptimConfig
from repro.training import TrainStepConfig as JTrainStepConfig
from repro.training import init_state as jinit_state
from repro.training import make_train_step as jmake_train_step

from repro_torch.carry import params_from_numpy, state_from_numpy
from repro_torch.comm import PathPlanner, multipath_send_local
from repro_torch.configs import get_config
from repro_torch.core.topology import Topology
from repro_torch.kernels.ring_allgather import kernel as rk
from repro_torch.launch.mesh import make_host_mesh, set_mesh
from repro_torch.models import moe, moe_dist
from repro_torch.models import transformer as tfm
from repro_torch.optim import OptimConfig
from repro_torch.training import TrainStepConfig, make_train_step
from repro_torch.tree import leaves

ATOL = 1e-5


def expert_weights(seed=2):
    """Reduced Mixtral's MoE block: (reference params, port params)."""
    cfg = jget_config("mixtral_8x22b").reduced()
    jp = jmoe.moe_init(jax.random.key(seed), cfg.d_model, cfg.d_ff,
                       cfg.num_experts, cfg.mlp, 0, jnp.float32)
    return cfg, jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def tokens(seed, t, d):
    return np.random.RandomState(seed).randn(t, d).astype(np.float32)


MESHES = {"ep_2x4": (2, 4), "tp_1x8": (1, 8)}
MODES = {"capacity": dict(capacity_factor=1.25),
         "dropless": dict(dropless=True)}


@pytest.mark.parametrize("fsdp", [False, True], ids=["replicated", "fsdp"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_moe_apply_dist_matches_reference(mesh_name, mode, fsdp):
    cfg, jp, p = expert_weights()
    shape = MESHES[mesh_name]
    x = tokens(3, 64, cfg.d_model)
    jmesh = make_mesh(shape, ("data", "model"))
    kw = dict(top_k=cfg.top_k, kind=cfg.mlp, fsdp=fsdp, **MODES[mode])
    with jset_mesh(jmesh):
        want, jaux = jax.jit(lambda a, q: jmoe_dist.moe_apply_dist(
            a, q, **kw))(jnp.asarray(x), jp)
    mesh = make_host_mesh(shape, device="cpu")
    assert mesh.session.num_devices == shape[1]
    before = rk.LAUNCHES
    with set_mesh(mesh):
        got, aux = moe_dist.moe_apply_dist(torch.from_numpy(x), p, **kw)
    assert rk.LAUNCHES == before          # CPU: the ring's plain version
    assert got.shape == (64, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)
    if mode == "capacity":
        # the capacity bites: the dropless layer differs
        free, _ = moe.moe_apply(torch.from_numpy(x), p, top_k=cfg.top_k,
                                kind=cfg.mlp, dropless=True)
        assert not torch.allclose(got, free, atol=1e-3)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_combine_is_one_session_psum_a_data_index(mesh_name, monkeypatch):
    """Each data index's rows go through the mesh session's
    ``collectives.psum`` once, as ``(model, T / data, d)``; the ring's
    sum equals the plain sum of the rows' contributions."""
    cfg, _, p = expert_weights()
    data, model = MESHES[mesh_name]
    mesh = make_host_mesh((data, model), device="cpu")
    seen = []
    real = moe_dist.CombineFn.forward

    def spy(ctx, rows, collectives):
        assert collectives is mesh.session.collectives
        seen.append(tuple(rows.shape))
        out = real(ctx, rows, collectives)
        np.testing.assert_allclose(out[0].numpy(), rows.sum(0).numpy(),
                                   atol=1e-6, rtol=0)
        return out

    monkeypatch.setattr(moe_dist.CombineFn, "forward", staticmethod(spy))
    x = torch.from_numpy(tokens(4, 64, cfg.d_model))
    with set_mesh(mesh):
        moe_dist.moe_apply_dist(x, p, top_k=2, kind=cfg.mlp, dropless=True)
    assert seen == [(model, 64 // data, cfg.d_model)] * data


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_dropless_dist_equals_single_shard_with_grads(mesh_name):
    """Dropless, the expert-parallel layer is the single-shard layer
    summed another way: outputs, aux loss and every gradient (the
    combine's backward a psum of the cotangent rows) within 1e-5."""
    cfg, _, p = expert_weights()
    mesh = make_host_mesh(MESHES[mesh_name], device="cpu")
    x = torch.from_numpy(tokens(5, 64, cfg.d_model))
    g = torch.from_numpy(tokens(6, 64, cfg.d_model))

    def grads(fn):
        xs = x.clone().requires_grad_()
        ps = {k: v.clone().requires_grad_() for k, v in p.items()}
        out, aux = fn(xs, ps)
        got = torch.autograd.grad(
            (out * g).sum() + aux, [xs] + [ps[k] for k in sorted(ps)])
        return out.detach(), aux.detach(), got

    kw = dict(top_k=2, kind=cfg.mlp, dropless=True)
    want = grads(lambda a, q: moe.moe_apply(a, q, **kw))
    with set_mesh(mesh):
        got = grads(lambda a, q: moe_dist.moe_apply_dist(a, q, **kw))
    np.testing.assert_allclose(got[0].numpy(), want[0].numpy(), atol=ATOL)
    np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-6)
    for a, b in zip(got[2], want[2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(),
                                   atol=ATOL * max(1.0, float(
                                       b.abs().max())), rtol=0)


def test_dist_declines_without_a_model_axis():
    """No mesh, a model axis of 1, or tokens the data axes do not divide:
    None, and ``_ffn`` runs the single-shard layer."""
    cfg, _, p = expert_weights()
    x = torch.from_numpy(tokens(7, 6, cfg.d_model))
    kw = dict(top_k=2, kind=cfg.mlp)
    assert moe_dist.moe_apply_dist(x, p, **kw) is None
    with set_mesh(make_host_mesh((4, 1), device="cpu")):
        assert moe_dist.moe_apply_dist(x, p, **kw) is None
    with set_mesh(make_host_mesh((2, 4), device="cpu")):
        assert moe_dist.moe_apply_dist(x[:5], p, **kw) is None
        assert moe_dist.moe_apply_dist(x, p, **kw) is not None


# -- the model under a mesh ---------------------------------------------------

def carried(arch, **replace):
    jcfg = dataclasses.replace(jget_config(arch).reduced(), **replace)
    cfg = dataclasses.replace(get_config(arch).reduced(), **replace)
    jparams = jtfm.init_params(jax.random.key(0), jcfg)
    return jcfg, cfg, jparams, params_from_numpy(
        jax.tree.map(np.asarray, jparams))


@pytest.mark.parametrize("name", ["llama3_8b", "mixtral_8x22b"])
def test_train_step_under_mesh_matches_unsharded(name):
    """One step under a ``(2, 4)`` mesh (the MoE expert parallel, its
    combine differentiated through the ring) against the reference's
    unsharded jitted step at its sharded test's tolerances (loss 2e-3,
    params 5e-3), and against the port's own unsharded step (loss rtol
    1e-5, params atol 2e-5 / rtol 1e-4)."""
    jcfg = dataclasses.replace(jget_config(name).reduced(),
                               capacity_factor=8.0)
    cfg = dataclasses.replace(get_config(name).reduced(),
                              capacity_factor=8.0)
    jopt = JOptimConfig(learning_rate=1e-3, warmup_steps=1, total_steps=5)
    opt = OptimConfig(learning_rate=1e-3, warmup_steps=1, total_steps=5)
    rng = np.random.RandomState(2)
    batch = {"tokens": rng.randint(0, cfg.vocab_size, (4, 16)).astype(
                 np.int32),
             "labels": rng.randint(0, cfg.vocab_size, (4, 16)).astype(
                 np.int32),
             "mask": np.ones((4, 16), np.float32)}
    jstate = jinit_state(jcfg, jopt, seed=7)
    s_ref, m_ref = jax.jit(jmake_train_step(jcfg, JTrainStepConfig(), jopt))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    step = make_train_step(cfg, TrainStepConfig(), opt, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    s_one, m_one = step(state_from_numpy(jax.tree.map(np.asarray, jstate)),
                        tb)
    mesh = make_host_mesh((2, 4), device="cpu")
    with set_mesh(mesh):
        s_got, m_got = step(
            state_from_numpy(jax.tree.map(np.asarray, jstate)), tb)
    assert abs(float(m_got["loss"]) - float(m_ref["loss"])) < 2e-3
    np.testing.assert_allclose(float(m_got["loss"]), float(m_one["loss"]),
                               rtol=1e-5)
    for a, b, c in zip(jax.tree.leaves(s_ref["params"]),
                       leaves(s_got["params"]), leaves(s_one["params"])):
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), atol=5e-3)
        np.testing.assert_allclose(b.numpy(), c.numpy(), atol=2e-5,
                                   rtol=1e-4)


@pytest.mark.parametrize("name", ["llama3_8b", "rwkv6_1_6b",
                                  "mixtral_8x22b"])
def test_decode_step_under_mesh_matches_unsharded(name):
    """Eight decode steps under a ``(2, 4)`` mesh against the unsharded
    steps (the reference's sharded decode test: atol 2e-3), and the
    reference's unsharded logits (the same bound)."""
    jcfg, cfg, jparams, params = carried(name, capacity_factor=8.0)
    b, s = 4, 8
    toks = np.random.RandomState(1).randint(0, cfg.vocab_size, (b, s))
    jspec = jtfm.cache_spec(jcfg, max_len=s, kv_chunks=4)
    spec = tfm.cache_spec(cfg, max_len=s, kv_chunks=4)
    jcache = jtfm.init_cache(jcfg, b, jspec)
    cache_ref = tfm.init_cache(cfg, b, spec, device="cpu")
    cache = tfm.init_cache(cfg, b, spec, device="cpu")
    mesh = make_host_mesh((2, 4), device="cpu")
    for t in range(s):
        tok = toks[:, t:t + 1].astype(np.int32)
        want, jcache = jtfm.decode_step(jparams, jcfg, jcache,
                                        jnp.asarray(tok), jnp.int32(t),
                                        jspec)
        ref, _ = tfm.decode_step(params, cfg, cache_ref,
                                 torch.from_numpy(tok), t, spec)
        with set_mesh(mesh):
            got, _ = tfm.decode_step(params, cfg, cache,
                                     torch.from_numpy(tok), t, spec)
        np.testing.assert_allclose(got.float().numpy(),
                                   ref.float().numpy(), atol=2e-3)
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=2e-3)


# -- multipath_send_local ------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("schedule", ["round_robin", "depth_first",
                                      "critical_path"])
def test_multipath_send_local_matches_reference_under_shard_map(schedule,
                                                                dtype):
    """A 3-path, 4-chunk plan 0 → 2 run by the reference's
    ``multipath_send_local`` inside ``shard_map`` on 4 devices and by the
    port's on the stacked ``(4, n)`` operand: bit for bit (the message on
    row 2, zeros elsewhere)."""
    n = 4099
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    isz = jnp.dtype(jdt).itemsize
    jtopo, topo = JTopology.full_mesh(4), Topology.full_mesh(4)
    kw = dict(granularity=isz, max_paths=3, num_chunks=4,
              include_host=False)
    jplan = JPathPlanner(jtopo, multipath_threshold=0).plan(0, 2, n * isz,
                                                            **kw)
    plan = PathPlanner(topo, multipath_threshold=0).plan(0, 2, n * isz, **kw)
    assert len(plan.paths) == 3
    x = np.random.RandomState(8).randn(4, n).astype(np.float32)
    xj = jnp.asarray(x, jdt)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:4]), ("dev",))
    fn = shard_map(lambda a: jsend_local(a, jplan, schedule=schedule,
                                         topology=jtopo),
                   mesh=mesh, in_specs=JP("dev"), out_specs=JP("dev"))
    want = np.asarray(jax.jit(fn)(xj).astype(jnp.float32))
    xt = torch.from_numpy(x).to(tdt)
    got = multipath_send_local(xt, plan, schedule=schedule, topology=topo)
    assert got.shape == (4, n) and got.dtype == tdt
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert torch.equal(got[2], xt[0])
    assert not got[[0, 1, 3]].any()
    again = multipath_send_local(xt * 2, plan, schedule=schedule,
                                 topology=topo)
    assert torch.equal(got[2], xt[0])           # a new tensor each call
    assert torch.equal(again[2], xt[0] * 2)
