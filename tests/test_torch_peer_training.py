"""The training side on a peer session against the stacked session and
the reference.

``CommSession(devices=["cpu"] * 4)`` holds one replica of the train state
a logical device (``replicate_state``), one stage of a pipeline a device
(``place_stages``) and one member's gradient leaf a device. The same
seeded inputs go through the stacked port session, the peer session and
the reference on a mesh of 4 CPU devices:

* the eager DP step: every replica bit for bit the stacked step's state,
  and the metrics equal, over three chained steps (reduced SmolLM-360M
  and RWKV-6, microbatches 1 and 2, the state given as one tree and as a
  list); within ``tests/test_torch_train_step.py``'s tolerances of the
  reference's ``make_dp_train_step`` (loss and grad norm rtol 1e-5,
  params atol 2e-5 / rtol 1e-4);
* the captured DP step: every replica bit for bit the stacked step's
  state over three chained steps, each replica fed back its own outputs
  and the stacked step its own state; every row of the stacked program
  equal; the stacked step's digest and ``GroupKey``; one dispatch a
  call; within the same tolerances of the reference's
  ``make_captured_dp_train_step``; a peer session of 3 devices refused;
* a replicated step input given as a per-device list, staged device by
  device, and a list with a wrong device or shape refused;
* ``compressed_psum``, ``compressed_psum_tree`` and
  ``compressed_psum_with_feedback`` on per-device lists: bit for bit the
  stacked rows, and within 1e-6 of the mean's max of the reference's
  under ``shard_map`` (as ``tests/test_torch_compression.py``);
* the tanh pipeline and a reduced Llama-3's block pipeline with a stage a
  device: bit for bit the stacked session's, the striped tanh one within
  atol 1e-6 of the reference's (as ``tests/test_torch_pipeline.py``), one
  exchange dispatch a tick and one for the surfacing psum.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.comm import CommSession as JCommSession
from repro.compat import shard_map
from repro.configs import get_config as jget_config
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticDataset as JSyntheticDataset
from repro.optim import OptimConfig as JOptimConfig
from repro.optim import compression as jcomp
from repro.training import TrainStepConfig as JTrainStepConfig
from repro.training import init_state as jinit_state
from repro.training import make_captured_dp_train_step as jmake_captured
from repro.training import make_dp_train_step as jmake_dp
from repro.training.pipeline import pipeline_apply as jpipeline_apply

from repro_torch.carry import state_from_numpy
from repro_torch.comm import CommConfig, CommSession
from repro_torch.comm.capture import PeerStepProgram, captured_psum
from repro_torch.comm.engine import PlacedKey
from repro_torch.configs import get_config
from repro_torch.core.topology import Topology
from repro_torch.models import transformer as tfm
from repro_torch.optim import OptimConfig
from repro_torch.optim import compression as comp
from repro_torch.training import (TrainStepConfig, make_captured_dp_train_step,
                                  make_dp_train_step, replicate_state)
from repro_torch.training.train_step import _bits_digest
from repro_torch.training.pipeline import (block_stages, make_block_stage_fn,
                                           pipeline_apply, place_stages)
from repro_torch.tree import leaves

N = 4
CPU4 = ["cpu"] * N
OPT = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)


@pytest.fixture(scope="module")
def jmesh4():
    return jax.sharding.Mesh(np.array(jax.devices()[:N]), ("dev",))


def states(arch):
    """(reference config, port config, reference optimizer, port
    optimizer, reference state, port state) of ``arch`` reduced to 2
    narrow layers, the port's state carried across from the reference's
    seed."""
    jcfg, cfg = jget_config(arch).reduced(), get_config(arch).reduced()
    jopt, opt = JOptimConfig(**OPT), OptimConfig(**OPT)
    jstate = jinit_state(jcfg, jopt)
    state = state_from_numpy(jax.tree.map(np.asarray, jstate))
    return jcfg, cfg, jopt, opt, jstate, state


def batch_np(cfg, step):
    return JSyntheticDataset(cfg, JDataConfig(12, 8)).batch_at(step)


def tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def assert_bitwise(got, want, what):
    a, b = leaves(got), leaves(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), what


def assert_close_to_reference(jstate, state):
    for a, b in zip(jax.tree.leaves(jstate["params"]),
                    leaves(state["params"])):
        np.testing.assert_allclose(b.float().numpy(),
                                   np.asarray(a, np.float32), atol=2e-5,
                                   rtol=1e-4)
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"])


def assert_metrics_close(m, jm):
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)


# -- the eager DP step -------------------------------------------------------

@pytest.mark.parametrize("arch,microbatches", [("smollm_360m", 1),
                                                ("rwkv6_1_6b", 2)])
def test_eager_dp_step_on_peers_bitwise_stacked(arch, microbatches):
    _, cfg, _, opt, _, state = states(arch)
    ts = TrainStepConfig(microbatches)
    stacked = make_dp_train_step(cfg, ts, opt, CommSession(device="cpu"))
    peer_sess = CommSession(devices=CPU4)
    peer = make_dp_train_step(cfg, ts, opt, peer_sess)
    one, reps = state, state
    for s in range(3):
        batch = tb(batch_np(cfg, s))
        # step 1 takes the stacked state replicated, the others go on
        # from the replicas (step 0's one tree replicated inside)
        reps, pm = peer(reps if s != 1 else replicate_state(one, peer_sess),
                        batch)
        one, m = stacked(one, batch)
        assert isinstance(reps, list) and len(reps) == N
        for d, rep in enumerate(reps):
            assert_bitwise(rep, one, f"step {s} replica {d}")
        assert m.keys() == pm.keys()
        assert all(torch.equal(m[k], pm[k]) for k in m)


def test_eager_dp_step_on_peers_matches_the_reference(jmesh4):
    jcfg, cfg, jopt, opt, jstate, state = states("smollm_360m")
    jstep = jax.jit(jmake_dp(jcfg, JTrainStepConfig(), jopt,
                             JCommSession(mesh=jmesh4)))
    sess = CommSession(devices=CPU4)
    step = make_dp_train_step(cfg, TrainStepConfig(), opt, sess)
    reps = replicate_state(state, sess)
    assert [leaves(r)[0].data_ptr() for r in reps] != [
        leaves(state)[0].data_ptr()] * N
    for s in range(2):
        batch = batch_np(jcfg, s)
        jstate, jm = jstep(jstate, jb(batch))
        reps, m = step(reps, tb(batch))
        assert_metrics_close(m, jm)
        for rep in reps:
            assert_close_to_reference(jstate, rep)


def test_eager_dp_step_on_peers_refuses_a_short_state_list():
    _, cfg, _, opt, _, state = states("smollm_360m")
    sess = CommSession(devices=CPU4)
    step = make_dp_train_step(cfg, TrainStepConfig(), opt, sess)
    with pytest.raises(ValueError, match="one state a logical device"):
        step(replicate_state(state, sess)[:2], tb(batch_np(cfg, 0)))


# -- the tree-ordered psum and the means' digest -----------------------------

@pytest.mark.parametrize("n", [2, 4, 8])
def test_tree_psum_gives_every_device_the_same_bits(n):
    """``captured_psum(..., tree=True)``: every row of the sum has the
    same bits (at 4 devices ``(x0 + x2) + (x1 + x3)``), on a peer session
    too, where the ring order's rows differ."""
    x = torch.from_numpy(np.random.default_rng(n).standard_normal(
        (n, 999)).astype(np.float32))

    def build(cap, tree):
        return captured_psum(cap, cap.input((999,), torch.float32), n,
                             name="tsum" if tree else "rsum", tree=tree)

    topo = Topology.full_mesh(n, with_host=True)
    stacked = CommSession(device="cpu", topology=topo)
    (out,) = stacked.capture(lambda cap: build(cap, True))(x)
    for d in range(1, n):
        assert torch.equal(out[d], out[0])
    np.testing.assert_allclose(out[0].numpy(), x.sum(0).numpy(), rtol=0,
                               atol=1e-5)
    if n == 4:
        assert torch.equal(out[0], (x[0] + x[2]) + (x[1] + x[3]))
        (ring,) = stacked.capture(lambda cap: build(cap, False))(x)
        assert not all(torch.equal(ring[d], ring[0]) for d in range(1, n))
        peer = CommSession(devices=CPU4)
        (got,) = peer.capture(lambda cap: build(cap, True))(
            list(x.unbind(0)))
        for d in range(n):
            assert torch.equal(got[d], out[d])


def test_tree_psum_needs_a_power_of_two():
    sess = CommSession(device="cpu",
                       topology=Topology.full_mesh(3, with_host=True))
    with pytest.raises(ValueError, match="power-of-two"):
        sess.capture(lambda cap: captured_psum(
            cap, cap.input((8,), torch.float32), 3, tree=True))


def test_bits_digest_sees_changes_that_cancel_in_a_plain_sum():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        100_000).astype(np.float32))
    bits = x.view(torch.int32).clone()
    bits[7] += 1
    bits[70_001] -= 1
    y = bits.view(torch.float32)
    assert not torch.equal(x, y)
    assert torch.sum(x.view(torch.int32), dtype=torch.int64) == torch.sum(
        y.view(torch.int32), dtype=torch.int64)
    assert not torch.equal(_bits_digest(x), _bits_digest(y))
    assert torch.equal(_bits_digest(x), _bits_digest(x.clone()))
    assert torch.equal(_bits_digest(x.to(torch.bfloat16)),
                       _bits_digest(x.to(torch.bfloat16)))


# -- the captured DP step ----------------------------------------------------

@pytest.mark.parametrize("arch,microbatches,given", [
    ("smollm_360m", 1, "tree"), ("rwkv6_1_6b", 2, "list")])
def test_captured_dp_step_on_peers_bitwise_stacked(arch, microbatches,
                                                   given):
    """Three chained steps: the stacked step fed its own state, the peer
    step its own replicas. Every replica is the stacked state bit for bit
    after every step (the tree-ordered psum gives every device the same
    mean), so the replicas never drift apart."""
    _, cfg, _, opt, _, state = states(arch)
    ts = TrainStepConfig(microbatches)
    batch0 = tb(batch_np(cfg, 0))
    ssess, psess = CommSession(device="cpu"), CommSession(devices=CPU4)
    stacked = make_captured_dp_train_step(cfg, ts, opt, ssess, state, batch0)
    peer = make_captured_dp_train_step(cfg, ts, opt, psess, state, batch0)
    one = state
    reps = state if given == "tree" else replicate_state(state, psess)
    for s in range(3):
        batch = tb(batch_np(cfg, s))
        before = psess.stats()["dispatches"]
        reps, m = peer(reps, batch)
        assert psess.stats()["dispatches"] == before + 1
        one, m1 = stacked(one, batch)
        assert isinstance(reps, list) and len(reps) == N
        for d in range(N):
            assert_bitwise(reps[d], one, f"step {s} replica {d}")
        assert m.keys() == m1.keys()
        assert all(torch.equal(m[k], m1[k]) for k in m)
    a, b = stacked.capture.resolve(), peer.capture.resolve()
    assert (b.digest, b.key) == (a.digest, a.key)
    assert isinstance(b.compiled.program, PeerStepProgram)
    assert b.compiled.key == PlacedKey(a.key, ("cpu",) * N)


def test_stacked_captured_dp_step_rows_agree():
    """Every row of the stacked program's new state has the same bits: the
    state the step returns is every replica's, not row 0's alone."""
    _, cfg, _, opt, _, state = states("smollm_360m")
    batch = tb(batch_np(cfg, 0))
    step = make_captured_dp_train_step(cfg, TrainStepConfig(), opt,
                                       CommSession(device="cpu"), state,
                                       batch)
    step(state, batch)
    outs = step.capture.resolve().compiled.program.outputs()
    for o in outs:
        for d in range(1, N):
            assert torch.equal(o[d], o[0])


def test_captured_dp_step_on_peers_needs_a_power_of_two():
    _, cfg, _, opt, _, state = states("smollm_360m")
    batch = tb(batch_np(cfg, 0))
    with pytest.raises(ValueError, match="power-of-two"):
        make_captured_dp_train_step(cfg, TrainStepConfig(), opt,
                                    CommSession(devices=["cpu"] * 3), state,
                                    batch)


def test_captured_dp_step_on_peers_matches_the_reference(jmesh4):
    jcfg, cfg, jopt, opt, jstate, state = states("smollm_360m")
    batch = batch_np(jcfg, 0)
    jsess, sess = JCommSession(mesh=jmesh4), CommSession(devices=CPU4)
    jstep = jmake_captured(jcfg, JTrainStepConfig(), jopt, jsess, jstate,
                           jb(batch))
    step = make_captured_dp_train_step(cfg, TrainStepConfig(), opt, sess,
                                       state, tb(batch))
    reps = state
    for s in range(2):
        batch = batch_np(jcfg, s)
        jstate, jm = jstep(jstate, jb(batch))
        reps, m = step(reps, tb(batch))
        assert sess.stats()["dispatches"] == s + 1
        assert_metrics_close(m, jm)
        for rep in reps:
            assert_close_to_reference(jstate, rep)
    jentry = next(iter(jsess.engine._fastpath._store.values()))[1]
    assert step.capture.resolve().graph.digest() == jentry.graph.digest()


# -- replicated inputs given per device ---------------------------------------

def test_a_replicated_input_as_a_list_is_staged_device_by_device():
    """A replicated input given as a list puts tensor d in device d's
    arena only (the kernel sees each device's own copy); a bare tensor is
    copied to every device. A list with a wrong device or a wrong shape
    raises ``ValueError``."""
    sess = CommSession(devices=CPU4)

    def build(cap):
        w = cap.input((3,), torch.float32, replicated=True)
        x = cap.input((3,), torch.float32)
        return cap.kernel(lambda a, b: a * b, w, x, name="scale")

    step = sess.capture(build)
    xs = [torch.full((3,), 1.0 + d) for d in range(N)]
    ws = [torch.full((3,), 10.0 * d) for d in range(N)]
    (out,) = step(ws, xs)
    assert [o.tolist() for o in out] == [[10.0 * d * (1 + d)] * 3
                                         for d in range(N)]
    (out,) = step(torch.full((3,), 2.0), xs)
    assert [o.tolist() for o in out] == [[2.0 * (1 + d)] * 3
                                         for d in range(N)]
    arenas = step.resolve().compiled.program.arenas
    assert len({a.data_ptr() for a in arenas}) == N
    bad_device = ws[:3] + [torch.empty((3,), device="meta")]
    with pytest.raises(ValueError, match="devices\\[d\\]"):
        step(bad_device, xs)
    with pytest.raises(ValueError, match="shape"):
        step(ws[:3] + [torch.zeros(4)], xs)
    with pytest.raises(ValueError, match="shape"):
        step(ws[:3], xs)
    assert sess.stats()["dispatches"] == 2


# -- the compressed mean -----------------------------------------------------

def grads(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).randn(N, *shape) * scale
            ).astype(np.float32)


def shard(fn, mesh, n_in, n_out):
    spec = P("dev")
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec,) * n_in,
                             out_specs=spec if n_out == 1 else (spec,) * n_out,
                             check_vma=False))


def close(got, want, rel=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * (np.abs(want).max() + 1e-30))


def rows_of(g):
    return [torch.from_numpy(r.copy()) for r in g]


def assert_rows_bitwise(peer, stacked):
    assert len(peer) == N
    for p, s in zip(peer, stacked.unbind(0)):
        assert p.dtype == s.dtype and torch.equal(p, s)


@pytest.mark.parametrize("shape", [(256,), (3, 5), (1,), (2, 3, 4)])
def test_compressed_psum_on_peers(jmesh4, shape):
    g = grads(1, shape)
    want = shard(lambda v: jcomp.compressed_psum(v[0], "dev")[None],
                 jmesh4, 1, 1)(g)
    stacked = comp.compressed_psum(torch.from_numpy(g),
                                   CommSession(device="cpu"))
    sess = CommSession(devices=CPU4)
    got = comp.compressed_psum(rows_of(g), sess)
    assert_rows_bitwise(got, stacked)
    close(torch.stack(got).numpy(), np.asarray(want))
    assert sess.stats()["dispatches"] == 1
    gb = rows_of(g)
    got = comp.compressed_psum([x.to(torch.bfloat16) for x in gb], sess)
    assert_rows_bitwise(got, comp.compressed_psum(
        torch.from_numpy(g).to(torch.bfloat16), CommSession(device="cpu")))


def test_compressed_psum_tree_on_peers(jmesh4):
    tree = {"w": grads(2, (4, 6)), "b": {"x": grads(3, (5,)),
                                         "y": grads(4, (2, 2, 3))}}

    def body(w, x, y):
        out = jcomp.compressed_psum_tree(
            {"w": w[0], "b": {"x": x[0], "y": y[0]}}, "dev")
        return out["w"][None], out["b"]["x"][None], out["b"]["y"][None]

    jw, jx, jy = shard(body, jmesh4, 3, 3)(tree["w"], tree["b"]["x"],
                                           tree["b"]["y"])
    stacked = comp.compressed_psum_tree(
        {"w": torch.from_numpy(tree["w"]),
         "b": {"x": torch.from_numpy(tree["b"]["x"]),
               "y": torch.from_numpy(tree["b"]["y"])}},
        CommSession(device="cpu"))
    members = [{"w": torch.from_numpy(tree["w"][d].copy()),
                "b": {"x": torch.from_numpy(tree["b"]["x"][d].copy()),
                      "y": torch.from_numpy(tree["b"]["y"][d].copy())}}
               for d in range(N)]
    got = comp.compressed_psum_tree(members, CommSession(devices=CPU4))
    assert len(got) == N
    for d, member in enumerate(got):
        assert_bitwise(member, {"w": stacked["w"][d],
                                "b": {"x": stacked["b"]["x"][d],
                                      "y": stacked["b"]["y"][d]}},
                       f"member {d}")
    close(torch.stack([m["w"] for m in got]).numpy(), np.asarray(jw))
    close(torch.stack([m["b"]["x"] for m in got]).numpy(), np.asarray(jx))
    close(torch.stack([m["b"]["y"] for m in got]).numpy(), np.asarray(jy))


@pytest.mark.parametrize("shape", [(128,), (6, 10)])
def test_compressed_psum_with_feedback_on_peers(jmesh4, shape):
    g, res = grads(5, shape, 0.1), grads(6, shape, 1e-3)

    def body(v, r):
        out, nr = jcomp.compressed_psum_with_feedback(v[0], r[0], "dev")
        return out[None], nr[None]

    jout, jres = shard(body, jmesh4, 2, 2)(g, res)
    out_s, res_s = comp.compressed_psum_with_feedback(
        torch.from_numpy(g), torch.from_numpy(res), CommSession(device="cpu"))
    out, new_res = comp.compressed_psum_with_feedback(
        rows_of(g), rows_of(res), CommSession(devices=CPU4))
    assert_rows_bitwise(out, out_s)
    assert_rows_bitwise(new_res, res_s)
    close(torch.stack(out).numpy(), np.asarray(jout))
    # the residual within 1e-6 of the quantized target, as the stacked
    # form's (tests/test_torch_compression.py says why not bitwise)
    target = torch.from_numpy(g) + torch.from_numpy(res)
    np.testing.assert_allclose(torch.stack(new_res).numpy(),
                               np.asarray(jres), rtol=0,
                               atol=1e-6 * target.abs().max().item())


# -- the pipeline ------------------------------------------------------------

M, MB, D = 6, 3, 8


def session(**where):
    return CommSession(CommConfig(multipath_threshold=64), **where)


@pytest.mark.parametrize("multipath", [False, True])
def test_tanh_pipeline_on_peers(multipath):
    """Bit for bit the stacked session's pipeline; with the striped
    handoff also within atol 1e-6 of the reference's (compiled once: the
    direct handoff's reference is held in ``tests/test_torch_pipeline.py``
    to the stacked session's, which this one equals)."""
    rng = np.random.RandomState(0)
    w = rng.randn(N, D, D).astype(np.float32) * np.float32(0.3)
    x = rng.randn(M, MB, D).astype(np.float32)

    def fn(wl, h):
        return torch.tanh(h @ wl)

    stacked = pipeline_apply(fn, torch.from_numpy(w), torch.from_numpy(x),
                             microbatches=M, multipath=multipath,
                             session=session(device="cpu"))
    sess = session(devices=CPU4)
    stages = place_stages(torch.from_numpy(w), sess)
    assert len(stages) == N and torch.equal(stages[2], torch.from_numpy(w[2]))
    got = pipeline_apply(fn, stages, torch.from_numpy(x), microbatches=M,
                         multipath=multipath, session=sess)
    assert torch.equal(got, stacked)
    if multipath:
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:N]), ("pipe",))
        want = np.asarray(jpipeline_apply(
            lambda wl, h: jnp.tanh(h @ wl), jnp.asarray(w), jnp.asarray(x),
            mesh, microbatches=M, multipath=True))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # one exchange a tick, and the surfacing psum
    assert sess.stats()["dispatches"] == M + N - 1 + 1


def test_block_pipeline_on_peers_bitwise_stacked():
    """A reduced Llama-3 of 8 layers in 4 stages of 2 (``block_stages``
    placed a stage a device): bit for bit the stacked session's pipeline
    and sequential ``block_apply``."""
    cfg = dataclasses.replace(get_config("llama3_8b").reduced(),
                              num_layers=8)
    params = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    m, s = 3, 12
    x = torch.from_numpy(np.random.RandomState(1).randn(
        m, 1, s, cfg.d_model).astype(np.float32))
    positions = torch.arange(s)
    stage_fn = make_block_stage_fn(cfg, N, positions)
    stages = block_stages(params, N)
    sess = session(devices=CPU4)
    with torch.no_grad():
        stacked = pipeline_apply(stage_fn, stages, x, microbatches=m,
                                 multipath=True, session=session(
                                     device="cpu"))
        got = pipeline_apply(stage_fn, stages, x, microbatches=m,
                             multipath=True, session=sess)
        seq = []
        for mb in range(m):
            h = x[mb]
            for i in range(cfg.num_layers):
                h, _ = tfm.block_apply(h, tfm.layer_params(params, i), cfg,
                                       -1, positions)
            seq.append(h)
    assert torch.equal(got, stacked)
    assert torch.equal(got, torch.stack(seq))
    assert sess.stats()["dispatches"] == m + N - 1 + 1


def test_place_stages_refuses_a_stage_count_off_the_session():
    with pytest.raises(ValueError, match="stages for a session"):
        place_stages(torch.zeros(3, 2, 2), CommSession(devices=CPU4))
