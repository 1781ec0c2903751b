"""The port's GPipe pipeline against the reference's.

The reference's ``pipeline_apply`` runs under ``shard_map`` over a
``pipe`` axis of 4 (or 2) CPU devices; the port's runs the same schedule
on the stage-stacked state, with no session (``torch.roll`` shifts) and
with a CPU session (one ``exchange`` a tick). The tanh stage of the
reference's ``tests/test_sharding_data.py`` must equal the reference
within atol 1e-6 and sequential application within its 1e-5; the handoff
with a session must deliver what the shifts deliver, bit for bit; a
reduced Llama-3's block stack in 4 stages must equal sequential
``block_apply``, bit for bit.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training.pipeline import pipeline_apply as jpipeline_apply

from repro_torch.comm import CommConfig, CommSession
from repro_torch.configs import get_config
from repro_torch.core.topology import Topology
from repro_torch.models import transformer as tfm
from repro_torch.training.pipeline import (_pipeline_surfaced,
                                           block_stages,
                                           make_block_stage_fn,
                                           pipeline_apply,
                                           send_next_stage)

M, MB, D = 6, 3, 8


def session(threshold=64):
    """A CPU session over the 4-GPU full mesh whose planner stripes
    messages from ``threshold`` bytes on."""
    return CommSession(CommConfig(multipath_threshold=threshold),
                       device="cpu", topology=Topology.full_mesh(4))


@functools.lru_cache(maxsize=None)
def reference_tanh(n_stages, multipath):
    """The reference's pipeline on the tanh stage (compiled once per
    case: a session and no session share it)."""
    w, x = tanh_case(n_stages)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n_stages]), ("pipe",))
    return np.asarray(jpipeline_apply(
        lambda wl, h: jnp.tanh(h @ wl), jnp.asarray(w), jnp.asarray(x),
        mesh, microbatches=M, multipath=multipath))


def tanh_case(n_stages):
    rng = np.random.RandomState(0)
    w = rng.randn(n_stages, D, D).astype(np.float32) * np.float32(0.3)
    x = rng.randn(M, MB, D).astype(np.float32)
    return w, x


@pytest.mark.parametrize("with_session", [False, True])
@pytest.mark.parametrize("multipath", [False, True])
@pytest.mark.parametrize("n_stages", [4, 2])
def test_tanh_pipeline_equals_reference_and_sequential(n_stages, multipath,
                                                       with_session):
    w, x = tanh_case(n_stages)
    want = reference_tanh(n_stages, multipath)
    sess = session() if with_session else None
    got = pipeline_apply(lambda wl, h: torch.tanh(h @ wl),
                         torch.from_numpy(w), torch.from_numpy(x),
                         microbatches=M, multipath=multipath, session=sess)
    assert got.shape == (M, MB, D)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    seq = torch.from_numpy(x)
    for i in range(n_stages):
        seq = torch.tanh(seq @ torch.from_numpy(w[i]))
    np.testing.assert_allclose(got.numpy(), seq.numpy(), atol=1e-5, rtol=0)
    if sess is not None:
        # one exchange a tick: M + P - 1 dispatches
        assert sess.stats()["dispatches"] == M + n_stages - 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_stages", [4, 3, 2])
def test_send_next_stage_session_equals_shifts(n_stages, dtype):
    """Each path's delivery is row i → row (i+1) % P, bit for bit; the
    shifts' halves and the planner's split give the same tensor."""
    h = torch.from_numpy(np.random.RandomState(n_stages).randn(
        n_stages, 5, 64).astype(np.float32)).to(dtype)
    want = torch.roll(h, 1, dims=0)
    for multipath in (False, True):
        assert torch.equal(send_next_stage(h, n_stages,
                                           multipath=multipath), want)
        sess = session()
        got = send_next_stage(h, n_stages, multipath=multipath,
                              session=sess)
        assert torch.equal(got, want)
        assert sess.stats()["dispatches"] == 1


def test_session_handoff_takes_the_planners_split():
    """With a session, ``multipath`` leaves the path count to the
    planner (more than one path here) and ``multipath=False`` sends on
    one; fewer than 3 stages send direct either way."""
    h = torch.randn(4, 1 << 20)       # 4 MiB a stage: worth striping
    paths = {}
    for multipath in (False, True):
        sess = session()
        send_next_stage(h, 4, multipath=multipath, session=sess)
        (entry,) = [e for _, e in sess.engine._fastpath._store.values()]
        paths[multipath] = [len(p.paths) for p in entry.plans]
    assert paths[False] == [1, 1, 1, 1]
    assert min(paths[True]) > 1
    sess = session()
    send_next_stage(h[:2], 2, multipath=True, session=sess)
    (entry,) = [e for _, e in sess.engine._fastpath._store.values()]
    assert [len(p.paths) for p in entry.plans] == [1, 1]


def test_surfaced_rows_equal_and_validation():
    w, x = tanh_case(4)
    sess = session()
    out = _pipeline_surfaced(lambda wl, h: torch.tanh(h @ wl),
                             torch.from_numpy(w), torch.from_numpy(x),
                             microbatches=M, multipath=True, session=sess)
    assert out.shape == (4, M, MB, D)
    for i in range(1, 4):
        assert torch.equal(out[i], out[0])
    with pytest.raises(ValueError, match="microbatches"):
        pipeline_apply(lambda wl, h: h, torch.from_numpy(w),
                       torch.from_numpy(x), microbatches=M + 1)
    with pytest.raises(ValueError, match="stacked over"):
        send_next_stage(torch.zeros(3, 4), 4)


def llama(num_layers, dtype):
    cfg = dataclasses.replace(get_config("llama3_8b").reduced(),
                              num_layers=num_layers, dtype=dtype)
    params = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    return cfg, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("multipath", [False, True])
def test_block_pipeline_bitwise_equals_sequential_block_apply(multipath,
                                                              dtype):
    """A reduced Llama-3 of 8 layers in 4 stages of 2: every microbatch
    bit for bit as sequential ``block_apply`` over the 8 layers, through
    the shifts and through a session."""
    cfg, params = llama(8, dtype)
    m, s = 3, 12
    x = (torch.from_numpy(np.random.RandomState(1).randn(
        m, 1, s, cfg.d_model).astype(np.float32))
        .to(tfm._dtype(cfg)))
    positions = torch.arange(s)
    seq = []
    for mb in range(m):
        h = x[mb]
        for i in range(cfg.num_layers):
            h, _ = tfm.block_apply(h, tfm.layer_params(params, i), cfg,
                                   -1, positions)
        seq.append(h)
    seq = torch.stack(seq)
    stage_fn = make_block_stage_fn(cfg, 4, positions)
    stages = block_stages(params, 4)
    assert stages["attn"]["wq"].shape[:2] == (4, 2)
    for sess in (None, session()):
        with torch.no_grad():
            got = pipeline_apply(stage_fn, stages, x, microbatches=m,
                                 multipath=multipath, session=sess)
        assert torch.equal(got, seq)
        if sess is not None:
            assert sess.stats()["dispatches"] == m + 4 - 1


def test_block_stages_validation():
    cfg, params = llama(6, "float32")
    with pytest.raises(ValueError, match="do not split"):
        block_stages(params, 4)
    gemma = dataclasses.replace(get_config("gemma3_27b").reduced(),
                                num_layers=2 * 6)
    windows = tfm.layer_windows(gemma)
    assert windows[:6] == windows[6:] and windows[:3] != windows[3:6]
    make_block_stage_fn(gemma, 2, torch.arange(4))      # 6 and 6 repeat
    with pytest.raises(ValueError, match="do not repeat"):
        make_block_stage_fn(gemma, 4, torch.arange(4))  # 3 and 3 do not
