"""The port's transformer against the reference's, on reduced configs.

Reduced ``llama3_8b``, ``smollm_360m`` (15 heads at full size),
``gemma3_27b`` (local/global windows, GeGLU), ``rwkv6_1_6b`` (RWKV-6
time-mix, squared-ReLU MLP, a recurrent-state cache), ``hymba_1_5b``
(attention beside Mamba, a sliding window: a ring cache beside the SSM
state and conv inputs), ``mixtral_8x22b`` (MoE, top-2 of 4 at reduced
size, a sliding window) and ``kimi_k2_1t_a32b`` (MoE with a shared
expert, full attention), float32. The reference draws the weights
(``init_params``); ``params_from_numpy`` carries them into the port, so
both sides compute with the same numbers. ``forward`` (logits and the
MoE auxiliary loss), ``prefill_forward`` (logits and cache) and 4
``decode_step`` calls agree within atol 1e-4: the same float32
arithmetic, summed in another order. A sliding-window variant exercises
the ring cache; the window-8 models' 10-token prompts overflow it. ``decode_step``
takes its position as an int or a 0-d tensor, bit-equal, and the jitted
reference step agrees. On the CPU the RWKV-6 scan is the kernel's plain
version, in the reference's chunks of 128. All ten configurations equal
the reference's. The audio encoder (reduced ``hubert_xlarge`` with its
head dim of 80 put back: ``frontend_proj`` on float32 features,
non-causal attention, ``head``) agrees with the reference's ``forward``
and ``loss_fn`` within the same atol; it has no decode step, and the
decode path refuses it with the reference's reason.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as JREGISTRY
from repro.configs import load_all as jload_all
from repro.models import transformer as jtfm

from repro_torch.carry import cache_from_numpy, params_from_numpy
from repro_torch.configs import REGISTRY, get_config, load_all
from repro_torch.models import transformer as tfm
from repro_torch.tree import leaves

jload_all()
load_all()

NAMES = ["llama3_8b", "smollm_360m", "gemma3_27b", "rwkv6_1_6b",
         "hymba_1_5b", "mixtral_8x22b", "kimi_k2_1t_a32b"]
#: Every configuration the port registers: the reference's ten.
CONFIGS = NAMES + ["nemotron_4_340b", "chameleon_34b", "hubert_xlarge"]
ATOL = 1e-4


def to_numpy(tree):
    return jax.tree.map(np.asarray, tree)


def swa(cfg):
    return dataclasses.replace(cfg, attention="swa", window=8)


def config(name, variant):
    jcfg = JREGISTRY[name].reduced()
    cfg = get_config(name).reduced()
    if variant == "swa":
        jcfg, cfg = swa(jcfg), swa(cfg)
    return jcfg, cfg


@pytest.fixture(scope="module", params=[(n, "base") for n in NAMES]
                + [("llama3_8b", "swa")], ids=lambda p: "-".join(p))
def model(request):
    """(reference config, port config, reference params, port params)."""
    jcfg, cfg = config(*request.param)
    jparams = jtfm.init_params(jax.random.key(1), jcfg)
    return jcfg, cfg, jparams, params_from_numpy(to_numpy(jparams))


def tokens(seed, b, s, vocab):
    return np.random.RandomState(seed).randint(0, vocab, (b, s))


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_configs_equal_the_reference():
    assert sorted(load_all()) == sorted(CONFIGS)
    for name in CONFIGS:
        ours, ref = REGISTRY[name], JREGISTRY[name]
        assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
        assert ours.param_count() == ref.param_count()
        assert dataclasses.asdict(ours.reduced()) == \
            dataclasses.asdict(ref.reduced())
        assert tfm.layer_windows(ours) == list(
            np.asarray(jtfm.layer_windows(ref)))
    assert get_config("llama3-8b") is REGISTRY["llama3_8b"]
    assert get_config("hubert-xlarge") is REGISTRY["hubert_xlarge"]
    with pytest.raises(KeyError, match="unknown arch"):
        get_config("hubert_large")


def test_forward(model):
    jcfg, cfg, jparams, params = model
    toks = tokens(2, 2, 12, cfg.vocab_size)
    want, jaux = jtfm.forward(jparams, jcfg, {"tokens": jnp.asarray(toks)})
    got, aux = tfm.forward(params, cfg, {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 12, cfg.vocab_size)
    close(got, want)
    close(aux, jaux)
    if not cfg.num_experts:
        assert float(aux) == float(jaux) == 0.0


def test_prefill_then_decode(model):
    jcfg, cfg, jparams, params = model
    b, sp, steps = 2, 10, 4
    toks = tokens(3, b, sp + steps, cfg.vocab_size)
    jspec = jtfm.cache_spec(jcfg, max_len=16, kv_chunks=4)
    spec = tfm.cache_spec(cfg, max_len=16, kv_chunks=4)
    assert dataclasses.asdict(spec) == dataclasses.asdict(jspec)
    want, jcache = jtfm.prefill_forward(
        jparams, jcfg, {"tokens": jnp.asarray(toks[:, :sp])}, jspec)
    got, cache = tfm.prefill_forward(
        params, cfg, {"tokens": torch.from_numpy(toks[:, :sp])}, spec)
    close(got, want)
    assert sorted(cache) == sorted(jcache) == {
        "ssm": ["rwkv_shift", "rwkv_state"],
        "hybrid": ["conv", "k", "ssm", "v"]}.get(cfg.family, ["k", "v"])
    for key in cache:
        assert cache[key].shape == jcache[key].shape
        close(cache[key], jcache[key])
    for t in range(sp, sp + steps):
        want, jcache = jtfm.decode_step(
            jparams, jcfg, jcache, jnp.asarray(toks[:, t:t + 1]),
            jnp.int32(t), jspec)
        got, same = tfm.decode_step(params, cfg, cache,
                                    torch.from_numpy(toks[:, t:t + 1]), t,
                                    spec)
        assert same is cache                     # updated in place
        close(got, want)
    for key in cache:
        close(cache[key], jcache[key])


def test_decode_from_a_carried_cache(model):
    """A reference cache carried with ``cache_from_numpy`` decodes to the
    reference's logits (positions past the ring's wrap included)."""
    jcfg, cfg, jparams, params = model
    jspec = jtfm.cache_spec(jcfg, max_len=16, kv_chunks=4)
    spec = tfm.cache_spec(cfg, max_len=16, kv_chunks=4)
    toks = tokens(4, 1, 12, cfg.vocab_size)
    _, jcache = jtfm.prefill_forward(
        jparams, jcfg, {"tokens": jnp.asarray(toks[:, :11])}, jspec)
    cache = cache_from_numpy(to_numpy(jcache))
    want, _ = jtfm.decode_step(jparams, jcfg, jcache,
                               jnp.asarray(toks[:, 11:]), jnp.int32(11),
                               jspec)
    got, _ = tfm.decode_step(params, cfg, cache, torch.from_numpy(
        toks[:, 11:]), 11, spec)
    close(got, want)


def test_decode_step_takes_cur_len_as_a_tensor(model):
    """``cur_len`` as a 0-d int64 tensor gives the int form's logits and
    cache bit for bit, and the jitted reference step's within ATOL, at
    positions 10-13: past the ring's wrap (window 8) and across a chunk
    boundary (chunks of 4)."""
    jcfg, cfg, jparams, params = model
    b, sp, steps = 2, 10, 4
    toks = tokens(5, b, sp + steps, cfg.vocab_size)
    jspec = jtfm.cache_spec(jcfg, max_len=16, kv_chunks=4)
    spec = tfm.cache_spec(cfg, max_len=16, kv_chunks=4)
    jstep = jax.jit(lambda p, c, t, n: jtfm.decode_step(p, jcfg, c, t, n,
                                                        jspec))
    _, jcache = jtfm.prefill_forward(
        jparams, jcfg, {"tokens": jnp.asarray(toks[:, :sp])}, jspec)
    _, as_int = tfm.prefill_forward(
        params, cfg, {"tokens": torch.from_numpy(toks[:, :sp])}, spec)
    as_tensor = {k: t.clone() for k, t in as_int.items()}
    for t in range(sp, sp + steps):
        tok = torch.from_numpy(toks[:, t:t + 1])
        want, jcache = jstep(jparams, jcache, jnp.asarray(toks[:, t:t + 1]),
                             jnp.int32(t))
        got_int, _ = tfm.decode_step(params, cfg, as_int, tok, t, spec)
        got, _ = tfm.decode_step(params, cfg, as_tensor, tok,
                                 torch.tensor(t), spec)
        assert torch.equal(got, got_int)
        close(got, want)
    for key in as_int:
        assert torch.equal(as_tensor[key], as_int[key])
        close(as_tensor[key], jcache[key])


def test_prefill_fills_a_given_cache(model):
    """``prefill_forward(cache=...)`` writes every entry of a used cache
    in place: the same logits and cache as a prefill into a new one."""
    _, cfg, _, params = model
    spec = tfm.cache_spec(cfg, max_len=16, kv_chunks=4)
    batch = {"tokens": torch.from_numpy(tokens(6, 2, 9, cfg.vocab_size))}
    want, fresh = tfm.prefill_forward(params, cfg, batch, spec)
    used = {k: torch.full_like(t, 3.0) for k, t in fresh.items()}
    got, same = tfm.prefill_forward(params, cfg, batch, spec, cache=used)
    assert same is used
    assert torch.equal(got, want)
    for key in fresh:
        assert torch.equal(used[key], fresh[key])


def test_init_params_shapes_dtypes_and_scales():
    cfg = get_config("llama3_8b").reduced()
    params = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    ref = jax.eval_shape(lambda k: jtfm.init_params(k, JREGISTRY[
        "llama3_8b"].reduced()), jax.random.key(0))
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    for path, leaf in flat:
        t = params
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), path
    assert float(params["layers"]["ln1"].abs().max()) == 0.0
    assert abs(params["embed"].std().item() - 64 ** -0.5) < 0.01
    bf = dataclasses.replace(cfg, dtype="bfloat16")
    pb = tfm.init_params(bf, generator=torch.Generator().manual_seed(0))
    assert pb["layers"]["mlp"]["w1"].dtype == torch.bfloat16
    assert pb["final_norm"].dtype == torch.float32


@pytest.mark.parametrize("arch,change,match", [
    pytest.param("llama3_8b", {"family": "audio", "frontend": "audio",
                               "causal": False},
                 "encoder-only", id="change3-audio")])
def test_unported_families_raise(arch, change, match):
    """The audio family is ported: its parameters draw, with
    ``frontend_proj`` and ``head``. What an encoder lacks is a decode step:
    the cache, prefill and decode refuse it, with the reference's reason
    (``configs/shapes.py``'s skip rule)."""
    cfg = dataclasses.replace(get_config(arch).reduced(), **change)
    params = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    assert "frontend_proj" in params and "head" in params
    assert "lm_head" not in params
    with pytest.raises(ValueError, match=match):
        tfm.init_cache(cfg, 1, tfm.CacheSpec("chunked", 8, 2))
    feats = {"features": torch.zeros((1, 4, cfg.frontend_dim))}
    with pytest.raises(ValueError, match=match):
        tfm.prefill_forward(params, cfg, feats, tfm.CacheSpec("chunked", 8,
                                                              2))
    with pytest.raises(ValueError, match=match):
        tfm.decode_step(params, cfg, {}, torch.zeros((1, 1), dtype=torch.long),
                        0, tfm.CacheSpec("chunked", 8, 2))


@pytest.mark.parametrize("name", ["hymba_1_5b", "mixtral_8x22b",
                                  "kimi_k2_1t_a32b"])
def test_new_families_init_like_the_reference(name):
    """The hybrid and MoE blocks' parameters have the reference's tree,
    shapes and dtypes (the router and Mamba's ``dt_bias``/``A_log``/``D``
    float32 in a bfloat16 model), and ``params_from_numpy`` carries the
    reference's drawn leaves across with those dtypes."""
    cfg = dataclasses.replace(get_config(name).reduced(), dtype="bfloat16")
    jcfg = dataclasses.replace(JREGISTRY[name].reduced(), dtype="bfloat16")
    ours = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    ref = jtfm.init_params(jax.random.key(0), jcfg)
    carried = params_from_numpy(to_numpy(ref))
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        t, c = ours, carried
        for p in path:
            t, c = t[p.key], c[p.key]
        assert tuple(t.shape) == leaf.shape == tuple(c.shape), path
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype) == \
            str(c.dtype).removeprefix("torch."), path
    layers = ours["layers"]
    if cfg.family == "hybrid":
        assert {k: layers["ssm"][k].dtype for k in ("dt_bias", "A_log", "D")
                } == dict.fromkeys(("dt_bias", "A_log", "D"), torch.float32)
        assert layers["ssm"]["w_in"].dtype == torch.bfloat16
    else:
        assert layers["moe"]["router"].dtype == torch.float32
        assert layers["moe"]["w1"].dtype == torch.bfloat16
        assert ("shared" in layers["moe"]) == bool(cfg.num_shared_experts)
    assert tfm.param_shapes(cfg)["layers"].keys() == layers.keys()


def hubert():
    """Reduced HuBERT-XLarge with its head dim of 80 put back, its
    reference twin, and the reference's weights carried across."""
    jcfg = dataclasses.replace(JREGISTRY["hubert_xlarge"].reduced(),
                               head_dim=80)
    cfg = dataclasses.replace(get_config("hubert_xlarge").reduced(),
                              head_dim=80)
    jparams = jtfm.init_params(jax.random.key(4), jcfg)
    return jcfg, cfg, jparams, params_from_numpy(to_numpy(jparams))


def features(seed, b, s, dim):
    return np.random.RandomState(seed).randn(b, s, dim).astype(np.float32)


def test_hubert_forward_and_loss_match_the_reference():
    """The audio encoder's ``forward`` (features through ``frontend_proj``,
    non-causal attention at head dim 80, ``head``) and ``loss_fn`` against
    the reference's on the same features: logits within atol 1e-4, the
    loss within rtol 1e-5, no auxiliary loss."""
    jcfg, cfg, jparams, params = hubert()
    assert (cfg.family, cfg.frontend, cfg.causal, cfg.head_dim_) == (
        "audio", "audio", False, 80)
    feats = features(5, 2, 12, cfg.frontend_dim)
    labels = np.random.RandomState(6).randint(0, cfg.vocab_size, (2, 12))
    want, jaux = jtfm.forward(jparams, jcfg,
                              {"features": jnp.asarray(feats)})
    got, aux = tfm.forward(params, cfg, {"features": torch.from_numpy(feats)})
    assert got.shape == (2, 12, cfg.vocab_size)
    close(got, want)
    assert float(aux) == float(jaux) == 0.0
    mask = np.ones((2, 12), np.float32)
    mask[0, 7:] = 0.0
    jbatch = {"features": jnp.asarray(feats), "labels": jnp.asarray(labels),
              "mask": jnp.asarray(mask)}
    batch = {"features": torch.from_numpy(feats),
             "labels": torch.from_numpy(labels),
             "mask": torch.from_numpy(mask)}
    np.testing.assert_allclose(float(tfm.loss_fn(params, cfg, batch)),
                               float(jtfm.loss_fn(jparams, jcfg, jbatch)),
                               rtol=1e-5)


def test_hubert_init_params_like_the_reference():
    """The audio encoder's parameters have the reference's tree, shapes
    and dtypes in bfloat16 (``frontend_proj`` ``(frontend_dim, d)`` and
    ``head``, no ``lm_head``), ``frontend_proj`` drawn at
    ``frontend_dim**-0.5``; the full config draws the reference's
    ``param_count`` (945,788,160 in all) beside ``frontend_proj`` and the
    encoder's ``head``, which ``param_count`` leaves out."""
    cfg = dataclasses.replace(get_config("hubert_xlarge").reduced(),
                              dtype="bfloat16", frontend_dim=256)
    jcfg = dataclasses.replace(JREGISTRY["hubert_xlarge"].reduced(),
                               dtype="bfloat16", frontend_dim=256)
    ours = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    ref = jax.eval_shape(lambda k: jtfm.init_params(k, jcfg),
                         jax.random.key(0))
    for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]:
        t = ours
        for p in path:
            t = t[p.key]
        assert tuple(t.shape) == leaf.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), path
    assert sorted(ours) == sorted(ref) == [
        "embed", "final_norm", "frontend_proj", "head", "layers"]
    proj = ours["frontend_proj"].float()
    assert abs(proj.std().item() - 256 ** -0.5) < 0.1 * 256 ** -0.5
    full = get_config("hubert_xlarge")
    shapes = tfm.param_shapes(full)
    count = sum(t.numel() for t in leaves(shapes))
    assert count == (full.param_count() + full.frontend_dim * full.d_model
                     + full.d_model * full.vocab_size) == 945_788_160
