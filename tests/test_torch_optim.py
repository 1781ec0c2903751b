"""The port's AdamW against the reference's, on the CPU.

The same numpy parameters, gradients and moments go through
``repro.optim`` and ``repro_torch.optim``. Both compute in float32 with
the same formulas, so the schedule and the global norm agree to float32
rounding (rtol 1e-6) and one update's parameters within atol 1e-6. int8
moments are re-quantized each step: a quantized value may land one code
apart where the float32 moment sits on a rounding boundary, so ``q`` is
held within 1 and its scale at rtol 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import OptimConfig as JOptimConfig
from repro.optim import adamw as jadamw

from repro_torch.carry import state_from_numpy
from repro_torch.optim import (OptimConfig, apply_updates, global_norm,
                               init_opt_state, lr_schedule, opt_state_shapes)
from repro_torch.tree import leaves, leaves_with_paths, tree_map

CONFIGS = [dict(), dict(learning_rate=1e-3, warmup_steps=3, total_steps=20),
           dict(warmup_steps=0, total_steps=5, min_lr_ratio=0.0)]


def tree(seed, zero_size=False):
    rs = np.random.RandomState(seed)
    t = {"embed": rs.randn(16, 8).astype(np.float32),
         "layers": {"w1": rs.randn(2, 8, 12).astype(np.float32),
                    "ln": (rs.randn(2, 8) * 0.1).astype(np.float32)},
         "head": rs.randn(8, 16).astype(np.float32)}
    if zero_size:
        t["layers"]["empty"] = np.zeros((0, 4), np.float32)
    return t


def to_torch(t):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), t)


@pytest.mark.parametrize("kw", CONFIGS)
def test_lr_schedule(kw):
    jcfg, cfg = JOptimConfig(**kw), OptimConfig(**kw)
    steps = np.arange(0, cfg.total_steps + 5, dtype=np.int32)
    want = np.asarray(jadamw.lr_schedule(jcfg, jnp.asarray(steps)))
    got = lr_schedule(cfg, torch.from_numpy(steps)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 300.0])
def test_global_norm(scale):
    g = tree_map(lambda a: a * scale, tree(5, zero_size=True))
    want = float(jadamw.global_norm(jax.tree.map(jnp.asarray, g)))
    got = float(global_norm(to_torch(g)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_init_opt_state_matches_the_reference():
    p = tree(0, zero_size=True)
    for md in ("float32", "bfloat16", "int8"):
        jst = jadamw.init_opt_state(jax.tree.map(jnp.asarray, p),
                                    JOptimConfig(moment_dtype=md))
        st = init_opt_state(to_torch(p), OptimConfig(moment_dtype=md))
        jl = jax.tree_util.tree_flatten_with_path(jst)[0]
        tl = list(leaves_with_paths(st))
        assert len(jl) == len(tl)
        for (jpath, ja), (path, ta) in zip(jl, tl):
            assert tuple(k.key for k in jpath) == path
            assert tuple(ja.shape) == tuple(ta.shape)
            assert str(ja.dtype) == str(ta.dtype).removeprefix("torch.")
            assert np.array_equal(np.asarray(ja, np.float32),
                                  ta.float().numpy())
        meta = opt_state_shapes(to_torch(p), OptimConfig(moment_dtype=md))
        assert all(t.device.type == "meta" for t in leaves(meta))


def run_updates(md, grad_scale, steps, zero_size=False):
    """``steps`` AdamW updates on both packages from the same numpy
    parameters and gradients; returns (reference state, params, metrics),
    (port ...)."""
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
              moment_dtype=md)
    jcfg, cfg = JOptimConfig(**kw), OptimConfig(**kw)
    p = tree(0, zero_size)
    jp = jax.tree.map(jnp.asarray, p)
    jst = jadamw.init_opt_state(jp, jcfg)
    tp = to_torch(p)
    st = init_opt_state(tp, cfg)
    for s in range(steps):
        g = tree_map(lambda a: a * grad_scale, tree(10 + s, zero_size))
        jp, jst, jm = jadamw.apply_updates(jp, jax.tree.map(jnp.asarray, g),
                                           jst, jcfg)
        tp, st, m = apply_updates(tp, to_torch(g), st, cfg)
    return (jp, jst, jm), (tp, st, m)


@pytest.mark.parametrize("md", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("grad_scale", [1e-2, 10.0])   # 10.0: clipped
def test_apply_updates(md, grad_scale):
    (jp, jst, jm), (tp, st, m) = run_updates(md, grad_scale, 3,
                                             zero_size=True)
    for k in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)
    if grad_scale > 1:
        assert float(jm["grad_norm"]) > OptimConfig().clip_norm
    for a, b in zip(jax.tree.leaves(jp), leaves(tp)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), atol=1e-6,
                                   rtol=0)
    assert int(st["step"]) == int(jst["step"]) == 3
    assert st["step"].dtype == torch.int32
    jflat = jax.tree_util.tree_flatten_with_path({"m": jst["m"],
                                                  "v": jst["v"]})[0]
    tflat = list(leaves_with_paths({"m": st["m"], "v": st["v"]}))
    for (jpath, ja), (path, ta) in zip(jflat, tflat):
        assert tuple(k.key for k in jpath) == path
        ja = np.asarray(ja)
        if path[-1] == "q":
            assert ta.dtype == torch.int8
            assert np.abs(ta.numpy().astype(np.int32)
                          - ja.astype(np.int32)).max(initial=0) <= 1
        elif path[-1] == "scale":
            np.testing.assert_allclose(ta.numpy(), ja, rtol=1e-6)
        else:
            np.testing.assert_allclose(ta.float().numpy(),
                                       ja.astype(np.float32), atol=1e-6,
                                       rtol=1e-6 if md == "float32"
                                       else 1e-2)


def test_int8_codec_rounds_half_to_even():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 127.0])
    q = jadamw._quantize(jnp.asarray(x.numpy()))
    from repro_torch.optim.adamw import _dequantize, _quantize
    tq = _quantize(x)
    assert np.array_equal(tq["q"].numpy(), np.asarray(q["q"]))
    np.testing.assert_allclose(_dequantize(tq).numpy(),
                               np.asarray(jadamw._dequantize(q)), rtol=1e-6)


def test_zero_size_leaf_quantizes_to_an_empty_code():
    from repro_torch.optim.adamw import _quantize
    q = _quantize(torch.zeros((0, 4)))
    assert q["q"].shape == (0, 4) and float(q["scale"]) == 1.0


def test_state_from_numpy_carries_a_reference_state():
    (jp, jst, _), _ = run_updates("int8", 1.0, 1)
    st = state_from_numpy(jax.tree.map(np.asarray, {"params": jp,
                                                    "opt": jst}))
    assert st["opt"]["step"].dtype == torch.int32
    assert int(st["opt"]["step"]) == 1
    for a, b in zip(jax.tree.leaves({"params": jp, "opt": jst}),
                    leaves(st)):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_large_leaves_update_slice_by_slice_bitwise(moment_dtype,
                                                    monkeypatch):
    """A leaf larger than ``UPDATE_SLICE`` is updated a slice at a time
    (float32 and bfloat16 moments; int8 keeps the whole leaf for its
    absmax): the new parameters and moments are bitwise those of the
    whole-leaf update."""
    from repro_torch.optim import adamw
    rng = np.random.RandomState(7)

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(
            dtype)

    params = {"a": t(3, 1000, dtype=torch.bfloat16), "b": t(77)}
    grads = {"a": t(3, 1000, dtype=torch.bfloat16), "b": t(77)}
    cfg = OptimConfig(moment_dtype=moment_dtype, warmup_steps=1)
    state = init_opt_state(params, cfg)
    for key in ("m", "v"):
        state[key] = {k: adamw._moment_write(t(*p.shape).abs(),
                                             moment_dtype)
                      for k, p in params.items()}
    whole = apply_updates(params, grads, state, cfg)
    monkeypatch.setattr(adamw, "UPDATE_SLICE", 128)
    sliced = apply_updates(params, grads, state, cfg)
    def flat(out):
        return leaves({"params": out[0], "opt": out[1]})

    for x, y in zip(flat(whole), flat(sliced)):
        assert x.dtype == y.dtype and torch.equal(x, y)
