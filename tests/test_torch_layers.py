"""The port's model layers against the reference's, forward only.

Each function gets the same numpy inputs (float32, from a seed) on both
sides. The reference's einsums and the port's run the same sums in
another order, so results agree to float32 rounding: atol 1e-5 (1e-6 for
the elementwise functions). ``blockwise_attention`` is checked with
``Sk > block_k`` so the plain blockwise loop runs, with and without a
window, and right-aligned ``Sq < Sk``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl

from repro_torch.models import layers as tl


def arr(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def both(a):
    return jnp.asarray(a), torch.from_numpy(a.copy())


def close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0)


def test_rms_norm():
    jx, tx = both(arr(0, 3, 5, 64))
    jw, tw = both(arr(1, 64, scale=0.1))
    close(tl.rms_norm(tx, tw), jl.rms_norm(jx, jw), 1e-6)


def test_rms_norm_bf16_keeps_the_dtype_rules():
    """Statistics in float32, product in bfloat16: the same bits up to one
    rounding of the statistics."""
    x = arr(2, 4, 64)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    jw, tw = both(arr(3, 64, scale=0.1))
    got = tl.rms_norm(tx, tw)
    assert got.dtype == torch.bfloat16
    want = np.asarray(jl.rms_norm(jx, jw), np.float32)
    assert np.max(np.abs(got.float().numpy() - want)) <= 2e-2


@pytest.mark.parametrize("hd,theta", [(16, 10_000.0), (128, 500_000.0)])
def test_rope(hd, theta):
    close(tl.rope_frequencies(hd, theta), jl.rope_frequencies(hd, theta),
          1e-6)
    jx, tx = both(arr(4, 2, 3, 12, hd))
    pos = np.arange(12)
    close(tl.apply_rope(tx, torch.from_numpy(pos), theta),
          jl.apply_rope(jx, jnp.asarray(pos), theta), 1e-5)
    one = np.full((1,), 37)
    jq, tq = both(arr(5, 2, 3, 1, hd))
    close(tl.apply_rope(tq, torch.from_numpy(one), theta),
          jl.apply_rope(jq, jnp.asarray(one), theta), 1e-5)


@pytest.mark.parametrize("window", [-1, 0, 3])
@pytest.mark.parametrize("causal", [True, False])
def test_window_mask(window, causal):
    row = np.arange(7)[:, None] + 2
    col = np.arange(9)[None, :]
    got = tl._window_mask(torch.from_numpy(row), torch.from_numpy(col),
                          window, causal)
    want = jl._window_mask(jnp.asarray(row), jnp.asarray(col),
                           jnp.asarray(window), causal)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def attn_inputs(seed, b, hq, hkv, sq, sk, hd):
    return (both(arr(seed, b, hq, sq, hd, scale=0.5)),
            both(arr(seed + 1, b, hkv, sk, hd, scale=0.5)),
            both(arr(seed + 2, b, hkv, sk, hd)))


@pytest.mark.parametrize("window", [None, 4])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(12, 12), (5, 12)])
def test_naive_attention(window, causal, sq, sk):
    (jq, tq), (jk, tk), (jv, tv) = attn_inputs(6, 2, 4, 2, sq, sk, 16)
    close(tl.naive_attention(tq, tk, tv, causal=causal, window=window,
                             scale=0.25),
          jl.naive_attention(jq, jk, jv, causal=causal, window=window,
                             scale=0.25), 1e-5)


@pytest.mark.parametrize("window", [None, -1, 7, 20])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk,block_k", [(40, 40, 16), (40, 40, 64),
                                           (9, 40, 16), (33, 33, 8)])
def test_blockwise_attention(window, causal, sq, sk, block_k):
    (jq, tq), (jk, tk), (jv, tv) = attn_inputs(7, 1, 4, 2, sq, sk, 16)
    got = tl.blockwise_attention(tq, tk, tv, causal=causal, window=window,
                                 scale=0.25, block_k=block_k)
    want = jl.blockwise_attention(jq, jk, jv, causal=causal, window=window,
                                  scale=0.25, block_k=block_k)
    close(got, want, 1e-5)


@pytest.mark.parametrize("window", [None, 5])
@pytest.mark.parametrize("cur_len", [1, 6, 13, 16])
def test_chunked_decode_attention(window, cur_len):
    jq, tq = both(arr(8, 2, 4, 16, scale=0.5))
    jk, tk = both(arr(9, 2, 2, 4, 4, 16, scale=0.5))
    jv, tv = both(arr(10, 2, 2, 4, 4, 16))
    got = tl.chunked_decode_attention(tq, tk, tv, cur_len, window=window,
                                      scale=0.25)
    want = jl.chunked_decode_attention(jq, jk, jv, jnp.int32(cur_len),
                                       window=window, scale=0.25)
    close(got, want, 1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "relu2"])
def test_mlp_apply(kind):
    jx, tx = both(arr(11, 3, 5, 32))
    params = {"w1": arr(12, 32, 48, scale=32 ** -0.5),
              "w2": arr(13, 48, 32, scale=48 ** -0.5)}
    if kind in ("swiglu", "geglu"):
        params["w3"] = arr(14, 32, 48, scale=32 ** -0.5)
    got = tl.mlp_apply(tx, {k: torch.from_numpy(v)
                            for k, v in params.items()}, kind)
    want = jl.mlp_apply(jx, {k: jnp.asarray(v) for k, v in params.items()},
                        kind)
    close(got, want, 1e-5)


def test_mlp_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown mlp kind"):
        tl.mlp_apply(torch.zeros(2, 4), {"w1": torch.zeros(4, 8),
                                         "w2": torch.zeros(8, 4)}, "tanh")


@pytest.mark.parametrize("kind", ["swiglu", "relu2"])
def test_mlp_init_shapes_and_scales(kind):
    p = tl.mlp_init(256, 1024, kind, torch.float32,
                    generator=torch.Generator().manual_seed(0),
                    device="cpu", lead=(2,))
    assert sorted(p) == (["w1", "w2", "w3"] if kind == "swiglu"
                         else ["w1", "w2"])
    assert p["w1"].shape == (2, 256, 1024) and p["w2"].shape == (2, 1024,
                                                                  256)
    assert abs(p["w1"].std().item() / 256 ** -0.5 - 1) < 0.05
    assert abs(p["w2"].std().item() / 1024 ** -0.5 - 1) < 0.05
