"""The port's MoE block against the reference's ``models/moe.py``.

The reference draws the weights (``moe_init``) at a reduced width (d 16 or
32, 4 or 8 experts); ``params_from_numpy`` carries them into the port, so
both sides compute with the same numbers on the same seeded numpy tokens.
``moe_apply``'s output and auxiliary loss agree within atol 1e-4 in
float32 (the same arithmetic summed in another order): dropless, at the
default capacity factor, and at the tight capacity of the reference's
``test_moe_capacity_drops`` (factor 0.25), where the same pairs fall past
capacity (the stable sort) and their tokens lose those experts' outputs;
every MLP kind; with a shared expert (kimi's recipe); at odd token counts.
The combine is deterministic (no atomics): two calls agree bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe

from repro_torch.carry import params_from_numpy
from repro_torch.models import moe

ATOL = 1e-4


def weights(d, ff, e, kind, shared, seed=2):
    """(reference params, port params) of one MoE block."""
    jp = jmoe.moe_init(jax.random.key(seed), d, ff, e, kind, shared,
                       jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def tokens(seed, t, d):
    return np.random.RandomState(seed).randn(t, d).astype(np.float32)


def both(jp, p, x, **kw):
    want, jaux = jmoe.moe_apply(jnp.asarray(x), jp, **kw)
    got, aux = moe.moe_apply(torch.from_numpy(x), p, **kw)
    return (got, aux), (want, jaux)


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "gelu", "relu2"])
@pytest.mark.parametrize("mode", [{"dropless": True}, {},
                                  {"capacity_factor": 0.25}],
                         ids=["dropless", "default", "tight"])
def test_apply_matches_reference(kind, mode):
    jp, p = weights(16, 32, 4, kind, 0)
    x = tokens(3, 64, 16)
    (got, aux), (want, jaux) = both(jp, p, x, top_k=2, kind=kind, **mode)
    assert got.shape == (64, 16) and got.dtype == torch.float32
    close(got, want)
    close(aux, jaux)


@pytest.mark.parametrize("t", [1, 5, 37])
@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_odd_token_counts_and_top_k(t, top_k):
    jp, p = weights(32, 64, 8, "swiglu", 0)
    x = tokens(t, t, 32)
    for mode in ({"dropless": True}, {"capacity_factor": 0.5}):
        (got, aux), (want, jaux) = both(jp, p, x, top_k=top_k,
                                        kind="swiglu", **mode)
        close(got, want)
        close(aux, jaux)


def test_tight_capacity_drops_the_reference_pairs():
    """At the reference test's tight capacity some pairs are dropped (the
    output differs from the dropless one, as the reference's test checks);
    the port drops the same ones: its output equals the reference's, and
    the tokens whose every pair was dropped come out zero on both sides."""
    jp, p = weights(16, 32, 4, "swiglu", 0)
    x = tokens(3, 64, 16)
    (tight, _), (jtight, _) = both(jp, p, x, top_k=2, kind="swiglu",
                                   capacity_factor=0.25)
    (loose, _), _ = both(jp, p, x, top_k=2, kind="swiglu", dropless=True)
    close(tight, jtight)
    assert not torch.allclose(tight, loose)
    r = moe.route(torch.from_numpy(x), p["router"], top_k=2,
                  capacity=moe.capacity_of(64, 4, 2, 0.25, False))
    assert r.capacity == 8
    assert 0 < int((~r.keep).sum()) < 64 * 2
    # each expert keeps its first `capacity` pairs in token order
    for e in range(4):
        tok = r.token[r.expert == e]
        assert torch.equal(tok, torch.sort(tok).values)
        assert int(r.keep[r.expert == e].sum()) == min(len(tok), 8)
    kept = torch.zeros(64, dtype=torch.long).index_add_(
        0, r.token, r.keep.long())
    gone = kept == 0
    assert torch.equal(tight[gone], torch.zeros_like(tight[gone]))
    np.testing.assert_array_equal(np.asarray(jtight)[gone.numpy()], 0.0)


def test_shared_experts_match_reference():
    """kimi's recipe: one shared expert (an MLP of ``ff·num_shared``)
    beside the routed ones, dropless and dropping."""
    jp, p = weights(16, 32, 4, "swiglu", 1)
    assert sorted(p["shared"]) == ["w1", "w2", "w3"]
    x = tokens(4, 24, 16)
    for mode in ({"dropless": True}, {"capacity_factor": 0.25}):
        (got, aux), (want, jaux) = both(jp, p, x, top_k=2, kind="swiglu",
                                        **mode)
        close(got, want)
        close(aux, jaux)


def test_combine_is_deterministic():
    jp, p = weights(32, 64, 8, "swiglu", 1)
    x = torch.from_numpy(tokens(5, 96, 32))
    a, aux_a = moe.moe_apply(x, p, top_k=2, kind="swiglu", dropless=True)
    b, aux_b = moe.moe_apply(x, p, top_k=2, kind="swiglu", dropless=True)
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_routes_are_a_permutation_of_the_pairs():
    _, p = weights(16, 32, 4, "swiglu", 0)
    x = torch.from_numpy(tokens(6, 30, 16))
    r = moe.route(x, p["router"], top_k=2, capacity=30)
    assert bool(r.keep.all())
    assert torch.equal(torch.sort(r.expert).values, r.expert)
    assert torch.equal(torch.sort(r.rank.flatten()).values,
                       torch.arange(60))
    # the sorted pair at rank[t, j] belongs to token t
    assert torch.equal(r.token[r.rank], torch.arange(30)[:, None].expand(
        30, 2))
    assert torch.allclose(torch.zeros(30).index_add_(0, r.token, r.gate),
                          torch.ones(30))


def test_init_shapes_dtypes_and_scales():
    p = moe.moe_init(64, 128, 8, "swiglu", 1, torch.bfloat16,
                     generator=torch.Generator().manual_seed(0), lead=(2,))
    ref = jax.eval_shape(lambda k: jmoe.moe_init(k, 64, 128, 8, "swiglu", 1,
                                                 jnp.bfloat16),
                         jax.random.key(0))
    flat = jax.tree_util.tree_flatten_with_path(ref)[0]
    for path, leaf in flat:
        t = p
        for key in path:
            t = t[key.key]
        assert tuple(t.shape) == (2,) + leaf.shape, path
        assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype), path
    assert p["router"].dtype == torch.float32
    assert abs(p["router"].std().item() - 64 ** -0.5) < 0.01
    assert abs(p["w2"].float().std().item() - 128 ** -0.5) < 0.01
    relu = moe.moe_init(64, 128, 8, "relu2", 0, torch.float32,
                        generator=torch.Generator().manual_seed(0))
    assert sorted(relu) == ["router", "w1", "w2"]
