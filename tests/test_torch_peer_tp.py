"""Dense tensor parallelism on a peer mesh, against the stacked engine,
the unsharded model and the reference under its mesh, on the CPU.

A peer mesh is ``make_host_mesh((1, 4), devices=["cpu"] * 4)``; its cards
are emulated as ``tests/test_torch_peer_moe.py`` emulates them: the
session's ring runs a layout's cards (``card_of``) and the placement reads
the same layout (``sharding._card_layout``), so each emulated card holds
its own tree, cache and inputs and runs its share on a host thread of its
own, meeting the others at the ring's steps (``LockstepRing``).

* ``place_params(params, mesh, cfg)`` gives each card, per leaf, the
  blocks of its logical devices where the reference's ``param_specs``
  put ``model`` and the port's unit rules hold (whole heads, kv heads,
  hidden units, vocabulary blocks, RWKV-6's heads, Mamba's channels),
  with the port's own layout of Mamba's ``w_in`` (the card's channels of
  both halves) and its own cuts of RWKV-6's ``u`` and ``ln_x`` and of
  Mamba's per-channel leaves, whole leaves elsewhere: a config whose
  heads do not divide keeps its attention a replica, routers, norms and
  RWKV-6's ``mu`` stay replicas, a one-card layout cuts nothing;
  ``unplace_state`` puts the cuts back bit for bit.
* Card shares of ``prefill_forward`` (Llama-3 8B, Nemotron-4 with its
  squared ReLU at head dim 192, Mixtral-8x22B, Kimi K2 with its shared
  expert, RWKV-6 with 4 heads of 16, Hymba at d = 64, and a config
  whose replicated kv heads its q-head blocks read unevenly) on two and
  four cards: every card the same bits.
* ``ServeEngine``'s greedy tokens, prefill logits and decode logits:
  every card the same bits; the tokens the stacked engine's, the logits
  within the bound below of the stacked engine's, of the unsharded
  ``decode_step`` and of the reference's ``prefill_forward`` /
  ``decode_step`` jitted under ``make_mesh((1, 4))`` with its
  ``param_shardings``; each card's decode cache at its kv heads, RWKV-6
  heads or Mamba channels; on the one-card layout bit for bit the
  stacked engine's.

* A train step's card shares carry the cut: two emulated cards' states
  from ``place_state(state, mesh, cfg)`` put back equal the unsharded
  step's (the training slice's own cases:
  ``tests/test_torch_peer_tp_training.py``).

The bound. Each tensor-parallel psum adds the cards' partial products in
the activations' dtype, as GSPMD's all-reduce of a dot does, where the
stacked engine runs one product over the whole reduction dim: the two
differ by float rounding only. In float32 (the reduced configs, logits
of order 1) that is 1e-5 absolute. In bfloat16 (the full configs'
dtype) each card's partial product is rounded to bfloat16 (a relative
2**-9) before the sum, and the difference compounds over the layers: the
logits are held within 2e-2 of the largest |logit|, the repo's bfloat16
bound for a layer's output (``chip_smoke.py``'s path S).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import make_mesh, set_mesh as jset_mesh
from repro.models import transformer as jtfm
from repro.training import sharding as jshd

from repro_torch.comm import collectives as coll
from repro_torch.launch.mesh import make_host_mesh, set_mesh
from repro_torch.models import moe_dist
from repro_torch.models import tensor_parallel as tp
from repro_torch.models import transformer as tfm
from repro_torch.optim import OptimConfig
from repro_torch.serving import ServeEngine
from repro_torch.training import init_state, make_train_step
from repro_torch.training import TrainStepConfig
from repro_torch.training import sharding as shd
from repro_torch.tree import leaves, leaves_with_paths

from test_torch_moe_dist import carried
from test_torch_peer_moe import PLEN, PROMPTS, TOKS, serve_engine

ATOL = 1e-5
CPU = torch.device("cpu")
LAYOUTS = {"one_card": [0, 0, 0, 0], "two_cards": [0, 0, 1, 1],
           "four_cards": [0, 1, 2, 3], "split": [0, 1, 0, 1]}
#: The reduced configs the slice serves, by id: (arch, config changes).
ARCHS = {"llama3_8b": ("llama3_8b", {}),
         "nemotron_192": ("nemotron_4_340b", {"head_dim": 192}),
         "mixtral_8x22b": ("mixtral_8x22b", {"capacity_factor": 8.0}),
         "kimi_k2": ("kimi_k2_1t_a32b", {"capacity_factor": 8.0}),
         "rwkv6": ("rwkv6_1_6b", {}),
         "hymba": ("hymba_1_5b", {})}


def emulate(monkeypatch, card_of) -> int:
    """Emulate the cards of ``card_of`` (a card a model-axis device) on
    the CPU: the ring's layout and the placement's. Returns the card
    count."""
    n = max(card_of) + 1

    class Cards(coll.PeerRing):
        def __init__(self, engine):
            super().__init__(engine)
            self.card_of, self.cards = list(card_of), (CPU,) * n

    monkeypatch.setattr(coll, "PeerRing", Cards)
    monkeypatch.setattr(shd, "_card_layout", lambda mesh, what: (
        (CPU,) * n, [[d for d, c in enumerate(card_of) if c == k]
                     for k in range(n)]))
    return n


def peer_mesh():
    return make_host_mesh((1, 4), devices=["cpu"] * 4)


def model(arch_id):
    arch, replace = ARCHS[arch_id]
    return carried(arch, **replace)


# -- the placement -------------------------------------------------------------

def reference_model_dims(jcfg, jparams) -> dict:
    """Per leaf path (a key tuple), the dim the reference's
    ``param_specs`` cut on ``model`` under ``make_mesh((1, 4))``, or
    None."""
    specs = jshd.param_specs(jcfg, make_mesh((1, 4), ("data", "model")),
                             jax.eval_shape(lambda: jparams))
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    out = {}
    for path, spec in flat:
        dims = [i for i, e in enumerate(spec)
                if e == "model" or isinstance(e, tuple) and "model" in e]
        out[tuple(k.key for k in path)] = dims[0] if dims else None
    return out


#: Leaves the reference cuts on ``model`` that the port keeps whole on
#: purpose: the router (every card routes every token over every
#: expert's logit).
KEPT_WHOLE = ("router",)
#: The port's own cuts of leaves the reference keeps whole, so that a
#: card's gradient of each is whole without a psum, by (mixer, name):
#: the dim of the stacked ``(L, ...)`` leaf cut by the card's RWKV-6
#: heads or Mamba channels.
OWN_CUTS = {("rwkv", "u"): 1, ("rwkv", "ln_x"): 1,
            ("ssm", "conv_w"): 2, ("ssm", "conv_b"): 1,
            ("ssm", "w_dt1"): 1, ("ssm", "w_dt2"): 2,
            ("ssm", "dt_bias"): 1, ("ssm", "w_B"): 1, ("ssm", "w_C"): 1,
            ("ssm", "A_log"): 1, ("ssm", "D"): 1}


def blocks(whole, dim, held):
    """The model-axis devices ``held``'s blocks of ``whole``'s ``dim`` cut
    into 4, in order."""
    size = whole.shape[dim] // 4
    return torch.cat([whole.narrow(dim, d * size, size) for d in held], dim)


def expected_leaf(path, whole, ref_dim, cut, held):
    """The card's part of ``whole`` at ``path`` (the leaf's name last,
    under ``params`` or a moment): its blocks where the reference cuts
    ``model`` (or the port cuts on its own, :data:`OWN_CUTS`) and the
    unit rules hold, else None (whole). Mamba's ``w_in`` holds x's
    channels and z's side by side: the card's blocks of each half, where
    the reference cuts the concatenation in plain blocks."""
    if cut is None or not cut.cuts or shd.is_expert(path) \
            or path[-1] in KEPT_WHOLE:
        return None
    dim = OWN_CUTS.get(tuple(path[-2:]), ref_dim)
    if dim is None:
        return None
    units_ok = {"embed": cut.vocab, "lm_head": cut.vocab,
                "wq": cut.heads, "wo": cut.heads, "wk": cut.kv,
                "wv": cut.kv}.get(path[-1])
    if units_ok is None:
        units_ok = (cut.time_mix if "rwkv" in path else cut.mamba
                    if "ssm" in path else cut.shared if "shared" in path
                    else cut.ff)
    if not units_ok:
        return None
    if tuple(path[-2:]) == ("ssm", "w_in"):
        return torch.cat([blocks(half, dim, held)
                          for half in whole.chunk(2, dim)], dim)
    return blocks(whole, dim, held)


@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch_id", ["llama3_8b", "kimi_k2", "odd_heads",
                                     "hymba", "hymba_4_heads", "rwkv6"])
def test_place_params_cuts_as_the_reference_specs(arch_id, layout,
                                                  monkeypatch):
    """Per leaf: the card's blocks where the reference cuts ``model`` and
    the unit rules hold (:func:`expected_leaf`), else the whole leaf.
    ``odd_heads`` has 3 heads of 16 (the reference cuts ``wq``'s 48
    columns mid-head on 4 devices; the port keeps the attention whole);
    ``hymba``'s 5 heads likewise, its Mamba cut by channels;
    ``hymba_4_heads`` cuts both, ``rwkv6`` its 4 heads of 16."""
    if arch_id == "odd_heads":
        jcfg, cfg, jparams, params = carried("llama3_8b", num_heads=3,
                                             num_kv_heads=1)
    elif arch_id == "hymba":
        jcfg, cfg, jparams, params = carried("hymba_1_5b", num_heads=5,
                                             num_kv_heads=5)
    elif arch_id == "hymba_4_heads":
        jcfg, cfg, jparams, params = model("hymba")
    else:
        jcfg, cfg, jparams, params = model(arch_id)
    card_of = LAYOUTS[layout]
    n = emulate(monkeypatch, card_of)
    mesh = peer_mesh()
    trees = shd.place_params(params, mesh, cfg)
    cuts = shd.card_cuts(cfg, mesh)
    assert len(trees) == len(cuts) == n
    ref_dims = reference_model_dims(jcfg, jparams)
    cut_leaves, cut_names = 0, set()
    for card, tree in enumerate(trees):
        held = [d for d, c in enumerate(card_of) if c == card]
        cut = cuts[card]
        assert cut.held == tuple(held) and cut.cuts == (n > 1)
        if arch_id in ("odd_heads", "hymba"):
            assert not cut.heads and not cut.kv
        assert cut.time_mix == (arch_id == "rwkv6" and n > 1)
        assert cut.mamba == (arch_id.startswith("hymba") and n > 1)
        for (path, got), whole in zip(leaves_with_paths(tree),
                                      leaves(params)):
            if shd.is_expert(path):
                continue       # the experts' cut: test_torch_peer_moe.py
            want = expected_leaf(path, whole, ref_dims[path], cut
                                 if n > 1 else None, held)
            if want is None:
                assert got is whole or torch.equal(got, whole), path
            else:
                assert torch.equal(got, want), path
                cut_leaves += 1
                cut_names.add(tuple(path[-2:]))
    if n > 1:
        assert cut_leaves > 0
        mixer = MIXER_LEAVES.get(cfg.family, set())
        assert mixer <= cut_names and ("rwkv", "mu") not in cut_names


#: Every leaf of each family's mixer that a multi-card layout cuts.
MIXER_LEAVES = {
    "ssm": {("rwkv", n) for n in ("w_r", "w_k", "w_v", "w_w", "w_g",
                                  "w_out", "u", "ln_x")},
    "hybrid": {("ssm", n) for n in ("w_in", "conv_w", "conv_b", "w_dt1",
                                    "w_dt2", "dt_bias", "w_B", "w_C",
                                    "A_log", "D", "w_out")}}


@pytest.mark.parametrize("layout", ["two_cards", "four_cards", "split"])
@pytest.mark.parametrize("arch_id", ["nemotron_192", "kimi_k2", "rwkv6",
                                     "hymba"])
def test_unplace_state_puts_the_cuts_back(arch_id, layout, monkeypatch):
    _, cfg, _, params = model(arch_id)
    emulate(monkeypatch, LAYOUTS[layout])
    mesh = peer_mesh()
    trees = shd.place_params(params, mesh, cfg)
    back = shd.unplace_state(trees, mesh, cfg)
    assert all(torch.equal(a, b) for a, b in zip(leaves(back),
                                                 leaves(params)))
    assert [p for p, _ in leaves_with_paths(back)] == [
        p for p, _ in leaves_with_paths(params)]


def test_a_cut_holds_whole_units_only():
    """The unit rules: heads, kv heads, hidden units and the vocabulary
    are cut only where the model axis divides them; a card that holds
    every device cuts nothing; an uneven kv read takes one kv head a q
    head."""
    _, cfg, _, _ = carried("llama3_8b")          # 4 heads, 2 kv, ff 128
    cut = tp.dense_cut(cfg, [1], 4)
    assert (cut.heads, cut.kv, cut.ff, cut.vocab) == (True, False, True,
                                                      True)
    assert tp.heads(cfg, cut) == (1, 1, [0])
    assert tp.dense_cut(cfg, [1], 2).kv
    assert not tp.dense_cut(cfg, [0, 1, 2, 3], 4).cuts
    odd = dataclasses.replace(cfg, num_heads=6, num_kv_heads=3)
    assert tp.heads(odd, tp.dense_cut(odd, [1], 2)) == (3, 3, [1, 2, 2])
    assert tp.heads(odd, tp.dense_cut(odd, [0], 2)) == (3, 3, [0, 0, 1])
    wide = dataclasses.replace(cfg, d_ff=130, vocab_size=250)
    cut = tp.dense_cut(wide, [0], 4)
    assert cut.heads and not cut.ff and not cut.vocab
    assert not cut.time_mix and not cut.mamba
    # RWKV-6 by whole heads (4 of 16 here), Mamba by channels (d_i = 64)
    _, rwkv, _, _ = carried("rwkv6_1_6b")
    assert tp.dense_cut(rwkv, [1], 4).time_mix
    assert not tp.dense_cut(rwkv, [1], 4).heads
    assert not tp.dense_cut(dataclasses.replace(rwkv, rwkv_head_dim=32),
                            [1], 4).time_mix
    _, hymba, _, _ = carried("hymba_1_5b")
    assert tp.dense_cut(hymba, [0, 1], 4).mamba
    assert not tp.dense_cut(dataclasses.replace(hymba, d_model=66), [0],
                            4).mamba
    assert not tp.dense_cut(hymba, [0, 1, 2, 3], 4).cuts
    x = torch.arange(12.).view(2, 6)
    assert torch.equal(tp.take(x, -1, [0, 1, 1, 4]),
                       x[:, [0, 1, 1, 4]])


# -- card shares ---------------------------------------------------------------

def card_prefill(cfg, params, mesh, n, toks, spec):
    """``prefill_forward`` as card shares of the emulated cards in
    lockstep, each on its placed tree under its cut: every card's
    logits."""
    trees = shd.place_params(params, mesh, cfg)
    cuts = shd.card_cuts(cfg, mesh)
    ring = coll.PeerRing(mesh.session.engine)
    ring.begin()
    lockstep = coll.LockstepRing(ring)
    got = [None] * n

    def body(card):
        with moe_dist.card_share(lockstep, card, cuts[card]):
            got[card], _ = tfm.prefill_forward(trees[card], cfg,
                                               {"tokens": toks}, spec)

    with set_mesh(mesh):
        coll.run_in_lockstep(lockstep, [(CPU, body)] * n)
    return got


@pytest.mark.parametrize("layout", ["two_cards", "four_cards"])
@pytest.mark.parametrize("arch_id", list(ARCHS) + ["uneven_kv"])
def test_card_shares_of_a_prefill(arch_id, layout, monkeypatch):
    """Every card's prefill logits the same bits, within 1e-5 of the
    unsharded ``prefill_forward``. ``uneven_kv`` (6 heads, 3 kv heads)
    on two cards: a card's 3 q heads read kv heads 0, 1, 1 (or 1, 2, 2)
    of the replicated ``wk``/``wv``."""
    if arch_id == "uneven_kv":
        _, cfg, _, params = carried("llama3_8b", num_heads=6,
                                    num_kv_heads=3, head_dim=8)
    else:
        _, cfg, _, params = model(arch_id)
    n = emulate(monkeypatch, LAYOUTS[layout])
    toks = TOKS
    spec = tfm.cache_spec(cfg, max_len=16, kv_chunks=4)
    got = card_prefill(cfg, params, peer_mesh(), n, toks, spec)
    want, _ = tfm.prefill_forward(params, cfg, {"tokens": toks}, spec)
    assert all(torch.equal(g, got[0]) for g in got)
    np.testing.assert_allclose(got[0].numpy(), want.numpy(), atol=ATOL,
                               rtol=0)


# -- serving -------------------------------------------------------------------

def reference_serve(jcfg, jparams, tok):
    """The reference's ``prefill_forward`` on :data:`TOKS` and one
    ``decode_step`` of ``tok`` after it, jitted under ``make_mesh((1,
    4))`` with its ``param_shardings``."""
    jmesh = make_mesh((1, 4), ("data", "model"))
    jspec = jtfm.cache_spec(jcfg, max_len=16, kv_chunks=4)
    with jset_mesh(jmesh):
        placed = jax.device_put(jparams, jshd.param_shardings(
            jcfg, jmesh, jax.eval_shape(lambda: jparams)))
        logits, cache = jax.jit(lambda p, t: jtfm.prefill_forward(
            p, jcfg, {"tokens": t}, jspec))(placed,
                                            jnp.asarray(TOKS.numpy()))
        step, _ = jax.jit(lambda p, c, t: jtfm.decode_step(
            p, jcfg, c, t, jnp.int32(PLEN), jspec))(
            placed, cache, jnp.asarray(tok.numpy().astype(np.int32)))
    return np.asarray(logits, np.float32), np.asarray(step, np.float32)


def engine_on(cfg, params, mesh):
    with set_mesh(mesh):
        return ServeEngine(cfg, params, max_len=16, kv_chunks=4)


def close(a, b, atol=ATOL) -> None:
    np.testing.assert_allclose(np.asarray(a.float() if torch.is_tensor(a)
                                          else a),
                               np.asarray(b.float() if torch.is_tensor(b)
                                          else b), atol=atol, rtol=0)


@pytest.mark.parametrize("layout", ["two_cards", "four_cards"])
@pytest.mark.parametrize("arch_id", list(ARCHS))
def test_serve_engine_tensor_parallel(arch_id, layout, monkeypatch):
    """Greedy tokens the stacked engine's; every card's prefill and
    decode logits the same bits, within 1e-5 of the stacked engine's, of
    the unsharded ``decode_step`` and of the reference under its mesh;
    each card's cache at its kv heads."""
    jcfg, cfg, jparams, params = model(arch_id)
    n = emulate(monkeypatch, LAYOUTS[layout])
    peer = peer_mesh()
    engine = engine_on(cfg, params, peer)
    assert len(engine.cards) == n and all(c.cuts for c in engine.cuts)
    outs, pre, dec, cache = serve_engine(engine, peer)
    stacked = make_host_mesh((1, 4), device="cpu")
    souts, spre, sdec, _ = serve_engine(engine_on(cfg, params, stacked),
                                        stacked)
    assert outs == souts
    assert all(torch.equal(x, pre[0]) for x in pre)
    assert all(torch.equal(x, dec[0]) for x in dec)
    close(pre[0], spre[0])
    close(dec[0], sdec[0])
    check_cache(cache, cfg, engine.cuts[0])
    tok = pre[0][:, -1].argmax(-1)[:, None]
    spec = tfm.cache_spec(cfg, max_len=16, kv_chunks=4)
    _, whole = tfm.prefill_forward(params, cfg, {"tokens": TOKS}, spec)
    free, _ = tfm.decode_step(params, cfg, whole, tok, PLEN, spec)
    close(dec[0], free)
    want_pre, want_dec = reference_serve(jcfg, jparams, tok)
    close(pre[0], want_pre)
    close(dec[0], want_dec)


def check_cache(cache, cfg, cut) -> None:
    """A card's decode cache under its ``cut``: its kv heads, its RWKV-6
    heads' states (the token-shift input whole) or its Mamba channels'
    states, each the whole cache's shape but that dim."""
    whole = tfm.cache_shapes(cfg, len(PROMPTS),
                             tfm.cache_spec(cfg, max_len=16, kv_chunks=4))
    part = {"k": (2, tp.heads(cfg, cut)[1]), "v": (2, tp.heads(cfg, cut)[1]),
            "rwkv_state": (2, cut.part(cfg.d_model // cfg.rwkv_head_dim)),
            "ssm": (2, cut.part(cfg.d_model)),
            "conv": (3, cut.part(cfg.d_model))}
    assert sorted(cache) == sorted(whole)
    for name, t in cache.items():
        want = list(whole[name].shape)
        if name in part:
            dim, n = part[name]
            assert n < want[dim], name
            want[dim] = n
        assert list(t.shape) == want, name


def test_serve_engine_tensor_parallel_bfloat16(monkeypatch):
    """Llama-3 8B's reduced config in bfloat16 (the full configs' dtype)
    on four cards: the tokens the stacked engine's, every card the same
    bits, the logits within 2e-2 of the stacked engine's largest |logit|
    (module docstring)."""
    _, cfg, _, params = carried("llama3_8b")
    cfg = dataclasses.replace(cfg, dtype="bfloat16")
    params = shd._map_with_path(
        lambda path, t: t.to(torch.bfloat16) if t.dim() > 1 else t, params)
    n = emulate(monkeypatch, LAYOUTS["four_cards"])
    peer = peer_mesh()
    outs, pre, dec, _ = serve_engine(engine_on(cfg, params, peer), peer)
    stacked = make_host_mesh((1, 4), device="cpu")
    souts, spre, sdec, _ = serve_engine(engine_on(cfg, params, stacked),
                                        stacked)
    assert n == 4 and outs == souts
    assert all(torch.equal(x, pre[0]) for x in pre)
    assert all(torch.equal(x, dec[0]) for x in dec)
    close(pre[0], spre[0], 2e-2 * spre[0].float().abs().max().item())
    close(dec[0], sdec[0], 2e-2 * sdec[0].float().abs().max().item())


@pytest.mark.parametrize("arch_id", ["nemotron_192", "kimi_k2", "rwkv6",
                                     "hymba"])
def test_one_card_layout_is_the_stacked_engine(arch_id):
    """Four logical devices on one card: every cut is the whole leaf and
    nothing is cut, so tokens and logits are the stacked engine's bit for
    bit."""
    _, cfg, _, params = model(arch_id)
    peer = peer_mesh()
    engine = engine_on(cfg, params, peer)
    assert engine.cuts == [tp.DenseCut((0, 1, 2, 3), 4)]
    (tree,) = engine.trees
    assert all(a.data_ptr() == b.data_ptr()
               for a, b in zip(leaves(tree), leaves(params)))
    outs, pre, dec, _ = serve_engine(engine, peer)
    stacked = make_host_mesh((1, 4), device="cpu")
    souts, spre, sdec, _ = serve_engine(engine_on(cfg, params, stacked),
                                        stacked)
    assert outs == souts
    assert torch.equal(pre[0], spre[0]) and torch.equal(dec[0], sdec[0])


def test_serve_engine_checks_the_callers_cuts(monkeypatch):
    """Trees placed for serving are taken; whole dense leaves (the
    training layout) on a multi-card mesh raise."""
    _, cfg, _, params = model("nemotron_192")
    emulate(monkeypatch, LAYOUTS["two_cards"])
    peer = peer_mesh()
    placed = shd.place_params(params, peer, cfg)
    engine = engine_on(cfg, placed, peer)
    assert engine.trees == placed
    whole = [shd.place_card(params, held, 4, CPU)      # training layout
             for held in ([0, 1], [2, 3])]
    with pytest.raises(ValueError, match="place_params"):
        engine_on(cfg, whole, peer)


def test_train_step_on_a_peer_mesh_cuts_the_dense_leaves(monkeypatch):
    """A train step's card shares carry the cut: ``place_state(state,
    mesh, cfg)`` gives each of two emulated cards its blocks of the dense
    leaves (and of their moments), the replicated leaves stay whole and
    come out the same bits on both cards, and the two cards' states put
    back equal the unsharded step's within float32 rounding (the psums
    add the cards' partial products in another order: 2e-5 absolute and
    1e-4 relative, the stacked mesh step's bound in
    ``tests/test_torch_peer_moe_training.py``)."""
    _, cfg, _, _ = carried("llama3_8b")
    opt = OptimConfig(learning_rate=1e-3, warmup_steps=1, total_steps=5)
    state = init_state(cfg, opt, generator=torch.Generator().manual_seed(3),
                       device="cpu")
    emulate(monkeypatch, LAYOUTS["two_cards"])
    peer = peer_mesh()
    trees = shd.place_state(state, peer, cfg)
    cuts = shd.card_cuts(cfg, peer)
    assert all(c.heads and c.ff and c.vocab for c in cuts)
    for tree in trees:
        assert tree["params"]["embed"].shape[0] * 2 == cfg.vocab_size
        assert tree["opt"]["m"]["layers"]["mlp"]["w1"].shape == \
            tree["params"]["layers"]["mlp"]["w1"].shape
    rng = np.random.RandomState(2)
    batch = {k: torch.from_numpy(rng.randint(0, cfg.vocab_size, (4, 8)))
             for k in ("tokens", "labels")}
    step = make_train_step(cfg, TrainStepConfig(), opt, device="cpu")
    want, wm = step(state, batch)
    with set_mesh(peer):
        got, m = step(trees, batch)
    assert len(got) == 2
    np.testing.assert_allclose(float(m["loss"]), float(wm["loss"]),
                               rtol=1e-5)
    rep = [[t for path, t in leaves_with_paths(tree)
            if not shd.is_cut(path, cuts[0])] for tree in got]
    assert all(torch.equal(a, b) for a, b in zip(*rep))
    back = shd.unplace_state(got, peer, cfg)
    for a, b in zip(leaves(back), leaves(want)):
        np.testing.assert_allclose(a.float().numpy(), b.float().numpy(),
                                   atol=2e-5, rtol=1e-4)
