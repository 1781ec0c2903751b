"""Expert-parallel MoE and serving on a peer mesh, against the stacked
mesh and the reference, on the CPU.

A peer mesh is ``make_host_mesh(shape, devices=["cpu"] * model)``: its
session puts each model-axis device on a device of its own (all the CPU
here, so one card). The same seeded inputs go through the stacked mesh
(``device="cpu"``), the peer mesh and the reference under its mesh on 8
CPU devices:

* ``moe_apply_dist`` on reduced Mixtral-8x22B's MoE (4 experts, top 2)
  at ``(data 2, model 4)`` (one expert a device) and ``(1, 8)``
  (expert-TP), capacity-bound and dropless, with and without FSDP's
  gather: bit for bit the stacked mesh's, and within
  ``tests/test_torch_moe_dist.py``'s bounds of the reference (float32
  atol 1e-5, aux rtol 1e-6); its combine one peer dispatch a data index
  (``session.collectives.psum`` of a list);
* each card's share (``moe_dist.card_share``) on its own placed tree,
  the cards emulated by host threads in lockstep over the session's peer
  ring (``LockstepRing``) for card layouts of one, two and four cards and
  a split one: every card's output bit for bit the stacked mesh's;
* under autograd the peer mesh gives gradients (the eager form; the card
  shares are ``tests/test_torch_peer_moe_training.py``'s);
* ``place_params`` / ``place_card``: each card holds only its devices'
  experts (EP: whole experts; expert-TP: ff-shards), every other leaf a
  replica, views on the card that holds the source;
* ``ServeEngine`` on reduced Mixtral-8x22B and Kimi K2 (4 experts, a
  shared expert) carried from the reference's weights: greedy tokens,
  prefill and decode logits bit for bit the stacked mesh's engine, given
  whole or placed parameters; one decode step within 2e-3 of the
  unsharded step (``test_decode_step_under_mesh_matches_unsharded``'s
  bound) and the reference's;
* ``make_host_mesh`` refuses ``device=`` beside ``devices=``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import make_mesh, set_mesh as jset_mesh
from repro.models import moe_dist as jmoe_dist
from repro.models import transformer as jtfm

from repro_torch.comm import collectives as coll
from repro_torch.comm.session import PeerCollectives
from repro_torch.launch.mesh import is_peer, make_host_mesh, set_mesh
from repro_torch.models import moe_dist
from repro_torch.models import transformer as tfm
from repro_torch.serving import Request, ServeEngine
from repro_torch.serving import engine as serving_engine
from repro_torch.training.sharding import cut_experts, place_card, place_params
from repro_torch.tree import leaves

from test_torch_moe_dist import MESHES, MODES, carried, expert_weights, tokens

ATOL = 1e-5


def peer_mesh(shape):
    return make_host_mesh(shape, devices=["cpu"] * shape[1])


def run_dist(mesh, x, p, **kw):
    with set_mesh(mesh):
        return moe_dist.moe_apply_dist(x, p, **kw)


@pytest.mark.parametrize("fsdp", [False, True], ids=["replicated", "fsdp"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_moe_apply_dist_on_a_peer_mesh_bitwise_stacked_and_reference(
        mesh_name, mode, fsdp):
    cfg, jp, p = expert_weights()
    shape = MESHES[mesh_name]
    x = tokens(3, 64, cfg.d_model)
    kw = dict(top_k=cfg.top_k, kind=cfg.mlp, fsdp=fsdp, **MODES[mode])
    mesh = peer_mesh(shape)
    assert is_peer(mesh) and mesh.session.num_devices == shape[1]
    got, aux = run_dist(mesh, torch.from_numpy(x), p, **kw)
    want, waux = run_dist(make_host_mesh(shape, device="cpu"),
                          torch.from_numpy(x), p, **kw)
    assert torch.equal(got, want) and torch.equal(aux, waux)
    with jset_mesh(make_mesh(shape, ("data", "model"))):
        ref, jaux = jax.jit(lambda a, q: jmoe_dist.moe_apply_dist(
            a, q, **kw))(jnp.asarray(x), jp)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-6)


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_peer_combine_is_one_dispatch_a_data_index(mesh_name, monkeypatch):
    """Outside a program each data index's rows go to the peer session's
    ``collectives.psum`` once, as a list of ``model`` tensors ``(T /
    data, d)``: one dispatch each."""
    cfg, _, p = expert_weights()
    data, model = MESHES[mesh_name]
    mesh = peer_mesh((data, model))
    seen = []
    real = PeerCollectives.psum

    def spy(self, xs):
        assert self is mesh.session.collectives
        seen.append([tuple(t.shape) for t in xs])
        return real(self, xs)

    monkeypatch.setattr(PeerCollectives, "psum", spy)
    x = torch.from_numpy(tokens(4, 64, cfg.d_model))
    before = mesh.session.stats()["dispatches"]
    run_dist(mesh, x, p, top_k=2, kind=cfg.mlp, dropless=True)
    assert seen == [[(64 // data, cfg.d_model)] * model] * data
    assert mesh.session.stats()["dispatches"] - before == data


CARD_LAYOUTS = {"one_card": [0, 0, 0, 0], "two_cards": [0, 0, 1, 1],
                "four_cards": [0, 1, 2, 3], "split": [0, 1, 0, 1],
                "uneven": [0, 1, 1, 1]}


def block_tree(p, card_of, card, model):
    """Card ``card``'s placed tree of one MoE block ``p``."""
    held = [d for d, c in enumerate(card_of) if c == card]
    return place_card({"moe": p}, held, model, "cpu")["moe"]


def card_shares(mesh, card_of, trees, fn):
    """``fn(card, tree)`` under ``card_share`` on host threads, one a card
    of ``card_of``, in lockstep over the mesh session's peer ring (begun
    over every card), whose cards ``card_of`` stands in for: the per-card
    outputs."""
    ring = coll.PeerRing(mesh.session.engine)
    ring.card_of = card_of
    ring.cards = (torch.device("cpu"),) * (max(card_of) + 1)
    ring.begin()
    lockstep = coll.LockstepRing(ring)
    got = [None] * lockstep.cards

    def body(card):
        with moe_dist.card_share(lockstep, card):
            got[card] = fn(card, trees[card])

    with set_mesh(mesh):
        coll.run_in_lockstep(lockstep, [(torch.device("cpu"), body)]
                             * lockstep.cards)
    return got


@pytest.mark.parametrize("fsdp", [False, True], ids=["replicated", "fsdp"])
@pytest.mark.parametrize("layout", list(CARD_LAYOUTS))
def test_card_shares_give_the_stacked_output(layout, fsdp):
    """Each card computes its own devices' rows from its placed experts
    and runs its share of every combine (two data indices, so two psums a
    call): every card's output is the stacked mesh's, bit for bit."""
    cfg, _, p = expert_weights()
    card_of = CARD_LAYOUTS[layout]
    mesh = peer_mesh((2, 4))
    kw = dict(top_k=cfg.top_k, kind=cfg.mlp, fsdp=fsdp, dropless=True)
    x = torch.from_numpy(tokens(8, 64, cfg.d_model))
    trees = [block_tree(p, card_of, card, 4)
             for card in range(max(card_of) + 1)]
    got = card_shares(mesh, card_of, trees,
                      lambda card, tree: moe_dist.moe_apply_dist(x, tree,
                                                                 **kw))
    want, waux = run_dist(make_host_mesh((2, 4), device="cpu"), x, p, **kw)
    for out, aux in got:
        assert torch.equal(out, want) and torch.equal(aux, waux)


def test_card_shares_under_expert_tp_give_the_stacked_output():
    """Expert-TP at ``(1, 8)`` (4 experts, 8 devices), two cards holding
    alternate devices: each card's tree holds its devices' ff-shards."""
    cfg, _, p = expert_weights()
    card_of = [0, 1] * 4
    mesh = peer_mesh((1, 8))
    kw = dict(top_k=cfg.top_k, kind=cfg.mlp, capacity_factor=1.25)
    x = torch.from_numpy(tokens(9, 64, cfg.d_model))
    trees = [block_tree(p, card_of, card, 8) for card in (0, 1)]
    assert trees[0]["w1"].shape[-1] == p["w1"].shape[-1] // 2
    got = card_shares(mesh, card_of, trees,
                      lambda card, tree: moe_dist.moe_apply_dist(x, tree,
                                                                 **kw))
    want, _ = run_dist(make_host_mesh((1, 8), device="cpu"), x, p, **kw)
    assert all(torch.equal(out, want) for out, _ in got)


def test_training_under_a_peer_mesh_raises():
    """The calls that raised before training on a peer mesh was ported
    (the name is theirs) now return gradients: of x, and of the whole
    parameters, each the stacked mesh's; without grad the output."""
    cfg, _, p = expert_weights()
    x = torch.from_numpy(tokens(5, 64, cfg.d_model))
    kw = dict(top_k=2, kind=cfg.mlp, dropless=True)
    mesh = peer_mesh((1, 4))
    stacked = make_host_mesh((1, 4), device="cpu")

    def x_grad(on):
        xs = x.clone().requires_grad_()
        out, aux = run_dist(on, xs, p, **kw)
        return torch.autograd.grad(out.sum() + aux, xs)[0]

    assert torch.equal(x_grad(mesh), x_grad(stacked))

    def p_grads(on):
        grad_p = {k: v.clone().requires_grad_() for k, v in p.items()}
        out, aux = run_dist(on, x, grad_p, **kw)
        return torch.autograd.grad(out.sum() + aux, list(grad_p.values()))

    got = p_grads(mesh)
    assert all(torch.equal(a, b) for a, b in zip(got, p_grads(stacked)))
    assert all(g.abs().max() > 0 for g in got)
    grad_p = {k: v.clone().requires_grad_() for k, v in p.items()}
    with torch.no_grad():
        out, _ = run_dist(mesh, x, grad_p, **kw)
    assert out.shape == x.shape


def test_an_eager_call_refuses_a_cards_tree():
    cfg, _, p = expert_weights()
    mesh = peer_mesh((1, 4))
    x = torch.from_numpy(tokens(5, 16, cfg.d_model))
    with pytest.raises(ValueError, match="whole parameters"):
        run_dist(mesh, x, block_tree(p, [1, 0, 0, 1], 0, 4), top_k=2,
                 kind=cfg.mlp)


# -- the placement ------------------------------------------------------------

@pytest.mark.parametrize("arch", ["mixtral_8x22b", "kimi_k2_1t_a32b"])
@pytest.mark.parametrize("held", [[0], [1, 2], [0, 1, 2, 3], [1, 3]],
                         ids=["one", "run", "all", "split"])
def test_a_card_holds_only_its_experts(arch, held):
    _, cfg, _, params = carried(arch)
    tree = place_card(params, held, 4, "cpu")
    moe, whole = tree["layers"]["moe"], params["layers"]["moe"]
    el = cfg.num_experts // 4
    contiguous = held == list(range(held[0], held[-1] + 1))
    for name in ("w1", "w3", "w2"):
        want = torch.cat([whole[name][:, d * el:(d + 1) * el]
                          for d in held], dim=1)
        assert torch.equal(moe[name], want)
        shares = (moe[name].untyped_storage().data_ptr()
                  == whole[name].untyped_storage().data_ptr())
        assert shares == contiguous        # a view where it can be one
    experts = {id(moe[name]) for name in ("w1", "w3", "w2")}
    rest = [(a, b) for a, b in zip(leaves(tree), leaves(params))
            if id(a) not in experts]
    assert len(rest) == len(leaves(params)) - 3
    assert all(a is b for a, b in rest)     # replicas: the same tensors
    assert "router" in moe and ("shared" in moe) == (arch ==
                                                      "kimi_k2_1t_a32b")


def test_expert_tp_cuts_the_ff_dim_and_needs_it_to_divide():
    cfg, _, p = expert_weights()
    w1, w2 = p["w1"], p["w2"]
    ff = w1.shape[-1]
    got = cut_experts(w1, "w1", [2, 3], 8)
    assert torch.equal(got, w1[..., 2 * ff // 8:4 * ff // 8])
    assert torch.equal(cut_experts(w2, "w2", [5], 8),
                       w2[:, 5 * ff // 8:6 * ff // 8])
    with pytest.raises(ValueError, match="ff dim"):
        cut_experts(w1[..., :ff - 1], "w1", [0], 8)


def test_place_params_gives_one_tree_a_card():
    _, cfg, _, params = carried("mixtral_8x22b")
    (tree,) = place_params(params, peer_mesh((1, 4)), cfg)
    assert all(a.data_ptr() == b.data_ptr()
               for a, b in zip(leaves(tree), leaves(params)))
    with pytest.raises(ValueError, match="peer mesh"):
        place_params(params, make_host_mesh((1, 4), device="cpu"), cfg)


# -- serving ------------------------------------------------------------------

PROMPTS = [[5, 9, 2, 7, 1, 3], [4, 4, 8], [11, 6, 1, 2], [3]]
PLEN = max(len(q) for q in PROMPTS)
#: The prompts left-padded to one length, as ``generate`` pads them.
TOKS = torch.tensor([[0] * (PLEN - len(q)) + q for q in PROMPTS])


def serve_engine(engine, mesh):
    """Under ``mesh``: ``generate``'s greedy tokens, then one prefill
    program call on :data:`TOKS` and one decode step after it: (tokens,
    every card's prefill logits, every card's decode logits, card 0's
    cache after the prefill)."""
    with set_mesh(mesh):
        outs = [r.out for r in engine.generate(
            [Request(list(q), 5) for q in PROMPTS])]
        prefill = engine.prefill_program(len(PROMPTS), PLEN)
        prefill.tokens.copy_(TOKS)
        prefill()
        pre = [t.clone() for t in prefill.card_logits]
        cache = {k: t.clone() for k, t in prefill.cache.items()}
        decode = engine.decode_program(len(PROMPTS))
        decode.tokens.copy_(pre[0][:, -1].argmax(-1)[:, None])
        decode.cur_len.fill_(PLEN)
        decode()
    return outs, pre, [t.clone() for t in decode.card_logits], cache


def serve(cfg, params, mesh):
    """A new engine under ``mesh`` and :func:`serve_engine`'s readings of
    it: (engine, tokens, prefill logits, decode logits, cache)."""
    with set_mesh(mesh):
        engine = ServeEngine(cfg, params, max_len=16, kv_chunks=4)
    outs, pre, dec, cache = serve_engine(engine, mesh)
    return engine, outs, pre[0], dec[0], cache


@pytest.mark.parametrize("arch", ["mixtral_8x22b", "kimi_k2_1t_a32b"])
def test_serve_engine_on_a_peer_mesh_bitwise_stacked(arch):
    jcfg, cfg, jparams, params = carried(arch, capacity_factor=8.0)
    peer = peer_mesh((1, 4))
    engine, outs, logits, step, cache = serve(cfg, params, peer)
    assert engine.mesh is peer and len(engine.cards) == 1
    assert len(engine.decode_program(len(PROMPTS)).rings) == 1
    _, souts, slogits, sstep, _ = serve(
        cfg, params, make_host_mesh((1, 4), device="cpu"))
    assert outs == souts
    assert torch.equal(logits, slogits) and torch.equal(step, sstep)
    # the same from trees placed by the caller
    _, pouts, plogits, pstep, _ = serve(cfg, place_params(params, peer,
                                                          cfg), peer)
    assert pouts == outs and torch.equal(plogits, logits)
    assert torch.equal(pstep, step)
    # the decode step against the unsharded step and the reference's
    tok = logits[:, -1].argmax(-1)[:, None]
    free, _ = tfm.decode_step(params, cfg, cache, tok, PLEN, engine.spec)
    np.testing.assert_allclose(step.float().numpy(), free.float().numpy(),
                               atol=2e-3)
    jspec = jtfm.cache_spec(jcfg, max_len=16, kv_chunks=4)
    _, jcache = jtfm.prefill_forward(jparams, jcfg,
                                     {"tokens": jnp.asarray(TOKS.numpy())},
                                     jspec)
    want, _ = jtfm.decode_step(jparams, jcfg, jcache,
                               jnp.asarray(tok.numpy().astype(np.int32)),
                               jnp.int32(PLEN), jspec)
    np.testing.assert_allclose(step.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-3)


def test_serve_engine_on_a_peer_mesh_with_a_data_axis():
    """``(2, 4)``: each data index routes its half of the batch's tokens
    and has its own combine; tokens and logits as the stacked mesh's."""
    _, cfg, _, params = carried("mixtral_8x22b", capacity_factor=8.0)
    _, outs, logits, step, _ = serve(cfg, params, peer_mesh((2, 4)))
    _, souts, slogits, sstep, _ = serve(
        cfg, params, make_host_mesh((2, 4), device="cpu"))
    assert outs == souts
    assert torch.equal(logits, slogits) and torch.equal(step, sstep)


def test_peer_programs_cut_into_segments_bitwise_one_graph(monkeypatch):
    """A program cut into segments of one layer (a graph a card each on
    the card, a static hand-over between them) gives the bits of the
    whole."""
    _, cfg, _, params = carried("kimi_k2_1t_a32b", capacity_factor=8.0)
    peer = peer_mesh((1, 4))
    _, outs, logits, step, _ = serve(cfg, params, peer)
    monkeypatch.setattr(serving_engine, "GRAPH_LAYERS", 1)
    engine, couts, clogits, cstep, _ = serve(cfg, params, peer)
    prefill = engine.prefill_program(len(PROMPTS), PLEN)
    assert [list(r) for r in prefill.segments] == [
        [i] for i in range(cfg.num_layers)] and cfg.num_layers > 1
    assert couts == outs
    assert torch.equal(clogits, logits) and torch.equal(cstep, step)


@pytest.mark.parametrize("graph_layers", [8, 1], ids=["one_segment",
                                                      "a_layer_each"])
def test_engine_programs_run_two_cards_in_lockstep(monkeypatch,
                                                   graph_layers):
    """The first run of a program over several cards: one host thread a
    card, each card's body on its own tree, inputs and cache, meeting at
    the ring's steps. Emulated with two "cards" on the CPU (the ring's
    ``card_of`` and the placement's layout ``[0, 0, 1, 1]``): each card
    holds its experts and its cut of the dense leaves, so every card's
    logits are the same bits and within ``tests/test_torch_peer_tp.py``'s
    float32 bound (1e-5) of the stacked mesh's engine, whose tokens they
    give; card 1's inputs are staged from card 0's."""
    from repro_torch.training import sharding as shd

    _, cfg, _, params = carried("mixtral_8x22b", capacity_factor=8.0)
    cpu = torch.device("cpu")

    class TwoCards(coll.PeerRing):
        def __init__(self, engine):
            super().__init__(engine)
            self.card_of, self.cards = [0, 0, 1, 1], (cpu, cpu)

    monkeypatch.setattr(coll, "PeerRing", TwoCards)
    monkeypatch.setattr(shd, "_card_layout", lambda mesh, what: (
        (cpu, cpu), [[0, 1], [2, 3]]))
    monkeypatch.setattr(serving_engine, "GRAPH_LAYERS", graph_layers)
    peer = peer_mesh((1, 4))
    with set_mesh(peer):
        engine = ServeEngine(cfg, params, max_len=16, kv_chunks=4)
    assert engine.cards == (cpu, cpu) and all(c.heads for c in engine.cuts)
    outs, pre, dec, _ = serve_engine(engine, peer)
    stacked = make_host_mesh((1, 4), device="cpu")
    with set_mesh(stacked):
        want = serve_engine(ServeEngine(cfg, params, max_len=16,
                                        kv_chunks=4), stacked)
    assert outs == want[0]
    assert all(torch.equal(x, pre[0]) for x in pre)
    assert all(torch.equal(x, dec[0]) for x in dec)
    np.testing.assert_allclose(pre[0].numpy(), want[1][0].numpy(),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(dec[0].numpy(), want[2][0].numpy(),
                               atol=ATOL, rtol=0)
    decode = engine.decode_program(len(PROMPTS))
    assert torch.equal(decode._tokens[1], decode.tokens)
    assert torch.equal(decode._cur_len[1], decode.cur_len)
    assert decode.caches[0] is not decode.caches[1]
    assert len(decode.segments) == len(decode.rings) == (
        cfg.num_layers if graph_layers == 1 else 1)


def test_serve_engine_refuses_trees_off_the_mesh_cards():
    _, cfg, _, params = carried("mixtral_8x22b")
    peer = peer_mesh((1, 4))
    with set_mesh(peer), pytest.raises(ValueError, match="one on each"):
        ServeEngine(cfg, place_params(params, peer, cfg) * 2, max_len=16)


def test_make_host_mesh_takes_device_or_devices():
    with pytest.raises(ValueError, match="not both"):
        make_host_mesh((1, 4), device="cpu", devices=["cpu"] * 4)
    assert not is_peer(make_host_mesh((1, 4), device="cpu"))
    mesh = make_host_mesh((2, 4), devices=["cpu"] * 4)
    assert is_peer(mesh) and mesh.shape == {"data": 2, "model": 4}
    with pytest.raises(ValueError):
        make_host_mesh((1, 4), devices=["cpu"] * 3)


def test_a_dense_model_serves_on_a_peer_mesh():
    """No MoE, no combine: the peer engine's replica serves as the stacked
    one does."""
    _, cfg, _, params = carried("llama3_8b")
    _, outs, logits, step, _ = serve(cfg, params, peer_mesh((1, 4)))
    _, souts, slogits, sstep, _ = serve(
        cfg, params, make_host_mesh((1, 4), device="cpu"))
    assert outs == souts and torch.equal(logits, slogits)
    assert torch.equal(step, sstep)
