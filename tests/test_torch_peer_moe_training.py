"""Expert-parallel training on a peer mesh, against the stacked mesh, the
single-shard layer and the reference, on the CPU.

A peer mesh is ``make_host_mesh(shape, devices=["cpu"] * model)``. Its
cards are emulated as in ``tests/test_torch_peer_moe.py``: the session's
peer ring is given a card layout (``card_of``) of one, two or four
"cards", each run by a host thread of its own in lockstep
(``LockstepRing``), each holding its own experts' weights (and, in a
train step, their gradients and AdamW moments, and its blocks of the
dense leaves the model axis cuts) and a replica of the rest.

* ``moe_apply_dist``'s gradients for x, the router and the experts under
  autograd, at ``(1, 4)`` and ``(2, 4)`` (expert parallel) and ``(1, 8)``
  (expert-TP), capacity-bound and dropless, in the eager form and in card
  shares: within 1e-5 (scaled by the largest |g|) of the stacked mesh's,
  of the single-shard ``moe.moe_apply``'s (dropless) and of the
  reference's ``jax.grad`` of its ``moe_apply_dist`` under its mesh on 8
  CPU devices; x's and the router's gradients the same bits on every
  card;
* each card's backward run on a thread other than its forward's (as
  autograd runs a CUDA backward on a thread of its own a device): the
  same gradients, bit for bit;
* ``make_train_step`` under a ``(2, 4)`` peer mesh of four emulated
  cards, three chained steps, for reduced Mixtral-8x22B (``remat`` none,
  and full with every backward on a thread of its own), reduced Kimi K2
  (a shared expert) and Llama-3 8B (dense), each card also holding its
  blocks of the dense leaves (``place_state(state, mesh, cfg)``: its
  heads, the shared expert's and the MLP's hidden units, its vocabulary
  blocks): against the reference's unsharded step (loss 2e-3, params
  5e-3) and the port's stacked mesh step (loss rtol 1e-5, params atol
  2e-5 / rtol 1e-4, but in AdamW's ε region: where the stacked step's
  |g| fell below EPS_CONDITIONED at some step, within twice the steps'
  summed lr), every card's replicated leaves the same bits;
* a step that clips (a small ``clip_norm``): ``grad_norm`` within 1e-6
  relative of the stacked step's;
* ``place_state`` / ``unplace_state``: the state back bit for bit, the
  moments cut as their parameters; int8 moments refused.
"""

import dataclasses
import functools
import math
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.compat import make_mesh, set_mesh as jset_mesh
from repro.configs import get_config as jget_config
from repro.models import moe_dist as jmoe_dist
from repro.optim import OptimConfig as JOptimConfig
from repro.training import TrainStepConfig as JTrainStepConfig
from repro.training import init_state as jinit_state
from repro.training import make_train_step as jmake_train_step

from repro_torch.carry import state_from_numpy
from repro_torch.comm import collectives as coll
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_host_mesh, set_mesh
from repro_torch.models import moe, moe_dist
from repro_torch.optim import OptimConfig
from repro_torch.training import (TrainStepConfig, init_state,
                                  make_train_step)
from repro_torch.training import sharding as shd
from repro_torch.training import train_step as tsm
from repro_torch.training.sharding import place_card
from repro_torch.tree import leaves, leaves_with_paths

from test_torch_moe_dist import expert_weights, tokens
from test_torch_peer_moe import peer_mesh

ATOL = 1e-5
MESHES = {"ep_1x4": (1, 4), "ep_2x4": (2, 4), "tp_1x8": (1, 8)}
MODES = {"capacity": dict(capacity_factor=1.25),
         "dropless": dict(dropless=True)}
#: The card shares' forms: the number of emulated cards (None: the eager
#: form on whole parameters).
FORMS = {"eager": None, "one_card": 1, "two_cards": 2, "four_cards": 4}
EXPERTS = ("w1", "w2", "w3")


def layout(model: int, cards: int) -> list[int]:
    """``cards`` emulated cards holding runs of ``model`` devices."""
    return [d * cards // model for d in range(model)]


def lockstep(mesh, card_of: list[int], body) -> None:
    """``body(ring, card)`` on a host thread a card of ``card_of``, in
    lockstep over the mesh session's peer ring (begun over every card),
    under the mesh."""
    ring = coll.PeerRing(mesh.session.engine)
    ring.card_of = card_of
    ring.cards = (torch.device("cpu"),) * (max(card_of) + 1)
    ring.begin()
    run = coll.LockstepRing(ring)
    with set_mesh(mesh):
        coll.run_in_lockstep(run, [(torch.device("cpu"),
                                    functools.partial(body, run))]
                             * run.cards)


def on_own_thread(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` on a new host thread, as autograd runs a
    CUDA backward on a thread of its own: its result, or its error."""
    out = {}

    def work():
        try:
            out["value"] = fn(*args, **kwargs)
        except BaseException as exc:    # noqa: BLE001 - re-raised below
            out["error"] = exc

    t = threading.Thread(target=work)
    t.start()
    t.join()
    if "error" in out:
        raise out["error"]
    return out["value"]


def loss_grads(fn, x, p, g, *, thread=False):
    """Gradients of ``(out · g).sum() + aux`` for x and every leaf of
    ``p`` (sorted keys), ``fn(x, p) -> (out, aux)``; the backward on a
    thread of its own with ``thread``."""
    xs = x.clone().requires_grad_()
    ps = {k: v.clone().requires_grad_() for k, v in p.items()}
    out, aux = fn(xs, ps)
    keys = sorted(ps)
    grad = functools.partial(torch.autograd.grad,
                             (out * g).sum() + aux, [xs] + [ps[k]
                                                         for k in keys])
    got = on_own_thread(grad) if thread else grad()
    return got[0], dict(zip(keys, got[1:]))


@functools.lru_cache(maxsize=None)
def reference_grads(mesh_name: str, mode: str):
    """The reference's ``jax.grad`` of its ``moe_apply_dist`` under its
    mesh: (dx, {leaf: grad}) as numpy."""
    _, jp, _ = expert_weights()
    cfg = jget_config("mixtral_8x22b").reduced()
    x, g = tokens(3, 64, cfg.d_model), tokens(4, 64, cfg.d_model)
    kw = dict(top_k=cfg.top_k, kind=cfg.mlp, **MODES[mode])

    def loss(a, q):
        out, aux = jmoe_dist.moe_apply_dist(a, q, **kw)
        return jnp.sum(out * jnp.asarray(g)) + aux

    with jset_mesh(make_mesh(MESHES[mesh_name], ("data", "model"))):
        dx, dp = jax.jit(jax.grad(loss, argnums=(0, 1)))(jnp.asarray(x),
                                                        jp)
    return np.asarray(dx), {k: np.asarray(v) for k, v in dp.items()}


def peer_grads(mesh, cards, x, p, g, kw, *, thread=False):
    """``moe_apply_dist``'s gradients on the peer ``mesh``: the eager form
    (``cards`` None) or ``cards`` emulated cards' shares, each on its own
    placed tree. Returns (dx, {leaf: grad}) with the experts' gradients
    put back in device order, and, for the shares, every card's dx and
    router gradient."""
    if cards is None:
        with set_mesh(mesh):
            dx, dp = loss_grads(lambda a, q: moe_dist.moe_apply_dist(
                a, q, **kw), x, p, g, thread=thread)
        return dx, dp, [dx], [dp["router"]]
    model = mesh.shape["model"]
    card_of = layout(model, cards)
    got = [None] * cards

    def body(run, card):
        held = [d for d, c in enumerate(card_of) if c == card]
        tree = place_card({"moe": p}, held, model, "cpu")["moe"]
        with moe_dist.card_share(run, card):
            got[card] = loss_grads(lambda a, q: moe_dist.moe_apply_dist(
                a, q, **kw), x, tree, g, thread=thread)

    lockstep(mesh, card_of, body)
    ep = p["router"].shape[-1] % model == 0
    dp = dict(got[0][1])
    for name in EXPERTS:
        dim = 0 if ep else (1 if name == "w2" else 2)
        dp[name] = torch.cat([gr[name] for _, gr in got], dim)
    return (got[0][0], dp, [dx for dx, _ in got],
            [gr["router"] for _, gr in got])


def assert_close(got, want) -> None:
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=ATOL * max(1.0, float(np.abs(
                                   want).max())), rtol=0)


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_peer_gradients_match_stacked_single_shard_and_reference(
        mesh_name, mode, form):
    cfg, _, p = expert_weights()
    shape = MESHES[mesh_name]
    x = torch.from_numpy(tokens(3, 64, cfg.d_model))
    g = torch.from_numpy(tokens(4, 64, cfg.d_model))
    kw = dict(top_k=cfg.top_k, kind=cfg.mlp, **MODES[mode])
    dx, dp, dxs, drs = peer_grads(peer_mesh(shape), FORMS[form], x, p, g, kw)
    assert all(torch.equal(a, dx) for a in dxs)      # every card's bits
    assert all(torch.equal(a, drs[0]) for a in drs)
    with set_mesh(make_host_mesh(shape, device="cpu")):
        sx, sp = loss_grads(lambda a, q: moe_dist.moe_apply_dist(a, q, **kw),
                            x, p, g)
    rx, rp = reference_grads(mesh_name, mode)
    wants = [(sx, sp), (rx, rp)]
    if mode == "dropless":      # the single shard routes with no capacity
        wants.append(loss_grads(lambda a, q: moe.moe_apply(a, q, **kw),
                                x, p, g))
    for wx, wp in wants:
        assert_close(dx, wx)
        for name in sorted(p):
            assert_close(dp[name], wp[name])
    assert all(dp[name].abs().max() > 0 for name in sorted(p))


@pytest.mark.parametrize("cards", [1, 2, 4])
def test_a_cards_backward_on_another_thread_gives_the_same_gradients(cards):
    """Each card's backward on a new thread, where neither the card share
    nor the lockstep ring's card is set: f and g re-enter the card there,
    and the gradients are the same-thread run's, bit for bit."""
    cfg, _, p = expert_weights()
    mesh = peer_mesh((2, 4))
    x = torch.from_numpy(tokens(5, 64, cfg.d_model))
    g = torch.from_numpy(tokens(6, 64, cfg.d_model))
    kw = dict(top_k=cfg.top_k, kind=cfg.mlp, capacity_factor=1.25)
    same = peer_grads(mesh, cards, x, p, g, kw)
    other = peer_grads(mesh, cards, x, p, g, kw, thread=True)
    assert torch.equal(same[0], other[0])
    assert all(torch.equal(same[1][k], other[1][k]) for k in same[1])


# -- the train step ----------------------------------------------------------

CARD_OF = [0, 1, 2, 3]           # a (2, 4) peer mesh, a device a card
OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=5)


@pytest.fixture
def four_cards(monkeypatch):
    """The peer mesh's cards emulated: the session's ring runs CARD_OF's
    cards, and ``place_state`` / ``unplace_state`` place on them."""
    cpu = torch.device("cpu")

    class Cards(coll.PeerRing):
        def __init__(self, engine):
            super().__init__(engine)
            self.card_of, self.cards = CARD_OF, (cpu,) * 4

    monkeypatch.setattr(coll, "PeerRing", Cards)
    monkeypatch.setattr(shd, "_card_layout", lambda mesh, what: (
        (cpu,) * 4, [[d] for d in range(4)]))


def batches(cfg, n: int) -> list[dict]:
    rng = np.random.RandomState(2)
    return [{"tokens": rng.randint(0, cfg.vocab_size, (4, 16)).astype(
                 np.int32),
             "labels": rng.randint(0, cfg.vocab_size, (4, 16)).astype(
                 np.int32),
             "mask": np.ones((4, 16), np.float32)} for _ in range(n)]


@functools.lru_cache(maxsize=None)
def reference_steps(name: str, steps: int):
    """The reference's unsharded jitted step, ``steps`` chained from
    ``init_state(seed=7)``: (initial state, [(losses, params)] as numpy)."""
    jcfg = dataclasses.replace(jget_config(name).reduced(),
                               capacity_factor=8.0)
    step = jax.jit(jmake_train_step(jcfg, JTrainStepConfig(),
                                    JOptimConfig(**OPT)))
    state = jinit_state(jcfg, JOptimConfig(**OPT), seed=7)
    first = jax.tree.map(np.asarray, state)
    out = []
    for bt in batches(jcfg, steps):
        state, m = step(state, {k: jnp.asarray(v) for k, v in bt.items()})
        out.append((float(m["loss"]), [np.asarray(a, np.float32) for a in
                                       jax.tree.leaves(state["params"])]))
    return first, out


#: AdamW moves a parameter by lr · m / (sqrt(v) + eps): where |g| is near
#: eps = 1e-8 the slope is ~1/eps, so two summation orders a few 1e-9
#: apart move it by up to lr. Where a reference step's |g| fell below
#: this at some step, a parameter is held within twice the steps' summed
#: lr instead of the stated tolerance (``tools/peer_smoke.py``'s
#: MOE_TRAIN_EPS_CONDITIONED).
EPS_CONDITIONED = 1e-6
#: How many of a step's compared parameter elements may take that
#: exemption: at most ``ceil(EPS_EXEMPT_SHARE · elements)``. Measured: on
#: the CPU at most 1 a comparison (of 16,384 in the leaf, of 98,624 to
#: 360,768 in the tree: a share of 1.0e-5 or less); on the card 5,240 of
#: 1.49 B in ``chip_smoke.py``'s path AC (3.5e-6). A fault that moved
#: many small-gradient elements would take more.
EPS_EXEMPT_SHARE = 2e-5


def recording_steps(cfg, opt, mesh, state, steps: int, monkeypatch):
    """:func:`port_steps` under ``mesh`` (None: no mesh), recording where
    the step hands its gradients to AdamW: (each step's (state, metrics),
    per step the elements a leaf whose |g| fell below EPS_CONDITIONED at
    that step or before, each step's lr)."""
    small: list = []
    update = tsm._update

    def rec(params, grads, opt_state, opt_, **kw):
        now = [g.abs() < EPS_CONDITIONED for g in leaves(grads)]
        small.append(now if not small else [a | b for a, b in
                                            zip(small[-1], now)])
        return update(params, grads, opt_state, opt_, **kw)

    monkeypatch.setattr(tsm, "_update", rec)
    out = port_steps(cfg, opt, mesh, state, steps)
    monkeypatch.setattr(tsm, "_update", update)
    return out, small, [float(m["lr"]) for _, m in out]


def assert_params_close(got, want, small, lr_sum: float, atol=2e-5,
                        rtol=1e-4) -> None:
    """Leaf by leaf, ``got`` within atol/rtol of ``want``, but for the
    elements of ``small`` (AdamW's ε region), held within twice
    ``lr_sum``; those at most EPS_EXEMPT_SHARE of all the elements."""
    taken = elements = 0
    for i, (a, b, eps) in enumerate(zip(got, want, small)):
        diff = (a.float() - b.float()).abs()
        out = diff > atol + rtol * b.float().abs()
        assert not bool((out & ~eps).any()), (i, diff.max().item())
        assert bool((diff[out] <= 2 * lr_sum).all()), (i, lr_sum)
        taken += int(out.sum())
        elements += b.numel()
    assert taken <= math.ceil(EPS_EXEMPT_SHARE * elements), (taken,
                                                             elements)


def port_steps(cfg, opt, mesh, state, steps: int) -> list:
    """``steps`` chained ``make_train_step`` steps under ``mesh``: each
    step's (state, metrics)."""
    step = make_train_step(cfg, TrainStepConfig(), opt, device="cpu")
    out = []
    with set_mesh(mesh):    # None: no mesh
        for bt in batches(cfg, steps):
            state, m = step(state, {k: torch.from_numpy(v)
                                    for k, v in bt.items()})
            out.append((state, m))
    return out


def replicas_equal(trees, cfg, mesh) -> bool:
    """Every card's replicated leaves (neither experts nor the dense leaves
    its cut cuts) the same bits as card 0's."""
    cut = shd.card_cuts(cfg, mesh)[0]
    rep = [[t for path, t in leaves_with_paths(tree)
            if not shd.is_cut(path, cut)] for tree in trees]
    return all(torch.equal(a, b) for other in rep[1:]
               for a, b in zip(rep[0], other))


ARCHS = {"mixtral": ("mixtral_8x22b", "none"),
         "mixtral_remat": ("mixtral_8x22b", "full"),
         "kimi": ("kimi_k2_1t_a32b", "none"),
         "llama": ("llama3_8b", "none")}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_step_on_a_peer_mesh_matches_stacked_and_reference(
        arch, four_cards, monkeypatch):
    """Three chained steps on a (2, 4) peer mesh of four emulated cards.
    With ``remat="full"`` every backward runs on a thread of its own, so
    each layer's recompute, and its combine's psum, run there."""
    name, remat = ARCHS[arch]
    cfg = dataclasses.replace(get_config(name).reduced(),
                              capacity_factor=8.0, remat=remat)
    first, ref = reference_steps(name, 3)
    opt = OptimConfig(**OPT)
    stacked, small, lrs = recording_steps(
        cfg, opt, make_host_mesh((2, 4), device="cpu"),
        state_from_numpy(first), 3, monkeypatch)
    peer = peer_mesh((2, 4))
    if remat == "full":
        grad = torch.autograd.grad
        monkeypatch.setattr(torch.autograd, "grad", functools.partial(
            on_own_thread, grad))
    got = port_steps(cfg, opt, peer, shd.place_state(
        state_from_numpy(first), peer, cfg), 3)
    for i, ((trees, m), (s, sm), (rloss, rparams)) in enumerate(
            zip(got, stacked, ref)):
        assert len(trees) == 4 and replicas_equal(trees, cfg, peer)
        whole = shd.unplace_state(trees, peer, cfg)
        assert abs(float(m["loss"]) - rloss) < 2e-3
        np.testing.assert_allclose(float(m["loss"]), float(sm["loss"]),
                                   rtol=1e-5)
        for a, c in zip(leaves(whole["params"]), rparams):
            np.testing.assert_allclose(a.numpy(), c, atol=5e-3)
        assert_params_close(leaves(whole["params"]), leaves(s["params"]),
                            small[i], sum(lrs[:i + 1]))


def test_the_clip_norm_is_over_every_card(four_cards):
    """A small ``clip_norm`` clips every step: ``grad_norm`` (the replicated
    leaves' squares plus the psum of each card's experts') within 1e-6
    relative of the stacked step's, and the parameters as there."""
    cfg = dataclasses.replace(get_config("mixtral_8x22b").reduced(),
                              capacity_factor=8.0)
    first, _ = reference_steps("mixtral_8x22b", 3)
    opt = OptimConfig(**OPT, clip_norm=1e-2)
    stacked = port_steps(cfg, opt, make_host_mesh((2, 4), device="cpu"),
                         state_from_numpy(first), 2)
    peer = peer_mesh((2, 4))
    got = port_steps(cfg, opt, peer, state_from_numpy(first), 2)
    for (trees, m), (s, sm) in zip(got, stacked):
        assert float(sm["grad_norm"]) > 10 * opt.clip_norm
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(sm["grad_norm"]), rtol=1e-6)
        whole = shd.unplace_state(trees, peer, cfg)
        for a, b in zip(leaves(whole["params"]), leaves(s["params"])):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5,
                                       rtol=1e-4)


# -- the placement -----------------------------------------------------------

@pytest.mark.parametrize("shape", [(1, 4), (1, 8)], ids=["ep", "tp"])
@pytest.mark.parametrize("cards", [1, 2, 4])
def test_place_state_round_trip(shape, cards, monkeypatch):
    """``unplace_state(place_state(s))`` is ``s`` bit for bit; each card's
    moments are cut as its parameters."""
    first, _ = reference_steps("kimi_k2_1t_a32b", 3)
    state = state_from_numpy(first)
    gen = torch.Generator().manual_seed(5)
    for path, t in leaves_with_paths(state["opt"]):
        if path[0] in ("m", "v"):
            t.copy_(torch.randn(t.shape, generator=gen))
    model = shape[1]
    card_of = layout(model, cards)
    cpu = torch.device("cpu")
    monkeypatch.setattr(shd, "_card_layout", lambda mesh, what: (
        (cpu,) * cards, [[d for d in range(model) if card_of[d] == c]
                         for c in range(cards)]))
    mesh = peer_mesh(shape)
    cfg = get_config("kimi_k2_1t_a32b").reduced()
    trees = shd.place_state(state, mesh, cfg)
    assert len(trees) == cards
    for tree in trees:
        moe_p = tree["params"]["layers"]["moe"]
        for key in ("m", "v"):
            moe_m = tree["opt"][key]["layers"]["moe"]
            assert all(moe_m[n].shape == moe_p[n].shape for n in EXPERTS)
        assert moe_p["w1"].numel() * cards == (
            state["params"]["layers"]["moe"]["w1"].numel())
    back = shd.unplace_state(trees, mesh, cfg)
    assert all(torch.equal(a, b) for a, b in zip(leaves(back),
                                                 leaves(state)))


def test_place_state_refuses_int8_moments_and_a_stacked_mesh():
    cfg = get_config("mixtral_8x22b").reduced()
    state = init_state(cfg, OptimConfig(moment_dtype="int8"),
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
    with pytest.raises(ValueError, match="int8 moments"):
        shd.place_state(state, peer_mesh((1, 4)), cfg)
    state = init_state(cfg, OptimConfig(),
                       generator=torch.Generator().manual_seed(0),
                       device="cpu")
    with pytest.raises(ValueError, match="peer mesh"):
        shd.place_state(state, make_host_mesh((1, 4), device="cpu"), cfg)
