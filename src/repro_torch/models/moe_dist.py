"""Distributed MoE: expert parallelism over a logical mesh's model axis.

The port of the reference's ``models/moe_dist.py``, on the device-stacked
emulation of a mesh (every logical device a row on one ``torch.device``,
:class:`~repro_torch.launch.mesh.LogicalMesh`):

* tokens enter replicated across the model axis and split across the
  data axes (each data index routes its own ``T / data`` tokens, with its
  own capacity),
* **dispatch is communication-free**: routing is the same on every model
  row (computed once per data index), and each row scatters only the
  pairs routed to ITS ``E / model`` experts (EP) — or, when ``E % model``
  is not 0, every pair into its ff-shard of every expert (expert-TP),
* each row runs its expert products on its own weights, views of the
  whole (with ``fsdp`` and a data axis, the row's weights are first
  gathered from their data shards through the session's ring
  all-gather),
* **the combine is ONE psum over the model axis** of the ``(T_local, d)``
  outputs, through the mesh session's ``collectives.psum`` (the ring that
  runs ``ring_allgather``): each token's k expert contributions live on
  at most k rows and the others add zeros; under expert-TP the psum adds
  the ff-shards' partial sums. Under autograd the combine's backward is
  the psum of the cotangent rows, through the same ring
  (:class:`CombineFn`). A cost count of meta tensors on a mesh with no
  session (the production shape) records each collective call in place
  of running it (:class:`~repro_torch.launch.cost.CountingCollectives`).

Every call of the ring records its own kernel launches, so a layer under
a mesh can be captured in a CUDA graph (the serving programs, a captured
step). The single-shard :mod:`.moe` stays the reference of this module;
the two agree within float rounding.

On a **peer mesh** (``make_host_mesh(..., devices=[...])``: each logical
device a tensor on its own device, several a card or one) the rows are
per-device tensors and the combine is ONE peer psum of their list
(:data:`~repro_torch.comm.collectives.FORMS` ``"psum"``: a reduce-scatter
whose every block is added once, by its owner, then an all-gather, so
every device receives the same bits, those of the stacked mesh's row 0):

* inside a card's share of a program (:func:`card_share`, as the serving
  engine's bodies run: one a card, on the card's tree of
  :func:`~repro_torch.training.sharding.place_params`), the card computes
  the rows of the logical devices it holds from its own experts and runs
  its share of the psum over the program's ring, ``None`` for the other
  cards' devices; it keeps the result of its first held device;
* outside one (an eager call on whole parameters), every row is computed
  and moved to its device, and the combine is
  ``session.collectives.psum(list)``: one dispatch a data index.

Under autograd on a peer mesh every card computes the whole loss from
replicated activations, so the combine's backward is Megatron's
conjugate pair
(:class:`PeerCombineFn`, :class:`PeerGatherFn`): around the combine, g
(forward the card's share of the psum, backward the identity: each of
the card's rows gets the combine output's cotangent, the same on every
card), and on what the rows read (the tokens and the router as the gates
use it), f (forward the identity, backward ONE peer psum of the card's
cotangents, so that each card's ``dx`` and router gradient hold every
card's experts' share). The aux loss stays outside f: each card computes
it whole. Both keep their ring and card and re-enter the card on the
thread that runs their backward (on CUDA autograd's own thread a device),
and :func:`in_this_share` does the same for a checkpointed layer's
recompute. The eager form's backward (:class:`PeerEagerCombineFn`) is
the peer psum of the cotangent list, ``g`` at device 0 and zeros
elsewhere, as :class:`CombineFn`'s is over the stacked rows.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch

from repro_torch.comm import collectives as coll_lib
from repro_torch.launch import cost
from repro_torch.launch.mesh import ambient_mesh, is_peer
from repro_torch.models.moe import (Routes, aux_loss, capacity_of, combine,
                                    expert_ffn, route)


class CombineFn(torch.autograd.Function):
    """The model-axis psum of the stacked ``(model, T, d)`` contributions
    through ``collectives``; its backward is the psum of the cotangent
    rows, so each row's contribution gets the sum of the rows'
    cotangents."""

    @staticmethod
    def forward(ctx, rows: torch.Tensor, collectives) -> torch.Tensor:
        ctx.collectives = collectives
        return collectives.psum(rows)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return ctx.collectives.psum(grad.contiguous()), None


class PeerEagerCombineFn(torch.autograd.Function):
    """The eager form's combine on a peer mesh: ``collectives.psum`` of
    the rows (one on each logical device), device 0's sum. Its backward
    is the peer psum of the cotangent list, ``g`` at device 0 and zeros
    elsewhere (adding zeros is exact): each row's gradient ``g``, on its
    device."""

    @staticmethod
    def forward(ctx, collectives, *rows: torch.Tensor) -> torch.Tensor:
        ctx.collectives = collectives
        ctx.devices = [y.device for y in rows]
        return collectives.psum(list(rows))[0]

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        cot = [grad.contiguous()] + [
            torch.zeros(grad.shape, dtype=grad.dtype, device=dev)
            for dev in ctx.devices[1:]]
        return (None, *ctx.collectives.psum(cot))


_SHARE = threading.local()


@contextlib.contextmanager
def card_share(ring, card: int, cut=None):
    """Inside: :func:`moe_apply_dist` on a peer mesh runs card ``card``'s
    share of a program over ``ring`` (a
    :class:`~repro_torch.comm.collectives.PeerRing` begun for this run, or
    a :class:`~repro_torch.comm.collectives.LockstepRing`): the rows of
    the logical devices ``ring.card_of`` puts on ``card``, from the card's
    placed experts, and its share of each combine. ``cut`` (a
    :class:`~repro_torch.models.tensor_parallel.DenseCut`, the serving
    engine's or the train step's) says which dense leaves the card's tree
    holds cut, and the transformer then runs them tensor parallel (under
    autograd inside the conjugate pair); None leaves every dense leaf a
    replica. Per thread (the lockstep run gives each card a thread of its
    own)."""
    prev = getattr(_SHARE, "run", None), getattr(_SHARE, "cut", None)
    _SHARE.run, _SHARE.cut = (ring, card), cut
    try:
        yield
    finally:
        _SHARE.run, _SHARE.cut = prev


def current_share():
    """``(ring, card, cut)`` of the card share in force on this thread, or
    None outside one."""
    run = getattr(_SHARE, "run", None)
    return None if run is None else (*run, getattr(_SHARE, "cut", None))


@contextlib.contextmanager
def _entered(ring, card: int, cut=None):
    """Card ``card``'s share over ``ring`` on this thread: the lockstep
    ring's card (:meth:`~repro_torch.comm.collectives.LockstepRing.enter`)
    and :func:`card_share`."""
    enter = getattr(ring, "enter", None)
    if enter is not None:
        enter(card)
    with card_share(ring, card, cut):
        yield


def in_this_share(fn):
    """``fn``, run under the card share in force on this thread now on
    whatever thread calls it later: a checkpointed layer's recompute runs
    in the backward, on CUDA on autograd's thread, where no share is in
    force. ``fn`` itself outside a share."""
    share = current_share()
    if share is None:
        return fn

    @functools.wraps(fn)
    def bound(*args, **kwargs):
        with _entered(*share):
            return fn(*args, **kwargs)
    return bound


def _held(ring, card: int) -> list[int]:
    return [d for d, c in enumerate(ring.card_of) if c == card]


def _share_of_psum(ring, card: int, rows) -> torch.Tensor:
    """Card ``card``'s share of ONE peer psum over ``ring``, ``rows`` the
    parts of its held devices: the sum over every device, the same bits
    on every card, a view of the ring's buffers."""
    held = _held(ring, card)
    parts = [None] * ring.n
    for d, y in zip(held, rows):
        parts[d] = y
    return coll_lib.FORMS["psum"](parts, ring)[held[0]]


def share_psum(ring, card: int, x: torch.Tensor) -> torch.Tensor:
    """:func:`_share_of_psum` of ``x`` from card ``card`` (at its first
    held device, zeros at its others; adding zeros is exact): the sum of
    the cards' ``x``."""
    zeros = [torch.zeros_like(x)] * (len(_held(ring, card)) - 1)
    return _share_of_psum(ring, card, [x] + zeros)


class PeerCombineFn(torch.autograd.Function):
    """g: the combine of a card's share, ``rows`` its held devices'
    contributions. Forward: the card's share of ONE peer psum over
    ``ring``. Backward: the identity, each row the combine output's
    cotangent (everything after the combine is replicated, so the
    cotangent is the same on every card)."""

    @staticmethod
    def forward(ctx, ring, card: int, *rows: torch.Tensor) -> torch.Tensor:
        ctx.count = len(rows)
        return _share_of_psum(ring, card, rows)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return (None, None) + (grad,) * ctx.count


class PeerGatherFn(torch.autograd.Function):
    """f: on what a card's rows read, the tokens ``x`` and the ``router``
    as the gates use it. Forward: the identity. Backward: the card's share
    of ONE peer psum over ``ring`` of its two cotangents (in float32, one
    flat operand; adding the other cards' shares and zeros), so that each
    card's gradients hold every card's experts' share. Re-enters the card
    on the thread that runs it."""

    @staticmethod
    def forward(ctx, ring, card: int, x: torch.Tensor,
                router: torch.Tensor):
        ctx.run = (ring, card)
        return x.view_as(x), router.view_as(router)

    @staticmethod
    def backward(ctx, dx: torch.Tensor, drouter: torch.Tensor):
        flat = torch.cat([dx.reshape(-1).float(),
                          drouter.reshape(-1).float()])
        with _entered(*ctx.run):
            total = share_psum(*ctx.run, flat).clone()
        n = dx.numel()
        return (None, None, total[:n].view(dx.shape).to(dx.dtype),
                total[n:].view(drouter.shape).to(drouter.dtype))


def _mesh_info():
    mesh = ambient_mesh()
    if mesh is None:
        return None
    model = mesh.shape.get("model", 1)
    if model <= 1:
        return None
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return mesh, dp, model


def _collectives(mesh, x: torch.Tensor):
    """The mesh session's collectives (a peer mesh's take and return
    per-device lists); for a mesh with no session (the production shape),
    while a cost count of meta tensors is in force, its counting stand-in,
    which records each call and runs nothing."""
    if mesh.session is not None:
        return mesh.session.collectives
    if x.device.type == "meta" and cost.active() is not None:
        return cost.CountingCollectives()
    raise ValueError(f"{mesh} has no session to run its model-axis psum on")


def _gather_data_shards(w: torch.Tensor, dim: int, data: int,
                        collectives) -> torch.Tensor:
    """ZeRO-3's gather before use: ``w`` cut into ``data`` shards along
    ``dim``, stacked as the data rows, all-gathered through the session's
    ring, and the first row's whole weight returned (every row holds the
    same)."""
    shards = torch.stack(torch.chunk(w.movedim(dim, 0), data, dim=0))
    return collectives.all_gather(shards)[0].movedim(0, dim)


def _row_weights(params: dict, r: int, *, ep: bool, model: int):
    """Model row ``r``'s expert weights, views of the whole: its ``E /
    model`` experts (EP), or its ff-shard of every expert (expert-TP)."""
    out = {}
    for name in ("w1", "w3", "w2"):
        if name not in params:
            continue
        w = params[name]
        if ep:
            el = w.shape[0] // model
            out[name] = w[r * el:(r + 1) * el]
        else:
            ff_dim = 1 if name == "w2" else 2
            out[name] = torch.chunk(w, model, dim=ff_dim)[r]
    return out


def _row_contribution(x: torch.Tensor, r: Routes, w: dict, row: int, *,
                      ep: bool, num_experts: int, model: int,
                      kind: str) -> torch.Tensor:
    """Model row ``row``'s ``(T, d)`` share of the output: the pairs it
    owns (EP) or its ff-shard's partial sums (expert-TP), gated and added
    per token in ascending expert order; zeros for every other pair."""
    c = r.capacity
    d = x.shape[1]
    if ep:
        el = num_experts // model
        e0 = row * el
        mine = r.keep & (r.expert >= e0) & (r.expert < e0 + el)
        local = torch.where(mine, r.row - e0 * c, el * c)
        n_buf = el
    else:
        mine = r.keep
        local = r.row
        n_buf = num_experts
    rows = n_buf * c
    buf = x.new_zeros((rows + 1, d))
    buf.index_copy_(0, local, x[r.token])
    y = expert_ffn(buf[:rows].view(n_buf, c, d), w, kind)
    back = y.view(rows, d)[local.clamp(max=rows - 1)]
    return combine(back, mine, r, x.dtype)


def _local_collectives(mesh):
    """Collectives over device-stacked rows on one device, for a peer
    mesh's FSDP gather, whose data shards all lie on one card."""
    from repro_torch.comm.session import BoundCollectives

    return BoundCollectives(mesh.session.config.axis_name)


def moe_apply_dist(x: torch.Tensor, params: dict, *, top_k: int, kind: str,
                   capacity_factor: float = 1.25, dropless: bool = False,
                   fsdp: bool = False):
    """Expert-parallel MoE on the ambient mesh. x: ``(T, d)`` → ``(out,
    aux)``, or None when no mesh with a model axis over 1 is ambient or
    the data axes do not divide T (the caller then runs
    :func:`~.moe.moe_apply`). Shared experts are the caller's. The aux
    loss is over all of x's tokens, as the reference computes it outside
    its per-device body. On a peer mesh, ``params`` are a card's placed
    tree inside :func:`card_share`, else the whole (module docstring)."""
    info = _mesh_info()
    if info is None:
        return None
    mesh, dp, model = info
    peer = is_peer(mesh)
    coll = _collectives(mesh, x)
    share = getattr(_SHARE, "run", None) if peer else None
    t, d = x.shape
    e = params["router"].shape[-1]
    ndp = 1
    for a in dp:
        ndp *= mesh.shape[a]
    if t % ndp:
        return None
    tl = t // ndp
    capacity = capacity_of(tl, e, top_k, capacity_factor, dropless)
    ep = e % model == 0
    probs = torch.softmax(x.float() @ params["router"], dim=-1)
    aux = aux_loss(probs, torch.topk(probs, top_k, dim=-1).indices)

    # the model rows this call computes, and their experts: a card's
    # share holds its own devices' (its tree cut to them), else every row
    if share is None:
        held = list(range(model))
        if peer and ep and params["w1"].shape[0] != e:
            raise ValueError(
                f"an eager call on a peer mesh takes the whole parameters "
                f"({e} experts), got {params['w1'].shape[0]}: a card's "
                f"placed tree runs inside moe_dist.card_share")
    else:
        ring, card = share
        held = _held(ring, card)
    weights = [_row_weights(params, j, ep=ep, model=len(held))
               for j in range(len(held))]
    data = mesh.shape.get("data", 1)
    if fsdp and "data" in mesh.axis_names and data > 1:
        # each row's weights are sharded over the data axis on their
        # non-TP dim (d of w1/w3, the last of w2): gather before use (on a
        # peer mesh the data axis shares the model rows' devices)
        gather = _local_collectives(mesh) if peer else coll
        weights = [{name: _gather_data_shards(
            w, 2 if name == "w2" else 1, data, gather)
            for name, w in row.items()} for row in weights]

    outs = []
    for i in range(ndp):
        xl, router = x[i * tl:(i + 1) * tl], params["router"]
        if share is not None:
            xl, router = PeerGatherFn.apply(ring, card, xl, router)
        r = route(xl, router, top_k=top_k, capacity=capacity)
        rows = [_row_contribution(xl, r, w, row, ep=ep, num_experts=e,
                                  model=model, kind=kind)
                for row, w in zip(held, weights)]
        if not peer:
            outs.append(CombineFn.apply(torch.stack(rows), coll)[0])
        elif share is None:
            devices = mesh.session.devices
            outs.append(PeerEagerCombineFn.apply(coll, *(
                y.to(dev) for y, dev in zip(rows, devices))).to(x.device))
        else:
            outs.append(PeerCombineFn.apply(ring, card, *rows))
    out = outs[0] if ndp == 1 else torch.cat(outs)
    return out, aux
