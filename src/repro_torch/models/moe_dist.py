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

Training under a peer mesh (the combine's backward across cards) is not
ported: a call under autograd raises.
"""

from __future__ import annotations

import contextlib
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


#: What a call under autograd on a peer mesh raises.
PEER_TRAINING = ("training under a peer mesh (the MoE combine's backward "
                 "across cards) comes with a later slice of the port; "
                 "train under a stacked mesh (make_host_mesh(device=...))")

_SHARE = threading.local()


@contextlib.contextmanager
def card_share(ring, card: int):
    """Inside: :func:`moe_apply_dist` on a peer mesh runs card ``card``'s
    share of a program over ``ring`` (a
    :class:`~repro_torch.comm.collectives.PeerRing` begun for this run, or
    a :class:`~repro_torch.comm.collectives.LockstepRing`): the rows of
    the logical devices ``ring.card_of`` puts on ``card``, from the card's
    placed experts, and its share of each combine. Per thread (the
    lockstep run gives each card a thread of its own)."""
    prev = getattr(_SHARE, "run", None)
    _SHARE.run = (ring, card)
    try:
        yield
    finally:
        _SHARE.run = prev


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


def _requires_grad(x: torch.Tensor, params: dict) -> bool:
    return torch.is_grad_enabled() and (x.requires_grad or any(
        w.requires_grad for w in params.values()
        if isinstance(w, torch.Tensor)))


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
    if peer and _requires_grad(x, params):
        raise NotImplementedError(PEER_TRAINING)
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
        held = [r for r, c in enumerate(ring.card_of) if c == card]
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
        xl = x[i * tl:(i + 1) * tl]
        r = route(xl, params["router"], top_k=top_k, capacity=capacity)
        rows = [_row_contribution(xl, r, w, row, ep=ep, num_experts=e,
                                  model=model, kind=kind)
                for row, w in zip(held, weights)]
        if not peer:
            outs.append(CombineFn.apply(torch.stack(rows), coll)[0])
        elif share is None:
            devices = mesh.session.devices
            outs.append(coll.psum([y.to(dev) for y, dev in zip(
                rows, devices)])[0].to(x.device))
        else:
            parts = [None] * model
            for row, y in zip(held, rows):
                parts[row] = y
            outs.append(coll_lib.FORMS["psum"](parts, ring)[held[0]])
    out = outs[0] if ndp == 1 else torch.cat(outs)
    return out, aux
