"""Train-step builders: loss → grads → AdamW, with grad accumulation.

The counterpart of the reference's ``repro/training/train_step.py``. State
is ``{"params": ..., "opt": ...}``, nested dicts of tensors in the
reference's layout; ``opt["step"]`` is a 0-d int32 tensor, and nothing in a
step reads a value back to the host, so a step can be captured.

Three builders:

* :func:`make_train_step` — one device, the whole batch.
* :func:`make_dp_train_step` — data parallelism over a
  :class:`~repro_torch.comm.session.CommSession`'s logical devices,
  device-stacked on the session's one ``torch.device``: the global batch
  is split into ``comm.num_devices`` shards, each shard's loss and grads
  come from autograd on the one replicated state, the grads are stacked
  ``(n, ...)`` per leaf and averaged with ``comm.collectives.pmean`` (the
  multipath ring all-reduce), and so is the loss.
* :func:`make_captured_dp_train_step` — the same step captured as ONE
  heterogeneous graph on ``comm.capture``: grad compute, the ``n − 1``
  rounds of the multipath ring all-reduce (``captured_psum``) and the
  AdamW update, replayed as one ``torch.cuda.CUDAGraph`` per call.

Both DP steps also run on a peer session (``CommSession(devices=[...])``,
one logical device a card): the state is then one replica a device
(:func:`replicate_state`), each device's grads and update run on its own
card, and the results are the stacked session's bit for bit.

Under an ambient peer mesh (``make_host_mesh(..., devices=[...])``)
:func:`make_train_step` trains expert and tensor parallel: each card
holds its own experts and its blocks of the dense leaves the model axis
cuts (whole heads, hidden units, vocabulary blocks, RWKV-6's heads and
Mamba's channels), with their
gradients and AdamW moments, and a replica of every other leaf
(:func:`~repro_torch.training.sharding.place_state`), and runs its share
of the loss inside its card share
(:func:`~repro_torch.models.moe_dist.card_share` with its
:class:`~repro_torch.models.tensor_parallel.DenseCut`): every MoE
combine and tensor-parallel psum and their backwards peer psums over
the cards, the loss from the cards' vocabulary blocks; one host thread a
card.

Every family trains, the audio encoder too (a batch of float32
``features`` and ``labels`` in place of ``tokens``; the captured step's
static batch buffers take the features as they come). On the card
attention's backward is the hand-written ``flash_attention`` backward
kernel (head dims that are multiples of 8 up to 128: HuBERT's 80 and Kimi
K2's 112 among them) and RWKV-6's the ``rwkv6_scan`` backward kernel; the
Mamba scan (plain torch ops) and the MoE's routing, dispatch and expert
products (with the capacity factor, dropping past it, and the aux loss)
are differentiated by autograd. On the CPU every kernel's plain version
is differentiated by autograd.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import weakref
from typing import TYPE_CHECKING, Callable

import torch
import torch.nn.functional as F

from repro_torch.comm import collectives as coll
from repro_torch.comm.capture import BufferSpec, captured_psum, dtype_name
from repro_torch.comm.session import on_device, resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import ambient_mesh, is_peer
from repro_torch.models import moe_dist
from repro_torch.models import transformer as tfm
from repro_torch.optim import OptimConfig, apply_updates, init_opt_state
from repro_torch.optim.adamw import opt_state_shapes
from repro_torch.training import sharding as shd
from repro_torch.tree import (flatten_up_to, leaves, leaves_with_paths,
                              tree_map, unflatten)

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.comm.session import CommSession
    from repro_torch.launch.mesh import LogicalMesh


@dataclasses.dataclass(frozen=True)
class TrainStepConfig:
    microbatches: int = 1          # gradient accumulation factor
    aux_coef: float = 0.01


def make_loss_fn(cfg: ArchConfig, ts: TrainStepConfig):
    def loss(params, batch):
        return tfm.loss_fn(params, cfg, batch, aux_coef=ts.aux_coef)
    return loss


def _value_and_grad(loss_fn: Callable) -> Callable:
    """``(params, batch) -> (loss, grads)``: autograd on fresh leaves over
    the parameters' storage (``torch.autograd.grad``, so nothing collects
    in ``.grad``); grads in each parameter's dtype."""
    def vg(params, batch):
        with torch.enable_grad():
            ps = [p.detach().requires_grad_() for p in leaves(params)]
            loss = loss_fn(unflatten(params, ps), batch)
            grads = torch.autograd.grad(loss, ps, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(ps, grads)]
        return loss.detach(), unflatten(params, grads)
    return vg


def _make_grad_fn(cfg: ArchConfig, ts: TrainStepConfig) -> Callable:
    """``(params, batch) -> (loss, grads)`` with microbatch accumulation:
    the batch's leading dim is split in ``ts.microbatches`` and the grads
    are summed in float32 (then float32 grads, as the reference's scan)."""
    grad_fn = _value_and_grad(make_loss_fn(cfg, ts))

    def grads_of(params, batch):
        if ts.microbatches == 1:
            return grad_fn(params, batch)
        mb = ts.microbatches
        acc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                             device=p.device), params)
        loss_acc = None
        for i in range(mb):
            micro = {k: x.reshape((mb, x.shape[0] // mb) + x.shape[1:])[i]
                     for k, x in batch.items()}
            loss, grads = grad_fn(params, micro)
            acc = tree_map(lambda a, g: a + g.to(torch.float32), acc, grads)
            loss_acc = loss if loss_acc is None else loss_acc + loss
        return loss_acc / mb, tree_map(lambda g: g / mb, acc)

    return grads_of


def _update(params, grads, opt_state, opt: OptimConfig, **kw):
    with torch.no_grad():
        return apply_updates(params, grads, opt_state, opt, **kw)


def _peer_norm(grads, ring, card: int, cut) -> torch.Tensor:
    """The global gradient norm of a peer mesh's step, from card ``card``'s
    tree under its dense ``cut``: each leaf's float32 sum of squares,
    every cut leaf's (expert or dense, :func:`~repro_torch.training.
    sharding.is_cut`) summed over the cards by ONE peer psum over
    ``ring`` (of one element a leaf: the same bits on every card), then
    every leaf's added in leaf order, as
    :func:`~repro_torch.optim.adamw.global_norm` adds them (on one card,
    its bits)."""
    sqs = [(shd.is_cut(path, cut),
            torch.sum(torch.square(g.to(torch.float32))))
           for path, g in leaves_with_paths(grads)]
    own = [sq for mine, sq in sqs if mine]
    summed = iter(moe_dist.share_psum(ring, card, torch.stack(own)).unbind(0)
                  if own else ())
    total = None
    for mine, sq in sqs:
        term = next(summed) if mine else sq
        total = term if total is None else total + term
    return torch.sqrt(total)


def _make_peer_step(grads_of: Callable, opt: OptimConfig,
                    cfg: ArchConfig) -> Callable:
    """``step(trees, batch, mesh)``: :func:`make_train_step`'s step on the
    peer mesh ``mesh``. Each card's share runs its forward and backward
    (``grads_of``) inside :func:`~repro_torch.models.moe_dist.card_share`
    under its :func:`~repro_torch.training.sharding.card_cuts` cut, then
    the norm over the cards (:func:`_peer_norm`) and AdamW on its own
    tree; one card directly, several one host thread a card in lockstep
    over the session's ring (:class:`~repro_torch.comm.collectives.
    LockstepRing`), begun once a step, each card's backward on its own
    thread (autograd's threads a device off: two cards on one device
    would otherwise share one, and one card's psum would wait on the
    other's, queued behind it)."""
    rings: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()

    def step(trees, batch, mesh):
        session = mesh.session
        ring = rings.get(session)
        if ring is None:
            ring = rings[session] = coll.PeerRing(session.engine)
        if isinstance(trees, dict):
            trees = shd.place_state(trees, mesh, cfg)
        shd.check_placed(trees, mesh, cfg, state_shapes(cfg, opt),
                         "place_state(state, mesh, cfg)")
        cards, cuts = ring.cards, shd.card_cuts(cfg, mesh)
        out: list = [None] * len(cards)

        def share(run, card: int) -> None:
            dev, tree, cut = cards[card], trees[card], cuts[card]
            with moe_dist.card_share(run, card, cut), on_device(dev), \
                    torch.autograd.set_multithreading_enabled(
                        len(cards) == 1):
                loss, grads = grads_of(tree["params"], {
                    k: x.to(dev) for k, x in batch.items()})
                new_params, new_opt, metrics = _update(
                    tree["params"], grads, tree["opt"], opt,
                    gnorm=_peer_norm(grads, run, card, cut))
            metrics["loss"] = loss
            out[card] = ({"params": new_params, "opt": new_opt}, metrics)

        ring.begin()
        if len(cards) == 1:
            share(ring, 0)
        else:
            lockstep = coll.LockstepRing(ring)
            coll.run_in_lockstep(lockstep, [
                (dev, functools.partial(share, lockstep)) for dev in cards])
        return [tree for tree, _ in out], out[0][1]

    return step


def make_train_step(cfg: ArchConfig, ts: TrainStepConfig, opt: OptimConfig,
                    *, device=None) -> Callable:
    """Returns ``step(state, batch) -> (state, metrics)``.

    ``state = {"params": ..., "opt": ...}`` on ``device`` (default: the
    card; ``"meta"`` for a step that is only counted,
    :mod:`repro_torch.launch.cost`); batch: tensors on it. With
    ``ts.microbatches > 1`` the batch's leading dim is split and gradients
    are accumulated in float32. Metrics ``loss``, ``grad_norm`` and ``lr``
    are 0-d tensors on the device.

    Under an ambient peer mesh the step trains expert and tensor
    parallel (:func:`_make_peer_step`): ``state`` is the list of
    :func:`~repro_torch.training.sharding.place_state` ``(state, mesh,
    cfg)`` (one tree is placed first; trees cut otherwise raise
    ``ValueError``), the batch is staged to every card, and the step
    returns the list of new trees and card 0's metrics, ``grad_norm`` the
    norm over every card's gradients. Its replicated leaves, the loss and
    ``grad_norm`` are the same bits on every card."""
    resolve_device(device, allow_meta=True)
    grads_of = _make_grad_fn(cfg, ts)
    peer_step = _make_peer_step(grads_of, opt, cfg)

    def step(state, batch):
        mesh = ambient_mesh()
        if is_peer(mesh):
            return peer_step(state, batch, mesh)
        params = state["params"]
        loss, grads = grads_of(params, batch)
        new_params, new_opt, metrics = _update(params, grads, state["opt"],
                                               opt)
        metrics["loss"] = loss
        return {"params": new_params, "opt": new_opt}, metrics

    return step


def _shards(batch: dict, n: int) -> list[dict]:
    for key, x in batch.items():
        if x.shape[0] % n:
            raise ValueError(f"global batch dim {x.shape[0]} of {key!r} not "
                             f"divisible by {n} devices")
    return [{k: x.reshape((n, x.shape[0] // n) + x.shape[1:])[i]
             for k, x in batch.items()} for i in range(n)]


def replicate_state(state, comm: "CommSession") -> list:
    """One replica of ``state`` a logical device of the peer session
    ``comm``: a list of ``comm.num_devices`` trees, tree *d* a copy of
    every leaf on ``devices[d]`` (the peer DP steps' state)."""
    return [tree_map(lambda t, d=d: t.to(d, copy=True), state)
            for d in comm.devices]


def _replicas(state, comm: "CommSession") -> list:
    """A peer step's state as per-device replicas: ``state`` itself when
    it is a list of them, else :func:`replicate_state` of the one tree."""
    if isinstance(state, dict):
        return replicate_state(state, comm)
    if len(state) != comm.num_devices:
        raise ValueError(f"a peer step takes one state a logical device "
                         f"({comm.num_devices}), got {len(state)}")
    return list(state)


#: A signed integer dtype of each element size, to digest a tensor's bits.
_INT_OF_SIZE = {1: torch.int8, 2: torch.int16, 4: torch.int32,
                8: torch.int64}

#: The prime whose residues weight :func:`_bits_digest`'s second sum.
_DIGEST_PRIME = 65521


def _bits_digest(x: torch.Tensor) -> torch.Tensor:
    """Two sums of ``x``'s elements read as integers of their size, the
    second with element *i* weighted by ``i mod 65521 + 1``, so that
    changes which cancel in the plain sum (+1 ulp in one element, -1 in
    another) show: an int64 ``(2,)`` on ``x``'s device, equal for tensors
    of equal bits."""
    v = x.reshape(-1).view(_INT_OF_SIZE[x.element_size()]).to(torch.int64)
    cols = F.pad(v, (0, -v.numel() % _DIGEST_PRIME)).view(
        -1, _DIGEST_PRIME).sum(0)
    w = torch.arange(1, _DIGEST_PRIME + 1, device=v.device)
    return torch.stack([cols.sum(), (cols * w).sum()])


def make_dp_train_step(cfg: ArchConfig, ts: TrainStepConfig,
                       opt: OptimConfig, comm: "CommSession") -> Callable:
    """Data-parallel step with manual multipath gradient collectives.

    The returned ``step(state, batch) -> (state, metrics)`` emulates
    ``comm.num_devices`` data-parallel replicas on the session's device:
    the replicated state is shared, the batch is split on its leading dim,
    each shard's grads (and loss) are stacked ``(n, ...)`` per leaf and
    averaged with ``comm.collectives.pmean`` — the multipath ring
    all-reduce — and every row of each mean is checked equal before row 0
    feeds the update. Equal to :func:`make_train_step` within float
    tolerance (mean of shard means = global mean for equal shards).

    On a peer session (``CommSession(devices=[...])``) every logical
    device is a replica on its own device: ``state`` is the list of
    :func:`replicate_state` (one tree is replicated first), shard *d* of
    the batch goes to ``devices[d]``, its grads come from autograd on
    replica *d* launched on that device, and each leaf and the loss are
    averaged by ``comm.collectives.pmean`` on the per-device list, leaf by
    leaf as above, so every replica's mean is the stacked step's row bit
    for bit. Each replica takes its own AdamW update; the means' bits are
    digested on each device (:func:`_bits_digest`) and compared on the
    host once a step. Returns the list of new replicas and device 0's
    metrics."""
    grads_of = _make_grad_fn(cfg, ts)
    n = comm.num_devices
    peer = comm.devices is not None
    devices = comm.devices if peer else [comm.device] * n

    def step(state, batch):
        replicas = _replicas(state, comm) if peer else [state] * n
        per = []
        for dev, rep, shard in zip(devices, replicas, _shards(batch, n)):
            with on_device(dev):
                per.append(grads_of(rep["params"],
                                    {k: x.to(dev) for k, x in shard.items()}))
        # what shows each mean's rows equal: a 0-d bool (stacked), or one
        # digest a device (peer)
        checks = []

        def mean(rows: list) -> list:
            if peer:
                out = comm.collectives.pmean(rows)
                checks.append([_bits_digest(m) for m in out])
                return out
            out = comm.collectives.pmean(torch.stack(rows))
            checks.append(torch.all(out == out[:1]))
            return list(out.unbind(0))

        means = [mean(list(rows))
                 for rows in zip(*(leaves(g) for _, g in per))]
        loss = mean([loss for loss, _ in per])
        if peer:
            seen = [torch.stack(got).cpu() for got in zip(*checks)]
            agreed = all(torch.equal(s, seen[0]) for s in seen[1:])
        else:
            agreed = bool(torch.stack(checks).all())
        if not agreed:
            raise RuntimeError(_UNEQUAL)
        new_states = []
        for d in range(n if peer else 1):
            grads = unflatten(replicas[0]["params"], [m[d] for m in means])
            with on_device(devices[d]):
                new_params, new_opt, mets = _update(
                    replicas[d]["params"], grads, replicas[d]["opt"], opt)
            new_states.append({"params": new_params, "opt": new_opt})
            if d == 0:
                metrics = mets
                metrics["loss"] = loss[0]
        return (new_states if peer else new_states[0]), metrics

    return step


#: What a DP step raises when the replicas' means differ.
_UNEQUAL = "pmean gave unequal rows: the replicas disagree"


#: The captured step's metrics vector, in order (the reference's).
METRIC_KEYS = ("grad_norm", "lr", "loss")


def make_captured_dp_train_step(cfg: ArchConfig, ts: TrainStepConfig,
                                opt: OptimConfig, comm: "CommSession",
                                state, batch, *,
                                schedule: str | None = None,
                                max_paths: int | None = None,
                                num_chunks: int | None = None) -> Callable:
    """Data-parallel step captured as ONE heterogeneous graph — grad
    compute, multipath ring all-reduce and the optimizer update inside a
    single replay (``comm.capture``).

    ``state``/``batch`` are examples (tensors, meta tensors or arrays)
    fixing the shapes; the returned ``step(state, batch) -> (state,
    metrics)`` matches :func:`make_dp_train_step` to float tolerance (the
    captured all-reduce sums in float32 in an order of its own). Every
    call is ONE
    engine dispatch: the ``grad`` kernel (each device's shard through
    autograd on its row of the replicated state, flattened into one
    float32 vector with the loss last), ``n − 1`` exchange rounds with
    their combine kernels, and the ``update`` kernel (AdamW on each row)
    are nodes of one scheduled transfer graph, so
    ``comm.stats()["dispatches"]`` grows by one per step. The graph's
    digest is the reference's for the same config, session and shapes.
    ``step.capture`` is the :class:`~repro_torch.comm.capture.CapturedStep`
    (its ``capture.buffers`` size the step's arena).

    Where ``n`` is a power of two the ring all-reduce adds in one tree
    order (``captured_psum(..., tree=True)``), so every device's mean,
    and so every row's new state, has the same bits; at other counts each
    row adds in its own ring order and the step keeps row 0.

    On a peer session (``n`` a power of two) the same recording (the
    stacked step's digest and ``GroupKey``) runs with one arena a logical
    device and one CUDA graph a card: the ``grad`` kernel, the
    ``captured_psum`` rounds and the ``update`` of logical device *d* all
    run on ``devices[d]``, each kernel over the rows it is given (one
    there, its ``mean`` still over the global ``n``). ``step(state,
    batch)`` takes the state as one tree (copied to every device) or as
    the list of :func:`replicate_state` (each replica staged on its own
    device), splits the global batch into per-device shards, and returns
    the list of the ``n`` new replicas, each the stacked step's state bit
    for bit, and device 0's metrics, one dispatch a call.
    """
    grads_of = _make_grad_fn(cfg, ts)
    n = comm.engine.num_devices
    peer = comm.devices is not None
    tree = n & (n - 1) == 0
    if peer and not tree:
        raise ValueError(f"a captured DP step on a peer session needs a "
                         f"power-of-two device count, so that every "
                         f"replica applies the same mean; got {n}")
    params_ex = state["params"]
    params_leaves = leaves(params_ex)
    opt_leaves = leaves(state["opt"])
    batch_keys = sorted(batch)
    batch_leaves = [torch.as_tensor(batch[k]) for k in batch_keys]
    npar, nopt = len(params_leaves), len(opt_leaves)
    for b in batch_leaves:
        if b.shape[0] % n:
            raise ValueError(f"global batch dim {b.shape[0]} not divisible "
                             f"by {n} devices")
    grad_sizes = [math.prod(p.shape) for p in params_leaves]
    total = sum(grad_sizes)
    opt_tree = state["opt"]

    def grad_kernel(*stacked):
        rows = stacked[0].shape[0]
        out = torch.empty((rows, total + 1), dtype=torch.float32,
                          device=stacked[0].device)
        for i in range(rows):
            params = unflatten(params_ex, [t[i] for t in stacked[:npar]])
            bt = dict(zip(batch_keys, (t[i] for t in stacked[npar:])))
            loss, grads = grads_of(params, bt)
            off = 0
            for g, sz in zip(leaves(grads), grad_sizes):
                out[i, off:off + sz].copy_(g.reshape(-1))
                off += sz
            out[i, total].copy_(loss)
        return out

    def update_kernel(tot_v, *stacked):
        rows = tot_v.shape[0]
        outs = [torch.empty_like(t) for t in stacked]
        mvec = torch.empty((rows, len(METRIC_KEYS)), dtype=torch.float32,
                           device=tot_v.device)
        for i in range(rows):
            params = unflatten(params_ex, [t[i] for t in stacked[:npar]])
            opt_state = unflatten(opt_tree, [t[i] for t in stacked[npar:]])
            mean = tot_v[i] / n
            gleaves, off = [], 0
            for p, sz in zip(params_leaves, grad_sizes):
                gleaves.append(mean[off:off + sz].reshape(p.shape)
                               .to(p.dtype))
                off += sz
            new_params, new_opt, metrics = _update(
                params, unflatten(params_ex, gleaves), opt_state, opt)
            metrics["loss"] = mean[total]
            for o, t in zip(outs, leaves(new_params) + leaves(new_opt)):
                o[i].copy_(t)
            mvec[i].copy_(torch.stack([metrics[k].to(torch.float32)
                                       for k in METRIC_KEYS]))
        return tuple(outs) + (mvec,)

    def spec(t) -> BufferSpec:
        return BufferSpec(tuple(t.shape), dtype_name(t.dtype))

    def build(cap):
        p_refs = [cap.input(tuple(p.shape), p.dtype, replicated=True)
                  for p in params_leaves]
        o_refs = [cap.input(tuple(o.shape), o.dtype, replicated=True)
                  for o in opt_leaves]
        b_refs = [cap.input((b.shape[0] // n,) + tuple(b.shape[1:]),
                            b.dtype) for b in batch_leaves]
        gvec = cap.kernel(grad_kernel, *p_refs, *b_refs, name="grad",
                          out=BufferSpec((total + 1,), "float32"),
                          flops=6 * total)
        tot = captured_psum(cap, gvec, n, max_paths=max_paths,
                            num_chunks=num_chunks, name="gradsum",
                            tree=tree)
        return cap.kernel(
            update_kernel, tot, *p_refs, *o_refs, name="update",
            out=[spec(t) for t in params_leaves + opt_leaves]
            + [BufferSpec((len(METRIC_KEYS),), "float32")],
            flops=10 * total)

    captured = comm.capture(build, schedule=schedule)

    def split(bt) -> list[torch.Tensor]:
        """The global batch's leaves stacked ``(n, ...)`` by shard."""
        xs = [torch.as_tensor(bt[k]) for k in batch_keys]
        return [x.reshape((n, x.shape[0] // n) + x.shape[1:]) for x in xs]

    def results(part):
        """One logical device's state and metrics from its part of each
        of the step's outputs."""
        mvec = part[-1]
        return ({"params": unflatten(params_ex, part[:npar]),
                 "opt": unflatten(opt_tree, part[npar:npar + nopt])},
                {k: mvec[i] for i, k in enumerate(METRIC_KEYS)})

    def step(st, bt):
        if isinstance(st, dict):
            p_l = flatten_up_to(params_ex, st["params"])
            o_l = leaves(st["opt"])
        else:                             # replicas, one a logical device
            reps = _replicas(st, comm)
            p_l = [list(r) for r in zip(*(flatten_up_to(
                params_ex, rep["params"]) for rep in reps))]
            o_l = [list(r) for r in zip(*(leaves(rep["opt"])
                                          for rep in reps))]
        b_l = split(bt)
        if peer:
            b_l = [list(x.unbind(0)) for x in b_l]
        outs = captured(*p_l, *o_l, *b_l)
        if not peer:
            # every row equal where n is a power of two, else row 0's;
            # row 0 copied out, so that the n stacked rows are freed
            return results([o[0].clone() for o in outs])
        parts = [[o[d] for o in outs] for d in range(n)]
        return [results(part)[0] for part in parts], results(parts[0])[1]

    step.capture = captured
    return step


def state_shapes(cfg: ArchConfig, opt: OptimConfig):
    """The train state's shapes and dtypes as meta tensors."""
    p = tfm.param_shapes(cfg)
    return {"params": p, "opt": opt_state_shapes(p, opt)}


def state_shardings(cfg: ArchConfig, mesh: "LogicalMesh", opt: OptimConfig):
    """The train state's partition specs on ``mesh`` (``{"params",
    "opt"}``, :mod:`~repro_torch.training.sharding`'s rules) and its
    shapes as meta tensors (:func:`state_shapes`). The reference returns
    placements on devices in place of the specs; the port lays a state
    out by them with :func:`~repro_torch.training.sharding.shard_tree`."""
    abstract = state_shapes(cfg, opt)
    p_specs = shd.param_specs(cfg, mesh, abstract["params"])
    o_specs = shd.opt_state_specs(cfg, mesh, abstract["opt"], p_specs)
    return {"params": p_specs, "opt": o_specs}, abstract


def init_state(cfg: ArchConfig, opt: OptimConfig, *,
               generator: torch.Generator | None = None, device=None,
               mesh: "LogicalMesh | None" = None):
    """A fresh train state on ``device`` (default: the card): random
    parameters from ``generator`` (:func:`~repro_torch.models.transformer.
    init_params`) and zero optimizer state. With ``mesh``, the state laid
    out by :func:`state_shardings`' specs: every leaf the ``(n, ...)``
    stack of the mesh's logical devices' shards
    (:func:`~repro_torch.training.sharding.shard_tree`; views where the
    split allows)."""
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    params = tfm.init_params(cfg, generator=generator, device=device)
    state = {"params": params, "opt": init_opt_state(params, opt)}
    if mesh is not None:
        specs, _ = state_shardings(cfg, mesh, opt)
        state = shd.shard_tree(state, specs, mesh)
    return state
