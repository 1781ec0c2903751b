"""Logical sharding rules with divisibility fallback (MaxText-style).

The port of the reference's ``training/sharding.py``. Rules are keyed on
parameter path + dim semantics. Every rule is filtered through
:func:`safe_spec`: an axis that does not divide its dim is dropped for
that tensor (partial replication), so all ten architectures — with head
counts 0/15/16/25/32/48/64/96 and kv heads 5/8/16 — shard without
special-casing.

Layout summary (mesh axes ``pod``/``data``/``model``):

* batch dims            → (pod, data)          [pure DP across pods]
* vocab / embed rows    → model
* attention q-projection cols (H·hd) and MLP hidden → model   [TP]
* MoE expert dim        → model                 [EP]
* param non-TP dim      → data when cfg.fsdp    [FSDP/ZeRO-3]
* decode KV chunk dim   → model (batch-shardable case) or every axis
                          (batch=1 long-context case)
* optimizer moments mirror their parameter specs (int8 scales replicated)

Specs are :class:`~repro_torch.models.pspec.PartitionSpec` tuples over a
:class:`~repro_torch.launch.mesh.LogicalMesh`. Sharding in the port is
device-stacked, so in place of the reference's placement of arrays on
devices, :func:`shard_tree` lays each leaf out as the ``(n, ...)`` stack
of the mesh's ``n`` logical devices' local shards (row-major over the
mesh axes) and :func:`unshard_tree` puts the whole back. On a peer mesh
(``make_host_mesh(..., devices=[...])``), :func:`place_params` gives one
tree a card: its logical devices' experts, its blocks of the dense
leaves the model axis cuts (whole heads, hidden units, vocabulary
blocks and the state-space mixers' heads or channels only,
:func:`~repro_torch.models.tensor_parallel.dense_cut`), and
a replica of the rest; :func:`place_state` places a train state the
same way, each AdamW moment cut as its parameter.
"""

from __future__ import annotations

import math
from typing import Any

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.launch.mesh import LogicalMesh
from repro_torch.models.pspec import P, PartitionSpec
from repro_torch.models.tensor_parallel import DenseCut, dense_cut
from repro_torch.tree import leaves, leaves_with_paths


def dp_axes(mesh: LogicalMesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def axis_size(mesh: LogicalMesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    n = 1
    for a in axes:
        n *= mesh.shape[a]
    return n


def safe_spec(shape, spec, mesh: LogicalMesh) -> PartitionSpec:
    """Drop axis names that do not evenly divide their dimension."""
    out = []
    for i, entry in enumerate(spec):
        if entry is None:
            out.append(None)
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        axes = tuple(a for a in axes if a in mesh.axis_names)
        keep = []
        size = shape[i] if i < len(shape) else 1
        for a in axes:
            n = mesh.shape[a]
            if size % n == 0 and n > 1:
                keep.append(a)
                size //= n
        out.append(tuple(keep) if len(keep) > 1 else
                   (keep[0] if keep else None))
    return P(*out)


def _param_rule(path: str, ndim: int, cfg: ArchConfig,
                model_size: int = 1) -> PartitionSpec:
    """Logical spec before divisibility filtering. Paths are '/'-joined."""
    fs = "data" if cfg.fsdp else None
    leaf = path.split("/")[-1]
    if "moe" in path and "shared" not in path:
        # E % model == 0 → expert parallelism over the model axis;
        # otherwise (mixtral: 8 experts on a 16-wide axis) fall back to
        # per-expert tensor parallelism: shard the expert FFN hidden dim.
        ep = cfg.num_experts % max(1, model_size) == 0
        if leaf == "router":
            return P(None, None, "model") if ep else P(None, None, None)
        if leaf in ("w1", "w3"):
            return (P(None, "model", fs, None) if ep
                    else P(None, None, fs, "model"))
        if leaf == "w2":
            return (P(None, "model", None, fs) if ep
                    else P(None, None, "model", fs))
    if leaf == "embed":
        return P("model", fs)
    if leaf in ("lm_head", "head"):
        return P(fs, "model")
    if leaf == "wq":
        return P(None, fs, "model")
    if leaf in ("wk", "wv"):
        # column-sharding GQA k/v projections whose kv_heads don't divide
        # the model axis splits heads mid-boundary; replicate the (small)
        # weights so k/v activations stay model-replicated.
        if cfg.num_kv_heads % max(1, model_size) == 0:
            return P(None, fs, "model")
        return P(None, fs, None)
    if leaf == "wo":
        return P(None, "model", fs)
    if "shared" in path and leaf in ("w1", "w3"):
        return P(None, fs, "model")
    if "shared" in path and leaf == "w2":
        return P(None, "model", fs)
    if leaf in ("w1", "w3"):            # dense mlp (L, d, ff)
        return P(None, fs, "model")
    if leaf == "w2":                    # (L, ff, d)
        return P(None, "model", fs)
    if leaf in ("w_in",):               # mamba (L, d, 2d_i)
        return P(None, fs, "model")
    if leaf in ("w_out",):              # (L, d_i, d)
        return P(None, "model", fs)
    if leaf in ("w_r", "w_k", "w_v", "w_w", "w_g"):   # rwkv (L, d, d)
        return P(None, fs, "model")
    if leaf == "frontend_proj":
        return P(None, None)
    return P(*([None] * ndim))          # norms, biases, small projections


def _path_str(path: tuple) -> str:
    return "/".join(str(p) for p in path)


def _map_with_path(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a nested dict's leaves, path a key tuple."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def param_specs(cfg: ArchConfig, mesh: LogicalMesh, abstract_params) -> Any:
    """Tree of :class:`PartitionSpec` matching ``abstract_params`` (meta
    tensors, :func:`~repro_torch.models.transformer.param_shapes`)."""
    model_size = mesh.shape.get("model", 1)

    def spec_of(path, leaf):
        raw = _param_rule(_path_str(path), leaf.dim(), cfg, model_size)
        # pad/truncate to leaf rank
        entries = list(raw) + [None] * leaf.dim()
        return safe_spec(leaf.shape, P(*entries[:leaf.dim()]), mesh)

    return _map_with_path(spec_of, abstract_params)


def opt_state_specs(cfg: ArchConfig, mesh: LogicalMesh, abstract_opt_state,
                    p_specs) -> Any:
    """Moments mirror param specs; int8 scale scalars replicate."""
    def lookup(path, leaf):
        # path may have trailing 'q'/'scale' for int8 moments
        node = p_specs
        for key in path:
            if isinstance(node, dict) and key in node:
                node = node[key]
            else:
                break
        if isinstance(node, PartitionSpec) and leaf.dim() == len(node):
            return node
        return P(*([None] * leaf.dim()))

    def mirror(moments):
        return _map_with_path(
            lambda path, leaf: safe_spec(leaf.shape, lookup(path, leaf),
                                         mesh), moments)

    return {"m": mirror(abstract_opt_state["m"]),
            "v": mirror(abstract_opt_state["v"]),
            "step": P()}


def batch_specs(cfg: ArchConfig, mesh: LogicalMesh, batch_shapes) -> Any:
    dp = dp_axes(mesh)
    return _map_with_path(
        lambda path, leaf: safe_spec(
            leaf.shape, P(dp, *([None] * (leaf.dim() - 1))), mesh),
        batch_shapes)


def cache_specs(cfg: ArchConfig, mesh: LogicalMesh, cache_shapes,
                batch: int):
    """Decode-cache layout (DESIGN.md §5): batch→DP; chunk dim C→model
    (or every axis when batch is unshardable); ring window→model;
    SSM/RWKV states: batch→DP, feature dims→model."""
    dp = dp_axes(mesh)
    batch_shardable = batch % axis_size(mesh, dp) == 0 and batch > 1
    chunk_axes = "model" if batch_shardable else tuple(
        list(dp) + ["model"])
    bspec = dp if batch_shardable else None

    def spec_of(path, leaf):
        name = _path_str(path).split("/")[-1]
        if name in ("k", "v"):
            if leaf.dim() == 6:    # chunked (L,B,Hkv,C,Sc,hd)
                raw = P(None, bspec, None, chunk_axes, None, None)
            else:                  # ring (L,B,Hkv,W,hd)
                raw = P(None, bspec, None, "model", None)
        elif name == "ssm":        # (L,B,d_i,N)
            raw = P(None, bspec, "model", None)
        elif name == "conv":       # (L,B,K-1,d_i)
            raw = P(None, bspec, None, "model")
        elif name == "rwkv_state":  # (L,B,h,dk,dv)
            raw = P(None, bspec, "model", None, None)
        elif name == "rwkv_shift":  # (L,B,d)
            raw = P(None, bspec, "model")
        else:
            raw = P(*([None] * leaf.dim()))
        return safe_spec(leaf.shape, raw, mesh)

    return _map_with_path(spec_of, cache_shapes)


# -- device-stacked layout ----------------------------------------------------

def _entry_axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def _check_spec(shape, spec: PartitionSpec, mesh: LogicalMesh) -> None:
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} does not match shape {tuple(shape)}")
    used = [a for e in spec for a in _entry_axes(e)]
    if len(set(used)) != len(used) or any(a not in mesh.axis_names
                                          for a in used):
        raise ValueError(f"spec {spec} is not a layout over {mesh}")
    for n, e in zip(shape, spec):
        if n % axis_size(mesh, _entry_axes(e) or None):
            raise ValueError(f"spec {spec} does not divide {tuple(shape)}")


def shard_leaf(x: torch.Tensor, spec: PartitionSpec,
               mesh: LogicalMesh) -> torch.Tensor:
    """``x`` as its ``(n, ...)`` stack of local shards, row ``d`` the
    logical device whose mesh coordinates are ``d`` in row-major order
    over ``mesh.axis_names``: a dim of entry ``(a1, a2, ...)`` is cut into
    ``|a1|·|a2|·...`` blocks, indexed row-major by the device's
    coordinates on those axes; axes a leaf does not use replicate it. A
    view of ``x`` where one can be (the split dims and the replication
    stride-0 expand), else a copy."""
    _check_spec(x.shape, spec, mesh)
    sizes = mesh.shape
    split_shape, axis_dims, local = [], {}, []
    for n, e in zip(x.shape, spec):
        axes = _entry_axes(e)
        for a in axes:
            axis_dims[a] = len(split_shape)
            split_shape.append(sizes[a])
        local.append(n // axis_size(mesh, axes or None))
        split_shape.append(local[-1])
    y = x.reshape(split_shape)
    # mesh axes first (in mesh order), replicated axes as stride-0 dims
    for a in mesh.axis_names:
        if a not in axis_dims:
            y = y.unsqueeze(0)
            axis_dims = {k: v + 1 for k, v in axis_dims.items()}
            axis_dims[a] = 0
    order = [axis_dims[a] for a in mesh.axis_names]
    rest = [i for i in range(y.dim()) if i not in order]
    y = y.permute(order + rest)
    y = y.expand(tuple(sizes[a] for a in mesh.axis_names) + y.shape[
        len(order):])
    return y.reshape((mesh.size,) + tuple(local))


def unshard_leaf(stack: torch.Tensor, spec: PartitionSpec,
                 mesh: LogicalMesh) -> torch.Tensor:
    """The whole tensor back from its :func:`shard_leaf` stack: the
    shards of the first device along every axis the spec does not use."""
    local = stack.shape[1:]
    y = stack.reshape(tuple(mesh.shape[a] for a in mesh.axis_names)
                      + tuple(local))
    index = tuple(slice(None) if any(a in _entry_axes(e) for e in spec)
                  else 0 for a in mesh.axis_names)
    y = y[index]
    kept = [a for a in mesh.axis_names
            if any(a in _entry_axes(e) for e in spec)]
    # y: (kept axes..., local...) → interleave each dim's axes before it
    pos = {a: i for i, a in enumerate(kept)}
    order, shape = [], []
    for i, (n, e) in enumerate(zip(local, spec)):
        axes = _entry_axes(e)
        order += [pos[a] for a in axes] + [len(kept) + i]
        shape.append(n * math.prod(mesh.shape[a] for a in axes))
    return y.permute(order).reshape(shape)


def shard_tree(tree, specs, mesh: LogicalMesh):
    """:func:`shard_leaf` over a tree of tensors and its specs."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return shard_leaf(tree, specs, mesh)


def unshard_tree(tree, specs, mesh: LogicalMesh):
    """:func:`unshard_leaf` over a tree of stacks and its specs."""
    if isinstance(tree, dict):
        return {k: unshard_tree(v, specs[k], mesh) for k, v in tree.items()}
    return unshard_leaf(tree, specs, mesh)


def _held_runs(held: list[int]) -> list[tuple[int, int]]:
    """``held`` (ascending) as ``[start, stop)`` runs of consecutive
    indices."""
    runs: list[list[int]] = []
    for d in held:
        if runs and runs[-1][1] == d:
            runs[-1][1] = d + 1
        else:
            runs.append([d, d + 1])
    return [(a, b) for a, b in runs]


def cut_experts(w: torch.Tensor, name: str, held: list[int],
                model: int) -> torch.Tensor:
    """The part of the expert weight ``w`` (``w1``/``w3``: ``(..., E, d,
    ff)``, ``w2``: ``(..., E, ff, d)``) that the model-axis devices
    ``held`` own, in device order: their ``E / model`` experts each (EP),
    or, when ``model`` does not divide ``E``, their ff-shards of every
    expert (expert-TP; ``ff`` must divide), as
    :func:`~repro_torch.models.moe_dist._row_weights` cuts a row. A view
    of ``w`` where ``held`` is one run of consecutive devices."""
    if w.shape[-3] % model == 0:
        return cut_dense(w, -3, held, model)
    dim = -2 if name == "w2" else -1
    if w.shape[dim] % model:
        raise ValueError(f"expert-TP over {model} devices needs the ff "
                         f"dim {w.shape[dim]} of {name} to divide")
    return cut_dense(w, dim, held, model)


def is_expert(path: tuple) -> bool:
    """Whether the leaf at ``path`` (a key tuple) is an expert weight or
    its moment: ``w1``, ``w3`` or ``w2`` under ``moe``, not ``shared``."""
    return ("moe" in path and "shared" not in path
            and path[-1] in ("w1", "w3", "w2"))


#: RWKV-6's leaves a time-mix cut cuts by whole heads, each at the dim
#: (from the end) of its heads or their channels; ``mu`` stays whole.
TIME_MIX_DIMS = {"w_r": -1, "w_k": -1, "w_v": -1, "w_w": -1, "w_g": -1,
                 "w_out": -2, "u": -2, "ln_x": -1}
#: Mamba's leaves a channel cut cuts, each at its ``d_i`` dim (from the
#: end); ``w_in``'s last dim holds x's and z's channels side by side, and
#: each half is cut (:func:`halves`).
MAMBA_DIMS = {"w_in": -1, "conv_w": -1, "conv_b": -1, "w_dt1": -2,
              "w_dt2": -1, "dt_bias": -1, "w_B": -2, "w_C": -2,
              "A_log": -2, "D": -1, "w_out": -2}


def dense_dim(path: tuple, cut: DenseCut | None) -> int | None:
    """The dim (from the end) along which ``cut`` cuts the dense leaf at
    ``path`` (a key tuple), or None where the leaf stays whole: ``embed``
    rows and ``lm_head`` columns (the vocabulary), ``wq`` columns and
    ``wo`` rows (heads), ``wk``/``wv`` columns (kv heads), ``w1``/``w3``
    columns and ``w2`` rows of the dense MLP (``mlp``) and of the shared
    expert (``moe``/``shared``), as the reference's rules cut them on the
    model axis; RWKV-6's time mix (``rwkv``, :data:`TIME_MIX_DIMS`) and
    Mamba (``ssm``, :data:`MAMBA_DIMS`), also their leaves the reference
    keeps whole, so that a card's gradient of each is whole without a
    psum."""
    if cut is None:
        return None
    name = path[-1]
    if name == "embed" and cut.vocab:
        return -2
    if name == "lm_head" and cut.vocab:
        return -1
    if "attn" in path:
        if name == "wq" and cut.heads or name in ("wk", "wv") and cut.kv:
            return -1
        if name == "wo" and cut.heads:
            return -2
    if ("mlp" in path and cut.ff) or ("shared" in path and cut.shared):
        if name in ("w1", "w3"):
            return -1
        if name == "w2":
            return -2
    if "rwkv" in path and cut.time_mix:
        return TIME_MIX_DIMS.get(name)
    if "ssm" in path and cut.mamba:
        return MAMBA_DIMS.get(name)
    return None


def halves(path: tuple) -> int:
    """How many halves the cut dim of the leaf at ``path`` holds side by
    side, each cut in ``model`` blocks (Mamba's ``w_in``: x's channels,
    then z's); 1 for every other leaf."""
    return 2 if tuple(path[-2:]) == ("ssm", "w_in") else 1


def cut_dense(w: torch.Tensor, dim: int, held: list[int],
              model: int, halves: int = 1) -> torch.Tensor:
    """The blocks ``held`` (ascending) of ``w``'s dim ``dim`` cut into
    ``model``, in index order: a view where they are one run. With
    ``halves`` the dim is that many halves side by side, and the card's
    blocks of each are taken, half after half (a copy)."""
    dim %= w.dim()
    if halves > 1:
        return cut_dense(w.unflatten(dim, (halves, -1)), dim + 1, held,
                         model).flatten(dim, dim + 1)
    size = w.shape[dim] // model
    parts = [w.narrow(dim, a * size, (b - a) * size)
             for a, b in _held_runs(sorted(held))]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def cut_leaf(x: torch.Tensor, path: tuple, held: list[int], model: int,
             cut: DenseCut | None) -> torch.Tensor:
    """The part of the whole leaf ``x`` at ``path`` that a card holding
    the model-axis devices ``held`` holds under its dense ``cut``: its
    experts (:func:`cut_experts`), its blocks of a leaf the cut cuts
    (:func:`dense_dim`, :func:`cut_dense`), else ``x``."""
    if is_expert(path):
        return cut_experts(x, path[-1], held, model)
    dim = dense_dim(path, cut)
    if dim is None:
        return x
    return cut_dense(x, dim, held, model, halves(path))


def place_card(params, held: list[int], model: int, device,
               cut: DenseCut | None = None):
    """One card's tree of ``params`` (or of a train state, whose moments
    sit at their parameters' paths under ``m``/``v``): the expert leaves
    (``w1``, ``w3``, ``w2`` under ``moe``, not ``shared``) cut to the
    model-axis devices ``held`` (:func:`cut_experts`); with ``cut`` (the
    card's :func:`card_cuts`) the dense leaves it cuts cut to the same
    devices (:func:`dense_dim`, :func:`cut_dense`); every other leaf a
    replica, all on ``device``. A leaf already there stays a view where
    its cut is one run."""
    return _map_with_path(lambda path, x: cut_leaf(
        x, path, held, model, cut).to(device), params)


def _card_layout(mesh: LogicalMesh, what: str):
    """A peer mesh's cards (its session's distinct devices, in first-use
    order) and the model-axis devices each holds."""
    session = mesh.session
    if session is None or session.devices is None:
        raise ValueError(f"{what} needs a peer mesh (make_host_mesh("
                         f"..., devices=[...])), got {mesh}")
    devices = session.devices
    cards = tuple(dict.fromkeys(devices))
    return cards, [[d for d, dev in enumerate(devices) if dev == card]
                   for card in cards]


def card_cuts(cfg: ArchConfig, mesh: LogicalMesh) -> list[DenseCut]:
    """The layout of a peer mesh, in serving and training: each card's
    :class:`~repro_torch.models.tensor_parallel.DenseCut` (its cards in
    first-use order)."""
    _, helds = _card_layout(mesh, "card_cuts")
    model = mesh.shape.get("model", 1)
    return [dense_cut(cfg, held, model) for held in helds]


def place_params(params, mesh: LogicalMesh, cfg: ArchConfig) -> list:
    """Parameters placed on a peer mesh: one tree a card of the mesh's
    session (its distinct devices, in first-use order), each
    :func:`place_card` of the logical devices that card holds.

    Every card holds its own experts and only its blocks of the dense
    leaves its :func:`card_cuts` cut: the vocabulary, whole heads, the
    dense MLP's and the shared expert's hidden units, RWKV-6's time mix
    by whole heads and Mamba by channels, where the model axis divides
    them, which the card runs tensor parallel
    (:mod:`~repro_torch.models.tensor_parallel`). On a card that holds
    every logical device, and for norms, routers and RWKV-6's ``mu`` on
    any card, the leaves stay whole replicas. On the
    card that already holds a leaf, a cut of one run of devices (or
    the whole leaf) stays a view: the serving engine only reads it, and a
    train step's update is functional (new tensors), so neither writes
    the caller's."""
    cards, helds = _card_layout(mesh, "place_params")
    model = mesh.shape.get("model", 1)
    return [place_card(params, held, model, card, cut)
            for card, held, cut in zip(cards, helds, card_cuts(cfg, mesh))]


def place_state(state, mesh: LogicalMesh, cfg: ArchConfig) -> list:
    """A train state (``{"params", "opt"}``) of ``cfg`` placed on a peer
    mesh: one tree a card, as :func:`place_params` places the parameters
    (the card's experts and its :func:`card_cuts` blocks of the dense
    leaves, a replica of the rest), with the AdamW moments ``m`` and
    ``v`` cut exactly as their parameters (:func:`place_card`) and
    ``step`` replicated. int8 moments raise ``ValueError``: each is
    quantized with one absmax scale over the whole tensor, which a
    card's cut would not share, so the cards' updates would leave the
    stacked step's."""
    if any(path[-1] in ("q", "scale")
           for path, _ in leaves_with_paths(state["opt"])):
        raise ValueError(
            "int8 moments cannot be placed on a peer mesh: each is "
            "quantized with one absmax scale over the whole tensor, and a "
            "card's cut of it would need a scale of its own; use float32 "
            "or bfloat16 moments")
    cards, helds = _card_layout(mesh, "place_state")
    model = mesh.shape.get("model", 1)
    return [place_card(state, held, model, card, cut)
            for card, held, cut in zip(cards, helds, card_cuts(cfg, mesh))]


def unplace_state(trees: list, mesh: LogicalMesh, cfg: ArchConfig):
    """The whole tree back from one tree a card of ``mesh`` (the inverse
    of :func:`place_state`, or of :func:`place_params` for parameters,
    given the same ``cfg``): each cut leaf, expert or dense, the cards'
    cuts put back in device order, every other leaf card 0's replica; all
    on card 0's device."""
    cards, helds = _card_layout(mesh, "unplace_state")
    if len(trees) != len(cards):
        raise ValueError(f"{mesh} has {len(cards)} cards, got "
                         f"{len(trees)} trees")
    model = mesh.shape.get("model", 1)
    return _uncut_tree(trees, helds, model, cards[0], (),
                       cuts=card_cuts(cfg, mesh))


def check_placed(trees: list, mesh: LogicalMesh, cfg: ArchConfig, shapes,
                 what: str) -> None:
    """Raise ``ValueError`` unless ``trees`` are one a card of the peer
    ``mesh``, on its cards, each cut as :func:`place_card` cuts
    ``shapes`` (the whole tree's meta tensors) for that card under its
    :func:`card_cuts` cut: as ``what`` (the placing call) places them.
    The layout is said by the placement, never guessed from a shape."""
    cards, helds = _card_layout(mesh, what)
    on = [str(leaves(t)[0].device) for t in trees]
    if on != [str(c) for c in cards]:
        raise ValueError(f"placed trees on {on}, not one on each of the "
                         f"peer mesh's cards")
    model = mesh.shape.get("model", 1)
    for card, (tree, held, cut) in enumerate(zip(trees, helds,
                                                 card_cuts(cfg, mesh))):
        want = dict(leaves_with_paths(place_card(shapes, held, model,
                                                 "meta", cut)))
        got = dict(leaves_with_paths(tree))
        bad = sorted("/".join(path) for path in want.keys() | got.keys()
                     if path not in want or path not in got
                     or got[path].shape != want[path].shape)
        if bad:
            raise ValueError(
                f"card {card}'s tree differs from its placement at "
                f"{bad[:4]}: trees on this peer mesh must be placed as "
                f"{what} places them")


def is_cut(path: tuple, cut: DenseCut | None) -> bool:
    """Whether a card's tree holds only its part of the leaf at ``path``
    (a key tuple) under ``cut``: an expert weight, or a dense leaf the
    cut cuts (:func:`dense_dim`)."""
    return is_expert(path) or dense_dim(path, cut) is not None


def _uncut_tree(parts: list, helds: list, model: int, device,
                path: tuple, experts: int | None = None, *, cuts: list):
    """:func:`unplace_state` over the subtrees ``parts`` (one a card) at
    ``path``; ``experts`` the expert count of the MoE block above (its
    router's last dim); ``cuts`` each card's dense cut (or None)."""
    first = parts[0]
    if isinstance(first, dict):
        if "router" in first:
            experts = first["router"].shape[-1]
        return {k: _uncut_tree([p[k] for p in parts], helds, model, device,
                               path + (k,), experts, cuts=cuts)
                for k in first}
    if is_expert(path):
        dim = (first.dim() - 3 if experts % model == 0
               else first.dim() - (2 if path[-1] == "w2" else 1))
    else:
        dim = dense_dim(path, cuts[0])
        if dim is None:
            return first.to(device)
        dim %= first.dim()
    # each card's part as (halves, its blocks of each half)
    two = halves(path)
    blocks = {}
    for part, held in zip(parts, helds):
        part = part.unflatten(dim, (two, -1))
        size = part.shape[dim + 1] // len(held)
        for j, d in enumerate(sorted(held)):
            blocks[d] = part.narrow(dim + 1, j * size, size).to(device)
    return torch.cat([blocks[d] for d in range(model)],
                     dim + 1).flatten(dim, dim + 1)
