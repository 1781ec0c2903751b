"""input_specs(): meta-tensor stand-ins for every dry-run cell.

Zero allocation: every argument of a cell's step is a meta tensor of its
shape and dtype, and beside the arguments stands a parallel tree of
:class:`~repro_torch.models.pspec.PartitionSpec` (the sharding rules of
:mod:`repro_torch.training.sharding`, :func:`~repro_torch.training.
sharding.safe_spec` applied) that lays each one out on the mesh. A
launcher counts a step on them (:mod:`repro_torch.launch.cost`) before it
touches a card.

The port of the reference package's ``launch/specs.py``, which attaches
the specs to its abstract arrays as placements on a device mesh.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.configs.shapes import ShapeConfig
from repro_torch.launch.mesh import LogicalMesh
from repro_torch.models import transformer as tfm
from repro_torch.models.pspec import P
from repro_torch.optim import OptimConfig
from repro_torch.serving.engine import make_serve_step, pick_kv_chunks
from repro_torch.training import (TrainStepConfig, make_train_step,
                                  state_shardings)
from repro_torch.training import sharding as shd


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def optim_for(arch: ArchConfig) -> OptimConfig:
    return OptimConfig(moment_dtype=arch.optimizer_dtype)


@dataclasses.dataclass
class CellSpec:
    """Everything needed to count one (arch × shape × mesh) cell: the
    step, its meta arguments and their specs (None for an argument laid
    out on no axis, as the decode position), the specs of its outputs,
    its kind and its description."""
    fn: Callable
    abstract_args: tuple
    specs: tuple
    out_specs: object
    kind: str
    description: str


def batch_abstract(arch: ArchConfig, shape: ShapeConfig, mesh: LogicalMesh,
                   seq_len: int | None = None, batch: int | None = None):
    """A batch's meta tensors and their specs: ``(tensors, specs)``."""
    dp = shd.dp_axes(mesh)
    b = batch if batch is not None else shape.global_batch
    s = seq_len if seq_len is not None else shape.seq_len
    if arch.frontend == "audio":
        leaves = {"features": ((b, s, arch.frontend_dim), torch.float32,
                               P(dp, None, None)),
                  "labels": ((b, s), torch.int32, P(dp, None)),
                  "mask": ((b, s), torch.float32, P(dp, None))}
    else:
        leaves = {"tokens": ((b, s), torch.int32, P(dp, None)),
                  "labels": ((b, s), torch.int32, P(dp, None)),
                  "mask": ((b, s), torch.float32, P(dp, None))}
    return ({k: _meta(sh, dt) for k, (sh, dt, _) in leaves.items()},
            {k: shd.safe_spec(sh, sp, mesh)
             for k, (sh, _, sp) in leaves.items()})


def _logits_spec(shape, mesh: LogicalMesh):
    """Logits ``(B, [S,] V)``: batch over the data axes, vocabulary over
    the model axis (the head's columns)."""
    mid = [None] * (len(shape) - 2)
    return shd.safe_spec(shape, P(shd.dp_axes(mesh), *mid, "model"), mesh)


def input_specs(arch: ArchConfig, shape: ShapeConfig,
                mesh: LogicalMesh) -> CellSpec:
    """Build the (step fn, meta args, specs) of one cell."""
    dp = shd.dp_axes(mesh)
    if shape.kind == "train":
        opt = optim_for(arch)
        step = make_train_step(arch, TrainStepConfig(), opt, device="meta")
        specs, abstract = state_shardings(arch, mesh, opt)
        batch_abs, batch_specs = batch_abstract(arch, shape, mesh)
        out_specs = (specs, {"grad_norm": P(), "lr": P(), "loss": P()})
        return CellSpec(step, (abstract, batch_abs), (specs, batch_specs),
                        out_specs, "train",
                        f"train_step {arch.name} b{shape.global_batch} "
                        f"s{shape.seq_len}")

    abstract_p = tfm.param_shapes(arch)
    p_specs = shd.param_specs(arch, mesh, abstract_p)
    if shape.kind == "prefill":
        @torch.no_grad()
        def prefill(params, batch):
            logits, aux = tfm.forward(params, arch, batch)
            return logits
        batch_abs, batch_specs = batch_abstract(arch, shape, mesh)
        for key in ("labels", "mask"):
            batch_abs.pop(key, None)
            batch_specs.pop(key, None)
        logits = (shape.global_batch, shape.seq_len, arch.vocab_size)
        return CellSpec(prefill, (abstract_p, batch_abs),
                        (p_specs, batch_specs), _logits_spec(logits, mesh),
                        "prefill",
                        f"prefill {arch.name} b{shape.global_batch} "
                        f"s{shape.seq_len}")

    # decode
    b = shape.global_batch
    kv_chunks = pick_kv_chunks(arch, mesh, b, shape.seq_len)
    spec = tfm.cache_spec(arch, max_len=shape.seq_len, kv_chunks=kv_chunks)
    serve = torch.no_grad()(make_serve_step(arch, spec))
    cache_abs = tfm.cache_shapes(arch, b, spec)
    c_specs = shd.cache_specs(arch, mesh, cache_abs, b)
    tokens = _meta((b, 1), torch.int32)
    cur_len = _meta((), torch.int32)
    out_specs = (_logits_spec((b, arch.vocab_size), mesh), c_specs)
    return CellSpec(serve, (abstract_p, cache_abs, tokens, cur_len),
                    (p_specs, c_specs,
                     shd.safe_spec((b, 1), P(dp, None), mesh), None),
                    out_specs, "decode",
                    f"serve_step {arch.name} b{b} cache={shape.seq_len} "
                    f"C={spec.kv_chunks if spec.kind == 'chunked' else 'ring'}")


def shard_bytes(t: torch.Tensor, spec, mesh: LogicalMesh) -> float:
    """One device's bytes of ``t`` laid out by ``spec``: its bytes over the
    product of the axes the spec names (None: replicated)."""
    n = t.numel() * t.element_size()
    if spec is None:
        return float(n)
    return n / shd.axis_size(mesh, tuple(
        a for e in spec if e is not None
        for a in ((e,) if isinstance(e, str) else e)) or None)


def leaf_specs(tree, specs):
    """``(leaf, spec)`` of every leaf of ``tree`` (nested dicts, or a
    tuple of them) beside its spec in the parallel ``specs``."""
    if isinstance(tree, (tuple, list)):
        for t, s in zip(tree, specs):
            yield from leaf_specs(t, s)
    elif isinstance(tree, dict):
        for key in sorted(tree):
            yield from leaf_specs(tree[key], specs[key])
    else:
        yield tree, specs


def tree_bytes(tree, specs, mesh: LogicalMesh) -> float:
    """:func:`shard_bytes` summed over a tree and its specs."""
    return sum(shard_bytes(t, s, mesh) for t, s in leaf_specs(tree, specs))
