"""Gradient compression for cross-pod (DCN) data-parallel synchronization.

Pods are joined by data-center network, not the fast intra-pod links —
the pod-axis gradient all-reduce is the slowest collective in the
multi-pod step. ``compressed_psum`` int8-quantizes each member's gradient
leaf (per-member absmax scale), reconstructs each member's contribution
with its own scale and all-reduces the contributions through the
session's multipath ring (``comm.collectives.psum``), then divides by
the member count: the mean, its max abs error under 0.02 of the mean's
max |value| (the bound the tests hold, as the reference package's
``tests/test_optim.py`` does).

Every function takes a device-stacked tensor ``(n, ...)``, row *i* being
member *i*'s leaf, where the reference takes one member's local leaf
inside ``shard_map`` over an axis name, and a session in place of that
name. On a peer session (``CommSession(devices=[...])``) it takes a list
of the ``n`` members' leaves instead, leaf *d* on ``devices[d]``: each
member is quantized on its own device, the contributions are summed by
``comm.collectives.psum`` on the list, and the result is such a list, bit
for bit the stacked result's rows. The all-reduce carries the float32
dequantized contributions, as the reference's code does; the
error-feedback variant carries the residual so the bias does not
accumulate across steps.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from repro_torch.comm.session import on_device
from repro_torch.tree import leaves, tree_map, unflatten

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.comm.session import CommSession


def _quantize(g: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-member int8 payload and float32 scale of the stacked float32
    ``g: (n, ...)``: ``scale = max|g_i| / 127 + 1e-12`` and ``q =
    clip(round(g_i / scale), -127, 127)``, rounding half to even. Returns
    ``(q (n, ...) int8, scale (n,) float32)``."""
    n = g.shape[0]
    scale = g.reshape(n, -1).abs().amax(dim=1) / 127.0 + 1e-12
    s = scale.reshape((n,) + (1,) * (g.dim() - 1))
    q = torch.clamp(torch.round(g / s), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale.reshape(
        (q.shape[0],) + (1,) * (q.dim() - 1))


def _per_member(fn, *stacked: list) -> list:
    """``fn`` over each member's ``(1, ...)`` rows on its own device (a
    peer session's lists, member *d*'s leaves on ``devices[d]``); the
    results per member, each with the row taken off."""
    outs = []
    for parts in zip(*stacked):
        with on_device(parts[0].device):
            res = fn(*(p[None] for p in parts))
        outs.append(tuple(r[0] for r in res) if isinstance(res, tuple)
                    else res[0])
    return outs


def _contribution(g: torch.Tensor) -> torch.Tensor:
    """Each member's dequantized int8 contribution of stacked ``g``."""
    return _dequantize(*_quantize(g.to(torch.float32)))


def compressed_psum(g, comm: "CommSession"):
    """int8 all-reduce mean of one stacked gradient leaf ``g: (n, ...)``
    over its ``n`` members; returns ``(n, ...)`` float32, every row the
    mean. On a peer session ``g`` and the result are per-device lists."""
    if isinstance(g, (list, tuple)):
        total = comm.collectives.psum(_per_member(_contribution, g))
        return [t / len(g) for t in total]
    return comm.collectives.psum(_contribution(g)) / g.shape[0]


def compressed_psum_tree(grads, comm: "CommSession"):
    """:func:`compressed_psum` of every leaf of a tree of stacked
    leaves; on a peer session of a list of the members' trees (tree *d*
    on ``devices[d]``), returning such a list."""
    if isinstance(grads, (list, tuple)):
        means = [compressed_psum(list(rows), comm)
                 for rows in zip(*(leaves(t) for t in grads))]
        return [unflatten(grads[0], [m[d] for m in means])
                for d in range(len(grads))]
    return tree_map(lambda g: compressed_psum(g, comm), grads)


def _feedback(g: torch.Tensor, residual: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(sent, new_residual)`` of stacked ``g`` and ``residual``."""
    target = g.to(torch.float32) + residual
    sent = _dequantize(*_quantize(target))
    return sent, target - sent


def compressed_psum_with_feedback(g, residual, comm: "CommSession"):
    """Error-feedback compression: quantize ``g + residual``, carry the
    quantization error to the next step. Both stacked ``(n, ...)``, or on
    a peer session both per-device lists. Returns ``(mean_grad,
    new_residual)``, each as its inputs are."""
    if isinstance(g, (list, tuple)):
        sent, new_residual = zip(*_per_member(_feedback, g, residual))
        total = comm.collectives.psum(list(sent))
        return [t / len(g) for t in total], list(new_residual)
    sent, new_residual = _feedback(g, residual)
    return comm.collectives.psum(sent) / g.shape[0], new_residual
