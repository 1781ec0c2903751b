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
name. The all-reduce carries the float32 dequantized contributions, as
the reference's code does; the error-feedback variant carries the
residual so the bias does not accumulate across steps.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from repro_torch.tree import tree_map

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


def compressed_psum(g: torch.Tensor, comm: "CommSession") -> torch.Tensor:
    """int8 all-reduce mean of one stacked gradient leaf ``g: (n, ...)``
    over its ``n`` members; returns ``(n, ...)`` float32, every row the
    mean."""
    q, scale = _quantize(g.to(torch.float32))
    contrib = _dequantize(q, scale)
    return comm.collectives.psum(contrib) / g.shape[0]


def compressed_psum_tree(grads, comm: "CommSession"):
    """:func:`compressed_psum` of every leaf of a tree of stacked
    leaves."""
    return tree_map(lambda g: compressed_psum(g, comm), grads)


def compressed_psum_with_feedback(g: torch.Tensor, residual: torch.Tensor,
                                  comm: "CommSession"
                                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Error-feedback compression: quantize ``g + residual``, carry the
    quantization error to the next step. Both stacked ``(n, ...)``.
    Returns ``(mean_grad, new_residual)``."""
    target = g.to(torch.float32) + residual
    q, scale = _quantize(target)
    sent = _dequantize(q, scale)
    new_residual = target - sent
    return comm.collectives.psum(sent) / g.shape[0], new_residual
