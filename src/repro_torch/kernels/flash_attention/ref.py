"""Materialised oracle for the flash attention kernel (GQA + causal +
window): the whole ``(S, S)`` score matrix, float32 softmax."""

from __future__ import annotations

import torch


def attention_mask(s: int, causal: bool, window: int | None,
                   device=None) -> torch.Tensor:
    """The ``(S, S)`` boolean mask of the keys (columns) each query row
    attends: ``col <= row`` if causal, ``col > row - window`` with a
    window."""
    row = torch.arange(s, device=device)[:, None]
    col = torch.arange(s, device=device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=device)
    if causal:
        mask &= col <= row
    if window is not None:
        mask &= col > row - window
    return mask


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, *,
                      causal: bool = True, window: int | None = None,
                      scale: float | None = None) -> torch.Tensor:
    """Each row's float32 log-sum-exp of ``scale·q·kᵀ`` over the keys it
    attends, ``(B, Hq, S)``; ``-inf`` for a row with none."""
    s, d = q.shape[2], q.shape[3]
    qpk = q.shape[1] // k.shape[1]
    if scale is None:
        scale = d ** -0.5
    kk = k.repeat_interleave(qpk, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * scale
    logits = torch.where(attention_mask(s, causal, window, q.device),
                         logits, -torch.inf)
    return torch.logsumexp(logits, dim=-1)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None,
                  scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D). fp32 softmax, q.dtype out;
    a row with every position masked gives zeros."""
    b, hq, s, d = q.shape
    qpk = hq // k.shape[1]
    if scale is None:
        scale = d ** -0.5
    kk = k.repeat_interleave(qpk, dim=1)
    vv = v.repeat_interleave(qpk, dim=1)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kk.float()) * scale
    mask = attention_mask(s, causal, window, q.device)
    logits = torch.where(mask, logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask.any(-1)[None, None, :, None], probs, 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vv.float())
    return out.to(q.dtype)
