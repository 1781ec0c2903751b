"""Materialised oracle for the flash attention kernel (GQA + causal +
window): the whole ``(S, S)`` score matrix, float32 softmax."""

from __future__ import annotations

import torch


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
    row = torch.arange(s, device=q.device)[:, None]
    col = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= col <= row
    if window is not None:
        mask &= col > row - window
    logits = torch.where(mask, logits, -torch.inf)
    probs = torch.softmax(logits, dim=-1)
    probs = torch.where(mask.any(-1)[None, None, :, None], probs, 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vv.float())
    return out.to(q.dtype)
