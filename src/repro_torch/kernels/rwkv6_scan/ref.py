"""Literal oracle for the RWKV-6 scan kernel: the per-step recurrence.

Per head, with state ``S: (dk, dv)``::

    o_t = r_t · (S + diag(u) kᵀ_t v_t)
    S   ← diag(w_t) S + kᵀ_t v_t

One Python step per position: for tests and small checks only.
"""

from __future__ import annotations

import torch


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor, *,
                   return_state: bool = False):
    """r/k/w: (BH, S, dk); v: (BH, S, dv); u: (BH, dk) -> (BH, S, dv) in
    r's dtype, float32 math. With ``return_state`` also the final
    ``(BH, dk, dv)`` float32 state."""
    rf, kf, vf, wf, uf = (t.float() for t in (r, k, v, w, u))
    bh, s, dk = rf.shape
    state = torch.zeros((bh, dk, vf.shape[-1]), dtype=torch.float32,
                        device=r.device)
    outs = []
    for t in range(s):
        kv = kf[:, t, :, None] * vf[:, t, None, :]
        outs.append(torch.einsum("bd,bde->be", rf[:, t],
                                 state + uf[:, :, None] * kv))
        state = wf[:, t, :, None] * state + kv
    o = torch.stack(outs, 1).to(r.dtype)
    return (o, state) if return_state else o
