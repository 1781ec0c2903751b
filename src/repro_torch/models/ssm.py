"""The RWKV-6 (Finch) time-mix: the full-sequence path and one decode step.

The reference's ``models/ssm.py`` holds two mixers; this module ports its
RWKV-6 half (Mamba comes with the hybrid slice). The full-sequence path
(prefill) runs the chunked scan of :mod:`repro_torch.kernels.rwkv6_scan`:
on a CUDA tensor the hand-written kernel, on a CPU tensor its plain
version. The decode step is a few plain tensor ops on the O(1) state, as
in the reference. States are returned explicitly so the serving cache can
carry them.

Deliberate difference from the reference: the scan runs in chunks of
:data:`~repro_torch.kernels.rwkv6_scan.kernel.MAX_CHUNK` (64) positions
on every device instead of 128, since the kernel's shared-memory tiles
hold 64 rows. The chunked form is exact for any chunk length; only
float32 rounding differs. The scan's output stays float32 into the group
norm, as the reference's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan.kernel import MAX_CHUNK
from repro_torch.kernels.rwkv6_scan.ops import chunked_scan


def rwkv6_init(d: int, head_dim: int, dtype: torch.dtype, *,
               generator: torch.Generator, device=None,
               lead: tuple = ()) -> dict:
    """One time-mix's parameters (``lead``-stacked), with the reference's
    distributions: ``mu`` uniform in [0, 1), the projections normal ×
    ``d**-0.5`` (``w_w`` × 0.1 more), ``u`` normal × 0.3, ``ln_x`` zero;
    ``mu``, ``u`` and ``ln_x`` in float32."""
    h = d // head_dim
    s = d ** -0.5

    def normal(shape, scale, dt=dtype):
        return torch.randn(lead + shape, generator=generator, device=device,
                           dtype=dt).mul_(scale)

    return {
        "mu": torch.rand(lead + (5, d), generator=generator, device=device),
        "w_r": normal((d, d), s),
        "w_k": normal((d, d), s),
        "w_v": normal((d, d), s),
        "w_w": normal((d, d), s * 0.1),
        "w_g": normal((d, d), s),
        "u": normal((h, head_dim), 0.3, torch.float32),
        "ln_x": torch.zeros(lead + (d,), device=device),
        "w_out": normal((d, d), s),
    }


def _rwkv6_project(x, shifted, p, head_dim):
    """Token-shift mix + projections → per-head r/k/v/w/g."""
    b = x.shape[:-1]
    d = x.shape[-1]
    h = d // head_dim
    delta = shifted - x
    mixed = [x + p["mu"][i].to(x.dtype) * delta for i in range(5)]
    r = (mixed[0] @ p["w_r"]).reshape(*b, h, head_dim)
    k = (mixed[1] @ p["w_k"]).reshape(*b, h, head_dim)
    v = (mixed[2] @ p["w_v"]).reshape(*b, h, head_dim)
    w = torch.exp(-torch.exp(
        (mixed[3] @ p["w_w"]).float() - 2.0)
    ).reshape(*b, h, head_dim)                               # decay ∈ (0,1)
    g = mixed[4] @ p["w_g"]
    return r, k, v, w, g


def _rwkv6_finish(o, g, p, x_dtype):
    """Per-head group-norm → gate → output projection."""
    b = o.shape[:-2]
    d = o.shape[-2] * o.shape[-1]
    of = o.float()
    var = torch.mean(of * of, dim=-1, keepdim=True)
    of = of * torch.rsqrt(var + 1e-6)
    of = of.reshape(*b, d) * (1.0 + p["ln_x"])
    return (of.to(x_dtype) * F.silu(g)) @ p["w_out"]


def rwkv6_apply(x: torch.Tensor, p: dict, *, head_dim: int,
                return_state: bool = False):
    """Full-sequence RWKV-6 time-mix. x: (B, L, d) → (B, L, d).

    With ``return_state`` also returns ``(wkv_state, shift_state)``:
    the float32 ``(B, h, dk, dv)`` state after the last position and
    ``x[:, -1]``. Padding carries identity decay (w=1) and zero k, so
    the final state is exact regardless of padding.
    """
    b, l, d = x.shape
    h = d // head_dim
    shifted = F.pad(x, (0, 0, 1, 0))[:, :-1]
    r, k, v, w, g = _rwkv6_project(x, shifted, p, head_dim)

    chunk = min(MAX_CHUNK, l)
    pad = (-l) % chunk
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, 0, 0, pad), value=1.0)
    o, state = chunked_scan(r, k, v, w, p["u"].expand(b, h, head_dim),
                            chunk=chunk, out_dtype=torch.float32,
                            return_state=True)
    out = _rwkv6_finish(o[:, :l], g, p, x.dtype)
    if not return_state:
        return out
    return out, (state, x[:, -1])                 # (state, shift_state)


def rwkv6_decode(x: torch.Tensor, p: dict, state: torch.Tensor,
                 shift_state: torch.Tensor, *, head_dim: int,
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step. x: (B, d); state: (B, h, dk, dv); shift_state: (B, d).
    Returns (out, new state, new shift state)."""
    r, k, v, w, g = _rwkv6_project(x, shift_state, p, head_dim)
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    kv = torch.einsum("bhd,bhe->bhde", kf, vf)
    o = torch.einsum("bhd,bhde->bhe", rf,
                     state + p["u"][None, :, :, None] * kv)
    state = state * wf[..., None] + kv
    out = _rwkv6_finish(o, g, p, x.dtype)
    return out, state, x
