"""Wrappers of the RWKV-6 scan: the kernel on the card, the plain version
on the CPU, and the autograd function whose backward is the backward
kernel."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan.kernel import (rwkv6_scan_bwd_cuda,
                                                   rwkv6_scan_cuda,
                                                   rwkv6_scan_fwd_cuda,
                                                   rwkv6_scan_plain)


class RWKV6ScanFn(torch.autograd.Function):
    """The scan on CUDA tensors with a hand-written backward: the forward
    kernel's chunk-start workspace is kept for the backward kernel
    (``rwkv6_scan_bwd_cuda``), which needs the state at every chunk's
    start and so does not recompute it. Returns ``(o, final state)``; a
    gradient autograd does not hand over (an unused output) is zeros. dO
    goes to the kernel as float32 with a contiguous last dim (a copy only
    when it is not), the final state's gradient as a contiguous float32.
    u's gradient comes back per ``(B, H, dk)``; autograd sums it over an
    expanded batch."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk, out_dtype):
        o, state, states = rwkv6_scan_fwd_cuda(r, k, v, w, u, chunk=chunk,
                                               out_dtype=out_dtype)
        ctx.save_for_backward(r, k, v, w, u, states)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return o, state

    @staticmethod
    def backward(ctx, do, dstate):
        r, k, v, w, u, states = ctx.saved_tensors
        if do is None:
            do = torch.zeros(v.shape, dtype=torch.float32, device=v.device)
        elif do.dtype != torch.float32 or do.stride(-1) != 1:
            do = do.float().contiguous()
        if dstate is not None:
            dstate = dstate.float().contiguous()
        dr, dk, dv, dw, du = rwkv6_scan_bwd_cuda(r, k, v, w, u, do, dstate,
                                                 states=states,
                                                 chunk=ctx.chunk)
        return dr, dk, dv, dw, du, None, None


def chunked_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, *, chunk: int,
                 out_dtype: torch.dtype | None = None,
                 return_state: bool = False):
    """The scan over r, k, w ``(B, S, H, dk)``, v ``(B, S, H, dv)`` and u
    ``(B, H, dk)`` (see :mod:`.kernel`). A CUDA tensor goes through the
    hand-written kernel, which takes dk, dv in 8, 16, 32, 64 and chunks up
    to 64 and raises on anything else: through :class:`RWKV6ScanFn`,
    whose backward is the backward kernel, when grad is enabled and an
    input requires grad, else the forward alone. A meta tensor, which a
    cost count passes, takes the card's branch. A CPU tensor goes through
    the plain version (differentiable by autograd); any other device
    raises."""
    if r.device.type in ("cuda", "meta"):
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (r, k, v, w, u)):
            o, state = RWKV6ScanFn.apply(r, k, v, w, u, chunk, out_dtype)
            return (o, state) if return_state else o
        return rwkv6_scan_cuda(r, k, v, w, u, chunk=chunk,
                               out_dtype=out_dtype,
                               return_state=return_state)
    if r.device.type == "cpu":
        return rwkv6_scan_plain(r, k, v, w, u, chunk=chunk,
                                out_dtype=out_dtype,
                                return_state=return_state)
    raise ValueError(f"unsupported device {r.device}")


def rwkv6_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               w: torch.Tensor, u: torch.Tensor, *,
               chunk: int = 64) -> torch.Tensor:
    """r/k/w ``(BH, S, dk)``, v ``(BH, S, dv)``, u ``(BH, dk)`` →
    ``(BH, S, dv)`` in r's dtype, as the reference's wrapper: the chunk is
    clamped to ``min(chunk, max(8, S))`` and the sequence padded to a
    multiple of it (w with 1.0, the identity decay; r, k, v with 0). w
    goes in as float32, the dtype the reference's kernel computes in."""
    s = r.shape[1]
    w = w.float()
    chunk = min(chunk, max(8, s))
    pad = (-s) % chunk
    if pad:
        r, k, v = (F.pad(t, (0, 0, 0, pad)) for t in (r, k, v))
        w = F.pad(w, (0, 0, 0, pad), value=1.0)
    out = chunked_scan(r[:, :, None], k[:, :, None], v[:, :, None],
                       w[:, :, None], u.float()[:, None], chunk=chunk)
    return out[:, :s, 0]
