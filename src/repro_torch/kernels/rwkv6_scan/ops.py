"""Wrappers of the RWKV-6 scan: the kernel on the card, the plain version
on the CPU."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan.kernel import (rwkv6_scan_cuda,
                                                   rwkv6_scan_plain)


def chunked_scan(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, *, chunk: int,
                 out_dtype: torch.dtype | None = None,
                 return_state: bool = False):
    """The scan over r, k, w ``(B, S, H, dk)``, v ``(B, S, H, dv)`` and u
    ``(B, H, dk)`` (see :mod:`.kernel`). A CUDA tensor goes through the
    hand-written kernel, which takes dk, dv in 8, 16, 32, 64 and chunks up
    to 64 and raises on anything else; a CPU tensor goes through the plain
    version (differentiable by autograd); any other device raises. The
    kernel has no backward yet: on a CUDA tensor with grad enabled and an
    input that requires grad it raises ``NotImplementedError``."""
    if r.device.type == "cuda":
        if torch.is_grad_enabled() and any(
                t.requires_grad for t in (r, k, v, w, u)):
            raise NotImplementedError(
                "rwkv6_scan has no backward kernel yet; RWKV-6 training on "
                "the card comes with the slice that ports it (ROADMAP "
                "queue 1, the RWKV-6 backward kernel)")
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
