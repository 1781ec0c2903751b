"""Shared model layers: norms, RoPE, attention, MLPs.

Attention comes in three flavours, as in the reference:

* ``naive_attention``     — materialises (Sq, Sk); used for short sequences.
* ``blockwise_attention`` — online softmax over KV blocks. On a CUDA
                            (or meta) tensor with ``Sq == Sk`` it runs the
                            hand-written ``flash_attention`` kernel, the
                            same function (under autograd with its
                            backward kernel); on the CPU it keeps the
                            plain blockwise/naive code.
* ``chunked_decode_attention`` — flash-decoding split-KV for serve steps:
                            the cache carries an explicit chunk dim;
                            partial (m, l, o) statistics merge with a
                            log-sum-exp reduction over chunks. Plain
                            PyTorch on every device.

The sliding window is an int (−1 = full attention) so local/global
stacks (gemma3) walk a per-layer window list with a single code path.

Dtype rules kept from the reference, or bfloat16 drifts from it: the
RMS statistics accumulate in float32 and the product is taken in
``x.dtype``; the RoPE tables are float32 and the rotation is done in
``x.dtype``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention

NEG_INF = -1e30


# -- norms -----------------------------------------------------------------
def _rms_inv(x: torch.Tensor, eps: float) -> torch.Tensor:
    """``rsqrt(mean(x²) + eps)`` per row, ``(..., 1)`` float32."""
    xf = x.float()
    var = torch.einsum("...d,...d->...", xf, xf)[..., None] / x.shape[-1]
    return torch.rsqrt(var + eps)


def _rms_norm_fwd(x, weight, eps):
    inv = _rms_inv(x, eps)
    return x * inv.to(x.dtype) * (1.0 + weight).to(x.dtype), inv


class RMSNormFn(torch.autograd.Function):
    """RMSNorm with the reference's hand-written VJP (``_rms_norm_fwd`` /
    ``_rms_norm_bwd`` of its ``models/layers.py``) and its dtype rules: the
    x-cotangent stays in ``x.dtype`` (autodiff through the float32
    statistics would promote the residual stream's cotangent to float32),
    row statistics accumulate in float32, and ``dw`` accumulates in
    float32 and is cast to the weight's dtype."""

    @staticmethod
    def forward(ctx, x, weight, eps):
        y, inv = _rms_norm_fwd(x, weight, eps)
        ctx.save_for_backward(x, weight, inv)
        return y

    @staticmethod
    def backward(ctx, g):
        x, weight, inv = ctx.saved_tensors
        d = x.shape[-1]
        w1 = (1.0 + weight).to(x.dtype)
        t = g * w1                                      # (..., d) x.dtype
        # rowwise float32 accumulation; per-row scalars only
        s = torch.einsum("...d,...d->...", t.float(), x.float())[..., None]
        coef = inv * inv * inv * s / d
        dx = t * inv.to(x.dtype) - x * coef.to(x.dtype)
        dw = torch.einsum("...d,...d->d", g.float(),
                          (x * inv.to(x.dtype)).float())
        return dx, dw.to(weight.dtype), None


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMSNorm with a zero-centred weight: ``x * rsqrt(mean(x²) + eps) *
    (1 + weight)``. Row statistics accumulate in float32; the products
    are taken in ``x.dtype``; the backward is the reference's
    (:class:`RMSNormFn`)."""
    return RMSNormFn.apply(x, weight, eps)


# -- rotary embeddings --------------------------------------------------------
def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, hd); positions: (S,) or broadcastable int.

    Angles (small (S, hd/2) tables) are float32; the rotation multiplies
    in ``x.dtype``."""
    hd = x.shape[-1]
    inv = rope_frequencies(hd, theta, x.device)
    ang = positions[..., :, None].to(torch.float32) * inv   # (S, hd/2)
    cos = torch.cos(ang).to(x.dtype)
    sin = torch.sin(ang).to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


# -- attention ----------------------------------------------------------------
def _window_mask(row: torch.Tensor, col: torch.Tensor, window: int,
                 causal: bool) -> torch.Tensor:
    """row/col: broadcastable global positions; window < 0 means
    unlimited."""
    mask = torch.ones(torch.broadcast_shapes(row.shape, col.shape),
                      dtype=torch.bool, device=row.device)
    if causal:
        mask &= col <= row
    if window >= 0:
        mask &= col > row - window
    return mask


def _window(window: int | None) -> int:
    return -1 if window is None else int(window)


def naive_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int | None,
                    scale: float) -> torch.Tensor:
    """q: (B, Hq, Sq, hd); k/v: (B, Hkv, Sk, hd) — GQA via head folding."""
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    qpk = hq // hkv
    qg = q.reshape(b, hkv, qpk, sq, hd)
    s = torch.einsum("bgqtd,bgsd->bgqts", qg.float(), k.float()) * scale
    row = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    col = torch.arange(sk, device=q.device)[None, :]
    mask = _window_mask(row, col, _window(window), causal)
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bgqts,bgsd->bgqtd", p, v.float())
    return o.reshape(b, hq, sq, hd).to(q.dtype)


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool, window: int | None, scale: float,
                        block_k: int = 1024) -> torch.Tensor:
    """Flash-structured attention: online softmax over KV blocks.

    On a CUDA tensor this is the ``flash_attention`` kernel (``Sq == Sk``
    only: the kernel's rows and columns are the same positions; other
    shapes raise), and so on a meta tensor, which a cost count passes. On
    the CPU: the naive version when ``Sk <= block_k``, else the plain
    blockwise loop, which never holds more than (..., Sq, block_k)
    scores.
    """
    b, hq, sq, hd = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    window = _window(window)
    if q.device.type in ("cuda", "meta"):
        if sq != sk:
            raise ValueError(f"the flash_attention kernel takes Sq == Sk, "
                             f"got Sq={sq}, Sk={sk}")
        return flash_attention(q, k, v, causal=causal,
                               window=window if window >= 0 else None,
                               scale=scale)
    if sk <= block_k:
        return naive_attention(q, k, v, causal=causal, window=window,
                               scale=scale)
    qpk = hq // hkv
    pad = (-sk) % block_k
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    nblk = (sk + pad) // block_k
    kb = k.reshape(b, hkv, nblk, block_k, hd)
    vb = v.reshape(b, hkv, nblk, block_k, hd)
    qg = (q.reshape(b, hkv, qpk, sq, hd) * scale).float()
    row = torch.arange(sq, device=q.device)[:, None] + (sk - sq)
    m = torch.full((b, hkv, qpk, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, hkv, qpk, sq, 1), device=q.device)
    acc = torch.zeros((b, hkv, qpk, sq, hd), device=q.device)
    for j in range(nblk):
        s = torch.einsum("bgqtd,bgsd->bgqts", qg, kb[:, :, j].float())
        col = j * block_k + torch.arange(block_k, device=q.device)[None, :]
        mask = _window_mask(row, col, window, causal) & (col < sk)
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.exp(s - m_new) * mask
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bgqts,bgsd->bgqtd", p,
                                         vb[:, :, j].float())
        m = m_new
    o = acc / torch.where(l == 0.0, 1.0, l)
    return o.reshape(b, hq, sq, hd).to(q.dtype)


def chunked_decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor,
                             cur_len: torch.Tensor | int, *,
                             window: int | None,
                             scale: float) -> torch.Tensor:
    """Single-token decode against a chunked cache (flash-decoding).

    q: (B, Hq, hd); k/v_cache: (B, Hkv, C, Sc, hd) — C is the split-KV
    chunk dim. ``cur_len`` is the number of valid cache positions, an int
    or a 0-d tensor on the cache's device (read on the device only).
    Returns (B, Hq, hd).
    """
    b, hq, hd = q.shape
    hkv, c, sc = k_cache.shape[1], k_cache.shape[2], k_cache.shape[3]
    qpk = hq // hkv
    window = _window(window)
    qg = (q.reshape(b, hkv, qpk, hd) * scale).float()

    s = torch.einsum("bgqd,bgcsd->bgqcs", qg, k_cache.float())
    dev = q.device
    pos = (torch.arange(c, device=dev)[:, None] * sc
           + torch.arange(sc, device=dev)[None, :])
    row = cur_len - 1
    valid = pos < cur_len
    if window >= 0:
        valid &= pos > row - window
    s = torch.where(valid, s, NEG_INF)

    m_c = s.amax(-1)                                       # (b,g,q,C)
    p = torch.exp(s - m_c[..., None]) * valid
    l_c = p.sum(-1)                                        # (b,g,q,C)
    o_c = torch.einsum("bgqcs,bgcsd->bgqcd", p, v_cache.float())

    m = m_c.amax(-1, keepdim=True)                         # merge over C
    w = torch.exp(m_c - m)
    l = (l_c * w).sum(-1)
    o = torch.einsum("bgqc,bgqcd->bgqd",
                     w * l_c / torch.where(l[..., None] == 0, 1.0,
                                           l[..., None]),
                     o_c / torch.where(l_c[..., None] == 0, 1.0,
                                       l_c[..., None]))
    return o.reshape(b, hq, hd).to(q.dtype)


# -- MLP variants ---------------------------------------------------------------
def mlp_apply(x: torch.Tensor, params: dict, kind: str) -> torch.Tensor:
    """x: (..., d). kinds: swiglu | geglu | gelu | relu2 (the GELUs are
    the tanh approximation, as in the reference)."""
    w1, w2 = params["w1"], params["w2"]
    if kind in ("swiglu", "geglu"):
        g = x @ w1
        u = x @ params["w3"]
        act = F.silu(g) if kind == "swiglu" else F.gelu(g,
                                                         approximate="tanh")
        return (act * u) @ w2
    h = x @ w1
    if kind == "gelu":
        h = F.gelu(h, approximate="tanh")
    elif kind == "relu2":
        h = torch.square(F.relu(h))
    else:
        raise ValueError(f"unknown mlp kind {kind}")
    return h @ w2


def mlp_init(d: int, ff: int, kind: str, dtype: torch.dtype, *,
             generator: torch.Generator, device, lead: tuple = ()) -> dict:
    """Weights of one MLP (or ``lead``-stacked MLPs): normal × ``d**-0.5``
    in, normal × ``ff**-0.5`` out, drawn from ``generator``."""
    def normal(shape, scale):
        w = torch.randn(lead + shape, generator=generator, device=device,
                        dtype=dtype)
        return w.mul_(scale)

    p = {"w1": normal((d, ff), d ** -0.5),
         "w2": normal((ff, d), ff ** -0.5)}
    if kind in ("swiglu", "geglu"):
        p["w3"] = normal((d, ff), d ** -0.5)
    return p
