"""The ``rwkv6_scan`` kernel: the chunked RWKV-6 recurrence.

Replaces the Pallas kernel ``rwkv6_scan_kernel`` of the reference package
(``src/repro/kernels/rwkv6_scan/kernel.py``). Per head, with state
``S: (dk, dv)``, decay ``w_t`` in (0, 1] and bonus ``u``::

    o_t = r_t · (S + diag(u) kᵀ_t v_t)
    S   ← diag(w_t) S + kᵀ_t v_t

computed chunk by chunk with the per-channel log-decay cumsums
``c_t = Σ_{s≤t} log w_s`` of one chunk (``q̃ = r·exp(c_{t-1})``,
``k̃ = k·exp(-c_t)``, strictly causal scores ``q̃ k̃ᵀ``, the bonus on the
diagonal, ``q̃ S``, and ``S ← diag(exp(c_L)) S + (k̃·exp(c_L))ᵀ V``).

Layout: r, k, w ``(B, S, H, dk)``, v ``(B, S, H, dv)`` (any strides over
batch, position and head, a contiguous last dim: the model's
``(B, L, h, hd)`` projections go in as they are), w float32 (its
log-cumsum drifts in bfloat16), u ``(B, H, dk)`` float32 (a head's bonus
broadcast over the batch has batch stride 0). The output
is a new ``(B, S, H, dv)`` tensor in ``out_dtype`` (r's by default; the
model asks for float32), and with ``return_state`` also the final
``(B, H, dk, dv)`` float32 state, which the Pallas kernel keeps in VMEM
and drops but the decode cache starts from. ``S`` must be a multiple of
``chunk`` (callers pad with ``w = 1`` and zeros, which leaves the state
exact).

:func:`rwkv6_scan_cuda` launches the hand-written kernel
(``csrc/rwkv6_scan.cu``, built by :mod:`repro_torch.kernels._build`) for
dims :data:`DIMS` and chunks up to :data:`MAX_CHUNK`;
:func:`rwkv6_scan_plain` is the chunked einsum form in PyTorch, the plain
version used for CPU tensors and as the check of the kernel on the card.
:data:`LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: dk and dv the kernel is built for.
DIMS = (8, 16, 32, 64)
#: The longest chunk the kernel's shared-memory tiles hold: at 64 rows the
#: r/k/log-w/bonus/v tiles, the 64×64 score tile and the state take 117.5 KB
#: of a block's 227 KB; at 128 they would not fit.
MAX_CHUNK = 64

#: Kernel launches so far.
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_shapes(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor, chunk: int) -> None:
    """Raise ``ValueError`` unless r, k, w are ``(B, S, H, dk)``, v is
    ``(B, S, H, dv)``, u is ``(B, H, dk)``, ``S`` is a multiple of
    ``chunk`` and w is float32 (its log-cumsum drifts in bfloat16)."""
    if r.dim() != 4 or k.shape != r.shape or w.shape != r.shape:
        raise ValueError(f"need r, k, w (B, S, H, dk), got {tuple(r.shape)},"
                         f" {tuple(k.shape)}, {tuple(w.shape)}")
    b, s, h, dk = r.shape
    if v.dim() != 4 or tuple(v.shape[:3]) != (b, s, h):
        raise ValueError(f"v {tuple(v.shape)} does not match r "
                         f"{tuple(r.shape)}")
    if tuple(u.shape) != (b, h, dk):
        raise ValueError(f"need u (B, H, dk) = {(b, h, dk)}, got "
                         f"{tuple(u.shape)}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"seq {s} not a multiple of chunk {chunk}")
    if w.dtype != torch.float32:
        raise ValueError(f"need float32 w, got {w.dtype}")


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor, *, chunk: int = 64,
                     out_dtype: torch.dtype | None = None,
                     return_state: bool = False):
    """Plain PyTorch version: the chunked einsum form of the reference
    model's scan (``src/repro/models/ssm.py``), one loop step per chunk,
    float32 math. Same arguments and results as :func:`rwkv6_scan_cuda`."""
    check_shapes(r, k, v, w, u, chunk)
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    nc = s // chunk
    rc, kc, vc, wc = (t.float().reshape(b, nc, chunk, h, t.shape[-1])
                      for t in (r, k, v, w))
    uf = u.float()
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    state = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
    outs = []
    for c in range(nc):
        r_, k_, v_, w_ = rc[:, c], kc[:, c], vc[:, c], wc[:, c]
        logw = torch.log(w_)
        cum = torch.cumsum(logw, dim=1)
        qt = r_ * torch.exp(cum - logw)
        kt = k_ * torch.exp(-cum)
        scores = torch.einsum("blhd,bmhd->bhlm", qt, kt)
        scores = torch.where(mask, scores, 0.0)
        bonus = (r_ * uf[:, None] * k_).sum(-1)              # (B, L, H)
        outs.append(torch.einsum("bhlm,bmhe->blhe", scores, v_)
                    + bonus[..., None] * v_
                    + torch.einsum("blhd,bhde->blhe", qt, state))
        dl = torch.exp(cum[:, -1])                           # (B, H, dk)
        state = (state * dl[..., None]
                 + torch.einsum("blhd,blhe->bhde", kt * dl[:, None], v_))
    o = torch.stack(outs, 1).reshape(b, s, h, dv).to(out_dtype or r.dtype)
    return (o, state) if return_state else o


def _lib():
    lib = _build.load("rwkv6_scan")
    fn = lib.rwkv6_scan_launch
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64] * 17
                   + [ctypes.c_int64] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def rwkv6_scan_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, *, chunk: int = 64,
                    out_dtype: torch.dtype | None = None,
                    return_state: bool = False):
    """Launch the kernel on CUDA tensors. r, k, v float32 or bfloat16 of
    one dtype; w and u float32; dk and dv in
    :data:`DIMS`; ``chunk`` at most :data:`MAX_CHUNK`; ``out_dtype``
    float32 or bfloat16. Returns ``o`` (and the final state with
    ``return_state``); anything else raises."""
    global LAUNCHES
    check_shapes(r, k, v, w, u, chunk)
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if t.device.type != "cuda" or t.device != r.device:
            raise ValueError(f"rwkv6_scan kernel needs CUDA tensors on one "
                             f"device, got {name} on {t.device}")
        if t.stride(-1) != 1 and t.shape[-1] > 1:
            raise ValueError(f"rwkv6_scan kernel needs a contiguous last "
                             f"dim, got {name} strides {t.stride()}")
    out_dtype = out_dtype or r.dtype
    if (r.dtype not in _DTYPE_CODES or k.dtype != r.dtype
            or v.dtype != r.dtype or u.dtype != torch.float32
            or out_dtype not in _DTYPE_CODES):
        raise ValueError(f"rwkv6_scan kernel takes float32 or bfloat16 r, k, "
                         f"v of one dtype, float32 u, float32 or bfloat16 "
                         f"out; got {r.dtype}, {k.dtype}, {v.dtype}, "
                         f"{u.dtype}, {out_dtype}")
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    if dk not in DIMS or dv not in DIMS:
        raise ValueError(f"rwkv6_scan kernel supports dk and dv in {DIMS}, "
                         f"got {dk}, {dv}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"rwkv6_scan kernel takes chunks up to "
                         f"{MAX_CHUNK}, got {chunk}")
    o = torch.empty((b, s, h, dv), dtype=out_dtype, device=r.device)
    state = torch.empty((b, h, dk, dv), dtype=torch.float32, device=r.device)
    rc = _lib()(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), o.data_ptr(), state.data_ptr(),
                *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *w.stride()[:3], *o.stride()[:3], *u.stride()[:2],
                b, h, s, dk, dv, chunk, _DTYPE_CODES[r.dtype],
                _DTYPE_CODES[out_dtype],
                torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(rc, "rwkv6_scan")
    LAUNCHES += 1
    return (o, state) if return_state else o
