"""The ``flash_attention`` kernel: blockwise online-softmax attention.

Replaces the Pallas kernel ``flash_attention_kernel`` of the reference
package (``src/repro/kernels/flash_attention/kernel.py``): q ``(B, Hq, S,
D)``, k and v ``(B, Hkv, S, D)`` with ``Hq % Hkv == 0``, float32 or
bfloat16, scores, statistics and accumulator in float32, causal and
sliding-window masks, exact zeros for a row with nothing to attend to.

:func:`flash_attention_cuda` launches the hand-written kernel
(``csrc/flash_attention.cu``, built by :mod:`repro_torch.kernels._build`)
for the head dims :func:`check_head_dim` admits: bfloat16 runs on the
tensor cores (``wgmma`` products fed by TMA loads, P rounded to bfloat16
before P·V), float32 on the CUDA cores. :func:`flash_attention_plain` is the
materialised attention of :mod:`.ref`, the plain version used for CPU
tensors and as the check of the kernel on the card. Both can also return
each row's float32 log-sum-exp of ``scale·q·kᵀ`` (``-inf`` for a row with
nothing to attend to), which the backward needs.

The backward has no Pallas kernel to replace (the reference differentiates
its plain attention): :func:`flash_attention_bwd_cuda` launches the
hand-written ``csrc/flash_attention_bwd.cu`` (dQ, dK, dV from q, k, v, the
output, its log-sum-exp and dO; bfloat16 on the tensor cores through the
forward's ``wgmma`` and TMA building blocks in ``csrc/hopper_tiles.cuh``,
P and dS rounded to bfloat16 before the products that take them, float32
on the CUDA cores), and :func:`flash_attention_bwd_plain` is the same
function in plain PyTorch.

:func:`tile_products_cuda` runs one tile of each bfloat16 product of the
forward through its loads and ``wgmma`` layouts, and
:func:`bwd_tile_products_cuda` those of the backward's dK/dV kernel, for
testing them on the card.
:data:`LAUNCHES` counts forward launches, :data:`LAUNCHES_BWD` backward
calls (three CUDA launches each: the row sums of dO·O, dK and dV, dQ).
A meta tensor, which a cost count (:mod:`repro_torch.launch.cost`)
passes, takes the CUDA wrappers' checks and gets empty outputs, launching
nothing; on both the wrappers report the kernel's formula to the counter.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.launch import cost
from repro_torch.kernels.flash_attention.ref import (attention_lse_ref,
                                                     attention_mask,
                                                     attention_ref)

#: The widest head dim of the multiples of 8 the kernels take.
MAX_HEAD_DIM = 128
#: The one head dim past :data:`MAX_HEAD_DIM` the kernels take
#: (Nemotron-4 340B's).
WIDE_HEAD_DIM = 192
#: The kernel's grid puts ``B * Hq`` in its second dimension.
_MAX_BATCH_HEADS = 65535

#: Kernel launches so far.
LAUNCHES = 0
#: Backward kernel calls so far.
LAUNCHES_BWD = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 window: int | None) -> None:
    """Raise ``ValueError`` unless q is ``(B, Hq, S, D)``, k and v are
    ``(B, Hkv, S, D)`` with ``Hq % Hkv == 0``, and ``window`` is None or
    positive."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q (B, Hq, S, D) and k, v (B, Hkv, S, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, s, d = q.shape
    if (k.shape[0], k.shape[2], k.shape[3]) != (b, s, d):
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if k.shape[1] == 0 or hq % k.shape[1]:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={k.shape[1]}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or >= 1, got {window}")


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int | None = None,
                          scale: float | None = None,
                          return_lse: bool = False):
    """Plain PyTorch version: :func:`~.ref.attention_ref`, the whole
    ``(S, S)`` score matrix with a float32 softmax, after the kernel's
    shape checks; returns ``(B, Hq, S, D)`` in q's dtype, and with
    ``return_lse`` also the float32 ``(B, Hq, S)`` row log-sum-exp."""
    check_shapes(q, k, v, window)
    out = attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    if not return_lse:
        return out
    return out, attention_lse_ref(q, k, causal=causal, window=window,
                                  scale=scale)


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True, window: int | None = None,
                              scale: float | None = None):
    """Plain PyTorch version of the backward: ``(dq, dk, dv)`` in q's
    dtype from the materialised formula, in float32. With ``S = scale·q·kᵀ``
    masked as the forward masks it, ``P = exp(S − lse)`` (0 where masked
    or where ``lse`` is ``-inf``), ``dV = Pᵀ·dO``, ``dS = P ∘ (dO·Vᵀ −
    rowsum(dO ∘ O))``, ``dQ = scale·dS·K``, ``dK = scale·dSᵀ·Q``; dK and dV
    are summed over the query heads that share a kv head."""
    check_shapes(q, k, v, window)
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    qpk = hq // hkv
    if scale is None:
        scale = d ** -0.5
    qf, kf, vf = q.float(), k.float(), v.float()
    dof, of = do.float(), o.float()
    kk = kf.repeat_interleave(qpk, dim=1)
    vv = vf.repeat_interleave(qpk, dim=1)
    mask = attention_mask(s, causal, window, q.device)
    lse = lse.float()[..., None]
    p = torch.exp(torch.einsum("bhqd,bhkd->bhqk", qf, kk) * scale - lse)
    p = torch.where(mask & (lse > -torch.inf), p, 0.0)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vv)
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (dp - delta) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kk)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dk = dk.reshape(b, hkv, qpk, s, d).sum(2)
    dv = dv.reshape(b, hkv, qpk, s, d).sum(2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def check_head_dim(d: int, *, backward: bool = False) -> None:
    """The kernels' head-dim rule, the forward's and the backward's:
    ``d % 8 == 0`` and ``8 <= d <= 128``, or ``d == 192``. The bfloat16
    kernels are built at a padded width (16, 32, 64, 128 or 192) whose
    columns past ``d`` the TMA loads fill with zeros; the float32 ones at
    16, 32, 64, 80, 112, 128 or 192. Raise ``ValueError`` for any other
    ``d``, naming the ``backward`` kernel or the forward."""
    if (d % 8 == 0 and 8 <= d <= MAX_HEAD_DIM) or d == WIDE_HEAD_DIM:
        return
    kind = "backward" if backward else "forward"
    raise ValueError(f"flash_attention {kind} kernel takes head dims that "
                     f"are multiples of 8 up to {MAX_HEAD_DIM}, or "
                     f"{WIDE_HEAD_DIM}; got {d}")


def _lib():
    lib = _build.load("flash_attention")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64] * 14
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _bwd_lib():
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int64] * 17
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def base_address(t: torch.Tensor) -> int:
    """``t``'s data pointer; for a meta tensor, which has none, its offset
    into its storage in bytes (a storage's base is aligned on the card)."""
    if t.device.type == "meta":
        return t.storage_offset() * t.element_size()
    return t.data_ptr()


def tma_aligned(t: torch.Tensor) -> bool:
    """Whether bfloat16 ``t`` suits the tensor-core kernels' TMA loads: a
    16-byte aligned base, and batch, head and position strides in multiples
    of 8 elements (16 bytes) wherever that dimension has more than one
    entry."""
    return base_address(t) % 16 == 0 and all(
        st % 8 == 0 for st, n in zip(t.stride()[:3], t.shape[:3]) if n > 1)


def check_tma_alignment(name: str, t: torch.Tensor) -> None:
    """Raise ``ValueError`` unless bfloat16 ``t`` is :func:`tma_aligned`."""
    if not tma_aligned(t):
        raise ValueError(f"flash_attention kernel needs bfloat16 {name} "
                         f"with a 16-byte aligned base and strides in "
                         f"multiples of 8 elements, got base "
                         f"{t.data_ptr():#x}, strides {t.stride()}")


def _check_cuda_operands(q, operands, *, backward: bool = False) -> None:
    """Raise ``ValueError`` unless every ``(name, tensor)`` is a CUDA (or,
    to be counted, meta) tensor on q's device, of q's dtype (float32 or
    bfloat16), with a contiguous head dim, in a head dim
    :func:`check_head_dim` admits."""
    for name, t in operands:
        if t.device.type not in ("cuda", "meta") or t.device != q.device:
            raise ValueError(f"flash_attention kernel needs CUDA tensors on "
                             f"one device, got {name} on {t.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise ValueError(f"flash_attention kernel takes float32 or "
                             f"bfloat16 q, k, v of one dtype, got {name} "
                             f"{t.dtype}")
        if t.stride(3) != 1 and t.shape[3] > 1:
            raise ValueError(f"flash_attention kernel needs a contiguous "
                             f"head dim, got {name} strides {t.stride()}")
    b, hq, s, d = q.shape
    check_head_dim(d, backward=backward)
    if b * hq > _MAX_BATCH_HEADS:
        raise ValueError(f"B * Hq = {b * hq} exceeds {_MAX_BATCH_HEADS}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         scale: float | None = None,
                         return_lse: bool = False):
    """Launch the kernel on CUDA tensors; returns a new contiguous
    ``(B, Hq, S, D)`` tensor in q's dtype, and with ``return_lse`` also a
    new float32 ``(B, Hq, S)`` of each row's log-sum-exp. q, k and v may
    have any strides over batch, head and position but a contiguous head
    dim (bfloat16: aligned as :func:`check_tma_alignment` says); any other
    layout, dtype or head dim (:func:`check_head_dim`) raises. Meta
    tensors get the same checks and empty outputs, and launch nothing;
    both report the kernel's formula to the cost counter
    (:func:`~repro_torch.launch.cost.record_kernel`)."""
    global LAUNCHES
    check_shapes(q, k, v, window)
    _check_cuda_operands(q, (("q", q), ("k", k), ("v", v)))
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype == torch.bfloat16:
            check_tma_alignment(name, t)
    b, hq, s, d = q.shape
    if scale is None:
        scale = d ** -0.5
    out = torch.empty((b, hq, s, d), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if q.device.type == "cuda":
        with torch.cuda.device(q.device):   # the stream's own card
            rc = _lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                        out.data_ptr(),
                        None if lse is None else lse.data_ptr(),
                        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                        b, hq, k.shape[1], s, d, float(scale),
                        int(bool(causal)),
                        -1 if window is None else int(window),
                        _DTYPE_CODES[q.dtype],
                        torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(rc, "flash_attention")
        LAUNCHES += 1
    cost.record_kernel("flash_attention",
                       cost.attention_flops(b, hq, s, d, causal, window),
                       (q, k, v), (out, lse))
    return (out, lse) if return_lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             lse: torch.Tensor, do: torch.Tensor, *,
                             causal: bool = True, window: int | None = None,
                             scale: float | None = None):
    """Launch the backward kernels on CUDA tensors: ``(dq, dk, dv)``, new
    contiguous tensors in q's dtype. q, k, v and ``do`` may have any
    strides over batch, head and position but a contiguous head dim; ``o``
    (the forward's output) must be contiguous and ``lse`` a contiguous
    float32 ``(B, Hq, S)``. bfloat16 q, k, v, o and ``do`` must be aligned
    as :func:`check_tma_alignment` says. The head dim is one
    :func:`check_head_dim` admits (at 192 the bfloat16 dK/dV kernel runs
    two warpgroups a block, one for dK and one for dV). Anything else
    raises. Meta tensors as :func:`flash_attention_cuda` takes them."""
    global LAUNCHES_BWD
    check_shapes(q, k, v, window)
    _check_cuda_operands(q, (("q", q), ("k", k), ("v", v), ("o", o),
                             ("do", do)), backward=True)
    if o.shape != q.shape or do.shape != q.shape or not o.is_contiguous():
        raise ValueError(f"flash_attention backward needs a contiguous o and "
                         f"a do of q's shape {tuple(q.shape)}, got "
                         f"{tuple(o.shape)} (contiguous: "
                         f"{o.is_contiguous()}) and {tuple(do.shape)}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
            check_tma_alignment(name, t)
    b, hq, s, d = q.shape
    if (lse.dtype != torch.float32 or tuple(lse.shape) != (b, hq, s)
            or not lse.is_contiguous() or lse.device != q.device):
        raise ValueError(f"flash_attention backward needs a contiguous "
                         f"float32 lse of shape {(b, hq, s)} on {q.device}, "
                         f"got {lse.dtype} {tuple(lse.shape)}")
    if scale is None:
        scale = d ** -0.5
    dq = torch.empty((b, hq, s, d), dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=q.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    delta = torch.empty((b, hq, s), dtype=torch.float32, device=q.device)
    if q.device.type == "cuda":
        with torch.cuda.device(q.device):   # the stream's own card
            rc = _bwd_lib()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                            delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                            dv.data_ptr(), *q.stride()[:3], *k.stride()[:3],
                            *v.stride()[:3], *do.stride()[:3], b, hq,
                            k.shape[1], s, d, float(scale),
                            int(bool(causal)),
                            -1 if window is None else int(window),
                            _DTYPE_CODES[q.dtype],
                            torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(rc, "flash_attention_bwd")
        LAUNCHES_BWD += 1
    cost.record_kernel("flash_attention_bwd",
                       cost.attention_bwd_flops(b, hq, s, d, causal, window),
                       (q, k, v, o, lse, do), (dq, dk, dv, delta))
    return dq, dk, dv


def tile_products_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       p: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One 64-row tile of each bfloat16 product, through the tensor-core
    kernel's TMA loads, shared-memory layouts and ``wgmma`` fragments:
    ``(q @ k.T, p @ v)`` in float32 for contiguous bfloat16 CUDA tensors q,
    k, v ``(64, D)`` and p ``(64, 64)``. A test of the layouts on the
    card; it does not count in :data:`LAUNCHES`."""
    d = q.shape[-1]
    for name, t, shape in (("q", q, (64, d)), ("k", k, (64, d)),
                           ("v", v, (64, d)), ("p", p, (64, 64))):
        if (tuple(t.shape) != shape or t.dtype != torch.bfloat16
                or t.device.type != "cuda" or not t.is_contiguous()):
            raise ValueError(f"tile_products_cuda needs contiguous "
                             f"bfloat16 CUDA {name} of shape {shape}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    check_head_dim(d)
    s = torch.empty((64, 64), dtype=torch.float32, device=q.device)
    o = torch.empty((64, d), dtype=torch.float32, device=q.device)
    fn = _build.load("flash_attention").flash_attention_tile_products
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
            s.data_ptr(), o.data_ptr(), d,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention tile products")
    return s, o


def bwd_tile_products_cuda(k: torch.Tensor, q: torch.Tensor,
                           do: torch.Tensor
                           ) -> tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """One 64-row tile of each bfloat16 product of the backward's dK/dV
    kernel, through its TMA loads, shared-memory layouts and ``wgmma``
    fragments: ``st = k @ q.T`` (K as A, Q as K-major B), then with ``p``
    = st rounded to bfloat16 and packed from the accumulator as the A
    operand, ``(st, p @ do, p @ q)`` (dO and Q as MN-major B), in float32,
    for contiguous bfloat16 CUDA tensors k, q, do ``(64, D)``. A test of
    the layouts on the card; it does not count in :data:`LAUNCHES_BWD`."""
    d = q.shape[-1]
    for name, t in (("k", k), ("q", q), ("do", do)):
        if (tuple(t.shape) != (64, d) or t.dtype != torch.bfloat16
                or t.device.type != "cuda" or not t.is_contiguous()):
            raise ValueError(f"bwd_tile_products_cuda needs contiguous "
                             f"bfloat16 CUDA {name} of shape {(64, d)}, "
                             f"got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    check_head_dim(d, backward=True)
    st = torch.empty((64, 64), dtype=torch.float32, device=q.device)
    pd = torch.empty((64, d), dtype=torch.float32, device=q.device)
    pq = torch.empty((64, d), dtype=torch.float32, device=q.device)
    fn = _build.load("flash_attention_bwd").flash_attention_bwd_tile_products
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(k.data_ptr(), q.data_ptr(), do.data_ptr(), st.data_ptr(),
            pd.data_ptr(), pq.data_ptr(), d,
            torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_attention_bwd tile products")
    return st, pd, pq
