"""The ``rwkv6_scan`` kernel: the chunked RWKV-6 recurrence.

Replaces the Pallas kernel ``rwkv6_scan_kernel`` of the reference package
(``src/repro/kernels/rwkv6_scan/kernel.py``). Per head, with state
``S: (dk, dv)``, decay ``w_t`` in (0, 1] and bonus ``u``::

    o_t = r_t · (S + diag(u) kᵀ_t v_t)
    S   ← diag(w_t) S + kᵀ_t v_t

computed chunk by chunk with the per-channel log-decay cumsums
``c_t = Σ_{s≤t} log w_s`` of one chunk (``q̃ = r·exp(c_{t-1})``,
``k̃ = k·exp(-c_t)``, strictly causal scores ``q̃ k̃ᵀ``, the bonus on the
diagonal, ``q̃ S``, and ``S ← diag(exp(c_L)) S + (k·exp(c_L - c))ᵀ V``).
The state at each chunk's start is the only serial part, so both the
kernel and the plain version run two passes: the chunk-start states
(:func:`rwkv6_chunk_states_plain`), then every chunk's output from its
start state (:func:`rwkv6_chunk_output_plain`).

Layout: r, k, w ``(B, S, H, dk)``, v ``(B, S, H, dv)`` (any strides over
batch, position and head, a contiguous last dim: the model's
``(B, L, h, hd)`` projections go in as they are; the kernels load 16
bytes at a time, so an input whose base or strides are off that grid is
first copied to a new contiguous tensor), w
float32 (its log-cumsum drifts in bfloat16), u ``(B, H, dk)`` float32 (a
head's bonus broadcast over the batch has batch stride 0). The output
is a new ``(B, S, H, dv)`` tensor in ``out_dtype`` (r's by default; the
model asks for float32), and with ``return_state`` also the final
``(B, H, dk, dv)`` float32 state, which the Pallas kernel keeps in VMEM
and drops but the decode cache starts from. ``S`` must be a multiple of
``chunk`` (callers pad with ``w = 1`` and zeros, which leaves the state
exact).

:func:`rwkv6_scan_cuda` launches the hand-written kernels
(``csrc/rwkv6_scan.cu``, built by :mod:`repro_torch.kernels._build`) for
dims :data:`DIMS` and chunks up to :data:`MAX_CHUNK`;
:func:`rwkv6_scan_plain` is the chunked einsum form in PyTorch, the plain
version used for CPU tensors and as the check of the kernel on the card.
:data:`LAUNCHES` counts calls of :func:`rwkv6_scan_cuda`.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

#: dk and dv the kernel is built for.
DIMS = (8, 16, 32, 64)
#: The longest chunk the output pass's shared-memory tiles hold: at 64
#: rows the r, k-then-start-state, w-then-scores and v tiles take 68.3
#: KiB, so three blocks fit on an SM.
MAX_CHUNK = 64

#: Calls of :func:`rwkv6_scan_cuda` so far; each launches two kernels, the
#: chunk-start states and then the outputs.
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_shapes(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor | None,
                 chunk: int) -> None:
    """Raise ``ValueError`` unless r, k, w are ``(B, S, H, dk)``, v is
    ``(B, S, H, dv)``, u is ``(B, H, dk)`` (unchecked if None), ``S`` is a
    multiple of ``chunk`` and w is float32 (its log-cumsum drifts in
    bfloat16)."""
    if r.dim() != 4 or k.shape != r.shape or w.shape != r.shape:
        raise ValueError(f"need r, k, w (B, S, H, dk), got {tuple(r.shape)},"
                         f" {tuple(k.shape)}, {tuple(w.shape)}")
    b, s, h, dk = r.shape
    if v.dim() != 4 or tuple(v.shape[:3]) != (b, s, h):
        raise ValueError(f"v {tuple(v.shape)} does not match r "
                         f"{tuple(r.shape)}")
    if u is not None and tuple(u.shape) != (b, h, dk):
        raise ValueError(f"need u (B, H, dk) = {(b, h, dk)}, got "
                         f"{tuple(u.shape)}")
    if chunk < 1 or s % chunk:
        raise ValueError(f"seq {s} not a multiple of chunk {chunk}")
    if w.dtype != torch.float32:
        raise ValueError(f"need float32 w, got {w.dtype}")


def _chunks(t: torch.Tensor, chunk: int) -> torch.Tensor:
    """``(B, S, H, d)`` → float32 ``(B, S / chunk, chunk, H, d)``."""
    b, s, h, d = t.shape
    return t.float().reshape(b, s // chunk, chunk, h, d)


def rwkv6_chunk_states_plain(k: torch.Tensor, v: torch.Tensor,
                             w: torch.Tensor, *, chunk: int = 64):
    """The first pass, plain: the float32 state at the start of every
    chunk, ``(B, H, S / chunk, dk, dv)`` (zeros first), and the final state
    ``(B, H, dk, dv)``. Each chunk's update ``diag(exp(c_L)) S +
    (k·exp(c_L - c))ᵀ V`` is formed for all chunks at once; only their
    composition loops."""
    check_shapes(k, k, v, w, None, chunk)
    b, s, h, dk = k.shape
    dv = v.shape[-1]
    kc, vc = _chunks(k, chunk), _chunks(v, chunk)
    cum = torch.cumsum(torch.log(_chunks(w, chunk)), dim=2)
    last = cum[:, :, -1]                                  # (B, nc, H, dk)
    upd = torch.einsum("bclhd,bclhe->bchde",
                       kc * torch.exp(last[:, :, None] - cum), vc)
    decay = torch.exp(last)
    state = torch.zeros((b, h, dk, dv), dtype=torch.float32, device=k.device)
    starts = []
    for c in range(s // chunk):
        starts.append(state)
        state = state * decay[:, c, :, :, None] + upd[:, c]
    if not starts:
        return state.new_zeros((b, h, 0, dk, dv)), state
    return torch.stack(starts, 2), state


def rwkv6_chunk_output_plain(r: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, w: torch.Tensor,
                             u: torch.Tensor, states: torch.Tensor, *,
                             chunk: int = 64,
                             out_dtype: torch.dtype | None = None):
    """The second pass, plain: every chunk's output from its start state
    ``states`` (as :func:`rwkv6_chunk_states_plain` returns them), all
    chunks at once, float32 math."""
    check_shapes(r, k, v, w, u, chunk)
    b, s, h, _ = r.shape
    dv = v.shape[-1]
    rc, kc, vc = (_chunks(t, chunk) for t in (r, k, v))
    logw = torch.log(_chunks(w, chunk))
    cum = torch.cumsum(logw, dim=2)
    qt = rc * torch.exp(cum - logw)
    kt = kc * torch.exp(-cum)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    scores = torch.where(mask, torch.einsum("bclhd,bcmhd->bchlm", qt, kt),
                         0.0)
    bonus = (rc * u.float()[:, None, None] * kc).sum(-1)  # (B, nc, L, H)
    o = (torch.einsum("bchlm,bcmhe->bclhe", scores, vc)
         + bonus[..., None] * vc
         + torch.einsum("bclhd,bhcde->bclhe", qt, states))
    return o.reshape(b, s, h, dv).to(out_dtype or r.dtype)


def rwkv6_scan_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     w: torch.Tensor, u: torch.Tensor, *, chunk: int = 64,
                     out_dtype: torch.dtype | None = None,
                     return_state: bool = False):
    """Plain PyTorch version: the chunked einsum form of the reference
    model's scan (``src/repro/models/ssm.py``) as its two passes, float32
    math. Same arguments and results as :func:`rwkv6_scan_cuda`."""
    states, state = rwkv6_chunk_states_plain(k, v, w, chunk=chunk)
    o = rwkv6_chunk_output_plain(r, k, v, w, u, states, chunk=chunk,
                                 out_dtype=out_dtype)
    return (o, state) if return_state else o


def _check_cuda(r, k, v, w, u, chunk, out_dtype) -> torch.dtype:
    """Raise ``ValueError`` on anything the kernels do not take; returns
    the output dtype."""
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
    dk, dv = r.shape[-1], v.shape[-1]
    if dk not in DIMS or dv not in DIMS:
        raise ValueError(f"rwkv6_scan kernel supports dk and dv in {DIMS}, "
                         f"got {dk}, {dv}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"rwkv6_scan kernel takes chunks up to "
                         f"{MAX_CHUNK}, got {chunk}")
    return out_dtype


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if its base and its batch, position and head strides
    keep 16-byte loads aligned, else a contiguous copy (whose rows are
    16-byte multiples for every dim in :data:`DIMS`)."""
    n = 16 // t.element_size()
    if t.data_ptr() % 16 == 0 and all(
            st % n == 0 for st, size in zip(t.stride()[:3], t.shape[:3])
            if size > 1):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _buffers(r, v, chunk, out_dtype):
    """The output, the final state and the chunk-start workspace."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    o = torch.empty((b, s, h, dv), dtype=out_dtype, device=r.device)
    state = torch.empty((b, h, dk, dv), dtype=torch.float32, device=r.device)
    ws = torch.empty((b, h, s // chunk, dk, dv), dtype=torch.float32,
                     device=r.device)
    return o, state, ws


def _launch(entry: str, r, k, v, w, u, o, state, ws, chunk) -> None:
    """Call one C entry point of the library (all share one argument
    list) on the current stream; raises on a CUDA error."""
    fn = getattr(_build.load("rwkv6_scan"), entry)
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int64] * 17
                   + [ctypes.c_int64] * 3 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    b, s, h, dk = r.shape
    rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u.data_ptr(), o.data_ptr(), state.data_ptr(), ws.data_ptr(),
            *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            *w.stride()[:3], *o.stride()[:3], *u.stride()[:2],
            b, h, s, dk, v.shape[-1], chunk, _DTYPE_CODES[r.dtype],
            _DTYPE_CODES[o.dtype],
            torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(rc, f"rwkv6_scan ({entry})")


def rwkv6_scan_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, *, chunk: int = 64,
                    out_dtype: torch.dtype | None = None,
                    return_state: bool = False):
    """Launch the two kernels on CUDA tensors, in order on the current
    stream with no host sync between them. r, k, v float32 or bfloat16 of
    one dtype; w and u float32; dk and dv in :data:`DIMS`; ``chunk`` at
    most :data:`MAX_CHUNK`; ``out_dtype`` float32 or bfloat16. Returns
    ``o`` (and the final state with ``return_state``); anything else
    raises."""
    global LAUNCHES
    out_dtype = _check_cuda(r, k, v, w, u, chunk, out_dtype)
    r, k, v, w = (aligned16(t) for t in (r, k, v, w))
    o, state, ws = _buffers(r, v, chunk, out_dtype)
    _launch("rwkv6_scan_launch", r, k, v, w, u, o, state, ws, chunk)
    LAUNCHES += 1
    return (o, state) if return_state else o


def rwkv6_scan_passes_cuda(r: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, w: torch.Tensor,
                           u: torch.Tensor, *, chunk: int = 64,
                           out_dtype: torch.dtype | None = None,
                           events: list | None = None):
    """The two kernels of :func:`rwkv6_scan_cuda` as two launches, for
    tests and timing: returns ``(o, states, final)``, ``states`` the
    ``(B, H, S / chunk, dk, dv)`` chunk-start workspace. With ``events``
    (three ``torch.cuda.Event``), records them before the first pass,
    between the passes and after the second. Does not count in
    :data:`LAUNCHES`."""
    out_dtype = _check_cuda(r, k, v, w, u, chunk, out_dtype)
    r, k, v, w = (aligned16(t) for t in (r, k, v, w))
    o, state, ws = _buffers(r, v, chunk, out_dtype)
    stream = torch.cuda.current_stream(r.device)
    for i, entry in enumerate(("rwkv6_states_launch", "rwkv6_output_launch")):
        if events:
            events[i].record(stream)
        _launch(entry, r, k, v, w, u, o, state, ws, chunk)
    if events:
        events[2].record(stream)
    return o, ws, state
