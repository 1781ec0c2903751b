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

The backward (no Pallas site: the reference differentiates its model's
chunk math, ``src/repro/models/ssm.py:158-212``) takes the forward's
chunk-start states and runs in the same two-pass form
(:func:`rwkv6_scan_bwd_plain`, :func:`rwkv6_scan_bwd_cuda`): a reverse
chunk-serial pass gives the gradient of every chunk's end state
(``G ← diag(exp(c_L)) G + q̃ᵀ dO``, from ``dState`` or zeros), then every
chunk at once gives dr, dk, dv, the bonus's du and the log-decay gradient,
``dw = d(log w) / w``, where ``d(log w)`` is the reverse within-chunk
cumsum of the ``exp(±c)`` factors' gradients (``r·dr`` and ``−k·dk`` of
the decayed paths) plus the chunk's state-decay term. Kernel source
``csrc/rwkv6_scan_bwd.cu``; :data:`LAUNCHES_BWD` counts calls of
:func:`rwkv6_scan_bwd_cuda`. A meta tensor, which a cost count
(:mod:`repro_torch.launch.cost`) passes, takes the CUDA wrappers' checks
and gets empty outputs, launching nothing; on both the wrappers report
the kernels' formula to the counter.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.launch import cost

#: dk and dv the kernel is built for.
DIMS = (8, 16, 32, 64)
#: The longest chunk the output pass's shared-memory tiles hold: at 64
#: rows the r, k-then-start-state, w-then-scores and v tiles take 68.3
#: KiB, so three blocks fit on an SM.
MAX_CHUNK = 64

#: Calls of :func:`rwkv6_scan_fwd_cuda` (and so of :func:`rwkv6_scan_cuda`)
#: so far; each launches two kernels, the chunk-start states and then the
#: outputs.
LAUNCHES = 0
#: Calls of :func:`rwkv6_scan_bwd_cuda` so far; each launches three
#: kernels, the end-state gradients, the chunks' gradients and the sum of
#: du over the chunks.
LAUNCHES_BWD = 0

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


def _decays(w: torch.Tensor, chunk: int):
    """The per-channel log-decay cumsums of every chunk, float32: the
    inclusive ``c`` and exclusive ``e = c − log w`` ``(B, nc, L, H, dk)``
    and the chunk's total ``c_L`` ``(B, nc, H, dk)``."""
    logw = torch.log(_chunks(w, chunk))
    cum = torch.cumsum(logw, dim=2)
    return cum, cum - logw, cum[:, :, -1]


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
    cum, _, last = _decays(w, chunk)
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
    cum, exc, _ = _decays(w, chunk)
    qt = rc * torch.exp(exc)
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


def rwkv6_chunk_state_grads_plain(r: torch.Tensor, w: torch.Tensor,
                                  do: torch.Tensor,
                                  dstate: torch.Tensor | None = None, *,
                                  chunk: int = 64) -> torch.Tensor:
    """The backward's reverse pass, plain: the float32 gradient of every
    chunk's end state, ``(B, H, S / chunk, dk, dv)``: the last chunk's is
    ``dstate`` (zeros if None), and the one before chunk c's is ``diag(
    exp(c_L)) G_c + q̃_cᵀ dO_c``. The ``q̃ᵀ dO`` products are formed for
    all chunks at once; only their composition loops."""
    check_shapes(r, r, do, w, None, chunk)
    b, s, h, dk = r.shape
    dv = do.shape[-1]
    _, exc, last = _decays(w, chunk)
    upd = torch.einsum("bclhd,bclhe->bchde", _chunks(r, chunk) * torch.exp(
        exc), _chunks(do, chunk))
    decay = torch.exp(last)
    g = (torch.zeros((b, h, dk, dv), dtype=torch.float32, device=r.device)
         if dstate is None else dstate.float())
    ends = []
    for c in reversed(range(s // chunk)):
        ends.append(g)
        g = g * decay[:, c, :, :, None] + upd[:, c]
    if not ends:
        return g.new_zeros((b, h, 0, dk, dv))
    return torch.stack(ends[::-1], 2)


def _rev_cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``Σ_{j' ≥ j} x_{j'}`` along ``dim``."""
    return torch.flip(torch.cumsum(torch.flip(x, (dim,)), dim), (dim,))


def rwkv6_chunk_grads_plain(r, k, v, w, u, do, states, ends, *,
                            chunk: int = 64):
    """The backward's chunk-parallel pass, plain: from every chunk's start
    state ``states`` and end-state gradient ``ends`` (both ``(B, H, nc,
    dk, dv)``), all chunks at once, float32 math. With ``A`` the forward's
    strictly causal ``q̃ k̃ᵀ`` plus the bonus on its diagonal and ``k̂ =
    k·exp(c_L − c)``: ``dq̃ = dA k̃ + dO Sᵀ``, ``dk̃ = dAᵀ q̃``, ``dk̂ = V
    Gᵀ``, ``dV = Aᵀ dO + k̂ G``; dr and dk undo the decays, and the
    log-decay gradient is the reverse cumsum of ``r·dr`` (over later
    rows, through ``q̃``) less that of ``k·dk`` (from the row on, through
    ``k̃`` and ``k̂``) plus ``c_L``'s gradient. Returns ``(dr, dk, dv, dw,
    du)``: dr, dk, dv in r's dtype, dw float32 like w, du float32 ``(B,
    H, dk)``."""
    check_shapes(r, k, v, w, u, chunk)
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    rc, kc, vc, dc = (_chunks(t, chunk) for t in (r, k, v, do))
    cum, exc, last = _decays(w, chunk)
    qt = rc * torch.exp(exc)
    kt = kc * torch.exp(-cum)
    kh = kc * torch.exp(last[:, :, None] - cum)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    uf = u.float()[:, None, None]                       # (B, 1, 1, H, dk)
    a = torch.where(mask, torch.einsum("bclhd,bcmhd->bchlm", qt, kt), 0.0)
    bonus = (rc * uf * kc).sum(-1)                      # (B, nc, L, H)
    da = torch.where(mask, torch.einsum("bclhe,bcmhe->bchlm", dc, vc), 0.0)
    dbon = (dc * vc).sum(-1)                            # (B, nc, L, H)
    sf, gf = states.float(), ends.float()
    dqt = (torch.einsum("bchlm,bcmhd->bclhd", da, kt)
           + torch.einsum("bclhe,bhcde->bclhd", dc, sf))
    dkt = torch.einsum("bchlm,bclhd->bcmhd", da, qt)
    dkh = torch.einsum("bclhe,bhcde->bclhd", vc, gf)
    dvv = (torch.einsum("bchlm,bclhe->bcmhe", a, dc)
           + bonus[..., None] * dc
           + torch.einsum("bclhd,bhcde->bclhe", kh, gf))
    dr = dqt * torch.exp(exc) + dbon[..., None] * uf * kc
    dkk = (dkt * torch.exp(-cum) + dkh * torch.exp(last[:, :, None] - cum)
           + dbon[..., None] * uf * rc)
    du = (dbon[..., None] * rc * kc).sum((1, 2))        # (B, H, dk)
    de = dqt * qt
    dcum = -(dkt * kt + dkh * kh)
    dlast = (dkh * kh).sum(2) + torch.exp(last) * torch.einsum(
        "bhcde,bhcde->bchd", gf, sf)
    dlogw = (_rev_cumsum(de, 2) - de + _rev_cumsum(dcum, 2)
             + dlast[:, :, None])
    dw = dlogw / _chunks(w, chunk)

    def back(t, d, dtype):
        return t.reshape(b, s, h, d).to(dtype)

    return (back(dr, dk, r.dtype), back(dkk, dk, k.dtype),
            back(dvv, dv, v.dtype), back(dw, dk, torch.float32), du)


def rwkv6_scan_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         w: torch.Tensor, u: torch.Tensor, do: torch.Tensor,
                         dstate: torch.Tensor | None = None, *,
                         chunk: int = 64,
                         states: torch.Tensor | None = None):
    """Plain PyTorch version of the backward: explicit einsums in the
    kernel's two-pass form. ``do`` is the output's gradient ``(B, S, H,
    dv)``, ``dstate`` the final state's ``(B, H, dk, dv)`` (None: zeros),
    ``states`` the forward's chunk-start states (None: recomputed).
    Returns ``(dr, dk, dv, dw, du)`` as :func:`rwkv6_chunk_grads_plain`:
    the gradients of :func:`rwkv6_scan_plain`'s output and final state."""
    if states is None:
        states, _ = rwkv6_chunk_states_plain(k, v, w, chunk=chunk)
    ends = rwkv6_chunk_state_grads_plain(r, w, do, dstate, chunk=chunk)
    return rwkv6_chunk_grads_plain(r, k, v, w, u, do, states, ends,
                                   chunk=chunk)


def _check_cuda(r, k, v, w, u, chunk, out_dtype) -> torch.dtype:
    """Raise ``ValueError`` on anything the kernels do not take; returns
    the output dtype."""
    check_shapes(r, k, v, w, u, chunk)
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("u", u)):
        if t.device.type not in ("cuda", "meta") or t.device != r.device:
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
    base = (t.storage_offset() * t.element_size() if t.device.type == "meta"
            else t.data_ptr())
    if base % 16 == 0 and all(
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
    with torch.cuda.device(r.device):       # the stream's own card
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), o.data_ptr(), state.data_ptr(), ws.data_ptr(),
                *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *w.stride()[:3], *o.stride()[:3], *u.stride()[:2],
                b, h, s, dk, v.shape[-1], chunk, _DTYPE_CODES[r.dtype],
                _DTYPE_CODES[o.dtype],
                torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(rc, f"rwkv6_scan ({entry})")


def rwkv6_scan_fwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor, *, chunk: int = 64,
                        out_dtype: torch.dtype | None = None):
    """Launch the two kernels on CUDA tensors, in order on the current
    stream with no host sync between them. r, k, v float32 or bfloat16 of
    one dtype; w and u float32; dk and dv in :data:`DIMS`; ``chunk`` at
    most :data:`MAX_CHUNK`; ``out_dtype`` float32 or bfloat16. Returns
    ``(o, state, states)``: the output, the final state and the ``(B, H,
    S / chunk, dk, dv)`` chunk-start workspace the backward kernel starts
    from; anything else raises. Meta tensors get the same checks and
    empty outputs, and launch nothing; both report the kernels' formula
    to the cost counter (:func:`~repro_torch.launch.cost.record_kernel`)."""
    global LAUNCHES
    out_dtype = _check_cuda(r, k, v, w, u, chunk, out_dtype)
    r, k, v, w = (aligned16(t) for t in (r, k, v, w))
    o, state, ws = _buffers(r, v, chunk, out_dtype)
    if r.device.type == "cuda":
        _launch("rwkv6_scan_launch", r, k, v, w, u, o, state, ws, chunk)
        LAUNCHES += 1
    b, s, h, dk = r.shape
    cost.record_kernel("rwkv6_scan",
                       cost.rwkv6_scan_flops(b, s, h, dk, v.shape[-1]),
                       (r, k, v, w, u), (o, state, ws))
    return o, state, ws


def rwkv6_scan_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    w: torch.Tensor, u: torch.Tensor, *, chunk: int = 64,
                    out_dtype: torch.dtype | None = None,
                    return_state: bool = False):
    """:func:`rwkv6_scan_fwd_cuda` returning ``o``, and the final state
    with ``return_state``."""
    o, state, _ = rwkv6_scan_fwd_cuda(r, k, v, w, u, chunk=chunk,
                                      out_dtype=out_dtype)
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


def _check_bwd(r, k, v, w, u, do, dstate, states, chunk) -> None:
    """Raise ``ValueError`` on anything the backward kernels do not take
    (beyond the forward's checks)."""
    _check_cuda(r, k, v, w, u, chunk, None)
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    if tuple(do.shape) != (b, s, h, dv) or do.dtype != torch.float32 \
            or do.device != r.device or do.stride(-1) != 1:
        raise ValueError(f"rwkv6_scan backward needs a float32 dO "
                         f"{(b, s, h, dv)} on {r.device} with a contiguous "
                         f"last "
                         f"dim, got {tuple(do.shape)} {do.dtype} on "
                         f"{do.device}, strides {do.stride()}")
    want = (b, h, s // chunk, dk, dv)
    if (tuple(states.shape) != want or states.dtype != torch.float32
            or states.device != r.device or not states.is_contiguous()):
        raise ValueError(f"rwkv6_scan backward needs the forward's "
                         f"contiguous float32 states {want}, got "
                         f"{tuple(states.shape)} {states.dtype}")
    if dstate is not None and (tuple(dstate.shape) != (b, h, dk, dv)
                               or dstate.dtype != torch.float32
                               or dstate.device != r.device
                               or not dstate.is_contiguous()):
        raise ValueError(f"rwkv6_scan backward needs a contiguous float32 "
                         f"dState {(b, h, dk, dv)}, got "
                         f"{tuple(dstate.shape)} {dstate.dtype}")


def bwd_operands(r, k, v, w, do, dstate, states):
    """The backward kernels' tensor operands on the 16-byte grid their
    loads need: each of r, k, v, w, ``do``, ``dstate`` (None stays None)
    and ``states`` through :func:`aligned16`, so an operand off the grid
    is copied and one on it passes through as it is."""
    return (*(aligned16(t) for t in (r, k, v, w, do)),
            None if dstate is None else aligned16(dstate), aligned16(states))


def _bwd_buffers(r, v, chunk):
    """dr, dk, dv in r's dtype, dw, the end-state gradients, du's
    per-chunk terms and du."""
    b, s, h, dk = r.shape
    dv = v.shape[-1]
    nc = s // chunk

    def new(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device=r.device)

    return (new(b, s, h, dk, dtype=r.dtype), new(b, s, h, dk, dtype=r.dtype),
            new(b, s, h, dv, dtype=r.dtype), new(b, s, h, dk),
            new(b, h, nc, dk, dv), new(b, h, nc, dk), new(b, h, dk))


def _launch_bwd(r, k, v, w, u, do, dstate, states, bufs, chunk) -> None:
    """One call of the backward library's entry point (its three passes)
    on the current stream; raises on a CUDA error."""
    fn = _build.load("rwkv6_scan_bwd").rwkv6_scan_bwd_launch
    fn.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int64] * 20
                   + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    dr, dk, dv, dw, gws, dupart, du = bufs
    b, s, h, ndk = r.shape
    with torch.cuda.device(r.device):       # the stream's own card
        rc = fn(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                u.data_ptr(), do.data_ptr(),
                None if dstate is None else dstate.data_ptr(),
                states.data_ptr(), gws.data_ptr(), dr.data_ptr(),
                dk.data_ptr(), dv.data_ptr(), dw.data_ptr(),
                dupart.data_ptr(), du.data_ptr(),
                *r.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                *w.stride()[:3], *do.stride()[:3], *u.stride()[:2],
                b, h, s, ndk, v.shape[-1], chunk, _DTYPE_CODES[r.dtype],
                torch.cuda.current_stream(r.device).cuda_stream)
    _build.check(rc, "rwkv6_scan_bwd")


def rwkv6_scan_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        w: torch.Tensor, u: torch.Tensor, do: torch.Tensor,
                        dstate: torch.Tensor | None = None, *,
                        states: torch.Tensor, chunk: int = 64):
    """Launch the backward's three kernels on CUDA tensors, in order on the
    current stream, no host sync and no allocation but through the
    caching allocator (so a CUDA graph can capture it). r, k, v, w, u as
    :func:`rwkv6_scan_cuda` takes them; ``do`` the float32 output
    gradient ``(B, S, H, dv)`` with a contiguous last dim; ``dstate`` a
    contiguous float32 ``(B, H, dk, dv)`` or None (zeros); ``states`` the
    forward's chunk-start workspace (:func:`rwkv6_scan_fwd_cuda`). The
    kernels load 16 bytes at a time, so an operand off that grid is
    copied first (:func:`bwd_operands`). Returns
    ``(dr, dk, dv, dw, du)`` as :func:`rwkv6_scan_bwd_plain` does;
    anything else raises. Meta tensors as :func:`rwkv6_scan_fwd_cuda`
    takes them."""
    global LAUNCHES_BWD
    _check_bwd(r, k, v, w, u, do, dstate, states, chunk)
    r, k, v, w, do, dstate, states = bwd_operands(r, k, v, w, do, dstate,
                                                  states)
    bufs = _bwd_buffers(r, v, chunk)
    if r.device.type == "cuda":
        _launch_bwd(r, k, v, w, u, do, dstate, states, bufs, chunk)
        LAUNCHES_BWD += 1
    b, s, h, ndk = r.shape
    cost.record_kernel("rwkv6_scan_bwd",
                       cost.rwkv6_scan_bwd_flops(b, s, h, ndk, v.shape[-1]),
                       (r, k, v, w, u, do, dstate, states), bufs)
    dr, dk, dv, dw, _, _, du = bufs
    return dr, dk, dv, dw, du
