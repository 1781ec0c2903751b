"""State-space mixers: Mamba (Hymba's parallel SSM heads) and RWKV-6.

Both expose a full-sequence path (prefill) and a single-step path
(decode, O(1) state). States are returned explicitly so the serving cache
can carry them.

Mamba has no hand-written kernel in the reference, and none here: its
full-sequence path is plain tensor ops on every device. The reference's
associative scan is transcribed as :func:`associative_scan`, the same
odd/even recursion on strided slices (about 2·log2 L elementwise levels,
O(L) work, the reference's association order), so a captured prefill
holds a few hundred graph nodes a layer rather than one per token. A
fused chunked kernel is later speed work, as the reference's docstring
says.

RWKV-6's full-sequence path runs the chunked scan of
:mod:`repro_torch.kernels.rwkv6_scan`: on a CUDA tensor the hand-written
kernel, on a CPU tensor its plain version. Its decode step is a few plain
tensor ops on the O(1) state, as in the reference.

Inside a card's share of a peer mesh's program whose
:class:`~repro_torch.models.tensor_parallel.DenseCut` cuts a mixer
(``time_mix`` or ``mamba``), the card's tree holds its heads or channels
(:func:`~repro_torch.training.sharding.dense_dim`) and the mixer runs
them: the input whole, through f (with RWKV-6's replicated ``mu``); the
heads' count, and so ``u``'s and the state's rows, from the weights'
columns; Mamba's dt, B and C, which contract over the channels, made
whole by ONE peer psum of the three partials each way (g then f: what
follows is the card's own channels again); the output a
card's partial product, summed by ONE peer psum (g). The group norm is
per head, so it needs no term of another card.

Deliberate difference from the reference: the RWKV-6 scan runs in chunks
of :data:`~repro_torch.kernels.rwkv6_scan.kernel.MAX_CHUNK` (64)
positions on every device instead of 128, since the kernel's
shared-memory tiles hold 64 rows. The chunked form is exact for any chunk
length; only float32 rounding differs. The scan's output stays float32
into the group norm, as the reference's does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.rwkv6_scan.kernel import MAX_CHUNK
from repro_torch.kernels.rwkv6_scan.ops import chunked_scan
from repro_torch.models import tensor_parallel as tp

#: The causal depthwise convolution's width in the Mamba mixer.
CONV_K = 4


# =========================== Mamba (diagonal SSM) ===========================
def mamba_init(d: int, state: int, dtype: torch.dtype, *,
               generator: torch.Generator, device=None,
               lead: tuple = ()) -> dict:
    """One Mamba mixer's parameters (``lead``-stacked), with the
    reference's distributions: the projections normal × ``d**-0.5``
    (``w_dt2`` × ``r**-0.5``, ``r = max(8, d // 64)``), ``conv_w`` normal
    × 0.3, ``conv_b`` zero; ``dt_bias`` −1, ``A_log`` 0 and ``D`` 1 in
    float32."""
    d_i = d
    r = max(8, d // 64)
    s = d ** -0.5

    def normal(shape, scale):
        return torch.randn(lead + shape, generator=generator, device=device,
                           dtype=dtype).mul_(scale)

    def const(shape, value, dt=torch.float32):
        return torch.full(lead + shape, value, dtype=dt, device=device)

    return {
        "w_in": normal((d, 2 * d_i), s),
        "conv_w": normal((CONV_K, d_i), 0.3),
        "conv_b": const((d_i,), 0.0, dtype),
        "w_dt1": normal((d_i, r), s),
        "w_dt2": normal((r, d_i), r ** -0.5),
        "dt_bias": const((d_i,), -1.0),
        "w_B": normal((d_i, state), s),
        "w_C": normal((d_i, state), s),
        "A_log": const((d_i, state), 0.0),
        "D": const((d_i,), 1.0),
        "w_out": normal((d_i, d), s),
    }


def _cut(part: str):
    """The card's cut in force where it cuts the mixer ``part``
    (``"mamba"`` or ``"time_mix"``), else None."""
    cut = tp.in_force()
    return cut if cut is not None and getattr(cut, part) else None


def _mamba_gates(x1: torch.Tensor, p: dict):
    """Shared projections: (dt, B, C) from the conv'd float32 activation;
    the weights are taken in float32, as the reference's mixed product
    promotes them, in ONE product of the three ``(..., r + 2N)``. Under a
    channel cut that product over the card's channels is a partial,
    summed over the cards in ONE peer psum each way."""
    n = p["w_B"].shape[-1]
    w = torch.cat([p["w_dt1"], p["w_B"], p["w_C"]], -1).float()
    whole = x1 @ w
    if _cut("mamba") is not None:
        (whole,) = tp.enter(tp.psum(whole))
    low, bmat, cmat = whole.split([w.shape[-1] - 2 * n, n, n], -1)
    dt = F.softplus(low @ p["w_dt2"].float() + p["dt_bias"])  # (..., d_i)
    return dt, bmat, cmat


def _mamba_drive(x1: torch.Tensor, p: dict):
    """The recurrence's decay ``a`` and input ``dt·x·B`` ``(..., d_i, N)``
    (float32), and ``C`` and the float32 activation."""
    x1f = x1.float()
    dt, bmat, cmat = _mamba_gates(x1f, p)
    a = torch.exp(-torch.exp(p["A_log"]) * dt[..., None])
    drive = (dt * x1f)[..., None] * bmat[..., None, :]
    return a, drive, cmat, x1f


def _mamba_out(y, x1f, z, p, x_dtype):
    """The skip, the gate and the output projection; under a channel cut
    the card's rows of ``w_out``, summed over the cards by ONE peer psum
    (g)."""
    y = y + p["D"] * x1f
    out = (y.to(x_dtype) * F.silu(z)) @ p["w_out"]
    return out if _cut("mamba") is None else tp.psum(out)


def associative_scan(a: torch.Tensor, b: torch.Tensor, *,
                     need_a: bool = False):
    """Prefix of the linear recurrence ``h_t = a_t·h_{t-1} + b_t`` along
    dim 1, as the reference's associative scan computes it with the
    combine ``(a1, b1), (a2, b2) → (a1·a2, b1·a2 + b2)``: pairs of
    neighbours are combined, the half-length sequence is scanned
    recursively (the odd positions' prefixes), and each even position
    combines its left neighbour's prefix with itself. Returns ``h`` (and
    the cumulative ``a`` with ``need_a``, which every level but the top
    one needs)."""
    n = a.shape[1]
    if n < 2:
        return (a, b) if need_a else b
    a0, a1 = a[:, 0:n - 1:2], a[:, 1::2]
    ra, rb = associative_scan(a0 * a1, b[:, 0:n - 1:2] * a1 + b[:, 1::2],
                              need_a=True)
    left_a, left_b = (ra, rb) if n % 2 else (ra[:, :-1], rb[:, :-1])
    a2 = a[:, 2::2]
    hb = torch.empty_like(b)
    hb[:, :1] = b[:, :1]
    hb[:, 2::2] = left_b * a2 + b[:, 2::2]
    hb[:, 1::2] = rb
    if not need_a:
        return hb
    ha = torch.empty_like(a)
    ha[:, :1] = a[:, :1]
    ha[:, 2::2] = left_a * a2
    ha[:, 1::2] = ra
    return ha, hb


def mamba_apply(x: torch.Tensor, p: dict, return_state: bool = False):
    """Full-sequence Mamba mixer. x: (B, L, d) → (B, L, d).

    With ``return_state`` also returns ``(ssm_state, conv_state)`` for
    prefill-into-cache: the float32 ``(B, d_i, N)`` state after the last
    position and the last ``CONV_K − 1`` raw conv inputs ``(B, K−1,
    d_i)`` (zero where the sequence is shorter)."""
    if _cut("mamba") is not None:
        (x,) = tp.enter(x)
    _, l, _ = x.shape
    x1_raw, z = torch.chunk(x @ p["w_in"], 2, dim=-1)
    # causal depthwise conv, kernel CONV_K
    xp = F.pad(x1_raw, (0, 0, CONV_K - 1, 0))
    x1 = sum(xp[:, i:i + l] * p["conv_w"][i] for i in range(CONV_K))
    x1 = F.silu(x1 + p["conv_b"])

    a, drive, cmat, x1f = _mamba_drive(x1, p)
    h = associative_scan(a, drive)                           # (B,L,d_i,N)
    del a, drive
    y = torch.einsum("blds,bls->bld", h, cmat)
    out = _mamba_out(y, x1f, z, p, x.dtype)
    if not return_state:
        return out
    return out, (h[:, -1], xp[:, l:l + CONV_K - 1])


def mamba_decode(x: torch.Tensor, p: dict, state: torch.Tensor,
                 conv_state: torch.Tensor,
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One step. x: (B, d); state: (B, d_i, N); conv_state: (B, K-1, d_i).
    Returns (out, new state, new conv state), new tensors (the inputs are
    not written, so a caller may ``copy_`` the new states over them)."""
    x1, z = torch.chunk(x @ p["w_in"], 2, dim=-1)
    hist = torch.cat([conv_state, x1[:, None]], dim=1)       # (B, K, d_i)
    x1 = sum(hist[:, i] * p["conv_w"][i] for i in range(CONV_K))
    x1 = F.silu(x1 + p["conv_b"])

    a, drive, cmat, x1f = _mamba_drive(x1, p)
    state = state * a + drive
    y = torch.einsum("bds,bs->bd", state, cmat)
    return _mamba_out(y, x1f, z, p, x.dtype), state, hist[:, 1:]


# ================================ RWKV-6 ====================================

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
    h = p["w_r"].shape[-1] // head_dim          # the card's heads
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
    out = (of.to(x_dtype) * F.silu(g)) @ p["w_out"]
    return out if _cut("time_mix") is None else tp.psum(out)


def rwkv6_apply(x: torch.Tensor, p: dict, *, head_dim: int,
                return_state: bool = False):
    """Full-sequence RWKV-6 time-mix. x: (B, L, d) → (B, L, d).

    With ``return_state`` also returns ``(wkv_state, shift_state)``:
    the float32 ``(B, h, dk, dv)`` state after the last position and
    ``x[:, -1]``. Padding carries identity decay (w=1) and zero k, so
    the final state is exact regardless of padding.
    """
    if _cut("time_mix") is not None:
        # f on what the card's heads read: x and the replicated mu
        x, mu = tp.enter(x, p["mu"])
        p = {**p, "mu": mu}
    b, l, _ = x.shape
    h = p["w_r"].shape[-1] // head_dim          # the card's heads
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
