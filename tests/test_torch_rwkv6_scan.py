"""The port's ``rwkv6_scan`` against the reference Pallas kernel.

The reference runs ``r_ops.rwkv6_scan`` (the Pallas kernel in interpret
mode on the CPU) and its oracle ``rwkv6_scan_ref`` (the literal per-step
recurrence); the port runs ``ops.rwkv6_scan`` on CPU tensors, which is its
plain version — the chunked einsum form. Same inputs, made with numpy from
a seed, on both sides, at the reference's sweep shapes
(``tests/test_kernels.py``) and with sequences that need padding. The
tolerance is the reference's own: max error relative to the largest
output below 1e-4 (float32 sums in another order). The final state, which
the port's kernel also returns, and the state at every chunk's start, which
its first pass writes, are held against the literal recurrence's.
The CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6_scan import ops as r_ops
from repro.kernels.rwkv6_scan import ref as r_ref

from repro_torch.kernels.rwkv6_scan import kernel as rk
from repro_torch.kernels.rwkv6_scan import ops
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

SWEEP = [(2, 128, 32, 32, 32), (1, 200, 64, 64, 64), (4, 64, 16, 32, 16),
         (1, 96, 8, 8, 32)]
PADDED = [(2, 100, 16, 16, 32), (3, 70, 64, 64, 64), (1, 5, 8, 8, 64)]


def inputs(seed, bh, s, dk, dv):
    """The reference sweep's inputs: decays in [0.85, 0.999)."""
    rng = np.random.RandomState(seed)
    r = rng.randn(bh, s, dk).astype(np.float32) * 0.5
    k = rng.randn(bh, s, dk).astype(np.float32) * 0.5
    v = rng.randn(bh, s, dv).astype(np.float32)
    w = rng.uniform(0.85, 0.999, (bh, s, dk)).astype(np.float32)
    u = rng.randn(bh, dk).astype(np.float32) * 0.3
    return r, k, v, w, u


def rel_err(got, want) -> float:
    want = np.asarray(want)
    return float(np.max(np.abs(np.asarray(got) - want))
                 / (np.max(np.abs(want)) + 1e-9))


@pytest.mark.parametrize("bh,s,dk,dv,chunk", SWEEP + PADDED)
def test_plain_matches_reference_kernel_and_oracle(bh, s, dk, dv, chunk):
    arrays = inputs(3, bh, s, dk, dv)
    want = r_ops.rwkv6_scan(*(jnp.asarray(a) for a in arrays), chunk=chunk)
    oracle = r_ref.rwkv6_scan_ref(*(jnp.asarray(a) for a in arrays))
    got = ops.rwkv6_scan(*(torch.from_numpy(a) for a in arrays), chunk=chunk)
    assert got.shape == (bh, s, dv) and got.dtype == torch.float32
    assert rel_err(got.numpy(), want) < 1e-4
    assert rel_err(got.numpy(), oracle) < 1e-4
    ours = rwkv6_scan_ref(*(torch.from_numpy(a) for a in arrays))
    assert rel_err(ours.numpy(), oracle) < 1e-4


@pytest.mark.parametrize("bh,s,dk,dv,chunk", SWEEP + PADDED)
def test_final_state_matches_the_recurrence(bh, s, dk, dv, chunk):
    """The state after the last position, as the decode cache needs it:
    padding (w = 1, zero k) leaves it exact."""
    r, k, v, w, u = (torch.from_numpy(a) for a in inputs(4, bh, s, dk, dv))
    want_o, want_s = rwkv6_scan_ref(r, k, v, w, u, return_state=True)
    pad = (-s) % chunk
    if pad:
        r, k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                   for t in (r, k, v))
        w = torch.nn.functional.pad(w, (0, 0, 0, pad), value=1.0)
    o, state = ops.chunked_scan(r[:, :, None], k[:, :, None], v[:, :, None],
                                w[:, :, None], u[:, None], chunk=chunk,
                                return_state=True)
    assert state.shape == (bh, 1, dk, dv) and state.dtype == torch.float32
    assert rel_err(o[:, :s, 0].numpy(), want_o.numpy()) < 1e-4
    assert rel_err(state[:, 0].numpy(), want_s.numpy()) < 1e-4


@pytest.mark.parametrize("bh,s,dk,dv,chunk", SWEEP + PADDED)
def test_chunk_states_match_the_recurrence_over_each_prefix(bh, s, dk, dv,
                                                            chunk):
    """The first pass's state at the start of chunk c equals the literal
    recurrence's final state over the first c·chunk positions (zeros at
    c = 0), and its final state the recurrence's over the whole padded
    sequence; the two passes compose to the scan."""
    r, k, v, w, u = (torch.from_numpy(a) for a in inputs(6, bh, s, dk, dv))
    pad = (-s) % chunk
    if pad:
        r, k, v = (torch.nn.functional.pad(t, (0, 0, 0, pad))
                   for t in (r, k, v))
        w = torch.nn.functional.pad(w, (0, 0, 0, pad), value=1.0)
    r4, k4, v4, w4 = (t[:, :, None] for t in (r, k, v, w))
    states, final = rk.rwkv6_chunk_states_plain(k4, v4, w4, chunk=chunk)
    nc = (s + pad) // chunk
    assert states.shape == (bh, 1, nc, dk, dv)
    assert states.dtype == torch.float32
    assert not states[:, :, 0].any()
    for c in range(1, nc):
        n = c * chunk
        _, want = rwkv6_scan_ref(r[:, :n], k[:, :n], v[:, :n], w[:, :n], u,
                                 return_state=True)
        assert rel_err(states[:, 0, c].numpy(), want.numpy()) < 1e-4
    _, want = rwkv6_scan_ref(r, k, v, w, u, return_state=True)
    assert rel_err(final[:, 0].numpy(), want.numpy()) < 1e-4
    o = rk.rwkv6_chunk_output_plain(r4, k4, v4, w4, u[:, None], states,
                                    chunk=chunk)
    assert torch.equal(o, rk.rwkv6_scan_plain(r4, k4, v4, w4, u[:, None],
                                              chunk=chunk))


def test_model_layout_and_dtypes():
    """The model's layout: (B, S, H, d) projections, one bonus row per head
    broadcast over the batch (stride 0), bfloat16 r/k/v beside float32 w,
    a float32 output; equal to the (BH, S, d) op on the same numbers."""
    b, s, h, d = 2, 64, 3, 16
    rng = np.random.RandomState(5)
    r, k, v = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.85, 0.999, (b, s, h, d))
                         .astype(np.float32))
    u = torch.from_numpy(rng.randn(h, d).astype(np.float32) * 0.3)
    o = ops.chunked_scan(r, k, v, w, u.expand(b, h, d), chunk=32,
                         out_dtype=torch.float32)
    assert o.shape == (b, s, h, d) and o.dtype == torch.float32

    def heads_first(t):
        return t.float().transpose(1, 2).reshape(b * h, s, d)

    want = ops.rwkv6_scan(*(heads_first(t) for t in (r, k, v, w)),
                          u.repeat(b, 1), chunk=32)
    got = o.transpose(1, 2).reshape(b * h, s, d)
    assert rel_err(got.numpy(), want.numpy()) < 1e-6
    low = ops.chunked_scan(r, k, v, w, u.expand(b, h, d), chunk=32)
    assert low.dtype == torch.bfloat16


def test_shape_checks_and_no_fallback():
    r = torch.zeros(1, 16, 2, 8)
    u = torch.zeros(1, 2, 8)
    with pytest.raises(ValueError, match="multiple of chunk"):
        rk.rwkv6_scan_plain(r, r, r, r, u, chunk=6)
    with pytest.raises(ValueError, match="u \\(B, H, dk\\)"):
        rk.rwkv6_scan_plain(r, r, r, r, torch.zeros(2, 8), chunk=8)
    with pytest.raises(ValueError, match="does not match"):
        rk.rwkv6_scan_plain(r, r, torch.zeros(1, 8, 2, 8), r, u, chunk=8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        rk.rwkv6_scan_cuda(r, r, r, r, u, chunk=8)


def test_w_is_float32():
    """w stays float32, since its log-cumsum drifts in bfloat16: the scan
    raises on another dtype, and the op-level wrapper casts it, as the
    reference's kernel computes in float32."""
    r, k, v, w, u = map(torch.from_numpy, inputs(9, 2, 64, 16, 16))
    low = w.to(torch.bfloat16)
    with pytest.raises(ValueError, match="float32 w"):
        rk.rwkv6_scan_plain(*(t[:, :, None] for t in (r, k, v, low)),
                            u[:, None], chunk=32)
    got = ops.rwkv6_scan(r, k, v, low, u, chunk=32)
    want = ops.rwkv6_scan(r, k, v, low.float(), u, chunk=32)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_inputs_off_the_16_byte_grid_are_copied(dtype):
    """The kernels load r, k, v and w 16 bytes at a time: ``aligned16``
    passes an input on that grid through and copies one whose base or
    head stride is off it, with the same values."""
    x = torch.randn(2, 16, 3, 8).to(dtype)
    assert rk.aligned16(x) is x
    shifted = torch.empty(x.numel() + 1, dtype=dtype)[1:].view(x.shape)
    narrow = torch.empty(2, 16, 3, 9, dtype=dtype)[..., :8]
    for t in (shifted, narrow):
        t.copy_(x)
        got = rk.aligned16(t)
        assert got.data_ptr() != t.data_ptr() and got.is_contiguous()
        assert got.data_ptr() % 16 == 0 and torch.equal(got, x)


def _off_grid(x: torch.Tensor) -> torch.Tensor:
    """``x``'s values in a tensor whose base is one element off the
    16-byte grid."""
    t = torch.empty(x.numel() + 1, dtype=x.dtype)[1:].view(x.shape)
    return t.copy_(x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_operands_off_the_16_byte_grid_are_copied(dtype):
    """The backward kernels load r, k, v, w, dO, dState and the
    chunk-start states 16 bytes at a time: ``bwd_operands`` passes each
    operand on that grid through as it is and copies one off it (a
    shifted base, or dO's position stride of 9 floats), with the same
    values; a None dState stays None."""
    b, s, h, dk, dv, nc = 2, 16, 3, 8, 8, 2
    r, k, v = (torch.randn(b, s, h, d).to(dtype) for d in (dk, dk, dv))
    w = torch.rand(b, s, h, dk)
    do = torch.randn(b, s, h, dv)
    dstate = torch.randn(b, h, dk, dv)
    states = torch.randn(b, h, nc, dk, dv)
    ins = (r, k, v, w, do, dstate, states)
    got = rk.bwd_operands(*ins)
    assert all(x is y for x, y in zip(got, ins))
    assert rk.bwd_operands(r, k, v, w, do, None, states)[5] is None
    narrow_do = torch.empty(b, s, h, dv + 1)[..., :dv].copy_(do)
    for off in ([_off_grid(t) for t in ins],
                [r, k, v, w, narrow_do, dstate, states]):
        got = rk.bwd_operands(*off)
        for x, y, want in zip(got, off, ins):
            if y.data_ptr() % 16 == 0 and y.is_contiguous():
                assert x is y
            else:
                assert x.data_ptr() != y.data_ptr() and x.is_contiguous()
                assert x.data_ptr() % 16 == 0
            assert torch.equal(x, want)


# -- the backward -------------------------------------------------------------

def bwd_inputs(seed, bh, s, dk, dv, low):
    """The sweep's inputs with decays drawn from [low, 0.999) and an output
    gradient; ``low = 0.3`` lets a chunk of 64 span the decay range the
    model's prefill reaches."""
    rng = np.random.RandomState(seed)
    r, k, v, _, u = inputs(seed, bh, s, dk, dv)
    w = rng.uniform(low, 0.999, (bh, s, dk)).astype(np.float32)
    do = rng.randn(bh, s, dv).astype(np.float32)
    return r, k, v, w, u, do


def padded_bwd(r, k, v, w, u, do, dstate, chunk):
    """The port's plain backward in the model's layout (one head), on the
    sequence padded as the forward pads it; gradients cut back to S."""
    s = r.shape[1]
    pad = (-s) % chunk
    f = torch.nn.functional.pad
    r, k, v, do = (f(t, (0, 0, 0, pad)) for t in (r, k, v, do))
    w = f(w, (0, 0, 0, pad), value=1.0)
    got = rk.rwkv6_scan_bwd_plain(
        *(t[:, :, None] for t in (r, k, v, w)), u[:, None], do[:, :, None],
        None if dstate is None else dstate[:, None], chunk=chunk)
    return [g[:, :s, 0] for g in got[:4]] + [got[4][:, 0]]


@pytest.mark.parametrize("low", [0.3, 0.85])
@pytest.mark.parametrize("bh,s,dk,dv,chunk", SWEEP + PADDED[:2])
def test_backward_plain_matches_reference_grad(bh, s, dk, dv, chunk, low):
    """``rwkv6_scan_bwd_plain`` (padded as the forward pads) against
    ``jax.grad`` of the reference's literal recurrence ``rwkv6_scan_ref``
    and against autograd of the port's plain scan: each of dr, dk, dv, dw,
    du within 1e-4 of its largest |want| (the reference's scan tolerance:
    float32 sums in another order)."""
    arrays = bwd_inputs(11, bh, s, dk, dv, low)
    *ins, do = arrays

    def loss(*xs):
        return jnp.sum(r_ref.rwkv6_scan_ref(*xs) * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(
        *(jnp.asarray(a) for a in ins))
    got = padded_bwd(*(torch.from_numpy(a) for a in arrays), None, chunk)
    for name, g, wv in zip("rkvwu", got, want):
        assert g.shape == wv.shape, name
        assert rel_err(g.numpy(), wv) < 1e-4, name
    leaves_ = [torch.from_numpy(a).requires_grad_() for a in ins]
    auto = torch.autograd.grad(
        ops.rwkv6_scan(*leaves_, chunk=chunk), leaves_,
        torch.from_numpy(do))
    for name, g, wv in zip("rkvwu", got, auto):
        assert rel_err(g.numpy(), wv.numpy()) < 1e-4, name


@pytest.mark.parametrize("bh,s,dk,dv,chunk", [(2, 128, 32, 32, 32),
                                              (1, 100, 16, 16, 32),
                                              (3, 64, 8, 16, 16),
                                              (1, 70, 64, 64, 64)])
def test_backward_plain_with_a_final_state_gradient(bh, s, dk, dv, chunk):
    """With a nonzero ``dState`` (the final state's gradient, the reverse
    pass's starting value): the plain backward against autograd of the
    plain scan's output and final state, w down to 0.3, within 1e-4."""
    arrays = bwd_inputs(12, bh, s, dk, dv, 0.3)
    *ins, do = (torch.from_numpy(a) for a in arrays)
    dstate = torch.from_numpy(np.random.RandomState(13).randn(
        bh, dk, dv).astype(np.float32))
    got = padded_bwd(*ins, do, dstate, chunk)
    leaves_ = [t.clone().requires_grad_() for t in ins]
    pad = (-s) % chunk
    f = torch.nn.functional.pad
    r, k, v = (f(t, (0, 0, 0, pad)) for t in leaves_[:3])
    w = f(leaves_[3], (0, 0, 0, pad), value=1.0)
    o, state = ops.chunked_scan(r[:, :, None], k[:, :, None], v[:, :, None],
                                w[:, :, None], leaves_[4][:, None],
                                chunk=chunk, return_state=True)
    loss = (o[:, :s, 0] * do).sum() + (state[:, 0] * dstate).sum()
    want = torch.autograd.grad(loss, leaves_)
    for name, g, wv in zip("rkvwu", got, want):
        assert rel_err(g.numpy(), wv.numpy()) < 1e-4, name


def test_backward_passes_compose_in_the_model_layout():
    """The backward's two plain passes in the model's layout ((B, S, H, d),
    bfloat16 r/k/v, a bonus row per head expanded over the batch): the
    reverse pass's end-state gradients equal autograd's gradient of a
    perturbation added to each chunk's end state in the state chain (the
    last chunk's is 0 without a dState), within 1e-5 of the largest; and
    du, summed over the batch as autograd sums an expanded u, equals
    autograd's."""
    b, s, h, d, chunk = 2, 96, 3, 16, 32
    nc = s // chunk
    rng = np.random.RandomState(14)
    r, k, v = (torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    w = torch.from_numpy(rng.uniform(0.3, 0.999, (b, s, h, d))
                         .astype(np.float32))
    u = torch.from_numpy(rng.randn(h, d).astype(np.float32) * 0.3)
    do = torch.from_numpy(rng.randn(b, s, h, d).astype(np.float32))
    ends = rk.rwkv6_chunk_state_grads_plain(r, w, do, chunk=chunk)
    assert ends.shape == (b, h, nc, d, d)
    assert not ends[:, :, -1].any()

    kc, vc = (t.float().reshape(b, nc, chunk, h, d) for t in (k, v))
    cum = torch.cumsum(torch.log(w.reshape(b, nc, chunk, h, d)), 2)
    last = cum[:, :, -1]
    upd = torch.einsum("bclhd,bclhe->bchde",
                       kc * torch.exp(last[:, :, None] - cum), vc)
    inject = torch.zeros((b, h, nc, d, d), requires_grad=True)
    state, starts = torch.zeros((b, h, d, d)), []
    for c in range(nc):
        starts.append(state)
        state = (state * torch.exp(last[:, c])[..., None] + upd[:, c]
                 + inject[:, :, c])
    o = rk.rwkv6_chunk_output_plain(r, k, v, w, u.expand(b, h, d),
                                    torch.stack(starts, 2), chunk=chunk,
                                    out_dtype=torch.float32)
    (want,) = torch.autograd.grad((o * do).sum(), inject)
    assert rel_err(ends.numpy(), want.numpy()) < 1e-5

    leaf = u.clone().requires_grad_()
    out = ops.chunked_scan(r, k, v, w, leaf.expand(b, h, d), chunk=chunk,
                           out_dtype=torch.float32)
    (want_u,) = torch.autograd.grad(out, leaf, do)
    du = rk.rwkv6_scan_bwd_plain(r, k, v, w, u.expand(b, h, d), do,
                                 chunk=chunk)[4]
    assert du.shape == (b, h, d)
    assert rel_err(du.sum(0).numpy(), want_u.numpy()) < 1e-5
