"""The port's ``flash_attention`` against the reference Pallas kernel.

The reference runs ``fa_ops.flash_attention`` (the Pallas kernel in
interpret mode on the CPU) and its oracle ``attention_ref``; the port
runs ``flash_attention`` on CPU tensors, which is its plain version —
the materialised attention with a float32 softmax. Same inputs, made with
numpy from a seed, on both sides. Tolerances are the reference's own
(``tests/test_kernels.py``): float32 atol 3e-5 / rtol 1e-4 (sums in
another order), bfloat16 max abs 2e-2 (one rounding of the output). The
CUDA kernel itself runs only on the card (``tests/test_torch_cuda.py``).

The backward's tensor-core kernel rounds P and dS to bfloat16 before the
products that take them; an emulation of that arithmetic, written here,
is held to ``jax.vjp`` of the reference's ``blockwise_attention`` within
the kernel's bound on the card (2e-2 of the largest |want|).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import StepCapture as JStepCapture
from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention import ref as jref
from repro.models import layers as jl

from repro_torch.carry import tensor_from_numpy
from repro_torch.comm import StepCapture
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention import ops
from repro_torch.kernels.flash_attention.ref import (attention_mask,
                                                     attention_ref)

SWEEP = [(1, 4, 2, 256, 64), (2, 4, 4, 128, 32), (1, 8, 2, 200, 64),
         (1, 2, 1, 384, 128)]
MASKS = [(True, None), (True, 64), (False, None)]


def inputs(seed, b, hq, hkv, s, d):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, hq, s, d).astype(np.float32) * 0.3
    k = rng.randn(b, hkv, s, d).astype(np.float32) * 0.3
    v = rng.randn(b, hkv, s, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("b,hq,hkv,s,d", SWEEP)
@pytest.mark.parametrize("causal,window", MASKS)
def test_plain_matches_reference_kernel_and_oracle(b, hq, hkv, s, d, causal,
                                                   window):
    q, k, v = inputs(0, b, hq, hkv, s, d)
    want = np.asarray(jops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))
    oracle = np.asarray(jref.attention_ref(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        window=window))
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.shape == (b, hq, s, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), oracle, atol=3e-5, rtol=1e-4)
    ours = attention_ref(tq, tk, tv, causal=causal, window=window)
    np.testing.assert_allclose(ours.numpy(), oracle, atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("causal,window", MASKS)
def test_bf16_matches_reference(causal, window):
    q, k, v = inputs(1, 1, 4, 2, 128, 64)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    want = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal,
                                           window=window), np.float32)
    oracle = np.asarray(jref.attention_ref(jq, jk, jv, causal=causal,
                                           window=window), np.float32)
    tq, tk, tv = (tensor_from_numpy(np.asarray(a)) for a in (jq, jk, jv))
    assert tq.dtype == torch.bfloat16
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert np.max(np.abs(got - want)) < 2e-2
    assert np.max(np.abs(got - oracle)) < 2e-2


def test_strided_layout_equals_contiguous():
    """The model hands the kernel q/k/v as transposes of (B, S, H, D):
    strided over heads and positions, contiguous over D."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(rng.randn(2, 96, 4, 32).astype(np.float32))
    kv = torch.from_numpy(rng.randn(2, 96, 2, 32).astype(np.float32))
    q, k = x.transpose(1, 2), kv.transpose(1, 2)
    assert not q.is_contiguous()
    got = ops.flash_attention(q, k, k, window=40)
    want = ops.flash_attention(q.contiguous(), k.contiguous(),
                               k.contiguous(), window=40)
    assert torch.equal(got, want)


@pytest.mark.parametrize("s", [1, 63, 64, 65, 200, 384])
@pytest.mark.parametrize("causal,window", MASKS + [(False, 64), (True, 1),
                                                   (True, 130)])
def test_plain_matches_reference_kernel_at_ragged_lengths(s, causal, window):
    """Lengths on either side of the reference kernel's 64-wide tiles and
    windows narrower and wider than a tile: the port's plain version
    against the Pallas kernel and its oracle."""
    q, k, v = inputs(3, 1, 2, 1, s, 32)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal,
                                           window=window))
    oracle = np.asarray(jref.attention_ref(jq, jk, jv, causal=causal,
                                           window=window))
    got = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal, window=window).numpy()
    np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)
    np.testing.assert_allclose(got, oracle, atol=3e-5, rtol=1e-4)


def test_attention_flops_equal():
    for q_shape, k_shape in [((1, 2, 8, 8), (1, 2, 8, 8)),
                             ((4, 32, 512, 128), (4, 8, 512, 128))]:
        assert ops.attention_flops(q_shape, k_shape) == \
            jops.attention_flops(q_shape, k_shape)


def _kernel_op(cap, name):
    (rec,) = [op for op in cap.ops if op[0] == "kernel" and op[1] == name]
    return rec[2], rec[3], rec[4], rec[5]


def test_captured_flash_attention_records_like_reference():
    """The adopter's node: FLOPs from ``attention_flops``, q's spec as the
    output, ``cost_ns`` 0 without a recorder — the recording's signature
    equals the reference's."""
    cap, jcap = StepCapture(), JStepCapture()
    q = cap.input((1, 2, 8, 8), torch.float32)
    k = cap.input((1, 2, 8, 8), torch.float32)
    v = cap.input((1, 2, 8, 8), torch.float32)
    jq = jcap.input((1, 2, 8, 8), jnp.float32)
    jk = jcap.input((1, 2, 8, 8), jnp.float32)
    jv = jcap.input((1, 2, 8, 8), jnp.float32)
    out = ops.captured_flash_attention(cap, q, k, v)
    jops.captured_flash_attention(jcap, jq, jk, jv)
    _, _, flops, cost_ns = _kernel_op(cap, "flash_attention")
    assert flops == jops.attention_flops((1, 2, 8, 8), (1, 2, 8, 8))
    assert cost_ns == 0
    assert cap.buffers[out.buf_id].shape == (1, 2, 8, 8)
    assert cap.signature() == jcap.signature()


def test_captured_kernel_folds_the_device_axis():
    """The recorded function folds ``(n, B, H, S, D)`` into
    ``(n·B, H, S, D)``: each device's attention is its own."""
    cap = StepCapture(3)
    q = cap.input((2, 4, 16, 16), torch.float32)
    k = cap.input((2, 2, 16, 16), torch.float32)
    ops.captured_flash_attention(cap, q, k, k, window=5)
    fn = cap.kernels["flash_attention"]
    rng = np.random.RandomState(3)
    qs = torch.from_numpy(rng.randn(3, 2, 4, 16, 16).astype(np.float32))
    ks = torch.from_numpy(rng.randn(3, 2, 2, 16, 16).astype(np.float32))
    got = fn(qs, ks, ks)
    for d in range(3):
        assert torch.equal(got[d], ops.flash_attention(qs[d], ks[d], ks[d],
                                                       window=5))


def test_other_devices_raise_instead_of_running_plain():
    """A device other than the card, the CPU and meta raises; a meta
    tensor (a cost count's) takes the card's branch and launches
    nothing; a CPU tensor into the kernel's wrapper raises."""
    other = types.SimpleNamespace(device=torch.device("xla", 0))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.flash_attention(other, other, other)
    q = torch.empty((1, 2, 8, 16), device="meta")
    launches = fk.LAUNCHES
    out = ops.flash_attention(q, q, q)
    assert out.device.type == "meta" and out.shape == q.shape
    assert fk.LAUNCHES == launches
    cpu = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_attention_cuda(cpu, cpu, cpu)


@pytest.mark.parametrize("bad", ["heads", "shape", "window"])
def test_bad_inputs_raise(bad):
    q = torch.zeros((1, 4, 8, 16))
    k = torch.zeros((1, 3 if bad == "heads" else 2, 8, 16))
    v = torch.zeros((1, 2, 9, 16)) if bad == "shape" else k
    with pytest.raises(ValueError):
        ops.flash_attention(q, k, v, window=0 if bad == "window" else None)


def _bf16(*shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


@pytest.mark.parametrize("name,make", [
    ("contiguous", lambda: _bf16(2, 4, 64, 64)),
    ("heads-inner layout", lambda: _bf16(2, 64, 4, 32).transpose(1, 2)),
    ("batch broadcast", lambda: _bf16(1, 4, 64, 64).expand(3, -1, -1, -1)),
    ("odd stride on a dim of extent 1",
     lambda: _bf16(64 * 16 + 3).as_strided((1, 1, 64, 16), (3, 5, 16, 1))),
])
def test_tma_alignment_accepts(name, make):
    fk.check_tma_alignment("q", make())


@pytest.mark.parametrize("name,make,match", [
    ("base off by one element",
     lambda: _bf16(2 * 64 * 64 + 1)[1:].view(1, 2, 64, 64), "16-byte aligned"),
    ("position stride 68", lambda: _bf16(1, 2, 64, 68)[..., :64],
     "multiples of 8"),
    ("head stride 4 values off", lambda: _bf16(1, 2, 64 * 64 + 4)[
        ..., :64 * 64].view(1, 2, 64, 64), "multiples of 8"),
])
def test_tma_alignment_rejects(name, make, match):
    with pytest.raises(ValueError, match=match):
        fk.check_tma_alignment("q", make())


def test_tile_products_need_cuda_tensors():
    t = _bf16(64, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fk.tile_products_cuda(t, t, t, t)


def test_bwd_tile_products_need_cuda_tensors():
    t = _bf16(64, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fk.bwd_tile_products_cuda(t, t, t)


def test_backward_rejects_cpu_tensors():
    t = torch.zeros((1, 2, 64, 16), dtype=torch.bfloat16)
    lse = torch.zeros((1, 2, 64))
    with pytest.raises(ValueError, match="CUDA"):
        fk.flash_attention_bwd_cuda(t, t, t, t, lse, t)


@pytest.mark.parametrize("name,make,copied", [
    ("contiguous bf16", lambda: _bf16(2, 4, 64, 64), False),
    ("heads-inner bf16 view", lambda: _bf16(2, 64, 4, 32).transpose(1, 2),
     False),
    ("bf16 base off by one element",
     lambda: _bf16(2 * 64 * 64 + 1)[1:].view(1, 2, 64, 64), True),
    ("bf16 position stride 68", lambda: _bf16(1, 2, 64, 68)[..., :64], True),
    ("bf16 strided head dim", lambda: _bf16(1, 2, 16, 64).transpose(2, 3),
     True),
    ("float32 base off by one element",
     lambda: torch.zeros(2 * 64 * 64 + 1)[1:].view(1, 2, 64, 64), False),
    ("float32 strided head dim",
     lambda: torch.zeros(1, 2, 16, 64).transpose(2, 3), True),
])
def test_backward_operand_copies_what_the_kernel_cannot_load(name, make,
                                                             copied):
    """``FlashAttentionFn.backward`` hands the kernel ``backward_operand(dO)``:
    dO itself where the kernel loads it as it lies, else a contiguous copy
    with the same values, which bfloat16's TMA alignment then accepts."""
    do = make()
    do.copy_(torch.arange(do.numel()).reshape(do.shape).to(do.dtype))
    got = ops.backward_operand(do)
    assert (got is not do) == copied
    assert torch.equal(got, do)
    assert got.stride(-1) == 1
    if do.dtype == torch.bfloat16:
        fk.check_tma_alignment("do", got)


def _bf16_values(a: np.ndarray) -> torch.Tensor:
    """float32 holding ``a`` rounded to bfloat16, as the kernel reads it."""
    return torch.from_numpy(a).to(torch.bfloat16).float()


def _kernel_rounding_backward(q, k, v, o, lse, do, *, causal, window,
                              scale):
    """The tensor-core backward's arithmetic on float32 tensors that hold
    bfloat16 values: S, dP, lse, D and the exp in float32, P and dS rounded
    to bfloat16 before the products that take them as A (P·dO, dS·Q,
    dS·K), float32 sums, outputs rounded to bfloat16."""
    def bf16(x):
        return x.to(torch.bfloat16).float()
    qpk = q.shape[1] // k.shape[1]
    kk = k.repeat_interleave(qpk, dim=1)
    vv = v.repeat_interleave(qpk, dim=1)
    log2e = 1.4426950408889634
    mask = attention_mask(q.shape[2], causal, window)
    s = torch.einsum("bhqd,bhkd->bhqk", q, kk)
    p = torch.exp2(s * (scale * log2e) - (lse * log2e)[..., None])
    p = torch.where(mask, p, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", do, vv)
    delta = (do * o).sum(-1, keepdim=True)
    ds = p * (dp - delta)
    pb, dsb = bf16(p), bf16(ds)
    dv = torch.einsum("bhqk,bhqd->bhkd", pb, do)
    dk = torch.einsum("bhqk,bhqd->bhkd", dsb, q) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", dsb, kk) * scale
    b, hkv, sl, d = k.shape
    dk = dk.reshape(b, hkv, qpk, sl, d).sum(2)
    dv = dv.reshape(b, hkv, qpk, sl, d).sum(2)
    return bf16(dq), bf16(dk), bf16(dv)


def test_kernel_rounding_within_bound_of_reference_grads():
    """At path J's heads and length, (2, 15/5, 512, 64) causal: the
    backward with the kernel's bfloat16 rounding of P and dS stays within
    2e-2 of the largest |want| of ``jax.vjp`` of the reference's
    ``blockwise_attention`` (float32, on the same bfloat16 values), the
    bound the card holds the kernel to."""
    b, hq, hkv, s, d = 2, 15, 5, 512, 64
    rng = np.random.RandomState(22)
    q, k = (_bf16_values(rng.randn(b, h, s, d).astype(np.float32) * 0.5)
            for h in (hq, hkv))
    v, do = (_bf16_values(rng.randn(b, h, s, d).astype(np.float32))
             for h in (hkv, hq))
    scale = d ** -0.5

    def jf(q_, k_, v_):
        return jl.blockwise_attention(q_, k_, v_, causal=True, window=None,
                                      scale=scale, block_k=128)

    _, vjp = jax.vjp(jf, *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = vjp(jnp.asarray(do.numpy()))
    o, lse = fk.flash_attention_plain(q, k, v, causal=True, scale=scale,
                                      return_lse=True)
    o = o.to(torch.bfloat16).float()      # the forward writes bfloat16
    got = _kernel_rounding_backward(q, k, v, o, lse, do, causal=True,
                                    window=None, scale=scale)
    exact = fk.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True,
                                         scale=scale)
    for name, g, w, x in zip(("dq", "dk", "dv"), got, want, exact):
        w = torch.from_numpy(np.array(w))
        top = w.abs().max().item()
        err = (g - w).abs().max().item()
        assert top > 0 and err <= 2e-2 * top, (name, err, top)
        assert not torch.equal(g, x.to(torch.bfloat16).float()), name


#: The registered configs' head dims beyond 16/32/64/128: HuBERT-XLarge's
#: 80 (non-causal), Kimi K2's 112 and Nemotron-4 340B's 192 (forward only
#: on the card).
CONFIG_DIMS = [80, 112, 192]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("d", CONFIG_DIMS)
def test_config_head_dims_match_reference_kernel(d, causal, window, dtype):
    """At the configs' head dims the port's ``flash_attention`` (its plain
    version on the CPU, the card kernel's check) against the reference's
    Pallas kernel in interpret mode and its oracle, at the reference's
    tolerances: float32 atol 3e-5 / rtol 1e-4, bfloat16 max abs 2e-2."""
    q, k, v = inputs(26, 1, 4, 2, 130, d)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    want = np.asarray(jops.flash_attention(jq, jk, jv, causal=causal,
                                           window=window), np.float32)
    oracle = np.asarray(jref.attention_ref(jq, jk, jv, causal=causal,
                                           window=window), np.float32)
    tq, tk, tv = (tensor_from_numpy(np.asarray(a)) for a in (jq, jk, jv))
    got = ops.flash_attention(tq, tk, tv, causal=causal, window=window)
    assert got.shape == (1, 4, 130, d) and got.dtype == tq.dtype
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=3e-5, rtol=1e-4)
        np.testing.assert_allclose(got, oracle, atol=3e-5, rtol=1e-4)
    else:
        assert np.max(np.abs(got - want)) < 2e-2
        assert np.max(np.abs(got - oracle)) < 2e-2


@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("d", [80, 112, 192])
def test_backward_at_config_head_dims_matches_reference_grads(d, causal,
                                                              window):
    """The backward at HuBERT's, Kimi K2's and Nemotron-4's head dims
    (80, 112, 192) against ``jax.vjp``
    of the reference's ``blockwise_attention``: the plain backward in
    float32 within 1e-4 of the largest |want| (the card kernel's float32
    bound), and the tensor-core kernel's arithmetic (P and dS rounded to
    bfloat16) on bfloat16 values within 2e-2 of it."""
    b, hq, hkv, s = 1, 4, 2, 130
    rng = np.random.RandomState(27)
    q, k = (_bf16_values(rng.randn(b, h, s, d).astype(np.float32) * 0.5)
            for h in (hq, hkv))
    v, do = (_bf16_values(rng.randn(b, h, s, d).astype(np.float32))
             for h in (hkv, hq))
    scale = d ** -0.5

    def jf(q_, k_, v_):
        return jl.blockwise_attention(q_, k_, v_, causal=causal,
                                      window=window, scale=scale,
                                      block_k=64)

    _, vjp = jax.vjp(jf, *(jnp.asarray(t.numpy()) for t in (q, k, v)))
    want = [torch.from_numpy(np.array(w))
            for w in vjp(jnp.asarray(do.numpy()))]
    o, lse = fk.flash_attention_plain(q, k, v, causal=causal, window=window,
                                      scale=scale, return_lse=True)
    exact = fk.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                         window=window, scale=scale)
    ob = o.to(torch.bfloat16).float()     # the forward writes bfloat16
    rounded = _kernel_rounding_backward(q, k, v, ob, lse, do, causal=causal,
                                        window=window, scale=scale)
    for name, x, r, w in zip(("dq", "dk", "dv"), exact, rounded, want):
        assert x.shape == w.shape == (b, hq if name == "dq" else hkv, s, d)
        top = w.abs().max().item()
        assert top > 0
        assert (x - w).abs().max().item() <= 1e-4 * top, name
        assert (r - w).abs().max().item() <= 2e-2 * top, name


@pytest.mark.parametrize("d,backward,admitted", [
    (8, False, True), (16, False, True), (24, False, True),
    (40, False, True), (80, False, True), (96, False, True),
    (112, False, True), (128, False, True), (192, False, True),
    (8, True, True), (80, True, True), (112, True, True), (128, True, True),
    (0, False, False), (4, False, False), (12, False, False),
    (100, False, False), (136, False, False), (176, False, False),
    (256, False, False), (192, True, True), (100, True, False),
    (136, True, False)])
def test_head_dim_rule(d, backward, admitted):
    """The kernels' head-dim rule, which the wrappers check before any
    launch, the forward's and the backward's: a multiple of 8 up to 128,
    or 192."""
    if admitted:
        fk.check_head_dim(d, backward=backward)
    else:
        with pytest.raises(ValueError, match="multiples of 8"):
            fk.check_head_dim(d, backward=backward)
