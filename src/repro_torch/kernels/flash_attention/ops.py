"""Wrappers of flash attention: the kernel on the card, the plain version
on the CPU, the autograd function whose backward is the backward kernel,
the FLOP count, and the capture adopter."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_bwd_cuda, flash_attention_cuda, flash_attention_plain,
    tma_aligned)


def backward_operand(do: torch.Tensor) -> torch.Tensor:
    """``do`` as the backward kernel takes it: ``do`` itself when its head
    dim is contiguous and, in bfloat16, it is :func:`~.kernel.tma_aligned`;
    else a new contiguous copy (whose base the allocator aligns)."""
    if do.stride(-1) == 1 and (do.dtype != torch.bfloat16
                               or tma_aligned(do)):
        return do
    return do.clone(memory_format=torch.contiguous_format)


class FlashAttentionFn(torch.autograd.Function):
    """Attention on CUDA tensors with a hand-written backward: the forward
    kernel also writes each row's log-sum-exp, and the backward kernel
    recomputes P from it (``flash_attention_bwd_cuda``). dO goes through
    :func:`backward_operand` first, since autograd may hand over a view
    the kernel cannot load as it lies."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, scale=scale,
                                        return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attrs = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.attrs
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, lse,
                                              backward_operand(do),
                                              causal=causal, window=window,
                                              scale=scale)
        return dq, dk, dv, None, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Attention of q ``(B, Hq, S, D)`` over k, v ``(B, Hkv, S, D)``
    (``scale`` defaults to ``D ** -0.5``). A CUDA tensor goes through the
    hand-written kernel, which takes head dims that are multiples of 8 up
    to 128, and 192 (:func:`~.kernel.check_head_dim`), and raises on any
    other: through :class:`FlashAttentionFn`, whose backward
    is the backward kernel, when grad is enabled and q, k or v requires
    grad, else the forward alone. A meta tensor, which a cost count
    passes, takes the card's branch. A CPU tensor goes through the plain
    version (differentiable by autograd); any other device raises."""
    if q.device.type in ("cuda", "meta"):
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttentionFn.apply(q, k, v, causal, window, scale)
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    scale=scale)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, window=window,
                                     scale=scale)
    raise ValueError(f"unsupported device {q.device}")


def attention_flops(q_shape, k_shape) -> int:
    """Nominal FLOP count of one attention call, the lane model's price of
    a capture's node (the reference's): ``2·B·H·Sq·Sk·D`` for QKᵀ plus the
    same again for the value matmul, whatever the mask keeps (the cost
    count's formula is :func:`repro_torch.launch.cost.attention_flops`)."""
    b, h, sq, d = q_shape
    sk = k_shape[2]
    return 4 * b * h * sq * sk * d


def captured_flash_attention(cap, q, k, v, *, name: str = "flash_attention",
                             causal: bool = True, window: int | None = None,
                             scale: float | None = None, telemetry=None):
    """Record a flash-attention invocation on a ``session.capture`` step.

    ``q``/``k``/``v`` are capture refs with local shapes ``(B, H, S, D)``;
    returns the attention output ref (q's shape). The kernel function folds
    the stacked ``(n, B, H, S, D)`` operands into ``(n·B, H, S, D)``, so
    one launch serves every device. The node is priced for the lane
    model: ``flops`` from :func:`attention_flops`, and — when a
    :class:`~repro_torch.comm.telemetry.TimelineRecorder` is passed as
    ``telemetry`` — ``cost_ns`` stamped from its recorded median for
    ``name`` (0 without one). ``cost_ns`` is part of the compute identity,
    so it changes the graph's digest. ``name`` is the capture's kernel
    identity: one adopter call per name per capture.
    """
    from repro_torch.comm.capture import BufferSpec
    q_spec = cap.buffers[cap._resolve(q)]
    k_spec = cap.buffers[cap._resolve(k)]

    def attn(q_, k_, v_):
        def fold(t):
            return t.reshape((-1,) + tuple(t.shape[2:]))
        out = flash_attention(fold(q_), fold(k_), fold(v_), causal=causal,
                              window=window, scale=scale)
        return out.reshape(q_.shape)

    cost = int(telemetry.kernel_cost_ns(name)) if telemetry is not None \
        else 0
    return cap.kernel(attn, q, k, v, name=name,
                      out=BufferSpec(q_spec.shape, q_spec.dtype),
                      flops=attention_flops(q_spec.shape, k_spec.shape),
                      cost_ns=cost)
