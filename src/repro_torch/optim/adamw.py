"""AdamW with dtype-configurable moment storage (float32 / bfloat16 / int8).

The counterpart of the reference's ``repro/optim/adamw.py``. The int8 mode
stores both moments as per-tensor absmax-quantized int8 with a float32
scale (8-bit Adam): each step dequantizes, updates in float32 and
re-quantizes, rounding half to even as the reference does.

Everything that depends on the step is a tensor op on ``state["step"]``,
a 0-d int32 tensor on the parameters' device: the learning rate, the bias
corrections ``b1**step`` and ``b2**step`` and the clip factor. Nothing is
read back to the host, so one update can be captured in a CUDA graph and
replayed at every later step with the step's own learning rate.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.tree import flatten_up_to, leaves, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"   # float32 | bfloat16 | int8


def lr_schedule(cfg: OptimConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to ``min_lr_ratio``, as a float32
    tensor of ``step``'s shape."""
    step = step.to(torch.float32)
    warm = step / max(1.0, cfg.warmup_steps)
    decay_steps = max(1.0, cfg.total_steps - cfg.warmup_steps)
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return cfg.learning_rate * torch.where(step < cfg.warmup_steps, warm,
                                           cos)


# -- int8 moment codec ---------------------------------------------------------
def _quantize(x: torch.Tensor) -> dict:
    if x.numel() == 0:  # zero-layer probe configs stack empty leaves
        return {"q": torch.zeros(x.shape, dtype=torch.int8, device=x.device),
                "scale": torch.ones((), device=x.device)}
    scale = torch.max(torch.abs(x)) / 127.0 + 1e-12
    return {"q": torch.round(x / scale).to(torch.int8),
            "scale": scale.to(torch.float32)}


def _dequantize(q: dict) -> torch.Tensor:
    return q["q"].to(torch.float32) * q["scale"]


def _moment_zeros(leaf: torch.Tensor, dtype: str):
    if dtype == "int8":
        return {"q": torch.zeros(leaf.shape, dtype=torch.int8,
                                 device=leaf.device),
                "scale": torch.zeros((), device=leaf.device)}
    return torch.zeros(leaf.shape, dtype=getattr(torch, dtype),
                       device=leaf.device)


def _moment_read(m, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return _dequantize(m)
    return m.to(torch.float32)


def _moment_write(x: torch.Tensor, dtype: str):
    if dtype == "int8":
        return _quantize(x)
    return x.to(getattr(torch, dtype))


def init_opt_state(params, cfg: OptimConfig) -> dict:
    """Zero moments in ``cfg.moment_dtype`` beside each parameter, and
    ``step`` as a 0-d int32 tensor on the parameters' device."""
    device = leaves(params)[0].device
    def zeros(p):
        return tree_map(lambda leaf: _moment_zeros(leaf, cfg.moment_dtype), p)
    return {"m": zeros(params), "v": zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def opt_state_shapes(abstract_params, cfg: OptimConfig):
    """:func:`init_opt_state` on meta tensors of ``abstract_params``'s
    shapes and dtypes."""
    meta = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                          device="meta"), abstract_params)
    return init_opt_state(meta, cfg)


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm over every leaf, summed in leaf order."""
    total = None
    for g in leaves(tree):
        sq = torch.sum(torch.square(g.to(torch.float32)))
        total = sq if total is None else total + sq
    if total is None:
        return torch.zeros(())
    return torch.sqrt(total)


#: A leaf of more elements is updated a slice of this many at a time
#: (float32 and bfloat16 moments; int8 moments need the whole leaf's
#: absmax): AdamW's float32 temporaries then take a few slices' bytes
#: rather than a few copies of the leaf (an expert weight of Mixtral-8x22B
#: is 805 M elements, 3.2 GB in float32).
UPDATE_SLICE = 1 << 26


def apply_updates(params, grads, state, cfg: OptimConfig, *,
                  gnorm: torch.Tensor | None = None):
    """One AdamW step. Returns (new_params, new_state, metrics); metrics
    ``grad_norm`` and ``lr`` are 0-d float32 tensors. A leaf larger than
    :data:`UPDATE_SLICE` is updated slice by slice (the same bits).

    ``gnorm``, the norm to clip by and report, defaults to
    :func:`global_norm` of ``grads``; a card of a peer mesh, whose tree
    holds only its own experts, passes the norm over every card's."""
    step = state["step"] + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    clip = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    md = cfg.moment_dtype

    def upd_whole(p, g, m, v):
        g = g.to(torch.float32) * clip
        m_f = b1 * _moment_read(m, md) + (1 - b1) * g
        v_f = b2 * _moment_read(v, md) + (1 - b2) * torch.square(g)
        mh = m_f / bc1
        vh = v_f / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * \
            p.to(torch.float32)
        new_p = (p.to(torch.float32) - lr * delta).to(p.dtype)
        return new_p, _moment_write(m_f, md), _moment_write(v_f, md)

    def upd(p, g, m, v):
        if md == "int8" or p.numel() <= UPDATE_SLICE:
            return upd_whole(p, g, m, v)
        # elementwise, so slice by slice gives the same bits
        outs = (torch.empty_like(p), torch.empty_like(m),
                torch.empty_like(v))
        ins = [t.reshape(-1) for t in (p, g, m, v)]
        for at in range(0, p.numel(), UPDATE_SLICE):
            part = slice(at, at + UPDATE_SLICE)
            for out, new in zip(outs, upd_whole(*(t[part] for t in ins))):
                out.view(-1)[part].copy_(new)
        return outs

    out = [upd(p, g, m, v) for p, g, m, v in zip(
        leaves(params), flatten_up_to(params, grads),
        flatten_up_to(params, state["m"]), flatten_up_to(params, state["v"]))]
    new_params = unflatten(params, [o[0] for o in out])
    new_m = unflatten(params, [o[1] for o in out])
    new_v = unflatten(params, [o[2] for o in out])
    metrics = {"grad_norm": gnorm, "lr": lr}
    return new_params, {"m": new_m, "v": new_v, "step": step}, metrics
