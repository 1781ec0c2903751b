"""Mixture-of-Experts block: top-k routing with a static capacity buffer.

The reference's ``models/moe.py`` on one shard (the expert-parallel
layer under a mesh is :mod:`.moe_dist`): a softmax router picks each
token's ``top_k`` experts; the ``T·k`` (token, expert) pairs are sorted
by expert, stably, and each pair's position within its expert comes from
a searchsorted over the sorted ids (O(T·k) memory, no ``(T, E)``
one-hots); pairs past the expert's ``capacity`` are dropped; every
expert's FFN runs as one batched product over its ``(E, capacity, d)``
buffer; each token sums its pairs' gated outputs. Includes the Switch-style load-balancing auxiliary loss
and optional shared experts (kimi/DeepSeek recipe).

Nothing reads back to the host (no ``.item()``, ``nonzero`` or boolean
indexing), so the layer can be captured in a CUDA graph. The combine is
deterministic: each token gathers its ``top_k`` contributions and adds
them in ascending expert order, the order the reference's scatter-add
visits them, with no atomics. ``dropless`` sets the capacity to ``T``, so
every expert's product runs over ``T`` rows whatever its load, as in the
reference (a grouped product over the real loads is later speed work).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import mlp_apply, mlp_init


def moe_init(d: int, ff: int, num_experts: int, kind: str, num_shared: int,
             dtype: torch.dtype, *, generator: torch.Generator, device=None,
             lead: tuple = ()) -> dict:
    """One MoE block's parameters (``lead``-stacked), with the reference's
    distributions: the float32 router normal × ``d**-0.5``, the experts'
    ``w1``/``w3`` normal × ``d**-0.5`` and ``w2`` × ``ff**-0.5``, and
    ``num_shared`` shared experts as one MLP of width ``ff·num_shared``."""
    def normal(shape, scale, dt=dtype):
        return torch.randn(lead + shape, generator=generator, device=device,
                           dtype=dt).mul_(scale)

    scale_in, scale_out = d ** -0.5, ff ** -0.5
    p = {"router": normal((d, num_experts), scale_in, torch.float32),
         "w1": normal((num_experts, d, ff), scale_in),
         "w2": normal((num_experts, ff, d), scale_out)}
    if kind in ("swiglu", "geglu"):
        p["w3"] = normal((num_experts, d, ff), scale_in)
    if num_shared:
        p["shared"] = mlp_init(d, ff * num_shared, kind, dtype,
                               generator=generator, device=device, lead=lead)
    return p


def capacity_of(tokens: int, num_experts: int, top_k: int,
                capacity_factor: float, dropless: bool) -> int:
    """Rows of each expert's buffer: ``tokens`` when dropless, else the
    GShard capacity ``max(1, int(T·k/E·capacity_factor))``."""
    if dropless:
        return tokens
    return max(1, int(tokens * top_k / num_experts * capacity_factor))


@dataclasses.dataclass
class Routes:
    """Where each of the ``T·k`` (token, expert) pairs goes, in the order
    sorted by expert: its ``expert``, its ``token``, its ``row`` in the
    flat ``(E·capacity + 1, d)`` buffer (``expert·capacity + position``,
    or the spare last row when dropped), ``keep`` (not dropped) and its
    normalised ``gate``; ``rank`` is the sorted position of token t's
    j-th pair, ``(T, k)``; ``aux`` the load-balancing loss."""
    expert: torch.Tensor
    token: torch.Tensor
    row: torch.Tensor
    keep: torch.Tensor
    gate: torch.Tensor
    rank: torch.Tensor
    aux: torch.Tensor
    capacity: int


def aux_loss(probs: torch.Tensor, expert_ids: torch.Tensor) -> torch.Tensor:
    """The load-balancing loss ``E · Σ_e f_e · p_e`` of router
    probabilities ``(T, E)`` and each token's top-k experts ``(T, k)``."""
    e = probs.shape[-1]
    experts = torch.arange(e, device=probs.device)
    one_hot = (expert_ids[..., None] == experts).float()        # (T, k, E)
    density = one_hot.sum(1).mean(0)
    return e * torch.sum(density * probs.mean(0))


def route(x: torch.Tensor, router: torch.Tensor, *, top_k: int,
          capacity: int) -> Routes:
    """Route the ``(T, d)`` tokens ``x``: float32 router softmax, top-k
    gates renormalised to sum to 1, the stable sort of the pairs by
    expert (ties keep token order, so the same pairs fall past capacity
    as in the reference), each pair's position within its expert."""
    t = x.shape[0]
    e = router.shape[-1]
    probs = torch.softmax(x.float() @ router, dim=-1)          # (T, E)
    gate_vals, expert_ids = torch.topk(probs, top_k, dim=-1)   # (T, k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)

    aux = aux_loss(probs, expert_ids)
    experts = torch.arange(e, device=x.device)

    flat_ids = expert_ids.reshape(t * top_k)
    order = torch.argsort(flat_ids, stable=True)
    sorted_ids = flat_ids[order]
    seg_start = torch.searchsorted(sorted_ids, experts, side="left")
    pos = torch.arange(t * top_k, device=x.device) - seg_start[sorted_ids]
    keep = pos < capacity
    rank = torch.empty_like(order)
    rank[order] = torch.arange(t * top_k, device=x.device)
    row = torch.where(keep, sorted_ids * capacity + pos, e * capacity)
    return Routes(expert=sorted_ids, token=order // top_k, row=row,
                  keep=keep,
                  gate=gate_vals.reshape(t * top_k)[order],
                  rank=rank.view(t, top_k), aux=aux, capacity=capacity)


def dispatch(x: torch.Tensor, r: Routes, num_experts: int) -> torch.Tensor:
    """The experts' ``(E, capacity, d)`` input buffer: each kept pair's
    token in its row, zeros elsewhere (a dropped pair lands in a spare
    row past the buffer)."""
    d = x.shape[1]
    rows = num_experts * r.capacity
    buf = x.new_zeros((rows + 1, d))
    buf.index_copy_(0, r.row, x[r.token])
    return buf[:rows].view(num_experts, r.capacity, d)


def expert_ffn(buf: torch.Tensor, params: dict, kind: str) -> torch.Tensor:
    """Every expert's FFN over its rows: ``(E, C, d)`` → ``(E, C, d)``,
    one batched product per weight."""
    h = torch.bmm(buf, params["w1"])
    if kind in ("swiglu", "geglu"):
        u = torch.bmm(buf, params["w3"])
        act = F.silu(h) if kind == "swiglu" else F.gelu(h, approximate="tanh")
        h = act * u
    elif kind == "relu2":
        h = torch.square(F.relu(h))
    else:
        h = F.gelu(h, approximate="tanh")
    return torch.bmm(h, params["w2"])


def combine(back: torch.Tensor, keep: torch.Tensor, r: Routes,
            dtype: torch.dtype) -> torch.Tensor:
    """Each token's sum of its pairs' gated outputs ``(T, d)`` in
    ``dtype``: ``back`` holds every pair's expert output in sorted order,
    ``keep`` says which pairs count (the others add zeros), and a token
    adds its pairs in ascending expert order (ascending sorted rank)."""
    back = torch.where(keep[:, None], back, 0)
    contrib = (back * (r.gate * keep)[:, None]).to(dtype)
    ranks = torch.sort(r.rank, dim=1).values                   # (T, k)
    out = contrib[ranks[:, 0]]
    for j in range(1, ranks.shape[1]):
        out = out + contrib[ranks[:, j]]
    return out


def moe_apply(x: torch.Tensor, params: dict, *, top_k: int, kind: str,
              capacity_factor: float = 1.25, dropless: bool = False,
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) flattened tokens → (out (T, d), aux_loss scalar).

    ``dropless=True`` sets the capacity to the worst case (T), as the
    decode and prefill paths do; training uses the capacity factor
    (GShard-style dropping)."""
    t, d = x.shape
    e = params["router"].shape[-1]
    r = route(x, params["router"], top_k=top_k,
              capacity=capacity_of(t, e, top_k, capacity_factor, dropless))
    rows = e * r.capacity
    y = expert_ffn(dispatch(x, r, e), params, kind)
    back = y.view(rows, d)[r.row.clamp(max=rows - 1)]          # (T·k, d)
    out = combine(back, r.keep, r, x.dtype)
    if "shared" in params:
        out = out + mlp_apply(x, params["shared"], kind)
    return out, r.aux
