"""Dense tensor parallelism inside a card's share of a peer mesh's program.

The reference lays every dense weight out on its mesh's ``model`` axis
(``training/sharding.py``'s ``_param_rule``) and lets GSPMD insert the
collectives. On a peer mesh (``make_host_mesh(..., devices=[...])``) the
serving engine places each card's share of those leaves
(:func:`~repro_torch.training.sharding.place_params`) and runs the
forward as card shares (:func:`~repro_torch.models.moe_dist.card_share`),
whose :class:`DenseCut` says which leaves the card's tree holds cut. A
card holding model-axis devices ``held`` holds, of a dim cut into
``model`` blocks, the blocks of ``held`` concatenated in index order:

* the vocabulary (``embed`` rows, ``lm_head`` columns) when ``model``
  divides it: the card looks its tokens up in its blocks (zero rows for
  the rest) and ONE peer psum gives every card the embeddings; its logits
  over its blocks are gathered once with the ring's all-gather, so every
  card holds ``(..., V)``;
* attention by whole heads (``wq`` columns and ``wo`` rows in blocks of
  ``num_heads / model`` heads) when ``model`` divides ``num_heads``, and
  ``wk``/``wv`` by whole kv heads when it divides ``num_kv_heads`` (else
  they stay replicas: the card computes every kv head and takes those
  its q heads use): attention over the card's heads, then ``o @ wo`` and
  ONE peer psum;
* the dense MLP's and the shared expert's hidden dim (``w1``/``w3``
  columns, ``w2`` rows) when ``model`` divides it: ONE peer psum of the
  partial products;
* RWKV-6's time mix by whole heads (``w_r``, ``w_k``, ``w_v``, ``w_w``,
  ``w_g`` columns, ``w_out`` rows, ``u`` rows and ``ln_x``'s channels in
  blocks of ``h / model`` heads) when ``model`` divides its ``h`` heads:
  the scan and the per-head group norm over the card's heads, then ONE
  peer psum; the token shift and ``mu`` stay whole;
* Hymba's Mamba by channels (``w_in``'s columns of both its x and z
  halves, every per-channel leaf, ``w_dt1``/``w_B``/``w_C``/``w_out``
  rows) when ``model`` divides ``d_i``: dt, B and C contract over the
  channels, so their partials go to every card in ONE peer psum of
  ``r + 2N`` floats a token, and the output in ONE more.

A part whose cut would split a head or not divide stays a replica and
runs whole, as before. A card that holds every model-axis device cuts
nothing, so a one-card layout runs exactly the stacked program. Each
psum adds the cards' partials in the activations' dtype, as GSPMD's
all-reduce of a bfloat16 dot does, and gives every card the same bits
(:func:`~repro_torch.models.moe_dist.share_psum`). Indices are Python
ints and every pick a slice, so a share records into a CUDA graph.

A train step's card shares (:func:`~repro_torch.training.sharding.
place_state` with a config) run the same cuts under autograd. Every card
computes the whole loss from replicated activations, so each cut region
stands inside Megatron's conjugate pair: g (:func:`psum`, forward the
card's share of ONE peer psum, backward the identity) after its
row-parallel product, f (:func:`enter`, forward the identity, backward
ONE peer psum of the card's cotangents, added in the activations'
dtype) on what it reads: the normed input of the card's heads, hidden
units, vocabulary blocks and mixer channels, the replicated ``wk``/``wv``
whose kv heads a card's q heads read and RWKV-6's replicated ``mu``
(each card's gradient of them holds only its part). Mamba's gates stand
inside both, g then f, since what follows their psum is the card's own
channels again. The loss over a vocabulary cut (:func:`vocab_nll`)
gathers no logits: each card's block log-sum-exps go to every card in
ONE all-gather of ``(B·S)`` floats a block, and the gold logit is ONE g
psum. Both Functions keep the share's ring and card and re-enter it on
the thread that runs their backward (on CUDA autograd's own thread a
device), as :class:`~repro_torch.models.moe_dist.PeerGatherFn` does.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe_dist


@dataclasses.dataclass(frozen=True)
class DenseCut:
    """Which dense leaves one card's serving tree holds cut: the
    model-axis devices ``held`` (ascending) of ``model``, and per part
    whether it is cut. Every flag False: every dense leaf whole."""

    held: tuple[int, ...]
    model: int
    heads: bool = False       # wq columns, wo rows, by whole heads
    kv: bool = False          # wk, wv columns, by whole kv heads
    ff: bool = False          # the dense MLP's hidden dim
    shared: bool = False      # the shared expert's hidden dim
    vocab: bool = False       # embed rows, lm_head columns
    time_mix: bool = False    # RWKV-6's time mix, by whole heads
    mamba: bool = False       # Hymba's Mamba, by channels

    @property
    def cuts(self) -> bool:
        return (self.heads or self.ff or self.shared or self.vocab
                or self.time_mix or self.mamba)

    def part(self, n: int) -> int:
        """The card's length of a dim of ``n`` cut into ``model`` blocks."""
        return n // self.model * len(self.held)

    def units(self, n: int) -> list[int]:
        """The indices of the card's ``part(n)`` units of ``n``, in the
        order its cut holds them."""
        b = n // self.model
        return [d * b + i for d in self.held for i in range(b)]


def dense_cut(cfg: ArchConfig, held, model: int) -> DenseCut:
    """The cut of the card that holds model-axis devices ``held`` of
    ``model``: each part cut whole units only (module docstring); nothing
    where the card holds every device."""
    held = tuple(sorted(held))
    if len(held) == model:
        return DenseCut(held, model)
    heads = cfg.family != "ssm" and cfg.num_heads % model == 0
    return DenseCut(
        held, model, heads=heads,
        kv=heads and cfg.num_kv_heads % model == 0,
        ff=not cfg.num_experts and cfg.d_ff % model == 0,
        shared=bool(cfg.num_experts and cfg.num_shared_experts)
        and cfg.d_ff * cfg.num_shared_experts % model == 0,
        vocab=cfg.decoder and cfg.vocab_size % model == 0,
        time_mix=cfg.family == "ssm"
        and cfg.d_model // cfg.rwkv_head_dim % model == 0,
        mamba=cfg.family == "hybrid" and cfg.d_model % model == 0)


def in_force() -> DenseCut | None:
    """The cut of the card share in force on this thread, where it cuts
    anything; else None (no share, a share with no cut, a card holding
    every device)."""
    share = moe_dist.current_share()
    if share is None or share[2] is None or not share[2].cuts:
        return None
    return share[2]


class PsumFn(torch.autograd.Function):
    """g: forward the card's share of ONE peer psum over ``ring``, the sum
    of every card's ``x`` (the same bits on every card); backward the
    identity (what follows is replicated, so the cotangent is every
    card's)."""

    @staticmethod
    def forward(ctx, ring, card: int, x: torch.Tensor) -> torch.Tensor:
        return moe_dist.share_psum(ring, card, x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return None, None, grad


class EnterFn(torch.autograd.Function):
    """f: forward the identity of each of ``xs``; backward ONE peer psum
    over ``ring`` of their cotangents, flattened into one operand in the
    first's dtype (the activations'), so that each card's gradients hold
    every card's part. Re-enters the card on the thread that runs it."""

    @staticmethod
    def forward(ctx, ring, card: int, *xs: torch.Tensor):
        ctx.run = (ring, card)
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads: torch.Tensor):
        dt = grads[0].dtype
        flat = torch.cat([g.reshape(-1).to(dt) for g in grads])
        with moe_dist._entered(*ctx.run):
            total = moe_dist.share_psum(*ctx.run, flat).clone()
        out, off = [], 0
        for g in grads:
            out.append(total[off:off + g.numel()].view(g.shape).to(g.dtype))
            off += g.numel()
        return (None, None, *out)


def psum(x: torch.Tensor) -> torch.Tensor:
    """The sum of every card's ``x``: g, the card's share of ONE peer psum
    over the share's ring, the same bits on every card (its backward the
    identity)."""
    ring, card, _ = moe_dist.current_share()
    return PsumFn.apply(ring, card, x)


def enter(*xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """f on what a cut region reads: ``xs`` themselves, whose gradients
    are summed over the cards by ONE peer psum in the backward; ``xs``
    as they are where no gradient is taken."""
    if not torch.is_grad_enabled():
        return xs
    ring, card, _ = moe_dist.current_share()
    return EnterFn.apply(ring, card, *xs)


def heads(cfg: ArchConfig, cut: DenseCut | None
          ) -> tuple[int, int, list[int] | None]:
    """``(q heads, kv heads, take)`` that a card's attention runs: the
    config's under no head cut; its own heads under one, and its own kv
    heads where ``wk``/``wv`` are cut too. Where they are replicas,
    ``take`` lists the kv heads (of all) its q heads read, in order: each
    once where every one serves the same number of consecutive q heads,
    else one a q head."""
    if cut is None or not cut.heads:
        return cfg.num_heads, cfg.num_kv_heads, None
    h = cut.part(cfg.num_heads)
    if cut.kv:
        return h, cut.part(cfg.num_kv_heads), None
    group = cfg.num_heads // cfg.num_kv_heads
    need = [q // group for q in cut.units(cfg.num_heads)]
    distinct = list(dict.fromkeys(need))
    per = len(need) // len(distinct)
    if need == [k for k in distinct for _ in range(per)]:
        return h, len(distinct), distinct
    return h, len(need), need


def take(x: torch.Tensor, dim: int, index: list[int]) -> torch.Tensor:
    """``x``'s entries ``index`` along ``dim``, from slices (each run of
    consecutive indices one ``narrow``)."""
    runs: list[list[int]] = []
    for i in index:
        if runs and runs[-1][1] == i:
            runs[-1][1] = i + 1
        else:
            runs.append([i, i + 1])
    parts = [x.narrow(dim, a, b - a) for a, b in runs]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim)


def embed(table: torch.Tensor, tokens: torch.Tensor, cut: DenseCut,
          vocab: int) -> torch.Tensor:
    """The embeddings of ``tokens`` from the card's vocabulary blocks
    ``table`` (zero rows for tokens outside them), summed over the cards
    by ONE peer psum: every card's lookup, exactly (one card adds each
    row, the others zeros)."""
    vb = vocab // cut.model
    row = torch.zeros_like(tokens)
    mine = torch.zeros(tokens.shape, dtype=torch.bool, device=tokens.device)
    for i, d in enumerate(cut.held):
        inside = (tokens >= d * vb) & (tokens < (d + 1) * vb)
        row = torch.where(inside, tokens - (d - i) * vb, row)
        mine = mine | inside
    rows = table[row]
    return psum(torch.where(mine[..., None], rows, torch.zeros(
        (), dtype=rows.dtype, device=rows.device)))


def gather_vocab(logits: torch.Tensor, cut: DenseCut) -> torch.Tensor:
    """Every card's logits ``(..., V)`` from each card's over its
    vocabulary blocks ``(..., part(V))``: ONE all-gather over the share's
    ring, each model-axis device's block a shard."""
    ring, _, _ = moe_dist.current_share()
    vb = logits.shape[-1] // len(cut.held)
    flat = logits.reshape(-1, logits.shape[-1])
    shards = [None] * ring.n
    for i, d in enumerate(cut.held):
        shards[d] = flat[:, i * vb:(i + 1) * vb]
    full = ring.gather(shards)[cut.held[0]]         # (model, rows, vb)
    return full.permute(1, 0, 2).reshape(
        logits.shape[:-1] + (ring.n * vb,))


class BlockGatherFn(torch.autograd.Function):
    """Every model-axis device's block row ``(B, S)`` on every card: the
    card's rows ``rows`` (one a held device, in order) gathered with ONE
    all-gather over ``ring`` into ``(model, B, S)`` (a copy). Backward:
    each of the card's rows its own slice of the cotangent (every card
    computes the same loss from the gather, so no sum is needed)."""

    @staticmethod
    def forward(ctx, ring, card: int, held: tuple, *rows: torch.Tensor):
        ctx.held = held
        shards = [None] * ring.n
        for d, x in zip(held, rows):
            shards[d] = x.reshape(1, -1)
        full = ring.gather(shards)[held[0]]             # (model, 1, B·S)
        return full.reshape((ring.n,) + rows[0].shape).clone()

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return (None, None, None, *(grad[d] for d in ctx.held))


def vocab_nll(h: torch.Tensor, head: torch.Tensor, labels: torch.Tensor,
              cut: DenseCut, vocab: int) -> torch.Tensor:
    """The float32 NLL ``(B, S)`` of ``labels`` under the logits ``h @
    head`` over the whole vocabulary, from the card's vocabulary blocks
    ``head`` ``(d, part(V))`` alone: no ``(B, S, V)`` logits are
    gathered. Each block's row log-sum-exp goes to every card by ONE
    all-gather (:class:`BlockGatherFn`), and every card takes the
    log-sum-exp over the blocks in device order (the same bits on every
    card; within float rounding of one log-sum-exp over ``V``); the gold
    logit is the card's where the label falls in its blocks, else 0,
    summed by ONE g psum (exact: one card adds it, the others zeros).
    ``h`` enters through f."""
    ring, card, _ = moe_dist.current_share()
    (h,) = enter(h)
    lf = (h @ head).float()
    vb = vocab // cut.model
    lab = labels.long()
    blocks, gold = [], None
    for i, d in enumerate(cut.held):
        block = lf[..., i * vb:(i + 1) * vb]
        blocks.append(torch.logsumexp(block, dim=-1))
        inside = (lab >= d * vb) & (lab < (d + 1) * vb)
        pick = torch.gather(block, -1, torch.where(
            inside, lab - d * vb, 0)[..., None])[..., 0]
        mine = torch.where(inside, pick, torch.zeros((), device=pick.device))
        gold = mine if gold is None else gold + mine
    every = BlockGatherFn.apply(ring, card, cut.held, *blocks)
    return torch.logsumexp(every, dim=0) - psum(gold)
