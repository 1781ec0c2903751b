"""Model assembly: blocks, layer stacks, the training loss, prefill and
decode.

The reference's model assembly, every family (``family`` ``dense``;
``vlm``, whose images arrive as tokens; ``moe``, whose FFN is a mixture
of experts; ``hybrid``, whose blocks mix attention and Mamba in parallel;
``ssm``, whose blocks mix with RWKV-6 instead of attention; ``audio``, an
encoder whose frames arrive as precomputed ``(B, T, frontend_dim)``
features, projected into ``d_model`` by ``frontend_proj``):
``ArchConfig`` selects the mixer, the FFN (dense MLP or MoE), the
attention pattern and the MLP kind. Each per-layer parameter is stacked
on a leading ``L`` axis, as in the reference, and the layer stack is a
Python loop over ``L``. An encoder (``causal=False``, the audio model)
runs ``forward`` and ``loss_fn`` with non-causal attention and its
``head``; it has no decode step, so :func:`init_cache`,
:func:`prefill_forward` and :func:`decode_step` refuse it
(:func:`check_decoder`). The MoE FFN runs the single-shard
:func:`~.moe.moe_apply`, or, under an ambient mesh with a model axis
(:func:`~repro_torch.launch.mesh.set_mesh`), the expert-parallel
:func:`~.moe_dist.moe_apply_dist`, as the reference does.
:func:`cache_shapes` gives a cache's shapes as meta tensors.

Decode caches (serve path):

* full / local_global attention → chunked cache ``(L, B, Hkv, C, Sc, hd)``
  for flash-decoding,
* sliding-window attention → ring cache ``(L, B, Hkv, W, hd)`` (O(window)
  memory),
* gemma3's 5:1 local:global stack walks a per-layer window list with a
  single code path (window = −1 ⇒ global),
* hybrid (Mamba beside attention) → the attention cache, plus the
  float32 SSM state ``ssm`` ``(L, B, d, N)`` and the last ``K − 1`` conv
  inputs ``conv`` ``(L, B, K − 1, d)``,
* RWKV-6 (SSM) → no key/value cache: the float32 recurrent state
  ``rwkv_state`` ``(L, B, h, hd, hd)`` and the token-shift input
  ``rwkv_shift`` ``(L, B, d)``.

MoE prefill and decode run dropless (every token reaches its experts), as
in the reference; ``forward`` uses the capacity factor and returns the
summed auxiliary loss.

Unlike the reference, whose arrays are immutable, :func:`decode_step`
writes the new token's key and value (or the new SSM state) into the cache
in place and returns the same cache: a decode step allocates no second
cache. Its position ``cur_len`` is a 0-d int64 tensor on the cache's
device (an int is turned into one), and the step reads nothing back to
the host, so one step can be captured as a CUDA graph and replayed with
another position. :func:`prefill_forward` can fill a given cache in
place instead of a new one.

Training: :func:`loss_fn` is the reference's masked float32 NLL plus the
auxiliary loss, differentiated by autograd (on the card attention's
backward is the ``flash_attention`` backward kernel and RMSNorm's the
reference's VJP). ``cfg.remat == "full"`` recomputes each layer in the
backward (``torch.utils.checkpoint``, non-reentrant, RNG state not
preserved: the model draws no random numbers, and reading the RNG state
would break graph capture); inside a card's share of a peer mesh's step
the recompute runs in that share too (:func:`~.moe_dist.in_this_share`).

Inside a card's share of a peer mesh's program whose
:class:`~.tensor_parallel.DenseCut` cuts dense leaves (the card's tree of
:func:`~repro_torch.training.sharding.place_params` or ``place_state``
with a config), the embedding, attention, dense MLP, shared expert and
head run tensor parallel (:mod:`.tensor_parallel`), and so do RWKV-6's
time mix and Hymba's Mamba (:mod:`.ssm`): the card's heads, hidden
units, vocabulary blocks and mixer channels, one peer psum (g) after
each of the embedding, the attention's ``wo``, the mixers' ``w_out``
and the MLP's ``w2`` (and one of Mamba's gates), and one all-gather of
the logits; its decode cache (:func:`init_cache` with the card's
``cut``) holds only the kv heads its attention reads and its mixer's
heads' or channels' states. Under
autograd each cut region's input passes f (its backward one peer psum),
and :func:`loss_fn` takes the NLL from the card's vocabulary blocks
without gathering the logits.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models import moe_dist
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import tensor_parallel as tp
from repro_torch.models.layers import (NEG_INF, apply_rope,
                                       blockwise_attention,
                                       chunked_decode_attention, mlp_apply,
                                       mlp_init, rms_norm)
from repro_torch.tree import leaves

Params = dict
Cache = dict

def _dtype(cfg: ArchConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def check_decoder(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` for an encoder-only model (``causal=False``),
    which has no autoregressive decode step: the reference's reason for
    skipping its decode shapes."""
    if not cfg.decoder:
        raise ValueError(f"{cfg.name}: encoder-only: no autoregressive "
                         f"decode step")


def layer_windows(cfg: ArchConfig) -> list[int]:
    """Per-layer window list: -1 = full/global attention."""
    if cfg.attention == "swa":
        return [cfg.window] * cfg.num_layers
    if cfg.attention == "local_global":
        r = cfg.local_global_ratio
        return [(cfg.window if (i % (r + 1)) != r else -1)
                for i in range(cfg.num_layers)]
    return [-1] * cfg.num_layers


# ================================ init =======================================
def _normal(shape, scale, dtype, generator, device) -> torch.Tensor:
    w = torch.randn(shape, generator=generator, device=device, dtype=dtype)
    return w.mul_(scale)


def _attn_init(cfg: ArchConfig, *, generator, device, lead=()) -> Params:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_
    s, dt = d ** -0.5, _dtype(cfg)
    return {
        "wq": _normal(lead + (d, h * hd), s, dt, generator, device),
        "wk": _normal(lead + (d, kv * hd), s, dt, generator, device),
        "wv": _normal(lead + (d, kv * hd), s, dt, generator, device),
        "wo": _normal(lead + (h * hd, d), (h * hd) ** -0.5, dt, generator,
                      device),
    }


def block_init(cfg: ArchConfig, *, generator: torch.Generator, device,
               lead: tuple = ()) -> Params:
    """One block's parameters (``lead``-stacked: ``lead=(L,)`` gives the
    whole stack)."""
    d = cfg.d_model
    p = {"ln1": torch.zeros(lead + (d,), device=device),
         "ln2": torch.zeros(lead + (d,), device=device)}
    if cfg.family == "ssm":
        p["rwkv"] = ssm_lib.rwkv6_init(d, cfg.rwkv_head_dim, _dtype(cfg),
                                       generator=generator, device=device,
                                       lead=lead)
    else:
        p["attn"] = _attn_init(cfg, generator=generator, device=device,
                               lead=lead)
        if cfg.family == "hybrid":
            p["ssm"] = ssm_lib.mamba_init(d, cfg.ssm_state, _dtype(cfg),
                                          generator=generator,
                                          device=device, lead=lead)
            p["ln_a"] = torch.zeros(lead + (d,), device=device)
            p["ln_s"] = torch.zeros(lead + (d,), device=device)
    if cfg.num_experts:
        p["moe"] = moe_lib.moe_init(d, cfg.d_ff, cfg.num_experts, cfg.mlp,
                                    cfg.num_shared_experts, _dtype(cfg),
                                    generator=generator, device=device,
                                    lead=lead)
    else:
        p["mlp"] = mlp_init(d, cfg.d_ff, cfg.mlp, _dtype(cfg),
                            generator=generator, device=device, lead=lead)
    return p


def init_params(cfg: ArchConfig, *, generator: torch.Generator,
                device=None) -> Params:
    """Random weights from ``generator`` with the reference's
    distributions: normal × ``d**-0.5`` (``wo``: × ``(h·hd)**-0.5``; MLP
    out: × ``ff**-0.5``; an audio model's ``frontend_proj`` ``(frontend_dim,
    d)``: × ``frontend_dim**-0.5``; RWKV-6 and Mamba as :mod:`.ssm`, MoE as
    :func:`~.moe.moe_init`), zero norm weights; layers stacked on ``L``; an
    encoder's output projection is ``head``, a decoder's ``lm_head``."""
    d, v, dt = cfg.d_model, cfg.vocab_size, _dtype(cfg)
    p = {"embed": _normal((v, d), d ** -0.5, dt, generator, device),
         "layers": block_init(cfg, generator=generator, device=device,
                              lead=(cfg.num_layers,)),
         "final_norm": torch.zeros((d,), device=device)}
    head = "lm_head" if cfg.decoder else "head"
    p[head] = _normal((d, v), d ** -0.5, dt, generator, device)
    if cfg.frontend == "audio":
        p["frontend_proj"] = _normal((cfg.frontend_dim, d),
                                     cfg.frontend_dim ** -0.5, dt, generator,
                                     device)
    return p


def param_shapes(cfg: ArchConfig) -> Params:
    """The parameters' shapes and dtypes, as meta tensors (nothing is
    allocated or drawn)."""
    return init_params(cfg, generator=None, device="meta")


# module-level recursion: a recursive closure is a reference cycle, which
# would hold the views it makes (so the parameters) until the cyclic
# collector runs
def _pick(tree, i: int):
    if isinstance(tree, dict):
        return {k: _pick(t, i) for k, t in tree.items()}
    return tree[i]


def _unbind(tree):
    if isinstance(tree, dict):
        return {k: _unbind(t) for k, t in tree.items()}
    return torch.unbind(tree)


def layer_params(params: Params, i: int) -> Params:
    """Layer ``i``'s view of the stacked layer parameters."""
    return _pick(params["layers"], i)


def unstacked_layers(params: Params) -> list[Params]:
    """Every layer's views of the stacked layer parameters, from one
    ``torch.unbind`` a leaf. Under autograd a leaf's gradient is then ONE
    stack of the layers' gradients; indexing the stack once a layer
    (:func:`layer_params`) would give each layer a zero-filled gradient of
    the whole stack, summed: traffic and memory quadratic in ``L``."""
    cols = _unbind(params["layers"])
    return [_pick(cols, i) for i in range(len(leaves(cols)[0]))]


# ============================ full-sequence path =============================
def _kv_proj(x: torch.Tensor, w: torch.Tensor, hd: int, kv: int,
             take: list[int] | None) -> torch.Tensor:
    """``x @ w`` as ``(..., kv, hd)``: every head of ``w``, or, where a
    card's q heads read some of a replica's (``take``), those."""
    y = (x @ w).reshape(x.shape[:-1] + (-1, hd))
    return y if take is None else tp.take(y, -2, take)


def attention_qkv(x: torch.Tensor, ap: Params, cfg: ArchConfig,
                  positions: torch.Tensor, cut=None):
    """q ``(B, H, S, hd)``, k and v ``(B, Hkv, S, hd)`` of one block,
    RoPE applied to q and k; under a head ``cut`` (:mod:`.tensor_parallel`)
    the card's heads and the kv heads they read."""
    b, s, _ = x.shape
    h, kv, take = tp.heads(cfg, cut)
    hd = cfg.head_dim_
    q = (x @ ap["wq"]).reshape(b, s, h, hd).transpose(1, 2)
    k = _kv_proj(x, ap["wk"], hd, kv, take).transpose(1, 2)
    v = _kv_proj(x, ap["wv"], hd, kv, take).transpose(1, 2)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attention_full(x, ap, cfg: ArchConfig, window: int, positions,
                    return_kv: bool = False):
    b, s, _ = x.shape
    hd = cfg.head_dim_
    cut = tp.in_force()
    if cut is not None and cut.heads:
        # f on what the card's heads read: x, and wk/wv where they stay
        # replicas of which its q heads read only some kv heads
        if cut.kv:
            (x,) = tp.enter(x)
        else:
            x, wk, wv = tp.enter(x, ap["wk"], ap["wv"])
            ap = {**ap, "wk": wk, "wv": wv}
    q, k, v = attention_qkv(x, ap, cfg, positions, cut)
    o = blockwise_attention(q, k, v, causal=cfg.causal, window=window,
                            scale=hd ** -0.5)
    out = o.transpose(1, 2).reshape(b, s, q.shape[1] * hd) @ ap["wo"]
    if cut is not None and cut.heads:
        out = tp.psum(out)
    if return_kv:
        return out, (k, v)
    return out


def _ffn(x, lp, cfg: ArchConfig, dropless: bool = False):
    """The FFN of a block on ``(..., d)``: the dense MLP, or the MoE over
    the flattened tokens — expert-parallel (:mod:`.moe_dist`, its combine
    one psum through the mesh's session) when a mesh with a model axis
    over 1 is ambient, else :func:`~.moe.moe_apply`. Returns (out, aux);
    aux is 0 for a dense MLP. Under a dense cut the card's hidden units of
    the dense MLP or the shared expert, between f on their input and one
    psum (g) of their products."""
    cut = tp.in_force()
    if cfg.num_experts:
        flat = x.reshape(-1, x.shape[-1])
        res = moe_dist.moe_apply_dist(
            flat, lp["moe"], top_k=cfg.top_k, kind=cfg.mlp,
            capacity_factor=cfg.capacity_factor, dropless=dropless,
            fsdp=cfg.fsdp)
        if res is not None:
            out, aux = res
            if "shared" in lp["moe"]:
                if cut is not None and cut.shared:
                    (xs,) = tp.enter(flat)
                    sh = tp.psum(mlp_apply(xs, lp["moe"]["shared"],
                                           cfg.mlp))
                else:
                    sh = mlp_apply(flat, lp["moe"]["shared"], cfg.mlp)
                out = out + sh
        else:
            out, aux = moe_lib.moe_apply(
                flat, lp["moe"], top_k=cfg.top_k, kind=cfg.mlp,
                capacity_factor=cfg.capacity_factor, dropless=dropless)
        return out.reshape(x.shape), aux
    if cut is not None and cut.ff:
        (xf,) = tp.enter(x)
        out = tp.psum(mlp_apply(xf, lp["mlp"], cfg.mlp))
    else:
        out = mlp_apply(x, lp["mlp"], cfg.mlp)
    return out, torch.zeros((), device=x.device)


def _mix_hybrid(a, s, lp):
    """Hymba's parallel heads: the mean of the normed attention and SSM
    outputs."""
    return 0.5 * (rms_norm(a, lp["ln_a"]) + rms_norm(s, lp["ln_s"]))


def block_apply(x, lp, cfg: ArchConfig, window: int, positions):
    """Full-sequence block. x: (B, S, d) → (x', aux); aux is 0 but for
    MoE models."""
    xin = rms_norm(x, lp["ln1"])
    if cfg.family == "ssm":
        mix = ssm_lib.rwkv6_apply(xin, lp["rwkv"],
                                  head_dim=cfg.rwkv_head_dim)
    elif cfg.family == "hybrid":
        a = _attention_full(xin, lp["attn"], cfg, window, positions)
        mix = _mix_hybrid(a, ssm_lib.mamba_apply(xin, lp["ssm"]), lp)
    else:
        mix = _attention_full(xin, lp["attn"], cfg, window, positions)
    x = x + mix
    ff, aux = _ffn(rms_norm(x, lp["ln2"]), lp, cfg)
    return x + ff, aux


def embed_inputs(params: Params, cfg: ArchConfig,
                 batch: dict) -> torch.Tensor:
    """The first layer's input ``(B, S, d)``: an audio model's float32
    ``features`` ``(B, S, frontend_dim)`` in the model's dtype times
    ``frontend_proj``, else the embeddings of ``tokens``
    (:func:`embed_tokens`)."""
    if cfg.frontend == "audio":
        return (batch["features"].to(_dtype(cfg))
                @ params["frontend_proj"])
    return embed_tokens(params, cfg, batch["tokens"])


def embed_tokens(params: Params, cfg: ArchConfig,
                 tokens: torch.Tensor) -> torch.Tensor:
    """The embeddings of ``tokens``: rows of ``embed``, or under a
    vocabulary cut the card's rows summed over the cards
    (:func:`~.tensor_parallel.embed`)."""
    cut = tp.in_force()
    if cut is not None and cut.vocab:
        return tp.embed(params["embed"], tokens, cut, cfg.vocab_size)
    return params["embed"][tokens]


def forward(params: Params, cfg: ArchConfig, batch: dict,
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward. batch: tokens (B, S), or an audio model's
    features (B, S, frontend_dim).

    Returns (logits (B, S, V), aux_loss)."""
    x, aux = hidden_states(params, cfg, batch)
    if cfg.decoder:
        return head_logits(params, x), aux
    return rms_norm(x, params["final_norm"]) @ params["head"], aux


def hidden_states(params: Params, cfg: ArchConfig, batch: dict,
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The last layer's output ``(B, S, d)`` of :func:`forward` (before
    the final norm) and the summed auxiliary loss."""
    x = embed_inputs(params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    aux = torch.zeros((), device=x.device)
    remat = cfg.remat == "full" and torch.is_grad_enabled()
    layers = unstacked_layers(params)
    # a card's share of a peer mesh's step also in the recompute
    block = moe_dist.in_this_share(block_apply) if remat else block_apply
    for lp, window in zip(layers, layer_windows(cfg)):
        if remat:
            x, a = torch.utils.checkpoint.checkpoint(
                block, x, lp, cfg, window, positions,
                use_reentrant=False, preserve_rng_state=False)
        else:
            x, a = block_apply(x, lp, cfg, window, positions)
        aux = aux + a
    return x, aux


def loss_fn(params: Params, cfg: ArchConfig, batch: dict,
            aux_coef: float = 0.01) -> torch.Tensor:
    """Mean NLL of ``labels`` over the masked positions (the next token for
    a decoder, the frame's unit for an encoder), from float32 log-sum-exps
    of the logits, plus ``aux_coef`` × the auxiliary loss. batch: tokens
    (or features), labels (B, S) int and an optional float mask (B, S).
    Nothing is read back to the host. Under a vocabulary cut the card's
    blocks give the NLL without a gather of the logits
    (:func:`~.tensor_parallel.vocab_nll`)."""
    labels = batch["labels"]
    cut = tp.in_force()
    if cut is not None and cut.vocab:
        x, aux = hidden_states(params, cfg, batch)
        nll = tp.vocab_nll(rms_norm(x, params["final_norm"]),
                           params["lm_head"], labels, cut, cfg.vocab_size)
    else:
        logits, aux = forward(params, cfg, batch)
        lf = logits.float()
        lse = torch.logsumexp(lf, dim=-1)
        gold = torch.gather(lf, -1, labels.long()[..., None])[..., 0]
        nll = lse - gold
    mask = batch.get("mask")
    if mask is not None:
        nll = nll * mask
        denom = torch.clamp(torch.sum(mask), min=1.0)
    else:
        denom = nll.numel()
    return torch.sum(nll) / denom + aux_coef * aux


# ============================ prefill-into-cache ============================
def _kv_to_chunked(k, spec: "CacheSpec"):
    """(B, Hkv, S, hd) → (B, Hkv, C, Sc, hd), zero-padded to max_len."""
    b, kv, s, hd = k.shape
    pad = spec.max_len - s
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
    return k.reshape(b, kv, spec.kv_chunks, spec.chunk_len, hd)


def _kv_to_ring(k, spec: "CacheSpec", s: int):
    """(B, Hkv, S, hd) → ring (B, Hkv, W, hd): slot j holds the largest
    position p < S with p ≡ j (mod W); slots from before position 0 zero."""
    w = spec.max_len
    j = torch.arange(w, device=k.device)
    p = (s - 1) - ((s - 1 - j) % w)
    valid = p >= 0
    gathered = k[:, :, p.clamp(min=0)]
    return torch.where(valid[None, None, :, None], gathered,
                       torch.zeros((), dtype=k.dtype, device=k.device))


def prefill_forward(params: Params, cfg: ArchConfig, batch: dict,
                    spec: "CacheSpec", cache: Cache | None = None,
                    ) -> tuple[torch.Tensor, Cache]:
    """Full-sequence forward that also emits the decode cache.

    Returns (logits (B, S, V), cache) with the cache positioned after the
    last prompt token (``cur_len = S`` for the subsequent decode_step).
    Every entry of the cache is written: a given ``cache`` (of
    :func:`init_cache`'s shapes) is filled in place and returned, else a
    new one is made. An encoder raises (:func:`check_decoder`)."""
    check_decoder(cfg)
    x = embed_inputs(params, cfg, batch)
    if cache is None:
        cache = init_cache(cfg, x.shape[0], spec, device=x.device,
                           cut=tp.in_force())
    x = prefill_blocks(params, cfg, x, spec, cache, range(cfg.num_layers))
    return head_logits(params, x), cache


def prefill_blocks(params: Params, cfg: ArchConfig, x: torch.Tensor,
                   spec: "CacheSpec", cache: Cache,
                   layers: range) -> torch.Tensor:
    """The prefill's ``layers`` on ``x`` (B, S, d), each writing its cache
    entries in place; returns the last one's output."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    windows = layer_windows(cfg)
    for i in layers:
        window = windows[i]
        lp = layer_params(params, i)
        xin = rms_norm(x, lp["ln1"])
        if cfg.family == "ssm":
            a, (st, sh) = ssm_lib.rwkv6_apply(
                xin, lp["rwkv"], head_dim=cfg.rwkv_head_dim,
                return_state=True)
            cache["rwkv_state"][i] = st
            cache["rwkv_shift"][i] = sh
        else:
            a, (k, v) = _attention_full(xin, lp["attn"], cfg, window,
                                        positions, return_kv=True)
            if spec.kind == "chunked":
                cache["k"][i] = _kv_to_chunked(k, spec)
                cache["v"][i] = _kv_to_chunked(v, spec)
            else:
                cache["k"][i] = _kv_to_ring(k, spec, s)
                cache["v"][i] = _kv_to_ring(v, spec, s)
            if cfg.family == "hybrid":
                sm, (st, conv) = ssm_lib.mamba_apply(xin, lp["ssm"],
                                                     return_state=True)
                cache["ssm"][i] = st
                cache["conv"][i] = conv
                a = _mix_hybrid(a, sm, lp)
        x = x + a
        ff, _ = _ffn(rms_norm(x, lp["ln2"]), lp, cfg, dropless=True)
        x = x + ff
    return x


def head_logits(params: Params, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the output projection: a decoder's logits;
    under a vocabulary cut the card's blocks, gathered from every card
    (:func:`~.tensor_parallel.gather_vocab`)."""
    logits = rms_norm(x, params["final_norm"]) @ params["lm_head"]
    cut = tp.in_force()
    if cut is not None and cut.vocab:
        return tp.gather_vocab(logits, cut)
    return logits


# ================================ decode path ================================
@dataclasses.dataclass(frozen=True)
class CacheSpec:
    """Static decode-cache geometry for one arch × shape."""
    kind: str            # "chunked" | "ring" | "none"
    max_len: int
    kv_chunks: int = 16  # C, the split-KV chunk count

    @property
    def chunk_len(self) -> int:
        return self.max_len // self.kv_chunks


def cache_spec(cfg: ArchConfig, max_len: int, kv_chunks: int = 16,
               ) -> CacheSpec:
    if cfg.family == "ssm":
        return CacheSpec("none", max_len)
    if cfg.attention == "swa":
        return CacheSpec("ring", min(cfg.window, max_len))
    return CacheSpec("chunked", max_len, kv_chunks)


def init_cache(cfg: ArchConfig, batch: int, spec: CacheSpec,
               device=None, cut=None) -> Cache:
    """A zero decode cache: keys and values for attention models (beside
    the float32 SSM state and the conv inputs for hybrid ones), the
    recurrent state and the token-shift input for SSM models; under a
    card's dense ``cut`` only the kv heads its attention reads
    (:func:`~.tensor_parallel.heads`), its RWKV-6 heads' states and its
    Mamba channels' (the token-shift input stays whole: every card's
    mixing reads all of it). An encoder raises
    (:func:`check_decoder`)."""
    check_decoder(cfg)
    l, hd, d = cfg.num_layers, cfg.head_dim_, cfg.d_model
    kv = tp.heads(cfg, cut)[1]
    dt = _dtype(cfg)
    if cfg.family == "ssm":
        rh = cfg.rwkv_head_dim
        h = d // rh
        return {"rwkv_state": torch.zeros(
                    (l, batch, cut.part(h) if cut is not None
                     and cut.time_mix else h, rh, rh), device=device),
                "rwkv_shift": torch.zeros((l, batch, d), dtype=dt,
                                          device=device)}
    if spec.kind == "chunked":
        shape = (l, batch, kv, spec.kv_chunks, spec.chunk_len, hd)
    else:
        shape = (l, batch, kv, spec.max_len, hd)
    c = {"k": torch.zeros(shape, dtype=dt, device=device),
         "v": torch.zeros(shape, dtype=dt, device=device)}
    if cfg.family == "hybrid":
        d_i = cut.part(d) if cut is not None and cut.mamba else d
        c["ssm"] = torch.zeros((l, batch, d_i, cfg.ssm_state),
                               device=device)
        c["conv"] = torch.zeros((l, batch, ssm_lib.CONV_K - 1, d_i),
                                dtype=dt, device=device)
    return c


def cache_shapes(cfg: ArchConfig, batch: int, spec: CacheSpec) -> Cache:
    """:func:`init_cache`'s shapes and dtypes as meta tensors (nothing is
    allocated)."""
    return init_cache(cfg, batch, spec, device="meta")


def _attention_decode(x, ap, cfg: ArchConfig, window: int, cache_k, cache_v,
                      cur_len: torch.Tensor, spec: CacheSpec):
    """x: (B, d) one token at position ``cur_len`` (a 0-d int64 tensor);
    writes its key and value into ``cache_k``/``cache_v`` in place.
    Returns out (B, d)."""
    b, _ = x.shape
    cut = tp.in_force()
    h, kv, take = tp.heads(cfg, cut)
    hd = cfg.head_dim_
    q = (x @ ap["wq"]).reshape(b, h, hd)
    k = _kv_proj(x, ap["wk"], hd, kv, take)
    v = _kv_proj(x, ap["wv"], hd, kv, take)
    pos = cur_len.view(1)
    q = apply_rope(q[:, :, None, :], pos, cfg.rope_theta)[:, :, 0]
    k = apply_rope(k[:, :, None, :], pos, cfg.rope_theta)[:, :, 0]

    if spec.kind == "ring":
        slot = cur_len % spec.max_len
        cache_k.index_copy_(2, slot.view(1), k[:, :, None])
        cache_v.index_copy_(2, slot.view(1), v[:, :, None])
        qpk = h // kv
        qg = (q.reshape(b, kv, qpk, hd) * hd ** -0.5).float()
        s = torch.einsum("bgqd,bgsd->bgqs", qg, cache_k.float())
        idx = torch.arange(spec.max_len, device=x.device)
        # ring slot ``idx`` holds global position cur_len - ((slot - idx) %
        # W) (slot itself holds cur_len); entries from before position 0
        # are unfilled and masked out. Window validity is automatic: the
        # ring only ever holds the freshest W positions.
        p_stored = cur_len - ((slot - idx) % spec.max_len)
        s = torch.where(p_stored >= 0, s, NEG_INF)
        pr = torch.softmax(s, dim=-1)
        o = torch.einsum("bgqs,bgsd->bgqd", pr, cache_v.float())
        o = o.reshape(b, h, hd).to(x.dtype)
    else:
        # chunk cur_len // Sc, slot cur_len % Sc: row cur_len of the
        # (B, Hkv, C·Sc, hd) view
        flat = (b, kv, spec.max_len, hd)
        cache_k.view(flat).index_copy_(2, pos, k[:, :, None])
        cache_v.view(flat).index_copy_(2, pos, v[:, :, None])
        o = chunked_decode_attention(q, cache_k, cache_v, cur_len + 1,
                                     window=window, scale=hd ** -0.5)
    out = o.reshape(b, h * hd) @ ap["wo"]
    return tp.psum(out) if cut is not None and cut.heads else out


def decode_block_apply(x, lp, cfg: ArchConfig, window: int, cache_l: dict,
                       cur_len: torch.Tensor, spec: CacheSpec):
    """One token through one block. x: (B, d); ``cache_l`` is the layer's
    views of the cache's leaves, updated in place."""
    xin = rms_norm(x, lp["ln1"])
    if cfg.family == "ssm":
        mix, st, sh = ssm_lib.rwkv6_decode(
            xin, lp["rwkv"], cache_l["rwkv_state"], cache_l["rwkv_shift"],
            head_dim=cfg.rwkv_head_dim)
        cache_l["rwkv_state"].copy_(st)
        cache_l["rwkv_shift"].copy_(sh)
    else:
        mix = _attention_decode(xin, lp["attn"], cfg, window, cache_l["k"],
                                cache_l["v"], cur_len, spec)
        if cfg.family == "hybrid":
            s, st, conv = ssm_lib.mamba_decode(xin, lp["ssm"],
                                               cache_l["ssm"],
                                               cache_l["conv"])
            cache_l["ssm"].copy_(st)
            cache_l["conv"].copy_(conv)
            mix = _mix_hybrid(mix, s, lp)
    x = x + mix
    ff, _ = _ffn(rms_norm(x, lp["ln2"]), lp, cfg, dropless=True)
    return x + ff


def decode_step(params: Params, cfg: ArchConfig, cache: Cache,
                tokens: torch.Tensor, cur_len: torch.Tensor | int,
                spec: CacheSpec) -> tuple[torch.Tensor, Cache]:
    """One serve step: tokens (B, 1) int → (logits (B, V), cache), the
    cache updated in place at position ``cur_len``: a 0-d int64 tensor on
    the cache's device, or an int, which becomes one. Nothing is read back
    to the host. An encoder raises (:func:`check_decoder`)."""
    check_decoder(cfg)
    x = embed_tokens(params, cfg, tokens[:, 0])
    cur_len = torch.as_tensor(cur_len, dtype=torch.int64, device=x.device)
    x = decode_blocks(params, cfg, cache, x, cur_len, spec,
                      range(cfg.num_layers))
    return head_logits(params, x), cache


def decode_blocks(params: Params, cfg: ArchConfig, cache: Cache,
                  x: torch.Tensor, cur_len: torch.Tensor, spec: CacheSpec,
                  layers: range) -> torch.Tensor:
    """One token through ``layers``: x (B, d) → (B, d), each layer's cache
    entries updated in place at ``cur_len`` (a 0-d int64 tensor)."""
    windows = layer_windows(cfg)
    for i in layers:
        x = decode_block_apply(x, layer_params(params, i), cfg, windows[i],
                               {key: t[i] for key, t in cache.items()},
                               cur_len, spec)
    return x
