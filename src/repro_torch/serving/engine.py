"""Batched serving engine: prefill → decode with a chunked KV cache.

``make_serve_step`` builds the single-token step; ``ServeEngine`` is the
runnable engine — batched requests, prefill-into-cache, greedy or
temperature sampling, per-request completion tracking.

Communication goes through an optional
:class:`~repro_torch.comm.session.CommSession`: ``ServeEngine.migrate_kv``
moves a populated KV cache between logical devices over the session's
captured multi-path graphs (the prefill→decode disaggregation
primitive). All leaves are fused into ONE transfer group — one captured
graph and one replay per migration, regardless of leaf count.

``make_captured_decode_step`` captures one decode step — the
``flash_attention`` kernel beside a KV-chunk migration — as ONE CUDA
graph per call.
"""

from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING, Callable, Sequence

import torch

from repro_torch.comm.capture import BufferSpec, dtype_name
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import captured_flash_attention
from repro_torch.models import transformer as tfm

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.comm.capture import CapturedStep
    from repro_torch.comm.session import CommSession


def make_serve_step(cfg: ArchConfig, spec: tfm.CacheSpec) -> Callable:
    """serve_step(params, cache, tokens (B,1), cur_len) → (logits, cache);
    the cache is updated in place."""
    def serve_step(params, cache, tokens, cur_len):
        return tfm.decode_step(params, cfg, cache, tokens, cur_len, spec)
    return serve_step


def make_captured_decode_step(comm: "CommSession", *, batch: int,
                              heads: int, kv_len: int, head_dim: int,
                              kv_chunk: int, src: int, dst: int,
                              dtype=torch.float32,
                              schedule: str | None = None,
                              max_paths: int | None = None,
                              num_chunks: int | None = None
                              ) -> "CapturedStep":
    """Capture one decode step that migrates a KV chunk *behind* the
    attention kernel — the flagship overlap adopter.

    ONE heterogeneous graph per call: a flash-attention compute node on
    the local ``(batch, heads, kv_len, head_dim)`` q/k/v shards, and —
    on an *independent* dataflow path — a ``kv_chunk``-element KV
    migration ``src → dst`` (stage kernel → multipath exchange → install
    kernel), so the scheduler can run the migration copies beside
    attention.

    Returns ``step(q, k, v, kv) -> (attn, new_kv)`` over device-stacked
    ``(num_devices, *local)`` tensors; every call is ONE engine dispatch
    (one CUDA-graph replay on the card). ``new_kv`` equals ``kv``
    everywhere except device ``dst``, which receives device ``src``'s
    chunk.
    """
    n = comm.engine.num_devices
    if not 0 <= src < n or not 0 <= dst < n or src == dst:
        raise ValueError(f"need distinct src/dst in [0, {n}), got "
                         f"{src}/{dst}")

    def kv_stage(c):
        return c * torch.ones((), dtype=c.dtype, device=c.device)

    def kv_install(cur, mig):
        dev = torch.arange(cur.shape[0], device=cur.device)[:, None]
        return torch.where(dev == dst, mig, cur)

    def build(cap):
        q = cap.input((batch, heads, kv_len, head_dim), dtype)
        k = cap.input((batch, heads, kv_len, head_dim), dtype)
        v = cap.input((batch, heads, kv_len, head_dim), dtype)
        kv = cap.input((kv_chunk,), dtype)
        attn = captured_flash_attention(cap, q, k, v)
        staged = cap.kernel(kv_stage, kv, name="kv_stage", flops=kv_chunk)
        (moved,) = cap.exchange([(staged, src, dst)], max_paths=max_paths,
                                num_chunks=num_chunks)
        new_kv = cap.kernel(kv_install, kv, moved, name="kv_install",
                            out=BufferSpec((kv_chunk,), dtype_name(dtype)),
                            flops=kv_chunk)
        return attn, new_kv

    return comm.capture(build, schedule=schedule)


@dataclasses.dataclass
class Request:
    prompt: list[int]
    max_new_tokens: int = 16
    out: list[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Minimal batched engine: pads a request batch to a common prompt
    length (left, with token 0, and no padding mask — as the reference
    does), prefills once, decodes until every request finishes.

    Runs on the device the parameters live on. Greedy sampling is
    ``argmax``; with ``temperature > 0`` tokens are drawn from a
    ``torch.Generator`` seeded by ``generate``'s ``seed`` (the reference
    draws from its own generator, so sampled tokens differ between the
    two packages; greedy ones agree).
    """

    def __init__(self, cfg: ArchConfig, params, *, max_len: int = 256,
                 kv_chunks: int = 4, temperature: float = 0.0,
                 comm: "CommSession | None" = None):
        self.cfg = cfg
        self.params = params
        self.spec = tfm.cache_spec(cfg, max_len=max_len,
                                   kv_chunks=kv_chunks)
        self.temperature = temperature
        self.comm = comm
        #: Comm-health events from the session; draining them comes with
        #: the health slice, so the list stays empty.
        self.health_events: list[dict] = []
        self._decode = make_serve_step(cfg, self.spec)
        self.device = params["embed"].device

    def prefill(self, tokens):
        """Run the prefill forward pass: ``(B, S)`` prompt tokens →
        ``(logits, cache)``. The cache is what :meth:`migrate_kv` moves."""
        tokens = torch.as_tensor(tokens, dtype=torch.long,
                                 device=self.device)
        return tfm.prefill_forward(self.params, self.cfg,
                                   {"tokens": tokens}, self.spec)

    def migrate_kv(self, cache, src: int, dst: int):
        """Move a KV cache from logical device ``src`` to ``dst`` through
        the comm session's multi-path engine (prefill→decode
        disaggregation).

        All leaves ride ONE fused transfer group: a single captured graph
        (one plan-cache entry keyed on every leaf's plan) and a single
        dispatch per migration — steady-state migration of a same-shaped
        cache is one fast-path hit and one replay; check
        ``self.comm.stats()``. Empty caches and ``src == dst`` no-op.
        """
        if self.comm is None:
            raise ValueError("ServeEngine was built without a CommSession; "
                             "pass comm= to enable KV migration")
        return self.comm.send_pytree(cache, src, dst)

    def _sample(self, logits: torch.Tensor,
                generator: torch.Generator | None) -> torch.Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits, -1)
        probs = torch.softmax(logits.float() / self.temperature, -1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    def generate(self, requests: Sequence[Request],
                 seed: int = 0) -> list[Request]:
        reqs = list(requests)
        plen = max(len(r.prompt) for r in reqs)
        toks = [([0] * (plen - len(r.prompt))) + r.prompt for r in reqs]
        logits, cache = self.prefill(toks)
        gen = None
        if self.temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        cur = plen - 1
        next_tok = self._sample(logits[:, -1], gen)
        max_new = max(r.max_new_tokens for r in reqs)
        for step in range(max_new):
            host = next_tok.tolist()
            for i, r in enumerate(reqs):
                if not r.done and step < r.max_new_tokens:
                    r.out.append(int(host[i]))
                    if step + 1 >= r.max_new_tokens:
                        r.done = True
            if all(r.done for r in reqs):
                break
            cur = cur + 1
            logits, cache = self._decode(self.params, cache,
                                         next_tok[:, None], cur)
            next_tok = self._sample(logits, gen)
        return reqs
