"""Batched serving engine: prefill → decode with a chunked KV cache.

``make_serve_step`` builds the single-token step, run eagerly;
``ServeEngine`` is the runnable engine — batched requests,
prefill-into-cache, greedy or temperature sampling, per-request
completion tracking.

The engine runs its prefill and its decode step as programs with static
buffers, the counterpart of the reference's jitted steps: one
:class:`DecodeProgram` per batch size (tokens ``(B, 1)``, the position,
the cache, the logits ``(B, V)``) and one :class:`PrefillProgram` per
(batch, prompt length), which fills the decode program's cache in place;
the :data:`PREFILL_PROGRAMS` most recently used are kept. On a CUDA device
each program's first call runs its body once, as the capture's warm-up,
and records it into a CUDA graph; every later call replays the graph. A
capture that fails raises: there is no eager path on the card. On the CPU
the same bodies run eagerly, with the kernels' plain versions.

Communication goes through an optional
:class:`~repro_torch.comm.session.CommSession`: ``ServeEngine.migrate_kv``
moves a populated KV cache between logical devices over the session's
captured multi-path graphs (the prefill→decode disaggregation
primitive). All leaves (keys and values; beside them a hybrid model's
float32 SSM state and conv inputs; or RWKV-6's state and shift) are
fused into ONE transfer group — one captured graph and one replay per
migration, regardless of leaf count or dtype.

Under an ambient :class:`~repro_torch.launch.mesh.LogicalMesh` with a
model axis the engine runs unchanged: an MoE model's layers are expert
parallel (:mod:`~repro_torch.models.moe_dist`), and each layer's combine,
one psum through the mesh's session, is recorded into the programs'
graphs as the ring's own kernel launches. :func:`pick_kv_chunks` picks
the split-KV chunk count for a mesh.

``make_captured_decode_step`` captures one decode step — the
``flash_attention`` kernel beside a KV-chunk migration — as ONE CUDA
graph per call.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import TYPE_CHECKING, Callable, Sequence

import torch

from repro_torch.comm.capture import BufferSpec, axis_index, dtype_name
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels._graph import GraphProgram
from repro_torch.kernels.flash_attention.ops import captured_flash_attention
from repro_torch.models import transformer as tfm
from repro_torch.training import sharding as shd

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.comm.capture import CapturedStep
    from repro_torch.comm.session import CommSession
    from repro_torch.launch.mesh import LogicalMesh


def pick_kv_chunks(cfg: ArchConfig, mesh: "LogicalMesh", batch: int,
                   max_len: int) -> int:
    """Chunk count for the split-KV decode cache: the model axis when the
    batch carries the DP axes, every mesh axis when batch is unshardable
    (long-context batch=1)."""
    model = mesh.shape.get("model", 1)
    dp = shd.axis_size(mesh, shd.dp_axes(mesh))
    chunks = model if (batch % dp == 0 and batch > 1) else model * dp
    while chunks > 1 and max_len % chunks:
        chunks //= 2
    return max(1, chunks)


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
    ``(num_devices, *local)`` tensors (on a peer session, lists of
    ``num_devices`` local tensors, tensor *d* on ``devices[d]``, in and
    out); every call is ONE engine dispatch (one CUDA-graph replay on the
    card, one a card over peers). ``new_kv`` equals ``kv``
    everywhere except device ``dst``, which receives device ``src``'s
    chunk. The attention node's ``cost_ns`` is stamped from
    ``comm.telemetry``'s recorded ``flash_attention`` median (0 while it
    holds none), as the reference's step does.
    """
    n = comm.engine.num_devices
    if not 0 <= src < n or not 0 <= dst < n or src == dst:
        raise ValueError(f"need distinct src/dst in [0, {n}), got "
                         f"{src}/{dst}")

    def kv_stage(c):
        return c * torch.ones((), dtype=c.dtype, device=c.device)

    def kv_install(cur, mig):
        dev = axis_index(cur)[:, None]
        return torch.where(dev == dst, mig, cur)

    def build(cap):
        q = cap.input((batch, heads, kv_len, head_dim), dtype)
        k = cap.input((batch, heads, kv_len, head_dim), dtype)
        v = cap.input((batch, heads, kv_len, head_dim), dtype)
        kv = cap.input((kv_chunk,), dtype)
        attn = captured_flash_attention(cap, q, k, v,
                                        telemetry=comm.telemetry)
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


#: Prefill programs an engine keeps, the most recently used: on a CUDA
#: device each one's graph holds its activations and logits.
PREFILL_PROGRAMS = 4


class _ServeProgram(GraphProgram):
    """A serving step over static buffers. Calling it runs the body on
    the CPU; on a CUDA device the first call runs the body once as the
    capture's warm-up, records it into a CUDA graph and returns the
    warm-up's results, and every later call replays the graph. A capture
    that fails raises and leaves the program uncaptured. ``calls`` counts
    the calls and ``replays`` the graph replays among them."""

    def __init__(self, engine: "ServeEngine", cache: dict):
        self.cfg = engine.cfg
        self.params = engine.params
        self.spec = engine.spec
        self.device = engine.device
        self.cache = cache
        self.logits: torch.Tensor | None = None
        self.calls = 0
        self.replays = 0

    def outputs(self) -> list[torch.Tensor]:
        return [self.logits, *self.cache.values()]

    def __call__(self) -> torch.Tensor:
        """One execution; returns the logits (the graph's static buffer
        after a replay: read it before the next call)."""
        self.calls += 1
        if self._graphs:
            self.replay()
            self.replays += 1
            return self.logits
        self.run()
        first = self.logits
        if self.device.type == "cuda":
            self.record()
        return first


class PrefillProgram(_ServeProgram):
    """``prefill_forward`` of one (batch, prompt length) into a given
    cache: static tokens ``(B, S)`` in, logits ``(B, S, V)`` out, every
    entry of ``cache`` written in place."""

    def __init__(self, engine: "ServeEngine", cache: dict, batch: int,
                 length: int):
        super().__init__(engine, cache)
        self.tokens = torch.zeros((batch, length), dtype=torch.long,
                                  device=self.device)

    def inputs(self) -> list[torch.Tensor]:
        return [self.tokens]

    def run(self) -> None:
        self.logits, _ = tfm.prefill_forward(
            self.params, self.cfg, {"tokens": self.tokens}, self.spec,
            cache=self.cache)


class DecodeProgram(_ServeProgram):
    """``decode_step`` of one batch size on its own cache: static tokens
    ``(B, 1)`` and position ``cur_len`` (0-d int64) in, logits ``(B, V)``
    out, the cache written in place at ``cur_len``."""

    def __init__(self, engine: "ServeEngine", batch: int):
        super().__init__(engine, tfm.init_cache(engine.cfg, batch,
                                                engine.spec,
                                                device=engine.device))
        self.tokens = torch.zeros((batch, 1), dtype=torch.long,
                                  device=self.device)
        self.cur_len = torch.zeros((), dtype=torch.long, device=self.device)

    def inputs(self) -> list[torch.Tensor]:
        return [self.tokens, self.cur_len]

    def run(self) -> None:
        self.logits, _ = tfm.decode_step(self.params, self.cfg, self.cache,
                                         self.tokens, self.cur_len,
                                         self.spec)


class ServeEngine:
    """Minimal batched engine: pads a request batch to a common prompt
    length (left, with token 0, and no padding mask — as the reference
    does), prefills once, decodes until every request finishes.

    Runs on the device the parameters live on, through its
    :class:`PrefillProgram` and :class:`DecodeProgram` (captured CUDA
    graphs on the card). An encoder-only model (``causal=False``) has no
    decode step and raises ``ValueError``. Greedy sampling is ``argmax``; with
    ``temperature > 0`` tokens are drawn from a ``torch.Generator`` seeded
    by ``generate``'s ``seed`` (the reference draws from its own
    generator, so sampled tokens differ between the two packages; greedy
    ones agree). Sampling runs outside the programs, on their logits.
    """

    def __init__(self, cfg: ArchConfig, params, *, max_len: int = 256,
                 kv_chunks: int = 4, temperature: float = 0.0,
                 comm: "CommSession | None" = None):
        tfm.check_decoder(cfg)
        self.cfg = cfg
        self.params = params
        self.spec = tfm.cache_spec(cfg, max_len=max_len,
                                   kv_chunks=kv_chunks)
        self.temperature = temperature
        self.comm = comm
        #: Comm-health events (DESIGN §4.6) drained from the session
        #: after each migration / generation — link faults, retries,
        #: quarantines, re-admissions that happened under serving
        #: traffic. A migration keeps delivering through a link failure
        #: (the session re-plans on surviving routes); this log is how
        #: the serving layer surfaces that it happened.
        self.health_events: list[dict] = []
        self.device = params["embed"].device
        self._decodes: dict[int, DecodeProgram] = {}
        self._prefills: collections.OrderedDict[
            tuple[int, int], PrefillProgram] = collections.OrderedDict()

    def _drain_health(self) -> None:
        """Fold the comm session's pending health events into
        :attr:`health_events`. Draining clears the session-side log but
        preserves its windowed counters (``stats()['health']``)."""
        if self.comm is not None:
            self.health_events.extend(self.comm.drain_health_events())

    def decode_program(self, batch: int) -> DecodeProgram:
        """The decode program of ``batch`` requests, made at first use; its
        cache is the one every prefill program of that batch fills."""
        prog = self._decodes.get(batch)
        if prog is None:
            prog = self._decodes[batch] = DecodeProgram(self, batch)
        return prog

    def prefill_program(self, batch: int, length: int) -> PrefillProgram:
        """The prefill program of ``batch`` prompts of ``length`` tokens,
        made at first use, writing into :meth:`decode_program`'s cache;
        past :data:`PREFILL_PROGRAMS` the least recently used is
        dropped."""
        key = (batch, length)
        prog = self._prefills.pop(key, None)
        if prog is None:
            prog = PrefillProgram(self, self.decode_program(batch).cache,
                                  batch, length)
        self._prefills[key] = prog
        while len(self._prefills) > PREFILL_PROGRAMS:
            self._prefills.popitem(last=False)
        return prog

    def graph_bytes(self) -> int:
        """Device memory that the programs' captured graphs hold."""
        return sum(p.held_bytes for p in (*self._decodes.values(),
                                          *self._prefills.values()))

    def prefill(self, tokens):
        """Run the prefill forward pass: ``(B, S)`` prompt tokens →
        ``(logits, cache)``, new tensors that do not share memory with the
        engine's programs. The cache is what :meth:`migrate_kv` moves."""
        tokens = torch.as_tensor(tokens, dtype=torch.long)
        prog = self.prefill_program(*tokens.shape)
        prog.tokens.copy_(tokens)
        logits = prog()
        return logits.clone(), {k: t.clone() for k, t in prog.cache.items()}

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
        out = self.comm.send_pytree(cache, src, dst)
        self._drain_health()
        return out

    def _sample(self, logits: torch.Tensor,
                generator: torch.Generator | None) -> torch.Tensor:
        if self.temperature <= 0.0:
            return torch.argmax(logits, -1)
        probs = torch.softmax(logits.float() / self.temperature, -1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    def generate(self, requests: Sequence[Request],
                 seed: int = 0) -> list[Request]:
        """Serve ``requests`` as one batch: one prefill program call, then
        one decode program call per step until every request has its
        tokens. Completion depends on step counts only, so the tokens are
        read back to the host once, at the end."""
        reqs = list(requests)
        plen = max(len(r.prompt) for r in reqs)
        max_new = max(r.max_new_tokens for r in reqs)
        if (self.spec.kind == "chunked"
                and plen + max(max_new - 1, 0) > self.spec.max_len):
            raise ValueError(f"a {plen}-token prompt and {max_new} new "
                             f"tokens do not fit a cache of max_len "
                             f"{self.spec.max_len}")
        prefill = self.prefill_program(len(reqs), plen)
        prefill.tokens.copy_(torch.tensor(
            [([0] * (plen - len(r.prompt))) + r.prompt for r in reqs]))
        logits = prefill()
        decode = self.decode_program(len(reqs))
        gen = None
        if self.temperature > 0.0:
            gen = torch.Generator(device=self.device).manual_seed(seed)
        next_tok = self._sample(logits[:, -1], gen)
        drawn, taken = [], [[] for _ in reqs]
        for step in range(max_new):
            drawn.append(next_tok)
            for i, r in enumerate(reqs):
                if not r.done and step < r.max_new_tokens:
                    taken[i].append(step)
                    if step + 1 >= r.max_new_tokens:
                        r.done = True
            if all(r.done for r in reqs):
                break
            decode.tokens.copy_(next_tok[:, None])
            decode.cur_len.fill_(plen + step)
            next_tok = self._sample(decode(), gen)
        host = torch.stack(drawn).tolist() if drawn else []
        for i, r in enumerate(reqs):
            r.out.extend(host[step][i] for step in taken[i])
        self._drain_health()
        return reqs
