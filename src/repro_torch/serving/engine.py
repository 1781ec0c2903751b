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

Under an ambient **peer mesh** (``make_host_mesh(..., devices=[...])``)
the engine serves expert and tensor parallel across the session's cards:
it takes whole parameters, which it places
(:func:`~repro_torch.training.sharding.place_params` with the config: a
card's own experts, its blocks of the dense leaves the model axis cuts,
:func:`~repro_torch.training.sharding.card_cuts`, and a replica of the
rest), or trees already placed so, one a card (any other cut raises).
Each program spans the cards: a static tokens buffer, position and cache
a card (the cache at the card's kv heads and its RWKV-6 heads' or Mamba
channels' states), and one body a card, that
card's prefill or decode step (``prefill_blocks`` / ``decode_blocks``)
on its own tree (:func:`~repro_torch.models.moe_dist.card_share` with
the card's cut), whose every MoE combine and tensor-parallel psum is the
card's share of one peer psum, and whose logits over its vocabulary
blocks are gathered by one all-gather, over the program's own
:class:`~repro_torch.comm.collectives.PeerRing`. On a CUDA card each
body is recorded as graphs of its card, one a segment of at most
:data:`GRAPH_LAYERS` layers, and the cards are ordered before every
replay; the first run, the capture's warm-up, runs
one host thread a card in lockstep at the ring's steps
(:func:`~repro_torch.comm.collectives.run_in_lockstep`) when there are
several. Callers write card 0's inputs (``tokens``, ``cur_len``); a
call stages them to every other card, and the logits are card 0's
(``devices[0]``'s), where ``generate`` samples; every card's are the
same bits. On the CPU the same bodies run eagerly with the plain
versions.

``make_captured_decode_step`` captures one decode step — the
``flash_attention`` kernel beside a KV-chunk migration — as ONE CUDA
graph per call.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
from typing import TYPE_CHECKING, Callable, Sequence

import torch

from repro_torch.comm import collectives as coll
from repro_torch.comm.capture import BufferSpec, axis_index, dtype_name
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels._graph import GraphProgram
from repro_torch.kernels.flash_attention.ops import captured_flash_attention
from repro_torch.launch.mesh import ambient_mesh, is_peer, set_mesh
from repro_torch.models import moe_dist
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


#: Layers a graph records under a peer mesh: each program is cut into
#: segments of at most this many layers, one CUDA graph a card a segment,
#: replayed segment by segment over the cards. On four H100s a prefill
#: graph of 8 or 12 Mixtral-8x22B layers a card replayed, and one of 24
#: or more crashed the process inside the graph launch (a segmentation
#: fault; the decode graph of 50 layers replayed). The cause is not
#: established; cut this way, 50 layers replay.
GRAPH_LAYERS = 8


class _ServeProgram(GraphProgram):
    """A serving step over static buffers. Calling it runs the body on
    the CPU; on a CUDA device the first call runs the body once as the
    capture's warm-up, records it into a CUDA graph and returns the
    warm-up's results, and every later call replays the graph. A capture
    that fails raises and leaves the program uncaptured. ``calls`` counts
    the calls and ``replays`` the graph replays among them.

    Under the engine's peer mesh the program spans its cards (the module
    docstring): per card ``c`` its inputs (:meth:`card_inputs`), cache
    ``caches[c]`` and tree; its layers cut into :attr:`segments` of at
    most :data:`GRAPH_LAYERS`, each with a :class:`~repro_torch.comm.
    collectives.PeerRing` of its own, one body a card a segment
    (:meth:`bodies`; a segment hands its output to the next through a
    static buffer a card). ``tokens``, ``cache`` and ``logits`` are card
    0's."""

    def __init__(self, engine: "ServeEngine", caches: list[dict]):
        self.cfg = engine.cfg
        self.spec = engine.spec
        self.mesh = engine.mesh
        self.trees = engine.trees
        self.cuts = engine.cuts
        self.params = self.trees[0]
        self._cards = engine.cards
        self.device = self._cards[0]
        self.caches = caches
        self.cache = caches[0]
        n = self.cfg.num_layers
        step = n if self.mesh is None else GRAPH_LAYERS
        #: ``range`` of layers of each segment.
        self.segments = [range(lo, min(lo + step, n))
                         for lo in range(0, max(n, 1), step)]
        self.rings = ([] if self.mesh is None else
                      [coll.PeerRing(self.mesh.session.engine)
                       for _ in self.segments])
        #: Each card's static hand-over between segments (None for one).
        self._x: list[torch.Tensor | None] = [None] * len(self._cards)
        self.logits: torch.Tensor | None = None
        #: Every card's logits (card 0's are :attr:`logits`).
        self.card_logits: list[torch.Tensor | None] = [None] * len(
            self._cards)
        self.calls = 0
        self.replays = 0

    @property
    def cards(self) -> tuple[torch.device, ...]:
        return self._cards

    def _handover(self, shape: tuple) -> None:
        """The static buffers a card between segments, ``shape`` each."""
        if len(self.segments) > 1:
            dt = tfm._dtype(self.cfg)
            self._x = [torch.zeros(shape, dtype=dt, device=card)
                       for card in self._cards]

    def card_inputs(self, card: int) -> list[torch.Tensor]:
        raise NotImplementedError

    def inputs(self) -> list[torch.Tensor]:
        return self.card_inputs(0)

    def outputs(self) -> list[torch.Tensor]:
        return [self.logits, *self.cache.values()]

    def embed(self, card: int) -> torch.Tensor:
        """Card ``card``'s first layer input."""
        raise NotImplementedError

    def blocks(self, card: int, x: torch.Tensor,
               layers: range) -> torch.Tensor:
        """``layers`` of card ``card``'s step on ``x``, its cache written
        in place."""
        raise NotImplementedError

    def body(self, card: int, seg: int = 0) -> None:
        """Segment ``seg`` of card ``card``'s step on its own tree, inputs
        and cache: the embeddings first, the logits last."""
        last = seg == len(self.segments) - 1
        x = self.embed(card) if seg == 0 else self._x[card]
        x = self.blocks(card, x, self.segments[seg])
        if not last:
            self._x[card].copy_(x)
            return
        logits = tfm.head_logits(self.trees[card], x)
        self.card_logits[card] = logits
        if card == 0:
            self.logits = logits

    def _share(self, seg: int, ring, card: int) -> None:
        with moe_dist.card_share(ring, card, self.cuts[card]):
            self.body(card, seg)

    def _run_card(self, card: int, seg: int) -> None:
        self.rings[seg].begin(card)
        self._share(seg, self.rings[seg], card)

    def run(self) -> None:
        """One execution without a graph: over every card, segment by
        segment, in lockstep on host threads a card when there are
        several."""
        if self.mesh is None:
            self.body(0)
            return
        for seg, ring in enumerate(self.rings):
            ring.begin()
            if len(self._cards) == 1:
                self._share(seg, ring, 0)
                continue
            lockstep = coll.LockstepRing(ring)
            coll.run_in_lockstep(lockstep, [
                (card, functools.partial(self._share, seg, lockstep))
                for card in self._cards])

    def bodies(self) -> list[tuple[torch.device, Callable[[], None]]]:
        if self.mesh is None:
            return [(self.device, self.run)]
        return [(card, functools.partial(self._run_card, c, seg))
                for seg in range(len(self.segments))
                for c, card in enumerate(self._cards)]

    def __call__(self) -> torch.Tensor:
        """One execution; returns the logits (the graph's static buffer
        after a replay: read it before the next call)."""
        self.calls += 1
        for c in range(1, len(self._cards)):
            for dst, src in zip(self.card_inputs(c), self.card_inputs(0)):
                dst.copy_(src)
        if self._graphs:
            self.replay()
            self.replays += 1
            return self.logits
        with (set_mesh(self.mesh) if self.mesh is not None
              else contextlib.nullcontext()):
            self.run()
            first = self.logits
            if self.device.type == "cuda":
                self.record()
        return first


class PrefillProgram(_ServeProgram):
    """``prefill_forward`` of one (batch, prompt length) into given
    caches (one a card): static tokens ``(B, S)`` in, logits ``(B, S,
    V)`` out, every entry of each cache written in place."""

    def __init__(self, engine: "ServeEngine", caches: list[dict],
                 batch: int, length: int):
        super().__init__(engine, caches)
        self._tokens = [torch.zeros((batch, length), dtype=torch.long,
                                    device=card) for card in self._cards]
        self.tokens = self._tokens[0]
        self._handover((batch, length, self.cfg.d_model))

    def card_inputs(self, card: int) -> list[torch.Tensor]:
        return [self._tokens[card]]

    def embed(self, card: int) -> torch.Tensor:
        return tfm.embed_inputs(self.trees[card], self.cfg,
                                {"tokens": self._tokens[card]})

    def blocks(self, card: int, x: torch.Tensor,
               layers: range) -> torch.Tensor:
        return tfm.prefill_blocks(self.trees[card], self.cfg, x, self.spec,
                                  self.caches[card], layers)


class DecodeProgram(_ServeProgram):
    """``decode_step`` of one batch size on its own caches (one a card):
    static tokens ``(B, 1)`` and position ``cur_len`` (0-d int64) in,
    logits ``(B, V)`` out, each cache written in place at ``cur_len``."""

    def __init__(self, engine: "ServeEngine", batch: int):
        super().__init__(engine, [
            tfm.init_cache(engine.cfg, batch, engine.spec, device=card,
                           cut=cut)
            for card, cut in zip(engine.cards, engine.cuts)])
        self._tokens = [torch.zeros((batch, 1), dtype=torch.long,
                                    device=card) for card in self._cards]
        self._cur_len = [torch.zeros((), dtype=torch.long, device=card)
                         for card in self._cards]
        self.tokens = self._tokens[0]
        self.cur_len = self._cur_len[0]
        self._handover((batch, self.cfg.d_model))

    def card_inputs(self, card: int) -> list[torch.Tensor]:
        return [self._tokens[card], self._cur_len[card]]

    def embed(self, card: int) -> torch.Tensor:
        return tfm.embed_tokens(self.trees[card], self.cfg,
                                self._tokens[card][:, 0])

    def blocks(self, card: int, x: torch.Tensor,
               layers: range) -> torch.Tensor:
        return tfm.decode_blocks(self.trees[card], self.cfg,
                                 self.caches[card], x, self._cur_len[card],
                                 self.spec, layers)


class ServeEngine:
    """Minimal batched engine: pads a request batch to a common prompt
    length (left, with token 0, and no padding mask — as the reference
    does), prefills once, decodes until every request finishes.

    Runs on the device the parameters live on, through its
    :class:`PrefillProgram` and :class:`DecodeProgram` (captured CUDA
    graphs on the card); under an ambient peer mesh on the mesh's cards,
    from ``params`` placed there (whole parameters, which it places, or
    one placed tree a card; the module docstring). An encoder-only model
    (``causal=False``) has no decode step and raises ``ValueError``.
    Greedy sampling is ``argmax``; with ``temperature > 0`` tokens are
    drawn from a ``torch.Generator`` seeded
    by ``generate``'s ``seed`` (the reference draws from its own
    generator, so sampled tokens differ between the two packages; greedy
    ones agree). Sampling runs outside the programs, on their logits.
    """

    def __init__(self, cfg: ArchConfig, params, *, max_len: int = 256,
                 kv_chunks: int = 4, temperature: float = 0.0,
                 comm: "CommSession | None" = None):
        tfm.check_decoder(cfg)
        self.cfg = cfg
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
        #: The ambient peer mesh the engine serves on, or None; its cards
        #: (one device for any other engine), one tree a card and each
        #: card's dense cut (None off a peer mesh).
        mesh = ambient_mesh()
        self.mesh = mesh if is_peer(mesh) else None
        if self.mesh is None:
            self.trees = [params]
            self.cards = (params["embed"].device,)
            self.cuts = [None]
        else:
            self.cards = shd._card_layout(mesh, "ServeEngine")[0]
            self.cuts = shd.card_cuts(cfg, mesh)
            if isinstance(params, (list, tuple)):
                self.trees = list(params)
                shd.check_placed(self.trees, mesh, cfg,
                                 tfm.param_shapes(cfg),
                                 "place_params(params, mesh, cfg)")
            else:
                self.trees = shd.place_params(params, mesh, cfg)
        self.params = self.trees[0]
        self.device = self.cards[0]
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
            prog = PrefillProgram(self, self.decode_program(batch).caches,
                                  batch, length)
        self._prefills[key] = prog
        while len(self._prefills) > PREFILL_PROGRAMS:
            self._prefills.popitem(last=False)
        return prog

    def graph_bytes(self) -> int:
        """Device memory that the programs' captured graphs hold (on every
        card)."""
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
