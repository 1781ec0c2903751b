"""Multi-path transfers across four peer cards, against single path.

Run from the root of a checkout on a machine with at least four CUDA cards
that reach each other (peer access; NVLink on an H100 host)::

    python3 tools/peer_smoke.py

It raises unless it sees four such cards. It builds the
``multipath_dma``, ``jacobi``, ``ring_allgather`` and ``flash_attention``
kernels, prints
``nvidia-smi topo -m`` (where that fails, ``topo -p2p n`` and then
``nvlink -s``) and every card's name and power limit, then drives a peer
session,
``CommSession(devices=["cuda:0", ..., "cuda:3"])`` (telemetry on, health
monitor off so that no plan changes mid-sweep), and prints:

* float32 sends 0→1 of 64 KiB, 1, 16, 64, 256 and 512 MiB (the OMB range
  of the paper), each with ``max_paths=1`` (the direct link) and the
  planner's default (several paths above its threshold: direct, and
  staged through cards 2 and 3), each received message bitwise the sent
  one; GB/s from the replay (CUDA events, replays back to back, every
  card's stream joined before the end event), the whole ``session.send``
  on the host clock, and one ``y.copy_(x)`` across the two cards (torch's
  peer copy) as the yardstick, beside the bound B / 450 GB/s (dst's NVLink
  ingress, data sheet), and a line a size: the single-path replay, its
  share of that bound, its ratio to the peer ``copy_``, and the
  multi-path replay with the multi/single ratio (of throughputs);
* the same for ``bidirectional`` (0→1 and 1→0 at once; the bound 2B /
  900 GB/s, the yardstick two peer copies, one each way);
* a 4-message ``exchange``, each card to the next, 64 MiB each;
* the session's collectives across the cards (a health-free
  ``CommSession(devices=cards)``): ``all_gather`` of 256 MiB float32,
  ``reduce_scatter``, ``all_reduce``, ``psum`` (an odd shape that pads)
  and ``all_to_all`` of 64 MiB, each twice (the second a cache hit), its
  result bitwise one card's stacked session's, one ``ring_allgather``
  launch a card a gather and one ``multipath_dma`` launch a card a ring
  shift; each program's replay timed by CUDA events (every card's stream
  joined before the end event) beside its bound, the bytes each card
  receives over its 450 GB/s ingress, the same collective through
  ``torch.cuda.nccl`` on per-card lists (``all_gather``,
  ``reduce_scatter``, ``all_reduce``; the all-to-all, which it lacks,
  as the 12 peer ``copy_`` of its blocks) and the stacked session's
  replay on one card;
* path A's Jacobi application, 4 blocks of (8, 2**22) float32, one block
  a card, 10 iterations, eagerly (``jacobi_step``) and as the captured
  step (``make_captured_jacobi_step`` on the peer session: one arena and
  one CUDA graph a card), each bitwise against one card's stacked run;
  an iteration timed by CUDA events: the captured step's replay on every
  card (events recorded after the replay's cross-card ordering, the
  slowest card's elapsed time), the eager peer iteration and the one-card
  captured step's replay;
* path F's migrating decode step across the cards (batch 1, 32 heads,
  2048 positions, head dim 128 bfloat16, an 8 MiB bfloat16 KV chunk
  0→2, schedule ``overlap``, whose copies fall in two runs with hop-1
  stages awaited across them): the KV chunk bitwise, attention within
  4e-3 + 8e-3·|want| of one card's stacked step, the replay timed the
  same way against the one-card step's;
* ``calibrate()`` on the sends' telemetry: the fitted bandwidth of every
  link that carried traffic, and the launch terms;
* a JSON line of every reading, then ``{"ok": true, "device": {...,
  "count": 4}}`` as the last line.

With ``--sweep`` it times the ``multipath_dma`` kernel's grid and tiles
instead (after the topology and the cards' names and power limits):

    python3 tools/peer_smoke.py --sweep            # about half a minute

The package's kernel runs the SWEEP_CASES tables (float32 0->1 sends: 64,
256 and 512 MiB single path, 512 MiB three paths, 512 MiB single path with
no fill, on the four cards; phase 9b's stacked 256 MiB send on card 0),
cut into tiles of each of SWEEP_TILES, on each of SWEEP_BLOCKS blocks a
card: each run bitwise (eager, then replayed), then timed as replays of
its graphs. One line a (case, tile), the best of each case, and every
reading in ``chiprun_out/peer_sweep.jsonl``. Then the peer
``ring_allgather`` of SWEEP_GATHERS (the 256 MiB all-gather's float32
shards, path S's combine gather's (1572864, 2) bfloat16 ones), one shard
a card, on each of SWEEP_BLOCKS blocks a card, bitwise its plain version,
timed as replays beside its ingress bound.

With ``--training`` it runs the training side a card instead (after the
topology, names and power limits; TF32 off)::

    python3 tools/peer_smoke.py --training         # a few minutes

On ``CommSession(devices=["cuda:0", ..., "cuda:3"])`` (health off), each
result held bit for bit to one card's stacked session where that fits,
each card's peak GiB printed:

* the captured DP step's arena a card for SmolLM-360M at full width and
  all 32 layers (reckoned from the recording on meta tensors), which
  must fit a card's memory;
* the eager DP step at 32 layers, bfloat16, 8 x 512 tokens (a replica a
  card, ``replicate_state``) against one card's eager DP step: every
  replica bitwise its state, ms a step in turns (host clock, synced) and
  by CUDA events on every card (the slowest card), tokens/s;
* the captured DP step at 2 layers against one card's stacked captured
  step, two steps chained: every replica bitwise its state after each,
  the same key, one dispatch; the replay and a call (fed the replicas)
  by CUDA events on every card against one card's replay and call;
* the captured DP step at 32 layers: its first call with the
  build, the replay and a call fed the replicas by CUDA events (the
  slowest card), tokens/s;
* path P's pipeline of Llama-3 8B (32 layers, 4 stages a card,
  ``place_stages``; 8 microbatches of (1, 2048), the planner's split):
  bitwise one card's stacked pipeline, one dispatch a handoff and one
  for the surfacing psum, ms a call in turns against one card's and one
  card's sequential ``block_apply``, a handoff's replay against a card's
  16 MiB at 450 GB/s;
* ``compressed_psum_tree`` over SmolLM-360M's leaves, a member a card,
  bitwise one card's stacked form, against the peer ``pmean`` of the
  same lists.

Every reading also goes to ``chiprun_out/peer_training.json``.

With ``--moe`` it serves Mixtral-8x22B expert parallel on a peer mesh
instead (after the topology, names and power limits; TF32 off)::

    python3 tools/peer_smoke.py --moe              # a few minutes

``make_host_mesh((1, 4), devices=cards)``: each card holds its logical
device's 2 experts a layer, its 12 of the 48 heads (2 of 8 kv heads)
and its quarter of the vocabulary, and a replica of the rest; each MoE
combine and attention's output is one peer psum a forward a layer, one
``ring_allgather`` launch a card, and the logits one more. Path S's
requests (4 prompts of 512/384/256/128 tokens, 32 new, greedy), full
width:

* at 8 layers, from path S's seeded weights (drawn whole on card 0 and
  placed by the engine), against one card's stacked path S
  (``make_host_mesh((1, 4), device=cards[0])`` in the same process):
  every card's logits the same bits, the distance from path S's logits
  and the greedy tokens that agree reported; then the same weights with
  every expert routed (``top_k`` 8, no discrete choice to flip), every
  card the same bits and the prefill's and a decode step's logits
  within TP_BOUND of the stacked run's largest;
* at the deepest depth the meta reckoning admits (each card's placed
  weights, its KV cache and its psums' and the logits' buffers, with
  SERVE_HEADROOM left for graphs and activations; at most 56 layers),
  the trees drawn layer by layer and placed without a whole model on
  any card: ``generate`` twice (the same tokens), every card's prefill
  and decode logits the same bits, the prefill replay and the captured
  decode step by CUDA events on every card (the slowest), tokens/s of
  the second ``generate``, ``ring_allgather`` launches a decode replay,
  each card's peak GiB, and one prefill and one decode replay under the
  profiler (device ms by kernel over the cards);
* one combine, a peer psum of path S's prefill rows (2048, 6144) and of
  a decode step's (4, 6144) bfloat16 a card: the call and its program's
  replay, against path S's 1.1031-1.4110 ms a layer.

Every reading also goes to ``chiprun_out/peer_moe.json``.

With ``--tp`` it serves Nemotron-4 340B tensor parallel on a peer mesh
instead (after the topology, names and power limits; TF32 off)::

    python3 tools/peer_smoke.py --tp               # about two minutes

``make_host_mesh((1, 4), devices=cards)``: each card holds its 24 of the
96 heads (2 of 8 kv heads), its 18432 of the 73728 hidden units and its
64000 of the 256000 vocabulary rows and columns; one peer psum after the
embedding and after attention and the MLP a layer, the logits gathered
once. Path O's requests (4 prompts of 512/384/256/128 tokens, 32 new,
greedy), full width:

* (a) at TP_CHECK_LAYERS (path O's 4) from path O's seeded weights,
  against one card's stacked engine in the same process: every card's
  prefill logits and a decode step's (from the stacked run's token) the
  same bits, within TP_BOUND of the stacked run's largest, the greedy
  tokens that agree, the prefill replay and captured decode step beside
  the stacked ones, ``ring_allgather`` launches a decode replay;
* (b) at the deepest depth the meta reckoning admits, the trees drawn
  layer by layer: as ``--moe``'s deep run, and the ring's kernels'
  device ms a card a psum from the profiler;
* one prefill psum (2048, 18432) and one decode psum (4, 18432) bfloat16
  a card: the call and its program's replay beside NCCL's all-reduce of
  the same operands, the bytes a card takes in at 450 GB/s and the
  dry-run's modeled term at one NVLink 4 link.

Every reading also goes to ``chiprun_out/peer_tp.json``.

With ``--tp-train`` it trains tensor parallel on a peer mesh instead
(after the topology, names and power limits; TF32 off)::

    python3 tools/peer_smoke.py --tp-train         # a few minutes

``make_train_step`` under ``make_host_mesh((1, 4), devices=cards)`` from
``place_state(state, mesh, cfg)``: each card holds its quarter of the
heads (and kv heads), of the MLP's hidden units and of the vocabulary,
with their gradients and AdamW moments, and a replica of the norms; one
peer psum (g) after the embedding, attention and the MLP a layer, their
backwards one peer psum (f) each, the loss from the cards' vocabulary
blocks (one gather of their log-sum-exps and one psum of the gold
logit), the clip norm one psum; 8 x 512 tokens, ``remat="full"``:

* (a) Llama-3 8B at full width over TP_TRAIN_CHECK_LAYERS layers, in
  float32 and then in bfloat16 (seeded weights, float32 moments), 3
  steps against one card's unsharded ``make_train_step`` from the same
  seed and batches (in the same process): every card's loss,
  ``grad_norm`` and replicated leaves the same bits, losses within path
  Z's rtol; in float32 step 1's gradients, each card's against its part
  of the unsharded step's, within TP_TRAIN_GRAD_REL of each leaf's
  largest |g|, and every updated parameter within path Z's limit but in
  AdamW's ε region (counted); in bfloat16 the gradients and parameters
  reported (the update's bfloat16 rounding moves them further);
* (b) Llama-3 8B whole (32 layers, vocabulary 128,256, float32 moments)
  and (c) Nemotron-4 340B at its whole vocabulary of 256,000 with
  bfloat16 moments, each at the deepest depth the meta reckoning admits
  (state, gradients, the update's new state, the psums' buffers and the
  activations, with TP_TRAIN_HEADROOM left; the trees drawn layer by
  layer): the first step, a step by CUDA events on every card (the
  slowest), tokens/s, each card's peak GiB against the reckoning,
  launches a step, one step under the profiler;
* one forward g psum and one backward f psum of (8, 512, 4096) bfloat16
  a card: each call by CUDA events and its ring kernels' device ms by the
  profiler, beside the same psum's replay, NCCL's all-reduce, the bytes a
  card takes in at 450 GB/s and the dry-run's one-link term.

Every reading also goes to ``chiprun_out/peer_tp_train.json``.

With ``--ssm-tp`` it serves and trains the state-space families tensor
parallel on a peer mesh instead (after the topology, names and power
limits; TF32 off)::

    python3 tools/peer_smoke.py --ssm-tp           # about ten minutes

RWKV-6 1.6B (24 layers, 32 heads of 64) and Hymba-1.5B (32 layers, d_i
1600, its 25 attention heads a replica), whole, under
``make_host_mesh((1, 4), devices=cards)``: each card holds a quarter of
each mixer (RWKV-6's 8 heads, Hymba's 400 Mamba channels, with their
decode states), of the MLP's hidden units and of the vocabulary:

* serving, paths G's and K's seeded weights and requests (32 new
  tokens, greedy): one card's unsharded engine, then the peer mesh's
  (:func:`against_stacked`: every card's logits the same bits, the
  distance from one card's reported beside TP_BOUND), the prefill
  replay, the captured decode step, tokens/s, ``ring_allgather``
  launches a decode replay, each card's peak GiB; then the twin of
  ``chip_smoke.py``'s path AD (its ``serve_twin``: RWKV-6 in float64
  through the scan's recurrence, Hymba in float32), the four cards'
  twin within TP_BOUND of the unsharded twin at every position and two
  faults' beyond it, the bfloat16 runs held by their median distance
  from it;
* training, 8 x 512 tokens, ``remat="full"``, seeded weights, float32
  moments: one card's unsharded step (as many steps as the four cards
  take, from their weights) and the four cards' (bfloat16, a step by
  CUDA events, tokens/s, each card's peak GiB, one step under the
  profiler, the losses finite wherever one card's are);
  ``rwkv6_scan_bwd`` at a card's 8 heads against its plain
  version; then 3 steps in float32 against one card's unsharded steps
  (``--tp-train``'s (a) at every layer: step 1's gradients within path
  M's float32 bound of each leaf's largest |g| (``chip_smoke.py``'s
  DP_GRAD_REL), Hymba's parameters at path Z's limits with AdamW's ε
  region counted and bounded, RWKV-6's within twice the summed lr, and
  RWKV-6's again with the scan's plain version on both sides).

Every reading also goes to ``chiprun_out/peer_ssm_tp.json``.

With ``--moe-train`` it trains Mixtral-8x22B expert parallel on a peer
mesh instead (after the topology, names and power limits; TF32 off)::

    python3 tools/peer_smoke.py --moe-train        # a few minutes

``make_train_step`` under ``make_host_mesh((1, 4), devices=cards)`` from
``place_state(state, mesh, cfg)``: each card holds its logical device's
2 experts a layer, its 12 of the 48 heads (2 of 8 kv heads) and its
quarter of the vocabulary, their gradients and AdamW moments, and a
replica of the rest; each MoE combine and attention's output is one peer
psum a forward, and its backward another (since the dense cut, held to
path Z's limits, not to PR 37's figures). Path Z's tokens (8 x 512),
full width:

* (a) at 1 layer in float32 (TF32 off; bfloat16 moments), 3 steps
  against one card's stacked mesh step from the same seed and batches
  (in the same process; float32, where bfloat16's rounding of the
  parameters would make path Z's limits a bit-for-bit test): losses
  within rtol 1e-3; step 1's gradients, each card's against the stacked
  step's, within 1e-5 of each leaf's largest |g|; every updated
  parameter within 2e-2 of the stacked update's largest |change|, but
  the elements whose stacked |g| fell under 1e-6 at some step (AdamW's
  eps region, where the order of the cross-card sums moves an update by
  up to its lr) held within twice the steps' summed lr and counted;
  every card's replicated leaves the same bits;
* (b) at the deepest depth the meta reckoning admits (each card's placed
  state, its gradients, the update's new state and temporaries and the
  psums' buffers, with MOE_TRAIN_HEADROOM left; the trees drawn layer by
  layer), bfloat16 with bfloat16 moments, ``remat="full"``: a step by
  CUDA events on every card (the slowest), tokens/s, each card's peak
  GiB, one step under the profiler, and one backward psum (float32 (T +
  E, d) a card, one a layer) and one forward combine, each as a call and
  its program's replay, beside the step's ms a layer.

Every reading also goes to ``chiprun_out/peer_moe_train.json``.

With ``--health`` it runs the §4.6 health ladder across the cards
instead (after the topology, names and power limits)::

    python3 tools/peer_smoke.py --health           # a few minutes

On ``CommSession(CommConfig(telemetry=True), devices=cards)`` (the
other modes keep the monitor off, so that no plan changes mid-sweep),
device times by CUDA events on every card (the slowest card):

* the healthy cost: 64 KiB sends 0->1 (host clock, synced) and 512 MiB
  sends (CUDA events) with the monitor on and off, in turns;
* a mid-traffic failure of (0, 1) over 512 MiB float32 sends 0->1 with
  the planner's paths: failed before send 3, restored before send 6,
  then (0, 1), (2, 1) and (3, 0) quarantined and readmitted by probes
  (each a captured send over exactly its link, across two cards), the
  pre-fault digest back as a plan-cache hit and a send of each probed
  plan a hit; every send bitwise on card 1 and split into plan + lower +
  schedule, capture (one graph a card) and backoff; the replay under
  the fault beside the healthy one and B / 450 GB/s (dst's ingress);
* path I's injected schedule over 20 sends of 16 MiB (its pinned
  counts, the CPU's);
* the host relay with every device link into card 1 failed, 512 MiB
  float32 0->1: the first call (pinned allocation included) and steady
  calls, GB/s, beside a plain ``x.to("cpu", non_blocking=True)`` on to
  card 1 (the yardstick; the relay as a ratio of it) and the bound, the
  bytes twice over PCIe Gen5 x16 at 64 GB/s a direction (data sheet);
* path F's migrating decode step through a failure of (0, 2): the
  re-captured ``PeerStepProgram`` (one graph a card), the KV chunk
  bitwise, attention against one card's stacked step, the replay healthy
  and under the fault;
* the droop monitor on healthy four-card traffic under a profile
  ``calibrate()`` fitted there: its measured/modeled ratios and any
  quarantine of a healthy link (reported; no threshold changes).

Every reading also goes to ``chiprun_out/peer_health.json``.

With ``--collectives`` it runs only the session's collectives (after the
topology, names and power limits), and ``--src DIR`` imports the package
from another checkout's ``src/`` (a parent commit unpacked by ``git
archive`` into a git-ignored directory), so that two versions run in
turns in one call::

    for s in .chip_work/parent/src src src .chip_work/parent/src; do
        python3 tools/peer_smoke.py --collectives --src $s; done
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
#: The package's ``src/``: this checkout's, or another's with ``--src``
#: (read before the package is imported).
SRC = os.path.abspath(sys.argv[sys.argv.index("--src") + 1]
                      if "--src" in sys.argv[:-1] else
                      os.path.join(ROOT, "src"))
sys.path.insert(0, SRC)

from repro_torch.comm import collectives as coll  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

def smoke():
    """This checkout's ``chip_smoke.py``, whose checks' helpers ``--ssm-tp``
    shares with its path AD."""
    if ROOT not in sys.path:
        sys.path.insert(1, ROOT)
    import chip_smoke
    return chip_smoke


#: H100 NVLink: 900 GB/s to the other cards of the host, 450 GB/s each way
#: (NVIDIA data sheet).
NVLINK_BYTES_PER_S = 450e9
KiB = 1 << 10
MiB = 1 << 20
SIZES = (64 * 1024, MiB, 16 * MiB, 64 * MiB, 256 * MiB, 512 * MiB)
#: H100 HBM3 (NVIDIA data sheet), the stacked table's bound.
HBM_BYTES_PER_S = 3.35e12

#: The sweep (``--sweep``): the blocks of the persistent grid a card and
#: the work table's tile bytes.
SWEEP_BLOCKS = (66, 132, 264)
SWEEP_TILES = (256 * KiB, MiB)
#: The sweep's tables, float32 0->1: (layout, bytes, max_paths, fill).
#: "peer" runs on the four cards, "stacked" on card 0 alone (phase 9b's
#: send).
SWEEP_CASES = (("peer", 64 * MiB, 1, "zero"), ("peer", 256 * MiB, 1, "zero"),
               ("peer", 512 * MiB, 1, "zero"),
               ("peer", 512 * MiB, None, "zero"),
               ("peer", 512 * MiB, 1, "none"),
               ("stacked", 256 * MiB, None, "zero"))
#: The sweep's peer gathers, one shard a card: (rows, f, dtype) — the 256
#: MiB all-gather's float32 shards and path S's combine gather's (rows, 2)
#: bfloat16 ones.
SWEEP_GATHERS = ((2048, 8192, torch.float32),
                 (1_572_864, 2, torch.bfloat16))


def check(cond: bool, msg: str) -> None:
    if not cond:
        print(f"FAIL: {msg}", flush=True)
        sys.exit(1)


def peer_cards(count: int = 4) -> list[torch.device]:
    """The first ``count`` cards; raises unless each reaches every other."""
    if not torch.cuda.is_available():
        raise RuntimeError("peer_smoke needs CUDA cards; none is available")
    if torch.cuda.device_count() < count:
        raise RuntimeError(f"peer_smoke needs {count} CUDA cards, found "
                           f"{torch.cuda.device_count()}")
    cards = [torch.device("cuda", i) for i in range(count)]
    for a in cards:
        for b in cards:
            if a != b and not torch.cuda.can_device_access_peer(a, b):
                raise RuntimeError(f"{a} has no peer access to {b}")
    return cards


def sync_all(cards) -> None:
    for c in cards:
        torch.cuda.synchronize(c)


def device_ms(fn, cards, iters: int, warmup: int = 2) -> float:
    """Mean ms of ``fn()`` over ``iters`` back-to-back calls: CUDA events
    on card 0's stream, every other card's stream joined to it before the
    end event."""
    for _ in range(warmup):
        fn()
    sync_all(cards)
    s0 = torch.cuda.current_stream(cards[0])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record(s0)
    for _ in range(iters):
        fn()
    for c in cards[1:]:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(c))
        s0.wait_event(ev)
    end.record(s0)
    sync_all(cards)
    return start.elapsed_time(end) / iters


def kernel_device_ms(fn, name: str, cards, iters: int = 10) -> float:
    """Mean device ms a launch of the kernels whose name holds ``name``
    over ``iters`` calls of ``fn`` under ``torch.profiler`` (every card's
    launches; a peer kernel's time includes its waits on other cards)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync_all(cards)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        sync_all(cards)
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and name in e.key]
    count = sum(e.count for e in hits)
    return sum(e.self_device_time_total for e in hits) / 1e3 / max(count, 1)


def host_ms(fn, cards, iters: int, warmup: int = 2) -> float:
    """Mean wall ms of ``fn()`` followed by a synchronize of every card."""
    for _ in range(warmup):
        fn()
        sync_all(cards)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        sync_all(cards)
    return (time.perf_counter() - t0) * 1e3 / iters


def replay_cards_ms(prog, iters: int, warmup: int = 2
                    ) -> tuple[float, list[float]]:
    """Mean ms of a replay of a program over several cards by CUDA events
    on every card: a start event on each card's stream once the first
    replay's cross-card ordering is enqueued, an end event after the last
    replay; returns the slowest card's elapsed time and each card's."""
    cards = prog.cards
    for _ in range(warmup):
        prog.replay()
    sync_all(cards)
    starts = [torch.cuda.Event(enable_timing=True) for _ in cards]
    ends = [torch.cuda.Event(enable_timing=True) for _ in cards]
    for i in range(iters):
        prog.order()
        if i == 0:
            for ev, c in zip(starts, cards):
                ev.record(torch.cuda.current_stream(c))
        for card, graph in prog._graphs:
            with torch.cuda.device(card):
                graph.replay()
    for ev, c in zip(ends, cards):
        ev.record(torch.cuda.current_stream(c))
    sync_all(cards)
    per = [a.elapsed_time(b) / iters for a, b in zip(starts, ends)]
    return max(per), per


def captured_steps(cards, stacked, u0, rows: int, cols: int, iters: int,
                   u_eager, gen) -> dict:
    """The captured Jacobi step and the migrating decode step on a peer
    session over ``cards`` (health off, no telemetry, so the sends'
    calibration samples stay the sends'), held to one card's stacked
    session and timed (module docstring)."""
    from repro_torch.comm import CommConfig, CommSession
    from repro_torch.core.halo import jacobi_step, make_captured_jacobi_step
    from repro_torch.serving.engine import make_captured_decode_step

    n = len(cards)
    sess = CommSession(CommConfig(health=False), devices=cards)
    one = make_captured_jacobi_step(stacked, rows, cols)
    step = make_captured_jacobi_step(sess, rows, cols)
    uc = u0
    for _ in range(iters):
        (uc,) = one(uc)
    blocks = [u0[i].to(cards[i]) for i in range(n)]
    for _ in range(iters):
        (blocks,) = step(blocks)
    sync_all(cards)
    check(all(b.device == c for b, c in zip(blocks, cards)),
          "captured Jacobi blocks left their cards")
    got = torch.stack([b.to(cards[0]) for b in blocks])
    check(torch.equal(got, uc) and torch.equal(got, u_eager),
          "captured peer Jacobi differs from one card's stacked run")
    prog = step.resolve().compiled.program
    runs = sum(len(r.program.launches) for r in prog.copy_runs)
    check(prog.replay_launches == {"jacobi": n, "multipath_dma": runs},
          f"captured peer Jacobi replay launches {prog.replay_launches}, "
          f"expected {n} jacobi and {runs} multipath_dma")
    cap_ms, per_card = replay_cards_ms(prog, 20)
    one_ms = device_ms(one.resolve().compiled.program.replay, cards[:1], 20)
    eager_ms = device_ms(lambda: jacobi_step(blocks, session=sess), cards,
                         10)
    out = {"jacobi": {
        "shape": [n, rows, cols], "iters": iters,
        "walk": [type(w).__name__ for w in prog.walk],
        "replay_launches": prog.replay_launches,
        "captured_replay_ms": cap_ms, "captured_replay_ms_per_card": per_card,
        "eager_iter_ms": eager_ms, "one_card_captured_replay_ms": one_ms}}
    print(f"captured Jacobi {n}x({rows},{cols}) f32, {iters} iterations on "
          f"{n} cards: bitwise the one-card stacked run (eager and "
          f"captured), per replay {prog.replay_launches}; an iteration "
          f"(CUDA events): captured replay {cap_ms:.4f} ms (slowest card; "
          f"each {[round(t, 4) for t in per_card]}), eager peer "
          f"jacobi_step {eager_ms:.4f} ms, one-card captured replay "
          f"{one_ms:.4f} ms", flush=True)
    del blocks, got, uc

    heads, kv_len, hd = 32, 2048, 128
    kv_chunk = 2 * 8 * kv_len * hd
    kw = dict(batch=1, heads=heads, kv_len=kv_len, head_dim=hd,
              kv_chunk=kv_chunk, src=0, dst=2, dtype=torch.bfloat16,
              schedule="overlap")
    q, k, v = (torch.randn(n, 1, heads, kv_len, hd, generator=gen,
                           device=cards[0]).to(torch.bfloat16)
               for _ in range(3))
    kv = torch.randn(n, kv_chunk, generator=gen, device=cards[0]).to(
        torch.bfloat16)
    one = make_captured_decode_step(stacked, **kw)
    want_attn, want_kv = one(q, k, v, kv)
    step = make_captured_decode_step(sess, **kw)
    per = [[t[i].to(cards[i]) for i in range(n)] for t in (q, k, v, kv)]
    for _ in range(2):
        attn, new_kv = step(*per)
    sync_all(cards)
    got_kv = torch.stack([t.to(cards[0]) for t in new_kv])
    check(torch.equal(got_kv, want_kv), "peer decode step: the KV chunk "
          "differs from one card's stacked step")
    expect = kv.clone()
    expect[2] = kv[0]
    check(torch.equal(got_kv, expect), "peer decode step: the KV chunk did "
          "not land bitwise on card 2")
    got_attn = torch.stack([t.to(cards[0]) for t in attn]).float()
    diff = (got_attn - want_attn.float()).abs()
    err = diff.max().item()
    check(bool((diff <= 4e-3 + 8e-3 * want_attn.float().abs()).all()),
          f"peer decode step attention: max abs err {err} against one "
          f"card's stacked step")
    entry = step.resolve()
    prog = entry.compiled.program
    run_of = {i: r for r, run in enumerate(prog.copy_runs)
              for i in run.nodes}
    cross = sum(1 for e in entry.graph.edges
                if e.kind == "hop" and run_of[e.src] != run_of[e.dst])
    cap_ms, per_card = replay_cards_ms(prog, 10)
    one_ms = device_ms(one.resolve().compiled.program.replay, cards[:1], 10)
    out["decode"] = {
        "walk": [type(w).__name__ for w in prog.walk],
        "cross_run_hops": cross, "replay_launches": prog.replay_launches,
        "attn_max_abs_err": err, "captured_replay_ms": cap_ms,
        "captured_replay_ms_per_card": per_card,
        "one_card_captured_replay_ms": one_ms}
    print(f"captured decode step across {n} cards (8 MiB bf16 KV chunk "
          f"0->2, overlap; walk {out['decode']['walk']}, {cross} hop "
          f"edges across copy runs): KV chunk bitwise, attention max abs "
          f"err {err} against one card's stacked step, per replay "
          f"{prog.replay_launches}; replay (CUDA events) {cap_ms:.4f} ms "
          f"(slowest card; each {[round(t, 4) for t in per_card]}), one-card "
          f"replay {one_ms:.4f} ms", flush=True)
    return out


def iters_for(nbytes: int) -> int:
    return max(5, min(200, (2 << 30) // max(nbytes, 1)))


def entry_for(sess, specs: tuple, max_paths):
    """The fast-path entry of a request (its signature's specs and
    ``max_paths``)."""
    for sig, (_, entry) in sess.engine._fastpath._store.items():
        if sig[1] == specs and sig[4] == max_paths:
            return entry
    raise KeyError(specs)


def routes(entry) -> list:
    return [[pa.route.via for pa in p.paths] for p in entry.plans]


def program_of(sess, op: str):
    """The cached program of the session's one collective ``op``."""
    (compiled,) = [c for k, c in zip(sess.cache.keys(), sess.cache.values())
                   if getattr(k, "key", k).op == op]
    return compiled.program


class TorchRing(coll.ListRing):
    """The ring steps of the per-device collectives as torch's peer
    ``copy_``s (the yardstick where NCCL is missing): a shift copies each
    part to its receiver's card, a gather every shard to every card."""

    def __init__(self, devices):
        self.devices = devices
        self.n = len(devices)

    def shift(self, *sends):
        n = self.n
        return [[parts[(d - s) % n].to(self.devices[d]) for d in range(n)]
                for parts, s in sends]

    def gather(self, shards):
        return [torch.stack([x.to(dev) for x in shards])
                for dev in self.devices]


def nccl_ms(op: str, parts: list, cards) -> float | None:
    """``torch.cuda.nccl``'s ``op`` on per-card operands, replays back to
    back (None when NCCL cannot take them)."""
    from torch.cuda import nccl

    if not nccl.is_available(parts):
        return None
    n = len(parts)
    if op == "all_gather":
        outs = [p.new_empty((n,) + tuple(p.shape)) for p in parts]
        return device_ms(lambda: nccl.all_gather(parts, outs), cards, 20)
    if op == "reduce_scatter":
        outs = [p.new_empty((p.shape[0] // n,) + tuple(p.shape[1:]))
                for p in parts]
        return device_ms(lambda: nccl.reduce_scatter(parts, outs), cards, 20)
    outs = [torch.empty_like(p) for p in parts]
    return device_ms(lambda: nccl.all_reduce(parts, outs), cards, 20)


def collectives(cards, gen) -> list[dict]:
    """The session's collectives across the cards against one card's
    stacked session, NCCL and their ingress bound; prints and returns a
    row a collective."""
    from repro_torch.comm import CommConfig, CommSession
    from repro_torch.kernels import _graph

    n = len(cards)
    sess = CommSession(CommConfig(health=False), devices=cards)
    stacked = CommSession(CommConfig(health=False), device=cards[0])

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=cards[0])

    calls = [("all_gather", randn(n * 2048, 8192), (n - 1) * 64 * MiB),
             ("reduce_scatter", randn(n * 512, 8192), 48 * MiB),
             ("all_reduce", randn(n * 512, 8192), 96 * MiB),
             ("psum", randn(4097, 4095), 96 * MiB),
             ("all_to_all", randn(n * n, 1 << 20), 12 * MiB)]
    rows = []
    for op, x, received in calls:
        want = getattr(stacked, op)(x)
        for _ in range(2):
            got = getattr(sess, op)(x)
            check(got.device == cards[0] and torch.equal(got, want),
                  f"{op} {tuple(x.shape)} across the cards differs from one "
                  f"card's stacked session")
        prog = program_of(sess, op)
        shifts = len(prog.ring.programs) - sum(
            type(p).__name__ == "PeerRingProgram" for p in prog.ring.programs)
        expect = {"multipath_dma": shifts * n,
                  "ring_allgather": (len(prog.ring.programs) - shifts) * n}
        check(prog.replay_launches == {k: v for k, v in expect.items() if v},
              f"{op}: launches a replay {prog.replay_launches}, expected "
              f"{expect}")
        before = _graph.launch_counts()
        rep = device_ms(prog.replay, cards, 20)
        after = _graph.launch_counts()
        check(all(after[k] - before[k] == 22 * v
                  for k, v in prog.replay_launches.items()),
              f"{op}: launch counters do not match 22 replays")
        one = device_ms(program_of(stacked, op).replay, cards[:1], 20)
        if op == "all_to_all":
            blocks = [[x.view(n, n, -1)[i, j].to(cards[i]) for j in range(n)]
                      for i in range(n)]
            dst = [[torch.empty(blocks[i][j].shape, device=cards[j])
                    for j in range(n)] for i in range(n)]

            def peer_copies():
                for i in range(n):
                    for j in range(n):
                        if i != j:
                            dst[i][j].copy_(blocks[i][j])

            library = None
            yard = device_ms(peer_copies, cards, 20)
        else:
            local = (x.view(n, -1, *x.shape[1:])
                     if op == "all_gather" else x)
            parts = [(local[i] if op == "all_gather" else local).to(c)
                     for i, c in enumerate(cards)]
            if op == "psum":
                parts = [p.reshape(-1) for p in parts]
            library = nccl_ms("all_reduce" if op == "psum" else op, parts,
                              cards)
            yard = None
            if library is None:
                print(f"{op}: torch.cuda.nccl cannot take the cards' "
                      f"tensors; timing the ring's peer copy_ and adds "
                      f"instead", flush=True)
                form = coll.FORMS[op]
                rows_ = ([local[i].to(c) for i, c in enumerate(cards)]
                         if op == "all_gather"
                         else [x.to(c) for c in cards])
                yard = device_ms(lambda: form(rows_, TorchRing(cards)),
                                 cards, 20)
        bound = received / NVLINK_BYTES_PER_S * 1e3
        row = {"op": op, "shape": list(x.shape), "received_bytes": received,
               "replay_ms": rep, "bound_ms": bound, "nccl_ms": library,
               "peer_copies_ms": yard, "one_card_stacked_ms": one,
               "launches": prog.replay_launches}
        rows.append(row)
        print(f"collective {op} {tuple(x.shape)} f32 on {n} cards: bitwise "
              f"one card's stacked; replay {rep:.4f} ms, bound {bound:.4f} "
              f"ms ({received} B into each card at 450 GB/s, "
              f"{bound / rep:.1%}), NCCL "
              f"{'n/a' if library is None else f'{library:.4f} ms'}"
              f"{'' if yard is None else f', peer copy_ {yard:.4f} ms'}"
              f", one card's stacked replay {one:.4f} ms; launches a "
              f"replay {prog.replay_launches}", flush=True)
        del want, got
    return rows


def sweep_program(case, tile: int, cards, peer_sess, stacked_sess, gen):
    """The program of one sweep case at ``tile`` bytes a tile, its input
    set, and a check that its outputs hold the message at dst and zeros
    (or nothing) elsewhere."""
    from repro_torch.kernels.multipath_dma import kernel as dk

    layout, nbytes, mp, fill = case
    n = nbytes // 4
    x = torch.randn(n, generator=gen, device=cards[0])
    spec = ((0, 1, n, "float32"),)
    if layout == "peer":
        peer_sess.send(x, 0, 1, max_paths=mp)
        graph = entry_for(peer_sess, spec, mp).graph
        table = dk.build_node_table(graph, [n], [4], 4, fill=fill,
                                    per_device=True, tile_bytes=tile)
        prog = dk.PeerDmaProgram(table, [torch.float32], cards)
        prog.inputs()[0][0][0].copy_(x)
        want = x.to(cards[1])

        def check() -> bool:
            outs = prog.outputs()[0]
            return torch.equal(outs[1][0], want) and all(
                o is None or not o.any() for d, o in enumerate(outs)
                if d != 1)
    else:
        stacked_sess.send(x, 0, 1, max_paths=mp)
        graph = entry_for(stacked_sess, spec, mp).graph
        table = dk.build_node_table(graph, [n], [4], 4, fill=fill,
                                    tile_bytes=tile)
        prog = dk.DmaProgram(table, [torch.float32], cards[0])
        prog.inputs()[0][0, 0].copy_(x)

        def check() -> bool:
            out = prog.outputs()[0][0]
            return torch.equal(out[1], x) and not out[[0, 2, 3]].any()
    return prog, graph, check


def time_grid(prog, blocks: int, cards, check, iters: int) -> float:
    """Replay ms of ``prog`` on ``blocks`` blocks a card; raises unless
    the eager run and a replay both pass ``check``."""
    from repro_torch.kernels.multipath_dma import kernel as dk

    peer = isinstance(prog, dk.PeerDmaProgram)
    if peer:
        prog.launches = [ln._replace(grid=max(1, min(blocks, len(ln.items))))
                         for ln in prog.launches]
    else:
        prog._grid = max(1, min(blocks, prog.table.num_items))
    run_cards = prog.cards
    ys = prog.y if peer else [prog.y]
    for attempt in ("run", "replay"):
        for y in ys:
            y.fill_(255)
        if attempt == "run":
            prog.run()
        else:
            prog.record()
            prog.replay()
        sync_all(run_cards)
        if not check():
            raise RuntimeError(f"sweep: {attempt} on {blocks} blocks is "
                               f"not bitwise the message")
    return device_ms(prog.replay, list(run_cards), iters)


def sweep_gathers(cards, out) -> None:
    """The peer ``ring_allgather`` of each of SWEEP_GATHERS on the four
    cards at SWEEP_BLOCKS blocks a card (each card's launch grid
    overridden), bitwise its plain version run and replayed, timed as
    replays of its graphs beside its ingress bound and the kernel's own
    device ms a card (profiler); a line a gather, every reading into
    ``out``."""
    from repro_torch.kernels.ring_allgather import kernel as rk

    gen = torch.Generator(device=cards[0]).manual_seed(1)
    n = len(cards)
    for rows, f, dt in SWEEP_GATHERS:
        shards = [torch.randn(rows, f, generator=gen, device=cards[0])
                  .to(dt).to(c) for c in cards]
        want = rk.ring_allgather_peer_plain(shards)
        size = rows * f * shards[0].element_size()
        bound = (n - 1) * size / NVLINK_BYTES_PER_S * 1e3
        times = []
        for blocks in SWEEP_BLOCKS:
            prog = rk.PeerRingProgram(rows, f, dt, cards)
            prog.launches = [ln._replace(grid=blocks)
                             for ln in prog.launches]
            for buf, x in zip(prog.x, shards):
                buf.copy_(x)
            for attempt in ("run", "replay"):
                for o in prog.out:
                    o.fill_(0)
                if attempt == "run":
                    prog.run()
                else:
                    prog.record()
                    prog.replay()
                sync_all(cards)
                check(all(torch.equal(o, w) for o, w in zip(prog.out, want))
                      and prog.completed_items() == prog.geometry.num_items,
                      f"sweep gather ({rows}, {f}) {dt} on {blocks} blocks:"
                      f" {attempt} not bitwise the plain version")
            ms = device_ms(prog.replay, cards, 20)
            kernel = kernel_device_ms(prog.replay, "ring_allgather_peer",
                                      cards)
            times.append((ms, kernel))
            out.write(json.dumps({
                "layout": "peer_gather", "shard": [rows, f],
                "dtype": str(dt), "blocks": blocks, "ms": ms,
                "kernel_device_ms": kernel, "bound_ms": bound,
                "chunk_bytes": prog.geometry.chunk_bytes}) + "\n")
            del prog
        print(f"sweep gather {n} x ({rows}, {f}) {str(dt)[6:]} on {n} "
              f"cards | " + " ".join(f"{b} blocks {ms:.4f} (kernel {k:.4f})"
                                     for b, (ms, k) in
                                     zip(SWEEP_BLOCKS, times))
              + f" ms | bound {bound:.4f} ms ({(n - 1) * size} B into each "
              f"card at 450 GB/s)", flush=True)
        del shards, want
        torch.cuda.empty_cache()


def sweep(cards) -> int:
    """Time the ``multipath_dma`` kernel on SWEEP_BLOCKS blocks a card
    over the SWEEP_CASES tables cut at each of SWEEP_TILES, every result
    bitwise, then the peer gathers (:func:`sweep_gathers`); prints a line
    a (case, tile) and writes every reading to
    ``chiprun_out/peer_sweep.jsonl``."""
    from repro_torch.comm import CommConfig, CommSession

    peer_sess = CommSession(CommConfig(health=False), devices=cards)
    stacked_sess = CommSession(CommConfig(health=False), device=cards[0])
    gen = torch.Generator(device=cards[0]).manual_seed(0)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    out_path = os.path.join(ROOT, "chiprun_out", "peer_sweep.jsonl")
    best = {}
    with open(out_path, "w") as out:
        for case in SWEEP_CASES:
            layout, nbytes, mp, fill = case
            for tile in SWEEP_TILES:
                prog, graph, check = sweep_program(case, tile, cards,
                                                   peer_sess, stacked_sess,
                                                   gen)
                if layout == "peer":
                    bound = nbytes / NVLINK_BYTES_PER_S * 1e3
                else:
                    reads, writes = prog.table.bytes_moved()
                    bound = (reads + writes) / HBM_BYTES_PER_S * 1e3
                iters = max(10, min(50, (4 << 30) // nbytes))
                times = [time_grid(prog, b, cards, check, iters)
                         for b in SWEEP_BLOCKS]
                for b, ms in zip(SWEEP_BLOCKS, times):
                    rec = {"layout": layout, "nbytes": nbytes,
                           "max_paths": mp, "fill": fill, "tile": tile,
                           "blocks": b, "ms": ms, "bound_ms": bound,
                           "copy_nodes": graph.num_copy_nodes}
                    out.write(json.dumps(rec) + "\n")
                    key = (layout, nbytes, mp, fill)
                    if key not in best or ms < best[key]["ms"]:
                        best[key] = rec
                print(f"sweep {layout} {nbytes >> 20} MiB max_paths={mp}"
                      f" fill={fill} tile {tile // KiB} KiB | "
                      + " ".join(f"{b} blocks {ms:.4f}"
                                 for b, ms in zip(SWEEP_BLOCKS, times))
                      + f" ms | bound {bound:.4f} ms", flush=True)
                del prog
                torch.cuda.empty_cache()
        sweep_gathers(cards, out)
    for key, rec in best.items():
        print(f"sweep best {key}: tile {rec['tile'] // KiB} KiB, "
              f"{rec['blocks']} blocks: {rec['ms']:.4f} ms "
              f"({rec['bound_ms'] / rec['ms']:.1%} of bound)", flush=True)
    return 0


#: ``--training``: the tokens of a step (SmolLM-360M, bfloat16).
TRAIN_BATCH, TRAIN_SEQ = 8, 512
#: ``--training``: the pipeline, path P's (Llama-3 8B in 4 stages, 8
#: microbatches of (1, 2048)).
PIPE_MICRO, PIPE_SEQ = 8, 2048


def same_tree(a, b, on) -> bool:
    """Every leaf of ``a`` bit for bit the leaf of ``b``, compared on the
    device ``on``, one leaf at a time."""
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x.to(on), y.to(on))
        for x, y in zip(la, lb))


def cards_call_ms(fn, cards, iters: int, warmup: int = 1
                  ) -> tuple[float, list[float]]:
    """Mean ms of ``fn()`` by CUDA events on every card (a start event on
    each card's stream before the first call, an end event after the
    last): the slowest card's and each card's."""
    for _ in range(warmup):
        fn()
    sync_all(cards)
    starts = [torch.cuda.Event(enable_timing=True) for _ in cards]
    ends = [torch.cuda.Event(enable_timing=True) for _ in cards]
    for ev, c in zip(starts, cards):
        ev.record(torch.cuda.current_stream(c))
    for _ in range(iters):
        fn()
    for ev, c in zip(ends, cards):
        ev.record(torch.cuda.current_stream(c))
    sync_all(cards)
    per = [a.elapsed_time(b) / iters for a, b in zip(starts, ends)]
    return max(per), per


def peaks_gib(cards) -> list[float]:
    return [round(torch.cuda.max_memory_allocated(c) / 2**30, 2)
            for c in cards]


def reset_peaks(cards) -> None:
    for c in cards:
        torch.cuda.reset_peak_memory_stats(c)


def free(cards) -> None:
    import gc
    gc.collect()
    for c in cards:
        with torch.cuda.device(c):
            torch.cuda.empty_cache()
    reset_peaks(cards)


def arena_a_card(cfg, ts, opt, sess) -> int:
    """The bytes of one logical device's arena of the captured DP step of
    ``cfg`` on the peer session ``sess``, reckoned from its recording on
    meta tensors (nothing allocated)."""
    from repro_torch.comm.capture import _arena_layout
    from repro_torch.training import make_captured_dp_train_step
    from repro_torch.training.train_step import state_shapes

    state = state_shapes(cfg, opt)
    batch = {k: torch.empty((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int32,
                            device="meta") for k in ("tokens", "labels")}
    batch["mask"] = torch.empty((TRAIN_BATCH, TRAIN_SEQ), device="meta")
    step = make_captured_dp_train_step(cfg, ts, opt, sess, state, batch)
    return _arena_layout(step.capture.capture, 1)[1]


def training(cards, smi) -> dict:
    """``--training``: the DP steps, the pipeline and the compressed mean
    on a peer session a card (module docstring)."""
    import dataclasses

    from repro_torch.comm import CommConfig, CommSession
    from repro_torch.configs import get_config
    from repro_torch.core.topology import Topology
    from repro_torch.data import DataConfig, SyntheticDataset, batch_to
    from repro_torch.models import transformer as tfm
    from repro_torch.models.transformer import param_shapes
    from repro_torch.optim import OptimConfig
    from repro_torch.optim import compression as comp
    from repro_torch.training import (TrainStepConfig, init_state,
                                      make_captured_dp_train_step,
                                      make_dp_train_step, replicate_state)
    from repro_torch.training.pipeline import (block_stages,
                                               make_block_stage_fn,
                                               pipeline_apply, place_stages)
    from repro_torch.tree import tree_map

    n, c0 = len(cards), cards[0]
    out: dict = {}
    full = get_config("smollm_360m")
    ts = TrainStepConfig()
    opt = OptimConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    tokens = TRAIN_BATCH * TRAIN_SEQ

    def peer_session():
        return CommSession(CommConfig(health=False), devices=cards)

    def batches(cfg, count):
        ds = SyntheticDataset(cfg, DataConfig(seq_len=TRAIN_SEQ,
                                              global_batch=TRAIN_BATCH))
        return [batch_to(ds.batch_at(i), c0) for i in range(count)]

    def fresh(cfg, seed):
        return init_state(cfg, opt, generator=torch.Generator(
            device=c0).manual_seed(seed), device=c0)

    # the captured step's arena a card at all 32 layers
    depth = full.num_layers
    arena = arena_a_card(full, ts, opt, peer_session())
    card_bytes = torch.cuda.get_device_properties(c0).total_memory
    out["arena_bytes_a_card"] = arena
    print(f"training: the captured DP step's arena a card (SmolLM-360M "
          f"full width, {depth} layers, bf16 params, float32 moments, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens over {n} cards): "
          f"{arena / 1e9:.2f} GB of the card's {card_bytes / 1e9:.2f} GB",
          flush=True)
    check(arena < card_bytes, f"the captured DP step's arena at {depth} "
          f"layers ({arena} B) does not fit a card ({card_bytes} B)")

    # the eager DP step at 32 layers against one card's
    bts = batches(full, 3)
    state = fresh(full, 61)
    stacked = CommSession(device=c0)
    sstep = make_dp_train_step(full, ts, opt, stacked)
    want, _ = sstep(state, bts[0])
    peer = peer_session()
    pstep = make_dp_train_step(full, ts, opt, peer)
    reps = replicate_state(state, peer)
    got, _ = pstep(reps, bts[0])
    sync_all(cards)
    check(all(r is not None and leaves(r)[0].device == c
              for r, c in zip(got, cards)), "eager DP: a replica left its "
          "card")
    check(all(same_tree(r, want, c0) for r in got),
          "eager DP at 32 layers: a replica differs from one card's step")
    del got, want
    turns: dict[str, list] = {}
    for label in ("one card", "peer", "peer", "one card"):
        fn = ((lambda: sstep(state, bts[1])) if label == "one card"
              else (lambda: pstep(reps, bts[1])))
        turns.setdefault(label, []).append(host_ms(fn, cards, 2, warmup=1))
    ev_ms, ev_per = cards_call_ms(lambda: pstep(reps, bts[1]), cards, 2)
    out["eager_dp_32"] = {"ms": turns, "events_ms": ev_ms,
                          "events_ms_per_card": ev_per,
                          "peak_gib": peaks_gib(cards)}
    print(f"training: eager DP step, SmolLM-360M full width, 32 layers, "
          f"bf16, {TRAIN_BATCH} x {TRAIN_SEQ}: {n} replicas a card, each "
          f"bitwise one card's eager DP step; ms a step in turns (host "
          f"clock, synced, mean of 2): {turns}; peer step by CUDA events "
          f"{ev_ms:.2f} ms (slowest card; each "
          f"{[round(t, 2) for t in ev_per]}), {tokens / ev_ms * 1e3:.0f} "
          f"tokens/s; peak GiB a card {out['eager_dp_32']['peak_gib']}",
          flush=True)
    del state, reps, sstep, pstep, stacked, peer, bts
    free(cards)

    # the captured DP step at 2 layers against one card's
    cfg2 = dataclasses.replace(full, num_layers=2)
    bts = batches(cfg2, 3)
    state = fresh(cfg2, 62)
    stacked = CommSession(device=c0)
    scap = make_captured_dp_train_step(cfg2, ts, opt, stacked, state,
                                       bts[0])
    want = [scap(state, bts[0])[0]]
    want.append(scap(want[0], bts[1])[0])
    one_prog = scap.capture.resolve().compiled.program
    one_ms = device_ms(one_prog.replay, cards[:1], 5)
    one_call = host_ms(lambda: scap(state, bts[1]), cards[:1], 3)
    s_key = scap.capture.resolve().key
    del scap, one_prog, stacked
    free(cards)
    peer = peer_session()
    pcap = make_captured_dp_train_step(cfg2, ts, opt, peer, state, bts[0])
    d0 = peer.stats()["dispatches"]
    reps, _ = pcap(state, bts[0])
    check(peer.stats()["dispatches"] == d0 + 1, "captured DP: not one "
          "dispatch a call")
    entry = pcap.capture.resolve()
    check(entry.key == s_key, "captured DP: key differs from one card's")
    check(all(same_tree(r, want[0], c0) for r in reps),
          "captured DP at 2 layers: a replica differs from one card's "
          "stacked step")
    reps, _ = pcap(reps, bts[1])
    check(all(same_tree(r, want[1], c0) for r in reps),
          "captured DP at 2 layers: a replica fed back differs from one "
          "card's stacked step fed its own state")
    del want
    rep_ms, rep_per = replay_cards_ms(entry.compiled.program, 5)
    ev_ms, ev_per = cards_call_ms(lambda: pcap(reps, bts[1]), cards, 3)
    out["captured_dp_2"] = {
        "one_card_replay_ms": one_ms, "one_card_call_ms": one_call,
        "replay_ms": rep_ms, "replay_ms_per_card": rep_per,
        "call_ms": ev_ms, "call_ms_per_card": ev_per,
        "replay_launches": entry.compiled.program.replay_launches,
        "peak_gib": peaks_gib(cards)}
    print(f"training: captured DP step, full width, 2 layers, bf16: "
          f"every replica bitwise one card's stacked step over two chained "
          f"steps, the same key, one dispatch a call; replay (CUDA events) "
          f"{rep_ms:.2f} ms (slowest card; each "
          f"{[round(t, 2) for t in rep_per]}) against one card's "
          f"{one_ms:.2f} ms; a call fed the replicas {ev_ms:.2f} ms "
          f"({tokens / ev_ms * 1e3:.0f} tokens/s) against one card's "
          f"{one_call:.2f} ms (host clock, synced); replay launches "
          f"{entry.compiled.program.replay_launches}; peak GiB a card "
          f"{out['captured_dp_2']['peak_gib']}", flush=True)
    del pcap, entry, reps, peer, state, bts
    free(cards)

    # the captured DP step at all 32 layers
    bts = batches(full, 3)
    state = fresh(full, 63)
    peer = peer_session()
    t0 = time.perf_counter()
    pcap = make_captured_dp_train_step(full, ts, opt, peer, state, bts[0])
    reps, m = pcap(state, bts[0])
    sync_all(cards)
    build_s = time.perf_counter() - t0
    check(torch.isfinite(m["loss"]).item(), "captured DP: loss not finite")
    del state
    prog = pcap.capture.resolve().compiled.program
    rep_ms, rep_per = replay_cards_ms(prog, 3)
    ev_ms, ev_per = cards_call_ms(lambda: pcap(reps, bts[1]), cards, 3)
    reps, m = pcap(reps, bts[2])
    check(torch.isfinite(m["loss"]).item(), "captured DP: loss not finite")
    out["captured_dp"] = {
        "layers": depth, "arena_bytes_a_card": arena,
        "build_s": build_s, "replay_ms": rep_ms,
        "replay_ms_per_card": rep_per, "call_ms": ev_ms,
        "call_ms_per_card": ev_per, "tokens_per_s": tokens / ev_ms * 1e3,
        "replay_launches": prog.replay_launches,
        "peak_gib": peaks_gib(cards)}
    print(f"training: captured DP step, full width, {depth} layers, bf16, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ}, one arena of "
          f"{arena / 1e9:.2f} GB a card (first call {build_s:.1f} "
          f"s with the build): replay (CUDA events) {rep_ms:.2f} ms "
          f"(slowest card; each {[round(t, 2) for t in rep_per]}); a call "
          f"fed the replicas {ev_ms:.2f} ms (slowest card; each "
          f"{[round(t, 2) for t in ev_per]}) = "
          f"{out['captured_dp']['tokens_per_s']:.0f} tokens/s; loss "
          f"{float(m['loss'])!r}; replay launches {prog.replay_launches}; "
          f"peak GiB a card {out['captured_dp']['peak_gib']}", flush=True)
    del pcap, prog, reps, peer, bts, m
    free(cards)

    # the pipeline of Llama-3 8B, a stage a card
    cfg = get_config("llama3_8b")
    p, mb, s = n, PIPE_MICRO, PIPE_SEQ
    gen = torch.Generator(device=c0).manual_seed(0)
    params = {"layers": tfm.block_init(cfg, generator=gen, device=c0,
                                       lead=(cfg.num_layers,))}
    x = torch.randn(mb, 1, s, cfg.d_model, generator=gen, device=c0).mul_(
        cfg.d_model ** -0.5).to(torch.bfloat16)
    positions = torch.arange(s, device=c0)
    stage_fn = make_block_stage_fn(cfg, p, positions)
    stages = block_stages(params, p)
    stacked = CommSession(device=c0, topology=Topology.full_mesh(p))
    peer = peer_session()
    placed = place_stages(stages, peer)

    def sequential():
        hs = []
        for i in range(mb):
            h = x[i]
            for j in range(cfg.num_layers):
                h, _ = tfm.block_apply(h, tfm.layer_params(params, j), cfg,
                                       -1, positions)
            hs.append(h)
        return torch.stack(hs)

    def piped(sess, st):
        return pipeline_apply(stage_fn, st, x, microbatches=mb,
                              multipath=True, session=sess)

    ticks = mb + p - 1
    with torch.no_grad():
        want = piped(stacked, stages)
        d0 = peer.stats()["dispatches"]
        got = piped(peer, placed)
        sync_all(cards)
        disp = peer.stats()["dispatches"] - d0
        check(torch.equal(got, want), "pipeline: a stage a card differs "
              "from one card's stacked pipeline")
        check(disp == ticks + 1, f"pipeline: {disp} dispatches, want "
              f"{ticks + 1}")
        turns = {}
        for label in ("one card", "peer", "peer", "one card"):
            fn = ((lambda: piped(stacked, stages)) if label == "one card"
                  else (lambda: piped(peer, placed)))
            turns.setdefault(label, []).append(host_ms(fn, cards, 1,
                                                       warmup=0))
        seq_ms = host_ms(sequential, cards[:1], 1, warmup=0)
        ev_ms, ev_per = cards_call_ms(lambda: piped(peer, placed), cards, 1,
                                      warmup=0)
        handoffs = [e for _, e in peer.engine._fastpath._store.values()
                    if getattr(e, "plans", None) and len(e.plans) == p]
        hand = handoffs[0].compiled.program
        nbytes = s * cfg.d_model * 2
        hand_ms, hand_per = replay_cards_ms(hand, 20)
    bound = nbytes / NVLINK_BYTES_PER_S * 1e3
    out["pipeline"] = {
        "ms": turns, "sequential_ms": seq_ms, "events_ms": ev_ms,
        "events_ms_per_card": ev_per, "dispatches": disp,
        "handoff_replay_ms": hand_ms, "handoff_replay_ms_per_card":
            hand_per, "handoff_bytes_a_card": nbytes,
        "handoff_bound_ms": bound,
        "handoff_paths": [len(pl.paths) for pl in handoffs[0].plans],
        "peak_gib": peaks_gib(cards)}
    print(f"training: pipeline of Llama-3 8B, {cfg.num_layers} layers in "
          f"{p} stages a card, {mb} microbatches of (1, {s}), the planner's "
          f"split: bitwise one card's stacked pipeline, {disp} dispatches; "
          f"ms a call in turns (host clock, synced): {turns}; by CUDA "
          f"events {ev_ms:.2f} ms (slowest card; each "
          f"{[round(t, 2) for t in ev_per]}); one card's sequential "
          f"block_apply {seq_ms:.2f} ms; a handoff ({p} x "
          f"{nbytes / MiB:.0f} MiB, paths {out['pipeline']['handoff_paths']}"
          f") replay {hand_ms:.4f} ms (slowest card) against {bound:.4f} ms "
          f"for a card's {nbytes / MiB:.0f} MiB at 450 GB/s "
          f"({bound / hand_ms:.1%}); peak GiB a card "
          f"{out['pipeline']['peak_gib']}", flush=True)
    del params, stages, placed, x, want, got, stacked, peer, hand, handoffs
    free(cards)

    # the compressed mean against the peer pmean of the same tree
    peer = peer_session()
    members = []
    for i, c in enumerate(cards):
        g = torch.Generator(device=c).manual_seed(70 + i)
        members.append(tree_map(lambda t: torch.randn(
            tuple(t.shape), generator=g, device=c).mul_(0.01),
            param_shapes(full)))
    got = comp.compressed_psum_tree(members, peer)
    stacked = CommSession(device=c0, topology=Topology.full_mesh(n))
    want = comp.compressed_psum_tree(tree_map(
        lambda *rows: torch.stack([r.to(c0) for r in rows]), *members),
        stacked)
    check(all(leaves(g)[0].device == c for g, c in zip(got, cards))
          and all(same_tree(g, tree_map(lambda t, d=d: t[d], want), c0)
                  for d, g in enumerate(got)),
          "compressed mean: a member's mean differs from its row of one "
          "card's stacked form")
    del want
    tree_ms = host_ms(lambda: comp.compressed_psum_tree(members, peer),
                      cards, 3)
    pmean_ms = host_ms(lambda: [peer.collectives.pmean(list(r)) for r in
                                zip(*map(leaves, members))], cards, 3)
    nbytes = sum(t.numel() * 4 for t in leaves(members[0]))
    out["compressed"] = {"tree_ms": tree_ms, "pmean_ms": pmean_ms,
                         "bytes_a_member": nbytes}
    print(f"training: compressed_psum_tree over SmolLM-360M's "
          f"{len(leaves(members[0]))} leaves, a member a card "
          f"({nbytes / 1e9:.2f} GB float32 each): bitwise one card's "
          f"stacked form; {tree_ms:.2f} ms a tree against the peer pmean "
          f"of the same lists {pmean_ms:.2f} ms (host clock, synced)",
          flush=True)
    del members, got, peer, stacked
    free(cards)
    out["cards"] = smi
    return out


#: ``--moe``: the depth at which one card's stacked path S runs beside
#: the peer mesh, path S's prompt lengths and new tokens, and the device
#: memory a card keeps beyond the reckoned weights, KV cache and combine
#: buffers (graphs, activations, the allocator's slack).
MOE_CHECK_LAYERS = 8
MOE_PROMPTS = (512, 384, 256, 128)
MOE_NEW = 32
#: The device memory a card keeps beyond the reckoned weights, caches and
#: psum and gather buffers when ``--moe`` and ``--tp`` serve at depth (the
#: graphs' pools, activations, the allocator's slack).
SERVE_HEADROOM = 10e9


def moe_prompts(cfg) -> list[list[int]]:
    """Path S's prompts: seeded token ids of MOE_PROMPTS lengths."""
    gen = torch.Generator().manual_seed(1)
    return [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
            for n in MOE_PROMPTS]


def moe_serve(engine, prompts, cards) -> dict:
    """``generate`` twice (host clock, every card synced), then one prefill
    program call on the padded prompts and one decode step after it:
    tokens, seconds, the two calls' logits and every card's."""
    from repro_torch.serving import Request

    times, outs = [], []
    for _ in range(2):
        t0 = time.perf_counter()
        res = engine.generate([Request(list(p), MOE_NEW) for p in prompts])
        sync_all(cards)
        times.append(time.perf_counter() - t0)
        outs.append([r.out for r in res])
    plen = max(len(p) for p in prompts)
    toks = torch.tensor([[0] * (plen - len(p)) + p for p in prompts],
                        device=engine.device)
    prefill = engine.prefill_program(*toks.shape)
    prefill.tokens.copy_(toks)
    logits = prefill().clone()
    prefill_cards = [t.clone() for t in prefill.card_logits]
    decode = engine.decode_program(toks.shape[0])
    decode.tokens.copy_(logits[:, -1].argmax(-1)[:, None])
    decode.cur_len.fill_(plen)
    step = decode().clone()
    decode_cards = [t.clone() for t in decode.card_logits]
    return {"outs": outs, "gen_s": times, "toks": toks, "logits": logits,
            "step": step, "prefill_cards": prefill_cards,
            "decode_cards": decode_cards}


def moe_times(engine, got: dict, cards) -> dict:
    """The prefill replay and the captured decode step (MOE_NEW - 1 greedy
    steps, the argmax and the staging included) by CUDA events on every
    card (the slowest card's), and the ``ring_allgather`` launches of one
    decode replay."""
    from repro_torch.kernels.ring_allgather import kernel as rk

    toks, logits = got["toks"], got["logits"]
    b, plen = toks.shape
    prefill = engine.prefill_program(b, plen)
    prefill.tokens.copy_(toks)
    prefill_ms, prefill_per = cards_call_ms(prefill, cards, 3)
    decode = engine.decode_program(b)

    def steps():
        tok = logits[:, -1].argmax(-1)[:, None]
        for i in range(MOE_NEW - 1):
            decode.tokens.copy_(tok)
            decode.cur_len.fill_(plen + i)
            tok = decode().argmax(-1)[:, None]

    prefill()
    steps_ms, steps_per = cards_call_ms(steps, cards, 2)
    before = rk.LAUNCHES
    decode()
    sync_all(cards)
    return {"prefill_ms": prefill_ms, "prefill_ms_cards": prefill_per,
            "decode_ms": steps_ms / (MOE_NEW - 1),
            "decode_ms_cards": [t / (MOE_NEW - 1) for t in steps_per],
            "gather_launches_a_decode": rk.LAUNCHES - before,
            "graph_gb": engine.graph_bytes() / 1e9,
            "prefill_profile": moe_profile(prefill, cards),
            "decode_profile": moe_profile(decode, cards)}


def moe_profile(fn, cards, top: int = 6) -> dict:
    """One call of ``fn`` (after one unprofiled) under ``torch.profiler``:
    the device ms of every card's kernels summed, their count, the ``top``
    kernels by device ms (a peer kernel's time includes its waits on the
    other cards), and the ring's kernels' ms (``multipath_dma``'s and
    ``ring_allgather``'s, prologues included) summed over the cards."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    sync_all(cards)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        sync_all(cards)
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and e.self_device_time_total > 0),
                  key=lambda r: -r[1])
    ring = {"multipath_dma": ("multipath_dma",),
            "ring_allgather": ("ring_allgather", "ring_peer")}
    return {"device_ms_all_cards": sum(ms for _, ms, _ in rows),
            "kernels": sum(c for *_, c in rows),
            "top": [(k[:60], round(ms, 4), c) for k, ms, c in rows[:top]],
            "by_kernel": {name: sum(ms for k, ms, _ in rows
                                    if any(p in k for p in prefixes))
                          for name, prefixes in ring.items()}}


def moe_combine(sess, cards, rows: int, d: int,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """One combine of ``rows x d`` ``dtype`` a card through the peer
    session's ``collectives.psum``: the call and its program's replay by
    CUDA events on every card (the slowest)."""
    gen = torch.Generator(device=cards[0]).manual_seed(3)
    parts = [torch.randn(rows, d, generator=gen, device=cards[0]).to(
        dtype).to(c) for c in cards]
    want = sum(p.to(cards[0]).float() for p in parts)
    got = sess.collectives.psum(parts)
    err = max((g.to(cards[0]).float() - want).abs().max().item()
              for g in got)
    check(all(torch.equal(g.to(cards[0]), got[0].to(cards[0]))
              for g in got), "the combine's results differ between cards")
    call_ms, _ = cards_call_ms(lambda: sess.collectives.psum(parts), cards,
                               10)
    replay_ms, _ = replay_cards_ms(program_of_shape(sess, (rows, d)), 10)
    return {"rows": rows, "d": d, "call_ms": call_ms,
            "replay_ms": replay_ms, "max_abs_vs_float_sum": err}


def program_of_shape(sess, local: tuple):
    """The cached peer psum program whose per-device input is ``local``."""
    for compiled in sess.cache.values():
        prog = getattr(compiled, "program", None)
        if getattr(prog, "x", None) and tuple(prog.x[0].shape) == local:
            return prog
    raise KeyError(local)


def moe_bitwise(cards, peer) -> dict:
    """``--moe`` at MOE_CHECK_LAYERS layers on path S's seeded weights: the
    served model (top 2 of 8 experts) on the peer mesh ``peer`` against
    one card's stacked path S, every card the same bits, its distance
    from path S reported (:func:`against_stacked`); then the same weights
    with every expert routed (``top_k`` 8, the gates the whole softmax),
    held within TP_BOUND of the stacked run's. Each card holds its
    attention heads and vocabulary blocks too, so the cards' psums add
    partial products, and a token whose two top experts are near-tied can
    take the other one under that rounding: a top-2 choice is not a
    continuous function of its input, so that token's output moves by
    O(1) and its neighbours' through attention. Routing every expert
    leaves no choice to flip and holds the rest of the path to the
    bound."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import ServeEngine

    c0 = cards[0]
    cfg = dataclasses.replace(get_config("mixtral_8x22b"),
                              num_layers=MOE_CHECK_LAYERS)
    prompts = moe_prompts(cfg)
    params = tfm.init_params(cfg, generator=torch.Generator(
        device=c0).manual_seed(0), device=c0)

    def stacked_then_peer(c, timed: bool):
        with set_mesh(make_host_mesh((1, 4), device=c0)):
            engine = ServeEngine(c, params, max_len=1024, kv_chunks=4)
            want = moe_serve(engine, prompts, [c0])
            stacked = moe_times(engine, want, [c0]) if timed else {}
            del engine
        free(cards)
        with set_mesh(peer):
            engine = ServeEngine(c, params, max_len=1024, kv_chunks=4)
            got = moe_serve(engine, prompts, cards)
            out = against_stacked(engine, got, want, cards)
            if timed:
                out.update(moe_times(engine, got, cards))
                out["peak_gib"] = peaks_gib(cards)
            del engine
        free(cards)
        out["stacked"] = stacked
        return out

    out = stacked_then_peer(cfg, True)
    stacked = out["stacked"]
    every = stacked_then_peer(dataclasses.replace(
        cfg, top_k=cfg.num_experts), False)
    out["every_expert_routed"] = every
    print(f"moe at {MOE_CHECK_LAYERS} layers on {peer} a card: every "
          f"card the same bits {out['every_card_same_bits']}; against one "
          f"card's stacked path S max abs err {out['max_abs_err']} (max "
          f"|logit| {out['max_abs_logit']}); greedy tokens agree in "
          f"{out['tokens_agree']} of {out['tokens']}; with every expert "
          f"routed: every card the same bits "
          f"{every['every_card_same_bits']}, max abs err "
          f"{every['max_abs_err']} (max |logit| {every['max_abs_logit']}, "
          f"bound {TP_BOUND} of it: {every['within_bound']}); prefill "
          f"replay {out['prefill_ms']:.2f} ms (one card's "
          f"{stacked['prefill_ms']:.2f}), captured decode step "
          f"{out['decode_ms']:.2f} ms ({stacked['decode_ms']:.2f}); "
          f"ring_allgather {out['gather_launches_a_decode']} launches a "
          f"decode replay; peak GiB a card {out['peak_gib']}", flush=True)
    check(out["every_card_same_bits"] and every["every_card_same_bits"]
          and every["within_bound"], f"moe at {MOE_CHECK_LAYERS} layers: "
          f"every card the same bits, and with every expert routed within "
          f"{TP_BOUND} of one card's stacked path S: {out}")
    del params
    free(cards)
    return out


def moe_deep(cards, peer) -> dict:
    """``--moe`` at the deepest depth the meta reckoning admits."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.serving import ServeEngine
    from repro_torch.training import sharding as shd

    c0 = cards[0]
    full = get_config("mixtral_8x22b")
    reck = serve_reckoning(full, peer, cards)
    depth = reck["layers"]
    print(f"moe reckoning (meta tensors, card 0 of 4): "
          f"{reck_text(reck, full)}", flush=True)
    cfg = dataclasses.replace(full, num_layers=depth)
    prompts = moe_prompts(cfg)
    t0 = time.perf_counter()
    trees = placed_trees(cfg, cards, seed=0,
                         cuts=shd.card_cuts(cfg, peer))
    build_s = time.perf_counter() - t0
    print(f"moe: {depth} layers drawn and placed a card in {build_s:.1f} "
          f"s; GiB a card {peaks_gib(cards)}", flush=True)
    reset_peaks(cards)
    with set_mesh(peer):
        engine = ServeEngine(cfg, trees, max_len=1024, kv_chunks=4)
        got = moe_serve(engine, prompts, cards)
        deep = moe_times(engine, got, cards)
        del engine
    gen1, gen2 = got["gen_s"]
    tokens = len(prompts) * MOE_NEW
    deep.update({
        "reckoning": reck, "layers": depth, "build_s": build_s,
        "generate_s": got["gen_s"], "tokens_per_s": tokens / gen2,
        "peak_gib": peaks_gib(cards),
        "same_tokens_twice": got["outs"][0] == got["outs"][1],
        "every_card_same_logits": all(
            torch.equal(t.to(c0), got["logits"])
            for t in got["prefill_cards"]) and all(
            torch.equal(t.to(c0), got["step"])
            for t in got["decode_cards"]),
        "logits_finite": bool(torch.isfinite(got["logits"]).all())})
    print(f"moe at {depth} layers on 4 cards: prefill replay "
          f"{deep['prefill_ms']:.2f} ms (cards "
          f"{[round(x, 2) for x in deep['prefill_ms_cards']]}), captured "
          f"decode step {deep['decode_ms']:.2f} ms (CUDA events, slowest "
          f"card), generate of {tokens} tokens {gen2:.3f} s = "
          f"{deep['tokens_per_s']:.1f} tokens/s (first {gen1:.3f} s, with "
          f"the captures); ring_allgather "
          f"{deep['gather_launches_a_decode']} launches a decode replay; "
          f"graphs {deep['graph_gb']:.2f} GB; peak GiB a card "
          f"{deep['peak_gib']}; same tokens twice "
          f"{deep['same_tokens_twice']}, every card's logits the same "
          f"bits {deep['every_card_same_logits']}", flush=True)
    for name in ("prefill", "decode"):
        prof = deep[f"{name}_profile"]
        print(f"moe at {depth} layers, profiler, one {name} replay: "
              f"{prof['device_ms_all_cards']:.2f} ms of device time over "
              f"the 4 cards in {prof['kernels']} kernels; top (name, ms, "
              f"count): {prof['top']}", flush=True)
    check(deep["same_tokens_twice"] and deep["every_card_same_logits"]
          and deep["logits_finite"], f"moe at {depth} layers: {deep}")
    psums = 1 + 2 * depth               # the embedding's, two a layer
    check(deep["gather_launches_a_decode"] == (psums + 1) * len(cards),
          f"moe: {deep['gather_launches_a_decode']} ring_allgather "
          f"launches a decode replay, not one a card a psum (the "
          f"embedding's, attention's and the combine a layer) and one for "
          f"the logits")
    del trees, got
    free(cards)
    return deep


def moe(cards, smi) -> dict:
    """``--moe``: Mixtral-8x22B served expert parallel on a peer mesh a
    card (module docstring)."""
    from repro_torch.launch.mesh import make_host_mesh

    peer = make_host_mesh((1, 4), devices=cards)
    d = 6144                                   # Mixtral-8x22B's d_model
    out = {"cards": smi, "peer_8": moe_bitwise(cards, peer),
           "deep": moe_deep(cards, peer),
           "combine": [moe_combine(peer.session, cards, rows, d)
                       for rows in (MOE_PROMPTS[0] * len(MOE_PROMPTS),
                                    len(MOE_PROMPTS))]}
    for row in out["combine"]:
        print(f"moe combine, a peer psum of ({row['rows']}, {row['d']}) "
              f"bfloat16 a card on 4 cards: the call {row['call_ms']:.4f} "
              f"ms, its program's replay {row['replay_ms']:.4f} ms (CUDA "
              f"events, slowest card; path S's combine on one card "
              f"1.1031-1.4110 ms a layer); every card the same bits, max "
              f"abs vs the float sum {row['max_abs_vs_float_sum']}",
              flush=True)
    return out


#: ``--moe-train``: path Z's tokens (8 x 512), the steps of the check
#: against one card's stacked step, the steps timed at depth (after one
#: warm-up that builds the ring's programs), and the device memory a card
#: keeps beyond the reckoned state, update and psum buffers (a layer's
#: recompute and backward, the logits, the allocator's slack).
MOE_TRAIN_TOKENS = (8, 512)
MOE_TRAIN_CHECK_STEPS = 3
MOE_TRAIN_TIMED = 2
MOE_TRAIN_HEADROOM = 8e9
#: Path Z's limits: the losses' relative difference, and a parameter's
#: largest difference over the stacked update's largest |change|.
MOE_TRAIN_LOSS_RTOL = 1e-3
MOE_TRAIN_DELTA_SHARE = 2e-2
#: (a)'s gradients at the first step: a card's largest difference from
#: the stacked step's over the leaf's largest |g| (float32, where only the
#: cross-card sums' order differs).
MOE_TRAIN_GRAD_REL = 1e-5
#: AdamW moves a parameter by lr · m / (sqrt(v) + eps): where |g| is near
#: eps = 1e-8 the slope is ~1/eps, so two summation orders a few 1e-9
#: apart move it by up to lr (chip_smoke.py's EPS_CONDITIONED, path J).
#: Where the stacked step's |g| fell below 100·eps at some step, (a) holds
#: a parameter within 2 x the steps' summed lr, and counts it.
MOE_TRAIN_EPS_CONDITIONED = 1e-6
#: Since the dense cut (PR 40) the cards also sum attention's and the
#: vocabulary's partial products, and step 1's gradients differ from the
#: reference step's by up to MOE_TRAIN_GRAD_REL of each leaf's largest |g|
#: (9.88e-6 measured on four cards). AdamW normalises an element's update
#: by its own gradient, so a relative gradient error e moves it by about
#: e·lr; path Z's limit takes e up to MOE_TRAIN_DELTA_SHARE. Where the
#: reference step's |g| fell below twice the share of the leaf's largest
#: at which that error reaches the limit (1e-3), (a) holds a parameter
#: as in the ε region.
MOE_TRAIN_COND_SHARE = 2 * MOE_TRAIN_GRAD_REL / MOE_TRAIN_DELTA_SHARE
#: How many of the compared parameter elements may take that exemption:
#: at most ``ceil(MOE_TRAIN_EXEMPT_SHARE · elements)``, the bound of
#: ``tests/test_torch_peer_moe_training.py``'s EPS_EXEMPT_SHARE. Measured
#: on four cards: 11,808 of 2.91 B (4.1e-6) after ``--moe-train``'s three
#: steps, 7,526 of 1.49 B (5.1e-6) after ``--tp-train``'s; 5,240 of
#: 1.49 B in ``chip_smoke.py``'s path AC.
MOE_TRAIN_EXEMPT_SHARE = 2e-5


def exempt_limit(elements: int) -> int:
    """The most of ``elements`` compared parameter elements that may take
    the ε-region exemption."""
    return math.ceil(MOE_TRAIN_EXEMPT_SHARE * elements)


def ill_conditioned(grads) -> list:
    """Per leaf of ``grads``, the elements whose AdamW update float
    rounding of the gradients may move beyond path Z's limit: |g| under
    MOE_TRAIN_EPS_CONDITIONED, or under MOE_TRAIN_COND_SHARE of the leaf's
    largest |g|."""
    out = []
    for g in leaves(grads):
        a = g.abs()
        out.append((a < MOE_TRAIN_EPS_CONDITIONED)
                   | (a < MOE_TRAIN_COND_SHARE * a.max()))
    return out


def moe_train_opt(cfg):
    from repro_torch.optim import OptimConfig
    return OptimConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                       moment_dtype=cfg.optimizer_dtype)


def moe_train_batches(cfg, dev, count: int) -> list[dict]:
    from repro_torch.data import DataConfig, SyntheticDataset, batch_to
    b, s = MOE_TRAIN_TOKENS
    ds = SyntheticDataset(cfg, DataConfig(seq_len=s, global_batch=b))
    return [batch_to(ds.batch_at(i), dev) for i in range(count)]


def moe_train_reckoning(cfg, cards) -> dict:
    """Card 0's bytes training ``L`` layers on the peer mesh of ``cards``
    (a logical device a card), reckoned on meta tensors: its placed state
    (parameters and AdamW moments, ``place_card`` of ``state_shapes``
    under the card's cut: its experts, heads and vocabulary blocks),
    the gradients (the parameters' bytes), the update's new parameters and
    moments and its float32 temporaries (nine of the largest leaf's or of
    ``UPDATE_SLICE`` elements), and three times each psum's operand a
    layer (a ring shift's send and receipt and the gather's replicas): the
    forward combine's ``(T, d)`` in the model's dtype and the backward's
    float32 ``(T + E, d)``, and the cut attention's three ``(T, d)`` (g
    forward and in the recompute, f backward). The deepest ``L`` of at
    most the config's whose bytes leave MOE_TRAIN_HEADROOM of the card."""
    import dataclasses
    import math

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim.adamw import UPDATE_SLICE
    from repro_torch.training.sharding import card_cuts, place_card
    from repro_torch.training.train_step import state_shapes

    opt = moe_train_opt(cfg)
    cut = card_cuts(cfg, make_host_mesh((1, len(cards)),
                                        devices=cards))[0]
    tokens = math.prod(MOE_TRAIN_TOKENS)
    elt = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()

    def card_bytes(layers):
        c = dataclasses.replace(cfg, num_layers=layers)
        tree = place_card(state_shapes(c, opt), [0], len(cards), "meta",
                          cut)
        params = sum(t.numel() * t.element_size()
                     for t in leaves(tree["params"]))
        moments = sum(t.numel() * t.element_size()
                      for t in leaves(tree["opt"]))
        largest = max(t.numel() for t in leaves(tree["params"]))
        temps = 9 * 4 * min(largest, UPDATE_SLICE)
        psums = 3 * layers * cfg.d_model * (
            tokens * elt * (1 + 3 * cut.heads)
            + (tokens + cfg.num_experts) * 4)
        return 3 * params + 2 * moments, temps, psums

    s0, t0, p0 = card_bytes(0)
    s1, t1, p1 = card_bytes(1)
    total = torch.cuda.mem_get_info(cards[0])[1]
    per_layer = (s1 - s0) + (p1 - p0)
    fixed = s0 + t1 + p0
    depth = min(cfg.num_layers,
                int((total - MOE_TRAIN_HEADROOM - fixed) // per_layer))
    return {"card_bytes": total, "fixed_bytes": fixed,
            "state_bytes_a_layer": s1 - s0, "psum_bytes_a_layer": p1 - p0,
            "update_temps_bytes": t1, "layers": depth,
            "reckoned_bytes": fixed + depth * per_layer}


def moe_train_steps(step, trees, batches, first=None
                    ) -> tuple[list, list[float]]:
    """``step`` over ``batches`` from ``trees``: the last trees and each
    step's card-0 loss; ``first(trees)``, given, is called after the first
    step."""
    losses = []
    for i, bt in enumerate(batches):
        trees, m = step(trees, bt)
        losses.append(float(m["loss"]))
        if i == 0 and first is not None:
            first(trees)
    return trees, losses


def param_diffs(got, want, bound: float, small) -> dict:
    """Leaf by leaf, ``got`` against ``want`` (host tensors): the largest
    difference and its leaf; the elements beyond ``bound``, those of them
    outside ``small`` (``bad``) and the largest difference of those
    inside."""
    out = {"worst": 0.0, "where": "", "beyond": 0, "bad": 0, "bad_worst": 0.0,
           "cond_worst": 0.0, "elements": 0}
    for i, (a, b, cond) in enumerate(zip(got, want, small)):
        out["elements"] += b.numel()
        diff = (a.float() - b.float()).abs()
        err = diff.max().item()
        if err >= out["worst"]:
            out["worst"], out["where"] = err, f"leaf {i} {tuple(b.shape)}"
        over = diff > bound
        bad = over & ~cond.to(over.device)
        out["beyond"] += int(over.sum())
        out["bad"] += int(bad.sum())
        out["bad_worst"] = max(out["bad_worst"], (diff * bad).max().item())
        out["cond_worst"] = max(out["cond_worst"],
                                (diff * (over & ~bad)).max().item())
    return out


def moe_train_check(cards, peer) -> dict:
    """``--moe-train`` (a): one layer at full width in float32 (TF32 off;
    bfloat16 moments), MOE_TRAIN_CHECK_STEPS steps on the four cards from
    ``place_state`` against one card's stacked mesh step from the same
    seed and batches: the losses, and every card's gradients at the first
    step (the combine's backward across cards) against the stacked step's
    (each card's cut against the same cut of the whole) within
    MOE_TRAIN_GRAD_REL of each leaf's largest |g|; the parameters after
    the first step at path Z's limit of that step's largest |change|, but
    for the elements of :func:`ill_conditioned` (AdamW's ε region and its
    elements with small gradients against the leaf's, where the
    cross-card sums' order moves an update by up to its lr), held within
    twice its lr and counted; after the last step every parameter within
    twice the steps' summed lr, the elements beyond path Z's limit
    counted (those of the first step's ε region moved by up to lr change
    the later steps' gradients beyond the first step's bound, so the
    later updates are not held to it); every card's replicated leaves the
    same bits."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels._graph import launch_counts
    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    from repro_torch.models import moe_dist
    from repro_torch.training import (TrainStepConfig, init_state,
                                      make_train_step)
    from repro_torch.training import sharding as shd
    from repro_torch.training import train_step as tsm
    from repro_torch.tree import leaves_with_paths

    c0 = cards[0]
    cfg = dataclasses.replace(get_config("mixtral_8x22b"), num_layers=1,
                              dtype="float32")
    opt = moe_train_opt(cfg)
    batches = moe_train_batches(cfg, c0, MOE_TRAIN_CHECK_STEPS)
    update = tsm._update
    seen: dict = {"cond": None, "grads": None, "lrs": [], "cards": {},
                  "first": {}}

    def stacked_update(params, grads, opt_state, opt_, **kw):
        small = ill_conditioned(grads)
        if seen["cond"] is None:
            seen["cond1"] = [t.cpu() for t in small]
        seen["cond"] = small if seen["cond"] is None else [
            a | b for a, b in zip(seen["cond"], small)]
        if seen["grads"] is None:
            seen["grads"] = [(path, g.cpu())
                             for path, g in leaves_with_paths(grads)]
        out = update(params, grads, opt_state, opt_, **kw)
        seen["lrs"].append(float(out[2]["lr"]))
        return out

    def peer_update(params, grads, opt_state, opt_, **kw):
        _, card = moe_dist._SHARE.run           # this thread's card share
        if card not in seen["cards"]:
            seen["cards"][card] = [g.cpu() for g in leaves(grads)]
        return update(params, grads, opt_state, opt_, **kw)

    def fresh():
        return init_state(cfg, opt, generator=torch.Generator(
            device=c0).manual_seed(71), device=c0)

    def step():
        return make_train_step(cfg, TrainStepConfig(), opt, device=c0)

    tsm._update = stacked_update
    try:
        with set_mesh(make_host_mesh((1, 4), device=c0)):
            want, want_losses = moe_train_steps(
                step(), fresh(), batches, lambda st: seen["first"].update(
                    want=[t.cpu() for t in leaves(st["params"])]))
    finally:
        tsm._update = update
    want = want["params"]
    free(cards)
    state = fresh()
    delta = max((a.float() - b.float()).abs().max().item()
                for a, b in zip(leaves(want), leaves(state["params"])))
    delta1 = max((a - b.cpu()).abs().max().item()
                 for a, b in zip(seen["first"]["want"],
                                 leaves(state["params"])))
    trees = shd.place_state(state, peer, cfg)
    cuts = shd.card_cuts(cfg, peer)
    del state
    before = launch_counts()
    tsm._update = peer_update
    try:
        with set_mesh(peer):
            trees, losses = moe_train_steps(
                step(), trees, batches, lambda tr: seen["first"].update(
                    got=[t.cpu() for t in leaves(shd.unplace_state(
                        tr, peer, cfg)["params"])]))
    finally:
        tsm._update = update
    sync_all(cards)
    launched = {k: (v - before[k]) / len(batches)
                for k, v in launch_counts().items() if v != before[k]}
    rep = [[t for path, t in leaves_with_paths(tree)
            if not shd.is_cut(path, cuts[0])] for tree in trees]
    replicas = all(torch.equal(a.to(c0), b)
                   for other in rep[1:] for a, b in zip(other, rep[0]))
    grad_rel = (0.0, "")
    for c in range(len(cards)):
        for (path, g), mine in zip(seen["grads"], seen["cards"][c]):
            ref = shd.cut_leaf(g, path, [c], len(cards), cuts[c])
            rel = ((mine - ref).abs().max().item()
                   / max(ref.abs().max().item(), 1e-30))
            grad_rel = max(grad_rel, (rel, f"card {c} {'/'.join(path)}"))
    got = shd.unplace_state(trees, peer, cfg)["params"]
    bound1, held1 = MOE_TRAIN_DELTA_SHARE * delta1, 2 * seen["lrs"][0]
    first = param_diffs(seen["first"]["got"], seen["first"]["want"],
                        bound1, seen["cond1"])
    bound, held = MOE_TRAIN_DELTA_SHARE * delta, 2 * sum(seen["lrs"])
    last = param_diffs(leaves(got), leaves(want), bound, seen["cond"])
    worst, where, beyond = last["worst"], last["where"], last["beyond"]
    cond_worst = max(last["cond_worst"], last["bad_worst"])
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    out = {"layers": 1, "dtype": "float32", "steps": len(batches),
           "losses": losses, "stacked_losses": want_losses,
           "loss_rel": loss_rel, "grad_rel_step1": grad_rel[0],
           "grad_rel_where": grad_rel[1], "worst_param_diff": worst,
           "worst_leaf": where, "stacked_delta": delta,
           "param_bound": bound, "elements_beyond_bound": beyond,
           "their_worst_diff": cond_worst, "conditioned_bound": held,
           "step1": {**first, "bound": bound1, "held": held1,
                     "delta": delta1},
           "replicas_bitwise": replicas, "launches_a_step": launched,
           "peak_gib": peaks_gib(cards)}
    print(f"moe-train at 1 layer, float32 (TF32 off), bfloat16 moments, "
          f"{len(batches)} steps of {MOE_TRAIN_TOKENS[0]} x "
          f"{MOE_TRAIN_TOKENS[1]} tokens on {peer} a card, from "
          f"place_state: losses {losses} (one card's stacked mesh "
          f"{want_losses}; largest relative difference {loss_rel:.3g}, "
          f"limit {MOE_TRAIN_LOSS_RTOL}); step 1's gradients, every card's "
          f"against the stacked step's: largest difference / the leaf's "
          f"largest |g| {grad_rel[0]:.3g} ({grad_rel[1]}; limit "
          f"{MOE_TRAIN_GRAD_REL}); after step 1 the parameters' largest "
          f"difference {first['worst']} ({first['where']}) against its "
          f"largest |change| {delta1} (limit {MOE_TRAIN_DELTA_SHARE} of it, "
          f"{bound1:.4g}): {first['beyond']} elements beyond it, "
          f"{first['beyond'] - first['bad']} of them with a stacked |g| "
          f"under {MOE_TRAIN_EPS_CONDITIONED} or {MOE_TRAIN_COND_SHARE} of "
          f"its leaf's largest (the largest {first['cond_worst']:.4g}, held "
          f"within 2 x its lr {held1:.4g}); after step "
          f"{len(batches)} the largest difference {worst} ({where}) against "
          f"the largest |change| {delta} ({bound:.4g}): {beyond} elements "
          f"beyond it, {last['bad']} of them outside the ε region (the "
          f"largest of all {cond_worst:.4g}, held within 2 x the summed lr "
          f"{held:.4g}); "
          f"every card's replicated leaves the same bits: {replicas}; "
          f"launches a step {launched}; peak GiB a card "
          f"{out['peak_gib']}", flush=True)
    check(replicas, "moe-train: the cards' replicated leaves differ")
    check(loss_rel <= MOE_TRAIN_LOSS_RTOL, f"moe-train: losses {losses} "
          f"vs one card's stacked step {want_losses}")
    check(grad_rel[0] <= MOE_TRAIN_GRAD_REL, f"moe-train: step 1's "
          f"gradients differ from the stacked step's by {grad_rel[0]} of "
          f"the leaf's largest |g| ({grad_rel[1]})")
    check(first["bad"] == 0 and first["cond_worst"] <= held1,
          f"moe-train: after step 1 {first['bad']} parameters differ beyond "
          f"{bound1} outside AdamW's ε region (the largest "
          f"{first['bad_worst']}), or one in it by {first['cond_worst']}, "
          f"beyond 2 x its lr {held1}")
    check(cond_worst <= held, f"moe-train: a parameter differs by "
          f"{cond_worst}, beyond 2 x the summed lr {held}")
    for when, d in (("step 1", first), (f"step {len(batches)}", last)):
        check(d["beyond"] <= exempt_limit(d["elements"]),
              f"moe-train: after {when} {d['beyond']} of {d['elements']} "
              f"elements took AdamW's ε-region exemption, more than "
              f"{exempt_limit(d['elements'])} ({MOE_TRAIN_EXEMPT_SHARE} of "
              f"them)")
    del trees, got, want, rep, seen
    free(cards)
    return out


def moe_train_deep(cards, peer) -> dict:
    """``--moe-train`` (b): the deepest depth the meta reckoning admits,
    bfloat16 with bfloat16 moments and ``remat="full"`` (the config's),
    the trees drawn layer by layer (no whole model on any card) with zero
    moments: the step by CUDA events on every card (the slowest), tokens/s,
    the peak GiB a card, one step under the profiler, and one backward
    psum (float32 ``(T + E, d)`` a card, one a layer) beside the step's
    ms a layer."""
    import dataclasses
    import math

    from repro_torch.configs import get_config
    from repro_torch.kernels._graph import launch_counts
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.optim import init_opt_state
    from repro_torch.training import TrainStepConfig, make_train_step
    from repro_torch.training.sharding import card_cuts

    full = get_config("mixtral_8x22b")
    reck = moe_train_reckoning(full, cards)
    depth = reck["layers"]
    print(f"moe-train reckoning (meta tensors, card 0 of 4): "
          f"{reck['fixed_bytes'] / 1e9:.3f} GB fixed (embeddings, head and "
          f"norms with gradients, moments and the update; the update's "
          f"temporaries), a layer {reck['state_bytes_a_layer'] / 1e9:.3f} "
          f"GB of state (parameters, gradients, moments, the update's new "
          f"ones) + {reck['psum_bytes_a_layer'] / 1e6:.1f} MB of psum "
          f"buffers; the card {reck['card_bytes'] / 1e9:.2f} GB less "
          f"{MOE_TRAIN_HEADROOM / 1e9:.0f} GB: {depth} of "
          f"{full.num_layers} layers ({reck['reckoned_bytes'] / 1e9:.2f} "
          f"GB reckoned)", flush=True)
    check(depth >= 1, "moe-train: no layer fits a card")
    cfg = dataclasses.replace(full, num_layers=depth)
    opt = moe_train_opt(cfg)
    t0 = time.perf_counter()
    trees = [{"params": p, "opt": init_opt_state(p, opt)}
             for p in placed_trees(cfg, cards, seed=0,
                                   cuts=card_cuts(cfg, peer))]
    build_s = time.perf_counter() - t0
    batches = moe_train_batches(cfg, cards[0], 1 + MOE_TRAIN_TIMED)
    step = make_train_step(cfg, TrainStepConfig(), opt, device=cards[0])
    reset_peaks(cards)
    state = {"trees": trees, "i": 0, "losses": []}
    del trees

    def one():
        bt = batches[state["i"] % len(batches)]
        state["trees"], m = step(state["trees"], bt)
        state["losses"].append(m["loss"])
        state["i"] += 1

    with set_mesh(peer):
        t0 = time.perf_counter()
        one()                                 # builds the ring's programs
        sync_all(cards)
        first_s = time.perf_counter() - t0
        before = launch_counts()
        step_ms, step_per = cards_call_ms(one, cards, MOE_TRAIN_TIMED,
                                          warmup=0)
        launched = {k: (v - before[k]) / MOE_TRAIN_TIMED
                    for k, v in launch_counts().items() if v != before[k]}
        peak = peaks_gib(cards)
        prof = moe_profile(one, cards)
    losses = [float(x) for x in state["losses"]]
    del state
    free(cards)
    d = cfg.d_model
    tokens = math.prod(MOE_TRAIN_TOKENS)
    bwd = moe_combine(peer.session, cards, tokens + cfg.num_experts, d,
                      torch.float32)
    fwd = moe_combine(peer.session, cards, tokens, d)
    out = {"reckoning": reck, "layers": depth, "build_s": build_s,
           "first_step_s": first_s, "step_ms": step_ms,
           "step_ms_cards": step_per, "step_ms_a_layer": step_ms / depth,
           "tokens_per_s": tokens / (step_ms / 1e3), "peak_gib": peak,
           "losses": losses, "launches_a_step": launched, "profile": prof,
           "backward_psum": bwd, "forward_combine": fwd}
    print(f"moe-train at {depth} layers on 4 cards (bfloat16, bfloat16 "
          f"moments, remat full, {MOE_TRAIN_TOKENS[0]} x "
          f"{MOE_TRAIN_TOKENS[1]} tokens): a step {step_ms:.2f} ms (CUDA "
          f"events, slowest card; cards "
          f"{[round(x, 2) for x in step_per]}) = {step_ms / depth:.2f} ms "
          f"a layer, {out['tokens_per_s']:.0f} tokens/s; the first step "
          f"(the ring's programs built) {first_s:.2f} s; drawn and placed "
          f"in {build_s:.1f} s; losses {losses}; peak GiB a card {peak}; "
          f"launches a step {launched}", flush=True)
    print(f"moe-train at {depth} layers, profiler, one step: "
          f"{prof['device_ms_all_cards']:.2f} ms of device time over the 4 "
          f"cards in {prof['kernels']} kernels; top (name, ms, count): "
          f"{prof['top']}", flush=True)
    print(f"moe-train: a backward psum (float32 ({bwd['rows']}, "
          f"{bwd['d']}) a card, one a layer): the call {bwd['call_ms']:.4f} "
          f"ms, its program's replay {bwd['replay_ms']:.4f} ms; a forward "
          f"combine (bfloat16 ({fwd['rows']}, {fwd['d']})): "
          f"{fwd['call_ms']:.4f} / {fwd['replay_ms']:.4f} ms; the step "
          f"{step_ms / depth:.2f} ms a layer (CUDA events, slowest card)",
          flush=True)
    check(all(math.isfinite(x) for x in losses),
          f"moe-train: a loss is not finite: {losses}")
    free(cards)
    return out


def moe_train(cards, smi) -> dict:
    """``--moe-train``: Mixtral-8x22B trained expert parallel on a peer
    mesh a card (module docstring)."""
    from repro_torch.launch.mesh import make_host_mesh

    peer = make_host_mesh((1, 4), devices=cards)
    return {"cards": smi, "check_1_layer": moe_train_check(cards, peer),
            "deep": moe_train_deep(cards, peer)}


#: PCIe Gen5 x16, one direction (data sheet): the host relay's link.
PCIE_BYTES_PER_S = 64e9
#: path I's injected schedule and the counts the CPU pins for it
#: (``tests/test_torch_health.py::test_chip_schedule_counts``).
HEALTH_SPEC = "drop@2x2:0-2;degrade@6x4:0-3*0.25;flap@12~2x2:0-1"
HEALTH_COUNTS = {"retries": 1, "replans": 1, "faults_seen": 7}


#: ``--tp``: the layers of the check against one card's stacked run (path
#: O's), and the logits' bound of ``--moe`` and ``--tp`` against one
#: card's stacked run: within this share of its largest |logit|
#: (bfloat16, ``tests/test_torch_peer_tp.py``).
TP_CHECK_LAYERS = 4
TP_BOUND = 2e-2


def against_stacked(engine, got: dict, want: dict, cards,
                    keep: dict | None = None) -> dict:
    """The peer engine's readings ``got`` (:func:`moe_serve`, just run)
    against one card's stacked run ``want``: every card's prefill logits
    the same bits, and a decode step from the stacked run's token (at the
    same position, after the same prefill) on every card the same bits;
    both within TP_BOUND of the stacked run's largest |logit|; the greedy
    tokens counted where they agree. With ``keep``, the decode step's
    logits are put there (``keep["step"]``)."""
    c0 = cards[0]
    b, plen = got["toks"].shape
    # the prefill again first: a recurrent state (RWKV-6's, Mamba's) moved
    # on by :func:`moe_serve`'s decode step, where a KV cache is rewritten
    prefill = engine.prefill_program(b, plen)
    prefill.tokens.copy_(got["toks"])
    prefill()
    decode = engine.decode_program(b)
    decode.tokens.copy_(want["logits"][:, -1].argmax(-1)[:, None].to(c0))
    decode.cur_len.fill_(plen)
    step = decode().clone()
    step_cards = [t.clone() for t in decode.card_logits]
    sync_all(cards)
    if keep is not None:
        keep["step"] = step

    def err(a, b):
        return (a.to(c0).float() - b.to(c0).float()).abs().max().item()

    errs = {"prefill": err(got["logits"], want["logits"]),
            "decode": err(step, want["step"])}
    tops = {"prefill": want["logits"].float().abs().max().item(),
            "decode": want["step"].float().abs().max().item()}
    pairs = [(a, w) for o, wo in zip(got["outs"][0], want["outs"][0])
             for a, w in zip(o, wo)]
    return {"max_abs_err": errs, "max_abs_logit": tops,
            "within_bound": all(errs[k] <= TP_BOUND * tops[k] for k in errs),
            "every_card_same_bits": all(
                torch.equal(t.to(c0), got["logits"])
                for t in got["prefill_cards"]) and all(
                torch.equal(t.to(c0), step) for t in step_cards),
            "tokens_agree": sum(a == w for a, w in pairs),
            "tokens": len(pairs),
            "first_tokens_agree": [o[0] for o in got["outs"][0]]
            == [o[0] for o in want["outs"][0]]}


def tp_check(cards, peer, smi) -> dict:
    """``--tp`` (a): Nemotron-4 340B at full width over TP_CHECK_LAYERS
    layers, path O's seeded weights drawn whole on card 0, one card's
    stacked engine, then the peer mesh's (the engine places each card's
    cut): :func:`against_stacked`, the prefill replay and the captured
    decode step against the stacked ones, ``ring_allgather`` launches a
    decode replay."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import ServeEngine

    c0 = cards[0]
    cfg = dataclasses.replace(get_config("nemotron_4_340b"),
                              num_layers=TP_CHECK_LAYERS)
    prompts = moe_prompts(cfg)
    params = tfm.init_params(cfg, generator=torch.Generator(
        device=c0).manual_seed(0), device=c0)
    engine = ServeEngine(cfg, params, max_len=1024, kv_chunks=4)
    want = moe_serve(engine, prompts, [c0])
    stacked = moe_times(engine, want, [c0])
    del engine
    free(cards)
    with set_mesh(peer):
        engine = ServeEngine(cfg, params, max_len=1024, kv_chunks=4)
        got = moe_serve(engine, prompts, cards)
        out = against_stacked(engine, got, want, cards)
        out.update(moe_times(engine, got, cards))
        out["cuts"] = [str(c) for c in engine.cuts]
        out["peak_gib"] = peaks_gib(cards)
        del engine
    psums = 1 + 2 * TP_CHECK_LAYERS
    out["stacked"] = stacked
    print(f"tp at {TP_CHECK_LAYERS} layers on {peer} a card ({smi[0]}): "
          f"every card the same bits {out['every_card_same_bits']}; "
          f"against one card's stacked run max abs err "
          f"{out['max_abs_err']} (max |logit| {out['max_abs_logit']}, "
          f"bound {TP_BOUND} of it: {out['within_bound']}); greedy tokens "
          f"agree in {out['tokens_agree']} of {out['tokens']} (first "
          f"tokens {out['first_tokens_agree']}); prefill replay "
          f"{out['prefill_ms']:.2f} ms (one card's "
          f"{stacked['prefill_ms']:.2f}), captured decode step "
          f"{out['decode_ms']:.2f} ms ({stacked['decode_ms']:.2f}); "
          f"ring_allgather {out['gather_launches_a_decode']} launches a "
          f"decode replay; peak GiB a card {out['peak_gib']}", flush=True)
    check(out["every_card_same_bits"] and out["within_bound"],
          f"tp at {TP_CHECK_LAYERS} layers: {out}")
    check(out["gather_launches_a_decode"] == (psums + 1) * len(cards),
          f"tp: {out['gather_launches_a_decode']} ring_allgather launches "
          f"a decode replay, not one a card a psum ({psums}) and one for "
          f"the logits")
    del params, want, got
    free(cards)
    return out


def serve_reckoning(cfg, peer, cards) -> dict:
    """Card 0's bytes at ``L`` layers on the peer mesh, reckoned on meta
    tensors: its placed weights (``place_card`` of its cut) and KV cache
    at its kv heads (path O's requests, max_len 1024); its psums' buffers,
    three times a prefill psum's operand ((2048, d) bfloat16 a card: a
    ring shift's sends and receipts and the gather's replicas), the
    embedding's and two a layer; the logits: its vocabulary shard, the
    gather's replicas, the gathered copy and the engine's two copies (a
    card's and card 0's). The deepest ``L`` of at most the config's whose
    bytes leave SERVE_HEADROOM of the card."""
    import dataclasses

    from repro_torch.models import transformer as tfm
    from repro_torch.training import sharding as shd

    rows = len(MOE_PROMPTS) * max(MOE_PROMPTS)
    n = len(cards)

    def card_bytes(layers):
        c = dataclasses.replace(cfg, num_layers=layers)
        cut = shd.card_cuts(c, peer)[0]
        tree = shd.place_card(tfm.param_shapes(c), list(cut.held),
                              cut.model, "meta", cut)
        spec = tfm.cache_spec(c, max_len=1024, kv_chunks=4)
        cache = tfm.init_cache(c, len(MOE_PROMPTS), spec, device="meta",
                               cut=cut)
        weights = sum(t.numel() * t.element_size() for t in leaves(tree))
        kv = sum(t.numel() * t.element_size() for t in cache.values())
        psum = 3 * rows * cfg.d_model * 2 * (1 + 2 * layers)
        logits = rows * cfg.vocab_size * 2 * (1 / n + 4)
        return weights, kv, psum, logits

    zero, one = card_bytes(0), card_bytes(1)
    total = torch.cuda.mem_get_info(cards[0])[1]
    per_layer = sum(one) - sum(zero)
    depth = min(cfg.num_layers,
                int((total - SERVE_HEADROOM - sum(zero)) // per_layer))
    return {"card_bytes": total, "fixed_bytes": sum(zero),
            "weight_bytes_a_layer": one[0] - zero[0],
            "kv_bytes_a_layer": one[1] - zero[1],
            "psum_bytes_a_layer": one[2] - zero[2],
            "vocab_bytes": zero[0], "logits_bytes": zero[3],
            "layers": depth,
            "reckoned_bytes": sum(zero) + depth * per_layer}


def reck_text(reck: dict, full) -> str:
    return (f"{reck['fixed_bytes'] / 1e9:.3f} GB fixed "
            f"({reck['vocab_bytes'] / 1e9:.3f} GB of vocabulary, "
            f"{reck['logits_bytes'] / 1e9:.3f} GB of logits), a layer "
            f"{reck['weight_bytes_a_layer'] / 1e9:.3f} GB of weights + "
            f"{reck['kv_bytes_a_layer'] / 1e6:.1f} MB of KV cache + "
            f"{reck['psum_bytes_a_layer'] / 1e6:.1f} MB of psum buffers; "
            f"the card {reck['card_bytes'] / 1e9:.2f} GB less "
            f"{SERVE_HEADROOM / 1e9:.0f} GB: {reck['layers']} of "
            f"{full.num_layers} layers ({reck['reckoned_bytes'] / 1e9:.2f} "
            f"GB reckoned)")


def placed_trees(cfg, cards, seed: int, cuts=None) -> list:
    """One placed tree a card of ``cfg`` on a peer mesh of ``cards`` (a
    logical device a card), drawn on card 0 from ``seed`` without the
    whole model on any card: the top-level leaves first (each card's part
    copied out, the whole freed), then each layer's block, whose part each
    card copies into its layer stacks. Each card holds its own experts and,
    with ``cuts`` (a card's :class:`~repro_torch.models.tensor_parallel.
    DenseCut` each: the serving layout), its cut of the dense leaves;
    without, a replica of them (the training layout)."""
    import dataclasses

    from repro_torch.models import transformer as tfm
    from repro_torch.training import sharding as shd
    from repro_torch.tree import tree_map

    n, c0 = len(cards), cards[0]
    cuts = cuts or [None] * n

    def part(tree, c, device):
        return shd.place_card(tree, [c], n, device, cuts[c])

    gen = torch.Generator(device=c0).manual_seed(seed)
    top = tfm.init_params(dataclasses.replace(cfg, num_layers=0),
                          generator=gen, device=c0)
    trees = []
    for c, card in enumerate(cards):
        mine = part({k: t for k, t in top.items() if k != "layers"}, c, c0)
        trees.append({k: torch.empty(t.shape, dtype=t.dtype,
                                     device=card).copy_(t)
                      for k, t in mine.items()})
    del top, mine
    free(cards)
    shapes = tfm.param_shapes(cfg)
    for c, (card, tree) in enumerate(zip(cards, trees)):
        tree["layers"] = tree_map(lambda t, card=card: torch.empty(
            t.shape, dtype=t.dtype, device=card),
            part(shapes, c, "meta")["layers"])
    for i in range(cfg.num_layers):
        layer = tfm.block_init(cfg, generator=gen, device=c0)
        for c, tree in enumerate(trees):
            mine = part({"layers": layer}, c, c0)["layers"]
            for dst, src in zip(leaves(tree["layers"]), leaves(mine)):
                dst[i].copy_(src)
        del layer, mine
    sync_all(cards)
    return trees


def psum_times(sess, cards, rows: int, d: int) -> dict:
    """One tensor-parallel psum of ``(rows, d)`` bfloat16 a card
    (:func:`moe_combine`: the call and its program's replay by CUDA events,
    the slowest card) beside NCCL's all-reduce of the same operands, the
    bytes each card takes in (2(n-1)/n of the operand) at
    NVLINK_BYTES_PER_S, and the dry-run's modeled term for the same wire
    bytes at one NVLink 4 link (``launch/roofline.py``)."""
    from repro_torch.launch import roofline

    out = moe_combine(sess, cards, rows, d)
    gen = torch.Generator(device=cards[0]).manual_seed(4)
    parts = [torch.randn(rows, d, generator=gen, device=cards[0]).to(
        torch.bfloat16).to(c) for c in cards]
    n = len(cards)
    wire = 2 * (n - 1) / n * rows * d * 2
    out.update({"nccl_ms": nccl_ms("all_reduce", parts, cards),
                "bound_ms": wire / NVLINK_BYTES_PER_S * 1e3,
                "modeled_ms": roofline.roofline_terms(
                    0, 0, wire)[0]["collective"] * 1e3,
                "wire_bytes_a_card": wire})
    return out


def tp_deep(cards, peer) -> dict:
    """``--tp`` (b): at the deepest depth :func:`serve_reckoning` admits,
    the trees drawn by :func:`placed_trees`: ``generate`` twice, the
    prefill replay and the captured decode step (CUDA events, slowest card),
    tokens/s, each card's GiB and one prefill and one decode replay under
    the profiler, whose ``multipath_dma`` and ``ring_allgather`` device
    time is the psums' and the gather's wire and wait time."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.serving import ServeEngine
    from repro_torch.training import sharding as shd

    c0 = cards[0]
    full = get_config("nemotron_4_340b")
    reck = serve_reckoning(full, peer, cards)
    depth = reck["layers"]
    print(f"tp reckoning (meta tensors, card 0 of 4): "
          f"{reck_text(reck, full)}", flush=True)
    cfg = dataclasses.replace(full, num_layers=depth)
    prompts = moe_prompts(cfg)
    t0 = time.perf_counter()
    trees = placed_trees(cfg, cards, seed=0,
                         cuts=shd.card_cuts(cfg, peer))
    build_s = time.perf_counter() - t0
    print(f"tp: {depth} layers drawn and placed a card in {build_s:.1f} s; "
          f"GiB a card {peaks_gib(cards)}", flush=True)
    reset_peaks(cards)
    with set_mesh(peer):
        engine = ServeEngine(cfg, trees, max_len=1024, kv_chunks=4)
        got = moe_serve(engine, prompts, cards)
        deep = moe_times(engine, got, cards)
        del engine
    gen1, gen2 = got["gen_s"]
    tokens = len(prompts) * MOE_NEW
    psums = 1 + 2 * depth
    deep.update({
        "reckoning": reck, "layers": depth, "build_s": build_s,
        "generate_s": got["gen_s"], "tokens_per_s": tokens / gen2,
        "peak_gib": peaks_gib(cards),
        "same_tokens_twice": got["outs"][0] == got["outs"][1],
        "every_card_same_logits": all(
            torch.equal(t.to(c0), got["logits"])
            for t in got["prefill_cards"]) and all(
            torch.equal(t.to(c0), got["step"])
            for t in got["decode_cards"]),
        "logits_finite": bool(torch.isfinite(got["logits"]).all())})
    for name in ("prefill", "decode"):
        prof = deep[f"{name}_profile"]
        comm = prof["by_kernel"]
        deep[f"{name}_comm_ms_a_card_a_psum"] = (
            sum(comm.values()) / len(cards) / (psums + 1))
    print(f"tp at {depth} layers on 4 cards: prefill replay "
          f"{deep['prefill_ms']:.2f} ms (cards "
          f"{[round(x, 2) for x in deep['prefill_ms_cards']]}), captured "
          f"decode step {deep['decode_ms']:.2f} ms (CUDA events, slowest "
          f"card), generate of {tokens} tokens {gen2:.3f} s = "
          f"{deep['tokens_per_s']:.1f} tokens/s (first {gen1:.3f} s, with "
          f"the captures); ring_allgather "
          f"{deep['gather_launches_a_decode']} launches a decode replay; "
          f"graphs {deep['graph_gb']:.2f} GB; peak GiB a card "
          f"{deep['peak_gib']}; same tokens twice "
          f"{deep['same_tokens_twice']}, every card's logits the same "
          f"bits {deep['every_card_same_logits']}", flush=True)
    for name in ("prefill", "decode"):
        prof = deep[f"{name}_profile"]
        print(f"tp at {depth} layers, profiler, one {name} replay: "
              f"{prof['device_ms_all_cards']:.2f} ms of device time over "
              f"the 4 cards in {prof['kernels']} kernels; the ring's "
              f"kernels {prof['by_kernel']} ms over the cards, "
              f"{deep[name + '_comm_ms_a_card_a_psum']:.4f} ms a card a "
              f"psum ({psums} psums and the logits' gather); top (name, "
              f"ms, count): {prof['top']}", flush=True)
    check(deep["same_tokens_twice"] and deep["every_card_same_logits"]
          and deep["logits_finite"], f"tp at {depth} layers: {deep}")
    check(deep["gather_launches_a_decode"] == (psums + 1) * len(cards),
          f"tp: {deep['gather_launches_a_decode']} ring_allgather "
          f"launches a decode replay, not one a card a psum and one for "
          f"the logits")
    del trees, got
    free(cards)
    return deep


def tp(cards, smi) -> dict:
    """``--tp``: Nemotron-4 340B served tensor parallel on a peer mesh a
    card (module docstring)."""
    from repro_torch.launch.mesh import make_host_mesh

    peer = make_host_mesh((1, 4), devices=cards)
    d = 18432                                 # Nemotron-4 340B's d_model
    out = {"cards": smi, "check": tp_check(cards, peer, smi),
           "deep": tp_deep(cards, peer),
           "psum": [psum_times(peer.session, cards, rows, d)
                    for rows in (max(MOE_PROMPTS) * len(MOE_PROMPTS),
                                 len(MOE_PROMPTS))]}
    for row in out["psum"]:
        print(f"tp psum, a peer psum of ({row['rows']}, {row['d']}) "
              f"bfloat16 a card on 4 cards ({smi[0]}): the call "
              f"{row['call_ms']:.4f} ms, its program's replay "
              f"{row['replay_ms']:.4f} ms (CUDA events, slowest card); "
              f"NCCL's all-reduce {row['nccl_ms']} ms; bound "
              f"{row['bound_ms']:.4f} ms "
              f"({row['wire_bytes_a_card'] / 1e6:.2f} MB into a card at "
              f"450 GB/s); the dry-run's modeled term "
              f"{row['modeled_ms']:.4f} ms (one NVLink 4 link); every card "
              f"the same bits, max abs vs the float sum "
              f"{row['max_abs_vs_float_sum']}", flush=True)
    return out


#: ``--tp-train``: the check's depth and steps, the tokens of every run,
#: the timed steps, what the reckoning leaves of a card for the caching
#: allocator and the CUDA context, and (a)'s float32 bound on step 1's
#: gradients, each card's against the unsharded step's (a share of the
#: leaf's largest |g|: only the cross-card sums' order differs).
TP_TRAIN_CHECK_LAYERS = 2
TP_TRAIN_CHECK_STEPS = 3
TP_TRAIN_TOKENS = (8, 512)
TP_TRAIN_TIMED = 2
TP_TRAIN_HEADROOM = 6e9
TP_TRAIN_GRAD_REL = 1e-5


def tp_train_opt(cfg):
    from repro_torch.optim import OptimConfig
    return OptimConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                       moment_dtype=cfg.optimizer_dtype)


def tp_train_batches(cfg, dev, count: int) -> list[dict]:
    from repro_torch.data import DataConfig, SyntheticDataset, batch_to
    b, s = TP_TRAIN_TOKENS
    ds = SyntheticDataset(cfg, DataConfig(seq_len=s, global_batch=b))
    return [batch_to(ds.batch_at(i), dev) for i in range(count)]


class card_readings:
    """Inside: each card's loss and ``grad_norm`` a step of a peer step
    (``seen[card]``: a list of (loss, gnorm) a step), and with ``grads``
    each card's first gradients copied to the host (``grads[card]``),
    recorded where the step computes the loss and hands the gradients to
    AdamW."""

    def __init__(self, grads: bool = False):
        self.seen: dict = {}
        self.grads: dict | None = {} if grads else None

    def __enter__(self):
        from repro_torch.models import moe_dist
        from repro_torch.models import transformer as tfm
        from repro_torch.training import train_step as tsm

        self.saved = tfm.loss_fn, tsm._update
        loss_fn, update = self.saved

        def loss(params, cfg, batch, aux_coef=0.01):
            out = loss_fn(params, cfg, batch, aux_coef)
            share = moe_dist.current_share()
            if share is not None:
                self.seen.setdefault(share[1], []).append([out.detach()])
            return out

        def upd(params, grads, opt_state, opt, **kw):
            share = moe_dist.current_share()
            if share is not None and "gnorm" in kw:
                self.seen[share[1]][-1].append(kw["gnorm"])
                if self.grads is not None and share[1] not in self.grads:
                    self.grads[share[1]] = [g.cpu() for g in leaves(grads)]
            return update(params, grads, opt_state, opt, **kw)

        tfm.loss_fn, tsm._update = loss, upd
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer as tfm
        from repro_torch.training import train_step as tsm

        tfm.loss_fn, tsm._update = self.saved
        return False

    def same_bits(self, on) -> bool:
        """Every card's loss and ``grad_norm`` the same bits at every
        step."""
        rows = [self.seen[c] for c in sorted(self.seen)]
        return all(len(r) == len(rows[0]) for r in rows) and all(
            torch.equal(a.to(on), b.to(on)) for r in rows[1:]
            for step, ref in zip(r, rows[0]) for a, b in zip(step, ref))


def tp_train_check(cards, peer, dtype: str, name: str = "llama3_8b",
                   layers: int | None = TP_TRAIN_CHECK_LAYERS,
                   grad_limit: float = TP_TRAIN_GRAD_REL,
                   params_within_lr: bool = False) -> dict:
    """``--tp-train`` (a): Llama-3 8B (``name``) at full width over
    TP_TRAIN_CHECK_LAYERS layers (``layers``; None: all) in ``dtype``
    (TF32 off), seeded weights
    and float32 moments, TP_TRAIN_CHECK_STEPS steps on the four cards
    from ``place_state(state, mesh, cfg)`` against one card's unsharded
    ``make_train_step`` from the same seed and batches (in the same
    process). Hard: every card's loss, ``grad_norm`` and replicated
    leaves the same bits; losses within rtol MOE_TRAIN_LOSS_RTOL (path
    Z's). In float32 also hard: step 1's gradients, each card's against
    its part of the unsharded step's, within ``grad_limit`` of each
    leaf's largest |g|; every updated parameter within
    MOE_TRAIN_DELTA_SHARE of the unsharded update's largest |change|, but
    for the elements of :func:`ill_conditioned` at some step (held within
    twice the steps' summed lr, counted, at most :func:`exempt_limit`). In bfloat16 both are reported: each update rounds to
    bfloat16, so two summation orders leave parameters a bfloat16 step or
    more apart (``chip_smoke.py``'s AC_LAYERS note). With
    ``params_within_lr`` (RWKV-6, whose float32 gradients its group norm
    leaves ``grad_limit`` apart, enough to turn the sign of AdamW's first
    update of every element whose |g| is under that) every parameter is
    held within twice the summed lr instead, path Z's counts reported."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels._graph import launch_counts
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.training import (TrainStepConfig, init_state,
                                      make_train_step)
    from repro_torch.training import sharding as shd
    from repro_torch.training import train_step as tsm
    from repro_torch.tree import leaves_with_paths

    c0 = cards[0]
    full = get_config(name)
    cfg = dataclasses.replace(full, num_layers=layers or full.num_layers,
                              dtype=dtype)
    opt = tp_train_opt(cfg)
    batches = tp_train_batches(cfg, c0, TP_TRAIN_CHECK_STEPS)
    update = tsm._update
    seen: dict = {"cond": None, "grads": None, "lrs": []}

    def unsharded_update(params, grads, opt_state, opt_, **kw):
        small = ill_conditioned(grads)
        seen["cond"] = small if seen["cond"] is None else [
            a | b for a, b in zip(seen["cond"], small)]
        if seen["grads"] is None:
            seen["grads"] = [(path, g.cpu())
                             for path, g in leaves_with_paths(grads)]
        out = update(params, grads, opt_state, opt_, **kw)
        seen["lrs"].append(float(out[2]["lr"]))
        return out

    def fresh():
        return init_state(cfg, opt, generator=torch.Generator(
            device=c0).manual_seed(91), device=c0)

    def step():
        return make_train_step(cfg, TrainStepConfig(), opt, device=c0)

    tsm._update = unsharded_update
    try:
        want, want_losses = moe_train_steps(step(), fresh(), batches)
    finally:
        tsm._update = update
    want = want["params"]
    free(cards)
    state = fresh()
    delta = max((a.float() - b.float()).abs().max().item()
                for a, b in zip(leaves(want), leaves(state["params"])))
    trees = shd.place_state(state, peer, cfg)
    cuts = shd.card_cuts(cfg, peer)
    del state
    free(cards)
    before = launch_counts()
    with card_readings(grads=True) as rec, set_mesh(peer):
        trees, losses = moe_train_steps(step(), trees, batches)
    sync_all(cards)
    launched = {k: (v - before[k]) / len(batches)
                for k, v in launch_counts().items() if v != before[k]}
    rep = [[t for path, t in leaves_with_paths(tree)
            if not shd.is_cut(path, cuts[0])] for tree in trees]
    replicas = all(torch.equal(a.to(c0), b)
                   for other in rep[1:] for a, b in zip(other, rep[0]))
    del rep
    grad_rel = (0.0, "")
    for c in range(len(cards)):
        for (path, g), mine in zip(seen["grads"], rec.grads[c]):
            ref = shd.cut_leaf(g, path, [c], len(cards), cuts[c])
            rel = ((mine.float() - ref.float()).abs().max().item()
                   / max(ref.float().abs().max().item(), 1e-30))
            grad_rel = max(grad_rel, (rel, f"card {c} {'/'.join(path)}"))
    got = shd.unplace_state(trees, peer, cfg)["params"]
    del trees
    bound, held = MOE_TRAIN_DELTA_SHARE * delta, 2 * sum(seen["lrs"])
    worst, where, beyond, cond, cond_worst = 0.0, "", 0, 0, 0.0
    elements = 0
    for i, (a, b, small) in enumerate(zip(leaves(got), leaves(want),
                                          seen["cond"])):
        elements += b.numel()
        diff = (a.float() - b.float()).abs()
        err = diff.max().item()
        if err >= worst:
            worst, where = err, f"leaf {i} {tuple(b.shape)}"
        out_ = diff > bound
        inside = out_ & small & (diff <= held)
        cond += int(inside.sum())
        bad = out_ & ~inside
        beyond += int(bad.sum())
        if bool(bad.any()):
            first = [tuple(int(x) for x in ix) for ix in bad.nonzero()[:3]]
            print(f"tp-train ({dtype}): leaf {i} {tuple(b.shape)}: "
                  f"{int(bad.sum())} elements beyond, e.g. at {first}: got "
                  f"{[a[ix].item() for ix in first]}, want "
                  f"{[b[ix].item() for ix in first]}", flush=True)
        if bool(inside.any()):
            cond_worst = max(cond_worst, diff[inside].max().item())
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    out = {"name": name, "layers": cfg.num_layers, "dtype": dtype,
           "steps": len(batches), "elements": elements,
           "losses": losses, "unsharded_losses": want_losses,
           "loss_rel": loss_rel, "grad_rel_step1": grad_rel[0],
           "grad_rel_where": grad_rel[1], "worst_param_diff": worst,
           "worst_leaf": where, "unsharded_delta": delta,
           "param_bound": bound, "eps_region_beyond_bound": cond,
           "their_worst_diff": cond_worst, "conditioned_bound": held,
           "others_beyond_bound": beyond,
           "metrics_same_bits": rec.same_bits(c0),
           "replicas_bitwise": replicas, "launches_a_step": launched,
           "cuts": [str(c) for c in cuts], "peak_gib": peaks_gib(cards)}
    print(f"tp-train {name} at {cfg.num_layers} layers, {dtype} (TF32 "
          f"off), "
          f"float32 moments, {len(batches)} steps of {TP_TRAIN_TOKENS[0]} x "
          f"{TP_TRAIN_TOKENS[1]} tokens on {peer} a card, from place_state: "
          f"losses {losses} (one card's unsharded step {want_losses}; "
          f"largest relative difference {loss_rel:.3g}, limit "
          f"{MOE_TRAIN_LOSS_RTOL}); every card's loss and grad_norm the same "
          f"bits {out['metrics_same_bits']}, replicated leaves "
          f"{replicas}; step 1's gradients, every card's against its part of "
          f"the unsharded step's: largest difference / the leaf's largest "
          f"|g| {grad_rel[0]:.3g} ({grad_rel[1]}; limit {grad_limit}); "
          f"parameters' largest "
          f"difference {worst} ({where}) against the unsharded update's "
          f"largest |change| {delta} (limit {MOE_TRAIN_DELTA_SHARE} of it, "
          f"{bound:.4g}): of {elements} elements {cond} beyond it with an "
          f"unsharded |g| "
          f"under {MOE_TRAIN_EPS_CONDITIONED} or {MOE_TRAIN_COND_SHARE} of "
          f"its leaf's largest at some step (largest {cond_worst:.4g}, "
          f"within 2 x the summed lr {held:.4g}), {beyond} others; "
          f"launches a step {launched}; peak "
          f"GiB a card {out['peak_gib']}", flush=True)
    check(out["metrics_same_bits"] and replicas,
          f"tp-train ({dtype}): the cards' metrics or replicated leaves "
          f"differ")
    check(loss_rel <= MOE_TRAIN_LOSS_RTOL, f"tp-train ({dtype}): losses "
          f"{losses} vs the unsharded step's {want_losses}")
    if dtype == "float32":
        check(grad_rel[0] <= grad_limit, f"tp-train: step 1's "
              f"gradients differ from the unsharded step's by "
              f"{grad_rel[0]} of the leaf's largest |g| ({grad_rel[1]})")
        if params_within_lr:
            check(worst <= held, f"tp-train: a parameter differs by "
                  f"{worst} ({where}), beyond 2 x the summed lr {held}")
        else:
            check(beyond == 0, f"tp-train: {beyond} parameters beyond "
                  f"{bound} outside AdamW's ε region, or beyond {held} in "
                  f"it")
            check(cond <= exempt_limit(elements), f"tp-train: {cond} of "
                  f"{elements} elements took AdamW's ε-region exemption, "
                  f"more than {exempt_limit(elements)}")
    del got, want, seen, rec
    free(cards)
    return out


def tp_train_reckoning(cfg, peer, cards) -> dict:
    """Card 0's bytes training ``L`` layers of a dense decoder tensor
    parallel on the peer mesh of ``cards`` (a logical device a card),
    reckoned on meta tensors: its placed state (``place_card`` of
    ``state_shapes`` under its cut), the gradients (the parameters'
    bytes), the update's new parameters and moments and its float32
    temporaries (nine of the largest leaf's or of ``UPDATE_SLICE``
    elements); the psums' buffers, each psum's own (2.75 times its
    ``(T, d)`` operand a card in the model's dtype: three ring shifts'
    sends and receipts of a quarter each and the gather's shard and
    replicas) for the ``4 + 5L`` psums a step (``chip_smoke.py``'s
    ``tp_step_psums``); the activations: each layer's checkpointed input
    ``(T, d)``, one layer's working set in the backward (its q, k, v,
    attention output and their gradients, the MLP's hidden products:
    about ``10·d + 6·ff/4`` elements a token) and the loss's logits over
    the card's vocabulary (in the model's dtype, their float32 copy, its
    gradient and the softmax's). The deepest ``L`` of at most the
    config's whose bytes leave TP_TRAIN_HEADROOM of the card."""
    import dataclasses
    import math

    from repro_torch.optim.adamw import UPDATE_SLICE
    from repro_torch.training import sharding as shd
    from repro_torch.training.train_step import state_shapes

    opt = tp_train_opt(cfg)
    tokens = math.prod(TP_TRAIN_TOKENS)
    elt = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    cut = shd.card_cuts(cfg, peer)[0]
    d, n = cfg.d_model, len(cards)

    def card_bytes(layers):
        c = dataclasses.replace(cfg, num_layers=layers)
        tree = shd.place_card(state_shapes(c, opt), list(cut.held),
                              cut.model, "meta", cut)
        params = sum(t.numel() * t.element_size()
                     for t in leaves(tree["params"]))
        moments = sum(t.numel() * t.element_size()
                      for t in leaves(tree["opt"]))
        largest = max(t.numel() for t in leaves(tree["params"]))
        temps = 9 * 4 * min(largest, UPDATE_SLICE)
        psums = (4 + 5 * layers) * 2.75 * tokens * d * elt
        acts = tokens * (layers * d * elt + (10 * d + 6 * cfg.d_ff // n)
                         * elt + cfg.vocab_size // n * (elt + 12))
        return 3 * params + 2 * moments, temps, psums, acts

    zero, one = card_bytes(0), card_bytes(1)
    total = torch.cuda.mem_get_info(cards[0])[1]
    per_layer = sum(one) - sum(zero)
    depth = min(cfg.num_layers,
                int((total - TP_TRAIN_HEADROOM - sum(zero)) // per_layer))
    at = card_bytes(depth)
    return {"card_bytes": total, "fixed_bytes": sum(zero),
            "state_bytes_a_layer": one[0] - zero[0],
            "psum_bytes_a_layer": one[2] - zero[2],
            "act_bytes_a_layer": one[3] - zero[3],
            "update_temps_bytes": one[1], "layers": depth,
            "state_bytes": at[0], "psum_bytes": at[2], "act_bytes": at[3],
            "reckoned_bytes": sum(at)}


def tp_train_deep(cards, peer, name: str, layers: int | None = None,
                  finite_as: list | None = None) -> dict:
    """``--tp-train`` (b) and (c): ``name``'s config (full width, its
    vocabulary, dtype, moments and ``remat="full"``) at the deepest depth
    :func:`tp_train_reckoning` admits, at most all its layers (or at
    ``layers``, unreckoned: ``--ssm-tp``'s whole models), the trees
    drawn layer by layer (no whole model on any card) with zero moments:
    the first step (the ring's programs built), a step by CUDA events on
    every card (the slowest), tokens/s, each card's peak GiB against the
    reckoning, launches a step, every card's metrics the same bits, one
    step under the profiler. Every loss must be finite, or with
    ``finite_as`` (one card's losses from the same weights and batches)
    every loss where that run's is."""
    import dataclasses
    import math

    from repro_torch.configs import get_config
    from repro_torch.kernels._graph import launch_counts
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.optim import init_opt_state
    from repro_torch.training import TrainStepConfig, make_train_step
    from repro_torch.training import sharding as shd

    full = get_config(name)
    reck = None if layers else tp_train_reckoning(full, peer, cards)
    depth = layers or reck["layers"]
    if reck:
        print(f"tp-train reckoning for {name} (meta tensors, card 0 of 4): "
              f"{reck['fixed_bytes'] / 1e9:.3f} GB fixed (embedding and head "
              f"blocks and norms with gradients, moments and the update; the "
              f"update's temporaries; 4 psums; the loss's logits), a layer "
              f"{reck['state_bytes_a_layer'] / 1e9:.3f} GB of state (parameters, "
              f"gradients, moments, the update's new ones) + "
              f"{reck['psum_bytes_a_layer'] / 1e9:.3f} GB of psum buffers + "
              f"{reck['act_bytes_a_layer'] / 1e9:.3f} GB of activations; the "
              f"card {reck['card_bytes'] / 1e9:.2f} GB less "
              f"{TP_TRAIN_HEADROOM / 1e9:.0f} GB: {depth} of {full.num_layers} "
              f"layers ({reck['reckoned_bytes'] / 1e9:.2f} GB reckoned: state "
              f"{reck['state_bytes'] / 1e9:.2f}, psums "
              f"{reck['psum_bytes'] / 1e9:.2f}, activations "
              f"{reck['act_bytes'] / 1e9:.2f})", flush=True)
    check(depth >= 1, f"tp-train: no layer of {name} fits a card")
    cfg = dataclasses.replace(full, num_layers=depth)
    opt = tp_train_opt(cfg)
    cuts = shd.card_cuts(cfg, peer)
    t0 = time.perf_counter()
    trees = [{"params": p, "opt": init_opt_state(p, opt)}
             for p in placed_trees(cfg, cards, seed=0, cuts=cuts)]
    build_s = time.perf_counter() - t0
    batches = tp_train_batches(cfg, cards[0], 1 + TP_TRAIN_TIMED)
    step = make_train_step(cfg, TrainStepConfig(), opt, device=cards[0])
    reset_peaks(cards)
    state = {"trees": trees, "i": 0, "losses": []}
    del trees

    def one():
        bt = batches[state["i"] % len(batches)]
        state["trees"], m = step(state["trees"], bt)
        state["losses"].append(m["loss"])
        state["i"] += 1

    with card_readings() as rec, set_mesh(peer):
        t0 = time.perf_counter()
        one()                                 # builds the ring's programs
        sync_all(cards)
        first_s = time.perf_counter() - t0
        before = launch_counts()
        step_ms, step_per = cards_call_ms(one, cards, TP_TRAIN_TIMED,
                                          warmup=0)
        launched = {k: (v - before[k]) / TP_TRAIN_TIMED
                    for k, v in launch_counts().items() if v != before[k]}
        peak = peaks_gib(cards)
    same = rec.same_bits(cards[0])
    with set_mesh(peer):
        prof = moe_profile(one, cards)
    losses = [float(x) for x in state["losses"]]
    del state, rec, step
    free(cards)
    tokens = math.prod(TP_TRAIN_TOKENS)
    reck_gib = (f"{reck['reckoned_bytes'] / 2**30:.2f}" if reck
                else "not reckoned: whole model")
    out = {"name": name, "reckoning": reck, "layers": depth,
           "vocab": cfg.vocab_size, "moments": opt.moment_dtype,
           "build_s": build_s, "first_step_s": first_s, "step_ms": step_ms,
           "step_ms_cards": step_per, "tokens_per_s": tokens / step_ms * 1e3,
           "peak_gib": peak, "losses": losses, "metrics_same_bits": same,
           "launches_a_step": launched, "profile": prof}
    print(f"tp-train {name} at {depth} of {full.num_layers} layers on 4 "
          f"cards (full width, vocabulary {cfg.vocab_size}, {cfg.dtype}, "
          f"{opt.moment_dtype} moments, remat full, {TP_TRAIN_TOKENS[0]} x "
          f"{TP_TRAIN_TOKENS[1]} tokens): a step {step_ms:.2f} ms (CUDA "
          f"events, slowest card; cards {[round(x, 2) for x in step_per]}) "
          f"= {out['tokens_per_s']:.0f} tokens/s; the first step (the "
          f"ring's programs built) {first_s:.2f} s; drawn and placed in "
          f"{build_s:.1f} s; losses {losses}; every card's loss and "
          f"grad_norm the same bits {same}; peak GiB a card {peak} "
          f"(reckoned {reck_gib}); launches a "
          f"step {launched}", flush=True)
    print(f"tp-train {name} at {depth} layers, profiler, one step: "
          f"{prof['device_ms_all_cards']:.2f} ms of device time over the 4 "
          f"cards in {prof['kernels']} kernels; the ring's kernels "
          f"{prof['by_kernel']} ms over the cards; top (name, ms, count): "
          f"{prof['top']}", flush=True)
    ref = (finite_as if finite_as and len(finite_as) == len(losses)
           else [0.0] * len(losses))
    finite = all(math.isfinite(x) for x, y in zip(losses, ref)
                 if math.isfinite(y))
    check(same and finite, f"tp-train {name}: losses {losses} (finite where "
          f"{finite_as or 'every step'}), every card the same bits {same}")
    return out


def tp_train_psums(peer, cards, d: int) -> dict:
    """One forward g psum and one backward f psum of ``(8, 512, d)``
    bfloat16 a card (:mod:`repro_torch.models.tensor_parallel`'s
    ``psum`` and ``enter``), each in card shares in lockstep over a peer
    ring of its own: the call by CUDA events on every card (the slowest)
    and the ring's kernels' device ms a card from the profiler; beside
    them :func:`psum_times` of the same operand (its program's replay,
    NCCL's all-reduce, the bytes a card takes in at 450 GB/s and the
    dry-run's one-link term)."""
    from repro_torch.comm import collectives as coll
    from repro_torch.models import moe_dist
    from repro_torch.models import tensor_parallel as tp

    b, s = TP_TRAIN_TOKENS
    gen = torch.Generator(device=cards[0]).manual_seed(5)
    xs = [torch.randn(b, s, d, generator=gen, device=cards[0]).to(
        torch.bfloat16).to(c) for c in cards]

    def runner(kind: str):
        ring = coll.PeerRing(peer.session.engine)

        def body(lock, card):
            with moe_dist.card_share(lock, card), \
                    torch.autograd.set_multithreading_enabled(False):
                if kind == "g":
                    tp.psum(xs[card])
                else:
                    x = xs[card].detach().requires_grad_()
                    with torch.enable_grad():
                        (y,) = tp.enter(x)
                        torch.autograd.grad(y, x, grad_outputs=xs[card])

        def call():
            ring.begin()
            lock = coll.LockstepRing(ring)
            coll.run_in_lockstep(lock, [
                (c, lambda card, lock=lock: body(lock, card))
                for c in cards])
        return call

    out = {"rows": b * s, "d": d}
    for kind in ("g", "f"):
        call = runner(kind)
        call_ms, per = cards_call_ms(call, cards, 10)
        prof = moe_profile(call, cards)
        out[kind] = {"call_ms": call_ms, "call_ms_cards": per,
                     "ring_ms_a_card": sum(prof["by_kernel"].values())
                     / len(cards), "by_kernel": prof["by_kernel"]}
    out["psum"] = psum_times(peer.session, cards, b * s, d)
    return out


def tp_train(cards, smi) -> dict:
    """``--tp-train``: Llama-3 8B, and Nemotron-4 340B at its whole
    vocabulary, trained tensor parallel on a peer mesh a card (module
    docstring)."""
    from repro_torch.launch.mesh import make_host_mesh

    peer = make_host_mesh((1, 4), devices=cards)
    # the measurements first, the checks against one card after them
    out = {"cards": smi,
           "llama3_8b": tp_train_deep(cards, peer, "llama3_8b"),
           "nemotron_4_340b": tp_train_deep(cards, peer, "nemotron_4_340b"),
           "psums": tp_train_psums(peer, cards, 4096)}
    row = out["psums"]
    p = row["psum"]
    print(f"tp-train psums of ({row['rows']}, {row['d']}) bfloat16 a card on "
          f"4 cards ({smi[0]}): forward g {row['g']['call_ms']:.4f} ms a call "
          f"(CUDA events, slowest card; one host thread a card), its ring "
          f"kernels {row['g']['ring_ms_a_card']:.4f} ms a card (profiler); "
          f"backward f {row['f']['call_ms']:.4f} ms, ring kernels "
          f"{row['f']['ring_ms_a_card']:.4f} ms a card; the same psum's "
          f"program replayed {p['replay_ms']:.4f} ms; NCCL's all-reduce "
          f"{p['nccl_ms']} ms; bound {p['bound_ms']:.4f} ms "
          f"({p['wire_bytes_a_card'] / 1e6:.2f} MB into a card at 450 "
          f"GB/s); the dry-run's modeled term {p['modeled_ms']:.4f} ms (one "
          f"NVLink 4 link)", flush=True)
    out["check_float32"] = tp_train_check(cards, peer, "float32")
    out["check_bfloat16"] = tp_train_check(cards, peer, "bfloat16")
    return out


#: ``--ssm-tp``'s families: their serving paths' prompt lengths
#: (``chip_smoke.py``'s paths G and K) and the engine's length.
SSM_TP = {"rwkv6_1_6b": {"prompts": (1024, 768, 512, 256), "max_len": 256},
          "hymba_1_5b": {"prompts": (1536, 1024, 768, 512),
                         "max_len": 1536 + MOE_NEW}}


def ssm_tp_serve(cards, peer, name: str, smi) -> dict:
    """``--ssm-tp`` serving: ``name`` whole on its serving path's seeded
    weights (drawn on card 0 from seed 0, as ``chip_smoke.py``'s
    ``init_model``) and prompts, one card's unsharded engine, then the
    peer mesh's (each card's quarter of the mixer, MLP and vocabulary
    placed from the weights on card 0): :func:`against_stacked`, each
    run's times (:func:`moe_times`), tokens/s, ``ring_allgather`` launches
    a decode replay (one a card a psum and one for the logits), each
    card's peak GiB."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import ServeEngine
    from repro_torch.training import sharding as shd

    c0, spec = cards[0], SSM_TP[name]
    cfg = get_config(name)
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), generator=gen).tolist()
               for n in spec["prompts"]]
    params = tfm.init_params(cfg, generator=torch.Generator(
        device=c0).manual_seed(0), device=c0)
    reset_peaks(cards)
    engine = ServeEngine(cfg, params, max_len=spec["max_len"])
    want = moe_serve(engine, prompts, [c0])
    one = moe_times(engine, want, [c0])
    one["peak_gib"] = peaks_gib([c0])
    del engine
    free(cards)
    reset_peaks(cards)
    keep: dict = {}
    with set_mesh(peer):
        engine = ServeEngine(cfg, params, max_len=spec["max_len"])
        got = moe_serve(engine, prompts, cards)
        out = against_stacked(engine, got, want, cards, keep)
        out.update(moe_times(engine, got, cards))
        out["cuts"] = [str(c) for c in engine.cuts]
        out["cache"] = {k: list(t.shape) for k, t in
                        engine.decode_program(len(prompts)).caches[0].items()}
        out["peak_gib"] = peaks_gib(cards)
        del engine
    tok = want["logits"][:, -1].argmax(-1)[:, None]
    # the twin (chip_smoke.py's serve_twin, as path AD holds its emulated
    # two cards): the unsharded run and the four cards' in the family's
    # twin dtype within TP_BOUND at every position, its controls beyond
    # it; the bfloat16 runs' median distances from it
    cs = smoke()
    twin = cs.serve_twin(cfg, params, want["toks"], tok, peer,
                         spec["max_len"])
    for phase, tp16, one16 in (("prefill", got["logits"], want["logits"]),
                               ("decode", keep.pop("step"), want["step"])):
        ref = twin["ref"][phase]
        twin["per"][phase]["tp16"] = cs.position_distances(tp16, ref)
        twin["per"][phase]["one16"] = cs.position_distances(one16, ref)
    out["distances"] = cs.twin_distances(twin, TP_BOUND)
    out["verdict"] = cs.twin_verdict(out["distances"])
    out["twin_dtype"] = twin["dtype"]
    out["twin_same_bits"] = twin["same_cards"]
    del twin
    free(cards)
    tokens = len(prompts) * MOE_NEW
    # a layer's psums: RWKV-6's time mix and MLP; Hymba's Mamba gates and
    # output and MLP (and its attention where its heads are cut; not its
    # 25); the embedding's psum and the logits' gather where the
    # vocabulary is cut (RWKV-6's 65,536; not Hymba's 32,001)
    cut = shd.card_cuts(cfg, peer)[0]
    a_layer = 2 if cfg.family == "ssm" else 3 + int(cut.heads)
    vocab = int(cut.vocab)
    psums = vocab + a_layer * cfg.num_layers
    out.update({"name": name, "layers": cfg.num_layers, "unsharded": one,
                "tokens_per_s": tokens / got["gen_s"][1],
                "unsharded_tokens_per_s": tokens / want["gen_s"][1],
                "generate_s": got["gen_s"],
                "unsharded_generate_s": want["gen_s"]})
    print(f"ssm-tp {name} served whole ({cfg.num_layers} layers, "
          f"prompts {list(spec['prompts'])}, {MOE_NEW} new tokens) on "
          f"{peer} a card ({smi[0]}), cuts {out['cuts'][0]}, card 0's cache "
          f"{out['cache']}: every card the same bits "
          f"{out['every_card_same_bits']}; against one card's unsharded run "
          f"max abs err {out['max_abs_err']} (max |logit| "
          f"{out['max_abs_logit']}, within {TP_BOUND} of it: "
          f"{out['within_bound']}); greedy tokens agree in "
          f"{out['tokens_agree']} of {out['tokens']}; prefill replay "
          f"{out['prefill_ms']:.2f} ms (one card's {one['prefill_ms']:.2f}), "
          f"captured decode step {out['decode_ms']:.3f} ms "
          f"({one['decode_ms']:.3f}); generate {got['gen_s'][1]:.3f} s = "
          f"{out['tokens_per_s']:.1f} tokens/s (one card "
          f"{want['gen_s'][1]:.3f} s = {out['unsharded_tokens_per_s']:.1f}); "
          f"ring_allgather {out['gather_launches_a_decode']} launches a "
          f"decode replay; peak GiB a card {out['peak_gib']} (one card "
          f"{one['peak_gib']}); against the unsharded {out['twin_dtype']} "
          f"twin (each position's largest distance: the largest, median, "
          f"share within {TP_BOUND} of the largest |logit|, where; tp the "
          f"four cards' twin, every card the same bits "
          f"{out['twin_same_bits']}; drop and swap its controls; one16 one "
          f"card's bfloat16 run, tp16 the four cards', drop16 the control): "
          f"{out['distances']}; verdict {out['verdict']}", flush=True)
    for what in ("prefill", "decode"):
        prof = out[f"{what}_profile"]
        print(f"ssm-tp {name}, profiler, one {what} replay on 4 cards: "
              f"{prof['device_ms_all_cards']:.2f} ms of device time in "
              f"{prof['kernels']} kernels; the ring's kernels "
              f"{prof['by_kernel']} ms over the cards; top (name, ms, "
              f"count): {prof['top']}", flush=True)
    check(out["every_card_same_bits"] and out["twin_same_bits"]
          and all(out["verdict"].values()), f"ssm-tp {name}: {out}")
    check(out["gather_launches_a_decode"] == (psums + vocab) * len(cards),
          f"ssm-tp {name}: {out['gather_launches_a_decode']} ring_allgather "
          f"launches a decode replay, not one a card a psum ({psums}) and "
          f"one for the logits where the vocabulary is cut")
    del params, want, got
    free(cards)
    return out


#: ``--ssm-tp``'s one-card training steps: as many as :func:`tp_train_deep`
#: takes on the four cards (its first, timed and profiled ones), on the
#: same batches in the same order.
SSM_TP_STEPS = 3 + TP_TRAIN_TIMED


def ssm_tp_train_one(c0, name: str) -> dict:
    """``--ssm-tp`` training on one card: ``name`` whole, unsharded, in
    its bfloat16 with float32 moments, ``remat="full"``, 8 x 512 tokens,
    from the weights :func:`tp_train_deep` draws, SSM_TP_STEPS steps: the
    first step, a step by CUDA events, tokens/s, peak GiB, the losses
    (the four cards' reference: RWKV-6's bfloat16 run itself reaches NaN
    at its fifth step at this lr, H100 80GB HBM3 at 700 W)."""
    from repro_torch.configs import get_config
    from repro_torch.optim import init_opt_state
    from repro_torch.training import TrainStepConfig, make_train_step

    cfg = get_config(name)
    opt = tp_train_opt(cfg)
    reset_peaks([c0])
    (params,) = placed_trees(cfg, [c0], seed=0)
    box = [{"params": params, "opt": init_opt_state(params, opt)}]
    del params
    batches = tp_train_batches(cfg, c0, 1 + TP_TRAIN_TIMED)
    step = make_train_step(cfg, TrainStepConfig(), opt, device=c0)
    losses = []

    def one():
        box[0], m = step(box[0], batches[len(losses) % len(batches)])
        losses.append(m["loss"])

    t0 = time.perf_counter()
    one()
    sync_all([c0])
    first_s = time.perf_counter() - t0
    step_ms, _ = cards_call_ms(one, [c0], TP_TRAIN_TIMED, warmup=0)
    while len(losses) < SSM_TP_STEPS:
        one()
    out = {"name": name, "layers": cfg.num_layers, "first_step_s": first_s,
           "step_ms": step_ms, "tokens_per_s": math.prod(TP_TRAIN_TOKENS)
           / step_ms * 1e3, "peak_gib": peaks_gib([c0])[0],
           "losses": [float(x) for x in losses]}
    print(f"ssm-tp {name} trained whole on one card, unsharded ("
          f"{cfg.num_layers} layers, {cfg.dtype}, float32 moments, remat "
          f"full, {TP_TRAIN_TOKENS[0]} x {TP_TRAIN_TOKENS[1]} tokens, the "
          f"four cards' weights and batches): a "
          f"step {step_ms:.2f} ms (CUDA events) = {out['tokens_per_s']:.0f} "
          f"tokens/s; the first {first_s:.2f} s; losses {out['losses']}; "
          f"peak {out['peak_gib']} GiB", flush=True)
    check(math.isfinite(out["losses"][0]),
          f"ssm-tp {name}: losses {out['losses']}")
    del box, step
    free([c0])
    return out


def ssm_tp(cards, smi, write) -> dict:
    """``--ssm-tp``: RWKV-6 1.6B and Hymba-1.5B served and trained tensor
    parallel on a peer mesh a card (module docstring); ``write(out)``
    after each part, every part run even where one before it failed."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh

    peer = make_host_mesh((1, 4), devices=cards)
    out: dict = {"cards": smi, "failed": []}

    def part(name: str, key: str, fn) -> None:
        """``out[name][key] = fn()``; a failed check is recorded and the
        next part runs (the call exits 1 at the end)."""
        try:
            out[name][key] = fn()
        except SystemExit:
            out[name][key] = None
            out["failed"].append(f"{key} of {name}")
            free(cards)
        write(out)

    cs = smoke()
    for name in SSM_TP:
        out[name] = {}
        part(name, "serve", lambda: ssm_tp_serve(cards, peer, name, smi))
        part(name, "train_one_card", lambda: ssm_tp_train_one(cards[0],
                                                              name))
        one = out[name].get("train_one_card") or {}
        part(name, "train", lambda: tp_train_deep(
            cards, peer, name, layers=get_config(name).num_layers,
            finite_as=one.get("losses")))
    part("rwkv6_1_6b", "scan_bwd_card_heads",
         lambda: ssm_tp_scan_bwd(cards[0]))
    # the checks against one card after the measurements: step 1's
    # gradients within path M's float32 bound of the family
    # (chip_smoke.py's DP_GRAD_REL); RWKV-6's also with the plain scan
    for name in SSM_TP:
        ssm = get_config(name).family == "ssm"
        limit = cs.DP_GRAD_REL[get_config(name).family]
        part(name, "check_float32", lambda: tp_train_check(
            cards, peer, "float32", name, layers=None, grad_limit=limit,
            params_within_lr=ssm))
        if ssm:
            def plain():
                with cs.rwkv_patched(cs.plain_scan):
                    return tp_train_check(
                        cards, peer, "float32", name, layers=None,
                        grad_limit=limit, params_within_lr=True)
            part(name, "check_float32_plain_scan", plain)
    check(not out["failed"], f"ssm-tp: failed {out['failed']}")
    return out


def ssm_tp_scan_bwd(c0) -> dict:
    """``--ssm-tp``: ``rwkv6_scan_bwd`` at a card's 8 of RWKV-6's 32 heads,
    ``(8, 512, 8, 64, 64)``, in bfloat16 and in float32 (the float32
    check's), against its plain version on the same inputs (path M's
    inputs; chip_smoke.py's RWKV_BWD_REL)."""
    cs = smoke()
    gen = torch.Generator(device=c0).manual_seed(44)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=c0).to(dtype)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, device=c0)

    b, s, _, dk, dv = cs.RWKV_BWD_SHAPE
    out = {}
    for dtype in (torch.bfloat16, torch.float32):
        inputs = cs.rwkv_bwd_inputs(randn, rand, b, s, 8, dk, dv, 64, dtype)
        rel, _, _ = cs.scan_bwd_errs(*inputs, 64)
        out[str(dtype)] = rel
        del inputs
    print(f"ssm-tp: rwkv6_scan_bwd at a card's 8 heads {(b, s, 8, dk, dv)} "
          f"against its plain version, each gradient's largest difference "
          f"over its largest |value| (limits {cs.RWKV_BWD_REL}): {out}",
          flush=True)
    check(all(e <= cs.RWKV_BWD_REL[getattr(torch, k.split('.')[-1])]
              for k, rel in out.items() for e in rel.values()),
          f"ssm-tp: rwkv6_scan_bwd at 8 heads: {out}")
    free([c0])
    return out


def timed_send(sess, x, src: int, dst: int, cards, **kw):
    """One ``sess.send`` synced on every card: (received, host ms, its
    sample's plan + lower + schedule ms, capture ms, backoff slept ms)."""
    slept = []
    sleep = time.sleep

    def timed_sleep(seconds):             # the engine's backoff sleeps
        s0 = time.perf_counter_ns()
        sleep(seconds)
        slept.append(time.perf_counter_ns() - s0)

    sync_all(cards)
    time.sleep = timed_sleep
    try:
        t0 = time.perf_counter()
        got = sess.send(x, src, dst, **kw)
        sync_all(cards)
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        time.sleep = sleep
    st = sess.telemetry.samples()[-1].stages
    return (got, wall, (st.plan_ns + st.lower_ns + st.schedule_ns) / 1e6,
            st.compile_ns / 1e6, sum(slept) / 1e6)


def health_midtraffic(cards, big, want) -> dict:
    """The mid-traffic failure of (0, 1), its restore and readmission by
    probes across the cards (module docstring)."""
    from repro_torch.comm import CommConfig, CommSession
    from repro_torch.comm.engine import PlacedKey

    n = big.numel()
    nbytes = n * 4
    sess = CommSession(CommConfig(telemetry=True), devices=cards)
    pre = sess.describe(0, 1, nbytes)["graph"]["digest"]
    rows, out = [], {}
    for i in range(10):
        if i == 3:
            sess.topology.fail_link(0, 1)
        if i == 6:
            sess.topology.restore_link(0, 1)
            probed = [(0, 1), (2, 1), (3, 0)]
            for link in probed:
                sess.monitor.quarantine_link(link, reason="droop")
            sweeps, verdicts = 0, []
            while sess.planner.quarantined and sweeps < 10:
                verdicts.append({f"{a}->{b}": ok for (a, b), ok in
                                 sess.probe_links().items()})
                sweeps += 1
            check(not sess.planner.quarantined, f"the probed links were "
                  f"not readmitted: {verdicts}")
            check(sess.describe(0, 1, nbytes)["graph"]["digest"] == pre,
                  "the post-readmit digest is not the pre-fault one")
            out["probes"] = {"links": [list(x) for x in probed],
                             "sweeps": sweeps, "verdicts": verdicts}
        cache0 = sess.stats()["cache"]
        got, wall, plan_ms, cap_ms, back_ms = timed_send(sess, big, 0, 1,
                                                         cards)
        check(got.device == cards[1] and torch.equal(got, want),
              f"send {i} not bitwise on card 1")
        cache1 = sess.stats()["cache"]
        level = sess.stats()["health"]["ladder_level"]
        check(level == (1 if 3 <= i < 6 else 0),
              f"send {i} at ladder level {level}")
        e = entry_for(sess, ((0, 1, n, "float32"),), None)
        prog = e.compiled.program
        if 3 <= i < 6:
            check(all((0, 1) not in p.directional_links() for p in e.plans),
                  f"send {i} routed over the failed (0, 1)")
        rows.append({"send": i, "host_ms": wall, "plan_ms": plan_ms,
                     "capture_ms": cap_ms, "backoff_ms": back_ms,
                     "new_captures": cache1["misses"] - cache0["misses"],
                     "graphs": len(prog._graphs)})
        if i in (2, 5):
            rep, per = replay_cards_ms(prog, 20)
            out["healthy" if i == 2 else "fault"] = {
                "paths": routes(e)[0], "replay_ms": rep,
                "replay_ms_per_card": per,
                "replay_gbps": nbytes / rep / 1e6}
        if i == 6:
            check(cache1["misses"] == cache0["misses"]
                  and cache1["hits"] == cache0["hits"] + 1,
                  "the readmitted send was not a plan-cache hit")
    small = big[:256]
    for (a, b) in out["probes"]["links"]:
        cache0 = sess.stats()["cache"]
        got = sess.send(small, a, b, max_paths=1)
        cache1 = sess.stats()["cache"]
        check(got.device == cards[b] and torch.equal(got.cpu(), small.cpu()),
              f"the probed plan's send {a}->{b} not bitwise")
        check(cache1["misses"] == cache0["misses"]
              and cache1["hits"] == cache0["hits"] + 1,
              f"the send of the probed plan {a}->{b} was not a cache hit")
    check(all(isinstance(k, PlacedKey) for k in sess.engine.cache._store),
          "a plan-cache key is not a PlacedKey")
    out["sends"] = rows
    out["bound_ms"] = nbytes / NVLINK_BYTES_PER_S * 1e3
    h, f = out["healthy"], out["fault"]
    print(f"mid-traffic failure of (0, 1), 512 MiB f32 sends 0->1 with the "
          f"planner's paths, failed before send 3, restored before send 6, "
          f"then {out['probes']['links']} quarantined and readmitted after "
          f"{out['probes']['sweeps']} probe sweeps across the cards "
          f"(verdicts {out['probes']['verdicts']}), the pre-fault digest "
          f"back as a cache hit, each probed plan's send a hit, every key "
          f"a PlacedKey; per send (i, host ms synced, plan+lower+schedule "
          f"ms, capture ms, backoff ms, new captures, graphs): "
          + ", ".join(f"({r['send']}, {r['host_ms']:.3f}, "
                      f"{r['plan_ms']:.3f}, {r['capture_ms']:.3f}, "
                      f"{r['backoff_ms']:.3f}, {r['new_captures']}, "
                      f"{r['graphs']})" for r in rows)
          + f"; replay (CUDA events, slowest card) healthy via {h['paths']} "
          f"{h['replay_ms']:.4f} ms ({h['replay_gbps']:.1f} GB/s), under "
          f"the fault via {f['paths']} {f['replay_ms']:.4f} ms "
          f"({f['replay_gbps']:.1f} GB/s; each card "
          f"{[round(t, 4) for t in f['replay_ms_per_card']]}); bound "
          f"{out['bound_ms']:.4f} ms (450 GB/s)", flush=True)
    return out


def health_relay(cards, big, want) -> dict:
    """The host relay across the cards against a plain pinned copy."""
    from repro_torch.comm import CommConfig, CommSession

    nbytes = big.numel() * 4
    sess = CommSession(CommConfig(), devices=cards)
    for src in (0, 2, 3):
        sess.topology.fail_link(src, 1)
    sync_all(cards)
    t0 = time.perf_counter()
    got = sess.send(big, 0, 1)
    sync_all(cards)
    first_ms = (time.perf_counter() - t0) * 1e3
    check(got.device == cards[1] and torch.equal(got, want),
          "the host relay not bitwise on card 1")
    h = sess.stats()["health"]
    check(h["ladder_level"] == 3 and h["host_relays"] == 1,
          f"the relay left health {h}")
    del got
    steady = host_ms(lambda: sess.send(big, 0, 1), cards, 5, warmup=1)
    pinned = []

    def plain():
        staged = big.to("cpu", non_blocking=True)
        pinned.append(staged.is_pinned())
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(cards[0]))
        torch.cuda.current_stream(cards[1]).wait_event(ev)
        return staged.to(cards[1], non_blocking=True)

    check(torch.equal(plain(), want), "the plain pinned copy not bitwise")
    plain_ms = host_ms(plain, cards, 5, warmup=1)
    again = host_ms(lambda: sess.send(big, 0, 1), cards, 5, warmup=1)
    bound_ms = 2 * nbytes / PCIE_BYTES_PER_S * 1e3
    out = {"first_ms": first_ms, "steady_ms": [steady, again],
           "gbps": [nbytes / t / 1e6 for t in (steady, again)],
           "plain_ms": plain_ms, "plain_gbps": nbytes / plain_ms / 1e6,
           "plain_pinned": all(pinned), "bound_ms": bound_ms,
           "ratio_to_plain": [t / plain_ms for t in (steady, again)],
           "relays": sess.stats()["health"]["host_relays"]}
    print(f"host relay across cards, every device link into card 1 failed, "
          f"512 MiB f32 0->1 (ladder level 3, bitwise on card 1): first "
          f"call {first_ms:.3f} ms (pinned allocation included), steady "
          f"{steady:.3f} / {again:.3f} ms synced = "
          f"{out['gbps'][0]:.2f} / {out['gbps'][1]:.2f} GB/s; plain "
          f"x.to('cpu', non_blocking=True) (pinned: {all(pinned)}) on to "
          f"card 1 {plain_ms:.3f} ms = {out['plain_gbps']:.2f} GB/s; relay "
          f"/ plain {out['ratio_to_plain'][0]:.3f} / "
          f"{out['ratio_to_plain'][1]:.3f}; bound {bound_ms:.3f} ms (twice "
          f"over PCIe Gen5 x16, 64 GB/s a direction)", flush=True)
    return out


def health_decode(cards, gen) -> dict:
    """Path F's migrating decode step through a failure of (0, 2)."""
    from repro_torch.comm import CommConfig, CommSession
    from repro_torch.comm.capture import PeerStepProgram
    from repro_torch.serving.engine import make_captured_decode_step

    n = len(cards)
    heads, kv_len, hd = 32, 2048, 128
    kv_chunk = 2 * 8 * kv_len * hd
    kw = dict(batch=1, heads=heads, kv_len=kv_len, head_dim=hd,
              kv_chunk=kv_chunk, src=0, dst=2, dtype=torch.bfloat16,
              schedule="overlap")
    q, k, v = (torch.randn(n, 1, heads, kv_len, hd, generator=gen,
                           device=cards[0]).to(torch.bfloat16)
               for _ in range(3))
    kv = torch.randn(n, kv_chunk, generator=gen, device=cards[0]).to(
        torch.bfloat16)
    stacked = CommSession(CommConfig(), device=cards[0])
    want_attn, want_kv = make_captured_decode_step(stacked, **kw)(q, k, v,
                                                                  kv)
    expect = kv.clone()
    expect[2] = kv[0]
    check(torch.equal(want_kv, expect), "the stacked decode step's KV chunk")
    sess = CommSession(CommConfig(), devices=cards)
    step = make_captured_decode_step(sess, **kw)
    per = [[t[i].to(cards[i]) for i in range(n)] for t in (q, k, v, kv)]
    out = {"first_call_ms": [], "replay_ms": {}, "graphs": [],
           "attn_max_abs_err": 0.0}
    for phase in ("healthy", "failed", "restored"):
        if phase == "failed":
            sess.topology.fail_link(0, 2)
        if phase == "restored":
            sess.topology.restore_link(0, 2)
        sync_all(cards)
        t0 = time.perf_counter()
        attn, new_kv = step(*per)
        sync_all(cards)
        out["first_call_ms"].append((time.perf_counter() - t0) * 1e3)
        got_kv = torch.stack([t.to(cards[0]) for t in new_kv])
        check(torch.equal(got_kv, expect), f"decode step ({phase}): the KV "
              f"chunk not bitwise")
        got = torch.stack([t.to(cards[0]) for t in attn]).float()
        diff = (got - want_attn.float()).abs()
        out["attn_max_abs_err"] = max(out["attn_max_abs_err"],
                                      diff.max().item())
        check(bool((diff <= 4e-3 + 8e-3 * want_attn.float().abs()).all()),
              f"decode step ({phase}) attention: max abs err "
              f"{diff.max().item()} against one card's stacked step")
        entry = step.resolve()
        prog = entry.compiled.program
        check(isinstance(prog, PeerStepProgram),
              "the decode step's program is not a PeerStepProgram")
        out["graphs"].append(len(prog._graphs))
        if phase == "failed":
            check(all((0, 2) not in p.directional_links()
                      for p in entry.plans),
                  "the decode step routed over the failed (0, 2)")
        if phase != "restored":
            out["replay_ms"][phase] = replay_cards_ms(prog, 10)[0]
    out["ladder_level"] = sess.stats()["health"]["ladder_level"]
    print(f"path F's captured decode step across {n} cards through a "
          f"failure of (0, 2): KV chunk bitwise in each call, attention max "
          f"abs err {out['attn_max_abs_err']} against one card's stacked "
          f"step; graphs a program {out['graphs']}; first call healthy / "
          f"failed / restored "
          f"{[round(t, 3) for t in out['first_call_ms']]} ms synced; "
          f"replay (CUDA events, slowest card) healthy "
          f"{out['replay_ms']['healthy']:.4f} ms, under the fault "
          f"{out['replay_ms']['failed']:.4f} ms", flush=True)
    return out


def health_droop(cards, gen) -> dict:
    """The droop monitor on healthy four-card traffic under a profile
    ``calibrate()`` fitted there: ratios and quarantines, reported."""
    from repro_torch.comm import CommConfig, CommSession

    sess = CommSession(CommConfig(telemetry=True), devices=cards)
    mon = sess.monitor
    ratios: dict[str, list] = {}
    culprits = []

    def observe(sample):
        before = mon.quarantines
        r = mon.observe(sample)
        if r is None:
            return
        ratios.setdefault(str(sample.nbytes), []).append(r)
        if mon.quarantines > before:
            culprits.append((sample.nbytes, round(r, 3),
                             sorted(map(list, mon.quarantined))))

    sess.telemetry.on_record = observe
    sizes = (64 * KiB, MiB, 16 * MiB, 64 * MiB, 256 * MiB)
    xs = {b: torch.randn(b // 4, generator=gen, device=cards[0])
          for b in sizes}
    wants = {b: x.to(cards[1]) for b, x in xs.items()}

    def traffic(reps: int) -> None:
        for b, x in xs.items():
            for mp in (1, None):
                for _ in range(reps):
                    check(torch.equal(sess.send(x, 0, 1, max_paths=mp),
                                      wants[b]),
                          f"droop traffic {b} B not bitwise")

    traffic(10)
    check(not ratios, "the monitor judged samples before a calibration")
    sess.calibrate(min_samples=3, warmup=2)
    traffic(10)
    sync_all(cards)
    out = {"threshold": mon.droop_threshold, "samples": mon.droop_samples,
           "ratios": {b: {"n": len(rs), "median": sorted(rs)[len(rs) // 2],
                          "max": max(rs),
                          "above": sum(r > mon.droop_threshold for r in rs)}
                      for b, rs in ratios.items()},
           "quarantines": mon.quarantines, "culprits": culprits,
           "readmissions": mon.readmissions,
           "health": sess.stats()["health"]}
    print(f"droop monitor on healthy 4-card sends under the fitted profile "
          f"(threshold {mon.droop_threshold}, {mon.droop_samples} in a row), "
          f"measured/modeled by bytes: "
          + "; ".join(f"{b} x{r['n']} median {r['median']:.4f} max "
                      f"{r['max']:.4f}, {r['above']} above"
                      for b, r in out["ratios"].items())
          + f"; quarantines {mon.quarantines} (bytes, ratio, set): "
          f"{culprits}; readmissions {mon.readmissions}; health "
          f"{out['health']}", flush=True)
    return out


def health(cards, smi) -> dict:
    """``--health``: the §4.6 ladder across the cards (module docstring)."""
    from repro_torch.comm import CommConfig, CommSession
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.multipath_dma import kernel as dk

    gen = torch.Generator(device=cards[0]).manual_seed(38)
    launches = (dk.LAUNCHES, fk.LAUNCHES)
    out: dict = {"cards": smi}
    big = torch.randn(128 * MiB, generator=gen, device=cards[0])  # 512 MiB
    want = big.to(cards[1])
    small, small1 = big[:16 * KiB], want[:16 * KiB]              # 64 KiB

    sessions = {on: CommSession(CommConfig(telemetry=True, health=on),
                                devices=cards) for on in (True, False)}
    cost = {True: {"small_us": [], "big_ms": []},
            False: {"small_us": [], "big_ms": []}}
    for on in (True, False, False, True, True, False):
        sess = sessions[on]
        check(torch.equal(sess.send(small, 0, 1), small1)
              and torch.equal(sess.send(big, 0, 1), want),
              f"a healthy send with health={on} not bitwise")
        cost[on]["small_us"].append(
            host_ms(lambda: sess.send(small, 0, 1), cards, 200) * 1e3)
        cost[on]["big_ms"].append(
            device_ms(lambda: sess.send(big, 0, 1), cards, 10))
    for on, sess in sessions.items():
        check(sess.stats()["health"]["ladder_level"] == 0
              and (sess.monitor is not None) == on,
              f"health={on} session state wrong")
    out["healthy_cost"] = {("on" if on else "off"): c
                           for on, c in cost.items()}
    print(f"healthy cost, in turns: 64 KiB send 0->1 host us synced, on "
          f"{[round(t, 3) for t in cost[True]['small_us']]}, off "
          f"{[round(t, 3) for t in cost[False]['small_us']]}; 512 MiB send "
          f"(CUDA events) on {[round(t, 4) for t in cost[True]['big_ms']]}, "
          f"off {[round(t, 4) for t in cost[False]['big_ms']]} ms",
          flush=True)
    del sessions, sess
    free(cards)

    out["midtraffic"] = health_midtraffic(cards, big, want)
    free(cards)

    sess = CommSession(CommConfig(faults=HEALTH_SPEC, telemetry=True),
                       devices=cards)
    m16, w16 = big[:4 * MiB], want[:4 * MiB]
    rows = [timed_send(sess, m16, 0, 1, cards, max_paths=3)
            for _ in range(20)]
    check(all(torch.equal(r[0], w16) for r in rows),
          "an injected-schedule send not bitwise")
    h = sess.stats()["health"]
    got = {k: h[k] for k in HEALTH_COUNTS}
    check(got == HEALTH_COUNTS, f"the injected schedule gave {got}, not the "
          f"CPU's {HEALTH_COUNTS}")
    kinds = [e["kind"] for e in sess.drain_health_events()]
    out["injected"] = {
        "spec": HEALTH_SPEC, "counts": got,
        "host_ms": sum(r[1] for r in rows), "plan_ms": sum(r[2] for r in rows),
        "capture_ms": sum(r[3] for r in rows),
        "backoff_ms": sum(r[4] for r in rows),
        "captures": sess.stats()["cache"]["misses"], "events": kinds}
    i = out["injected"]
    print(f"injected {HEALTH_SPEC!r}, 20 sends of 16 MiB across the cards, "
          f"all bitwise: {got}, {i['captures']} captures; {i['host_ms']:.3f} "
          f"ms in all, of it backoff {i['backoff_ms']:.3f}, plan+lower+"
          f"schedule {i['plan_ms']:.3f}, capture {i['capture_ms']:.3f}; "
          f"events {kinds}", flush=True)
    del sess, rows
    free(cards)

    out["relay"] = health_relay(cards, big, want)
    free(cards)
    del big, want, small, small1, m16, w16
    free(cards)
    out["decode"] = health_decode(cards, gen)
    free(cards)
    out["droop"] = health_droop(cards, gen)
    free(cards)
    out["launches"] = {"multipath_dma": dk.LAUNCHES - launches[0],
                       "flash_attention": fk.LAUNCHES - launches[1]}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="time the kernels' grid and tiles instead of the "
                         "session's traffic")
    ap.add_argument("--collectives", action="store_true",
                    help="time the session's collectives alone")
    ap.add_argument("--training", action="store_true",
                    help="run the DP steps, the pipeline and the compressed "
                         "mean a card instead")
    ap.add_argument("--moe", action="store_true",
                    help="serve Mixtral-8x22B expert parallel on a peer "
                         "mesh a card instead")
    ap.add_argument("--moe-train", action="store_true",
                    help="train Mixtral-8x22B expert parallel on a peer "
                         "mesh a card instead")
    ap.add_argument("--health", action="store_true",
                    help="run the health ladder across the cards instead")
    ap.add_argument("--tp", action="store_true",
                    help="serve Nemotron-4 340B tensor parallel on a peer "
                         "mesh a card instead")
    ap.add_argument("--tp-train", action="store_true",
                    help="train Llama-3 8B and Nemotron-4 340B tensor "
                         "parallel on a peer mesh a card instead")
    ap.add_argument("--ssm-tp", action="store_true",
                    help="serve and train RWKV-6 1.6B and Hymba-1.5B "
                         "tensor parallel on a peer mesh a card instead")
    ap.add_argument("--src", help="another checkout's src/ directory to "
                                  "import the package from")
    args = ap.parse_args()
    cards = peer_cards(4)
    from repro_torch.comm import CommConfig, CommSession
    from repro_torch.core.halo import jacobi_step
    from repro_torch.kernels import _build
    from repro_torch.kernels.multipath_dma import kernel as dk

    for cmd in (["topo", "-m"], ["topo", "-p2p", "n"], ["nvlink", "-s"]):
        out = subprocess.run(["nvidia-smi", *cmd], capture_output=True,
                             text=True)
        print(f"nvidia-smi {' '.join(cmd)} (exit {out.returncode}):\n"
              f"{out.stdout}{out.stderr}", flush=True)
        if out.returncode == 0 and "Failed" not in out.stdout:
            break
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    for i, line in enumerate(smi):
        print(f"card {i}: {line}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; package "
          f"from {SRC}", flush=True)
    t0 = time.perf_counter()
    _build.build_all(("multipath_dma", "jacobi", "ring_allgather",
                      "flash_attention", "flash_attention_bwd")
                     + (("rwkv6_scan", "rwkv6_scan_bwd") if args.ssm_tp
                        else ()))
    print(f"build: {time.perf_counter() - t0:.2f} s", flush=True)
    if (args.sweep or args.collectives or args.training or args.moe
            or args.moe_train or args.health or args.tp or args.tp_train
            or args.ssm_tp):
        if args.sweep:
            sweep(cards)
        elif args.ssm_tp:
            torch.backends.cuda.matmul.allow_tf32 = False
            os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)

            def write(results):
                with open(os.path.join(ROOT, "chiprun_out",
                                       "peer_ssm_tp.json"), "w") as f:
                    json.dump(results, f, indent=1, default=str)

            results = ssm_tp(cards, smi, write)
            print(json.dumps({"ssm_tp": results}, default=str), flush=True)
        elif args.tp_train:
            torch.backends.cuda.matmul.allow_tf32 = False
            results = tp_train(cards, smi)
            os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
            with open(os.path.join(ROOT, "chiprun_out",
                                   "peer_tp_train.json"), "w") as f:
                json.dump(results, f, indent=1, default=str)
            print(json.dumps({"tp_train": results}, default=str),
                  flush=True)
        elif args.tp:
            torch.backends.cuda.matmul.allow_tf32 = False
            results = tp(cards, smi)
            os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
            with open(os.path.join(ROOT, "chiprun_out", "peer_tp.json"),
                      "w") as f:
                json.dump(results, f, indent=1, default=str)
            print(json.dumps({"tp": results}, default=str), flush=True)
        elif args.health:
            results = health(cards, smi)
            os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
            with open(os.path.join(ROOT, "chiprun_out", "peer_health.json"),
                      "w") as f:
                json.dump(results, f, indent=1)
            print(json.dumps({"health": results}), flush=True)
        elif args.moe_train:
            torch.backends.cuda.matmul.allow_tf32 = False
            results = moe_train(cards, smi)
            os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
            with open(os.path.join(ROOT, "chiprun_out",
                                   "peer_moe_train.json"), "w") as f:
                json.dump(results, f, indent=1)
            print(json.dumps({"moe_train": results}), flush=True)
        elif args.moe:
            torch.backends.cuda.matmul.allow_tf32 = False
            results = moe(cards, smi)
            os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
            with open(os.path.join(ROOT, "chiprun_out", "peer_moe.json"),
                      "w") as f:
                json.dump(results, f, indent=1)
            print(json.dumps({"moe": results}), flush=True)
        elif args.training:
            torch.backends.cuda.matmul.allow_tf32 = False
            results = training(cards, smi)
            os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
            with open(os.path.join(ROOT, "chiprun_out",
                                   "peer_training.json"), "w") as f:
                json.dump(results, f, indent=1)
            print(json.dumps({"training": results}), flush=True)
        else:
            gen = torch.Generator(device=cards[0]).manual_seed(0)
            print(json.dumps({"collectives": collectives(cards, gen),
                              "src": SRC}), flush=True)
        print(f"cards: {smi[0]}", flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": len(cards)}}), flush=True)
        return 0

    sess = CommSession(CommConfig(telemetry=True, health=False),
                       devices=cards)
    check(sess.stats()["devices"] == [str(c) for c in cards],
          "session does not list its cards")
    gen = torch.Generator(device=cards[0]).manual_seed(0)
    results: dict[str, list] = {"send": [], "bidirectional": []}
    launches = dk.LAUNCHES

    for nbytes in SIZES:
        n = nbytes // 4
        x = torch.randn(n, generator=gen, device=cards[0])
        x1 = x.to(cards[1])
        y = torch.empty_like(x1)
        copy_ms = device_ms(lambda: y.copy_(x), cards, iters_for(nbytes))
        pair = []
        for mp in (1, None):
            for _ in range(2):
                out = sess.send(x, 0, 1, max_paths=mp)
                check(out.device == cards[1] and torch.equal(out, x1),
                      f"send {nbytes} B max_paths={mp} not bitwise")
            e = entry_for(sess, ((0, 1, n, "float32"),), mp)
            prog = e.compiled.program
            check(prog.completed_nodes() == e.graph.num_copy_nodes,
                  f"send {nbytes} B: completed != copy nodes")
            rep = device_ms(prog.replay, cards, iters_for(nbytes))
            host = host_ms(lambda: sess.send(x, 0, 1, max_paths=mp), cards,
                           min(50, iters_for(nbytes)))
            row = {"nbytes": nbytes, "max_paths": mp,
                   "paths": routes(e)[0], "copy_nodes":
                       e.graph.num_copy_nodes,
                   "replay_ms": rep, "replay_gbps": nbytes / rep / 1e6,
                   "send_ms": host, "send_gbps": nbytes / host / 1e6,
                   "copy_ms": copy_ms, "copy_gbps": nbytes / copy_ms / 1e6,
                   "bound_ms": nbytes / NVLINK_BYTES_PER_S * 1e3,
                   "launches": prog.replay_launches}
            results["send"].append(row)
            pair.append(row)
            print(f"send {nbytes} B 0->1 max_paths={mp}: paths "
                  f"{row['paths']}, {row['copy_nodes']} copy nodes, bitwise;"
                  f" replay {rep:.4f} ms = {row['replay_gbps']:.1f} GB/s, "
                  f"session.send {host:.4f} ms = {row['send_gbps']:.1f} GB/s"
                  f" (host clock, synced), peer y.copy_(x) {copy_ms:.4f} ms ="
                  f" {row['copy_gbps']:.1f} GB/s, bound "
                  f"{row['bound_ms']:.4f} ms (450 GB/s); launches a replay "
                  f"{prog.replay_launches}", flush=True)
        single, multi = pair
        print(f"size {nbytes} B: single-path replay "
              f"{single['replay_ms']:.4f} ms, "
              f"{single['bound_ms'] / single['replay_ms']:.1%} of dst's "
              f"ingress bound, {single['replay_ms'] / copy_ms:.3f}x the peer "
              f"copy_ ({copy_ms:.4f} ms); multi-path {multi['replay_ms']:.4f}"
              f" ms, multi/single {single['replay_ms'] / multi['replay_ms']:.3f}"
              f" (throughput)", flush=True)
        del x, x1, y

    for nbytes in SIZES:
        n = nbytes // 4
        x = torch.randn(n, generator=gen, device=cards[0])
        x1 = x.to(cards[1])
        ya, yb = torch.empty_like(x1), torch.empty_like(x)

        def both():
            ya.copy_(x)
            yb.copy_(x1)

        copy_ms = device_ms(both, cards, iters_for(2 * nbytes))
        for mp in (1, None):
            fwd, rev = sess.bidirectional(x, 0, 1, max_paths=mp)
            check(fwd.device == cards[1] and torch.equal(fwd, x1)
                  and rev.device == cards[0] and torch.equal(rev, x),
                  f"bidirectional {nbytes} B max_paths={mp} not bitwise")
            e = entry_for(sess, ((0, 1, n, "float32"), (1, 0, n, "float32")),
                          mp)
            prog = e.compiled.program
            rep = device_ms(prog.replay, cards, iters_for(2 * nbytes))
            host = host_ms(lambda: sess.bidirectional(x, 0, 1, max_paths=mp),
                           cards, min(50, iters_for(2 * nbytes)))
            row = {"nbytes": nbytes, "max_paths": mp, "paths": routes(e),
                   "replay_ms": rep, "replay_gbps": 2 * nbytes / rep / 1e6,
                   "call_ms": host, "copy_ms": copy_ms,
                   "copy_gbps": 2 * nbytes / copy_ms / 1e6,
                   "bound_ms": nbytes / NVLINK_BYTES_PER_S * 1e3}
            results["bidirectional"].append(row)
            print(f"bidirectional {nbytes} B 0<->1 max_paths={mp}: paths "
                  f"{row['paths']}, bitwise; replay {rep:.4f} ms = "
                  f"{row['replay_gbps']:.1f} GB/s both ways, call "
                  f"{host:.4f} ms, two peer copy_ {copy_ms:.4f} ms = "
                  f"{row['copy_gbps']:.1f} GB/s, bound {row['bound_ms']:.4f}"
                  f" ms", flush=True)
        del x, x1, ya, yb

    n = 16 * MiB                                          # 64 MiB each
    msgs = [torch.randn(n, generator=gen, device=cards[0]).to(cards[i])
            for i in range(4)]
    items = [(msgs[i], i, (i + 1) % 4) for i in range(4)]
    got = sess.exchange(items)
    for i, g in enumerate(got):
        check(g.device == cards[(i + 1) % 4]
              and torch.equal(g, msgs[i].to(g.device)),
              f"exchange message {i} not bitwise")
    e = entry_for(sess, tuple((i, (i + 1) % 4, n, "float32")
                              for i in range(4)), None)
    rep = device_ms(e.compiled.program.replay, cards, 20)
    host = host_ms(lambda: sess.exchange(items), cards, 20)
    results["exchange"] = {"nbytes_each": 4 * n, "paths": routes(e),
                           "replay_ms": rep,
                           "replay_gbps": 4 * 4 * n / rep / 1e6,
                           "call_ms": host}
    print(f"exchange 4 x 64 MiB, card i -> i+1: paths {routes(e)}, bitwise; "
          f"replay {rep:.4f} ms = {results['exchange']['replay_gbps']:.1f} "
          f"GB/s in all, call {host:.4f} ms", flush=True)
    del msgs, items, got

    results["collectives"] = collectives(cards, gen)

    ranks, rows, cols, iters = 4, 8, 1 << 22, 10
    u0 = torch.randn(ranks, rows, cols, generator=gen, device=cards[0])
    stacked = CommSession(device=cards[0])
    u = u0
    for _ in range(iters):
        u = jacobi_step(u, session=stacked)
    blocks = [u0[i].to(cards[i]) for i in range(4)]
    for _ in range(iters):
        blocks = jacobi_step(blocks, session=sess)
    sync_all(cards)
    check(all(b.device == c for b, c in zip(blocks, cards)),
          "Jacobi blocks left their cards")
    check(torch.equal(torch.stack([b.to(cards[0]) for b in blocks]), u),
          "peer Jacobi differs from one card's stacked run")
    print(f"Jacobi {ranks}x({rows},{cols}) f32, {iters} iterations on 4 "
          f"cards: bitwise the one-card stacked run", flush=True)
    del blocks
    results.update(captured_steps(cards, stacked, u0, rows, cols, iters, u,
                                  gen))
    del u0, u, stacked

    t0 = time.perf_counter()
    prof = sess.calibrate(min_samples=2, warmup=1)
    fit_ms = (time.perf_counter() - t0) * 1e3
    links = {f"{a}->{b}": round(g, 3)
             for (a, b), g in sorted(prof.link_bandwidth_gbps.items())}
    samples = {f"{a}->{b}": k
               for (a, b), k in sorted(prof.link_samples.items())}
    results["calibration"] = {"link_gbps": links, "link_samples": samples,
                              "launch": str(prof.launch),
                              "fit_ms": fit_ms}
    print(f"calibrate() on {len(sess.telemetry.samples())} samples "
          f"({fit_ms:.1f} ms): fitted GB/s per link {links} (samples "
          f"{samples}); launch terms {prof.launch}", flush=True)
    results["launches"] = dk.LAUNCHES - launches
    results["cards"] = smi
    print(json.dumps({"peer_smoke": results}), flush=True)
    print(f"cards: {smi[0]}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": len(cards)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
