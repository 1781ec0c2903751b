"""Drive the port's main paths on one CUDA card and check every kernel.

Run from the root of a checkout, on a machine with an NVIDIA H100::

    python3 chip_smoke.py

What it does, in order (any failed check exits nonzero):

1. prints the card's name and power limit (``nvidia-smi``) and builds the
   seven CUDA kernels from ``src/repro_torch/kernels/*/csrc`` (one
   ``nvcc`` per source, started together), printing the build seconds;
2. holds ``multipath_dma`` against its plain version, bit for bit:
   ``Topology.full_mesh(4)`` plans with 1/2/3 paths, 1/4/8 chunks,
   float32 and bfloat16, window 1 and 2, a 4-message exchange group, and a
   ``torus2d(4, 4)`` send with 3-hop chains through the engine; the
   kernel's completion counter must equal the graph's copy-node count;
3. holds ``jacobi`` against its plain version (float32 atol 1e-6, bfloat16
   atol 2e-2 on inputs in [-1, 1)) at W = 700 and W = 2**22,
   ``ring_allgather`` against its plain version, bit for bit, at n = 4 and
   8, ``(rows, f)`` = (8, 128), (4, 64), (8, 7), (2048, 8192), float32
   and bfloat16 (completed items = table size), and ``flash_attention``
   against its plain version: the reference's sweep (``(B, Hq, Hkv, S,
   D)`` = (1, 4, 2, 256, 64), (2, 4, 4, 128, 32), (1, 8, 2, 200, 64),
   (1, 2, 1, 384, 128); causal, causal with a window of 64, full) in
   float32 at atol 3e-5 / rtol 1e-4, bfloat16 at max abs 2e-2 (also at
   D = 16, 32, 64 with S = 200 and at (2, 32, 8, 300, 128), each mask), a
   Gemma-style window of 64 at (1, 32, 16, 512, 128) and D = 128 with
   Hq/Hkv = 32/8; at the registered configs' head dims 80, 112 and 192
   (HuBERT-XLarge, Kimi K2, Nemotron-4) at (1, 4/2, 200, D) and (2, 8/8,
   130, D), each mask, float32 and bfloat16 at the same tolerances, and
   the backward at 80, 112 and 192 against its plain version (float32
   within 1e-4, bfloat16 within 2e-2 of the largest |want|); and
   ``rwkv6_scan`` against its plain version and the
   literal per-step recurrence at the reference's sweep (``(BH, S, dk, dv,
   chunk)`` = (2, 128, 32, 32, 32), (1, 200, 64, 64, 64), (4, 64, 16, 32,
   16), (1, 96, 8, 8, 32), float32, max error relative to the largest
   output below 1e-4), and at the model's shape (4, 1024, 32 heads, 64,
   64) with bfloat16 r/k/v, float32 w/u/out, output and final state
   within the same bound, and there also its first pass's chunk-start
   states (the two-pass kernel's workspace) against the plain first pass
   within that bound;
4. main path A, with every launch counter set to 0 just before it and read
   after phase 5: a ``CommSession(schedule="auto")`` on the default
   4-device topology sends 256 MiB of float32 0→1 with 3 paths (bitwise),
   again (one fast-path hit, one dispatch, one kernel launch), a 64 MiB
   ``bidirectional`` and a 4-message ``exchange``;
5. the Jacobi application on that session: 4 ranks of (8, 2**22) float32,
   10 iterations of ``halo_exchange_group`` + the ``jacobi`` kernel, held
   against the plain stacked version (row shifts, plain sweep) within
   atol 1e-5;
6. main path B, counters set to 0 before it and read after it: the
   collectives of that session, each called twice (the second one cache
   hit, one replay) and held bit for bit against its plain version on the
   card: ``all_gather`` of a 256 MiB float32 ``(4*2048, 8192)`` array (all
   four replicas equal), ``reduce_scatter``, ``all_reduce`` and ``psum``
   of 64 MiB, ``all_to_all`` of ``(16, 2**20)``;
7. main path C: ``make_captured_jacobi_step`` at (4, 8, 2**22) float32,
   resolved first, then 10 iterations with the counters set to 0 just
   before: one dispatch per iteration, ``multipath_dma`` and ``jacobi``
   launched once per iteration per copy run, bit-equal to 10 eager
   ``jacobi_step(u, session=sess)``;
8. main path D: a captured step of ``captured_ring_allgather`` followed by
   a compute node, held bit for bit against the eager composition;
9. the kernels again at the main paths' shapes against their plain
   versions, then times from CUDA events: each kernel beside its bound,
   its plain version and a one-call PyTorch yardstick, a captured-graph
   replay against eager launches per dispatch at 64 KiB, sends of 64 KiB
   to 256 MiB (replay against one ``copy_`` of the message),
   ``ring_allgather`` also at (8, 2048, 8192) float32, (4, 2048, 8192)
   bfloat16 and psum's (rows, 2) gathers (path S's combine, (4, 1572864,
   2) bfloat16, and path V's psum, (4, 2097152, 2) float32, each bitwise
   and beside its plain version), each
   collective's graph replay and ``session.all_gather`` per call, the
   captured Jacobi iteration against the eager one, and
   ``flash_attention`` (bfloat16, causal) at path E's prefill shape (4,
   32/8, 512, 128), at path F's (4, 32, 2048, 128), at path K's (4,
   25/5, 1536, 64, a window of 1024) and at path L's (4, 48/8, 512, 128),
   each against its plain version (K's and L's also within 2e-2) and
   beside its bound, its plain version and
   ``F.scaled_dot_product_attention`` (the yardstick only; the port never
   calls it; for K with an explicit boolean window mask), and ``rwkv6_scan`` at path G's prefill shape (4, 1024, 32,
   64, 64) beside its bound and its plain version, with each of its two
   kernels' times and the workspace's bytes (no one PyTorch call
   computes this scan); then everything of paths A–D is freed;
10. main path E, counters set to 0 before it and read after it: serving
    Llama-3 8B at full width (``get_config("llama3_8b")``: 32 layers,
    d_model 4096, 32/8 heads of 128, d_ff 14336, vocab 128256, bfloat16,
    about 16 GB of seeded random weights) with
    ``ServeEngine(max_len=1024, kv_chunks=4, comm=CommSession())``, whose
    prefill and decode step are captured CUDA graphs (the first call of
    each program captures it, later calls replay): 4 requests of
    512/384/256/128 seeded prompt tokens and 32 new tokens each, greedily,
    twice (the same tokens, every one in range), then a prefill whose
    cache ``migrate_kv(cache, 0, 1)`` moves, twice (bitwise, one dispatch,
    the second a fast-path hit); ``flash_attention`` launched once per
    layer per prefill (captures and replays counted); after the counts are
    read, ``generate``'s tokens against an eager loop of ``prefill_forward``
    + ``make_serve_step`` + ``argmax`` (all 4 x 32 equal), one captured
    decode step's logits and cache against the eager step's on a copy of
    the same cache (bitwise, the max abs difference printed); at layer 0's
    real prefill q/k/v the kernel within 4e-3 + 8e-3·|want| of its plain
    version, and the whole eager prefill's logits against one on the plain
    version (printed); times in one call: the prefill program's replay
    against the eager prefill, the captured decode step against the eager
    step (in turns), each one's device time, op count and idle share under
    the profiler, tokens/s of the second ``generate``, the memory the
    engine's graphs hold, and the migration's replay;
11. main path F: ``make_captured_decode_step`` (batch 1, 32 heads, 2048
    positions, head dim 128, an 8 MiB bfloat16 KV chunk 0→2, schedule
    ``overlap``), resolved first, then 5 calls with the counters set to 0
    just before: one dispatch per call, one ``flash_attention`` and at
    least one ``multipath_dma`` launch per replay, attention on every
    device within 4e-3 + 8e-3·|want| of the plain version, the KV chunk
    bitwise; the replay against the eager composition (attention +
    ``session.send``), and every device op of one of each under the
    profiler;
12. main path G, after path E's and F's tensors are freed, counters set to
    0 before it and read after it: serving RWKV-6 1.6B at full width
    (``get_config("rwkv6_1_6b")``: 24 layers, d_model 2048, 32 heads of
    64, d_ff 7168, vocab 65536, bfloat16, about 3.16 GB of seeded random
    weights) with ``ServeEngine(comm=CommSession())``: 4 requests of
    1024/768/512/256 seeded prompt tokens and 32 new tokens each,
    greedily, twice (the same tokens, every one in range), then a prefill
    whose state cache ``migrate_kv(cache, 0, 1)`` moves, twice (bitwise,
    one dispatch, the second a fast-path hit: a float32 state beside a
    bfloat16 shift in one transfer group); ``rwkv6_scan`` launched once
    per layer per prefill; at layer 0's real prefill r/k/v/w the kernel's
    output and final state within 1e-4 (relative to the largest) of the
    plain version, and the decay range of that prefill; a prefill of all
    but the last 8 tokens and 8 decode steps against the full prefill's
    logits (max abs difference within 0.47, 3× the sound reading of
    bfloat16 activations through 24 layers in two orders), and the same
    with a zeroed state, the state of one chunk earlier and of one
    position earlier planted in the cache, each of which must exceed the
    limit; the same prefill and 8 steps through the captured prefill and
    decode programs within the same limit; the token and logit checks and
    the times of path E;
13. main path H, after path G's tensors are freed, counters set to 0
    before it and read after it: the measured-feedback loop on a
    ``CommSession(CommConfig(telemetry=True, health=False,
    profile_dir=...))`` (the droop monitor is path I's) on the default
    4-device topology (the directory a temporary one under
    ``build/``): float32 sends 0→1 of 64 KiB, 1, 16, 64 and 256 MiB with
    ``max_paths`` 1, 2 and 3, 10 dispatches each, and a 4-message
    ``exchange`` 10 times; ``flash_attention`` at path F's shape and
    ``ring_allgather`` at (4, 2048, 8192) float32, each timed 5 times by
    CUDA events into the recorder's kernel channel; path F's captured
    decode step (its attention node's ``cost_ns`` must equal the
    recorder's median) resolved and called 3 times, and a captured ring
    all-gather whose node is priced the same way; then
    ``calibrate(min_samples=3, warmup=2, persist=True)`` and the sweep,
    the exchange and the step again under the fitted profile. Checks:
    every message and KV chunk bitwise before and after the profile, the
    attention within 4e-3 + 8e-3·|want| of the plain version, one sample
    per dispatch, zero setup stages on every fast-path hit, launch and
    execute above 0 and the stage sum within the call's wall time in every
    sample, a second session on the directory loads an equal profile, and
    ``multipath_dma``, ``flash_attention`` and ``ring_allgather`` each
    launched. Printed beside the card's name and power limit: the fitted
    launch and instantiate terms against the nominal ones and phase 9's
    64 KiB eager launch, the fitted link bandwidths and kernel costs, the
    residuals' median and p90 with nominal and fitted terms, and a 64 KiB
    send's host time with telemetry on and off, in turns;
14. main path I, after path H's tensors are freed, counters set to 0
    before it and read after it: the §4.6 health ladder on the default
    4-device topology. (1) A 64 KiB and a 256 MiB float32 send 0→1 with
    ``max_paths=3`` on a ``health=True`` and a ``health=False`` session,
    in turns (host clock, CUDA events), every one bitwise, the 256 MiB
    replay's device time within 5% of path A's; (2) 10 sends of 256 MiB
    0→1, (0, 1) failed before the 4th and restored before the 7th, then
    ``probe_links()`` until nothing is quarantined: every message
    bitwise, no plan over (0, 1) while it is failed, ladder level 1
    under the fault and 0 after, ``describe``'s digest after the restore
    the pre-fault one and that send a plan-cache hit; printed per send:
    host ms, plan and capture ms, captures, cached graphs and their MiB;
    (3) ``CommConfig(faults="drop@2x2:0-2;degrade@6x4:0-3*0.25;
    flap@12~2x2:0-1")`` and 20 sends of 16 MiB: bitwise, with the
    retries, replans and faults seen that the CPU tests pin (1, 1, 7),
    backoff and plan/capture time printed apart; (4) every device link
    into 1 failed and 256 MiB sent 0→1: bitwise, ladder level 3, one
    ``host_relay`` event, its time and GB/s beside a pinned ``copy_``
    to the host and back; (5) path F's captured decode step called
    healthy, with (0, 2) failed and after the restore: attention within
    4e-3 + 8e-3·|want| of the plain version, the KV chunk bitwise, no
    plan over (0, 2) under the fault; (6) ``ServeEngine`` on
    ``smollm_360m`` at full width (32 layers, d_model 960, 15/5 heads of
    64, bfloat16, seeded random weights): 2 prompts of 256 tokens
    prefilled, their cache migrated 0→1 with (0, 1) failed, bitwise, a
    ``ladder`` event in ``health_events``; (7) path H's send sweep, its
    exchange and path F's decode step on a ``CommConfig(telemetry=True,
    health=True)`` session, ``calibrate``, the same again, every message
    bitwise: the droop monitor's measured/modeled ratios (median, p90,
    max, per kind; the decode step's too, which the monitor does not
    judge) and its quarantines and readmissions printed (a report, not a
    check); and
    ``multipath_dma`` and ``flash_attention`` each launched;
15. main path J, after path I's tensors are freed: training SmolLM-360M
    at full width (``get_config("smollm_360m")``: 32 layers, d_model 960,
    15/5 heads of 64, d_ff 2560, vocab 49152, bfloat16, ``remat="full"``,
    float32 moments). First, not counted: the ``flash_attention``
    backward kernel against its plain version at the training shapes (q
    ``(8, 15, 512, 64)``, k/v ``(8, 5, 512, 64)``, and ``(2, ...)`` for
    one DP shard; causal; float32 within 1e-4 and bfloat16 within 2e-2 of
    the largest |want| on dQ, dK and dV) with the forward's ``lse``, and
    in bfloat16 at head dims 16/32/64/128 at (1, 4/2, 200, D), causal,
    windowed and unmasked; its time (back to back, and one call replayed
    as a CUDA graph) beside its bound, the plain version's, its three
    kernels' device times, SDPA's backward alone and
    forward + backward, and SDPA's backend; ``loss.backward()`` through
    the dense forward (2 layers,
    float32) against the plain attention's ``wq``/``wk``/``wv`` gradients;
    RWKV-6 training running on the card. Then, counters set to
    0 before it and read after it: at full width, 2 layers, float32, TF32
    off, ``make_dp_train_step`` on the default 4-device session against
    ``make_train_step`` and ``make_captured_dp_train_step`` against it
    (loss rtol 1e-5, params atol 2e-5 / rtol 1e-4; the captured step one
    dispatch); 1 warm-up + 5 timed steps of 8 x 512 tokens in bfloat16 of
    ``make_train_step`` and ``make_dp_train_step`` at 32 layers and of the
    captured step at 2 layers (its arena's bytes reckoned first): step ms,
    tokens/s, losses (finite), peak GiB, dispatches and kernel launches a
    step; a checkpoint save and restore of the 2-layer state, bitwise;
    ``flash_attention``, ``flash_attention_bwd`` and ``multipath_dma``
    each launched;
16. main path K, after path J's tensors are freed, counters set to 0
    before it and read after it: serving Hymba-1.5B at full width and
    depth (``get_config("hymba_1_5b")``: 32 layers, each attention
    beside a Mamba mixer, d_model 1600, 25/5 heads of 64, a sliding
    window of 1024, SSM state 16, d_ff 5504, vocab 32001, bfloat16, about
    2.8 GB of seeded random weights) with ``ServeEngine(max_len=1568,
    comm=CommSession())``: 4 requests of 1536/1024/768/512 seeded prompt
    tokens and 32 new tokens each, greedily, twice, so that the prompt
    overflows the ring cache of 1024 in prefill and decode wraps it; then
    a prefill whose cache (keys, values, the float32 SSM state, the conv
    inputs) ``migrate_kv(cache, 0, 2)`` moves, twice (bitwise, one
    dispatch each, the second a fast-path hit); ``flash_attention``
    launched once per layer per prefill; the token and logit checks of
    path E; the kernel at layer 0's real q/k/v (window 1024) within 4e-3
    + 8e-3·|want| of its plain version; the Mamba mixer's and its
    associative scan's time at the prefill's shape beside the prefill
    replay (their share); a prefill of all but the last 8 positions and 8
    decode steps (eager, and through the captured programs) against the
    full prefill's logits within ``HYMBA_DECODE_ATOL``, which a zeroed SSM
    state and zeroed conv inputs must each exceed; the times of path E;
17. main path L, after path K's tensors are freed, counters set to 0
    before it and read after it: serving Mixtral-8x22B at full width
    over 8 of its 56 layers (d_model 6144, 48/8 heads of 128, 8 experts
    of d_ff 16384 top-2, a window of 4096, vocab 32768, bfloat16, 40.9 GB
    of seeded random weights) with ``ServeEngine(max_len=1024,
    kv_chunks=4)``: path E's 4 requests of 512/384/256/128 tokens, 32 new
    each, twice, and a prefill; ``flash_attention`` once per layer per
    prefill; the token and logit checks of path E; the kernel at layer
    0's real q/k/v; one eager prefill and 8 decode steps with every MoE
    call's routes counted: each expert's pairs per layer, no pair dropped
    (dropless); the MoE layer's and its expert products' time at the
    prefill's shape beside the prefill replay; the tail decode check
    within ``MIXTRAL_DECODE_ATOL``, which zeroed keys and values must
    exceed; the times of path E;
18. main path M, after path L's tensors are freed: training every family
    the port serves. First, not counted: the ``rwkv6_scan`` backward
    kernel against its plain version at (8, 512, 32, 64, 64) with
    bfloat16 r/k/v and float32 w/u/dO, decays down to 0.3, and at small
    shapes (a sequence padded to the chunk, chunks of 40 and 24, dk/dv
    16/32, 8 and 8 beside 64, a nonzero dState) in float32 and bfloat16
    (each gradient within 1e-4 / 2e-2 of its largest |want|; at (2, 256,
    4, 64, 64) in float32, dw and du within 1e-5); its time back to back
    and replayed as a CUDA
    graph, each of its three passes' device ms, its bound and the plain
    version's time. Then, counters set to 0 before it and read after it:
    RWKV-6 1.6B (``loss.backward()`` through 2 layers in float32 against
    the plain scan's gradients of the time-mix projections within 1e-4;
    at 2 layers, float32, the vocabulary cut to 4096, the DP step against
    the single step and the captured DP step against the DP step, one
    dispatch, path J's tolerances with elements whose |g| lies within
    the measured difference of the two steps' gradients held to 2·lr;
    then 1 warm-up and 3 timed steps of 8 x 512 tokens at full width and
    depth, bfloat16, float32 moments), Hymba-1.5B (the DP step against
    the single step at 2 layers in float32; 3 timed steps of 4 x 1536
    tokens at 32 layers, so that the window of 1024 bites), Mixtral-8x22B
    at full width over the layers its reckoned bytes leave 15 GB free for
    (2 or 1 of 56; bfloat16 moments; 3 timed steps of 8 x 512 tokens, the
    routed pairs per expert and the dropped pairs, and a nonzero weight
    gradient for exactly the experts that kept pairs): for each, step ms,
    tokens/s, finite losses, peak GiB, launches a step of every kernel
    and the idle share of one profiled step; then
    ``examples_torch/quickstart.py``, ``jacobi_multipath.py --captured``
    and ``serve_batched.py``, each once with ``--device cuda``; path M's
    seconds;
19. main path N, after path M's tensors are freed: training the audio
    encoder HuBERT-XLarge at full width and depth (48 layers, d_model
    1280, 16/16 heads of 80, non-causal, d_ff 5120 GELU, vocab 504,
    bfloat16, ``remat="full"``, float32 moments, about 945 M parameters)
    on 8 x 512 seeded frames of 512 features (about 10 s of audio each at
    20 ms a frame). First, not counted: ``flash_attention`` and its
    backward at (8, 16/16, 512, 80), full mask, against their plain
    versions (and the backward at one DP shard's batch of 2), each timed
    beside its bound, its plain version and SDPA (forward; backward alone
    and forward + backward); ``loss.backward()`` through 2 float32 layers
    against the plain attention's gradients within 1e-4. Then, counters
    set to 0 before it and read after it: the DP and captured DP steps
    against the single step at 2 layers in float32 (path J's
    tolerances); one step's launches (the forward kernel twice a layer,
    remat, the backward once); 1 warm-up + 3 timed steps of
    ``make_train_step`` and ``make_dp_train_step`` (4 devices) at 48
    layers and of the captured DP step at 2 (its arena reckoned first):
    step ms, frames/s, finite losses, peak GiB, and one step's device
    ms, ops and idle share under the profiler;
20. main path O, after path N's tensors are freed: serving at head dims
    112 and 192, each model freed before the next, each counted on its
    own (counters set to 0 before its ``generate`` and read after its
    prefill): Kimi K2 at full width over 1 of 61 layers (d_model 7168,
    64/8 heads of 112, 384 experts of d_ff 2048 top-8 and a shared
    expert, vocab 163840, bfloat16, 38.8 GB of seeded random weights) on
    4 requests of 256/192/128/64 tokens, 16 new each, halved while the
    reckoned peak (weights, twice a dropless prefill's dispatch buffers,
    logits) passes 70 GB; Nemotron-4 340B at full width over 4 of 96
    layers (d_model 18432, 96/8 heads of 192, squared-ReLU d_ff 73728,
    vocab 256000, 46.5 GB) on path E's 4 requests, 32 new each. For each:
    ``generate`` twice (the same tokens), tokens equal to an eager loop of
    ``prefill_forward`` + ``make_serve_step``, one captured decode step
    bitwise equal to the eager step, ``flash_attention`` once a layer a
    prefill, layer 0's real prefill q/k/v through the kernel within 4e-3
    + 8e-3·|want| of its plain version, path E's times (prefill replay
    and captured decode against eager, the memory the graphs hold), and
    the kernel at the prefill's shape beside its bound, its plain version
    and SDPA;
21. main path P, after path O's tensors are freed, counters set to 0
    before it and read after it: the GPipe forward of Llama-3 8B at full
    width and depth (32 layers, d_model 4096, 32/8 heads of 128, SwiGLU
    d_ff 14336, bfloat16) in 4 stages of 8 layers (13.96 GB of seeded
    block weights), 8 microbatches of ``(1, 2048, 4096)`` hidden states
    from a seeded embedding table, on ``CommSession`` over
    ``Topology.full_mesh(4)``: ``pipeline_apply`` with ``multipath=False``
    and ``True``, each bitwise equal to sequential ``block_apply`` over
    the 32 layers microbatch by microbatch, every surfaced row equal, 11
    handoff dispatches a call (one ``session.exchange`` of the 4 stage
    rows a tick, fast-path hits after the first), ``flash_attention``
    launched 352 times a call (every stage every tick, bubbles included),
    ``multipath_dma`` once a handoff (and twice for each handoff
    program's build) and ``ring_allgather`` by the surfacing psum; ms a
    call for both settings and for sequential, medians of 3 in turns,
    each one's device ms and idle share under the profiler (one card
    runs the stages one after another: (M + P − 1)/M = 1.375× the layer
    work), one handoff's replay beside two bounds (its own bytes, and
    the table's, which add the zero fill of each message's other rows),
    peak GiB, and the kernel at the microbatch's attention shape
    (1, 32/8, 2048, 128) beside its bound, its plain version and SDPA;
22. main path Q, counters set to 0 before it and read after it: the int8
    compressed gradient mean at SmolLM-360M's full-width leaf shapes, 4
    replicas of seeded float32 gradients (6.54 GB stacked):
    ``compressed_psum_tree`` against the plain mean ``g.mean(0)`` of the
    same device tensors, every row equal and every leaf's max abs error
    within 0.02 of its max |mean|; ``comm.collectives.pmean`` (the ring
    the compressed mean runs, ``ring_allgather``) against the same plain
    mean within a 4-term sum's float32 rounding; 30 steps of
    ``compressed_psum_with_feedback`` against ``compressed_psum`` at
    (8, 128) and at the (4, 49152, 960) embedding leaf, the accumulated
    error against the plain mean smaller with feedback; ms a tree
    against ``pmean``'s;
23. a captured step of ``captured_multipath_dma``, ``cap.exchange`` and a
    compute node: bitwise equal to the eager composition, one dispatch a
    call, ``multipath_dma`` launched once for the DMA node and once for
    each copy run; ``multipath_send_local`` of the same plan, one launch,
    its destination row bitwise as ``session.send``'s and zeros
    elsewhere, eagerly and replayed from a CUDA graph that recorded it;
24. ``python -m repro_torch.launch.dryrun --comm --fail-link 0:1``, the
    model-cell dry-run of SmolLM-360M's ``decode_32k`` on both
    production meshes, and ``python -m repro_torch.launch.report`` in
    subprocesses under ``-X importtime``, all exit 0, the ``--comm``
    dry-run and the report importing nothing beyond the standard library
    and what importing ``torch`` and ``repro_torch.comm`` imports, the
    model cells nothing of the reference package;
25. main path R, counters set to 0 before it and read after it (the
    kernel checks first, not counted): training Nemotron-4 340B at full
    width (d_model 18432, 96/8 heads of 192, squared-ReLU d_ff 73728,
    bfloat16, bfloat16 moments, ``remat="full"``) over 1 of its 96 layers
    with its vocabulary cut to 32,768 (both cuts forced: about 37 GB of
    weights, gradients and moments), on 8 x 512 tokens. The attention
    backward at head dim 192 against its plain version at (8, 96/8, 512,
    192) and at one DP shard's batch of 2, float32 and bfloat16, and its
    time beside its bound, the plain version and SDPA's backward; one
    step keeping layer 0's real q/k/v/O/dO, the backward kernel's outputs
    on them within 2e-2 of the plain backward's largest |want|, the
    forward kernel launched twice a layer and the backward once; 1
    warm-up + 3 timed steps and one under the profiler: step ms,
    tokens/s, finite losses, peak GiB;
26. main path S, counters set to 0 before it and read after it:
    Mixtral-8x22B served expert-parallel, path L's config, weights and
    requests, under ``make_host_mesh((1, 4))`` on
    ``Topology.full_mesh(4)`` (2 experts a row, the rows' weights views
    of the whole): ``generate`` twice, ``ring_allgather`` launched once a
    MoE layer a forward (every combine one session psum), the token and
    captured-decode checks of path E under the mesh, layer 0's MoE
    output within 2e-2 of ``moe_apply``'s largest |want|, the combine's
    ms a layer, path E's times and the peak beside path L's;
27. main path T, counters set to 0 before it and read after it: the
    dry-run's probes at full width (``launch.specs.input_specs`` cells,
    ``launch.cost`` counts), each at L = 0 and L = 1: T1 Llama-3 8B
    prefill of 4 x 512 (``flash_attention``), T2 Nemotron-4 340B's train
    step of 8 x 512 with path R's vocabulary of 32,768 (the attention and
    its backward at head dim 192), T3 RWKV-6 1.6B's train step of 8 x 512
    (``rwkv6_scan`` and its backward), T4 Mixtral-8x22B prefill of 4 x 512
    under ``make_host_mesh((1, 4))`` (``flash_attention``,
    ``ring_allgather`` in the combine psum). Each step counted on meta
    tensors and on the card's (FLOPs, bytes, collective records, kernel
    calls and peak live bytes all equal; the card's kernel calls equal to
    the launch counters' rise), timed without the counter (one warm-up,
    then 3 calls, host clock ending in a synchronize) against the count's
    bound (the larger of FLOPs at 989 TFLOP/s and bytes at 3.35 TB/s; the
    share at most 100%), ``max_memory_allocated`` within 0.9x to 1.2x of
    the predicted peak (arguments + the count's peak live bytes) plus 1
    GiB, and the layer's increment counted and measured;
28. main path U, counters set to 0 before it and read after it: a peer
    session, ``CommSession(schedule="auto", devices=["cuda:0"] * 4)``
    (each logical device its own buffers on the one card, the
    ``multipath_dma`` kernel over its per-device table with a pointer
    table): the sends of path A (256 MiB float32 0→1 with 3 paths, twice,
    the second a fast-path hit; 64 KiB with the planner's default), a
    64 MiB ``bidirectional`` and a 4-message ``exchange``, then 10
    iterations of path A's Jacobi, 4 blocks of (8, 2**22), on per-device
    blocks; each result bitwise equal to the stacked session's (run
    before the counters are zeroed) and every program's output to the
    plain table's on the same operands, completed copy nodes equal to
    each graph's, one ``multipath_dma`` launch a replay (one card); the
    256 MiB replay, the 64 KiB send and a Jacobi iteration timed against
    the stacked session's, in turns;
29. main path V, counters set to 0 before it and read after it: the
    collectives of a peer session on the one card,
    ``CommSession(schedule="auto", devices=["cuda:0"] * 4)``: a 256 MiB
    float32 ``all_gather`` twice (the second a cache hit), 64 MiB
    ``reduce_scatter``, ``all_reduce``, ``psum`` of an odd (4097, 4095)
    that pads and ``all_to_all``, bfloat16 ``all_gather`` at f = 7 and
    f = 1, and ``session.collectives`` (``all_gather``,
    ``reduce_scatter``, ``all_reduce``, ``psum``, ``pmean``,
    ``all_to_all``) on per-device lists of 8 MiB rows; each result bitwise
    equal to the stacked session's (run before the counters are zeroed),
    one dispatch a call (a list call runs its driver-level counterpart's
    program from the plan cache), every peer ``ring_allgather``
    program's replicas bitwise ``ring_allgather_peer_plain`` on its shards
    (completed items = items), ``ring_allgather`` launched once a card a
    gather and ``multipath_dma`` once a card a ring shift, as counted from
    the programs; the 256 MiB all-gather and the 64 MiB all-reduce replays
    timed against the stacked session's, in turns;
30. main path W, counters set to 0 before it and read after it:
    whole-iteration capture on a peer session on the one card,
    ``CommSession(schedule="auto", devices=["cuda:0"] * 4)`` (one arena a
    logical device, one CUDA graph): path C's captured Jacobi (4 x (8,
    2**22) float32, 10 iterations), path D's captured all-gather + compute
    node, a ``captured_psum`` step of 4 x 2**22 float32, path F's
    migrating decode step (batch 1, 32 heads, 2048 positions, head dim
    128, an 8 MiB bfloat16 KV chunk 0→2, schedule ``overlap``) and phase
    23's captured ``multipath_dma`` step; each result bitwise the same
    step's on the stacked session (run before the counters are zeroed;
    attention within path F's tolerance of it and of the plain version),
    digests and ``GroupKey`` equal, one dispatch a call, every copy-run
    table's output and every collective node's (the peer
    ``ring_allgather``, the plan's per-device ``multipath_dma`` table)
    equal to its plain version on the same operands, the launches read
    equal to the programs' replay launches times the calls (the Jacobi
    step: 4 ``jacobi``, one a logical device, and one ``multipath_dma`` a
    copy run); the Jacobi and decode replays timed by CUDA events against
    the stacked session's, in turns;
31. main path X, each part's counters set to 0 just before its peer run
    and read just after it (X1-X4): the training side on a peer session
    on the one card, ``CommSession(devices=["cuda:0"] * 4)``, each part
    bitwise the same call on the stacked session, run first: X1 path J's
    DP step and captured DP step at full width, 2 layers, float32 (the
    captured step's replica d against row d of the stacked program, its
    digest and ``GroupKey`` the stacked step's, one dispatch a call, a
    call's launches its program's replay launches); X2 the eager DP step
    at 32 layers in bfloat16; X3 path Q's compressed mean and its
    feedback variant on per-device lists; X4 path P's pipeline of
    Llama-3 8B, a stage a logical device, one exchange dispatch a tick.
    Then, in turns against the stacked session's: the eager step at 32
    layers, the captured step at 2 layers in bfloat16 and the pipeline
    call;
32. main path Y, run right after path S on its weights (counters set to
    0 before it and read after it): Mixtral-8x22B served expert parallel
    on a peer mesh on the one card, ``make_host_mesh((1, 4),
    devices=["cuda:0"] * 4)``: the engine places path S's weights (views:
    the card holds all four logical devices' experts), each program one
    CUDA graph, each MoE combine one peer psum over the program's ring
    (three ``multipath_dma`` ring shifts and one ``ring_allgather``
    launch); ``generate`` twice, its tokens and the prefill's and one
    decode step's logits bit for bit path S's, ``ring_allgather`` once a
    MoE layer a forward, path E's token and captured-decode checks under
    the peer mesh, the prefill replay and the captured decode step beside
    path S's, and the peak GiB;
33. main path Z, counters set to 0 before it and read after it:
    Mixtral-8x22B trained expert parallel on a peer mesh of four logical
    devices on the one card, ``make_host_mesh((1, 4), devices=["cuda:0"]
    * 4)``: full width, ``remat="full"``, bfloat16 with bfloat16 moments,
    path M's depth and tokens (8 x 512), 2 steps of ``make_train_step``
    from ``place_state``, every MoE combine and its backward a peer psum
    over the card's ring (``multipath_dma`` ring shifts and one
    ``ring_allgather`` each); held against the stacked mesh's step from
    the same seed and batches, run first and not counted: losses within
    rtol 1e-3, every updated parameter within 2e-2 of the stacked
    update's largest |change|; the largest errors, the step ms, the peak
    GiB and the launches a step, and the whole run's seconds;
34. main path AA, counters set to 0 before it and read after it: the
    §4.6 health ladder on a peer session of four logical devices on the
    one card, ``CommSession(CommConfig(telemetry=True), devices=["cuda:0"]
    * 4)``, in lockstep with a stacked session on the card running the
    same operations: path I's mid-traffic failure of (0, 1) over 256 MiB
    sends 0->1 (3 paths), its restore, a quarantine of (0, 1) readmitted
    by probes and the pre-fault digest back as a plan-cache hit; path I's
    injected schedule over 20 sends of 16 MiB (its pinned counts); the
    host relay with every device link into 1 failed; path F's captured
    decode step through a failure of (0, 2). After every operation the
    two sessions' outputs are bitwise equal, and so are their
    ``stats()["health"]``, drained events, launched digests (probes
    included) and cache statistics; every key of the peer plan cache is a
    ``PlacedKey``. Prints the first send after the fault split into
    plan + lower + schedule, capture and backoff on each layout, the
    replay under the fault against the healthy one, and the relay's ms
    and GB/s;
35. main path AB, counters set to 0 before each of its two runs and read
    after it: dense tensor parallelism on a peer mesh, Nemotron-4 340B at
    path O's full width, 4 layers, seeded weights and requests. Four
    logical devices on the one card (``make_host_mesh((1, 4),
    devices=["cuda:0"] * 4)``): the card holds every device, so
    ``place_params`` cuts nothing (its tree the weights' views, its bytes
    as reckoned from the config) and ``generate``'s tokens, the prefill's
    logits and one decode step's are path O's bit for bit; the prefill
    replay and the captured decode step timed. Then the two-card layout
    ``[0, 0, 1, 1]`` emulated on the card (the placement's and the ring's
    layout): each card's tree its 48 heads, 4 kv heads, 36864 hidden
    units and 128000 vocabulary rows (bytes as reckoned), its cache its kv
    heads; one eager lockstep prefill and decode step whose every psum
    (the embedding, attention's and the MLP's, a layer) is three
    ``multipath_dma`` ring shifts and one ``ring_allgather`` launch and
    whose logits are gathered by one more (launches counted exactly);
    every card's logits the same bits and within 2e-2 of path O's largest
    |logit|;
36. main path AC, counters set to 0 before each of its two peer runs and
    read after it: training under dense tensor parallelism on a peer
    mesh, Llama-3 8B at full width (``remat="full"``, float32 moments,
    8 x 512 tokens, 2 steps of ``make_train_step``), each peer run held
    against the unsharded step from the same seed and batches, run just
    before it and not counted. Four logical devices on the one card, 4
    layers in bfloat16: ``place_state(state, mesh, cfg)`` cuts nothing
    (views of the state) and both steps are the unsharded step's bit for
    bit. Then 2 layers in float32 (TF32 off; in bfloat16 the update's
    rounding moves parameters beyond path Z's limit), the two-card
    layout ``[0, 0, 1, 1]`` emulated on the card: each
    card's state its 16 heads, 4 kv heads, 7168 hidden units and 64128
    vocabulary rows and columns with their moments (bytes as reckoned
    from the config); one host thread a card; every psum of the conjugate
    pairs, of the loss and of the clip norm three ``multipath_dma`` ring
    shifts and one ``ring_allgather`` launch (one real card), the loss's
    block
    log-sum-exps one more gather, attention forward and recompute and
    its backward a card a layer (launches counted exactly); every card's
    replicated leaves the same bits, losses and parameters within path
    Z's limits of the unsharded step (AdamW's ε region counted apart);
    the step ms of every run;
37. main path AD, counters set to 0 before each of its six runs and read
    after it: the state-space mixers tensor parallel on a peer mesh,
    RWKV-6 1.6B (24 layers) and Hymba-1.5B (32 layers) at full width in
    bfloat16 on paths G's and K's seeded weights and requests. Four
    logical devices on the one card: nothing is cut, and tokens, prefill
    and decode logits are paths G's and K's bit for bit. The two-card
    layout ``[0, 0, 1, 1]`` emulated on the card: each card's tree its 16
    of RWKV-6's 32 heads (``w_r``..``w_g`` columns, ``w_out`` rows, ``u``,
    ``ln_x``) or 800 of Hymba's 1600 Mamba channels (both halves of
    ``w_in``, every per-channel leaf, ``w_dt1``/``w_B``/``w_C``/``w_out``
    rows), its hidden units and vocabulary blocks (bytes as reckoned), its
    decode states its heads' or channels'; one eager prefill and decode
    step (launches counted exactly), every card's logits the same bits.
    Their twin (RWKV-6 in float64 through the scan's recurrence, Hymba in
    float32 through its kernels): the two-card run within 2e-2 of the
    unsharded run's largest |logit| at every position, every card's the
    same bits, and two faults (the mixer's psum dropped, two cards' blocks
    swapped) beyond it; the bfloat16 runs, each itself far from the twin,
    by their median distance from it (the two-card run's within twice the
    unsharded run's, the dropped psum's beyond that); RWKV-6's float32
    runs through the kernel and its group norm's input at their worst
    positions printed as witnesses. ``rwkv6_scan`` and its
    backward at a card's 16 heads against their plain versions and timed
    beside their whole-head times (not counted). Each model's float32
    train step at 2 layers on the emulated layout (one host thread a card,
    launches counted exactly), held as path AC holds its own, AdamW's ε
    region counted and bounded, and step 1's gradients and the grad norm
    within path M's float32 bound of the family, beside a witness (the
    unsharded step from nudged parameters) and a control (f's psum
    skipped) that must exceed it; RWKV-6's parameters within twice the
    summed lr (its group norm turns float32 rounding of its gradients
    into signs of AdamW's first update);
38. one JSON line ``{"kernels": [...]}`` (``rwkv6_scan`` and
    ``rwkv6_scan_bwd`` with their times at a card's heads), then as the
    last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import os
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

#: H100 SXM device-memory rate, bytes/s (NVIDIA data sheet).
HBM_BYTES_PER_S = 3.35e12
#: H100 SXM dense bf16 tensor-core rate, FLOP/s (NVIDIA data sheet).
BF16_FLOPS_PER_S = 989e12
#: H100 SXM float32 rate outside the tensor cores, FLOP/s (data sheet).
F32_FLOPS_PER_S = 67e12
MiB = 1 << 20


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


#: bfloat16 outputs of a kernel and its plain version (both rounded
#: from float32) may differ by about two bfloat16 steps: an absolute
#: floor for values near 0, and a share of the value elsewhere.
BF16_ATOL, BF16_RTOL = 4e-3, 8e-3


def bf16_err(got: torch.Tensor, want: torch.Tensor) -> tuple[float, bool]:
    """The max abs difference of two bfloat16 tensors, and whether every
    element lies within ``BF16_ATOL + BF16_RTOL * |want|``."""
    want = want.float()
    diff = (got.float() - want).abs()
    ok = bool((diff <= BF16_ATOL + BF16_RTOL * want.abs()).all())
    return diff.max().item(), ok


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` over ``iters`` back-to-back calls,
    from CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def host_time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean wall milliseconds per call of ``fn()`` followed by a device
    synchronize (host clock)."""
    for _ in range(warmup):
        fn()
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def profile_device_ms(fn, top: int | None = 5
                      ) -> tuple[float, float, int, list]:
    """One synced call of ``fn`` under ``torch.profiler``: (wall ms under
    the profiler, device ms of the device-side events (kernels, copies,
    fills: one stream, so they do not overlap), their count, and the
    ``top`` (all with ``None``) with the most device time as (name, ms,
    count)). Device ms is 0 when the profiler records no device
    activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows, count = [], 0
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            rows.append((e.key, e.self_device_time_total / 1e3, e.count))
            count += e.count
    rows.sort(key=lambda r: -r[1])
    return wall, sum(r[1] for r in rows), count, rows[:top]


def top_ops(rows) -> str:
    """Profiler rows as ``name ms xcount``, names cut to 48 characters."""
    return ", ".join(f"{name[:48]} {ms:.4f} x{n}" for name, ms, n in rows)


def comm_paths(dev, randn, errs, per_path, read_path
               ) -> tuple[list[dict], dict]:
    """Main paths A–D (phases 4–8) on one session, then their kernels at
    the paths' shapes and their times (phase 9). Returns the report rows
    of ``multipath_dma``, ``jacobi`` and ``ring_allgather`` (``launches``
    is filled in by the caller) and the 64 KiB send's per-dispatch times
    in µs (graph replay and eager launch, back to back and synced) beside
    the 256 MiB send's and the captured Jacobi iteration's replays in ms
    (``replay256_ms``, ``jacobi_replay_ms``); everything else is freed on
    return."""
    from repro_torch.comm import CommConfig, CommSession
    from repro_torch.comm import collectives as coll
    from repro_torch.core.halo import jacobi_step, make_captured_jacobi_step
    from repro_torch.kernels._graph import reset_launch_counts
    from repro_torch.kernels.jacobi import kernel as jk
    from repro_torch.kernels.multipath_dma import kernel as dk
    from repro_torch.kernels.ring_allgather import kernel as rk
    from repro_torch.kernels.ring_allgather import ops as rops

    # -- 4. main path A ----------------------------------------------------
    reset_launch_counts()
    sess = CommSession(schedule="auto")
    check(sess.device.type == "cuda", "session not on cuda")
    big = randn(1 << 26)                                  # 256 MiB f32
    t0 = time.perf_counter()
    out = sess.send(big, 0, 1, max_paths=3)
    first_ms = (time.perf_counter() - t0) * 1e3
    check(torch.equal(out, big), "256 MiB send not bitwise exact")
    s1 = sess.stats()
    launches = dk.LAUNCHES
    out = sess.send(big, 0, 1, max_paths=3)
    s2 = sess.stats()
    check(torch.equal(out, big), "second 256 MiB send not bitwise exact")
    check(s2["fastpath"]["hits"] == s1["fastpath"]["hits"] + 1,
          "second send was not a fast-path hit")
    check(s2["dispatches"] == s1["dispatches"] + 1,
          "second send was not exactly one dispatch")
    check(dk.LAUNCHES == launches + 1,
          f"second send launched multipath_dma {dk.LAUNCHES - launches} "
          f"times, not once")
    main_entry = next(iter(sess.engine._fastpath._store.values()))[1]
    main_prog = main_entry.compiled.program
    check(main_prog.completed_nodes() == main_entry.graph.num_copy_nodes,
          "main send completion counter != copy nodes")
    print(f"send 256 MiB 0->1 max_paths=3: bitwise exact; first dispatch "
          f"{first_ms:.1f} ms (plan+table+capture), schedule "
          f"{main_entry.schedule}, {main_entry.graph.num_copy_nodes} copy "
          f"nodes, {main_prog.table.num_items} work items, paths "
          f"{[pa.route.via for pa in main_entry.plans[0].paths]}",
          flush=True)
    d0, l0 = sess.stats()["dispatches"], dk.LAUNCHES
    mid = big[: 16 * MiB]                                 # 64 MiB f32
    fwd, rev = sess.bidirectional(mid, 0, 2, max_paths=3)
    check(torch.equal(fwd, mid) and torch.equal(rev, mid),
          "64 MiB bidirectional not exact")
    quarter = [randn(4 * MiB) for _ in range(4)]          # 16 MiB each
    got = sess.exchange([(quarter[i], i, (i + 1) % 4) for i in range(4)],
                        max_paths=3)
    check(all(torch.equal(a, b) for a, b in zip(got, quarter)),
          "4-message exchange not exact")
    d1 = sess.stats()["dispatches"]
    check(d1 - d0 == 2 and dk.LAUNCHES - l0 >= 2,
          "bidirectional/exchange dispatch or launch count wrong")
    print("bidirectional 64 MiB and 4-message exchange: bitwise exact",
          flush=True)

    # -- 5. Jacobi application ---------------------------------------------
    ranks, rows, cols, iters = 4, 8, 1 << 22, 10
    u0 = randn(ranks, rows, cols)
    d0 = sess.stats()["dispatches"]
    t0 = time.perf_counter()
    u = u0
    for _ in range(iters):
        u = jacobi_step(u, session=sess, use_kernel=True)
    torch.cuda.synchronize()
    app_s = time.perf_counter() - t0
    halo_dispatches = sess.stats()["dispatches"] - d0
    read_path("A")
    check(per_path["A"].get("multipath_dma", 0) > 0
          and per_path["A"].get("jacobi", 0) > 0,
          "path A did not launch multipath_dma and jacobi")
    up = u0
    for _ in range(iters):
        up = jacobi_step(up, session=None, use_kernel=False)
    err = (u - up).abs().max().item()
    check(bool(torch.isfinite(u).all()) and tuple(u.shape) == (ranks, rows,
                                                               cols),
          "Jacobi output not finite or wrong shape")
    check(err <= 1e-5, f"Jacobi application max abs err {err} > 1e-5")
    check(halo_dispatches == iters, "halo exchange not one dispatch/iter")
    print(f"jacobi app {ranks}x({rows},{cols}) f32, {iters} iterations: "
          f"max abs err vs plain stacked {err} (atol 1e-5), "
          f"{app_s * 1e3 / iters:.2f} ms/iteration (host clock, first "
          f"iteration captures), one exchange dispatch per iteration",
          flush=True)

    # -- 6. main path B: collectives ----------------------------------------
    nd = sess.num_devices

    def plain_gather(xs):
        n_, s_ = xs.shape[:2]
        return rk.ring_allgather_plain(xs.reshape(n_, -1, xs.shape[-1])
                                       ).reshape((n_, n_ * s_)
                                                 + tuple(xs.shape[2:]))

    def plain_psum(xs):
        n_ = xs.shape[0]
        size = xs[0].numel()
        flat = torch.nn.functional.pad(xs.reshape(n_, -1),
                                       (0, (-size) % (2 * n_)))
        red = plain_gather(coll.bidir_ring_reduce_scatter(
            flat.reshape(n_, -1, 2)))
        return red.reshape(n_, -1)[:, :size].reshape(xs.shape)

    def coll_program(op):
        key = next(k for k in sess.cache.keys()
                   if getattr(k, "op", None) == op)
        return sess.cache._store[key]

    ag_x = randn(nd * 2048, 8192)                         # 256 MiB f32
    rs_x = randn(nd * 512, 8192)                          # 64 MiB f32
    a2a_x = randn(nd * nd, 1 << 20)                       # 64 MiB f32
    ps_x = randn(4097, 4095)                              # 64 MiB, odd
    rows_ag = ag_x.view(nd, 2048, 8192)
    expect = {
        "all_gather": ag_x,
        "reduce_scatter": coll.bidir_ring_reduce_scatter(
            rs_x.expand(nd, -1, -1)).reshape(rs_x.shape),
        "all_reduce": plain_gather(coll.bidir_ring_reduce_scatter(
            rs_x.expand(nd, -1, -1)))[0],
        "psum": plain_psum(ps_x.expand(nd, -1, -1))[0],
        "all_to_all": a2a_x.view(nd, nd, -1).transpose(0, 1).reshape(
            a2a_x.shape),
    }
    check(torch.equal(plain_gather(rows_ag)[1], ag_x),
          "plain all-gather is not the identity")
    inputs = {"all_gather": ag_x, "reduce_scatter": rs_x,
              "all_reduce": rs_x, "psum": ps_x, "all_to_all": a2a_x}
    reset_launch_counts()
    coll_ms = {}
    for op, x in inputs.items():
        t0 = time.perf_counter()
        got = getattr(sess, op)(x)
        torch.cuda.synchronize()
        first = (time.perf_counter() - t0) * 1e3
        check(torch.equal(got, expect[op]), f"session.{op} differs from "
              f"its plain version")
        c0 = sess.stats()["cache"]
        prog = coll_program(op)
        l0 = prog.lifecycle.launches
        got = getattr(sess, op)(x)
        c1 = sess.stats()["cache"]
        check(torch.equal(got, expect[op]), f"second session.{op} differs")
        check(c1["hits"] == c0["hits"] + 1 and c1["misses"] == c0["misses"],
              f"second session.{op} was not one cache hit")
        check(prog.lifecycle.launches == l0 + 1,
              f"second session.{op} was not exactly one replay")
        coll_ms[op] = first
        if op == "all_gather":
            (y,) = prog.outputs()
            check(all(torch.equal(y[d], ag_x) for d in range(nd)),
                  "all_gather replicas differ")
        print(f"session.{op} {tuple(x.shape)} {x.dtype}: bitwise equal to "
              f"plain, second call one cache hit + one replay; first call "
              f"{first:.1f} ms (build + capture)", flush=True)
    read_path("B")
    check(per_path["B"].get("ring_allgather", 0) > 0,
          "path B did not launch ring_allgather")
    del expect, got

    # -- 7. main path C: captured Jacobi ------------------------------------
    cap_step = make_captured_jacobi_step(sess, rows, cols)
    centry = cap_step.resolve()
    cprog = centry.compiled.program
    runs = [(len(r.nodes), r.table.num_items) for r in cprog.copy_runs]
    print(f"captured Jacobi: schedule {centry.schedule}, walk "
          f"{[type(w).__name__ for w in cprog.walk]}, copy runs (nodes, "
          f"items) {runs}, replay launches {cprog.replay_launches}",
          flush=True)
    ue = u0
    for _ in range(iters):
        ue = jacobi_step(ue, session=sess)
    d0 = sess.stats()["dispatches"]
    reset_launch_counts()
    uc = u0
    for _ in range(iters):
        (uc,) = cap_step(uc)
    torch.cuda.synchronize()
    cap_dispatches = sess.stats()["dispatches"] - d0
    read_path("C")
    check(cap_dispatches == iters, f"captured Jacobi took {cap_dispatches} "
          f"dispatches for {iters} iterations")
    check(per_path["C"].get("multipath_dma", 0) == iters * len(runs)
          and per_path["C"].get("jacobi", 0) == iters,
          f"captured Jacobi launches {per_path['C']} != one jacobi and "
          f"{len(runs)} multipath_dma per iteration")
    check(torch.equal(uc, ue), "captured Jacobi differs from eager "
          "jacobi_step")
    print(f"captured Jacobi {ranks}x({rows},{cols}) f32, {iters} iterations: "
          f"bitwise equal to eager jacobi_step, one dispatch per iteration",
          flush=True)

    # -- 8. main path D: captured ring all-gather + compute ------------------
    g_rows = 512

    def gather_scale(cap):
        g = rops.captured_ring_allgather(
            cap, cap.input((g_rows, 8192), torch.float32), nd)
        return cap.kernel(lambda t: t * 0.5 + 1.0, g, name="scale")

    gx = randn(nd, g_rows, 8192)                          # 16 MiB shards
    reset_launch_counts()
    gstep = sess.capture(gather_scale)
    (gout,) = gstep(gx)
    (gout,) = gstep(gx)
    torch.cuda.synchronize()
    read_path("D")
    check(per_path["D"].get("ring_allgather", 0) > 0,
          "path D did not launch ring_allgather")
    geager = rops.ring_allgather(gx).reshape(nd, nd * g_rows, 8192) * 0.5 \
        + 1.0
    check(torch.equal(gout, geager), "captured ring all-gather step differs "
          "from the eager composition")
    print("captured ring_allgather + compute node: bitwise equal to eager",
          flush=True)
    del gout, geager

    # -- 9a. kernels vs plain at the main path's shapes ---------------------
    plain_y = torch.zeros_like(main_prog.y)
    plain_stage = torch.empty_like(main_prog.stage)
    main_prog.inputs()[0][:, 0].copy_(big)
    main_prog.replay()
    dk.run_node_table_plain(main_prog.table.items, main_prog.x, plain_y,
                            plain_stage)
    torch.cuda.synchronize()
    check(torch.equal(main_prog.y, plain_y), "multipath_dma differs from "
          "plain at the main path's shape")
    ext4 = torch.cat([torch.zeros(ranks, rows, 1, device=dev), u0,
                      torch.zeros(ranks, rows, 1, device=dev)], dim=2)
    err4 = (jk.jacobi_sweep_cuda(ext4) - jk.jacobi_sweep_plain(ext4)
            ).abs().max().item()
    errs["jacobi"] = max(errs["jacobi"], err4)
    check(err4 <= 1e-6, f"jacobi at (4, 8, 2**22 + 2): err {err4}")
    ag_prog = coll_program("all_gather").program
    ring_got = rk.ring_allgather_cuda(rows_ag)
    check(torch.equal(ring_got, rk.ring_allgather_plain(rows_ag)),
          "ring_allgather differs from plain at the main path's shape")
    del ring_got
    print("kernels vs plain at the main path's shapes: multipath_dma "
          f"bitwise, jacobi max abs err {err4}, ring_allgather (4, 2048, "
          f"8192) bitwise", flush=True)

    # -- 9b. times ---------------------------------------------------------
    reads, writes = main_prog.table.bytes_moved()
    dma_bound = (reads + writes) / HBM_BYTES_PER_S * 1e3
    dma_ms = cuda_time_ms(main_prog.run, 20)
    replay_ms = cuda_time_ms(main_prog.replay, 20)
    dma_plain_ms = cuda_time_ms(
        lambda: dk.run_node_table_plain(main_prog.table.items, main_prog.x,
                                        plain_y, plain_stage), 5, warmup=1)
    x4 = main_prog.inputs()[0]
    y4 = main_prog.outputs()[0]
    # one PyTorch call computing the same function: the message in the
    # destination row, zeros in every other row
    dst_row = (torch.arange(4, device=dev) == 1).view(4, 1)
    zero = torch.zeros((), device=dev)
    where_out = torch.empty_like(y4[0])
    torch.where(dst_row, x4[0, 0], zero, out=where_out)
    check(torch.equal(where_out, y4[0]), "torch.where yardstick differs")
    where_ms = cuda_time_ms(
        lambda: torch.where(dst_row, x4[0, 0], zero, out=where_out), 20)
    copy_ms = cuda_time_ms(lambda: y4[0, 1].copy_(x4[0, 0]), 20)
    copy_bound = 2 * big.numel() * 4 / HBM_BYTES_PER_S * 1e3
    print(f"multipath_dma 256 MiB send: kernel {dma_ms:.4f} ms, graph "
          f"replay {replay_ms:.4f} ms, bound {dma_bound:.4f} ms "
          f"({reads} B read + {writes} B written incl. fills at 3.35 TB/s, "
          f"{dma_bound / dma_ms:.1%} of bound, {dma_ms / copy_ms:.3f}x "
          f"out[dst].copy_(x[src])), plain {dma_plain_ms:.4f} ms, "
          f"torch.where into the (4, n) output {where_ms:.4f} ms, "
          f"out[dst].copy_(x[src]) of the message alone {copy_ms:.4f} ms "
          f"(its bound {copy_bound:.4f} ms)", flush=True)

    w = 1 << 22
    ext = randn(rows, w + 2)
    jac_ms = cuda_time_ms(lambda: jk.jacobi_sweep_cuda(ext), 50)
    jac_plain_ms = cuda_time_ms(lambda: jk.jacobi_sweep_plain(ext), 20)
    weight = torch.tensor([[0.0, 0.25, 0.0], [0.25, 0.0, 0.25],
                           [0.0, 0.25, 0.0]], device=dev).view(1, 1, 3, 3)
    ext_nchw = ext.view(1, 1, rows, w + 2)
    conv = torch.nn.functional.conv2d(ext_nchw, weight, padding=(1, 0))
    conv_err = (conv.view(rows, w) - jk.jacobi_sweep_plain(ext)
                ).abs().max().item()
    conv_ms = cuda_time_ms(lambda: torch.nn.functional.conv2d(
        ext_nchw, weight, padding=(1, 0)), 20)
    jac_bound = (rows * (w + 2) + rows * w) * 4 / HBM_BYTES_PER_S * 1e3
    print(f"jacobi (8, 2**22 + 2) f32: kernel {jac_ms:.4f} ms, bound "
          f"{jac_bound:.4f} ms ({jac_bound / jac_ms:.1%} of bound), plain "
          f"{jac_plain_ms:.4f} ms, F.conv2d cross 3x3 (tf32 off) "
          f"{conv_ms:.4f} ms (max abs diff {conv_err})", flush=True)

    # graph replay vs eager launch per dispatch at 64 KiB (paper Figs 13/14)
    small = CommSession(CommConfig(multipath_threshold=0), device=dev)
    msg = randn(16 * 1024)                                # 64 KiB f32
    check(torch.equal(small.send(msg, 0, 1, max_paths=3, num_chunks=4), msg),
          "64 KiB send not exact")
    sentry = next(iter(small.engine._fastpath._store.values()))[1]
    sprog = sentry.compiled.program
    nodes = sentry.graph.num_copy_nodes
    rep_dev = cuda_time_ms(sprog.replay, 200, warmup=10)
    eager_dev = cuda_time_ms(sprog.run, 200, warmup=10)
    sy = torch.zeros_like(sprog.y)
    sst = torch.empty_like(sprog.stage)
    pernode_dev = cuda_time_ms(lambda: dk.run_node_table_plain(
        sprog.table.items, sprog.x, sy, sst), 50, warmup=5)
    rep_host = host_time_ms(sprog.replay, 200, warmup=10)
    eager_host = host_time_ms(sprog.run, 200, warmup=10)
    send_host = host_time_ms(
        lambda: small.send(msg, 0, 1, max_paths=3, num_chunks=4), 200,
        warmup=10)
    print(f"64 KiB send, 3 paths x 4 chunks = {nodes} copy nodes: graph "
          f"replay {rep_dev * 1e3:.2f} us/dispatch back to back "
          f"({rep_host * 1e3:.2f} us with a sync each), eager kernel launch "
          f"{eager_dev * 1e3:.2f} us ({eager_host * 1e3:.2f} us synced), "
          f"eager one copy_ per work item {pernode_dev * 1e3:.2f} us; whole "
          f"session.send {send_host * 1e3:.2f} us synced", flush=True)
    launch64 = {"replay_us": rep_dev * 1e3,
                "replay_synced_us": rep_host * 1e3,
                "eager_us": eager_dev * 1e3,
                "eager_synced_us": eager_host * 1e3, "copy_nodes": nodes,
                "replay256_ms": replay_ms}
    # send size sweep on the main session: graph replay vs one copy_
    for nbytes in (64 * 1024, MiB, 16 * MiB, 256 * MiB):
        m = big[: nbytes // 4]
        check(torch.equal(sess.send(m, 0, 1, max_paths=3), m),
              f"{nbytes} B send not exact")
        e = next(e for _, e in sess.engine._fastpath._store.values()
                 if e.key.entries == ((0, 1, m.numel(), "float32"),))
        prog = e.compiled.program
        rd, wr = prog.table.bytes_moved()
        rep = cuda_time_ms(prog.replay, 50, warmup=5)
        xin, yout = prog.inputs()[0], prog.outputs()[0]
        cp = cuda_time_ms(lambda: yout[0, 1].copy_(xin[0, 0]), 50, warmup=5)
        print(f"sweep {nbytes} B: {len(e.plans[0].paths)} paths, "
              f"{e.graph.num_copy_nodes} copy nodes, replay {rep * 1e3:.2f} "
              f"us (bound {(rd + wr) / HBM_BYTES_PER_S * 1e6:.2f} us), "
              f"copy_ of the message {cp * 1e3:.2f} us (bound "
              f"{2 * nbytes / HBM_BYTES_PER_S * 1e6:.2f} us)", flush=True)

    # ring_allgather at the all-gather's shape: (4, 2048, 8192) f32 shards;
    # the kernel moves each shard once in and into every replica, the
    # function's own bytes (n + n^2) S
    ring_floor = sum(rk.RingGeometry.for_shape(nd, 2048, 8192, 4)
                     .bytes_moved()) / HBM_BYTES_PER_S * 1e3
    ring_ms = cuda_time_ms(lambda: rk.ring_allgather_cuda(rows_ag), 20)
    ring_plain_ms = cuda_time_ms(lambda: rk.ring_allgather_plain(rows_ag), 5,
                                 warmup=1)
    yard = rows_ag.reshape(1, nd * 2048, 8192).expand(nd, -1, -1).contiguous()
    check(torch.equal(yard, plain_gather(rows_ag)), "yardstick differs")
    del yard
    yard_ms = cuda_time_ms(lambda: rows_ag.reshape(1, nd * 2048, 8192)
                           .expand(nd, -1, -1).contiguous(), 20)
    ag_replay_ms = cuda_time_ms(ag_prog.replay, 20)
    launch64["ag_replay256_ms"] = ag_replay_ms
    ag_call_ms = host_time_ms(lambda: sess.all_gather(ag_x), 10)
    print(f"ring_allgather (4, 2048, 8192) f32: kernel {ring_ms:.4f} ms, "
          f"bound {ring_floor:.4f} ms ((n + n^2) S at 3.35 TB/s, "
          f"{ring_floor / ring_ms:.1%} of it), plain {ring_plain_ms:.4f} ms, "
          f"reshape.expand.contiguous {yard_ms:.4f} ms; session.all_gather "
          f"256 MiB: graph replay {ag_replay_ms:.4f} ms, whole call "
          f"{ag_call_ms:.4f} ms synced (staging + replay + replica clone)",
          flush=True)

    # the kernel at its other sizes: 8 devices, bf16, and the (rows, 2)
    # shards of psum's gather: path S's combine ((4, 2048, 6144) bf16 rows)
    # and path V's psum of (4097, 4095) f32, each bitwise its plain version
    # and timed beside it (psum shapes) and the library call
    for n_dev, rows_, f_, dt, plain in (
            (8, 2048, 8192, torch.float32, False),
            (4, 2048, 8192, torch.bfloat16, False),
            (4, 1_572_864, 2, torch.bfloat16, True),
            (4, 2_097_152, 2, torch.float32, True)):
        xs = randn(n_dev, rows_, f_, dtype=dt)
        bound = sum(rk.RingGeometry.for_shape(n_dev, rows_, f_, dt.itemsize)
                    .bytes_moved()) / HBM_BYTES_PER_S * 1e3
        k_ms = cuda_time_ms(lambda: rk.ring_allgather_cuda(xs), 20)
        y_ms = cuda_time_ms(lambda: xs.reshape(1, -1, f_)
                            .expand(n_dev, -1, -1).contiguous(), 20)
        p_txt = ""
        if plain:
            check(torch.equal(rk.ring_allgather_cuda(xs),
                              rk.ring_allgather_plain(xs)),
                  f"ring_allgather ({n_dev}, {rows_}, {f_}) {dt} differs "
                  f"from plain")
            p_ms = cuda_time_ms(lambda: rk.ring_allgather_plain(xs), 5,
                                warmup=1)
            p_txt = f"bitwise plain, plain {p_ms:.4f} ms, "
        print(f"ring_allgather ({n_dev}, {rows_}, {f_}) {str(dt)[6:]}: "
              f"kernel {k_ms:.4f} ms, bound {bound:.4f} ms ((n + n^2) S, "
              f"{bound / k_ms:.1%} of it), {p_txt}reshape.expand.contiguous"
              f" {y_ms:.4f} ms", flush=True)
        del xs
    for op, x in inputs.items():
        rep = cuda_time_ms(coll_program(op).program.replay, 10)
        print(f"session.{op} {tuple(x.shape)}: graph replay {rep:.4f} ms",
              flush=True)

    # the paper's graph-vs-eager comparison at iteration scope
    cap_replay_ms = cuda_time_ms(cprog.replay, 10)
    cap_call_ms = host_time_ms(lambda: cap_step(uc), 10)
    eager_ms = cuda_time_ms(lambda: jacobi_step(uc, session=sess), 10)
    eager_host_ms = host_time_ms(lambda: jacobi_step(uc, session=sess), 10)
    print(f"Jacobi iteration {ranks}x({rows},{cols}) f32: captured graph "
          f"replay {cap_replay_ms:.4f} ms (CUDA events), whole captured "
          f"call {cap_call_ms:.4f} ms synced (input staging + replay + "
          f"output clone); eager jacobi_step {eager_ms:.4f} ms (CUDA "
          f"events), {eager_host_ms:.4f} ms synced", flush=True)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
          f" GiB", flush=True)
    launch64["jacobi_replay_ms"] = cap_replay_ms

    kernels = [
        {"name": "multipath_dma", "route": "cuda",
         "source": "src/repro_torch/kernels/multipath_dma/csrc/"
                   "multipath_dma.cu",
         "replaces": "src/repro/kernels/multipath_dma/kernel.py:201",
         "ms": dma_ms, "plain_ms": dma_plain_ms, "bound_ms": dma_bound,
         "bound_by": "bytes", "library_ms": where_ms,
         "library_call": "torch.where(row == dst, x[src], 0) into the "
                         "(4, n) output (a single path: no staging)"},
        {"name": "jacobi", "route": "cuda",
         "source": "src/repro_torch/kernels/jacobi/csrc/jacobi.cu",
         "replaces": "src/repro/kernels/jacobi/kernel.py:47",
         "ms": jac_ms, "plain_ms": jac_plain_ms, "bound_ms": jac_bound,
         "bound_by": "bytes", "library_ms": conv_ms,
         "library_call": "F.conv2d with the cross-shaped 3x3 weights, "
                         "cudnn tf32 off"},
        {"name": "ring_allgather", "route": "cuda",
         "source": "src/repro_torch/kernels/ring_allgather/csrc/"
                   "ring_allgather.cu",
         "replaces": "src/repro/kernels/ring_allgather/kernel.py:87",
         "ms": ring_ms, "plain_ms": ring_plain_ms, "bound_ms": ring_floor,
         "bound_by": "bytes", "library_ms": yard_ms,
         "library_call": "xs.reshape(1, n*rows, f).expand(n, -1, -1)"
                         ".contiguous()"},
    ]
    return kernels, launch64


def flash_case_times(randn, errs, b, hq, hkv, s, d, plain_iters,
                     window: int | None = None, causal: bool = True,
                     smi: str = "") -> dict:
    """``flash_attention`` at one bfloat16 shape, causal (optionally with a
    sliding ``window``) or unmasked: the kernel against its plain version
    (within ``BF16_ATOL + BF16_RTOL * |want|``), then its time beside its
    bound, the plain version's and SDPA's (the yardstick only; the port
    never calls it; with a window it gets an explicit boolean mask)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fk

    q = randn(b, hq, s, d, dtype=torch.bfloat16)
    k = randn(b, hkv, s, d, dtype=torch.bfloat16)
    v = randn(b, hkv, s, d, dtype=torch.bfloat16)
    want = fk.flash_attention_plain(q, k, v, causal=causal, window=window)
    err, ok = bf16_err(fk.flash_attention_cuda(q, k, v, causal=causal,
                                               window=window), want)
    errs["flash_attention"] = max(errs["flash_attention"], err)
    check(ok, f"flash_attention at ({b}, {hq}/{hkv}, {s}, {d}) window "
          f"{window}: max abs err {err}, beyond {BF16_ATOL} + {BF16_RTOL} * "
          f"|want|")
    kk = k.repeat_interleave(hq // hkv, dim=1)
    vv = v.repeat_interleave(hq // hkv, dim=1)
    rows = torch.arange(s, device=q.device)
    if not causal:
        mask = None
        flops = 4 * b * hq * s * s * d    # every (query, key) pair
    elif window is None:
        mask = None
        flops = 2 * b * hq * s * s * d    # causal: half of 4·B·H·S²·D
    else:
        mask = ((rows[None, :] <= rows[:, None])
                & (rows[None, :] > rows[:, None] - window))
        # every (query, key) pair the window keeps, 4·D FLOPs each
        flops = 4 * b * hq * d * int(torch.clamp(rows + 1, max=window).sum())

    def sdpa():
        if mask is None:
            return F.scaled_dot_product_attention(q, kk, vv,
                                                  is_causal=causal,
                                                  scale=d ** -0.5)
        return F.scaled_dot_product_attention(q, kk, vv, attn_mask=mask,
                                              scale=d ** -0.5)

    sdpa_err = (sdpa().float() - want.float()).abs().max().item()
    del want
    ms = cuda_time_ms(lambda: fk.flash_attention_cuda(
        q, k, v, causal=causal, window=window), 20)
    plain_ms = cuda_time_ms(lambda: fk.flash_attention_plain(
        q, k, v, causal=causal, window=window), plain_iters, warmup=1)
    lib_ms = cuda_time_ms(sdpa, 20)
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    ops_ms = flops / BF16_FLOPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(ops_ms, bytes_ms)
    rep = "repeat_interleave'd " if hq != hkv else ""
    masked = ("full" if not causal else "causal" if window is None
              else f"causal window {window}")
    lib = ("" if window is None else
           ", an explicit boolean window mask")
    card = f" ({smi})" if smi else ""
    print(f"flash_attention{card} ({b}, {hq}/{hkv}, {s}, {d}) bf16 {masked}: "
          f"kernel {ms:.4f} ms, bound {bound:.4f} ms ({flops} {masked} "
          f"FLOPs at 989 TFLOP/s = {ops_ms:.4f} ms; {nbytes} B at 3.35 "
          f"TB/s = {bytes_ms:.4f} ms; {bound / ms:.1%} of bound), plain "
          f"{plain_ms:.4f} ms, SDPA on {rep}k/v{lib} {lib_ms:.4f} ms "
          f"({bound / lib_ms:.1%} of bound; max abs diff to plain "
          f"{sdpa_err}); kernel max abs err vs plain {err}", flush=True)
    return {"shape": [b, hq, hkv, s, d], "causal": causal, "window": window,
            "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": lib_ms, "max_abs_err": err}


def flash_times(randn, errs) -> dict:
    """Phase 9's ``flash_attention`` row: at path E's prefill shape (4
    requests of 512 positions, Llama-3 8B's 32/8 heads of 128, bfloat16,
    causal), and under ``shapes`` also at path F's (4 devices x 32 heads x
    2048 positions of 128, one KV head per query head), path K's prefill
    (Hymba-1.5B: 4 requests of 1536 positions, 25/5 heads of 64, a window
    of 1024) and path L's (Mixtral-8x22B: 4 of 512, 48/8 heads of 128,
    causal; its window of 4096 does not bite)."""
    at_e = flash_case_times(randn, errs, 4, 32, 8, 512, 128, plain_iters=5)
    at_f = flash_case_times(randn, errs, 4, 32, 32, 2048, 128,
                            plain_iters=2)
    at_k = flash_case_times(randn, errs, 4, 25, 5, 1536, 64, plain_iters=2,
                            window=1024)
    at_l = flash_case_times(randn, errs, 4, 48, 8, 512, 128, plain_iters=5)
    for path, case in (("K", at_k), ("L", at_l)):
        check(case["max_abs_err"] <= 2e-2, f"flash_attention at path "
              f"{path}'s prefill shape: max abs err {case['max_abs_err']} "
              f"vs plain, beyond the reference's bf16 2e-2")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:116",
            **{key: at_e[key] for key in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms")},
            "library_call": "F.scaled_dot_product_attention(q, "
                            "k.repeat_interleave(4, 1), "
                            "v.repeat_interleave(4, 1), is_causal=True)",
            "shapes": {"E": at_e, "F": at_f, "K": at_k, "L": at_l}}


#: The reference's bound for the RWKV-6 scan: max error relative to the
#: largest output (float32 sums in another order).
RWKV_REL = 1e-4
#: Path G's bound on prefill + 8 decode steps against the full prefill,
#: the largest logit difference: 3× the sound reading (0.156, bfloat16
#: computed in two orders); a state planted one position early reads 3.93.
RWKV_DECODE_ATOL = 0.47
#: Path G's shape: 4 requests of 1024 positions, 32 heads of 64.
RWKV_SHAPE = (4, 1024, 32, 64, 64)


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Max abs difference relative to the largest ``|want|``."""
    want = want.float()
    return ((got.float() - want).abs().max() / want.abs().max()).item()


def rwkv_inputs(randn, rand, b, s, h, dk, dv, dtype=torch.float32):
    """The reference sweep's distributions in the model's ``(B, S, H, d)``
    layout: r, k ~ 0.5·N(0, 1), v ~ N(0, 1), decays uniform in [0.85,
    0.999) in float32, and a float32 bonus ~ 0.3·N(0, 1) per (batch,
    head)."""
    r = (randn(b, s, h, dk) * 0.5).to(dtype)
    k = (randn(b, s, h, dk) * 0.5).to(dtype)
    v = randn(b, s, h, dv, dtype=dtype)
    w = rand(b, s, h, dk) * 0.149 + 0.85
    u = randn(b, h, dk) * 0.3
    return r, k, v, w, u


def rwkv_checks(randn, rand, errs) -> None:
    """Phase 3's ``rwkv6_scan`` cases: the reference sweep in float32
    against the plain version and the literal recurrence, and the model's
    shape and types against the plain version, output and final state."""
    from repro_torch.kernels.rwkv6_scan import kernel as sk
    from repro_torch.kernels.rwkv6_scan import ops as sops
    from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref

    t0 = time.perf_counter()
    worst = 0.0
    for bh, s, dk, dv, chunk in ((2, 128, 32, 32, 32), (1, 200, 64, 64, 64),
                                 (4, 64, 16, 32, 16), (1, 96, 8, 8, 32)):
        *rkvw, u = rwkv_inputs(randn, rand, bh, s, 1, dk, dv)
        r, k, v, w = (t[:, :, 0] for t in rkvw)
        u = u[:, 0]
        got = sops.rwkv6_scan(r, k, v, w, u, chunk=chunk)
        plain = sops.rwkv6_scan(r.cpu(), k.cpu(), v.cpu(), w.cpu(), u.cpu(),
                                chunk=chunk).to(got.device)
        oracle = rwkv6_scan_ref(r, k, v, w, u)
        e_plain, e_ref = rel_err(got, plain), rel_err(got, oracle)
        worst = max(worst, e_plain, e_ref)
        errs["rwkv6_scan"] = max(errs["rwkv6_scan"],
                                 (got - plain).abs().max().item())
        check(e_plain < RWKV_REL and e_ref < RWKV_REL,
              f"rwkv6_scan ({bh}, {s}, {dk}, {dv}) chunk {chunk}: relative "
              f"err {e_plain} vs plain, {e_ref} vs the recurrence")
    b, s, h, dk, dv = RWKV_SHAPE
    r, k, v, w, u = rwkv_inputs(randn, rand, b, s, h, dk, dv,
                                dtype=torch.bfloat16)
    u = u[:1].expand(b, -1, -1)                  # one bonus row per head
    o, st = sk.rwkv6_scan_cuda(r, k, v, w, u, out_dtype=torch.float32,
                               return_state=True)
    po, pst = sk.rwkv6_scan_plain(r, k, v, w, u, out_dtype=torch.float32,
                                  return_state=True)
    e_o, e_s = rel_err(o, po), rel_err(st, pst)
    errs["rwkv6_scan"] = max(errs["rwkv6_scan"], (o - po).abs().max().item())
    check(e_o < RWKV_REL and e_s < RWKV_REL,
          f"rwkv6_scan at the model's shape: relative err {e_o} (output), "
          f"{e_s} (state)")
    # the first pass alone: the state at every chunk's start
    _, states, final = sk.rwkv6_scan_passes_cuda(r, k, v, w, u,
                                                 out_dtype=torch.float32)
    pstates, _ = sk.rwkv6_chunk_states_plain(k, v, w, chunk=sk.MAX_CHUNK)
    e_c = rel_err(states, pstates)
    check(e_c < RWKV_REL and torch.equal(final, st),
          f"rwkv6_scan's first pass at the model's shape: relative err {e_c} "
          f"(chunk-start states), final state equal to the scan's: "
          f"{torch.equal(final, st)}")
    print(f"rwkv6_scan vs plain and the per-step recurrence: 4 float32 sweep "
          f"cases (max relative err {worst}, limit {RWKV_REL}); "
          f"{RWKV_SHAPE} bf16 r/k/v, f32 w/u/out: relative err {e_o} "
          f"(output), {e_s} (final state), {e_c} (the first pass's "
          f"{states.shape[2]} chunk-start states of each head) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


def scan_bound(b, s, h, dk, dv, chunk) -> dict:
    """The least time of the ``rwkv6_scan`` forward at ``(B, S, H, dk,
    dv)`` with the model's types: the larger of its bytes over the HBM
    rate and its float32 work over the peak rate."""
    # each input read once, each output written once: r, k, v bfloat16,
    # w float32, one u row per head, o float32, the final state float32
    nbytes = ((2 * dk + dv) * 2 + dk * 4 + dv * 4) * b * s * h \
        + h * dk * 4 + b * h * dk * dv * 4

    # the least work of any chunking: q̃·S and the state update, 4·dk·dv
    # per position, plus per position in chunks of c the strictly causal
    # scores, (c - 1)·dk, P·V with the bonus diagonal, (c + 1)·dv, and the
    # state's decay once a chunk, dk·dv / c; at the c that needs least
    def per_position(c):
        return 4 * dk * dv + (c - 1) * dk + (c + 1) * dv + dk * dv / c

    best = min(range(1, s + 1), key=per_position)
    flops = round(b * h * s * per_position(best))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "best_chunk": best,
            "kernel_flops": round(b * h * s * per_position(chunk)),
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def rwkv_times(randn, rand, errs) -> dict:
    """Phase 9's ``rwkv6_scan`` row at path G's prefill shape, with the
    model's types (bfloat16 r/k/v, float32 w, u and output, the final
    state): the kernel against its plain version, then its time beside its
    bound and the plain version's, and each of its two kernels' times
    (CUDA events around each launch, back to back) beside the workspace
    between them. No one PyTorch call computes the scan, so there is no
    yardstick."""
    from repro_torch.kernels.rwkv6_scan import kernel as sk

    b, s, h, dk, dv = RWKV_SHAPE
    chunk = sk.MAX_CHUNK
    r, k, v, w, u = rwkv_inputs(randn, rand, b, s, h, dk, dv,
                                dtype=torch.bfloat16)
    u = u[:1].expand(b, -1, -1)

    def kernel():
        return sk.rwkv6_scan_cuda(r, k, v, w, u, chunk=chunk,
                                  out_dtype=torch.float32, return_state=True)

    def plain():
        return sk.rwkv6_scan_plain(r, k, v, w, u, chunk=chunk,
                                   out_dtype=torch.float32, return_state=True)

    (o, st), (po, pst) = kernel(), plain()
    err = (o - po).abs().max().item()
    errs["rwkv6_scan"] = max(errs["rwkv6_scan"], err)
    check(rel_err(o, po) < RWKV_REL and rel_err(st, pst) < RWKV_REL,
          "rwkv6_scan differs from plain at path G's shape")
    ms = cuda_time_ms(kernel, 20)
    plain_ms = cuda_time_ms(plain, 5, warmup=1)
    # the passes launched apart, events around each, no sync between calls
    iters = 20
    events = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
              for _ in range(iters + 2)]
    for ev in events:
        _, ws, _ = sk.rwkv6_scan_passes_cuda(r, k, v, w, u, chunk=chunk,
                                             out_dtype=torch.float32,
                                             events=ev)
    torch.cuda.synchronize()
    states_ms, output_ms = (
        sum(ev[i].elapsed_time(ev[i + 1]) for ev in events[2:]) / iters
        for i in (0, 1))
    workspace = ws.numel() * ws.element_size()
    bnd = scan_bound(b, s, h, dk, dv, chunk)
    nbytes, flops, kernel_flops, best = (bnd[k] for k in (
        "bytes", "flops", "kernel_flops", "best_chunk"))
    bytes_ms, ops_ms, bound = bnd["bytes_ms"], bnd["ops_ms"], bnd["bound_ms"]
    print(f"rwkv6_scan {RWKV_SHAPE} bf16 r/k/v, f32 w/u/out + state, chunk "
          f"{chunk}: kernel {ms:.4f} ms, bound {bound:.4f} ms ({flops} float32"
          f" FLOPs in chunks of {best} at 67 TFLOP/s = {ops_ms:.4f} ms, the "
          f"kernel's chunks of {chunk} do {kernel_flops}; {nbytes} B at 3.35 "
          f"TB/s = {bytes_ms:.4f} ms; {bound / ms:.1%} of bound), plain "
          f"{plain_ms:.4f} ms; kernel max abs err vs plain {err}; launched "
          f"apart, pass 1 (chunk-start states) {states_ms:.4f} ms, pass 2 "
          f"(outputs) {output_ms:.4f} ms, a {workspace} B float32 workspace "
          f"between them", flush=True)
    return {"name": "rwkv6_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/rwkv6_scan/csrc/rwkv6_scan.cu",
            "replaces": "src/repro/kernels/rwkv6_scan/kernel.py:99",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None,
            "passes_ms": {"states": states_ms, "output": output_ms},
            "workspace_bytes": workspace}


def _leaves(tree) -> list:
    """A tree's leaves in sorted-key order (the port's tree order,
    whatever order its dicts were built in)."""
    from repro_torch.tree import leaves

    return leaves(tree)


def eager_greedy(cfg, params, spec, toks, new) -> list[list[int]]:
    """Greedy tokens ``(B, new)`` of the eager loop on left-padded prompt
    tokens ``toks``: ``prefill_forward``, then ``make_serve_step`` and
    ``argmax`` per step, no program and no graph."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import make_serve_step

    plen = toks.shape[1]
    logits, cache = tfm.prefill_forward(params, cfg, {"tokens": toks}, spec)
    step = make_serve_step(cfg, spec)
    tok = logits[:, -1].argmax(-1)
    out = [tok]
    for i in range(new - 1):
        logits, cache = step(params, cache, tok[:, None], plen + i)
        tok = logits.argmax(-1)
        out.append(tok)
    return torch.stack(out, 1).tolist()


def program_checks(cfg, engine, toks, outs, path: str) -> None:
    """The token check (``generate``'s greedy tokens ``outs`` against the
    eager loop's) and the logit check (one decode program step against
    ``make_serve_step`` on a copy of the same cache, token and position:
    bit for bit)."""
    from repro_torch.serving import make_serve_step

    new = len(outs[0])
    want = eager_greedy(cfg, engine.params, engine.spec, toks, new)
    same = sum(a == b for o, w in zip(outs, want) for a, b in zip(o, w))
    check(outs == want, f"path {path}: generate's tokens differ from the "
          f"eager loop's in {len(outs) * new - same} of {len(outs) * new}")
    b, plen = toks.shape
    prefill = engine.prefill_program(b, plen)
    prefill.tokens.copy_(toks)
    tok = prefill()[:, -1].argmax(-1)[:, None]
    decode = engine.decode_program(b)
    eager_cache = {k: t.clone() for k, t in decode.cache.items()}
    want_lg, _ = make_serve_step(cfg, engine.spec)(engine.params, eager_cache,
                                                   tok, plen)
    decode.tokens.copy_(tok)
    decode.cur_len.fill_(plen)
    got = decode()
    diff = (got.float() - want_lg.float()).abs().max().item()
    cache_same = all(torch.equal(decode.cache[k], eager_cache[k])
                     for k in eager_cache)
    print(f"path {path}: generate's greedy tokens (prefill and decode "
          f"programs, captured) equal the eager loop's, {same} of "
          f"{len(outs) * new}; one decode program replay vs the eager step "
          f"at position {plen}: logits max abs diff {diff}, bitwise "
          f"{torch.equal(got, want_lg)}, cache bitwise {cache_same}",
          flush=True)
    check(torch.equal(got, want_lg) and cache_same, f"path {path}: the "
          f"captured decode step differs from the eager step (logits max "
          f"abs diff {diff}, cache bitwise {cache_same})")
    del eager_cache


def serving_times(cfg, engine, sess, toks, logits, cache, new,
                  gen_s: tuple[float, float], path: str,
                  dst: int = 1) -> dict:
    """Print a served model's times, in one call: the prefill program's
    replay against the eager ``prefill_forward``; the decode step (``new -
    1`` greedy steps from the end of ``toks``, the argmax included) as the
    decode program's replay and as the eager ``make_serve_step``, twice
    each in turns (CUDA events); each one's device time, op count and idle
    share under the profiler; tokens/s of the second ``generate`` (host
    clock, ``gen_s`` = first and second call); the device memory that the
    engine's graphs hold; and, with a session ``sess``, the migration of
    ``cache`` (graph replay, whole ``migrate_kv``) to device ``dst``.
    Returns the prefill replay's, the captured and the eager decode
    step's ms and the peak GiB."""
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import make_serve_step

    b, plen = toks.shape
    params, spec = engine.params, engine.spec
    prefill = engine.prefill_program(b, plen)
    prefill.tokens.copy_(toks)
    decode = engine.decode_program(b)
    serve_step = make_serve_step(cfg, spec)

    def eager_prefill():
        return tfm.prefill_forward(params, cfg, {"tokens": toks}, spec)

    replay_ms = cuda_time_ms(prefill, 3, warmup=1)
    eager_prefill_ms = cuda_time_ms(eager_prefill, 3, warmup=1)
    _, dcache = eager_prefill()
    tok0 = logits[:, -1].argmax(-1)[:, None]

    def captured(tok, pos):
        decode.tokens.copy_(tok)
        decode.cur_len.fill_(pos)
        return decode().argmax(-1)[:, None]

    def eager(tok, pos):
        lg, _ = serve_step(params, dcache, tok, pos)
        return lg.argmax(-1)[:, None]

    def step_ms(one):
        prefill()
        tok = tok0
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for i in range(new - 1):
            tok = one(tok, plen + i)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (new - 1)

    turns = [("captured", step_ms(captured)), ("eager", step_ms(eager)),
             ("captured", step_ms(captured)), ("eager", step_ms(eager))]
    cap_ms = min(ms for kind, ms in turns if kind == "captured")
    eager_ms = min(ms for kind, ms in turns if kind == "eager")
    decode.tokens.copy_(tok0)
    decode.cur_len.fill_(plen + new - 1)
    prof = {
        "prefill replay": (profile_device_ms(prefill), replay_ms),
        "eager prefill": (profile_device_ms(eager_prefill),
                          eager_prefill_ms),
        "decode replay": (profile_device_ms(decode), cap_ms),
        "eager decode step": (profile_device_ms(
            lambda: serve_step(params, dcache, tok0, plen + new - 1)),
            eager_ms)}
    eager_dev = {"prefill replay": prof["eager prefill"][0][1],
                 "decode replay": prof["eager decode step"][0][1]}
    for name, ((wall, dev_ms, n_ops, rows), ms) in prof.items():
        if dev_ms <= 0:
            idle = "not measured: the profiler recorded no device time"
        elif n_ops <= 1 and name in eager_dev:
            idle = (f"the profiler shows the replay as {n_ops} op; against "
                    f"the eager version's {eager_dev[name]:.2f} ms of "
                    f"device time: {1 - eager_dev[name] / ms:.1%}")
        else:
            idle = f"{1 - dev_ms / ms:.1%}"
        print(f"profiler, path {path}, {name} (one call): {dev_ms:.2f} ms "
              f"of device time in {n_ops} device ops, {wall:.2f} ms wall; "
              f"idle share vs the unprofiled {ms:.2f} ms: {idle}; top ms: "
              f"{top_ops(rows)}", flush=True)
    migration = "no migration"
    if sess is not None:
        mig = next(iter(sess.engine._fastpath._store.values()))[1]
        mig_ms = cuda_time_ms(mig.compiled.program.replay, 10)
        mig_call_ms = host_time_ms(
            lambda: engine.migrate_kv(cache, 0, dst), 5)
        migration = (f"migration of the cache 0->{dst}: graph replay "
                     f"{mig_ms:.4f} "
                     f"ms, whole migrate_kv {mig_call_ms:.4f} ms synced")
    gen1_s, gen2_s = gen_s
    held = {f"prefill {key}": p.held_bytes
            for key, p in engine._prefills.items()}
    held.update({f"decode {key}": p.held_bytes
                 for key, p in engine._decodes.items()})
    print(f"serving {cfg.name} {cfg.dtype}, batch {b}: prefill of "
          f"{tuple(toks.shape)} tokens: program replay {replay_ms:.2f} ms, "
          f"eager {eager_prefill_ms:.2f} ms (CUDA events); decode per "
          f"token step ({new - 1} steps from position {plen}, argmax "
          f"included; CUDA events, in turns "
          f"{', '.join(f'{k} {ms:.2f}' for k, ms in turns)}): captured "
          f"{cap_ms:.2f} ms, eager {eager_ms:.2f} ms, captured/eager "
          f"{cap_ms / eager_ms:.3f}; generate of {b} x {new} tokens "
          f"{gen2_s:.3f} s = {b * new / gen2_s:.1f} tokens/s (host clock, "
          f"second call; first {gen1_s:.3f} s, with the captures); the "
          f"engine's graphs hold {engine.graph_bytes() / 2**20:.1f} MiB ("
          f"{', '.join(f'{k} {v / 2**20:.1f}' for k, v in held.items())}); "
          f"{migration}", flush=True)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"peak device memory, path {path}: {peak:.2f} GiB", flush=True)
    return {"prefill_ms": replay_ms, "decode_ms": cap_ms,
            "eager_decode_ms": eager_ms, "peak_gib": peak}


def serving_paths(dev, errs, per_path, read_path) -> None:
    """Main paths E (phase 10: serving Llama-3 8B at full width) and F
    (phase 11: the captured decode step), each read with the counters set
    to 0 just before it."""
    from repro_torch.comm import CommSession
    from repro_torch.configs import get_config
    from repro_torch.kernels._graph import reset_launch_counts
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import ServeEngine, make_captured_decode_step

    # -- 10. main path E: serving -------------------------------------------
    cfg = get_config("llama3_8b")
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.head_dim_, cfg.d_ff, cfg.vocab_size, cfg.dtype)
          == (32, 4096, 32, 8, 128, 14336, 128256, "bfloat16"),
          f"llama3_8b is not the full-width config: {cfg}")
    params = init_model(cfg, dev, "E")
    sess = CommSession()
    engine = ServeEngine(cfg, params, max_len=1024, kv_chunks=4, comm=sess)
    tok_gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (n,),
                             generator=tok_gen).tolist()
               for n in (512, 384, 256, 128)]
    new = 32
    toks, outs, logits, cache, (gen1_s, gen2_s) = serve_requests(
        cfg, engine, prompts, new, "E", per_path, read_path, migrate_to=1)
    plen = toks.shape[1]
    program_checks(cfg, engine, toks, outs, "E")

    # the kernel at layer 0's real prefill q/k/v, and the whole prefill on
    # the plain version
    layer0_attention_check(cfg, params, toks, errs, "E")

    def plain_attention(q, k, v, *, causal, window, scale, block_k=1024):
        return fk.flash_attention_plain(
            q, k, v, causal=causal, window=window if window >= 0 else None,
            scale=scale)

    kernel_attention = tfm.blockwise_attention
    tfm.blockwise_attention = plain_attention
    try:
        plain_logits, _ = tfm.prefill_forward(params, cfg, {"tokens": toks},
                                              engine.spec)
    finally:
        tfm.blockwise_attention = kernel_attention
    logit_diff = (logits.float() - plain_logits.float()).abs().max().item()
    same_next = (logits[:, -1].argmax(-1) == plain_logits[:, -1].argmax(-1)
                 ).tolist()
    print(f"path E: whole prefill {tuple(toks.shape)}, kernel vs plain "
          f"attention: logits max abs diff {logit_diff} (|logits| max "
          f"{logits.float().abs().max().item():.3f}), same next token "
          f"{same_next}", flush=True)
    del plain_logits

    serving_times(cfg, engine, sess, toks, logits, cache, new,
                  (gen1_s, gen2_s), "E")
    del logits, cache, engine, params
    gc.collect()
    torch.cuda.empty_cache()

    # -- 11. main path F: the captured decode step ----------------------------
    n = sess.num_devices
    heads, kv_len, hd = 32, 2048, 128
    kv_chunk = 2 * 8 * kv_len * hd          # one layer's K and V, 8 MiB
    step = make_captured_decode_step(
        sess, batch=1, heads=heads, kv_len=kv_len, head_dim=hd,
        kv_chunk=kv_chunk, src=0, dst=2, dtype=torch.bfloat16,
        schedule="overlap")
    g = torch.Generator(device=dev).manual_seed(2)
    q, k, v = (torch.randn((n, 1, heads, kv_len, hd), generator=g,
                           device=dev).to(torch.bfloat16) for _ in range(3))
    kv = torch.randn((n, kv_chunk), generator=g, device=dev).to(
        torch.bfloat16)
    entry = step.resolve()
    prog = entry.compiled.program
    calls = 5
    d0 = sess.stats()["dispatches"]
    reset_launch_counts()
    for _ in range(calls):
        attn, new_kv = step(q, k, v, kv)
    torch.cuda.synchronize()
    read_path("F")
    check(sess.stats()["dispatches"] - d0 == calls,
          "the captured decode step was not one dispatch per call")
    check(per_path["F"].get("flash_attention", 0) == calls
          and per_path["F"].get("multipath_dma", 0) >= calls
          and prog.replay_launches.get("flash_attention") == 1
          and prog.replay_launches.get("multipath_dma", 0) >= 1,
          f"captured decode step launches {per_path['F']} (per replay "
          f"{prog.replay_launches}) != one flash_attention and at least "
          f"one multipath_dma per replay")
    q4, k4, v4 = (t.view(n, heads, kv_len, hd) for t in (q, k, v))
    want = fk.flash_attention_plain(q4, k4, v4)
    errf, ok = bf16_err(attn.view(n, heads, kv_len, hd), want)
    errs["flash_attention"] = max(errs["flash_attention"], errf)
    check(ok, f"captured decode step attention: max abs err {errf}, "
          f"beyond {BF16_ATOL} + {BF16_RTOL} * |want|")
    expect = kv.clone()
    expect[2] = kv[0]
    check(torch.equal(new_kv, expect), "captured decode step: the KV chunk "
          "did not land bitwise on device 2")
    del want
    replay_ms = cuda_time_ms(prog.replay, 10)
    call_ms = host_time_ms(lambda: step(q, k, v, kv), 5)
    attn_ms = cuda_time_ms(lambda: fops.flash_attention(q4, k4, v4), 10)

    def eager():
        fops.flash_attention(q4, k4, v4)
        sess.send(kv[0], 0, 2)

    eager_ms = cuda_time_ms(eager, 5)
    eager_host_ms = host_time_ms(eager, 5)
    for name, fn in (("graph replay", prog.replay),
                     ("eager attention + session.send", eager)):
        wall, dev_ms, n_ops, rows = profile_device_ms(fn, top=None)
        print(f"profiler, path F, {name} (one call): {dev_ms:.4f} ms of "
              f"device time in {n_ops} device ops, {wall:.4f} ms wall; every "
              f"op: {top_ops(rows)}", flush=True)
    print(f"captured decode step ({n} devices x (1, {heads}, {kv_len}, "
          f"{hd}) bf16 attention + {kv_chunk * 2 / MiB:.0f} MiB KV chunk "
          f"0->2, schedule {entry.schedule}, walk "
          f"{[type(w).__name__ for w in prog.walk]}): one dispatch per "
          f"call, per replay {prog.replay_launches}; attention max abs err "
          f"vs plain {errf}, KV chunk bitwise; graph replay "
          f"{replay_ms:.4f} ms (CUDA events), whole call {call_ms:.4f} ms "
          f"synced; eager attention + session.send {eager_ms:.4f} ms (CUDA "
          f"events), {eager_host_ms:.4f} ms synced; attention alone "
          f"{attn_ms:.4f} ms", flush=True)
    print(f"peak device memory, paths E-F: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)


def served_readings(engine, prompts, new, toks, outs, logits) -> dict:
    """A serving path's readings that path AD holds its peer meshes to:
    the prompts and ``new``, generate's tokens, the padded prompts, the
    prefill logits and one decode program step's after them (on the host)."""
    return {"prompts": prompts, "new": new, "outs": outs,
            "toks": toks.cpu(), "logits": logits.cpu(),
            "dec": decode_logits(engine, toks, logits).cpu()}


def rwkv_path(dev, errs, per_path, read_path, at_out: dict) -> None:
    """Main path G (phase 12): serving RWKV-6 1.6B at full width, read with
    the counters set to 0 just before it; then the kernel at layer 0's
    real prefill, prefill-then-decode against the full prefill, and the
    times. Puts :func:`served_readings` in ``at_out``."""
    from repro_torch.comm import CommSession
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6_scan import kernel as sk
    from repro_torch.models import layers, ssm
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import ServeEngine

    # -- 12. main path G: serving RWKV-6 ------------------------------------
    cfg = get_config("rwkv6_1_6b")
    hd = cfg.rwkv_head_dim
    check((cfg.family, cfg.num_layers, cfg.d_model, cfg.d_model // hd, hd,
           cfg.d_ff, cfg.mlp, cfg.vocab_size, cfg.dtype)
          == ("ssm", 24, 2048, 32, 64, 7168, "relu2", 65536, "bfloat16"),
          f"rwkv6_1_6b is not the full-width config: {cfg}")
    params = init_model(cfg, dev, "G")
    sess = CommSession()
    engine = ServeEngine(cfg, params, comm=sess)
    tok_gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (n,),
                             generator=tok_gen).tolist()
               for n in (1024, 768, 512, 256)]
    new = 32
    toks, outs, logits, cache, (gen1_s, gen2_s) = serve_requests(
        cfg, engine, prompts, new, "G", per_path, read_path,
        kernel="rwkv6_scan", migrate_to=1)
    plen = toks.shape[1]
    check(sorted(cache) == ["rwkv_shift", "rwkv_state"]
          and cache["rwkv_state"].dtype == torch.float32
          and cache["rwkv_shift"].dtype == torch.bfloat16,
          f"path G cache {[(k, t.dtype) for k, t in cache.items()]}")
    program_checks(cfg, engine, toks, outs, "G")
    at_out.update(served_readings(engine, prompts, new, toks, outs, logits))

    # the kernel at layer 0's real prefill r/k/v/w, and the decay range
    lp = tfm.layer_params(params, 0)
    x = layers.rms_norm(params["embed"][toks], lp["ln1"])
    shifted = torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]
    r, k, v, w, _ = ssm._rwkv6_project(x, shifted, lp["rwkv"], hd)
    u = lp["rwkv"]["u"].expand(len(prompts), -1, -1)
    o, st = sk.rwkv6_scan_cuda(r, k, v, w, u, out_dtype=torch.float32,
                               return_state=True)
    po, pst = sk.rwkv6_scan_plain(r, k, v, w, u, out_dtype=torch.float32,
                                  return_state=True)
    e_o, e_s = rel_err(o, po), rel_err(st, pst)
    errs["rwkv6_scan"] = max(errs["rwkv6_scan"], (o - po).abs().max().item())
    check(e_o < RWKV_REL and e_s < RWKV_REL and bool(torch.isfinite(o).all()),
          f"rwkv6_scan at layer 0's prefill: relative err {e_o} (output), "
          f"{e_s} (state)")
    logw = torch.log(w)
    chunk_decay = -logw.reshape(len(prompts), plen // sk.MAX_CHUNK,
                                sk.MAX_CHUNK, *logw.shape[2:]).sum(2)
    print(f"layer 0 prefill r/k/v/w {tuple(r.shape)}: kernel vs plain "
          f"relative err {e_o} (output), {e_s} (final state), limit "
          f"{RWKV_REL}; log w in [{logw.min().item():.4f}, "
          f"{logw.max().item():.4f}], largest decay over one chunk of "
          f"{sk.MAX_CHUNK}: exp({chunk_decay.max().item():.3f})", flush=True)
    del x, shifted, r, k, v, w, o, st, po, pst, logw, chunk_decay

    # prefill of all but the last 8 tokens, then 8 decode steps, against
    # the full prefill's logits; then the same with a state planted wrong,
    # each of which the limit must catch
    start = plen - 8

    def state_of(n):
        def plant(c):
            c["rwkv_state"].copy_(engine.prefill(toks[:, :n])[1]["rwkv_state"])
        return plant

    tail_checks(cfg, engine, toks, logits, RWKV_DECODE_ATOL, {
        "zeroed state": lambda c: c["rwkv_state"].zero_(),
        f"state one chunk ({sk.MAX_CHUNK}) early":
            state_of(start - sk.MAX_CHUNK),
        "state one position early": state_of(start - 1)}, "G")

    serving_times(cfg, engine, sess, toks, logits, cache, new,
                  (gen1_s, gen2_s), "G")
def quantile(xs, q: float) -> float:
    """The ``q`` quantile of ``xs`` (linear between the order
    statistics)."""
    xs = sorted(xs)
    pos = q * (len(xs) - 1)
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def calibration_path(dev, errs, per_path, read_path, launch64: dict,
                     smi: str) -> None:
    """Main path H (phase 13): the measured-feedback loop, read with the
    counters set to 0 just before it. A ``CommSession`` with telemetry on
    and a profile directory records every dispatch of a send sweep, an
    exchange and path F's captured decode step, times ``flash_attention``
    and ``ring_allgather`` into the recorder's kernel channel, fits and
    persists a calibration profile, and sends again under it; then the
    fitted terms beside the nominal ones, the residuals and telemetry's
    own cost."""
    import tempfile

    from repro_torch.comm import (CalibrationFitter, CommConfig,
                                  CommSession, StageTimings,
                                  modeled_sample_time_s, modeled_vs_measured)
    from repro_torch.core import pipelining as pl
    from repro_torch.core.topology import Topology
    from repro_torch.kernels._graph import reset_launch_counts
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.kernels.ring_allgather import kernel as rk
    from repro_torch.kernels.ring_allgather.ops import captured_ring_allgather
    from repro_torch.serving import make_captured_decode_step

    # -- 13. main path H: telemetry and calibration --------------------------
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    profiles = tempfile.TemporaryDirectory(
        dir=os.path.join(HERE, "build"), prefix="profiles-")
    reset_launch_counts()
    # health off: a probe is a dispatch that records no sample, and the
    # droop monitor on this traffic is path I's to measure
    sess = CommSession(CommConfig(telemetry=True, health=False,
                                  profile_dir=profiles.name))
    rec = sess.telemetry
    check(rec.enabled and sess.topology.calibration is None,
          "path H session: telemetry off or a profile already attached")
    walls = []

    def dispatch(fn):
        """Run one dispatch, keeping its host wall time beside the one
        sample it must record."""
        n0 = rec.recorded
        t0 = time.perf_counter_ns()
        out = fn()
        wall = time.perf_counter_ns() - t0
        check(rec.recorded == n0 + 1, f"a dispatch recorded "
              f"{rec.recorded - n0} samples, not one")
        walls.append((rec.samples()[-1], wall))
        return out

    g = torch.Generator(device=dev).manual_seed(7)
    big = torch.randn(1 << 26, generator=g, device=dev)       # 256 MiB f32
    sizes = (64 * 1024, MiB, 16 * MiB, 64 * MiB, 256 * MiB)
    sweep = [(nbytes, paths) for nbytes in sizes for paths in (1, 2, 3)]
    quarter = [torch.randn(4 * MiB, generator=g, device=dev)
               for _ in range(4)]                            # 16 MiB each
    items = [(quarter[i], i, (i + 1) % 4) for i in range(4)]

    def send_sweep(reps: int) -> None:
        for nbytes, paths in sweep:
            m = big[: nbytes // 4]
            for _ in range(reps):
                got = dispatch(lambda: sess.send(m, 0, 1, max_paths=paths))
                check(torch.equal(got, m), f"path H: {nbytes} B send with "
                      f"max_paths={paths} not bitwise")

    def exchange(reps: int) -> None:
        for _ in range(reps):
            got = dispatch(lambda: sess.exchange(items))
            check(all(torch.equal(a, b) for a, b in zip(got, quarter)),
                  "path H: 4-message exchange not bitwise")

    send_sweep(10)                      # 2 warm-up + 8 kept per signature
    exchange(10)

    # the kernel channel: CUDA-event times of the two kernels
    n = sess.num_devices
    heads, kv_len, hd = 32, 2048, 128
    q, k, v = (torch.randn((n, 1, heads, kv_len, hd), generator=g,
                           device=dev).to(torch.bfloat16) for _ in range(3))
    q4, k4, v4 = (t.view(n, heads, kv_len, hd) for t in (q, k, v))
    rows_ag = torch.randn((n, 2048, 8192), generator=g, device=dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for name, fn in (("flash_attention",
                      lambda: fops.flash_attention(q4, k4, v4)),
                     ("ring_allgather",
                      lambda: rk.ring_allgather_cuda(rows_ag))):
        for _ in range(5):
            torch.cuda.synchronize()
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            rec.record_kernel(name, start.elapsed_time(end) * 1e6)

    # path F's captured decode step, its attention node priced from them
    kv_chunk = 2 * 8 * kv_len * hd
    kv = torch.randn((n, kv_chunk), generator=g, device=dev).to(
        torch.bfloat16)
    step = make_captured_decode_step(
        sess, batch=1, heads=heads, kv_len=kv_len, head_dim=hd,
        kv_chunk=kv_chunk, src=0, dst=2, dtype=torch.bfloat16,
        schedule="overlap")
    entry = step.resolve()
    (attn_node,) = [nd for nd in entry.graph.nodes
                    if getattr(nd, "kernel", None) == "flash_attention"]
    want_cost = int(rec.kernel_cost_ns("flash_attention"))
    check(want_cost > 0 and attn_node.cost_ns == want_cost,
          f"path H: the decode step's attention node carries cost_ns "
          f"{attn_node.cost_ns}, not the recorder's {want_cost}")
    want_attn = fk.flash_attention_plain(q4, k4, v4)
    want_kv = kv.clone()
    want_kv[2] = kv[0]

    def decode_calls(reps: int) -> float:
        worst = 0.0
        for _ in range(reps):
            attn, new_kv = dispatch(lambda: step(q, k, v, kv))
            err, ok = bf16_err(attn.view(n, heads, kv_len, hd), want_attn)
            check(ok, f"path H: decode step attention max abs err {err}, "
                  f"beyond {BF16_ATOL} + {BF16_RTOL} * |want|")
            check(torch.equal(new_kv, want_kv), "path H: the KV chunk did "
                  "not land bitwise on device 2")
            worst = max(worst, err)
        return worst

    worst = decode_calls(3)

    # the ring adopter: its node priced from the kernel channel
    ring_step = sess.capture(lambda cap: captured_ring_allgather(
        cap, cap.input((2048, 8192), torch.float32), n,
        telemetry=sess.telemetry))
    rentry = ring_step.resolve()
    (ring_node,) = [nd for nd in rentry.graph.nodes
                    if getattr(nd, "kernel", None) == "ring_allgather"]
    ring_cost = int(rec.kernel_cost_ns("ring_allgather"))
    check(ring_cost > 0 and ring_node.cost_ns == ring_cost,
          f"path H: the ring node carries cost_ns {ring_node.cost_ns}, not "
          f"the recorder's {ring_cost}")
    (gathered,) = dispatch(lambda: ring_step(rows_ag))
    check(torch.equal(gathered, rk.ring_allgather_plain(rows_ag).reshape(
        n, n * 2048, 8192)), "path H: captured ring all-gather not bitwise")
    del gathered

    # fit, attach and persist
    fitted_from = rec.samples()
    t0 = time.perf_counter()
    epoch = sess.planner.epoch
    prof = sess.calibrate(min_samples=3, warmup=2, persist=True)
    fit_ms = (time.perf_counter() - t0) * 1e3
    check(sess.topology.calibration is prof and sess.planner.epoch != epoch,
          "path H: the fitted profile was not attached")
    check(prof.launch is not None and prof.link_bandwidth_gbps
          and set(prof.kernel_cost_ns) == {"flash_attention",
                                           "ring_allgather"},
          f"path H: the profile lacks terms: {prof.summary()}")
    # under the fitted terms the same traffic replans; still bitwise
    send_sweep(2)
    exchange(2)
    worst = max(worst, decode_calls(1))
    torch.cuda.synchronize()
    read_path("H")
    errs["flash_attention"] = max(errs["flash_attention"], worst)
    for name in ("multipath_dma", "flash_attention", "ring_allgather"):
        check(per_path["H"].get(name, 0) > 0,
              f"path H did not launch {name}")

    # the recorder's own checks
    samples = rec.samples()
    dispatches = sess.stats()["dispatches"]
    check(len(samples) == rec.recorded == dispatches == len(walls),
          f"path H: {rec.recorded} samples recorded for {dispatches} "
          f"dispatches")
    for smp, wall in walls:
        st = smp.stages
        check(st.launch_ns > 0 and st.execute_ns > 0,
              f"path H: a sample without launch or execute time: {st}")
        check(st.total_ns <= wall, f"path H: stage sum {st.total_ns} ns "
              f"over the call's wall time {wall} ns")
        if smp.fastpath_hit:
            check((st.plan_ns, st.lower_ns, st.schedule_ns, st.compile_ns)
                  == (0, 0, 0, 0), f"path H: a fast-path hit with setup "
                  f"time: {st}")
    hits = sum(smp.fastpath_hit for smp in samples)
    other = CommSession(CommConfig(profile_dir=profiles.name))
    loaded = other.topology.calibration
    check(loaded is not None and loaded.to_payload() == prof.to_payload()
          and other.stats()["calibration"]["active"],
          "path H: a second session did not load the fitted profile")
    files = os.listdir(profiles.name)
    print(f"path H ({smi}): {dispatches} dispatches, {len(samples)} "
          f"samples ({hits} fast-path hits, every one with zero setup "
          f"stages; launch and execute > 0 and the stage sum within the "
          f"call's wall time in every sample); every message bitwise before "
          f"and after the profile ({len(fitted_from)} samples fitted in "
          f"{fit_ms:.1f} ms, persisted as {files}, loaded by a second "
          f"session); decode step attention max abs err {worst}, KV chunk "
          f"bitwise; attention node cost_ns {attn_node.cost_ns}, ring node "
          f"cost_ns {ring_node.cost_ns}", flush=True)

    # what the fitter saw: median launch and execute per node count
    by_nodes: dict[int, list] = {}
    for smp in fitted_from:
        if not smp.compute and smp.fastpath_hit:
            by_nodes.setdefault(smp.num_nodes, []).append(smp.stages)
    print(f"path H ({smi}): fast-path pure-comm samples by node count, "
          f"median launch / execute / staging us: " + ", ".join(
              f"{nodes} nodes x{len(st)}: "
              f"{quantile([x.launch_ns for x in st], 0.5) / 1e3:.2f} / "
              f"{quantile([x.execute_ns for x in st], 0.5) / 1e3:.2f} / "
              f"{quantile([x.staging_ns for x in st], 0.5) / 1e3:.2f}"
              for nodes, st in sorted(by_nodes.items())), flush=True)
    inst = [(smp.num_nodes, smp.stages.compile_ns / 1e6)
            for smp in fitted_from if smp.stages.compile_ns]
    # every build is a signature's first dispatch, which the warm-up
    # drops: the same fitter without warm-up fits the instantiate terms
    builds = CalibrationFitter(sess.topology, min_samples=3,
                               warmup=0).fit(fitted_from).launch
    print(f"path H ({smi}): graph builds (nodes, ms): {inst}; fitted "
          f"without warm-up: instantiate base "
          f"{builds.graph_instantiate_base_ns:.1f} ns + "
          f"{builds.graph_instantiate_per_node_ns:.3f} ns/node", flush=True)

    launch = prof.launch
    print(f"path H ({smi}): fitted launch terms from "
          f"{prof.launch_samples} samples: graph launch base "
          f"{launch.graph_launch_base_ns:.1f} ns + "
          f"{launch.graph_launch_per_node_ns:.3f} ns/node (nominal "
          f"{pl.GRAPH_LAUNCH_BASE_NS} + {pl.GRAPH_LAUNCH_PER_NODE_NS}), "
          f"instantiate base {launch.graph_instantiate_base_ns:.1f} ns + "
          f"{launch.graph_instantiate_per_node_ns:.3f} ns/node (nominal "
          f"{pl.GRAPH_INSTANTIATE_BASE_NS} + "
          f"{pl.GRAPH_INSTANTIATE_PER_NODE_NS}); phase 9's 64 KiB send "
          f"({launch64['copy_nodes']} copy nodes): graph replay "
          f"{launch64['replay_us']:.2f} us/dispatch back to back "
          f"({launch64['replay_synced_us']:.2f} synced), eager kernel "
          f"launch {launch64['eager_us']:.2f} us "
          f"({launch64['eager_synced_us']:.2f} synced)", flush=True)
    nominal = Topology.full_mesh(4, with_host=True).links
    print(f"path H ({smi}): fitted link bandwidths, GB/s (nominal; every "
          f"link is the one HBM here, so these describe the multipath_dma "
          f"kernel): " + ", ".join(
              f"{a}->{b} {bw} ({nominal[(a, b)].bandwidth_gbps}, "
              f"{prof.link_samples[(a, b)]} samples)"
              for (a, b), bw in sorted(prof.link_bandwidth_gbps.items())),
          flush=True)
    print(f"path H ({smi}): fitted kernel costs ns: " + ", ".join(
        f"{name} {ns} ({prof.kernel_samples[name]} samples)"
        for name, ns in sorted(prof.kernel_cost_ns.items())), flush=True)
    topo = sess.topology
    resid = {}
    for label, p in (("nominal", None), ("fitted", prof)):
        rel = [abs(modeled_sample_time_s(smp, topo, p) - smp.measured_s)
               / smp.measured_s for smp in fitted_from]
        resid[label] = (quantile(rel, 0.5), quantile(rel, 0.9))
    mvm = modeled_vs_measured(fitted_from, topo, prof)
    print(f"path H ({smi}): modeled vs measured over the "
          f"{len(fitted_from)} fitted samples, relative error median / "
          f"p90: nominal {resid['nominal'][0]:.4f} / "
          f"{resid['nominal'][1]:.4f}, fitted {resid['fitted'][0]:.4f} / "
          f"{resid['fitted'][1]:.4f} (modeled_vs_measured: {mvm})",
          flush=True)
    del step, ring_step, entry, rentry, q, k, v, q4, k4, v4, kv, want_attn
    del sess, other, big, quarter, items, rows_ag, samples, fitted_from
    profiles.cleanup()
    gc.collect()
    torch.cuda.empty_cache()

    # telemetry's own cost: one session's 64 KiB send with its recorder
    # on and off, in turns (the same program and graph either way)
    tsess = CommSession(CommConfig(telemetry=True, health=False))
    msg = torch.randn(16 * 1024, generator=g, device=dev)
    times = {True: [], False: []}
    for on in (True, False, False, True, True, False, False, True):
        tsess.telemetry.enabled = on
        gc.collect()
        times[on].append(host_time_ms(lambda: tsess.send(msg, 0, 1), 500,
                                      warmup=20) * 1e3)
    tel = tsess.telemetry
    check(tel.recorded == 4 * 520, f"the recorder kept {tel.recorded} "
          f"samples of {4 * 520} dispatches with it on")
    mean_on, mean_off = (sum(times[k]) / 4 for k in (True, False))
    # the same replay through timed_call alone, on an idle stream and
    # behind the staging copy a dispatch enqueues first; one record's cost
    (_, tentry), = tsess.engine._fastpath._store.values()
    compiled = tentry.compiled
    split = [compiled.timed_call()[1:] for _ in range(300)]
    staged = []
    for _ in range(300):
        compiled.inputs()[0][:, 0].copy_(msg)
        staged.append(compiled.timed_call()[1])
    t0 = time.perf_counter_ns()
    for _ in range(1000):
        tsess.engine._record(tentry, StageTimings(), True, 1)
    record_us = (time.perf_counter_ns() - t0) / 1000 / 1e3
    print(f"path H ({smi}): 64 KiB send ({tentry.graph.num_nodes} copy "
          f"node) host time synced, recorder on {mean_on:.3f} us, off "
          f"{mean_off:.3f} us (one session, in turns, 4 x 500 calls each: "
          f"on {[round(t, 3) for t in times[True]]}, off "
          f"{[round(t, 3) for t in times[False]]}): "
          f"{mean_on - mean_off:.3f} us a dispatch; building and recording "
          f"one sample alone {record_us:.3f} us; its replay through "
          f"timed_call alone, median launch "
          f"{quantile([a for a, _ in split], 0.5) / 1e3:.2f} us, execute "
          f"{quantile([b for _, b in split], 0.5) / 1e3:.2f} us; launch "
          f"behind a staging copy_ {quantile(staged, 0.5) / 1e3:.2f} us",
          flush=True)

def held_mib(sess) -> float:
    """MiB of device memory that a session's cached send programs hold:
    each one's byte buffers (operand, output, staging) and its graph's
    pool."""
    return sum(c.program.x.numel() + c.program.y.numel()
               + c.program.stage.numel() + c.program.held_bytes
               for c in sess.cache.values()) / MiB


def health_path(dev, errs, per_path, read_path, smi: str,
                a_replay_ms: float) -> None:
    """Main path I (phase 14): the §4.6 health ladder, read with the
    counters set to 0 just before it. A send's healthy cost with the
    monitor on and off; a mid-traffic link failure and its recovery; an
    injected drop/degrade/flap schedule; the host relay; path F's
    captured decode step through a failed link; a KV migration of
    SmolLM-360M at full width under a failed link; and the droop
    monitor's ratios on healthy traffic under a fitted profile."""
    from repro_torch.comm import (CommConfig, CommSession,
                                  modeled_sample_time_s)
    from repro_torch.configs import get_config
    from repro_torch.kernels._graph import reset_launch_counts
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import ServeEngine, make_captured_decode_step

    # -- 14. main path I: the health ladder ---------------------------------
    reset_launch_counts()
    g = torch.Generator(device=dev).manual_seed(11)
    big = torch.randn(1 << 26, generator=g, device=dev)      # 256 MiB f32
    msg64 = big[: 16 * 1024]                                 # 64 KiB f32

    # 1. the healthy path's cost: monitor on and off, in turns
    sessions = {on: CommSession(CommConfig(health=on, schedule="auto"))
                for on in (True, False)}
    host_us = {True: [], False: []}
    dev_ms = {True: [], False: []}
    for on in (True, False, False, True, True, False, False, True):
        sess = sessions[on]
        check(torch.equal(sess.send(msg64, 0, 1, max_paths=3), msg64)
              and torch.equal(sess.send(big, 0, 1, max_paths=3), big),
              f"path I: a healthy send with health={on} not bitwise")
        gc.collect()
        host_us[on].append(host_time_ms(
            lambda: sess.send(msg64, 0, 1, max_paths=3), 300,
            warmup=20) * 1e3)
        dev_ms[on].append(cuda_time_ms(
            lambda: sess.send(big, 0, 1, max_paths=3), 10))
    replay = {}
    for on, sess in sessions.items():
        check(sess.stats()["health"]["ladder_level"] == 0
              and (sess.monitor is not None) == on,
              f"path I: health={on} session state wrong")
        compiled, _ = sess.compiled_for(0, 1, big.numel(), max_paths=3)
        replay[on] = cuda_time_ms(compiled.program.replay, 20)
        check(abs(replay[on] / a_replay_ms - 1) <= 0.05,
              f"path I: 256 MiB replay with health={on} {replay[on]:.4f} "
              f"ms, not within 5% of path A's {a_replay_ms:.4f} ms")
    mean = {on: (sum(host_us[on]) / 4, sum(dev_ms[on]) / 4)
            for on in (True, False)}
    print(f"path I ({smi}): healthy cost, one call, in turns (4 rounds "
          f"each): 64 KiB send host time synced, health on "
          f"{mean[True][0]:.3f} us, off {mean[False][0]:.3f} us (on "
          f"{[round(t, 3) for t in host_us[True]]}, off "
          f"{[round(t, 3) for t in host_us[False]]}); 256 MiB send by CUDA "
          f"events, on {mean[True][1]:.4f} ms, off {mean[False][1]:.4f} ms; "
          f"its replay's device time on {replay[True]:.4f} ms, off "
          f"{replay[False]:.4f} ms, path A {a_replay_ms:.4f} ms", flush=True)
    del sessions, sess
    gc.collect()
    torch.cuda.empty_cache()

    # 2. a mid-traffic failure of (0, 1), its restore and readmission
    sess = CommSession(CommConfig(telemetry=True))
    pre = sess.describe(0, 1, big.numel() * 4, max_paths=3)
    rows = []
    for i in range(10):
        if i == 3:
            sess.topology.fail_link(0, 1)
        if i == 6:
            sess.topology.restore_link(0, 1)
            probes = 0
            while sess.planner.quarantined and probes < 10:
                sess.probe_links()
                probes += 1
            check(not sess.planner.quarantined, "path I: (0, 1) was not "
                  "readmitted")
            digest = sess.describe(0, 1, big.numel() * 4,
                                   max_paths=3)["graph"]["digest"]
            check(digest == pre["graph"]["digest"], "path I: the "
                  "post-readmit digest is not the pre-fault one")
        cache0 = sess.stats()["cache"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = sess.send(big, 0, 1, max_paths=3)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        check(torch.equal(out, big), f"path I: send {i} not bitwise")
        cache1 = sess.stats()["cache"]
        # the plan of the graph just launched: compiled_for re-plans the
        # request and finds its graph in the cache (no new capture)
        compiled, plan = sess.compiled_for(0, 1, big.numel(), max_paths=3)
        check(sess.stats()["cache"]["misses"] == cache1["misses"],
              f"path I: send {i}'s plan is not the one just launched")
        links = plan.directional_links()
        failed = 3 <= i < 6
        check(not (failed and (0, 1) in links), f"path I: send {i} "
              f"routed over the failed (0, 1)")
        level = sess.stats()["health"]["ladder_level"]
        check(level == (1 if failed else 0), f"path I: send {i} at "
              f"ladder level {level}")
        st = sess.telemetry.samples()[-1].stages
        rows.append((i, wall, (st.plan_ns + st.lower_ns + st.schedule_ns)
                     / 1e6, st.compile_ns / 1e6,
                     cache1["misses"] - cache0["misses"], cache1["size"],
                     held_mib(sess)))
        if i == 5:
            fault_replay_ms = cuda_time_ms(compiled.program.replay, 20)
            fault_paths = [pa.route.via for pa in plan.paths]
        if i == 6:
            check(cache1["misses"] == cache0["misses"]
                  and cache1["hits"] == cache0["hits"] + 1,
                  "path I: the readmitted send was not a plan-cache hit")
    print(f"path I ({smi}): 256 MiB sends 0->1, 3 paths, (0, 1) failed "
          f"before send 3 and restored before send 6 (readmitted after "
          f"{probes} probe sweeps, the pre-fault digest back as a "
          f"plan-cache hit), all bitwise; per send (i, host ms synced, "
          f"plan+lower+schedule ms, capture ms, new captures, cached "
          f"graphs, graph MiB): "
          + ", ".join(f"({i}, {w:.3f}, {p:.3f}, {c:.3f}, {n}, {k}, "
                      f"{m:.0f})" for i, w, p, c, n, k, m in rows)
          + f"; under the fault the paths via {fault_paths} replay in "
          f"{fault_replay_ms:.4f} ms of device time", flush=True)
    del sess, out, compiled, plan
    gc.collect()
    torch.cuda.empty_cache()

    # 3. an injected schedule of drops, a droop and a flap
    spec = "drop@2x2:0-2;degrade@6x4:0-3*0.25;flap@12~2x2:0-1"
    sess = CommSession(CommConfig(faults=spec, telemetry=True))
    m16 = big[: 4 * MiB]                                     # 16 MiB f32
    slept_ns = []
    sleep = time.sleep

    def timed_sleep(seconds):         # the engine's backoff sleeps
        s0 = time.perf_counter_ns()
        sleep(seconds)
        slept_ns.append(time.perf_counter_ns() - s0)

    time.sleep = timed_sleep
    t0 = time.perf_counter()
    try:
        for i in range(20):
            check(torch.equal(sess.send(m16, 0, 1, max_paths=3), m16),
                  f"path I: injected-schedule send {i} not bitwise")
        torch.cuda.synchronize()
    finally:
        time.sleep = sleep
    total_ms = (time.perf_counter() - t0) * 1e3
    h = sess.stats()["health"]
    got = {k: h[k] for k in ("retries", "replans", "faults_seen")}
    check(got == {"retries": 1, "replans": 1, "faults_seen": 7},
          f"path I: the injected schedule gave {got}, not the CPU's "
          f"retries 1, replans 1, faults_seen 7")
    samples = sess.telemetry.samples()
    setup_ms = sum(x.stages.plan_ns + x.stages.lower_ns
                   + x.stages.schedule_ns for x in samples) / 1e6
    capture_ms = sum(x.stages.compile_ns for x in samples) / 1e6
    kinds = [e["kind"] for e in sess.drain_health_events()]
    print(f"path I ({smi}): {spec!r}, 20 sends of 16 MiB, all bitwise: "
          f"{got}, {sess.stats()['dispatches']} dispatches (probes "
          f"included), {sess.stats()['cache']['misses']} captures, graph "
          f"MiB {held_mib(sess):.0f}; {total_ms:.3f} ms in all, of it "
          f"backoff {sum(slept_ns) / 1e6:.3f} ms, plan+lower+"
          f"schedule {setup_ms:.3f} ms, capture {capture_ms:.3f} ms; "
          f"events {kinds}", flush=True)
    del sess, samples
    gc.collect()
    torch.cuda.empty_cache()

    # 4. the host relay: every device link into 1 failed
    sess = CommSession(CommConfig())
    for src in (0, 2, 3):
        sess.topology.fail_link(src, 1)
    out = sess.send(big, 0, 1, max_paths=3)
    check(torch.equal(out, big), "path I: host relay not bitwise")
    check(sess.stats()["health"]["ladder_level"] == 3,
          "path I: the relay did not leave ladder level 3")
    relays = [e for e in sess.drain_health_events()
              if e["kind"] == "host_relay"]
    check(len(relays) == 1, f"path I: {len(relays)} host_relay events")
    relay_ms = host_time_ms(lambda: sess.send(big, 0, 1, max_paths=3), 5,
                            warmup=1)
    pinned = torch.empty(big.shape, dtype=big.dtype, pin_memory=True)
    back = torch.empty_like(big)

    def round_trip():
        pinned.copy_(big, non_blocking=True)
        back.copy_(pinned, non_blocking=True)

    trip_ms = host_time_ms(round_trip, 5, warmup=1)
    check(torch.equal(back, big), "path I: pinned round trip not bitwise")
    nbytes = big.numel() * 4
    print(f"path I ({smi}): host relay of 256 MiB 0->1 (ladder level 3, "
          f"one host_relay event, bitwise): {relay_ms:.3f} ms synced, "
          f"{nbytes / relay_ms / 1e6:.2f} GB/s of message; a pinned copy_ "
          f"to the host and back alone {trip_ms:.3f} ms, "
          f"{nbytes / trip_ms / 1e6:.2f} GB/s", flush=True)
    del sess, out, pinned, back
    gc.collect()
    torch.cuda.empty_cache()

    # 5. path F's captured decode step through a failure of (0, 2)
    sess = CommSession(CommConfig())
    n = sess.num_devices
    heads, kv_len, hd = 32, 2048, 128
    kv_chunk = 2 * 8 * kv_len * hd
    step = make_captured_decode_step(
        sess, batch=1, heads=heads, kv_len=kv_len, head_dim=hd,
        kv_chunk=kv_chunk, src=0, dst=2, dtype=torch.bfloat16,
        schedule="overlap")
    q, k, v = (torch.randn((n, 1, heads, kv_len, hd), generator=g,
                           device=dev).to(torch.bfloat16) for _ in range(3))
    kv = torch.randn((n, kv_chunk), generator=g, device=dev).to(
        torch.bfloat16)
    q4, k4, v4 = (t.view(n, heads, kv_len, hd) for t in (q, k, v))
    want = fk.flash_attention_plain(q4, k4, v4)
    want_kv = kv.clone()
    want_kv[2] = kv[0]
    step_ms = []
    for phase in ("healthy", "failed", "restored"):
        if phase == "failed":
            sess.topology.fail_link(0, 2)
        if phase == "restored":
            sess.topology.restore_link(0, 2)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        attn, new_kv = step(q, k, v, kv)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        err, ok = bf16_err(attn.view(n, heads, kv_len, hd), want)
        errs["flash_attention"] = max(errs["flash_attention"], err)
        check(ok, f"path I: decode step ({phase}) attention max abs err "
              f"{err}, beyond {BF16_ATOL} + {BF16_RTOL} * |want|")
        check(torch.equal(new_kv, want_kv), f"path I: decode step "
              f"({phase}) KV chunk not bitwise")
        if phase == "failed":
            for plan in step.resolve().plans:
                check((0, 2) not in plan.directional_links(),
                      "path I: the decode step routed over the failed "
                      "(0, 2)")
    print(f"path I ({smi}): path F's captured decode step through a "
          f"failure of (0, 2): attention within {BF16_ATOL} + {BF16_RTOL} "
          f"* |want| and the KV chunk bitwise in each call; first call "
          f"healthy / after the failure / after the restore "
          f"{step_ms[0]:.3f} / {step_ms[1]:.3f} / {step_ms[2]:.3f} ms "
          f"synced (each a new resolve; the first two capture)", flush=True)
    del sess, step, q, k, v, q4, k4, v4, kv, want, want_kv, attn, new_kv
    gc.collect()
    torch.cuda.empty_cache()

    # 6. serving SmolLM-360M at full width: a KV migration under a fault
    cfg = get_config("smollm_360m")
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.head_dim_, cfg.dtype)
          == (32, 960, 15, 5, 64, "bfloat16"),
          f"smollm_360m is not the full-width config: {cfg}")
    params = tfm.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(3),
        device=dev)
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    sess = CommSession(CommConfig())
    engine = ServeEngine(cfg, params, max_len=512, kv_chunks=4, comm=sess)
    toks = torch.randint(0, cfg.vocab_size, (2, 256),
                         generator=torch.Generator().manual_seed(4))
    _, cache = engine.prefill(toks)
    sess.topology.fail_link(0, 1)
    moved = engine.migrate_kv(cache, 0, 1)
    check(sorted(moved) == sorted(cache)
          and all(torch.equal(moved[key], cache[key]) for key in cache),
          "path I: the KV migration under a failed link not bitwise")
    kinds = [e["kind"] for e in engine.health_events]
    check("ladder" in kinds, f"path I: no ladder event in the serving "
          f"engine's health events {kinds}")
    cbytes = sum(t.numel() * t.element_size() for t in cache.values())
    print(f"path I ({smi}): smollm_360m full width ({wbytes / 1e9:.2f} GB "
          f"of seeded random weights), 2 prompts of 256 tokens, KV cache "
          f"of {cbytes / MiB:.1f} MiB migrated 0->1 with (0, 1) failed: "
          f"bitwise; engine.health_events {kinds}", flush=True)
    del sess, engine, params, cache, moved
    gc.collect()
    torch.cuda.empty_cache()

    # 7. the droop monitor on path H's healthy traffic under a fitted
    #    profile: its send sweep, its exchange and path F's decode step
    sess = CommSession(CommConfig(telemetry=True, health=True))
    mon = sess.monitor
    ratios = {"send": [], "exchange": []}
    unjudged, culprits = [], []

    def observe(sample):
        before = mon.quarantines
        r = mon.observe(sample)
        if sample.compute and sess.topology.calibration is not None:
            # not judged (the model prices no compute): reported only
            unjudged.append(sample.measured_s / modeled_sample_time_s(
                sample, sess.topology, sess.topology.calibration))
        if r is None:
            return
        kind = "exchange" if len(sample.routes) > 1 else "send"
        ratios[kind].append(r)
        if mon.quarantines > before:
            culprits.append((kind, round(r, 3),
                             sorted(map(list, mon.quarantined))))

    sess.telemetry.on_record = observe
    sweep = [(nbytes, paths)
             for nbytes in (64 * 1024, MiB, 16 * MiB, 64 * MiB, 256 * MiB)
             for paths in (1, 2, 3)]
    quarter = [big[i * 4 * MiB:(i + 1) * 4 * MiB] for i in range(4)]
    items = [(quarter[i], i, (i + 1) % 4) for i in range(4)]
    n = sess.num_devices
    step = make_captured_decode_step(
        sess, batch=1, heads=heads, kv_len=kv_len, head_dim=hd,
        kv_chunk=kv_chunk, src=0, dst=2, dtype=torch.bfloat16,
        schedule="overlap")
    q, k, v = (torch.randn((n, 1, heads, kv_len, hd), generator=g,
                           device=dev).to(torch.bfloat16) for _ in range(3))
    kv = torch.randn((n, kv_chunk), generator=g, device=dev).to(
        torch.bfloat16)
    want_kv = kv.clone()
    want_kv[2] = kv[0]

    def traffic(reps: int) -> None:
        for nbytes, paths in sweep:
            m = big[: nbytes // 4]
            for _ in range(reps):
                check(torch.equal(sess.send(m, 0, 1, max_paths=paths), m),
                      f"path I: {nbytes} B droop-sweep send not bitwise")
        for _ in range(reps):
            got = sess.exchange(items)
            check(all(torch.equal(a, b) for a, b in zip(got, quarter)),
                  "path I: droop-sweep exchange not bitwise")
        for _ in range(3):
            check(torch.equal(step(q, k, v, kv)[1], want_kv),
                  "path I: droop-sweep decode step KV chunk not bitwise")

    traffic(10)
    check(not any(ratios.values()), "path I: the monitor judged samples "
          "before a calibration")
    sess.calibrate(min_samples=3, warmup=2)
    traffic(10)
    torch.cuda.synchronize()
    read_path("I")
    check(ratios["send"], "path I: the monitor judged no send under the "
          "profile")
    check(unjudged, "path I: no decode step ran under the profile")
    print(f"path I ({smi}): droop monitor on path H's healthy traffic "
          f"under the fitted profile (threshold {mon.droop_threshold}, "
          f"{mon.droop_samples} in a row), measured/modeled by kind: "
          + "; ".join(
              f"{kind} x{len(rs)} median {quantile(rs, 0.5):.4f}, p90 "
              f"{quantile(rs, 0.9):.4f}, max {max(rs):.4f}, "
              f"{sum(r > mon.droop_threshold for r in rs)} above"
              for kind, rs in ratios.items() if rs)
          + f"; decode step (not judged: the model prices no compute) "
          f"x{len(unjudged)} median {quantile(unjudged, 0.5):.4f}"
          + f"; quarantines {mon.quarantines} (kind, ratio, quarantined "
          f"set): {culprits}; readmissions {mon.readmissions}; ladder "
          f"{sess.stats()['health']}", flush=True)
    for name in ("multipath_dma", "flash_attention"):
        check(per_path["I"].get(name, 0) > 0,
              f"path I did not launch {name}")
    del sess, step, big, msg64, m16, quarter, items, q, k, v, kv, want_kv
    gc.collect()
    torch.cuda.empty_cache()


#: Path J's attention shape: SmolLM-360M's 15/5 heads of 64 at 512
#: positions; batch 8 for the single-device step, 2 for one of 4 DP
#: shards.
TRAIN_HEADS, TRAIN_SEQ, TRAIN_BATCH = (15, 5, 64), 512, 8
#: The backward kernel against its plain version: the largest error of
#: dQ, dK and dV relative to the largest |want| (float32 sums in another
#: order; bfloat16 outputs rounded once).
BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


#: Path J (a)'s small bfloat16 cases of the backward kernel: every head
#: dim (each swizzle of the tensor-core kernels), a ragged length (the
#: sequence-end mask), GQA 4/2; causal, windowed and unmasked.
BWD_SWEEP = [(1, 4, 2, 200, d) for d in (16, 32, 64, 128)]
BWD_MASKS = [(True, None), (True, 64), (False, None), (False, 48)]


def bwd_case_err(fk, q, k, v, do, causal, window, path: str = "J") -> dict:
    """The backward kernel against its plain version on one input, from
    the forward's ``o`` and ``lse``: each gradient's max abs error and
    max |want|."""
    o, lse = fk.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                     return_lse=True)
    lse_err = (lse - fk.attention_lse_ref(q, k, causal=causal,
                                          window=window)).abs().max().item()
    check(lse_err <= 1e-4, f"path {path}: flash_attention lse at "
          f"{tuple(q.shape)} {q.dtype} causal={causal} window={window}: "
          f"max abs err {lse_err}")
    got = fk.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal,
                                      window=window)
    want = fk.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                        window=window)
    return {name: ((g.float() - w.float()).abs().max().item(),
                   w.float().abs().max().item())
            for name, g, w in zip(("dq", "dk", "dv"), got, want)}


def kernel_name(name: str) -> str:
    """A profiler kernel name without its return type, anonymous namespace
    and argument list: ``dkdv_wgmma_kernel<64>``."""
    name = name.replace("(anonymous namespace)::", "")
    return name.removeprefix("void ").split("(")[0]


def sdpa_backend(names) -> str:
    """Which SDPA backend ran, from the CUDA kernel names it launched."""
    low = " ".join(names).lower()
    if "cudnn" in low:
        return "cuDNN"
    if "flash" in low:
        return "flash"
    if "fmha" in low or "efficient" in low or "cutlass" in low:
        return "memory-efficient"
    return "math"


def bwd_case_times(randn, b, hq, hkv, s, d, causal: bool, dt, smi: str,
                   path: str) -> dict:
    """The backward kernel's time at one shape, causal or unmasked, in
    ``dt``: back-to-back calls, and one call captured in a CUDA graph and
    replayed, beside its bound, the plain version's time, its three
    kernels' device times (profiler), the forward with ``lse``, SDPA's
    backward alone and its forward + backward, and the backend SDPA
    picked (the yardstick only; the port never calls it)."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as fk

    q = (randn(b, hq, s, d) * 0.5).to(dt)
    k = (randn(b, hkv, s, d) * 0.5).to(dt)
    v = randn(b, hkv, s, d, dtype=dt)
    do = randn(b, hq, s, d, dtype=dt)
    o, lse = fk.flash_attention_cuda(q, k, v, causal=causal,
                                     return_lse=True)

    def bwd():
        return fk.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                           causal=causal)

    ms = cuda_time_ms(bwd, 20)
    _, _, _, rows = profile_device_ms(
        lambda: [bwd() for _ in range(10)], top=None)
    split = {kernel_name(name): ms_ / n for name, ms_, n in rows}
    # back-to-back calls can wait on the wrapper's host work; one call
    # captured and replayed shows the device's time for the three
    # launches alone
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        bwd()
    graph_ms = cuda_time_ms(graph.replay, 20)
    del graph
    fwd_ms = cuda_time_ms(lambda: fk.flash_attention_cuda(
        q, k, v, causal=causal, return_lse=True), 20)
    plain_ms = cuda_time_ms(lambda: fk.flash_attention_bwd_plain(
        q, k, v, o, lse, do, causal=causal), 5, warmup=1)
    qq = q.detach().requires_grad_()
    kk = k.repeat_interleave(hq // hkv, dim=1).detach().requires_grad_()
    vv = v.repeat_interleave(hq // hkv, dim=1).detach().requires_grad_()

    def sdpa():
        return F.scaled_dot_product_attention(qq, kk, vv, is_causal=causal,
                                              scale=d ** -0.5)

    def sdpa_fwd_bwd():
        return torch.autograd.grad(sdpa(), (qq, kk, vv), do)

    out = sdpa()    # the forward, outside the timed backward
    lib_ms = cuda_time_ms(lambda: torch.autograd.grad(
        out, (qq, kk, vv), do, retain_graph=True), 20)
    lib_fb_ms = cuda_time_ms(sdpa_fwd_bwd, 20)
    _, _, _, lib_rows = profile_device_ms(lambda: torch.autograd.grad(
        out, (qq, kk, vv), do, retain_graph=True), top=None)
    backend = sdpa_backend(name for name, _, _ in lib_rows)
    lib_top = ", ".join(kernel_name(n)[:48] for n, _, _ in lib_rows[:3])
    # each input read once (q, k, v, o, dO, lse), each output written
    # once (dQ, dK, dV); 2.5 × the forward's FLOPs (half of 4·B·H·S²·D
    # under the causal mask)
    nbytes = ((4 * q.numel() + 4 * k.numel()) * q.element_size()
              + lse.numel() * 4)
    flops = 2.5 * (2 if causal else 4) * b * hq * s * s * d
    peak = BF16_FLOPS_PER_S if dt == torch.bfloat16 else F32_FLOPS_PER_S
    ops_ms = flops / peak * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound = max(ops_ms, bytes_ms)
    masked = "causal" if causal else "full"
    print(f"path {path} ({smi}): flash_attention_bwd ({b}, {hq}/{hkv}, {s}, "
          f"{d}) {str(dt)[6:]} {masked}: kernel {ms:.4f} ms (forward with "
          f"lse {fwd_ms:.4f} ms), bound {bound:.4f} ms ({flops:.4g} "
          f"FLOPs = 2.5 x the {masked} forward's at "
          f"{peak / 1e12:.0f} TFLOP/s = {ops_ms:.4f} ms; {nbytes} B at "
          f"3.35 TB/s = {bytes_ms:.4f} ms; {bound / ms:.1%} of bound), "
          f"plain {plain_ms:.4f} ms; one call captured and replayed "
          f"{graph_ms:.4f} ms ({bound / graph_ms:.1%} of bound); its "
          f"kernels under the profiler (device ms a call): "
          + ", ".join(f"{k_} {v_:.4f}" for k_, v_ in split.items())
          + f"; SDPA on repeat_interleave'd k/v ({backend} backend; "
          f"kernels {lib_top}): "
          f"backward alone {lib_ms:.4f} ms, forward + backward "
          f"{lib_fb_ms:.4f} ms", flush=True)
    return {"shape": [b, hq, hkv, s, d], "causal": causal, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": lib_ms, "library_fwd_bwd_ms": lib_fb_ms,
            "library_backend": backend, "kernels_ms": split,
            "graph_ms": graph_ms, "fwd_ms": fwd_ms}


def train_bwd_checks(randn, errs, path: str, b, hq, hkv, s, d,
                     causal: bool) -> None:
    """The backward kernel against its plain version at a training shape
    and at one DP shard's (a quarter of the batch), float32 within 1e-4
    and bfloat16 within 2e-2 of each gradient's largest |want|, the
    forward's ``lse`` against the plain log-sum-exp."""
    from repro_torch.kernels.flash_attention import kernel as fk

    rel = {}
    for bb in (b, b // 4):
        for dt in (torch.float32, torch.bfloat16):
            q = (randn(bb, hq, s, d) * 0.5).to(dt)
            k = (randn(bb, hkv, s, d) * 0.5).to(dt)
            v = randn(bb, hkv, s, d, dtype=dt)
            do = randn(bb, hq, s, d, dtype=dt)
            for name, (err, top) in bwd_case_err(fk, q, k, v, do, causal,
                                                 None, path).items():
                errs["flash_attention_bwd"] = max(
                    errs["flash_attention_bwd"], err)
                rel[(bb, str(dt)[6:], name)] = err / top
                check(err <= BWD_REL[dt] * top,
                      f"path {path}: flash_attention_bwd {name} at ({bb}, "
                      f"{hq}/{hkv}, {s}, {d}) {dt} causal={causal}: max "
                      f"abs err {err} > {BWD_REL[dt]} * {top}")
            del q, k, v, do
    masked = "causal" if causal else "full mask"
    print(f"path {path}: flash_attention_bwd vs plain at ({b}, {hq}/{hkv}, "
          f"{s}, {d}) ({masked}; max abs err / max |want|): "
          + ", ".join(f"B={bb} {dt} {n} {r:.3g}"
                      for (bb, dt, n), r in rel.items())
          + " (bounds float32 1e-4, bfloat16 2e-2)", flush=True)


def flash_bwd_checks(randn, errs, smi) -> dict:
    """Path J (a): the ``flash_attention`` backward kernel against its
    plain version at the training shapes (single step and one DP shard),
    causal, float32 and bfloat16, and in bfloat16 at every head dim,
    causal, windowed and unmasked (``BWD_SWEEP`` x ``BWD_MASKS``), with the
    forward's ``lse`` against the plain log-sum-exp; then at the single
    step's shape its time (back-to-back calls, and one call captured in a
    CUDA graph and replayed) beside its bound, the plain version's, each
    of its three kernels' device time (profiler), SDPA's backward alone and
    its forward + backward, and the backend SDPA picked (the yardstick
    only; the port never calls it). Returns the kernel row."""
    from repro_torch.kernels.flash_attention import kernel as fk

    hq, hkv, d = TRAIN_HEADS
    s = TRAIN_SEQ
    train_bwd_checks(randn, errs, "J", TRAIN_BATCH, hq, hkv, s, d, True)
    worst = 0.0
    for shape in BWD_SWEEP:
        bb, h1, h2, sl, dd = shape
        for causal, window in BWD_MASKS:
            q = (randn(bb, h1, sl, dd) * 0.5).to(torch.bfloat16)
            k = (randn(bb, h2, sl, dd) * 0.5).to(torch.bfloat16)
            v = randn(bb, h2, sl, dd, dtype=torch.bfloat16)
            do = randn(bb, h1, sl, dd, dtype=torch.bfloat16)
            for name, (err, top) in bwd_case_err(fk, q, k, v, do, causal,
                                                 window).items():
                errs["flash_attention_bwd"] = max(
                    errs["flash_attention_bwd"], err)
                worst = max(worst, err / top)
                check(err <= BWD_REL[torch.bfloat16] * top,
                      f"path J: flash_attention_bwd {name} at {shape} "
                      f"bfloat16 causal={causal} window={window}: max abs "
                      f"err {err} > 2e-2 * {top}")
    print(f"path J: flash_attention_bwd bfloat16 vs plain at "
          f"{len(BWD_SWEEP) * len(BWD_MASKS)} cases, head dims 16/32/64/128 "
          f"at (1, 4/2, 200, D), (causal, window) in {BWD_MASKS}: largest "
          f"max abs err / max |want| {worst:.3g} (bound 2e-2)", flush=True)

    b = TRAIN_BATCH
    times = {dt: bwd_case_times(randn, b, hq, hkv, s, d, True, dt, smi, "J")
             for dt in (torch.bfloat16, torch.float32)}
    row = times[torch.bfloat16]
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention_bwd.cu",
            "replaces": "src/repro/models/layers.py:143",
            "replaces_note": "no Pallas site: the reference differentiates "
                             "its blockwise_attention",
            **{key: row[key] for key in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms",
                                         "library_fwd_bwd_ms",
                                         "kernels_ms", "graph_ms")},
            "library_call": "torch.autograd.grad of "
                            "F.scaled_dot_product_attention(q, "
                            "k.repeat_interleave(3, 1), "
                            "v.repeat_interleave(3, 1), is_causal=True), "
                            "the backward alone (forward run outside the "
                            f"timed region), {row['library_backend']} "
                            "backend",
            "shape": [b, hq, hkv, s, d], "dtype": "bfloat16",
            "float32": times[torch.float32]}


def attention_grads_check(dev, name: str = "smollm_360m",
                          path: str = "J") -> None:
    """Path J (a) (SmolLM-360M) and path N (a) (HuBERT-XLarge):
    ``loss.backward()`` through the port's forward on the card gives
    ``wq``, ``wk`` and ``wv`` the gradients of the same forward with the
    plain attention (full width, 2 layers, float32, 2 x 256 tokens or
    frames): within 1e-4 of the largest gradient."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import layers
    from repro_torch.models import transformer as tfm

    cfg = dataclasses.replace(get_config(name), num_layers=2,
                              dtype="float32")
    params = tfm.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(11),
        device=dev)
    gen = torch.Generator().manual_seed(12)
    toks = torch.randint(0, cfg.vocab_size, (2, 257), generator=gen)
    batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev),
             "mask": torch.ones((2, 256), device=dev)}
    if cfg.frontend == "audio":
        batch["features"] = torch.randn((2, 256, cfg.frontend_dim),
                                        generator=gen).to(dev)
        del batch["tokens"]

    def grads():
        for t in _leaves(params):
            t.grad = None
            t.requires_grad_(True)
        tfm.loss_fn(params, cfg, batch).backward()
        return [params["layers"]["attn"][w].grad.clone()
                for w in ("wq", "wk", "wv")]

    def plain(q, k, v, *, causal, window, scale):
        return fk.flash_attention_plain(q, k, v, causal=causal,
                                        window=window, scale=scale)

    bwd0 = fk.LAUNCHES_BWD
    got = grads()
    check(fk.LAUNCHES_BWD - bwd0 == cfg.num_layers,
          f"path {path}: loss.backward() launched flash_attention_bwd "
          f"{fk.LAUNCHES_BWD - bwd0} times, not once per layer")
    kernel_attn = layers.flash_attention
    layers.flash_attention = plain
    try:
        want = grads()
    finally:
        layers.flash_attention = kernel_attn
    errs = []
    for leaf, g, w in zip(("wq", "wk", "wv"), got, want):
        top = w.abs().max().item()
        err = (g - w).abs().max().item()
        errs.append(f"{leaf} {err / top:.3g}")
        check(top > 0 and err <= 1e-4 * top, f"path {path}: loss.backward() "
              f"{leaf} grad differs from the plain path's: max abs err "
              f"{err}, max |want| {top}")
    print(f"path {path}: loss.backward() through the forward ({cfg.name} "
          f"full width, head dim {cfg.head_dim_}, "
          f"{'causal' if cfg.causal else 'non-causal'}, 2 layers, float32) "
          f"gives wq/wk/wv the plain path's gradients (max abs err / max "
          f"|g|: {', '.join(errs)}; bound 1e-4)", flush=True)
    del params


def rwkv_training_runs(dev) -> None:
    """Path J (a): RWKV-6 training on the card runs: the scan's wrapper
    with grad goes through the backward kernel (one launch), and the
    builders take the config."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.rwkv6_scan import kernel as sk
    from repro_torch.kernels.rwkv6_scan.ops import chunked_scan
    from repro_torch.optim import OptimConfig
    from repro_torch.training import TrainStepConfig, make_train_step

    r = torch.randn(1, 64, 1, 16, device=dev, requires_grad=True)
    w = torch.rand(1, 64, 1, 16, device=dev) * 0.5 + 0.5
    u = torch.zeros(1, 1, 16, device=dev)
    before = sk.LAUNCHES_BWD
    (grad,) = torch.autograd.grad(chunked_scan(r, r, r, w, u, chunk=64)
                                  .sum(), r)
    check(sk.LAUNCHES_BWD == before + 1 and bool(grad.isfinite().all()),
          "path J: RWKV-6 training through chunked_scan on the card did not "
          "run the backward kernel once")
    make_train_step(get_config("rwkv6_1_6b"), TrainStepConfig(),
                    OptimConfig(), device=dev)
    print("path J: RWKV-6 training on the card runs (the scan's wrapper "
          "through the backward kernel; the builders take the config)",
          flush=True)


#: AdamW's first step moves a parameter by lr · g / (|g| + eps) (the
#: bias corrections cancel): near g = 0 the slope is 1/eps = 1e8, so a
#: gradient of ~1e-8 that two summation orders give 1e-8 apart (the DP
#: step's shard means against the whole batch's) moves it by up to 2·lr.
#: Where the single-device step's |g| is below 100·eps the parameters are
#: held to 2·lr instead of the reference's tolerance, and counted.
EPS_CONDITIONED = 1e-6


def state_close(got, want, what: str, grads=None, lr: float = 0.0,
                path: str = "J") -> tuple[float, int]:
    """Hold a train state's parameters to another's at the reference's
    tolerance (atol 2e-5, rtol 1e-4), except, given the single-device
    step's ``grads``, the elements whose |g| < ``EPS_CONDITIONED``, which
    are held within ``2·lr``. Returns the max abs difference and the
    number of elements held to ``2·lr`` that the reference's tolerance
    would not take."""
    worst, loose = 0.0, 0
    gl = (_leaves(grads) if grads is not None
          else [None] * len(_leaves(want["params"])))
    for a, b, g in zip(_leaves(got["params"]),
                       _leaves(want["params"]), gl):
        diff = (a.float() - b.float()).abs()
        worst = max(worst, diff.max().item())
        ok = diff <= 2e-5 + 1e-4 * b.float().abs()
        if g is not None:
            cond = g.float().abs() < EPS_CONDITIONED
            loose += int((cond & ~ok).sum())
            ok |= cond & (diff <= 2 * lr)
        check(bool(ok.all()), f"path {path}: {what}: params beyond atol "
              f"2e-5 / rtol 1e-4 (max abs diff {diff.max().item()})")
    return worst, loose


def arena_bytes(cap) -> int:
    """The bytes a captured step's arena takes: every buffer of the
    recording, stacked over the devices, at 256-byte alignment."""
    import math

    from repro_torch.comm.capture import as_dtype

    total = 0
    for spec in cap.buffers:
        nbytes = (cap.num_devices * math.prod(spec.shape)
                  * as_dtype(spec.dtype).itemsize)
        total += -(-nbytes // 256) * 256
    return total


def train_timed(path: str, label: str, step_fn, state, batches: list,
                sess=None, profile: bool = False):
    """Steps of ``step_fn`` over ``batches``, the first a warm-up and the
    rest timed (host clock around each synced step): prints the step ms,
    tokens/s, the losses (each must be finite), the peak GiB, the
    dispatches and every kernel's launches a step, and with ``profile``
    the wall and device time, op count and idle share of one more step
    under the profiler. Returns the last state and the mean step ms."""
    import math

    from repro_torch.kernels._graph import launch_counts

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, m = step_fn(state, batches[0])
    warm = float(m["loss"])
    c0 = launch_counts()
    d0 = sess.stats()["dispatches"] if sess is not None else 0
    losses, times = [], []
    for bt in batches[1:]:
        t0 = time.perf_counter()
        state, m = step_fn(state, bt)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    counts = {k: (v - c0[k]) / len(times)
              for k, v in launch_counts().items() if v != c0[k]}
    disp = ((sess.stats()["dispatches"] - d0) / len(times)
            if sess is not None else 0)
    peak = torch.cuda.max_memory_allocated() / 2**30
    check(all(math.isfinite(x) for x in [warm] + losses),
          f"path {path}: {label}: a loss is not finite: {[warm] + losses}")
    ms = sum(times) / len(times) * 1e3
    tokens = batches[0]["labels"].numel()
    unit = "frames" if "features" in batches[0] else "tokens"
    print(f"path {path}: {label}: {ms:.2f} ms a step (steps "
          f"{', '.join(f'{t * 1e3:.2f}' for t in times)} ms), "
          f"{tokens / (ms / 1e3):.0f} {unit}/s, losses "
          f"{warm!r} (warm-up), {', '.join(repr(x) for x in losses)}; "
          f"peak {peak:.2f} GiB; {disp:g} dispatches a step; launches a "
          f"step {counts}", flush=True)
    if profile:
        wall, dev_ms, n_ops, rows = profile_device_ms(
            lambda: step_fn(state, batches[0]), top=8)
        print(f"path {path}: {label}: one step under the profiler: wall "
              f"{wall:.2f} ms, device {dev_ms:.2f} ms in {n_ops} ops "
              f"(idle {1 - dev_ms / wall:.1%}); top: {top_ops(rows)}",
              flush=True)
    return state, ms


def steps_agree(path: str, cfg32, ts, opt, dev, smi: str,
                seed: int) -> None:
    """Path J's (b) and path N's (b), float32 (TF32 off): one
    ``make_dp_train_step`` on the default 4-device session against one
    ``make_train_step`` (loss rtol 1e-5, params atol 2e-5 / rtol 1e-4,
    elements whose |g| < ``EPS_CONDITIONED`` within 2·lr) and one
    ``make_captured_dp_train_step`` against it (one dispatch, the same
    tolerances), on a batch of ``TRAIN_BATCH`` x ``TRAIN_SEQ``."""
    from repro_torch.comm import CommSession
    from repro_torch.data import DataConfig, SyntheticDataset, batch_to
    from repro_torch.training import (init_state,
                                      make_captured_dp_train_step,
                                      make_dp_train_step, make_train_step)
    from repro_torch.training.train_step import _make_grad_fn

    ds32 = SyntheticDataset(cfg32, DataConfig(seq_len=TRAIN_SEQ,
                                              global_batch=TRAIN_BATCH))
    batch = batch_to(ds32.batch_at(0), dev)
    state = init_state(cfg32, opt, generator=torch.Generator(
        device=dev).manual_seed(seed), device=dev)
    _, grads = _make_grad_fn(cfg32, ts)(state["params"], batch)
    single, m1 = make_train_step(cfg32, ts, opt, device=dev)(state, batch)
    sess = CommSession(device=dev)
    dp, m2 = make_dp_train_step(cfg32, ts, opt, sess)(state, batch)
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    check(abs(l2 - l1) <= 1e-5 * abs(l1), f"path {path}: DP loss {l2} vs "
          f"single-device {l1} beyond rtol 1e-5")
    lr1 = float(m1["lr"])
    dp_err, loose = state_close(dp, single, "DP step vs single-device step",
                                grads, lr1, path=path)
    n_cond = sum(int((g.abs() < EPS_CONDITIONED).sum())
                 for g in _leaves(grads))
    del single, grads
    cap_sess = CommSession(device=dev)
    captured = make_captured_dp_train_step(cfg32, ts, opt, cap_sess, state,
                                           batch)
    d0 = cap_sess.stats()["dispatches"]
    cap, m3 = captured(state, batch)
    check(cap_sess.stats()["dispatches"] - d0 == 1,
          f"path {path}: the captured step is not one dispatch a call")
    l3 = float(m3["loss"])
    check(abs(l3 - l2) <= 1e-5 * abs(l2), f"path {path}: captured loss "
          f"{l3} vs DP {l2} beyond rtol 1e-5")
    cap_err, _ = state_close(cap, dp, "captured step vs DP step", path=path)
    unit = "frames" if "features" in batch else "tokens"
    print(f"path {path} ({smi}): full width, 2 layers, float32, TF32 off, "
          f"one step of {TRAIN_BATCH} x {TRAIN_SEQ} {unit}: loss single "
          f"{l1!r}, DP {l2!r}, captured "
          f"{l3!r}; params max abs diff DP-single {dp_err}, captured-DP "
          f"{cap_err} (atol 2e-5 / rtol 1e-4; DP-single: {loose} of the "
          f"{n_cond} elements with |g| < {EPS_CONDITIONED} beyond it, "
          f"within 2 lr = {2 * lr1}); captured step 1 dispatch",
          flush=True)
    del state, dp, cap, captured, cap_sess, sess, m1, m2, m3, batch
    gc.collect()
    torch.cuda.empty_cache()


def training_path(dev, errs, per_path, read_path, smi: str) -> dict:
    """Main path J (phase 15): training SmolLM-360M at full width.

    (a), not counted: the backward kernel against its plain version and
    its times, ``loss.backward()`` through the dense forward against the
    plain attention's gradients, and RWKV-6 training running. Then, with
    every launch counter set to 0 just before and read just after: (b) at
    full width, 2 layers, float32, TF32 off, one step each,
    ``make_dp_train_step`` on the default 4-device session against
    ``make_train_step`` and ``make_captured_dp_train_step`` against it
    (loss rtol 1e-5, params atol 2e-5 / rtol 1e-4), the captured step one
    dispatch; (c) 1 warm-up + 5 timed steps of batch 8 x 512 tokens,
    bfloat16: ``make_train_step`` and ``make_dp_train_step`` at full
    depth (32 layers) and the captured step at 2 layers, its arena
    reckoned first; (d) a checkpoint save and restore of the 2-layer
    state, bitwise. Returns the backward kernel's report row."""
    import dataclasses
    import tempfile

    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.comm import CommSession
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticDataset, batch_to
    from repro_torch.kernels._graph import reset_launch_counts
    from repro_torch.models.transformer import param_shapes
    from repro_torch.optim import OptimConfig
    from repro_torch.training import (TrainStepConfig, init_state,
                                      make_captured_dp_train_step,
                                      make_dp_train_step, make_train_step)

    dev_gen = torch.Generator(device=dev).manual_seed(21)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=dev_gen, device=dev).to(dtype)

    # -- 15. main path J: training SmolLM-360M -------------------------------
    row = flash_bwd_checks(randn, errs, smi)
    attention_grads_check(dev)
    rwkv_training_runs(dev)
    gc.collect()
    torch.cuda.empty_cache()

    full = get_config("smollm_360m")
    check((full.num_layers, full.d_model, full.num_heads, full.num_kv_heads,
           full.head_dim_, full.d_ff, full.vocab_size, full.dtype,
           full.remat) == (32, 960, 15, 5, 64, 2560, 49152, "bfloat16",
                           "full"),
          f"smollm_360m is not the full-width config: {full}")
    ts = TrainStepConfig()
    opt = OptimConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    reset_launch_counts()

    # (b) correctness at full width, 2 layers, float32
    steps_agree("J", dataclasses.replace(full, num_layers=2,
                                         dtype="float32"), ts, opt, dev,
                smi, seed=22)

    # (c) timed runs, bfloat16, 1 warm-up + 5 steps of 8 x 512 tokens
    def timed(label, cfg, step_fn, state, sess=None, profile=False):
        ds = SyntheticDataset(cfg, DataConfig(seq_len=TRAIN_SEQ,
                                              global_batch=TRAIN_BATCH))
        batches = [batch_to(ds.batch_at(i), dev) for i in range(6)]
        return train_timed("J", label, step_fn, state, batches, sess,
                           profile)

    n_params = sum(t.numel() for t in _leaves(param_shapes(full)))
    state = init_state(full, opt, generator=torch.Generator(
        device=dev).manual_seed(23), device=dev)
    state, _ = timed(f"make_train_step, full width, {full.num_layers} "
                     f"layers ({n_params} parameters), bfloat16", full,
                     make_train_step(full, ts, opt, device=dev), state,
                     profile=True)
    sess = CommSession(device=dev)
    state, _ = timed(f"make_dp_train_step on {sess.num_devices} devices, "
                     f"full width, {full.num_layers} layers, bfloat16", full,
                     make_dp_train_step(full, ts, opt, sess), state, sess,
                     profile=True)
    del state, sess
    gc.collect()
    torch.cuda.empty_cache()

    cfg2 = dataclasses.replace(full, num_layers=2)
    state = init_state(cfg2, opt, generator=torch.Generator(
        device=dev).manual_seed(24), device=dev)
    p2 = sum(t.numel() for t in _leaves(state["params"]))
    sess = CommSession(device=dev)
    ds2 = SyntheticDataset(cfg2, DataConfig(seq_len=TRAIN_SEQ,
                                            global_batch=TRAIN_BATCH))
    captured = make_captured_dp_train_step(cfg2, ts, opt, sess, state,
                                           batch_to(ds2.batch_at(0), dev))
    arena = arena_bytes(captured.capture.capture)
    print(f"path J: the captured step's arena at full width, 2 layers "
          f"({p2} parameters), bfloat16 params, float32 moments, "
          f"{sess.num_devices} devices: {arena} B = {arena / 1e9:.2f} GB, "
          f"{arena / p2:.1f} B a parameter "
          f"({len(captured.capture.capture.buffers)} buffers)", flush=True)
    state, _ = timed(f"make_captured_dp_train_step on {sess.num_devices} "
                     f"devices, full width, 2 layers, bfloat16", cfg2,
                     captured, state, sess, profile=True)

    # (d) checkpoint round trip of the 2-layer state
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build"),
                                     prefix="ckpt-") as tmp:
        t0 = time.perf_counter()
        path = save_checkpoint(tmp, int(state["opt"]["step"]), state)
        back, step, _ = restore_checkpoint(path, state, device=dev)
        dt = time.perf_counter() - t0
        same = all(
            a.dtype == b.dtype and torch.equal(
                a.view(torch.int16) if a.dtype == torch.bfloat16 else a,
                b.view(torch.int16) if b.dtype == torch.bfloat16 else b)
            for a, b in zip(_leaves(state), _leaves(back)))
        check(same and step == int(state["opt"]["step"]),
              "path J: checkpoint save -> restore not bitwise")
    nbytes = sum(t.numel() * t.element_size()
                 for t in _leaves(state))
    print(f"path J: checkpoint of the 2-layer state ({nbytes / 1e9:.2f} GB, "
          f"step {step}) saved and restored bitwise in {dt:.2f} s",
          flush=True)
    del state, back, captured, sess
    read_path("J")
    for name in ("flash_attention", "flash_attention_bwd", "multipath_dma"):
        check(per_path["J"].get(name, 0) > 0,
              f"path J did not launch {name}")
    gc.collect()
    torch.cuda.empty_cache()
    return row


#: Path K's bound on a prefill of all but the last 8 prompt positions and
#: 8 decode steps against the full prefill's logits, the largest logit
#: difference: 3× the sound reading (0.180 on an H100, bfloat16 computed
#: in two orders through 32 layers of attention and Mamba, eager and
#: captured alike), as path G's; a zeroed SSM state reads 1.84, zeroed
#: conv inputs 4.98.
HYMBA_DECODE_ATOL = 0.54
#: Path L's bound, the same check: 3× the sound reading (0.797 on an
#: H100, bfloat16 computed in two orders through 8 MoE layers, whose
#: top-2 choice jumps where two router probabilities tie); zeroed keys
#: and values read 6.73.
MIXTRAL_DECODE_ATOL = 2.4
#: Path L's depth: 8 of Mixtral-8x22B's 56 layers (5.01 GB each in
#: bfloat16; 56 would be 281 GB).
MIXTRAL_LAYERS = 8


def tail_decode_diffs(cfg, engine, toks, logits, tail, faults: dict
                      ) -> tuple[float, float, dict]:
    """The last ``tail`` positions of ``toks`` decoded one at a time after
    a prefill of the others, against the full prefill's ``logits`` there:
    the largest absolute logit difference with eager steps
    (``make_serve_step`` after the engine's prefill program), with the
    engine's captured prefill and decode programs, and with each planted
    fault of ``faults`` (name → a function that alters the eager run's
    cache after the prefill), each of which the bound must catch."""
    from repro_torch.serving import make_serve_step

    b, plen = toks.shape
    start = plen - tail
    serve_step = make_serve_step(cfg, engine.spec)

    def eager(plant=None):
        _, cache = engine.prefill(toks[:, :start])
        if plant is not None:
            plant(cache)
        worst = 0.0
        for t in range(start, plen):
            lg, cache = serve_step(engine.params, cache, toks[:, t:t + 1], t)
            worst = max(worst, (lg.float() - logits[:, t].float()).abs()
                        .max().item())
        return worst

    def captured():
        prefill = engine.prefill_program(b, start)
        prefill.tokens.copy_(toks[:, :start])
        prefill()
        decode = engine.decode_program(b)
        worst = 0.0
        for t in range(start, plen):
            decode.tokens.copy_(toks[:, t:t + 1])
            decode.cur_len.fill_(t)
            worst = max(worst, (decode().float() - logits[:, t].float())
                        .abs().max().item())
        return worst

    return eager(), captured(), {k: eager(f) for k, f in faults.items()}


def tail_checks(cfg, engine, toks, logits, limit: float, faults: dict,
                path: str) -> None:
    """:func:`tail_decode_diffs` over the last 8 positions, held to
    ``limit``: eager and captured within it, every planted fault past
    it."""
    tail = 8
    worst, worst_captured, planted = tail_decode_diffs(
        cfg, engine, toks, logits, tail, faults)
    start = toks.shape[1] - tail
    top = logits[:, start:].float().abs().max().item()
    print(f"path {path}: prefill of {start} tokens + {tail} decode steps vs "
          f"the full prefill: logits max abs diff {worst} eager steps, "
          f"{worst_captured} captured prefill and steps (largest logit "
          f"{top:.3f}, limit {limit}); planted faults: "
          + ", ".join(f"{k} {d}" for k, d in planted.items()), flush=True)
    check(worst <= limit, f"path {path}: prefill + {tail} decode steps "
          f"differ from the full prefill by {worst} (limit {limit})")
    check(worst_captured <= limit, f"path {path}: the captured prefill + "
          f"{tail} captured decode steps differ from the full prefill by "
          f"{worst_captured} (limit {limit})")
    check(all(d > limit for d in planted.values()),
          f"path {path}: a planted fault passes the decode check: {planted}")


def layer0_attention_check(cfg, params, toks, errs, path: str) -> None:
    """The kernel at layer 0's real prefill q/k/v (the model's window)
    against its plain version, within ``BF16_ATOL + BF16_RTOL * |want|``."""
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models import layers
    from repro_torch.models import transformer as tfm

    lp = tfm.layer_params(params, 0)
    x = layers.rms_norm(params["embed"][toks], lp["ln1"])
    q, k, v = tfm.attention_qkv(x, lp["attn"], cfg,
                                torch.arange(toks.shape[1],
                                             device=toks.device))
    window = tfm.layer_windows(cfg)[0]
    window = window if window >= 0 else None
    scale = cfg.head_dim_ ** -0.5
    err, ok = bf16_err(
        fk.flash_attention_cuda(q, k, v, window=window, scale=scale),
        fk.flash_attention_plain(q, k, v, window=window, scale=scale))
    errs["flash_attention"] = max(errs["flash_attention"], err)
    check(ok, f"path {path}: flash_attention at layer 0's prefill q/k/v: max"
          f" abs err {err}, beyond {BF16_ATOL} + {BF16_RTOL} * |want|")
    print(f"path {path}: layer 0 prefill q/k/v {tuple(q.shape)}/"
          f"{tuple(k.shape)} window {window}: kernel vs plain max abs err "
          f"{err} (limit {BF16_ATOL} + {BF16_RTOL} * |want|)", flush=True)


def serve_requests(cfg, engine, prompts, new, path: str, per_path,
                   read_path, kernel: str = "flash_attention",
                   migrate_to: int | None = None):
    """Main path ``path``'s counted run: every launch counter set to 0,
    ``generate`` of ``prompts`` (``new`` tokens each, greedy) twice, a
    prefill of the left-padded prompts, with ``migrate_to`` its cache
    moved there twice, then the counters read. Checks the tokens (in
    range, the same twice), one launch of the mixer's ``kernel`` per
    layer per prefill and the migrations (bitwise, one dispatch each, the
    second a fast-path hit). Returns (toks, outs, logits, cache, generate
    seconds (first, second))."""
    from repro_torch.kernels._graph import reset_launch_counts
    from repro_torch.serving import Request

    dev = engine.device
    plen = max(len(p) for p in prompts)
    toks = torch.tensor([[0] * (plen - len(p)) + p for p in prompts],
                        device=dev)

    def requests():
        return [Request(list(p), new) for p in prompts]

    sess = engine.comm
    reset_launch_counts()
    t0 = time.perf_counter()
    first = engine.generate(requests())
    torch.cuda.synchronize()
    gen1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    second = engine.generate(requests())
    torch.cuda.synchronize()
    gen2_s = time.perf_counter() - t0
    logits, cache = engine.prefill(toks)
    if migrate_to is not None:
        moved = engine.migrate_kv(cache, 0, migrate_to)
        s1 = sess.stats()
        moved2 = engine.migrate_kv(cache, 0, migrate_to)
        s2 = sess.stats()
    torch.cuda.synchronize()
    read_path(path)
    outs = [r.out for r in first]
    check(all(len(o) == new for o in outs)
          and all(0 <= t < cfg.vocab_size for o in outs for t in o),
          f"path {path}: a wrong count or an out-of-range token")
    check([r.out for r in second] == outs, f"path {path}: a second "
          f"generate gave other tokens")
    launched = per_path[path].get(kernel, 0)
    check(launched == 3 * cfg.num_layers, f"path {path} launched {kernel} "
          f"{launched} times, not once per layer per prefill "
          f"({3 * cfg.num_layers})")
    sizes = ", ".join(f"{k} {tuple(t.shape)} {str(t.dtype)[6:]} "
                      f"{t.numel() * t.element_size() / 1e6:.2f} MB"
                      for k, t in cache.items())
    moved_note = ""
    if migrate_to is not None:
        check(per_path[path].get("multipath_dma", 0) > 0,
              f"path {path} did not launch multipath_dma")
        check(all(moved[k].dtype == cache[k].dtype
                  and torch.equal(moved[k], cache[k])
                  and torch.equal(moved2[k], cache[k]) for k in cache),
              f"path {path}: migrate_kv 0->{migrate_to} is not bitwise "
              f"equal to the cache")
        check(s1["dispatches"] == 1 and s2["dispatches"] == 2,
              f"path {path} migrations took {s1['dispatches']}, "
              f"{s2['dispatches']} dispatches, not one each")
        check(s2["fastpath"]["hits"] == s1["fastpath"]["hits"] + 1,
              f"path {path}: the second migration was not one fast-path "
              f"hit")
        moved_note = (f"; migrate_kv of the cache 0->{migrate_to} bitwise, "
                      f"one dispatch, second one fast-path hit")
    print(f"path {path}: served {len(prompts)} requests (prompts "
          f"{[len(p) for p in prompts]}, {new} new tokens each, greedy): "
          f"tokens in range, a second generate gives the same tokens; "
          f"first outputs {[o[:4] for o in outs]}; cache {sizes}"
          f"{moved_note}", flush=True)
    return toks, outs, logits, cache, (gen1_s, gen2_s)


def init_model(cfg, dev, path: str):
    """Seeded random weights of ``cfg`` on the card, their count and
    bytes printed beside ``param_count``."""
    from repro_torch.models import transformer as tfm

    t0 = time.perf_counter()
    params = tfm.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    torch.cuda.synchronize()
    leaves = _leaves(params)
    count = sum(t.numel() for t in leaves)
    wbytes = sum(t.numel() * t.element_size() for t in leaves)
    layer = sum(t.numel() * t.element_size()
                for t in _leaves(params["layers"])) / cfg.num_layers
    if cfg.attention_free:
        mixer = (f"{cfg.d_model // cfg.rwkv_head_dim} RWKV-6 heads of "
                 f"{cfg.rwkv_head_dim}")
    else:
        mixer = (f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
                 f"{cfg.head_dim_}, {cfg.attention} attention"
                 + (f" window {cfg.window}" if cfg.window else ""))
    print(f"path {path}: {cfg.name} {cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {mixer}, d_ff {cfg.d_ff} ({cfg.mlp}), vocab "
          f"{cfg.vocab_size}, {cfg.dtype}: {count} "
          f"parameters drawn (param_count() {cfg.param_count()}), "
          f"{wbytes / 1e9:.2f} GB of seeded random weights "
          f"({layer / 1e9:.3f} GB a layer) in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    return params


def hymba_path(dev, errs, per_path, read_path, at_out: dict) -> None:
    """Main path K (phase 16): serving Hymba-1.5B at full width and depth
    (attention beside Mamba in every layer), read with the counters set to
    0 just before it; then the kernel at layer 0's real prefill, the Mamba
    mixer's and its scan's share of the prefill, prefill-then-decode
    against the full prefill, and the times. Puts
    :func:`served_readings` in ``at_out``."""
    from repro_torch.comm import CommSession
    from repro_torch.configs import get_config
    from repro_torch.models import layers, ssm
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import ServeEngine

    # -- 16. main path K: serving Hymba-1.5B --------------------------------
    cfg = get_config("hymba_1_5b")
    check((cfg.family, cfg.num_layers, cfg.d_model, cfg.num_heads,
           cfg.num_kv_heads, cfg.head_dim_, cfg.d_ff, cfg.vocab_size,
           cfg.attention, cfg.window, cfg.ssm_state, cfg.dtype)
          == ("hybrid", 32, 1600, 25, 5, 64, 5504, 32001, "swa", 1024, 16,
              "bfloat16"), f"hymba_1_5b is not the full config: {cfg}")
    params = init_model(cfg, dev, "K")
    tok_gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (n,),
                             generator=tok_gen).tolist()
               for n in (1536, 1024, 768, 512)]
    new = 32
    engine = ServeEngine(cfg, params, max_len=1536 + new,
                         comm=CommSession())
    check(engine.spec == tfm.CacheSpec("ring", 1024),
          f"path K: cache {engine.spec}, not a ring of the window")
    toks, outs, logits, cache, gen_s = serve_requests(
        cfg, engine, prompts, new, "K", per_path, read_path, migrate_to=2)
    b, plen = toks.shape
    check(sorted(cache) == ["conv", "k", "ssm", "v"]
          and cache["ssm"].dtype == torch.float32
          and tuple(cache["ssm"].shape) == (32, b, 1600, 16)
          and tuple(cache["conv"].shape) == (32, b, ssm.CONV_K - 1, 1600)
          and all(cache[k].dtype == torch.bfloat16
                  for k in ("k", "v", "conv")),
          f"path K cache {[(k, t.dtype) for k, t in cache.items()]}")
    program_checks(cfg, engine, toks, outs, "K")
    at_out.update(served_readings(engine, prompts, new, toks, outs, logits))
    layer0_attention_check(cfg, params, toks, errs, "K")

    # the Mamba mixer and its scan at layer 0's real prefill input
    prefill = engine.prefill_program(b, plen)
    prefill.tokens.copy_(toks)
    replay_ms = cuda_time_ms(prefill, 3, warmup=1)
    lp = tfm.layer_params(params, 0)
    x = layers.rms_norm(params["embed"][toks], lp["ln1"])
    mamba_ms = cuda_time_ms(lambda: ssm.mamba_apply(x, lp["ssm"]), 3,
                            warmup=1)
    shape = (b, plen, cfg.d_model, cfg.ssm_state)
    a = torch.rand(shape, device=dev) * 0.5 + 0.5
    drive = torch.randn(shape, device=dev)
    scan_ms = cuda_time_ms(lambda: ssm.associative_scan(a, drive), 3,
                           warmup=1)
    scan_bytes = 3 * a.numel() * a.element_size()
    del x, a, drive
    n = cfg.num_layers
    print(f"path K: prefill replay {replay_ms:.2f} ms; the Mamba mixer at "
          f"layer 0's input {mamba_ms:.3f} ms x {n} layers = "
          f"{n * mamba_ms / replay_ms:.1%} of it; its associative scan on "
          f"{shape} float32 {scan_ms:.3f} ms x {n} = "
          f"{n * scan_ms / replay_ms:.1%} (reads a and the drive and writes "
          f"h, {scan_bytes / 1e6:.0f} MB: {scan_bytes / HBM_BYTES_PER_S * 1e3:.3f}"
          f" ms at 3.35 TB/s)", flush=True)

    tail_checks(cfg, engine, toks, logits, HYMBA_DECODE_ATOL, {
        "zeroed SSM state": lambda c: c["ssm"].zero_(),
        "zeroed conv inputs": lambda c: c["conv"].zero_()}, "K")
    serving_times(cfg, engine, engine.comm, toks, logits, cache, new, gen_s,
                  "K", dst=2)


def mixtral_path(dev, errs, per_path, read_path) -> dict:
    """Main path L (phase 17): serving Mixtral-8x22B at full width over 8
    of its 56 layers (MoE, 8 experts top-2, dropless in prefill and
    decode), read with the counters set to 0 just before it; then the
    kernel at layer 0's real prefill, each expert's token count and the
    dropped pairs in one eager prefill and 8 decode steps, the expert
    products' share of the prefill, prefill-then-decode against the full
    prefill, and the times (returned, :func:`serving_times`'s, for path
    S)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import layers
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import ServeEngine, make_serve_step

    # -- 17. main path L: serving Mixtral-8x22B ------------------------------
    full = get_config("mixtral_8x22b")
    check((full.family, full.num_layers, full.d_model, full.num_heads,
           full.num_kv_heads, full.head_dim_, full.d_ff, full.vocab_size,
           full.num_experts, full.top_k, full.attention, full.window,
           full.dtype)
          == ("moe", 56, 6144, 48, 8, 128, 16384, 32768, 8, 2, "swa", 4096,
              "bfloat16"), f"mixtral_8x22b is not the full config: {full}")
    cfg = dataclasses.replace(full, num_layers=MIXTRAL_LAYERS)
    params = init_model(cfg, dev, "L")
    tok_gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (n,),
                             generator=tok_gen).tolist()
               for n in (512, 384, 256, 128)]
    new = 32
    engine = ServeEngine(cfg, params, max_len=1024, kv_chunks=4)
    toks, outs, logits, cache, gen_s = serve_requests(
        cfg, engine, prompts, new, "L", per_path, read_path)
    b, plen = toks.shape
    program_checks(cfg, engine, toks, outs, "L")
    layer0_attention_check(cfg, params, toks, errs, "L")

    # routing of one eager prefill and 8 eager decode steps
    e = cfg.num_experts
    routed: list[tuple[torch.Tensor, torch.Tensor]] = []
    real = moe_lib.moe_apply

    def counting(x, p, *, top_k, kind, capacity_factor=1.25,
                 dropless=False):
        r = moe_lib.route(x, p["router"], top_k=top_k,
                          capacity=moe_lib.capacity_of(
                              x.shape[0], e, top_k, capacity_factor,
                              dropless))
        routed.append((torch.zeros(e, device=x.device).index_add_(
            0, r.expert, r.keep.float()), (~r.keep).sum()))
        return real(x, p, top_k=top_k, kind=kind,
                    capacity_factor=capacity_factor, dropless=dropless)

    moe_lib.moe_apply = counting
    try:
        lg, pcache = tfm.prefill_forward(params, cfg, {"tokens": toks},
                                         engine.spec)
        step = make_serve_step(cfg, engine.spec)
        tok = lg[:, -1].argmax(-1)
        for i in range(8):
            lg, pcache = step(params, pcache, tok[:, None], plen + i)
            tok = lg.argmax(-1)
    finally:
        moe_lib.moe_apply = real
    del lg, pcache
    counts = [c.long().tolist() for c, _ in routed]
    dropped = [int(d) for _, d in routed]
    nl = cfg.num_layers
    check(len(counts) == 9 * nl, f"path L: {len(counts)} MoE calls, not "
          f"{9 * nl}")
    check(all(sum(c) == b * plen * cfg.top_k for c in counts[:nl])
          and all(sum(c) == b * cfg.top_k for c in counts[nl:]),
          "path L: routed pairs do not add up to tokens x top_k")
    check(not any(dropped), f"path L: dropless prefill or decode dropped "
          f"{sum(dropped)} pairs")
    print(f"path L: one eager prefill of {tuple(toks.shape)} tokens, each "
          f"expert's pairs per layer (dropless, capacity {b * plen}): "
          f"{counts[:nl]}; 8 decode steps, per expert over all layers and "
          f"steps: {[sum(c[i] for c in counts[nl:]) for i in range(e)]}; "
          f"dropped pairs: {sum(dropped)}", flush=True)

    # the expert products' share of the prefill
    prefill = engine.prefill_program(b, plen)
    prefill.tokens.copy_(toks)
    replay_ms = cuda_time_ms(prefill, 3, warmup=1)
    lp = tfm.layer_params(params, 0)
    x = layers.rms_norm(params["embed"][toks], lp["ln2"]).reshape(
        b * plen, cfg.d_model)
    moe_ms = cuda_time_ms(lambda: moe_lib.moe_apply(
        x, lp["moe"], top_k=cfg.top_k, kind=cfg.mlp, dropless=True), 3,
        warmup=1)
    buf = moe_lib.dispatch(x, moe_lib.route(x, lp["moe"]["router"],
                                             top_k=cfg.top_k,
                                             capacity=b * plen), e)
    experts_ms = cuda_time_ms(
        lambda: moe_lib.expert_ffn(buf, lp["moe"], cfg.mlp), 3, warmup=1)
    flops = 2 * 3 * e * b * plen * cfg.d_model * cfg.d_ff
    useful = flops * cfg.top_k / e
    del x, buf
    print(f"path L: prefill replay {replay_ms:.2f} ms; the MoE layer on "
          f"layer 0's normed embeddings {moe_ms:.2f} ms x {nl} layers = "
          f"{nl * moe_ms / replay_ms:.1%} of it; its expert products on "
          f"that layer's dropless ({e}, {b * plen}, {cfg.d_model}) buffer "
          f"(its {b * plen * cfg.top_k} pairs' rows filled, the rest 0) "
          f"{experts_ms:.2f} ms x {nl} = {nl * experts_ms / replay_ms:.1%} "
          f"({flops / experts_ms / 1e9:.0f} TFLOP/s: {flops} FLOPs a "
          f"layer, of which the routed pairs need {useful:.0f}; "
          f"{flops / BF16_FLOPS_PER_S * 1e3:.2f} ms at 989 TFLOP/s)",
          flush=True)

    def zero_positions(c):
        c["k"].zero_()
        c["v"].zero_()

    tail_checks(cfg, engine, toks, logits, MIXTRAL_DECODE_ATOL, {
        "zeroed keys and values": zero_positions}, "L")
    return serving_times(cfg, engine, None, toks, logits, cache, new, gen_s,
                         "L")


#: Path M's shape of the RWKV-6 scan's backward kernel: one step of
#: 8 x 512 tokens through RWKV-6 1.6B's 32 heads of 64, chunks of 64.
RWKV_BWD_SHAPE = (8, 512, 32, 64, 64)
#: Path M's small cases of the backward kernel, (B, S, H, dk, dv, chunk,
#: dState): a sequence padded to the chunk (w = 1, zeros), dk/dv 16/32,
#: a nonzero final-state gradient; chunks of 40 and 24, off the kernel's
#: 16-row mma tile, and a dk or dv of 8 (one 8-wide tile) beside 64.
RWKV_BWD_SMALL = [(2, 100, 3, 16, 32, 32, True), (1, 96, 2, 32, 16, 16, True),
                  (3, 40, 2, 8, 8, 8, False), (2, 100, 3, 64, 64, 40, True),
                  (1, 70, 2, 64, 8, 24, True), (2, 50, 2, 8, 64, 24, True)]
#: Path M's float32 case whose dw and du are held to ``RWKV_BWD_F32_REL``
#: of their largest |want|: float32 accuracy, which a product in one TF32
#: pass misses.
RWKV_BWD_F32_CASE = (2, 256, 4, 64, 64, 64, True)
RWKV_BWD_F32_REL = 1e-5
#: The backward kernel against its plain version: each gradient's largest
#: error relative to its largest |want| (float32 sums in another order;
#: bfloat16 gradients rounded once).
RWKV_BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
#: Path M's lowest decay: a chunk of 64 then spans the decay range path G
#: prints for a real prefill.
RWKV_BWD_LOW = 0.3
#: Path M's RWKV-6 correctness checks cut the vocabulary to this (the
#: captured DP step's arena takes ~400 B a float32 parameter at 4
#: devices, and the full vocabulary's embedding and head are 268 M
#: parameters); the width, heads and layers' shapes stay the config's.
RWKV_CHECK_VOCAB = 4096


#: Path M's attention shapes: each family's (batch, sequence) of its
#: timed steps; heads, head dim and windows are the config's.
FAMILY_ATTN = {"hymba_1_5b": (4, 1536), "mixtral_8x22b": (8, 512)}


def family_attention_bwd_checks(randn, errs) -> None:
    """Path M (a), not counted: the ``flash_attention`` backward kernel
    against its plain version in bfloat16 at each ``FAMILY_ATTN`` shape,
    causal, at every window the config's layers use, each of dQ, dK, dV
    within ``BWD_REL`` of its largest |want|."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.models.transformer import layer_windows

    t0 = time.perf_counter()
    out = []
    for cfg_name, (b, s) in FAMILY_ATTN.items():
        cfg = get_config(cfg_name)
        hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
        for window in sorted(set(layer_windows(cfg))):
            window = None if window < 0 else window
            q = (randn(b, hq, s, d) * 0.5).to(torch.bfloat16)
            k = (randn(b, hkv, s, d) * 0.5).to(torch.bfloat16)
            v = randn(b, hkv, s, d, dtype=torch.bfloat16)
            do = randn(b, hq, s, d, dtype=torch.bfloat16)
            rel = {}
            for name, (err, top) in bwd_case_err(fk, q, k, v, do, True,
                                                 window, "M").items():
                errs["flash_attention_bwd"] = max(
                    errs["flash_attention_bwd"], err)
                rel[name] = err / top
                check(err <= BWD_REL[torch.bfloat16] * top,
                      f"path M: flash_attention_bwd {name} at ({b}, "
                      f"{hq}/{hkv}, {s}, {d}) bfloat16 causal window "
                      f"{window}: max abs err {err} > 2e-2 * {top}")
            out.append(f"{cfg_name} ({b}, {hq}/{hkv}, {s}, {d}) window "
                       f"{window}: " + ", ".join(f"{n} {r:.3g}"
                                                 for n, r in rel.items()))
            del q, k, v, do
            gc.collect()
            torch.cuda.empty_cache()
    print(f"path M: flash_attention_bwd bfloat16 vs plain at the families' "
          f"training shapes, causal (max abs err / max |want|): "
          f"{'; '.join(out)} (bound 2e-2; "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)


def rwkv_bwd_inputs(randn, rand, b, s, h, dk, dv, chunk, dtype):
    """Backward inputs in the model's layout: ``rwkv_inputs`` with decays
    from [RWKV_BWD_LOW, 0.999), one bonus row per head, a float32 output
    gradient; a sequence padded as the model pads it (r, k, v and dO 0
    and w 1 past S)."""
    pad = (-s) % chunk
    r, k, v, _, u = rwkv_inputs(randn, rand, b, s + pad, h, dk, dv, dtype)
    w = rand(b, s + pad, h, dk) * (0.999 - RWKV_BWD_LOW) + RWKV_BWD_LOW
    do = randn(b, s + pad, h, dv)
    if pad:
        for t in (r, k, v, do):
            t[:, s:] = 0
        w[:, s:] = 1
    return r, k, v, w, u[:1].expand(b, -1, -1), do


def scan_bwd_errs(r, k, v, w, u, do, chunk: int):
    """``rwkv6_scan_bwd`` on the card against its plain version on the same
    inputs: each gradient's largest difference over its largest |value|,
    the largest difference, and the forward kernel's chunk-start states
    the backward read."""
    from repro_torch.kernels.rwkv6_scan import kernel as sk

    _, _, states = sk.rwkv6_scan_fwd_cuda(r, k, v, w, u, chunk=chunk,
                                          out_dtype=torch.float32)
    got = sk.rwkv6_scan_bwd_cuda(r, k, v, w, u, do, states=states,
                                 chunk=chunk)
    want = sk.rwkv6_scan_bwd_plain(r, k, v, w, u, do, chunk=chunk)
    rel, worst = {}, 0.0
    for gname, g, wv in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        err = (g.float() - wv.float()).abs().max().item()
        worst = max(worst, err)
        rel[gname] = err / wv.float().abs().max().item()
    return rel, worst, states


def scan_bwd_bound(b, s, h, dk, dv, chunk, states: int) -> dict:
    """The least time of the ``rwkv6_scan`` backward at ``(B, S, H, dk,
    dv)`` from ``states`` float32 chunk-start state elements, with the
    model's types (:func:`scan_bound`'s terms)."""
    # each input read once (r, k, v bfloat16; w, dO and the chunk-start
    # states float32; one u row per head), each output written once (dr,
    # dk, dv bfloat16, dw float32, du)
    nbytes = ((2 * dk + dv) * 2 * 2 + dk * 4 * 2 + dv * 4) * b * s * h \
        + states * 4 + h * dk * 4 + b * h * dk * 4

    # FMAs per position in chunks of c: the four dk x dv products (dO Sᵀ,
    # V Gᵀ, k̂ G and the reverse pass's q̃ᵀ dO), the strictly causal A,
    # dA k̃, dAᵀ q̃ ((c - 1) / 2 each over dk) and dA ((c - 1) / 2 over
    # dv), Aᵀ dO with its diagonal ((c + 1) / 2 over dv) and G's decay
    # once a chunk; at the c that needs least
    def per_position(c):
        return (4 * dk * dv + (c - 1) / 2 * (3 * dk + dv)
                + (c + 1) / 2 * dv + dk * dv / c)

    best = min(range(1, s + 1), key=per_position)
    flops = round(2 * b * h * s * per_position(best))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / F32_FLOPS_PER_S * 1e3
    return {"bytes": nbytes, "flops": flops, "best_chunk": best,
            "kernel_flops": round(2 * b * h * s * per_position(chunk)),
            "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def rwkv_bwd_checks(randn, rand, errs, smi) -> dict:
    """Path M (a), not counted: the ``rwkv6_scan`` backward kernel against
    its plain version at ``RWKV_BWD_SHAPE`` (bfloat16 r/k/v, float32
    w/u/dO, from the forward kernel's chunk-start states) and at
    ``RWKV_BWD_SMALL`` in float32 and bfloat16, each of dr, dk, dv, dw, du
    within ``RWKV_BWD_REL``, and ``RWKV_BWD_F32_CASE``'s float32 dw and du
    within ``RWKV_BWD_F32_REL``; then at the main shape its time back to back
    and as one call captured and replayed, each pass's device ms (from
    the profiler, by kernel name), its bound and the plain version's time.
    Returns the kernel row."""
    from repro_torch.kernels.rwkv6_scan import kernel as sk

    names = ("dr", "dk", "dv", "dw", "du")

    def case(b, s, h, dk, dv, chunk, dtype, with_dstate, tight=()):
        r, k, v, w, u, do = rwkv_bwd_inputs(randn, rand, b, s, h, dk, dv,
                                            chunk, dtype)
        dstate = randn(b, h, dk, dv) if with_dstate else None
        _, _, states = sk.rwkv6_scan_fwd_cuda(r, k, v, w, u, chunk=chunk,
                                              out_dtype=torch.float32)
        got = sk.rwkv6_scan_bwd_cuda(r, k, v, w, u, do, dstate,
                                     states=states, chunk=chunk)
        want = sk.rwkv6_scan_bwd_plain(r, k, v, w, u, do, dstate,
                                       chunk=chunk)
        rel = {}
        for name, g, wv in zip(names, got, want):
            err = (g.float() - wv.float()).abs().max().item()
            top = wv.float().abs().max().item()
            errs["rwkv6_scan_bwd"] = max(errs["rwkv6_scan_bwd"], err)
            rel[name] = err / top
            bound = RWKV_BWD_F32_REL if name in tight else RWKV_BWD_REL[
                g.dtype]
            check(g.dtype == wv.dtype and err <= bound * top,
                  f"path M: rwkv6_scan_bwd {name} at {(b, s, h, dk, dv)} "
                  f"chunk {chunk} {dtype} dState={with_dstate}: max abs err "
                  f"{err} > {bound} * {top}")
        return rel

    t0 = time.perf_counter()
    b, s, h, dk, dv = RWKV_BWD_SHAPE
    chunk = sk.MAX_CHUNK
    main_rel = case(b, s, h, dk, dv, chunk, torch.bfloat16, False)
    small = {}
    for shape in RWKV_BWD_SMALL:
        for dt in (torch.float32, torch.bfloat16):
            small[(shape, str(dt)[6:])] = max(case(*shape[:6], dt,
                                                   shape[6]).values())
    f32_rel = case(*RWKV_BWD_F32_CASE[:6], torch.float32,
                   RWKV_BWD_F32_CASE[6], tight=("dw", "du"))
    print(f"path M: rwkv6_scan_bwd vs plain (max abs err / max |want|) at "
          f"{RWKV_BWD_SHAPE} bf16 r/k/v, f32 w/u/dO, w in [{RWKV_BWD_LOW}, "
          f"0.999): " + ", ".join(f"{n} {r:.3g}" for n, r in main_rel.items())
          + "; small cases (B, S, H, dk, dv, chunk, dState): "
          + ", ".join(f"{k_[0]} {k_[1]} {r:.3g}" for k_, r in small.items())
          + f"; {RWKV_BWD_F32_CASE} float32: dw {f32_rel['dw']:.3g}, du "
          f"{f32_rel['du']:.3g} (bound {RWKV_BWD_F32_REL})"
          + f" (bounds float32 1e-4, bfloat16 2e-2; "
          f"{time.perf_counter() - t0:.1f} s)", flush=True)

    r, k, v, w, u, do = rwkv_bwd_inputs(randn, rand, b, s, h, dk, dv, chunk,
                                        torch.bfloat16)
    _, _, states = sk.rwkv6_scan_fwd_cuda(r, k, v, w, u, chunk=chunk,
                                          out_dtype=torch.float32)

    def bwd():
        return sk.rwkv6_scan_bwd_cuda(r, k, v, w, u, do, states=states,
                                      chunk=chunk)

    # each (batch, head, chunk) is its own block: a DP shard's gradients
    # are bitwise the whole batch's rows
    part = slice(2, 4)
    _, _, pstates = sk.rwkv6_scan_fwd_cuda(
        r[part], k[part], v[part], w[part], u[part], chunk=chunk,
        out_dtype=torch.float32)
    shard = sk.rwkv6_scan_bwd_cuda(r[part], k[part], v[part], w[part],
                                   u[part], do[part], states=pstates,
                                   chunk=chunk)
    check(all(torch.equal(a[part], b_) for a, b_ in zip(bwd(), shard)),
          "path M: rwkv6_scan_bwd on a batch shard differs from the whole "
          "batch's rows")
    ms = cuda_time_ms(bwd, 20)
    fwd_ms = cuda_time_ms(lambda: sk.rwkv6_scan_fwd_cuda(
        r, k, v, w, u, chunk=chunk, out_dtype=torch.float32), 20)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        bwd()
    graph_ms = cuda_time_ms(graph.replay, 20)
    del graph
    plain_ms = cuda_time_ms(lambda: sk.rwkv6_scan_bwd_plain(
        r, k, v, w, u, do, chunk=chunk, states=states), 3, warmup=1)
    # each pass's device ms from the profiler, by kernel name
    _, _, _, rows = profile_device_ms(lambda: [bwd() for _ in range(10)],
                                      top=None)
    passes = {name: ms_ / n for name, ms_, n in
              ((kernel_name(key), ms_, n) for key, ms_, n in rows)
              if name.startswith("rwkv6_bwd_")}
    check(len(passes) == 3, f"path M: the profiler did not see "
          f"rwkv6_scan_bwd's three kernels: {rows}")
    bnd = scan_bwd_bound(b, s, h, dk, dv, chunk, states.numel())
    nbytes, flops, kernel_flops, best = (bnd[k] for k in (
        "bytes", "flops", "kernel_flops", "best_chunk"))
    bytes_ms, ops_ms, bound = bnd["bytes_ms"], bnd["ops_ms"], bnd["bound_ms"]
    print(f"path M ({smi}): rwkv6_scan_bwd {RWKV_BWD_SHAPE} bf16 r/k/v, f32 "
          f"w/u/dO, chunk {chunk}: kernel {ms:.4f} ms back to back, one "
          f"call captured and replayed {graph_ms:.4f} ms (the forward "
          f"{fwd_ms:.4f} ms); its kernels' device ms: "
          + ", ".join(f"{n} {t:.4f} ms" for n, t in passes.items())
          + f"; bound {bound:.4f} ms ({flops} float32 FLOPs in chunks of "
          f"{best} at 67 TFLOP/s = {ops_ms:.4f} ms, the kernel's chunks of "
          f"{chunk} do {kernel_flops}; {nbytes} B at 3.35 TB/s = "
          f"{bytes_ms:.4f} ms; {bound / ms:.1%} of bound back to back, "
          f"{bound / graph_ms:.1%} replayed), plain {plain_ms:.4f} ms; a "
          f"shard of 2 of the 8 rows gives those rows' gradients bitwise",
          flush=True)
    return {"name": "rwkv6_scan_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/rwkv6_scan/csrc/"
                      "rwkv6_scan_bwd.cu",
            "replaces": "src/repro/models/ssm.py:158",
            "replaces_note": "no Pallas site: the reference differentiates "
                             "its rwkv6_apply chunk math",
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None, "graph_ms": graph_ms, "fwd_ms": fwd_ms,
            "passes_ms": passes, "shape": list(RWKV_BWD_SHAPE)}


#: Path M's RWKV-6 DP step against its single-device step: the largest
#: difference of the gradients each hands its AdamW update (the DP step's
#: after the multipath all-reduce), per leaf, as a share of the leaf's
#: largest |g|; float32, TF32 off, 2 layers at the family's timed batch.
#: Set from the readings recorded on an H100 80GB HBM3 at 700 W, the
#: whole batch's gradients against the mean of its 4 shards': RWKV-6 1.6B
#: 8.04e-3 (6.85e-3 with the plain scan: the per-head group norm's
#: conditioning, whose input mean square spans 5.57e-6 to 2.69e3, not the
#: kernel), Hymba-1.5B 9.44e-6. The control, a DP gradient that lost one
#: of the 4 shards, must exceed it. The RWKV-6 bound also holds the
#: scan kernel's ``loss.backward()`` against the plain scan's on the DP
#: check's own parameters and batch, where a difference within it is one
#: float32 summation order against another.
DP_GRAD_REL = {"ssm": 2e-2, "hybrid": 1e-4}
def scan_grads_check(dev, cfg, params, batch, bound: float,
                     what: str) -> None:
    """Path M: ``loss.backward()`` through ``cfg`` (RWKV-6, float32) on
    the card from ``params`` on ``batch`` gives every leaf the gradient of
    the same forward with the plain scan, within ``bound`` of the leaf's
    largest |g|; the backward kernel launched once a layer. Prints the
    time-mix projections' and the bonus's readings, the worst other
    leaf's and the group norm's input spread."""
    from repro_torch.kernels.rwkv6_scan import kernel as sk
    from repro_torch.models import transformer as tfm

    leaves = _leaves(params)
    names = ("w_r", "w_k", "w_v", "w_w", "w_g", "u")
    named = {id(params["layers"]["rwkv"][n]): n for n in names}

    def grads():
        for t in leaves:
            t.grad = None
            t.requires_grad_(True)
        tfm.loss_fn(params, cfg, batch).backward()
        out = [t.grad.clone() for t in leaves]
        for t in leaves:
            t.grad = None
            t.requires_grad_(False)
        return out

    var: list = []
    bwd0 = sk.LAUNCHES_BWD
    with rwkv_patched(spread=var):
        got = grads()
    spread = [(t.min().item(), t.median().item(), t.max().item())
              for t in var]
    del var
    check(sk.LAUNCHES_BWD - bwd0 == cfg.num_layers,
          f"path M: loss.backward() launched rwkv6_scan_bwd "
          f"{sk.LAUNCHES_BWD - bwd0} times, not once per layer")
    with rwkv_patched(plain_scan):
        want = grads()
    rels, other = [], (0.0, "")
    for i, (t, g, w) in enumerate(zip(leaves, got, want)):
        name = named.get(id(t))
        top = w.abs().max().item()
        err = (g - w).abs().max().item()
        if name:
            rels.append(f"{name} {err / top:.3g}")
        else:
            other = max(other, (err / max(top, 1e-30),
                                f"leaf {i} {tuple(w.shape)}"))
        check(err <= bound * top, f"path M: loss.backward() ({what}): leaf "
              f"{i} {name or tuple(w.shape)} grad differs from the plain "
              f"scan's: max abs err {err}, max |want| {top}, bound {bound}")
    print(f"path M: loss.backward() through {cfg.name} ({cfg.num_layers} "
          f"layers, float32, vocab {cfg.vocab_size}), {what}, "
          f"{tuple(batch['tokens'].shape)} tokens, against the plain scan's "
          f"gradients, max abs err / max |g|: {', '.join(rels)}, every other "
          f"leaf up to {other[0]:.3g} ({other[1]}) (bound {bound}); the "
          f"group norm's input, mean square per (position, head), min / "
          f"median / max per call: "
          + ", ".join(f"{x:.3g} / {y:.3g} / {z:.3g}" for x, y, z in spread),
          flush=True)


def _worst_rel(got, want) -> tuple[float, str]:
    """The largest of each leaf's max |got - want| over its max |want|,
    and which leaf."""
    top = (0.0, "")
    for i, (a, b) in enumerate(zip(got, want)):
        rel = ((a - b).abs().max().item()
               / max(b.abs().max().item(), 1e-30))
        top = max(top, (rel, f"leaf {i} {tuple(b.shape)}"))
    return top


def dp_against_single(path, cfg, ts, opt, dev, batch, seed,
                      captured=False) -> None:
    """Path M's correctness check for ``cfg`` (float32, TF32 off): one
    ``make_dp_train_step`` on the default 4-device session against one
    ``make_train_step``: the losses within rtol 1e-5, and the gradients
    each hands its AdamW update (the DP step's after the multipath
    all-reduce) within ``DP_GRAD_REL`` of each leaf's largest |g|, a
    bound the control (the mean of 3 of the 4 shards' gradients, one
    replica's lost) must exceed. RWKV-6 also prints, unchecked, the whole
    batch's gradients against its shards' mean with the plain scan. With
    ``captured``, ``make_captured_dp_train_step`` against the DP step (one
    dispatch, loss rtol 1e-5, params as path J holds them), its arena
    reckoned first."""
    from repro_torch.comm import CommSession
    from repro_torch.training import (init_state,
                                      make_captured_dp_train_step,
                                      make_dp_train_step, make_train_step)
    from repro_torch.training import train_step as tsm
    from repro_torch.training.train_step import _make_grad_fn, _shards

    state = init_state(cfg, opt, generator=torch.Generator(
        device=dev).manual_seed(seed), device=dev)
    seen = []
    update = tsm._update

    def recording(params, grads, opt_state, opt_):
        seen.append(grads)
        return update(params, grads, opt_state, opt_)

    tsm._update = recording
    try:
        single, m1 = make_train_step(cfg, ts, opt, device=dev)(state, batch)
        dp, m2 = make_dp_train_step(cfg, ts, opt, CommSession(device=dev))(
            state, batch)
    finally:
        tsm._update = update
    grads, dp_grads = seen
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    check(abs(l2 - l1) <= 1e-5 * abs(l1), f"path {path}: DP loss {l2} vs "
          f"single-device {l1} beyond rtol 1e-5")
    bound = DP_GRAD_REL[cfg.family]
    dp_rel = _worst_rel(_leaves(dp_grads), _leaves(grads))
    check(dp_rel[0] <= bound, f"path {path}: {cfg.name} DP step's gradients "
          f"differ from the single step's by {dp_rel[0]} of a leaf's max "
          f"|g| ({dp_rel[1]}), beyond {bound}")
    grad_fn = _make_grad_fn(cfg, ts)

    def shard_grads():
        return [_leaves(grad_fn(state["params"], sh)[1])
                for sh in _shards(batch, 4)]

    lost = [sum(per[:3]) / 3 for per in zip(*shard_grads())]
    ctl_rel = _worst_rel(lost, _leaves(grads))
    check(ctl_rel[0] > bound, f"path {path}: {cfg.name}: the control (one "
          f"of 4 shards' gradients lost) is within the bound {bound} "
          f"({ctl_rel[0]}): the check cannot tell")
    del lost, dp_grads
    plain_note = ""
    if cfg.family == "ssm":     # the same with the plain scan on the card
        with rwkv_patched(plain_scan):
            whole = _leaves(grad_fn(state["params"], batch)[1])
            mean = [sum(per) / len(per) for per in zip(*shard_grads())]
            plain_rel = _worst_rel(mean, whole)
        plain_note = (f"; with the plain scan the whole batch's against "
                      f"its 4 shards' mean: {plain_rel[0]:.3g} "
                      f"({plain_rel[1]})")
        del whole, mean
    lr1 = float(m1["lr"])
    note = ""
    if captured:
        sess = CommSession(device=dev)
        step = make_captured_dp_train_step(cfg, ts, opt, sess, state, batch)
        arena = arena_bytes(step.capture.capture)
        d0 = sess.stats()["dispatches"]
        cap, m3 = step(state, batch)
        check(sess.stats()["dispatches"] - d0 == 1,
              f"path {path}: the captured step is not one dispatch a call")
        l3 = float(m3["loss"])
        check(abs(l3 - l2) <= 1e-5 * abs(l2), f"path {path}: captured loss "
              f"{l3} vs DP {l2} beyond rtol 1e-5")
        cap_err, cap_loose = state_close(
            cap, dp, f"{cfg.name} captured step vs DP step", grads, lr1,
            path=path)
        note = (f"; captured loss {l3!r} (1 dispatch, arena "
                f"{arena / 1e9:.2f} GB), params max abs diff captured-DP "
                f"{cap_err} (atol 2e-5 / rtol 1e-4; {cap_loose} elements "
                f"with |g| < {EPS_CONDITIONED} beyond it, within 2 lr)")
        del step, cap, sess
    n = sum(t.numel() for t in _leaves(state["params"]))
    print(f"path {path}: {cfg.name} {cfg.num_layers} layers ({n} "
          f"parameters, vocab {cfg.vocab_size}), float32, TF32 off, one step "
          f"of {tuple(batch['tokens'].shape)} tokens: loss single {l1!r}, DP "
          f"{l2!r}; the gradients each step hands AdamW, DP (after the "
          f"multipath all-reduce) against single, max abs diff / leaf max "
          f"|g|: {dp_rel[0]:.3g} ({dp_rel[1]}; bound {bound}); the control, "
          f"one of 4 shards lost: {ctl_rel[0]:.3g} ({ctl_rel[1]}; must "
          f"exceed the bound){plain_note}{note}", flush=True)
    del state, dp, single, grads, seen
    gc.collect()
    torch.cuda.empty_cache()


def family_batches(cfg, dev, batch: int, seq: int, n: int) -> list:
    from repro_torch.data import DataConfig, SyntheticDataset, batch_to
    ds = SyntheticDataset(cfg, DataConfig(seq_len=seq, global_batch=batch))
    return [batch_to(ds.batch_at(i), dev) for i in range(n)]


def update_bytes(cfg, opt) -> tuple[int, int]:
    """The bytes a train step holds for ``cfg``'s state: parameters,
    gradients and moments, the update's new parameters and moments (made
    before the old are freed) and nine float32 temporaries of the largest
    leaf or of its slice (AdamW's per-leaf arithmetic, ``UPDATE_SLICE``
    elements at a time); and the first three alone."""
    import math

    from repro_torch.models.transformer import param_shapes
    from repro_torch.optim.adamw import UPDATE_SLICE

    shapes = _leaves(param_shapes(cfg))
    pbytes = sum(t.numel() * t.element_size() for t in shapes)
    msize = torch.empty((), dtype=getattr(torch, opt.moment_dtype)
                        ).element_size()
    n = sum(t.numel() for t in shapes)
    state = 2 * pbytes + 2 * n * msize
    largest = max(math.prod(t.shape) for t in shapes)
    if opt.moment_dtype != "int8":
        largest = min(largest, UPDATE_SLICE)
    return state + pbytes + 2 * n * msize + 9 * 4 * largest, state


def families_training_path(dev, errs, per_path, read_path, smi) -> dict:
    """Main path M (phase 18): training every family the port serves on
    the card. (a), not counted: the ``rwkv6_scan`` backward kernel's
    checks and times, and the ``flash_attention`` backward kernel against
    its plain version at Hymba's and Mixtral's training shapes. Then,
    counters set to 0 just before and read just after: RWKV-6 1.6B at
    full width and depth (``loss.backward()`` with the kernel against the
    plain scan's gradients, the DP step's gradients against the single
    step's and the captured DP step against the DP step, at 2 layers in
    float32; 1 warm-up and 3 timed steps of 8 x 512 tokens in
    bfloat16 at 24), Hymba-1.5B at full width and depth (the DP step's
    gradients against the single step's at 2 layers in float32; 3 timed
    steps of 4 x 1536 tokens at 32), Mixtral-8x22B at full width over the layers its
    reckoned bytes allow (2, or 1 when 2 would leave under 15 GB free;
    3 timed steps of 8 x 512 tokens, bfloat16 moments; each expert's
    routed pairs, the dropped pairs, and a nonzero weight gradient for
    exactly the experts that kept pairs), and each of the three port
    examples once with ``--device cuda``. Returns the backward kernel's
    row."""
    import dataclasses
    import importlib.util

    from repro_torch.configs import get_config
    from repro_torch.kernels._graph import reset_launch_counts
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import OptimConfig
    from repro_torch.training import (TrainStepConfig, init_state,
                                      make_train_step)
    from repro_torch.training.train_step import _make_grad_fn

    # -- 18. main path M: training every family ------------------------------
    t_path = time.perf_counter()
    dev_gen = torch.Generator(device=dev).manual_seed(41)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=dev_gen, device=dev).to(dtype)

    def rand(*shape):
        return torch.rand(*shape, generator=dev_gen, device=dev)

    row = rwkv_bwd_checks(randn, rand, errs, smi)
    family_attention_bwd_checks(randn, errs)
    gc.collect()
    torch.cuda.empty_cache()
    ts = TrainStepConfig()
    opt = OptimConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    reset_launch_counts()

    # RWKV-6 1.6B
    full = get_config("rwkv6_1_6b")
    check((full.num_layers, full.d_model, full.d_model // full.rwkv_head_dim,
           full.rwkv_head_dim, full.vocab_size, full.dtype, full.remat)
          == (24, 2048, 32, 64, 65536, "bfloat16", "full"),
          f"rwkv6_1_6b is not the full config: {full}")
    cfg32 = dataclasses.replace(full, num_layers=2, dtype="float32",
                                vocab_size=RWKV_CHECK_VOCAB)
    params = tfm.init_params(
        cfg32, generator=torch.Generator(device=dev).manual_seed(31),
        device=dev)
    for bsz, seq in ((2, 256), (8, 512)):
        toks = torch.randint(0, cfg32.vocab_size, (bsz, seq + 1),
                             generator=torch.Generator().manual_seed(32))
        scan_grads_check(dev, cfg32, params, {
            "tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)},
            1e-4, "random weights and tokens")
    batch = family_batches(cfg32, dev, 8, 512, 1)[0]
    params = init_state(cfg32, opt, generator=torch.Generator(
        device=dev).manual_seed(42), device=dev)["params"]
    scan_grads_check(dev, cfg32, params, batch, DP_GRAD_REL["ssm"],
                     "the DP check's weights and batch")
    del params
    dp_against_single("M", cfg32, ts, opt, dev, batch, 42, captured=True)
    state = init_state(full, opt, generator=torch.Generator(
        device=dev).manual_seed(43), device=dev)
    n = sum(t.numel() for t in _leaves(state["params"]))
    state, rwkv_ms = train_timed(
        "M", f"RWKV-6 1.6B make_train_step, full width, {full.num_layers} "
        f"layers ({n} parameters), bfloat16, float32 moments, 8 x 512 "
        f"tokens", make_train_step(full, ts, opt, device=dev), state,
        family_batches(full, dev, 8, 512, 4), profile=True)
    del state
    gc.collect()
    torch.cuda.empty_cache()

    # Hymba-1.5B
    full = get_config("hymba_1_5b")
    check((full.family, full.num_layers, full.d_model, full.window,
           full.dtype, full.remat) == ("hybrid", 32, 1600, 1024, "bfloat16",
                                       "full"),
          f"hymba_1_5b is not the full config: {full}")
    cfg32 = dataclasses.replace(full, num_layers=2, dtype="float32")
    dp_against_single("M", cfg32, ts, opt, dev,
                      family_batches(cfg32, dev, 4, 1536, 1)[0], 44)
    state = init_state(full, opt, generator=torch.Generator(
        device=dev).manual_seed(45), device=dev)
    n = sum(t.numel() for t in _leaves(state["params"]))
    state, hymba_ms = train_timed(
        "M", f"Hymba-1.5B make_train_step, full width, {full.num_layers} "
        f"layers ({n} parameters), bfloat16, float32 moments, 4 x 1536 "
        f"tokens (window {full.window})",
        make_train_step(full, ts, opt, device=dev), state,
        family_batches(full, dev, 4, 1536, 4), profile=True)
    del state
    gc.collect()
    torch.cuda.empty_cache()

    # Mixtral-8x22B
    full = get_config("mixtral_8x22b")
    check((full.num_layers, full.d_model, full.num_experts, full.top_k,
           full.d_ff, full.optimizer_dtype) == (56, 6144, 8, 2, 16384,
                                                "bfloat16"),
          f"mixtral_8x22b is not the full config: {full}")
    mopt = dataclasses.replace(opt, moment_dtype=full.optimizer_dtype)
    free = torch.cuda.mem_get_info()[0]
    need, held = update_bytes(dataclasses.replace(full, num_layers=2), mopt)
    layers = 2 if free - need >= 15e9 else 1
    cfg = dataclasses.replace(full, num_layers=layers)
    need1, held1 = update_bytes(cfg, mopt)
    print(f"path M: Mixtral-8x22B training bytes at 2 layers: params, grads "
          f"and bfloat16 moments {held / 1e9:.2f} GB, with the update's new "
          f"state and float32 temporaries {need / 1e9:.2f} GB, of "
          f"{free / 1e9:.2f} GB free: {layers} layer(s) ({held1 / 1e9:.2f} "
          f"GB, {need1 / 1e9:.2f} GB at the update)", flush=True)
    state = init_state(cfg, mopt, generator=torch.Generator(
        device=dev).manual_seed(46), device=dev)
    batches = family_batches(cfg, dev, 8, 512, 4)
    n = sum(t.numel() for t in _leaves(state["params"]))
    state, mixtral_ms = train_timed(
        "M", f"Mixtral-8x22B make_train_step, full width, {layers} of 56 "
        f"layers ({n} parameters), bfloat16, bfloat16 moments, 8 x 512 "
        f"tokens, capacity factor {cfg.capacity_factor}",
        make_train_step(cfg, ts, mopt, device=dev), state, batches,
        profile=True)
    e = cfg.num_experts
    routed = []
    real = moe_lib.moe_apply

    def counting(x, p, *, top_k, kind, capacity_factor=1.25,
                 dropless=False):
        r = moe_lib.route(x, p["router"], top_k=top_k,
                          capacity=moe_lib.capacity_of(
                              x.shape[0], e, top_k, capacity_factor,
                              dropless))
        routed.append((torch.zeros(e, device=x.device).index_add_(
            0, r.expert, r.keep.float()), (~r.keep).sum(), r.capacity))
        return real(x, p, top_k=top_k, kind=kind,
                    capacity_factor=capacity_factor, dropless=dropless)

    moe_lib.moe_apply = counting
    try:
        _, grads = _make_grad_fn(cfg, ts)(state["params"], batches[0])
    finally:
        moe_lib.moe_apply = real
    kept = [c.long().tolist() for c, _, _ in routed[:layers]]
    dropped = [int(d) for _, d, _ in routed[:layers]]
    moe_g = grads["layers"]["moe"]
    nonzero = [[bool(any(moe_g[w][li, j].abs().max() > 0
                         for w in ("w1", "w2", "w3"))) for j in range(e)]
               for li in range(layers)]
    check(all(nonzero[li][j] == (kept[li][j] > 0)
              for li in range(layers) for j in range(e)),
          f"path M: experts with a nonzero weight gradient {nonzero} are not "
          f"those that kept pairs {kept}")
    tokens = batches[0]["tokens"].numel()
    check(all(sum(kept[li]) + dropped[li] == tokens * cfg.top_k
              for li in range(layers)),
          "path M: kept and dropped pairs do not add up to tokens x top_k")
    print(f"path M: Mixtral-8x22B one step's routing ({tokens} tokens, "
          f"top-{cfg.top_k}, capacity {routed[0][2]} a expert): kept pairs "
          f"per expert per layer {kept}, dropped {dropped}; experts with a "
          f"nonzero w1/w2/w3 gradient are exactly those that kept pairs",
          flush=True)
    del state, grads, moe_g, routed, batches
    gc.collect()
    torch.cuda.empty_cache()

    # the port's examples, each once on the card
    for name, args in (("quickstart", []),
                       ("jacobi_multipath", ["--captured"]),
                       ("serve_batched", [])):
        t0 = time.perf_counter()
        spec = importlib.util.spec_from_file_location(
            f"example_{name}", os.path.join(HERE, "examples_torch",
                                            f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        print(f"path M: examples_torch/{name}.py "
              f"{' '.join(['--device', 'cuda', *args])}:", flush=True)
        mod.main(["--device", "cuda", *args])
        torch.cuda.synchronize()
        print(f"path M: {name} ran in {time.perf_counter() - t0:.2f} s",
              flush=True)
    read_path("M")
    for name in ("rwkv6_scan", "rwkv6_scan_bwd", "flash_attention",
                 "flash_attention_bwd", "multipath_dma", "jacobi",
                 "ring_allgather"):
        check(per_path["M"].get(name, 0) > 0,
              f"path M did not launch {name}")
    print(f"path M ({smi}): step ms RWKV-6 {rwkv_ms:.2f}, Hymba "
          f"{hymba_ms:.2f}, Mixtral ({layers} layers) {mixtral_ms:.2f}; "
          f"path M took {time.perf_counter() - t_path:.1f} s", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    return row


#: Path N's attention shape: one HuBERT-XLarge step of 8 x 512 frames,
#: 16/16 heads of 80, unmasked (an encoder).
HUBERT_ATTN = (8, 16, 16, 512, 80)


def hubert_attention_checks(randn, errs, smi) -> tuple[dict, dict]:
    """Path N (a): ``flash_attention`` and its backward at HuBERT-XLarge's
    training shape (``HUBERT_ATTN``, full mask) against their plain
    versions (forward bfloat16 within ``BF16_ATOL + BF16_RTOL * |want|``;
    backward float32 within 1e-4 and bfloat16 within 2e-2 of the largest
    |want|, also at one DP shard's batch of 2), then both timed beside
    their bounds, the plain versions and SDPA (the yardstick only).
    Returns the forward's and the backward's times."""
    b, hq, hkv, s, d = HUBERT_ATTN
    train_bwd_checks(randn, errs, "N", b, hq, hkv, s, d, False)
    fwd = flash_case_times(randn, errs, b, hq, hkv, s, d, plain_iters=3,
                           causal=False, smi=smi)
    bwd = bwd_case_times(randn, b, hq, hkv, s, d, False, torch.bfloat16,
                         smi, "N")
    return fwd, bwd


def hubert_training_path(dev, errs, per_path, read_path, smi) -> tuple:
    """Main path N (phase 19): training HuBERT-XLarge, the audio encoder,
    at full width and depth (48 layers, d_model 1280, 16/16 heads of 80,
    non-causal, d_ff 5120 GELU, vocab 504, bfloat16, ``remat="full"``,
    float32 moments) on batches of 8 x 512 seeded 512-dim frame features.

    (a), not counted: the attention kernels at its shape
    (:func:`hubert_attention_checks`) and ``loss.backward()`` through 2
    float32 layers against the plain attention's gradients. Then, with
    every launch counter set to 0 just before and read just after: (b) the
    DP and captured DP steps against the single step at 2 layers in
    float32 (:func:`steps_agree`); (c) 1 warm-up + 3 timed steps of
    ``make_train_step`` and of ``make_dp_train_step`` on 4 devices at 48
    layers, and of the captured DP step at 2 layers (its arena reckoned
    first), each with one step under the profiler; the forward kernel
    launched twice a layer a step (remat) and the backward once. Returns
    the forward's and the backward's times at the attention shape."""
    import dataclasses

    from repro_torch.comm import CommSession
    from repro_torch.configs import get_config
    from repro_torch.kernels._graph import launch_counts, reset_launch_counts
    from repro_torch.models.transformer import param_shapes
    from repro_torch.optim import OptimConfig
    from repro_torch.training import (TrainStepConfig, init_state,
                                      make_captured_dp_train_step,
                                      make_dp_train_step, make_train_step)

    dev_gen = torch.Generator(device=dev).manual_seed(26)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=dev_gen, device=dev).to(dtype)

    # -- 19. main path N: training HuBERT-XLarge -----------------------------
    t_path = time.perf_counter()
    full = get_config("hubert_xlarge")
    check((full.family, full.num_layers, full.d_model, full.num_heads,
           full.num_kv_heads, full.head_dim_, full.d_ff, full.mlp,
           full.causal, full.vocab_size, full.frontend_dim, full.dtype,
           full.remat)
          == ("audio", 48, 1280, 16, 16, 80, 5120, "gelu", False, 504, 512,
              "bfloat16", "full"),
          f"hubert_xlarge is not the full config: {full}")
    times = hubert_attention_checks(randn, errs, smi)
    attention_grads_check(dev, "hubert_xlarge", "N")
    gc.collect()
    torch.cuda.empty_cache()

    ts = TrainStepConfig()
    opt = OptimConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    reset_launch_counts()
    # (b) correctness at full width, 2 layers, float32
    steps_agree("N", dataclasses.replace(full, num_layers=2,
                                         dtype="float32"), ts, opt, dev,
                smi, seed=27)

    # (c) timed runs, bfloat16, 1 warm-up + 3 steps of 8 x 512 frames
    def batches(cfg):
        return family_batches(cfg, dev, TRAIN_BATCH, TRAIN_SEQ, 4)

    n_params = sum(t.numel() for t in _leaves(param_shapes(full)))
    state = init_state(full, opt, generator=torch.Generator(
        device=dev).manual_seed(28), device=dev)
    bt = batches(full)
    step = make_train_step(full, ts, opt, device=dev)
    state, _ = step(state, bt[0])
    torch.cuda.synchronize()
    c0 = launch_counts()
    state, _ = step(state, bt[1])
    torch.cuda.synchronize()
    one = {k: v - c0[k] for k, v in launch_counts().items() if v != c0[k]}
    nl = full.num_layers
    check(one.get("flash_attention") == 2 * nl
          and one.get("flash_attention_bwd") == nl,
          f"path N: a step launched {one}, not flash_attention twice a "
          f"layer (remat) and flash_attention_bwd once ({2 * nl}, {nl})")
    print(f"path N: one make_train_step step at {nl} layers launched "
          f"{one}: flash_attention twice a layer (forward and remat), "
          f"flash_attention_bwd once", flush=True)
    state, _ = train_timed(
        "N", f"make_train_step, full width, {nl} layers ({n_params} "
        f"parameters), bfloat16", step, state, bt, profile=True)
    sess = CommSession(device=dev)
    state, _ = train_timed(
        "N", f"make_dp_train_step on {sess.num_devices} devices, full "
        f"width, {nl} layers, bfloat16", make_dp_train_step(
            full, ts, opt, sess), state, bt, sess, profile=True)
    del state, sess, step, bt
    gc.collect()
    torch.cuda.empty_cache()

    cfg2 = dataclasses.replace(full, num_layers=2)
    state = init_state(cfg2, opt, generator=torch.Generator(
        device=dev).manual_seed(29), device=dev)
    p2 = sum(t.numel() for t in _leaves(state["params"]))
    sess = CommSession(device=dev)
    bt = batches(cfg2)
    captured = make_captured_dp_train_step(cfg2, ts, opt, sess, state, bt[0])
    arena = arena_bytes(captured.capture.capture)
    print(f"path N: the captured step's arena at full width, 2 layers "
          f"({p2} parameters), bfloat16 params, float32 moments, "
          f"{sess.num_devices} devices: {arena} B = {arena / 1e9:.2f} GB, "
          f"{arena / p2:.1f} B a parameter "
          f"({len(captured.capture.capture.buffers)} buffers)", flush=True)
    state, _ = train_timed(
        "N", f"make_captured_dp_train_step on {sess.num_devices} devices, "
        f"full width, 2 layers, bfloat16", captured, state, bt, sess,
        profile=True)
    del state, captured, sess, bt
    read_path("N")
    for name in ("flash_attention", "flash_attention_bwd", "multipath_dma"):
        check(per_path["N"].get(name, 0) > 0,
              f"path N did not launch {name}")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"path N: {time.perf_counter() - t_path:.1f} s", flush=True)
    return times


#: Path O's depths: Kimi K2 over 1 of its 61 layers (38.8 GB at full
#: width, 33.9 GB of it the 384 experts), Nemotron-4 340B over 4 of 96
#: (6.9 GB a layer beside 18.9 GB of embedding and head).
KIMI_LAYERS, NEMOTRON_LAYERS = 1, 4
#: The most device memory path O reckons a model's serving may take
#: before its prompts are halved (the card has 80 GB).
SERVE_BYTES_LIMIT = 70e9


def moe_prefill_bytes(cfg, tokens: int) -> int:
    """The bytes one dropless MoE layer holds at once over ``tokens``
    prompt tokens (capacity = tokens for each of the E experts): the
    dispatch buffer and the experts' output, ``(E, T, d)`` each, and three
    ``(E, T, d_ff)`` intermediates of the gated product, bfloat16."""
    e, d, ff = cfg.num_experts, cfg.d_model, cfg.d_ff
    return 2 * e * tokens * (2 * d + 3 * ff)


def serve_reckoning(cfg, prompts: list[int], new: int) -> int:
    """The bytes a model's serving in path O reckons at its peak: the
    weights, twice a prefill's largest transient (the prefill graph's
    private pool and an eager prefill beside it) and the full-sequence
    logits."""
    from repro_torch.models.transformer import param_shapes

    weights = sum(t.numel() * t.element_size()
                  for t in _leaves(param_shapes(cfg)))
    tokens = len(prompts) * max(prompts)
    transient = (moe_prefill_bytes(cfg, tokens) if cfg.num_experts
                 else 2 * tokens * 2 * cfg.d_ff)
    logits = tokens * cfg.vocab_size * 2
    return weights + 2 * transient + 2 * logits


def serve_config_path(dev, errs, per_path, read_path, name: str, layers: int,
                      want: tuple, prompt_lens: list[int], new: int,
                      path: str, smi: str, keep: dict | None = None) -> dict:
    """One model of main path O: ``name`` at full width over ``layers``
    layers, served with ``ServeEngine(max_len=1024, kv_chunks=4)`` on
    seeded random weights (its prompts halved while
    :func:`serve_reckoning` passes ``SERVE_BYTES_LIMIT``): the counted run
    of :func:`serve_requests` (every counter set to 0 just before), the
    token and captured-decode checks of :func:`program_checks`, the kernel
    at layer 0's real prefill q/k/v, :func:`serving_times`, and the kernel
    at the prefill's shape beside its bound and SDPA. Returns that
    shape's times; with ``keep``, puts the run's prompts, tokens, prefill
    logits and one decode step's logits there (on the host)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.serving import ServeEngine

    full = get_config(name)
    fields = ("family", "d_model", "num_heads", "num_kv_heads", "head_dim_",
              "d_ff", "mlp", "num_experts", "top_k", "num_shared_experts",
              "vocab_size", "attention", "dtype")
    check(tuple(getattr(full, f) for f in fields) == want,
          f"{name} is not the full config: {full}")
    cfg = dataclasses.replace(full, num_layers=layers)
    lens = list(prompt_lens)
    reckoned = serve_reckoning(cfg, lens, new)
    while reckoned > SERVE_BYTES_LIMIT:
        lens = [n // 2 for n in lens]
        reckoned = serve_reckoning(cfg, lens, new)
    print(f"path {path}: {name} over {layers} of {full.num_layers} layers: "
          f"reckoned peak {reckoned / 1e9:.1f} GB (weights, twice a "
          f"prefill's transient, logits) at prompts {lens}"
          + (f" (halved from {prompt_lens}: {serve_reckoning(cfg, prompt_lens, new) / 1e9:.1f} GB "
             f"passes {SERVE_BYTES_LIMIT / 1e9:.0f} GB)"
             if lens != prompt_lens else ""), flush=True)
    params = init_model(cfg, dev, path)
    tok_gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (n,),
                             generator=tok_gen).tolist() for n in lens]
    engine = ServeEngine(cfg, params, max_len=1024, kv_chunks=4)
    toks, outs, logits, cache, gen_s = serve_requests(
        cfg, engine, prompts, new, path, per_path, read_path)
    b, plen = toks.shape
    program_checks(cfg, engine, toks, outs, path)
    layer0_attention_check(cfg, params, toks, errs, path)
    serving_times(cfg, engine, None, toks, logits, cache, new, gen_s, path)
    if keep is not None:
        keep.update(prompts=prompts, toks=toks.cpu(), outs=outs,
                    logits=logits.cpu(),
                    dec=decode_logits(engine, toks, logits).cpu())
    del engine, params, logits, cache
    gc.collect()
    torch.cuda.empty_cache()
    dev_gen = torch.Generator(device=dev).manual_seed(31)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=dev_gen, device=dev).to(dtype)

    case = flash_case_times(randn, errs, b, cfg.num_heads, cfg.num_kv_heads,
                            plen, cfg.head_dim_, plain_iters=3, smi=smi)
    if plen != max(prompt_lens):
        # the requests' own length too, where the reckoning halved them
        case["unhalved"] = flash_case_times(
            randn, errs, b, cfg.num_heads, cfg.num_kv_heads,
            max(prompt_lens), cfg.head_dim_, plain_iters=3, smi=smi)
    for c in (case, case.get("unhalved", case)):
        check(c["max_abs_err"] <= 2e-2, f"flash_attention at path {path}'s "
              f"prefill shape: max abs err {c['max_abs_err']} vs plain, "
              f"beyond the reference's bf16 2e-2")
    return case


def serving_head_dims_path(dev, errs, per_path, read_path, smi,
                           keep: dict) -> dict:
    """Main path O (phase 20): serving at head dims 112 and 192, each
    model freed before the next: Kimi K2 (MoE, 384 experts of d_ff 2048
    top-8 and one shared expert, 64/8 heads of 112, vocab 163840) over 1
    of its 61 layers, 4 requests of 256/192/128/64 tokens and 16 new
    each; Nemotron-4 340B (dense, 96/8 heads of 192, squared-ReLU d_ff
    73728, vocab 256000) over 4 of its 96 layers, path E's 4 requests of
    512/384/256/128 tokens and 32 new each. Returns the kernel's times at
    each prefill shape (Kimi K2's also at its requests' unhalved
    length); Nemotron-4's readings go into ``keep`` for path AB."""
    t_path = time.perf_counter()
    kimi = serve_config_path(
        dev, errs, per_path, read_path, "kimi_k2_1t_a32b", KIMI_LAYERS,
        ("moe", 7168, 64, 8, 112, 2048, "swiglu", 384, 8, 1, 163840, "full",
         "bfloat16"), [256, 192, 128, 64], 16, "O-kimi", smi)
    nemotron = serve_config_path(
        dev, errs, per_path, read_path, "nemotron_4_340b", NEMOTRON_LAYERS,
        ("dense", 18432, 96, 8, 192, 73728, "relu2", 0, 0, 0, 256000, "full",
         "bfloat16"), [512, 384, 256, 128], 32, "O-nemotron", smi,
        keep=keep)
    print(f"path O: {time.perf_counter() - t_path:.1f} s", flush=True)
    return {"O-kimi": kimi, "O-nemotron": nemotron}


#: Phase 3's head dims of the registered configs beyond 16/32/64/128:
#: HuBERT-XLarge's 80, Kimi K2's 112, Nemotron-4 340B's 192 (the forward
#: only: the backward raises there), at two shapes each.
WIDE_DIMS = (80, 112, 192)
WIDE_SHAPES = ((1, 4, 2, 200), (2, 8, 8, 130))


def wide_head_dim_checks(randn, errs, flash_case) -> None:
    """Phase 3 at the configs' head dims: the forward at ``WIDE_DIMS`` x
    ``WIDE_SHAPES`` under each mask (causal, causal with a window of 64,
    full), float32 at atol 3e-5 / rtol 1e-4 and bfloat16 at max abs 2e-2;
    the backward at 80, 112 and 192 against its plain version, float32
    within 1e-4 and bfloat16 within 2e-2 of the largest |want|."""
    from repro_torch.kernels.flash_attention import kernel as fk

    t0 = time.perf_counter()
    masks = ((True, None), (True, 64), (False, None))
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for d in WIDE_DIMS:
        for b, hq, hkv, s in WIDE_SHAPES:
            for causal, window in masks:
                worst[torch.float32] = max(worst[torch.float32], flash_case(
                    (b, hq, hkv, s, d), torch.float32, causal, window, 3e-5,
                    1e-4))
                worst[torch.bfloat16] = max(worst[torch.bfloat16],
                                            flash_case((b, hq, hkv, s, d),
                                                       torch.bfloat16, causal,
                                                       window, 2e-2, 0.0))
    rel = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for d in WIDE_DIMS:
        for b, hq, hkv, s in WIDE_SHAPES:
            for causal, window in masks:
                for dt in (torch.float32, torch.bfloat16):
                    q = (randn(b, hq, s, d) * 0.5).to(dt)
                    k = (randn(b, hkv, s, d) * 0.5).to(dt)
                    v = randn(b, hkv, s, d, dtype=dt)
                    do = randn(b, hq, s, d, dtype=dt)
                    for name, (err, top) in bwd_case_err(
                            fk, q, k, v, do, causal, window, "3").items():
                        errs["flash_attention_bwd"] = max(
                            errs["flash_attention_bwd"], err)
                        rel[dt] = max(rel[dt], err / top)
                        check(err <= BWD_REL[dt] * top,
                              f"flash_attention_bwd {name} at ({b}, "
                              f"{hq}/{hkv}, {s}, {d}) {dt} causal={causal} "
                              f"window={window}: max abs err {err} > "
                              f"{BWD_REL[dt]} * {top}")
    print(f"flash_attention vs plain at head dims {WIDE_DIMS}, shapes "
          f"{WIDE_SHAPES}, (causal, window) in {masks}: float32 max abs err "
          f"{worst[torch.float32]} (atol 3e-5, rtol 1e-4), bfloat16 "
          f"{worst[torch.bfloat16]} (max abs 2e-2); flash_attention_bwd "
          f"at {WIDE_DIMS}: largest max abs err / max |want| float32 "
          f"{rel[torch.float32]:.3g} (1e-4), bfloat16 "
          f"{rel[torch.bfloat16]:.3g} (2e-2) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)


#: Path P: Llama-3 8B's 32 layers in 4 stages of 8, 8 microbatches of one
#: sequence of 2048 positions.
PIPE_STAGES, PIPE_MICRO, PIPE_SEQ = 4, 8, 2048


def pipeline_path(dev, errs, per_path, read_path, smi) -> dict:
    """Main path P (phase 21): the GPipe forward of Llama-3 8B at full
    width and depth (32 layers, d_model 4096, 32/8 heads of 128, SwiGLU
    d_ff 14336, bfloat16) in 4 stages of 8 layers (13.96 GB of seeded
    block weights) over 8 microbatches of ``(1, 2048, 4096)`` hidden
    states drawn from a seeded embedding table, on a ``CommSession`` over
    ``Topology.full_mesh(4)``: every stage handoff one ``session.exchange``
    of the 4 stage rows (``multipath_dma``), the last stage's outputs
    surfaced by the session's ring psum (``ring_allgather``). With every
    counter set to 0 just before and read just after: ``pipeline_apply``
    with ``multipath=False`` and ``True``, each bit for bit as sequential
    ``block_apply`` over the 32 layers microbatch by microbatch, every
    surfaced row equal (checked outside the counted run), 11 handoff
    dispatches a call (their fast-path hits
    after the first tick), ``flash_attention`` launched 352 times a call
    (every stage every tick, bubbles included) and ``multipath_dma`` once
    a handoff and twice for each handoff program's build. Then times: ms
    a call for both settings and sequential (medians of 3 in turns), each
    one's device ms, op count and idle share under the profiler, one
    handoff's replay beside its own bytes' bound and its table's, peak
    GiB, and the kernel at the
    microbatch's attention shape beside its bound, its plain version and
    SDPA. Returns that shape's times."""
    from repro_torch.comm import CommSession
    from repro_torch.configs import get_config
    from repro_torch.core.topology import Topology
    from repro_torch.kernels._graph import reset_launch_counts
    from repro_torch.models import transformer as tfm
    from repro_torch.training.pipeline import (_pipeline_surfaced,
                                               block_stages,
                                               make_block_stage_fn,
                                               pipeline_apply,
                                               send_next_stage)

    # -- 21. main path P: the pipeline ----------------------------------------
    t_path = time.perf_counter()
    p, m, s = PIPE_STAGES, PIPE_MICRO, PIPE_SEQ
    cfg = get_config("llama3_8b")
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.head_dim_, cfg.d_ff, cfg.mlp, cfg.dtype)
          == (32, 4096, 32, 8, 128, 14336, "swiglu", "bfloat16"),
          f"llama3_8b is not the full config: {cfg}")
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {"layers": tfm.block_init(cfg, generator=gen, device=dev,
                                       lead=(cfg.num_layers,))}
    embed = torch.randn(cfg.vocab_size, cfg.d_model, generator=gen,
                        device=dev).mul_(cfg.d_model ** -0.5).to(
                            torch.bfloat16)
    tokens = torch.randint(0, cfg.vocab_size, (m, 1, s),
                           generator=torch.Generator().manual_seed(1))
    x = embed[tokens.to(dev)]
    del embed
    torch.cuda.synchronize()
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    print(f"path P: {cfg.name} {cfg.num_layers} layers in {p} stages of "
          f"{cfg.num_layers // p}: {wbytes / 1e9:.2f} GB of seeded block "
          f"weights, {m} microbatches of {tuple(x.shape[1:])} bf16 hidden "
          f"states from a seeded embedding table "
          f"({time.perf_counter() - t0:.2f} s)", flush=True)
    positions = torch.arange(s, device=dev)
    stage_fn = make_block_stage_fn(cfg, p, positions)
    stages = block_stages(params, p)
    sess = CommSession(device=dev, topology=Topology.full_mesh(4))

    def sequential():
        out = []
        for mb in range(m):
            h = x[mb]
            for i in range(cfg.num_layers):
                h, _ = tfm.block_apply(h, tfm.layer_params(params, i), cfg,
                                       -1, positions)
            out.append(h)
        return torch.stack(out)

    def piped(multipath):
        return pipeline_apply(stage_fn, stages, x, microbatches=m,
                              multipath=multipath, session=sess)

    with torch.no_grad():
        seq = sequential()
        torch.cuda.synchronize()
        reset_launch_counts()
        calls = {}
        for multipath in (False, True):
            st0 = sess.stats()
            out = piped(multipath)
            torch.cuda.synchronize()
            st1 = sess.stats()
            calls[multipath] = (
                out, st1["dispatches"] - st0["dispatches"],
                st1["fastpath"]["hits"] - st0["fastpath"]["hits"])
        read_path("P")
        ticks = m + p - 1
        for multipath, (out, disp, hits) in calls.items():
            check(tuple(out.shape) == (m, 1, s, cfg.d_model),
                  f"path P: output shape {tuple(out.shape)}")
            check(torch.equal(out, seq), f"path P (multipath="
                  f"{multipath}): pipeline differs from sequential "
                  f"block_apply (max abs diff "
                  f"{(out.float() - seq.float()).abs().max().item()})")
            check(disp == ticks, f"path P (multipath={multipath}): {disp} "
                  f"handoff dispatches, want {ticks}")
            check(hits == ticks - 1, f"path P (multipath={multipath}): "
                  f"{hits} fast-path hits, want {ticks - 1}")
        launches = per_path["P"]
        check(launches.get("flash_attention", 0)
              == 2 * ticks * cfg.num_layers,
              f"path P: flash_attention launched "
              f"{launches.get('flash_attention', 0)} times, want "
              f"{2 * ticks * cfg.num_layers} (two calls of {ticks} ticks x "
              f"{cfg.num_layers} layers)")
        paths = {}
        for _, entry in sess.engine._fastpath._store.values():
            paths[max(len(pl.paths) for pl in entry.plans)] = entry
        check(sorted(paths)[0] == 1 and len(paths) == 2,
              f"path P: handoff plans with {sorted(paths)} paths, want a "
              f"direct one and a striped one")
        replays = [e.compiled.lifecycle.launches for e in paths.values()]
        check(replays == [ticks, ticks], f"path P: handoff programs "
              f"replayed {replays} times, want {ticks} each")
        # one launch a handoff, and each program's build warms it up and
        # replays it once before its first dispatch (compile_plan)
        check(launches.get("multipath_dma", 0) == 2 * (ticks + 2),
              f"path P: multipath_dma launched "
              f"{launches.get('multipath_dma', 0)} times, want one a "
              f"handoff and two a build ({2 * (ticks + 2)})")
        check(launches.get("ring_allgather", 0) > 0,
              "path P: the surfacing psum launched no ring_allgather")
        # every stage's row of the surfaced outputs, outside the counted
        # run: the stacked result that pipeline_apply returns row 0 of
        for multipath, (out, _, _) in calls.items():
            rows = _pipeline_surfaced(stage_fn, stages, x,
                                      microbatches=m, multipath=multipath,
                                      session=sess)
            check(all(torch.equal(rows[i], out) for i in range(p)),
                  f"path P (multipath={multipath}): surfaced rows differ")
            del rows
        print(f"path P: pipeline_apply, multipath False and True: bitwise "
              f"equal to sequential block_apply over {cfg.num_layers} "
              f"layers for all {m} microbatches, every surfaced row equal, "
              f"{ticks} handoff dispatches a call ({ticks - 1} fast-path "
              f"hits), launches {launches} (flash_attention {ticks} ticks x "
              f"{cfg.num_layers} layers a call, bubbles included; "
              f"multipath_dma one a handoff, two a program build); handoff "
              f"paths per message: direct 1, multipath {max(paths)}",
              flush=True)

        # times: one card runs the four stages one after another; three
        # rounds in turns, then one profiled call of each
        calls_ms = {"sequential": [], "direct": [], "multipath": []}
        fns = {"sequential": sequential, "direct": lambda: piped(False),
               "multipath": lambda: piped(True)}
        for _ in range(3):
            for name, fn in fns.items():
                calls_ms[name].append(host_time_ms(fn, 1, warmup=0))
        seq_ms, direct_ms, mp_ms = (sorted(calls_ms[k])[1] for k in fns)
        profiled = {name: profile_device_ms(fn, top=4)
                    for name, fn in fns.items()}
        h_out = torch.randn(p, 1, s, cfg.d_model, generator=gen,
                            device=dev).to(torch.bfloat16)
        handoff = {}
        # the handoff itself reads each stage row once and writes it once;
        # the table's bytes add the exchange's zero fill of every
        # message's other rows, which the pipeline throws away
        own_ms = 2 * h_out.numel() * h_out.element_size() \
            / HBM_BYTES_PER_S * 1e3
        for npaths, entry in sorted(paths.items()):
            prog = entry.compiled.program
            reads, writes = prog.table.bytes_moved()
            handoff[npaths] = (
                cuda_time_ms(prog.replay, 20),
                (reads + writes) / HBM_BYTES_PER_S * 1e3,
                host_time_ms(lambda mp=npaths > 1: send_next_stage(
                    h_out, p, multipath=mp, session=sess), 10))
        peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"path P ({smi}): ms a call (host clock, synced): sequential "
          f"{seq_ms:.2f}, pipeline direct {direct_ms:.2f} "
          f"({direct_ms / seq_ms:.3f}x), multipath {mp_ms:.2f} "
          f"({mp_ms / seq_ms:.3f}x). One card runs the {p} stages one "
          f"after another, so pipelining cannot beat sequential here: "
          f"every tick runs all {p} stages, {ticks} ticks for {m} "
          f"microbatches, (M + P - 1)/M = {ticks / m:.3f}x the layer work "
          f"(the bubble's share); medians of 3 in turns, each call "
          f"{ {k: [round(v, 2) for v in vs] for k, vs in calls_ms.items()} }",
          flush=True)
    for (name, (wall, dev_ms, n_ops, top)), ms in zip(
            profiled.items(), (seq_ms, direct_ms, mp_ms)):
        idle = (f"{1 - dev_ms / ms:.1%}" if dev_ms else
                "not measured: the profiler recorded no device time")
        print(f"path P ({smi}): {name} under the profiler: wall "
              f"{wall:.2f} ms, device {dev_ms:.2f} ms in {n_ops} ops, idle "
              f"share vs the unprofiled {ms:.2f} ms: {idle}; top ms: "
              f"{top_ops(top)}", flush=True)
    for npaths, (replay, bound, call) in handoff.items():
        print(f"path P ({smi}): one handoff ({p} x "
              f"{s * cfg.d_model * 2 / MiB:.0f} MiB, {npaths} path(s) a "
              f"message): replay {replay:.4f} ms; bound of the handoff's "
              f"own bytes (each row read and written once) {own_ms:.4f} ms "
              f"({own_ms / replay:.1%}), of the table's bytes (with the "
              f"zero fill of each message's {p - 1} other rows) "
              f"{bound:.4f} ms ({bound / replay:.1%}); send_next_stage "
              f"{call:.4f} ms (host clock: staging, replay, copies out)",
              flush=True)
    print(f"path P: peak {peak:.2f} GiB; {time.perf_counter() - t_path:.1f} "
          f"s", flush=True)
    del params, stages, x, seq, calls, out, h_out, sess
    gc.collect()
    torch.cuda.empty_cache()
    dev_gen = torch.Generator(device=dev).manual_seed(37)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=dev_gen, device=dev).to(dtype)

    case = flash_case_times(randn, errs, 1, cfg.num_heads, cfg.num_kv_heads,
                            s, cfg.head_dim_, plain_iters=3, smi=smi)
    check(case["max_abs_err"] <= 2e-2, f"flash_attention at path P's "
          f"microbatch shape: max abs err {case['max_abs_err']} vs plain, "
          f"beyond the reference's bf16 2e-2")
    return case


#: Path Q's bound: the reference's int8 error bound, max abs error over
#: the max |mean| of a leaf.
COMPRESS_REL = 0.02


def mean_sum_tol(g: torch.Tensor) -> float:
    """How far two float32 means of ``g: (n, ...)`` over dim 0 may differ
    when they sum in different orders: each n-term sum is within
    ``(n - 1) · 2**-24 · n · max|g|`` of the exact one, so their means
    are within ``2 (n - 1) · 2**-24 · max|g|``, under ``n · 2**-23 ·
    max|g|``."""
    return g.shape[0] * 2.0 ** -23 * g.abs().max().item()


def compression_path(dev, errs, per_path, read_path, smi) -> None:
    """Main path Q (phase 22): the int8 compressed gradient mean at
    SmolLM-360M's full-width leaf shapes (32 layers, d_model 960, 15/5
    heads of 64, d_ff 2560, vocab 49152): 4 replicas of seeded float32
    gradients that differ per replica (6.54 GB stacked). With every
    counter set to 0 just before and read just after:
    ``compressed_psum_tree`` and ``comm.collectives.pmean`` against the
    plain mean ``g.mean(0)`` of the same device tensors (every row
    equal; every leaf of the compressed mean within 0.02 of its max
    |mean|, of ``pmean`` within :func:`mean_sum_tol`, which holds the
    ring and its ``ring_allgather`` to the plain sum at the path's
    shapes), then 30 steps of ``compressed_psum_with_feedback`` against
    30 of ``compressed_psum`` at the reference's (8, 128) and at the
    full-width (49152, 960) embedding leaf with 4 replicas (the
    accumulated error against the plain mean with feedback below that
    without). Then ms a tree against ``pmean``'s."""
    from repro_torch.comm import CommSession
    from repro_torch.configs import get_config
    from repro_torch.core.topology import Topology
    from repro_torch.kernels._graph import reset_launch_counts
    from repro_torch.models.transformer import param_shapes
    from repro_torch.optim import compression as comp
    from repro_torch.tree import leaves_with_paths, tree_map

    # -- 22. main path Q: compressed gradient mean ----------------------------
    t_path = time.perf_counter()
    cfg = get_config("smollm_360m")
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.d_ff, cfg.vocab_size) == (32, 960, 15, 5, 2560, 49152),
          f"smollm_360m is not the full config: {cfg}")
    n = 4
    gen = torch.Generator(device=dev).manual_seed(41)
    grads = tree_map(lambda t: torch.randn((n,) + tuple(t.shape),
                                           generator=gen, device=dev)
                     .mul_(0.01), param_shapes(cfg))
    gbytes = sum(g.numel() * 4 for _, g in leaves_with_paths(grads))
    sess = CommSession(device=dev, topology=Topology.full_mesh(n))
    sess8 = CommSession(device=dev, topology=Topology.full_mesh(
        8, name="mesh8"))
    reset_launch_counts()
    got = comp.compressed_psum_tree(grads, sess)
    mean = tree_map(sess.collectives.pmean, grads)
    torch.cuda.synchronize()
    # both against the plain mean of the same device tensors: pmean runs
    # the ring (ring_allgather) that the compressed mean runs
    worst, worst_leaf, rows_equal = 0.0, "", True
    pmean_worst, pmean_leaf, pmean_ok = 0.0, "", True
    for (path, g), (_, c), (_, w) in zip(leaves_with_paths(grads),
                                         leaves_with_paths(got),
                                         leaves_with_paths(mean)):
        plain = g.mean(0)
        scale = plain.abs().max().item() + 1e-9
        rows_equal &= all(torch.equal(c[i], c[0]) for i in range(1, n))
        rows_equal &= all(torch.equal(w[i], w[0]) for i in range(1, n))
        rel = (c[0] - plain).abs().max().item() / scale
        if rel >= worst:
            worst, worst_leaf = rel, "/".join(path)
        err = (w[0] - plain).abs().max().item()
        pmean_ok &= err <= mean_sum_tol(g)
        if err / scale >= pmean_worst:
            pmean_worst, pmean_leaf = err / scale, "/".join(path)
        del plain
    del got, mean

    def feedback_gap(g, comm, steps=30):
        """Accumulated mean error of ``steps`` compressed means, with and
        without error feedback, against the plain mean."""
        exact = g.mean(0)
        res = torch.zeros_like(g)
        acc_fb = torch.zeros_like(exact)
        acc = torch.zeros_like(exact)
        for _ in range(steps):
            out, res = comp.compressed_psum_with_feedback(g, res, comm)
            acc_fb += out[0]
            acc += comp.compressed_psum(g, comm)[0]
        return ((acc_fb / steps - exact).abs().mean().item(),
                (acc / steps - exact).abs().mean().item())

    small = feedback_gap(torch.randn(8, 128, generator=gen, device=dev)
                         * 0.1, sess8)
    embed = tuple(grads["embed"].shape)
    wide = feedback_gap(torch.randn(embed, generator=gen, device=dev) * 0.1,
                        sess)
    torch.cuda.synchronize()
    read_path("Q")
    check(rows_equal, "path Q: compressed mean or pmean rows differ")
    check(pmean_ok, f"path Q: pmean differs from the plain mean beyond "
          f"the float32 rounding of a {n}-term sum (worst leaf "
          f"{pmean_leaf}, {pmean_worst:.3g} of its max |mean|)")
    check(worst < COMPRESS_REL, f"path Q: leaf {worst_leaf} max abs err "
          f"{worst} of its max |mean|, beyond {COMPRESS_REL}")
    for shape, (fb, nofb) in (((8, 128), small), (embed, wide)):
        check(fb < nofb, f"path Q: error feedback at {shape} does not beat "
              f"no feedback ({fb} >= {nofb})")
    check(per_path["Q"].get("ring_allgather", 0) > 0,
          "path Q: the compressed mean launched no ring_allgather")
    print(f"path Q: compressed_psum_tree over {len(_leaves(grads))} leaves "
          f"of smollm_360m x {n} replicas ({gbytes / 1e9:.2f} GB float32) "
          f"against the plain mean g.mean(0): every row equal, worst leaf "
          f"{worst_leaf} max abs err / max |mean| {worst:.5f} (bound "
          f"{COMPRESS_REL}); pmean (the same ring) within a {n}-term "
          f"sum's float32 rounding on every leaf, worst {pmean_leaf} "
          f"{pmean_worst:.3g} of its max |mean|; 30 steps' mean "
          f"error with / without feedback: (8, 128) {small[0]:.3e} / "
          f"{small[1]:.3e}, {embed} {wide[0]:.3e} / {wide[1]:.3e}; "
          f"launches {per_path['Q']}", flush=True)
    tree_ms = host_time_ms(lambda: comp.compressed_psum_tree(grads, sess),
                           3, warmup=1)
    pmean_ms = host_time_ms(lambda: tree_map(sess.collectives.pmean, grads),
                            3, warmup=1)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"path Q ({smi}): compressed_psum_tree {tree_ms:.2f} ms a tree, "
          f"pmean {pmean_ms:.2f} ms ({tree_ms / pmean_ms:.2f}x; both "
          f"all-reduce float32 through the session's ring: the int8 "
          f"payload is not what crosses); peak {peak:.2f} GiB; "
          f"{time.perf_counter() - t_path:.1f} s", flush=True)


def captured_dma_check(dev) -> None:
    """Phase 23: a captured step of ``captured_multipath_dma``, then
    ``cap.exchange``, then a compute node, on the default session: each
    call one dispatch, ``multipath_dma`` launched once for the DMA node
    and once for each copy run, the result bit for bit as the eager
    composition (``multipath_dma_transfer``, ``session.send``, the
    kernel). Then ``multipath_send_local`` of the same plan on the stacked
    operand: one ``multipath_dma`` launch, the message bit for bit as
    ``session.send``'s on row 2 and zeros elsewhere, eagerly and replayed
    from a CUDA graph that recorded it."""
    from repro_torch.comm import CommSession, multipath_send_local
    from repro_torch.kernels.multipath_dma import kernel as dk
    from repro_torch.kernels.multipath_dma.ops import (
        captured_multipath_dma, multipath_dma_transfer)

    # -- 23. the captured multipath_dma step ----------------------------------
    sess = CommSession(device=dev)
    n, nelems = sess.num_devices, 1 << 22            # 16 MiB float32 rows
    plan = sess.plan(0, 2, nelems * 4, max_paths=3, num_chunks=4,
                     granularity=4)

    def build(cap):
        y = captured_multipath_dma(cap, cap.input((nelems,), torch.float32),
                                   plan, n)
        (r,) = cap.exchange([(y, 2, 1)])
        return cap.kernel(lambda v: v * 0.5 - 1.0, r, name="affine")

    step = sess.capture(build)
    runs = len(step.resolve().compiled.program.copy_runs)
    gen = torch.Generator(device=dev).manual_seed(43)
    xs = torch.randn(n, nelems, generator=gen, device=dev)
    d0, l0 = sess.stats()["dispatches"], dk.LAUNCHES
    (out,) = step(xs)
    (out,) = step(xs)
    torch.cuda.synchronize()
    disp, launched = sess.stats()["dispatches"] - d0, dk.LAUNCHES - l0
    moved = multipath_dma_transfer(xs, plan)
    want = torch.zeros_like(xs)
    want[1] = sess.send(moved[2], 2, 1)
    want = want * 0.5 - 1.0
    check(torch.equal(out, want), "captured multipath_dma step differs from "
          "the eager composition")
    check(disp == 2 and launched == 2 * (1 + runs),
          f"captured multipath_dma step: {disp} dispatches and {launched} "
          f"multipath_dma launches for 2 calls, want 2 and {2 * (1 + runs)}")
    print(f"captured multipath_dma ({len(plan.paths)} paths) + exchange + "
          f"compute node: bitwise equal to the eager composition, one "
          f"dispatch a call, multipath_dma 1 + {runs} copy run(s) a call",
          flush=True)

    sent = sess.send(xs[0], 0, 2, max_paths=3, num_chunks=4)
    l0 = dk.LAUNCHES
    local = multipath_send_local(xs, plan, topology=sess.topology)
    launched = dk.LAUNCHES - l0
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        recorded = multipath_send_local(xs, plan, topology=sess.topology)
    graph.replay()
    torch.cuda.synchronize()
    others = [0, 1, 3]
    check(launched == 1 and torch.equal(local[2], sent)
          and not local[others].any() and torch.equal(recorded, local),
          f"multipath_send_local: {launched} launches, row 2 bitwise "
          f"{torch.equal(local[2], sent)}, other rows zero "
          f"{not local[others].any()}, replay bitwise "
          f"{torch.equal(recorded, local)}")
    print(f"multipath_send_local of the same plan on the stacked ({n}, "
          f"{nelems}) operand: one multipath_dma launch, row 2 bitwise as "
          f"session.send's, zeros elsewhere; recorded in a CUDA graph and "
          f"replayed: bitwise the same", flush=True)


def dryrun_cli_check() -> None:
    """Phase 24: the port's dry-run and report CLIs, each in a subprocess
    from the checkout's ``src`` under ``-X importtime``: ``python -m
    repro_torch.launch.dryrun --comm --fail-link 0:1 --out <tmp>``, the
    model-cell dry-run of one arch and shape into the same file (counted
    on meta tensors) and ``python -m repro_torch.launch.report <tmp>``
    exit 0 and import no module of the reference package; the ``--comm``
    dry-run and the report no top-level package beyond the standard
    library and what importing ``torch`` and ``repro_torch.comm``
    imports."""
    import tempfile

    # -- 24. the dry-run and report CLIs --------------------------------------
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))

    def run(*args):
        """Run ``python -X importtime *args``; returns the process and the
        top-level names of the modules it imported."""
        proc = subprocess.run([sys.executable, "-X", "importtime", *args],
                              capture_output=True, text=True, env=env,
                              timeout=300)
        check(proc.returncode == 0, f"{' '.join(args)}: exit "
              f"{proc.returncode}: {proc.stderr[-2000:]}")
        names = {line.rsplit("|", 1)[1].strip().split(".")[0]
                 for line in proc.stderr.splitlines()
                 if line.startswith("import time:") and "|" in line}
        return proc, names - {"imported package"}

    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build"),
                                     prefix="dryrun-") as tmp:
        rows = os.path.join(tmp, "rows.json")
        dry, dry_names = run("-m", "repro_torch.launch.dryrun", "--comm",
                             "--fail-link", "0:1", "--out", rows)
        cells, cell_names = run("-m", "repro_torch.launch.dryrun", "--arch",
                                "smollm_360m", "--shape", "decode_32k",
                                "--out", rows)
        rep, rep_names = run("-m", "repro_torch.launch.report", rows)
    _, base = run("-c", "import torch, repro_torch.comm")
    loaded = dry_names | rep_names
    extra = sorted(loaded - base - set(sys.stdlib_module_names))
    check("repro" not in loaded and not extra and "repro_torch" in loaded,
          f"the dry-run CLIs imported {extra} beyond the port's own imports "
          f"(reference package imported: {'repro' in loaded})")
    table_rows = sum(line.startswith("| ") for line in rep.stdout.splitlines())
    # a meta count also loads what torch's meta kernels import lazily
    check("ok=2 skipped=0 error=0" in cells.stdout
          and "repro" not in cell_names,
          f"the model-cell dry-run: {cells.stdout[-500:]}")
    print(f"dryrun CLI --comm --fail-link 0:1: exit 0, "
          f"{dry.stdout.strip().splitlines()[-1]}; the model cells of "
          f"smollm_360m decode_32k: {cells.stdout.strip().splitlines()[-1]}"
          f"; report CLI: exit 0, "
          f"{table_rows} table lines; {len(loaded)} top-level packages "
          f"imported, none beyond the port's own imports and the standard "
          f"library ({time.perf_counter() - t0:.1f} s)", flush=True)


#: Path R: Nemotron-4 340B trained at full width over 1 of its 96 layers,
#: its vocabulary cut to 32,768. Reckoned at 8 B a parameter (bfloat16
#: weights, gradients and two bfloat16 moments): a layer is 3.454 B
#: parameters, 27.6 GB; the untied embedding and head at the full 256,000
#: would be 9.44 B parameters, 75.5 GB, and do not fit beside it; at
#: 32,768 they are 1.21 B, 9.7 GB.
NEMOTRON_TRAIN_LAYERS, NEMOTRON_TRAIN_VOCAB = 1, 32768
#: Path R's attention shape: (batch, q heads, kv heads, sequence, head dim).
NEMOTRON_ATTN = (8, 96, 8, 512, 192)


def nemotron_training_path(dev, errs, per_path, read_path, smi) -> dict:
    """Main path R (phase 25): training Nemotron-4 340B at full width
    (d_model 18432, 96/8 heads of 192, squared-ReLU d_ff 73728, bfloat16,
    bfloat16 moments as the config says, ``remat="full"``) over
    ``NEMOTRON_TRAIN_LAYERS`` layer, its vocabulary cut to
    ``NEMOTRON_TRAIN_VOCAB``, on batches of 8 x 512 tokens.

    (a), not counted: the attention backward kernel at head dim 192 at
    the training shape (``NEMOTRON_ATTN``, causal) and at one DP shard's,
    float32 and bfloat16, against its plain version, then its time beside
    its bound, the plain version and SDPA's backward. Then, with every
    launch counter set to 0 just before and read just after: one step of
    ``make_train_step`` whose attention backward's inputs (layer 0's real
    q, k, v, O and dO) are kept, its kernels' outputs held to the plain
    backward on them within 2e-2 of the largest |want|, the forward
    kernel launched twice a layer (remat) and the backward once; then 1
    warm-up + 3 timed steps and one under the profiler. Returns the
    backward's times at the attention shape."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels._graph import launch_counts, reset_launch_counts
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.flash_attention import ops as fops
    from repro_torch.models.transformer import param_shapes
    from repro_torch.optim import OptimConfig
    from repro_torch.training import (TrainStepConfig, init_state,
                                      make_train_step)

    dev_gen = torch.Generator(device=dev).manual_seed(41)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=dev_gen, device=dev).to(dtype)

    # -- 25. main path R: training Nemotron-4 340B ---------------------------
    t_path = time.perf_counter()
    full = get_config("nemotron_4_340b")
    check((full.family, full.num_layers, full.d_model, full.num_heads,
           full.num_kv_heads, full.head_dim_, full.d_ff, full.mlp,
           full.vocab_size, full.dtype, full.remat, full.optimizer_dtype)
          == ("dense", 96, 18432, 96, 8, 192, 73728, "relu2", 256000,
              "bfloat16", "full", "bfloat16"),
          f"nemotron_4_340b is not the full config: {full}")
    cfg = dataclasses.replace(full, num_layers=NEMOTRON_TRAIN_LAYERS,
                              vocab_size=NEMOTRON_TRAIN_VOCAB)
    layer_p = sum(t.numel() for t in _leaves(param_shapes(cfg)["layers"]))
    vocab_p = 2 * cfg.d_model * cfg.vocab_size
    print(f"path R: {cfg.name} at full width over {cfg.num_layers} of "
          f"{full.num_layers} layers, vocabulary {cfg.vocab_size} of "
          f"{full.vocab_size}: reckoned at 8 B a parameter (bf16 weights, "
          f"grads, two bf16 moments): a layer {layer_p / 1e9:.3f} B "
          f"parameters, {8 * layer_p / 1e9:.1f} GB; embedding and head "
          f"{vocab_p / 1e9:.3f} B, {8 * vocab_p / 1e9:.1f} GB (at the full "
          f"vocabulary {2 * cfg.d_model * full.vocab_size / 1e9:.2f} B, "
          f"{16 * cfg.d_model * full.vocab_size / 1e9:.1f} GB)", flush=True)
    b, hq, hkv, s, d = NEMOTRON_ATTN
    check((hq, hkv, d) == (cfg.num_heads, cfg.num_kv_heads, cfg.head_dim_)
          and (b, s) == (TRAIN_BATCH, TRAIN_SEQ),
          f"path R's attention shape {NEMOTRON_ATTN} is not the model's")
    train_bwd_checks(randn, errs, "R", b, hq, hkv, s, d, True)
    times = bwd_case_times(randn, b, hq, hkv, s, d, True, torch.bfloat16,
                           smi, "R")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    opt = OptimConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                      moment_dtype=cfg.optimizer_dtype)
    ts = TrainStepConfig()
    total, held = update_bytes(cfg, opt)
    print(f"path R: the step holds {held / 1e9:.1f} GB of weights, grads "
          f"and moments, {total / 1e9:.1f} GB at the update (new weights "
          f"and moments beside the old, AdamW's slice temporaries)",
          flush=True)
    reset_launch_counts()
    t0 = time.perf_counter()
    state = init_state(cfg, opt, generator=torch.Generator(
        device=dev).manual_seed(42), device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(state["params"]))
    state_gb = sum(t.numel() * t.element_size()
                   for t in _leaves(state)) / 1e9
    print(f"path R: {n_params} parameters drawn, {state_gb:.2f} GB of "
          f"weights and moments in {time.perf_counter() - t0:.2f} s",
          flush=True)
    bt = family_batches(cfg, dev, TRAIN_BATCH, TRAIN_SEQ, 4)
    step = make_train_step(cfg, ts, opt, device=dev)

    # one step, keeping layer 0's attention backward's real inputs
    kept = {}
    real_bwd = fops.flash_attention_bwd_cuda

    def keeping(q, k, v, o, lse, do, **kw):
        out = real_bwd(q, k, v, o, lse, do, **kw)
        if not kept:
            kept.update(args=(q, k, v, o, lse, do), kw=kw, out=out)
        return out

    fops.flash_attention_bwd_cuda = keeping
    try:
        c0 = launch_counts()
        state, m = step(state, bt[0])
        torch.cuda.synchronize()
    finally:
        fops.flash_attention_bwd_cuda = real_bwd
    one = {k: v - c0[k] for k, v in launch_counts().items() if v != c0[k]}
    nl = cfg.num_layers
    check(one.get("flash_attention") == 2 * nl
          and one.get("flash_attention_bwd") == nl,
          f"path R: a step launched {one}, not flash_attention twice a "
          f"layer (remat) and flash_attention_bwd once ({2 * nl}, {nl})")
    want = fk.flash_attention_bwd_plain(*kept["args"], **kept["kw"])
    rel = {}
    for name, g, w in zip(("dq", "dk", "dv"), kept["out"], want):
        err = (g.float() - w.float()).abs().max().item()
        top = w.float().abs().max().item()
        errs["flash_attention_bwd"] = max(errs["flash_attention_bwd"], err)
        rel[name] = err / top
        check(err <= BWD_REL[torch.bfloat16] * top,
              f"path R: layer 0's attention backward {name}: max abs err "
              f"{err} > 2e-2 * {top}")
    shape = tuple(kept["args"][0].shape)
    del kept, want
    print(f"path R: one make_train_step step launched {one}: "
          f"flash_attention twice a layer (forward and remat), "
          f"flash_attention_bwd once; loss {float(m['loss'])!r}; layer 0's "
          f"real q/k/v/O/dO {shape} through the backward kernel vs its "
          f"plain version, max abs err / max |want|: "
          + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
          + " (bound 2e-2)", flush=True)
    # the state goes in through a box: a name of this frame holding the
    # old state would keep 28 GB alive beside the next step's two
    box = [state]
    del state
    state, step_ms = train_timed(
        "R", f"make_train_step, full width, {nl} layer ({n_params} "
        f"parameters), vocabulary {cfg.vocab_size}, bfloat16, bf16 moments",
        step, box.pop(), bt, profile=True)
    del state, step, bt
    read_path("R")
    for name in ("flash_attention", "flash_attention_bwd"):
        check(per_path["R"].get(name, 0) > 0, f"path R did not launch "
              f"{name}")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"path R: {time.perf_counter() - t_path:.1f} s", flush=True)
    return times


def mixtral_mesh_path(dev, errs, per_path, read_path, smi,
                      at_l: dict) -> None:
    """Main path S (phase 26): Mixtral-8x22B served expert-parallel, path
    L's config and requests (full width, ``MIXTRAL_LAYERS`` layers, the
    same seeded weights; 4 requests of 512/384/256/128 tokens, 32 new)
    under ``make_host_mesh((1, 4))`` on ``Topology.full_mesh(4)``: each
    of the 4 model rows runs its 2 experts on views of the weights, and
    each MoE layer's combine is one psum through the mesh's session
    (``ring_allgather`` once a layer a prefill and a decode step). The
    counted run of :func:`serve_requests` (every counter set to 0 just
    before), the token and captured-decode checks of
    :func:`program_checks` under the mesh, layer 0's expert-parallel MoE
    output against ``moe_apply``'s within 2e-2 of the largest |want|, the
    combine's ms a layer and its device ms by kernel (profiler), and
    :func:`serving_times` beside path L's ``at_l``."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    from repro_torch.models import layers
    from repro_torch.models import moe as moe_lib
    from repro_torch.models import moe_dist
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import ServeEngine

    # -- 26. main path S: Mixtral-8x22B served expert-parallel ---------------
    t_path = time.perf_counter()
    cfg = dataclasses.replace(get_config("mixtral_8x22b"),
                              num_layers=MIXTRAL_LAYERS)
    params = init_model(cfg, dev, "S")
    mesh = make_host_mesh((1, 4), device=dev)
    topo = mesh.session.topology
    model = mesh.shape["model"]
    check(topo.num_devices == 4 and len(topo.links) == len(
        type(topo).full_mesh(4).links) and cfg.num_experts % model == 0,
          f"path S: {mesh} is not expert parallel on full_mesh(4)")
    views, shared = 0, True
    for i in range(cfg.num_layers):
        mp = tfm.layer_params(params, i)["moe"]
        for r in range(model):
            for name, w in moe_dist._row_weights(mp, r, ep=True,
                                                 model=model).items():
                views += w.numel() * w.element_size()
                shared &= (w.untyped_storage().data_ptr()
                           == mp[name].untyped_storage().data_ptr())
    check(shared, "path S: a row's expert weights are not views")
    tok_gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, cfg.vocab_size, (n,),
                             generator=tok_gen).tolist()
               for n in (512, 384, 256, 128)]
    new = 32
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with set_mesh(mesh):
        engine = ServeEngine(cfg, params, max_len=1024, kv_chunks=4)
        toks, outs, logits, cache, gen_s = serve_requests(
            cfg, engine, prompts, new, "S", per_path, read_path)
        nl = cfg.num_layers
        rings = per_path["S"].get("ring_allgather", 0)
        check(rings == nl * (2 * new + 1), f"path S launched "
              f"ring_allgather {rings} times, not once a MoE layer a "
              f"forward ({nl} x {2 * new + 1})")
        program_checks(cfg, engine, toks, outs, "S")
        b, plen = toks.shape
        lp = tfm.layer_params(params, 0)
        x = layers.rms_norm(params["embed"][toks], lp["ln2"]).reshape(
            b * plen, cfg.d_model)
        kw = dict(top_k=cfg.top_k, kind=cfg.mlp, dropless=True)
        got, _ = moe_dist.moe_apply_dist(x, lp["moe"], **kw)
        want, _ = moe_lib.moe_apply(x, lp["moe"], **kw)
        err = (got.float() - want.float()).abs().max().item()
        top = want.float().abs().max().item()
        check(err <= 2e-2 * top, f"path S: layer 0's expert-parallel MoE "
              f"output: max abs err {err} > 2e-2 * {top}")
        dist_ms = cuda_time_ms(lambda: moe_dist.moe_apply_dist(
            x, lp["moe"], **kw), 3, warmup=1)
        one_ms = cuda_time_ms(lambda: moe_lib.moe_apply(
            x, lp["moe"], **kw), 3, warmup=1)
        coll = mesh.session.collectives
        rows_p = torch.randn(model, b * plen, cfg.d_model, device=dev).to(
            x.dtype)
        rows_d = torch.randn(model, b, cfg.d_model, device=dev).to(x.dtype)
        comb_p = cuda_time_ms(lambda: coll.psum(rows_p), 10)
        comb_d = cuda_time_ms(lambda: coll.psum(rows_d), 10)
        _, comb_dev, _, comb_rows = profile_device_ms(
            lambda: coll.psum(rows_p), top=None)
        dt = str(x.dtype)[6:]
        del x, got, want, rows_p, rows_d
        print(f"path S: under {mesh} (session on {topo.name}), expert "
              f"parallel, {cfg.num_experts // model} experts a row: layer "
              f"0's MoE on its prefill's normed embeddings "
              f"({b * plen} tokens) vs moe_apply: max abs err {err} (max "
              f"|want| {top}, bound 2e-2 of it); the layer {dist_ms:.2f} ms "
              f"against moe_apply's {one_ms:.2f} ms; the combine (one "
              f"session psum of ({model}, {b * plen}, {cfg.d_model}) "
              f"{dt}) {comb_p:.4f} ms "
              f"a layer in prefill, of ({model}, {b}, {cfg.d_model}) "
              f"{comb_d:.4f} ms a layer a decode step; ring_allgather "
              f"launched {rings} times in the counted run; the rows' "
              f"expert weights are views: 0 B copied (copies would take "
              f"{views / 1e9:.2f} GB)", flush=True)
        print(f"path S: the prefill combine's device ms by kernel "
              f"(profiler, one psum): {comb_dev:.4f} ms in all; "
              + top_ops([(kernel_name(k), ms, c) for k, ms, c in comb_rows]),
              flush=True)
        at_s = serving_times(cfg, engine, None, toks, logits, cache, new,
                             gen_s, "S")
        at_s["decode_step_ms"] = replay_times(engine, toks, logits, new)[1]
        dec = decode_logits(engine, toks, logits)
    del engine, cache
    gc.collect()
    torch.cuda.empty_cache()
    print(f"path S vs path L (no mesh), Mixtral-8x22B over {nl} layers: "
          f"prefill replay {at_s['prefill_ms']:.2f} ms vs "
          f"{at_l['prefill_ms']:.2f}; captured decode step "
          f"{at_s['decode_ms']:.2f} ms vs {at_l['decode_ms']:.2f} (eager "
          f"{at_s['eager_decode_ms']:.2f} vs "
          f"{at_l['eager_decode_ms']:.2f}); peak {at_s['peak_gib']:.2f} GiB "
          f"vs {at_l['peak_gib']:.2f} ({time.perf_counter() - t_path:.1f} "
          f"s)", flush=True)
    peer_mesh_path(dev, per_path, read_path, cfg, params, prompts, new,
                   (toks, outs, logits, dec), at_s)
    del params, logits, dec
    gc.collect()
    torch.cuda.empty_cache()


def decode_logits(engine, toks, logits) -> torch.Tensor:
    """A copy of the logits of one decode program step after the prefill
    program's run on ``toks``, its token the argmax of the prefill's last
    ``logits``."""
    b, plen = toks.shape
    prefill = engine.prefill_program(b, plen)
    prefill.tokens.copy_(toks)
    prefill()
    decode = engine.decode_program(b)
    decode.tokens.copy_(logits[:, -1].argmax(-1)[:, None])
    decode.cur_len.fill_(plen)
    return decode().clone()


def replay_times(engine, toks, logits, new) -> tuple[float, float]:
    """The prefill program's replay ms on ``toks`` and the captured decode
    step's (``new - 1`` greedy steps after it, the argmax included, the
    better of two runs), by CUDA events."""
    b, plen = toks.shape
    prefill = engine.prefill_program(b, plen)
    prefill.tokens.copy_(toks)
    prefill_ms = cuda_time_ms(prefill, 3, warmup=1)
    decode = engine.decode_program(b)
    runs = []
    for _ in range(2):
        prefill()
        tok = logits[:, -1].argmax(-1)[:, None]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for i in range(new - 1):
            decode.tokens.copy_(tok)
            decode.cur_len.fill_(plen + i)
            tok = decode().argmax(-1)[:, None]
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) / (new - 1))
    return prefill_ms, min(runs)


def peer_mesh_path(dev, per_path, read_path, cfg, params, prompts, new,
                   at_s_out: tuple, at_s: dict) -> None:
    """Main path Y (phase 32, run right after path S on its weights):
    Mixtral-8x22B served expert parallel on a peer mesh on the one card
    (module docstring). ``at_s_out`` is path S's (tokens, generate's
    outputs, prefill logits, decode logits), ``at_s`` its times."""
    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    from repro_torch.serving import ServeEngine

    # -- 32. main path Y: Mixtral-8x22B expert parallel on a peer mesh ------
    t_path = time.perf_counter()
    toks_s, outs_s, logits_s, dec_s = at_s_out
    nl = cfg.num_layers
    mesh = make_host_mesh((1, 4), devices=[dev] * 4)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with set_mesh(mesh):
        engine = ServeEngine(cfg, params, max_len=1024, kv_chunks=4)
        (tree,) = engine.trees
        views = all(a.untyped_storage().data_ptr()
                    == b.untyped_storage().data_ptr()
                    for a, b in zip(_leaves(tree), _leaves(params)))
        check(views and engine.cards == (dev,), "path Y: the placed tree "
              "is not views of path S's weights on the one card")
        toks, outs, logits, _, gen_s = serve_requests(
            cfg, engine, prompts, new, "Y", per_path, read_path)
        rings = per_path["Y"].get("ring_allgather", 0)
        shifts = per_path["Y"].get("multipath_dma", 0)
        check(rings == nl * (2 * new + 1), f"path Y launched "
              f"ring_allgather {rings} times, not once a MoE layer a "
              f"forward ({nl} x {2 * new + 1})")
        check(shifts == 3 * rings, f"path Y launched multipath_dma "
              f"{shifts} times, not three ring shifts a combine")
        dec = decode_logits(engine, toks, logits)
        same = {"tokens": outs == outs_s and torch.equal(toks, toks_s),
                "prefill logits": torch.equal(logits, logits_s),
                "decode logits": torch.equal(dec, dec_s)}
        print(f"path Y: under {mesh} on a peer session of 4 logical "
              f"devices on {dev} (one graph a program), the tree views of "
              f"path S's weights; bit for bit path S's: {same}; "
              f"ring_allgather {rings} launches (one a MoE layer a "
              f"forward), multipath_dma {shifts} (three ring shifts a "
              f"combine)", flush=True)
        check(all(same.values()), f"path Y differs from path S: {same}")
        program_checks(cfg, engine, toks, outs, "Y")
        prefill_ms, decode_ms = replay_times(engine, toks, logits, new)
        graphs = engine.graph_bytes()
        del engine, tree
    peak = torch.cuda.max_memory_allocated() / 2**30
    gen1_s, gen2_s = gen_s
    b = toks.shape[0]
    print(f"path Y vs path S (stacked mesh), Mixtral-8x22B over {nl} "
          f"layers: prefill replay {prefill_ms:.2f} ms vs "
          f"{at_s['prefill_ms']:.2f}; captured decode step "
          f"{decode_ms:.2f} ms vs {at_s['decode_step_ms']:.2f} (CUDA "
          f"events, {new - 1} steps, the better of two runs each); "
          f"generate of {b} x {new} tokens {gen2_s:.3f} s = "
          f"{b * new / gen2_s:.1f} tokens/s (second call; first "
          f"{gen1_s:.3f} s); the graphs hold {graphs / 2**30:.2f} GiB; "
          f"peak {peak:.2f} GiB vs {at_s['peak_gib']:.2f} "
          f"({time.perf_counter() - t_path:.1f} s)", flush=True)


#: Phase T's probes: (name, arch, kind, batch, seq, vocabulary cut or
#: None, host mesh shape or None, the kernels it must launch). Each runs
#: at L = 0 and L = 1 at full width, in a shape and cut an earlier path
#: uses: T1 path E's longest prompt, T2 path R, T3 path M's RWKV-6 step
#: (its full vocabulary), T4 path S's mesh.
PROBES = (
    ("T1", "llama3_8b", "prefill", 4, 512, None, None,
     ("flash_attention",)),
    ("T2", "nemotron_4_340b", "train", TRAIN_BATCH, TRAIN_SEQ,
     NEMOTRON_TRAIN_VOCAB, None, ("flash_attention", "flash_attention_bwd")),
    ("T3", "rwkv6_1_6b", "train", TRAIN_BATCH, TRAIN_SEQ, None, None,
     ("rwkv6_scan", "rwkv6_scan_bwd")),
    ("T4", "mixtral_8x22b", "prefill", 4, 512, None, (1, 4),
     ("flash_attention", "ring_allgather")),
)
#: Calls timed a probe (after one warm-up call).
PROBE_CALLS = 3
#: The measured peak must lie within this band of the meta count's
#: (arguments + peak live bytes), plus :data:`PROBE_PEAK_SLACK` for the
#: allocator's rounding and the libraries' workspaces.
PROBE_PEAK_BAND = (0.9, 1.2)
PROBE_PEAK_SLACK = 1 << 30


def probe_args(cfg, kind: str, batch: int, seq: int, dev, seed: int):
    """Seeded arguments on the card for a probe's step, the shapes and
    dtypes of its meta arguments: a train state and a batch, or the
    parameters and the prompt tokens."""
    from repro_torch.launch.specs import optim_for
    from repro_torch.models import transformer as tfm
    from repro_torch.training import init_state

    gen = torch.Generator(device=dev).manual_seed(seed)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=dev, dtype=torch.int32)
    if kind == "prefill":
        return [tfm.init_params(cfg, generator=gen, device=dev),
                {"tokens": tokens}]
    labels = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=dev, dtype=torch.int32)
    state = init_state(cfg, optim_for(cfg), generator=gen, device=dev)
    return [state, {"tokens": tokens, "labels": labels,
                    "mask": torch.ones((batch, seq), device=dev)}]


def probe_step(cell, args: list, kind: str):
    """One call of the cell's step on ``args``; a train step's new state
    replaces the old in ``args`` (the caller holds no other name on it,
    so the old is freed as the next step makes its own)."""
    if kind == "train":
        state = args.pop(0)
        new, _ = cell.fn(state, *args)
        del state
        args.insert(0, new)
        return None
    return cell.fn(*args)


def dryrun_probes_path(dev, errs, per_path, read_path, smi) -> None:
    """Main path T (phase 27): the dry-run's probes measured at full
    width. For each probe of :data:`PROBES` at L = 0 and L = 1: its cell
    (``launch.specs.input_specs``) counted once on meta tensors and once
    on the card's (``launch.cost``), which must agree in FLOPs, bytes,
    collective records, kernel calls and peak live bytes; the kernel
    calls the card's count records equal to the launch counters' rise;
    the step timed without the counter (one warm-up call, then
    :data:`PROBE_CALLS` calls on the host clock ending in a synchronize);
    the count's bound (the larger of FLOPs at 989 TFLOP/s and bytes at
    3.35 TB/s) against the measured ms, at most 100%; the measured peak
    within :data:`PROBE_PEAK_BAND` of the meta count's, plus
    :data:`PROBE_PEAK_SLACK`; the layer's increment (L1 − L0) counted and
    measured. Every launch counter is set to 0 before the path and read
    after it."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.kernels._graph import launch_counts, reset_launch_counts
    from repro_torch.launch import cost
    from repro_torch.launch.mesh import (LogicalMesh, make_host_mesh,
                                         set_mesh)
    from repro_torch.launch.specs import input_specs

    # -- 27. main path T: the dry-run's probes on the card ---------------
    t_path = time.perf_counter()
    reset_launch_counts()
    for (name, arch, kind, batch, seq, vocab, mesh_shape,
         want_kernels) in PROBES:
        full = get_config(arch)
        mesh = (make_host_mesh(mesh_shape, device=dev) if mesh_shape
                else LogicalMesh(("data", "model"), (1, 1)))
        ambient = mesh if mesh_shape else None
        shape = ShapeConfig(name, seq, batch, kind)
        at = {}
        for layers in (0, 1):
            cfg = dataclasses.replace(full, num_layers=layers)
            if vocab:
                cfg = dataclasses.replace(cfg, vocab_size=vocab)
            cell = input_specs(cfg, shape, mesh)
            with set_mesh(ambient):
                _, on_meta = cost.count(cell.fn, *cell.abstract_args)
            gc.collect()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            args = probe_args(cfg, kind, batch, seq, dev, 27 + layers)
            # one card holds every logical device's rows: whole arguments
            argument = sum(t.numel() * t.element_size()
                           for a in args for t in _leaves(a))
            with set_mesh(ambient):
                c0 = launch_counts()
                with cost.CostCounter() as counter:
                    probe_step(cell, args, kind)
                torch.cuda.synchronize()
                launched = {k: v - c0[k] for k, v in launch_counts().items()
                            if v != c0[k]}
                on_card = counter.cost
                probe_step(cell, args, kind)
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
                for _ in range(PROBE_CALLS):
                    probe_step(cell, args, kind)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3 / PROBE_CALLS
            peak = torch.cuda.max_memory_allocated() - base
            del args
            gc.collect()
            torch.cuda.empty_cache()
            check(on_meta.key() == on_card.key(),
                  f"path {name} L={layers}: the meta count {on_meta} "
                  f"differs from the card's {on_card}")
            check(launched == on_card.kernels,
                  f"path {name} L={layers}: the count's kernel calls "
                  f"{on_card.kernels} are not the launches {launched}")
            if layers:
                for k in want_kernels:
                    check(launched.get(k, 0) > 0, f"path {name} L=1 did "
                          f"not launch {k}: {launched}")
            flops_ms = on_meta.flops / BF16_FLOPS_PER_S * 1e3
            bytes_ms = on_meta.bytes / HBM_BYTES_PER_S * 1e3
            bound = max(flops_ms, bytes_ms)
            share = bound / ms
            check(share <= 1.0, f"path {name} L={layers}: the count's "
                  f"bound {bound:.4f} ms exceeds the measured {ms:.4f} ms: "
                  f"the count left out work")
            predicted = argument + on_meta.peak_bytes
            lo, hi = PROBE_PEAK_BAND
            check(lo * predicted <= peak <= hi * predicted
                  + PROBE_PEAK_SLACK,
                  f"path {name} L={layers}: measured peak {peak} B outside "
                  f"[{lo}, {hi}] x the predicted {predicted} B (+ "
                  f"{PROBE_PEAK_SLACK} B)")
            at[layers] = (on_meta, ms)
            coll = ", ".join(f"{op} {rb} B over {n}" for op, rb, n in
                             sorted(set(on_meta.collectives))) or "none"
            print(f"path {name} ({smi}): {cfg.name} {kind} "
                  f"({batch} x {seq}) at L={layers}"
                  + (f", vocabulary {cfg.vocab_size}" if vocab else "")
                  + (f", under {mesh}" if mesh_shape else "")
                  + f": counted {on_meta.flops} FLOPs, {on_meta.bytes} B "
                  f"(meta = card: FLOPs, bytes, {len(on_meta.collectives)} "
                  f"collective records ({coll}), kernel calls "
                  f"{on_meta.kernels}, peak live bytes); bound "
                  f"{bound:.4f} ms by "
                  f"{'operations' if flops_ms >= bytes_ms else 'bytes'} "
                  f"(FLOPs {flops_ms:.4f} ms, bytes {bytes_ms:.4f} ms); "
                  f"measured {ms:.4f} ms a call ({PROBE_CALLS} calls, host "
                  f"clock): {share:.1%} of bound; peak {peak / 2**30:.3f} "
                  f"GiB measured (max_memory_allocated) vs "
                  f"{predicted / 2**30:.3f} GiB predicted (arguments "
                  f"{argument / 2**30:.3f} + the count's peak live "
                  f"{on_meta.peak_bytes / 2**30:.3f})", flush=True)
        (c0_, ms0), (c1_, ms1) = at[0], at[1]
        df, db = c1_.flops - c0_.flops, c1_.bytes - c0_.bytes
        dbound = max(df / BF16_FLOPS_PER_S, db / HBM_BYTES_PER_S) * 1e3
        print(f"path {name}: the layer's increment (L1 - L0): counted {df} "
              f"FLOPs, {db} B, bound {dbound:.4f} ms; measured "
              f"{ms1 - ms0:.4f} ms"
              + (f" ({dbound / (ms1 - ms0):.1%} of bound)"
                 if ms1 > ms0 else ""), flush=True)
        del mesh, ambient
    read_path("T")
    print(f"path T: {time.perf_counter() - t_path:.1f} s", flush=True)


def peer_path(dev, per_path, read_path, at_a: dict) -> None:
    """Main path U (phase 28): a peer session on the one card, four
    logical devices each with its own buffers, held bit for bit to the
    stacked session and to the plain table, timed against it. ``at_a``:
    path A's times (``replay256_ms``)."""
    from repro_torch.comm import CommSession
    from repro_torch.core.halo import jacobi_step
    from repro_torch.kernels._graph import reset_launch_counts
    from repro_torch.kernels.multipath_dma import kernel as dk

    gen = torch.Generator(device=dev).manual_seed(28)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    big = randn(1 << 26)                                  # 256 MiB f32
    small = randn(16 * 1024)                              # 64 KiB
    mid = big[: 16 * MiB]                                 # 64 MiB
    quarter = [randn(4 * MiB) for _ in range(4)]          # 16 MiB each
    ranks, rows, cols, iters = 4, 8, 1 << 22, 10
    u0 = randn(ranks, rows, cols)

    def traffic(sess, blocks):
        out = [sess.send(big, 0, 1, max_paths=3),
               sess.send(big, 0, 1, max_paths=3), sess.send(small, 0, 1)]
        out += sess.bidirectional(mid, 0, 2, max_paths=3)
        out += sess.exchange([(quarter[i], i, (i + 1) % 4)
                              for i in range(4)], max_paths=3)
        for _ in range(iters):
            blocks = jacobi_step(blocks, session=sess)
        return out, blocks

    stacked = CommSession(schedule="auto", device=dev)
    want, want_u = traffic(stacked, u0)
    torch.cuda.synchronize()
    peer = CommSession(schedule="auto", devices=[dev] * 4)
    reset_launch_counts()
    t0 = time.perf_counter()
    got, got_u = traffic(peer, list(u0.unbind(0)))
    torch.cuda.synchronize()
    drive_s = time.perf_counter() - t0
    read_path("U")
    check(per_path["U"].get("multipath_dma", 0) > 0
          and per_path["U"].get("jacobi", 0) > 0,
          "path U did not launch multipath_dma and jacobi")
    check(peer.stats()["devices"] == [str(dev)] * 4,
          "peer session does not list its devices")
    names = ("send 256 MiB", "send 256 MiB again", "send 64 KiB",
             "bidirectional fwd", "bidirectional rev") + tuple(
                 f"exchange {i}->{(i + 1) % 4}" for i in range(4))
    msgs = [big, big, small, mid, mid] + quarter
    for name, g, w, m in zip(names, got, want, msgs):
        check(torch.equal(g, w) and torch.equal(g, m),
              f"path U {name} differs from the stacked session's")
    check(all(torch.equal(a, b) for a, b in zip(got_u, want_u.unbind(0))),
          "path U Jacobi differs from the stacked jacobi_step")
    pentries = [e for _, e in peer.engine._fastpath._store.values()]
    for e in pentries:
        prog = e.compiled.program
        check(isinstance(prog, dk.PeerDmaProgram),
              "path U program is not a PeerDmaProgram")
        check(prog.completed_nodes() == e.graph.num_copy_nodes,
              f"path U completed {prog.completed_nodes()} of "
              f"{e.graph.num_copy_nodes} copy nodes")
        check(prog.replay_launches == {"multipath_dma": 1},
              f"path U replay launches {prog.replay_launches}")
        plain_y = [torch.zeros_like(y) for y in prog.y]
        plain_stage = [torch.empty_like(st) for st in prog.stage]
        prog.replay()
        dk.run_node_table_plain(prog.table.items, prog.x, plain_y,
                                plain_stage)
        check(all(torch.equal(a, b) for a, b in zip(prog.y, plain_y)),
              f"path U program {e.key.entries} differs from the plain "
              f"table")
        del plain_y, plain_stage
    print(f"path U: {len(pentries)} programs (256 MiB and 64 KiB sends, "
          f"bidirectional, 4-message exchange, Jacobi halos) bitwise equal "
          f"to the stacked session's and to the plain table, completed = "
          f"copy nodes, 1 multipath_dma launch a replay; Jacobi "
          f"{ranks}x({rows},{cols}) {iters} iterations bitwise the stacked "
          f"jacobi_step; drive {drive_s:.2f} s (first calls capture)",
          flush=True)

    def program(sess, nelems):
        return next(e.compiled.program
                    for _, e in sess.engine._fastpath._store.values()
                    if e.key.entries == ((0, 1, nelems, "float32"),))

    sp, pp = program(stacked, big.numel()), program(peer, big.numel())
    reads, writes = pp.table.bytes_moved()
    bound = (reads + writes) / HBM_BYTES_PER_S * 1e3
    times = {}
    for label, prog in (("stacked", sp), ("peer", pp), ("peer", pp),
                        ("stacked", sp)):
        times.setdefault(label, []).append(cuda_time_ms(prog.replay, 20))
    small_t = {}
    for label, sess in (("stacked", stacked), ("peer", peer),
                        ("peer", peer), ("stacked", stacked)):
        small_t.setdefault(label, []).append(host_time_ms(
            lambda: sess.send(small, 0, 1), 100, warmup=5))
    blocks = list(u0.unbind(0))
    jac_t = {}
    for label, sess, u in (("stacked", stacked, u0), ("peer", peer, blocks),
                           ("peer", peer, blocks),
                           ("stacked", stacked, u0)):
        jac_t.setdefault(label, []).append(host_time_ms(
            lambda: jacobi_step(u, session=sess), 10))
    print(f"path U 256 MiB send 0->1 3 paths: peer replay "
          f"{times['peer'][0]:.4f} / {times['peer'][1]:.4f} ms, stacked "
          f"{times['stacked'][0]:.4f} / {times['stacked'][1]:.4f} ms "
          f"(in turns; path A's {at_a['replay256_ms']:.4f}), bound "
          f"{bound:.4f} ms ({reads} B read + {writes} B written at 3.35 "
          f"TB/s); 64 KiB session.send synced: peer {small_t['peer'][0]:.2f}"
          f" / {small_t['peer'][1]:.2f} ms, stacked "
          f"{small_t['stacked'][0]:.2f} / {small_t['stacked'][1]:.2f} ms; "
          f"Jacobi iteration synced: peer {jac_t['peer'][0]:.4f} / "
          f"{jac_t['peer'][1]:.4f} ms, stacked {jac_t['stacked'][0]:.4f} / "
          f"{jac_t['stacked'][1]:.4f} ms", flush=True)


def peer_collectives_path(dev, per_path, read_path, at_b: dict) -> None:
    """Main path V (phase 29): the collectives of a peer session on the
    one card, four logical devices each with its own buffers, held bit for
    bit to the stacked session and every peer ring program to its plain
    version, launches counted, timed against the stacked session. ``at_b``:
    path B's times (``ag_replay256_ms``)."""
    from repro_torch.comm import CommSession
    from repro_torch.comm.session import PeerCollectiveProgram
    from repro_torch.kernels._graph import reset_launch_counts
    from repro_torch.kernels.multipath_dma import kernel as dk
    from repro_torch.kernels.ring_allgather import kernel as rk

    gen = torch.Generator(device=dev).manual_seed(29)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    nd = 4
    big = randn(nd * 2048, 8192)                          # 256 MiB f32
    mid = randn(nd * 512, 8192)                           # 64 MiB f32
    odd = randn(4097, 4095)                               # 64 MiB, pads
    a2a = randn(nd * nd, 1 << 20)                         # 64 MiB f32
    calls = [("all_gather", big), ("all_gather", big),
             ("reduce_scatter", mid), ("all_reduce", mid), ("psum", odd),
             ("all_to_all", a2a),
             ("all_gather", randn(nd * 4096, 7, dtype=torch.bfloat16)),
             ("all_gather", randn(nd * 4096, 1, dtype=torch.bfloat16))]
    rows = randn(nd, 1024, 2048)                          # 8 MiB a row
    lists = [("all_gather", rows), ("reduce_scatter", rows),
             ("all_reduce", rows), ("psum", rows[:, :999, :7]),
             ("pmean", rows), ("all_to_all", rows[:, :nd])]
    stacked = CommSession(schedule="auto", device=dev)
    want = [getattr(stacked, op)(x) for op, x in calls]
    want_c = [getattr(stacked.collectives, op)(x) for op, x in lists]
    torch.cuda.synchronize()
    peer = CommSession(schedule="auto", devices=[dev] * nd)
    reset_launch_counts()
    t0 = time.perf_counter()
    got = [getattr(peer, op)(x) for op, x in calls]
    got_c = [getattr(peer.collectives, op)(list(x.unbind(0)))
             for op, x in lists]
    torch.cuda.synchronize()
    drive_s = time.perf_counter() - t0
    read_path("V")
    for (op, x), g, w in zip(calls, got, want):
        check(g.device == dev and torch.equal(g, w),
              f"path V session.{op} {tuple(x.shape)} {x.dtype} differs from "
              f"the stacked session's")
    for (op, x), g, w in zip(lists, got_c, want_c):
        check(len(g) == nd and torch.equal(torch.stack(g), w),
              f"path V session.collectives.{op} {tuple(x.shape)} differs "
              f"from the stacked session's")
    stats = peer.stats()
    check(stats["dispatches"] == len(calls) + len(lists)
          and stats["cache"]["hits"] == 1,
          f"path V: {stats['dispatches']} dispatches, "
          f"{stats['cache']['hits']} cache hits for {len(calls)} "
          f"driver-level calls (one repeat) and {len(lists)} list calls")
    # Launches, one a card (here one card) a ring shift or gather: a
    # program (driver-level or a list call's; pmean runs psum's) runs at
    # its warm-up, at compile_plan's first replay and once a call.
    expect = {"multipath_dma": 0, "ring_allgather": 0}
    rings = []
    for compiled in peer.cache.values():
        prog = compiled.program
        check(isinstance(prog, PeerCollectiveProgram),
              "path V program is not a PeerCollectiveProgram")
        for name, k in prog.replay_launches.items():
            expect[name] += k * (2 + compiled.lifecycle.launches)
        shifts = sum(isinstance(p, dk.PeerDmaProgram)
                     for p in prog.ring.programs)
        check(prog.replay_launches.get("multipath_dma", 0) == shifts
              and prog.replay_launches.get("ring_allgather", 0)
              == len(prog.ring.programs) - shifts,
              f"path V program launches {prog.replay_launches} a replay, "
              f"not one a ring shift or gather")
        rings.append(prog.ring)
    check(per_path["V"] == expect,
          f"path V launches {per_path['V']}, expected {expect} (one a card "
          f"a ring shift or gather)")
    gathers = 0
    for ring in rings:
        for p in ring.programs:
            if isinstance(p, rk.PeerRingProgram):
                plain = rk.ring_allgather_peer_plain(p.x)
                check(all(torch.equal(a, b) for a, b in zip(p.out, plain)),
                      f"path V peer ring {p.geometry} differs from "
                      f"ring_allgather_peer_plain")
                check(p.completed_items() == p.geometry.num_items,
                      f"path V peer ring completed {p.completed_items()} of "
                      f"{p.geometry.num_items} items")
                gathers += 1
    print(f"path V: {len(calls)} driver-level calls (256 MiB all_gather "
          f"twice, the second a cache hit; 64 MiB reduce_scatter, "
          f"all_reduce, psum of (4097, 4095), all_to_all; bf16 all_gather "
          f"f = 7 and f = 1) and {len(lists)} session.collectives calls on "
          f"lists bitwise the stacked session's; {gathers} peer ring "
          f"programs bitwise ring_allgather_peer_plain, completed = items; "
          f"launches {per_path['V']} as counted (one a card a shift or a "
          f"gather); drive {drive_s:.2f} s (first calls capture)",
          flush=True)

    def program(sess, op, shape):
        for key, compiled in zip(sess.cache.keys(), sess.cache.values()):
            k = getattr(key, "key", key)
            if k.op == op and compiled.program.inputs():
                x = compiled.program.inputs()[0]
                local = tuple((x[0] if isinstance(x, list) else x).shape)
                if local[-1] == shape[-1]:
                    return compiled.program
        raise KeyError(op)

    shard = 2048 * 8192 * 4
    ag_bound = (nd + nd * nd) * shard / HBM_BYTES_PER_S * 1e3
    ring = program(peer, "all_gather", big.shape).ring.programs[0]
    kernel_ms = cuda_time_ms(ring.run, 20)
    plain_ms = cuda_time_ms(lambda: rk.ring_allgather_peer_plain(ring.x), 5,
                            warmup=1)
    print(f"path V peer ring_allgather (4 x (2048, 8192) f32 on one card, "
          f"its resident program): kernel {kernel_ms:.4f} ms, bound "
          f"{ag_bound:.4f} ms ((n + n^2) S at 3.35 TB/s, "
          f"{ag_bound / kernel_ms:.1%} of it), ring_allgather_peer_plain "
          f"{plain_ms:.4f} ms", flush=True)
    def resident_mib(prog, d):
        # logical device d's static buffers: the input and every step's
        bufs = [prog.x]
        for p in prog.ring.programs:
            bufs += ([p.x, p.y, p.stage] if isinstance(p, dk.PeerDmaProgram)
                     else [p.x, p.out])
        return sum(b[d].numel() * b[d].element_size() for b in bufs) / MiB

    ar = program(peer, "all_reduce", mid.shape)
    print(f"path V 64 MiB all_reduce program: static buffers a logical "
          f"device {[round(resident_mib(ar, d), 2) for d in range(nd)]} MiB "
          f"(input, 3 ring shifts, the gather)", flush=True)
    times = {}
    for op, shape in (("all_gather", big.shape), ("all_reduce", mid.shape)):
        sp, pp = program(stacked, op, shape), program(peer, op, shape)
        for label, prog in (("stacked", sp), ("peer", pp), ("peer", pp),
                            ("stacked", sp)):
            times.setdefault((op, label), []).append(
                cuda_time_ms(prog.replay, 20))
    print(f"path V 256 MiB all_gather replay: peer "
          f"{times['all_gather', 'peer'][0]:.4f} / "
          f"{times['all_gather', 'peer'][1]:.4f} ms, stacked "
          f"{times['all_gather', 'stacked'][0]:.4f} / "
          f"{times['all_gather', 'stacked'][1]:.4f} ms (in turns; path B's "
          f"{at_b['ag_replay256_ms']:.4f}), one-card bound {ag_bound:.4f} ms "
          f"((n + n^2) S at 3.35 TB/s); 64 MiB all_reduce replay: peer "
          f"{times['all_reduce', 'peer'][0]:.4f} / "
          f"{times['all_reduce', 'peer'][1]:.4f} ms, stacked "
          f"{times['all_reduce', 'stacked'][0]:.4f} / "
          f"{times['all_reduce', 'stacked'][1]:.4f} ms", flush=True)


def plain_run_matches(items, xs, ys, stage) -> bool:
    """A per-device table's output against its plain version on the same
    operands: every byte range the table writes is zeroed in a copy of
    ``ys`` (one byte buffer a logical device; ``xs`` may be the same
    buffers), the plain version runs on that copy (reading ``xs``, or the
    copy where the operand is the output) with fresh staging, and the
    copy must equal ``ys``."""
    from repro_torch.kernels.multipath_dma import kernel as dk

    same = all(x is y for x, y in zip(xs, ys))
    want = [y.clone() for y in ys]
    for row in items[items[:, dk.C_DST_SPACE] == dk.SPACE_OUT].tolist():
        off, nb = row[dk.C_DST_OFF], row[dk.C_NBYTES]
        want[row[dk.C_DST_DEV]][off:off + nb].zero_()
    dk.run_node_table_plain(items, want if same else xs, want,
                            [torch.empty_like(st) for st in stage])
    torch.cuda.synchronize()
    return all(torch.equal(a, b) for a, b in zip(want, ys))


def peer_capture_path(dev, errs, per_path, read_path, at_c: dict) -> None:
    """Main path W (phase 30): whole-iteration capture on a peer session
    on the one card, each step held to the same step on the stacked
    session (bitwise, attention at path F's tolerance), one dispatch a
    call, every copy-run table and collective node against its plain
    version, launches as the programs count them, the Jacobi and decode
    replays timed against the stacked ones. ``at_c``: path C's captured
    Jacobi (``jacobi_replay_ms``)."""
    from repro_torch.comm import CommSession, captured_psum
    from repro_torch.comm.capture import PeerCopyRun, PeerNode
    from repro_torch.core.halo import make_captured_jacobi_step
    from repro_torch.kernels._graph import reset_launch_counts
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.multipath_dma.ops import (
        captured_multipath_dma, multipath_dma_transfer)
    from repro_torch.kernels.ring_allgather import kernel as rk
    from repro_torch.kernels.ring_allgather import ops as rops
    from repro_torch.serving.engine import make_captured_decode_step

    gen = torch.Generator(device=dev).manual_seed(30)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    n, rows, cols, iters = 4, 8, 1 << 22, 10
    g_rows, p_elems, d_elems = 512, 1 << 22, 1 << 22
    heads, kv_len, hd = 32, 2048, 128
    kv_chunk = 2 * 8 * kv_len * hd                        # 8 MiB bf16
    u0 = randn(n, rows, cols)                             # path C's
    gx = randn(n, g_rows, 8192)                           # path D's
    px = randn(n, p_elems)                                # 16 MiB rows
    dx = randn(n, d_elems)                                # phase 23's
    q, k, v = (randn(n, 1, heads, kv_len, hd).to(torch.bfloat16)
               for _ in range(3))
    kv = randn(n, kv_chunk).to(torch.bfloat16)

    def gather_scale(cap):
        g = rops.captured_ring_allgather(
            cap, cap.input((g_rows, 8192), torch.float32), n)
        return cap.kernel(lambda t: t * 0.5 + 1.0, g, name="scale")

    def psum(cap):
        return captured_psum(cap, cap.input((p_elems,), torch.float32), n,
                             name="psum")

    def steps(sess):
        plan = sess.plan(0, 2, d_elems * 4, max_paths=3, num_chunks=4,
                         granularity=4)

        def dma(cap):
            y = captured_multipath_dma(
                cap, cap.input((d_elems,), torch.float32), plan, n)
            (r,) = cap.exchange([(y, 2, 1)])
            return cap.kernel(lambda t: t * 0.5 - 1.0, r, name="affine")

        return {"jacobi": make_captured_jacobi_step(sess, rows, cols),
                "gather": sess.capture(gather_scale),
                "psum": sess.capture(psum),
                "decode": make_captured_decode_step(
                    sess, batch=1, heads=heads, kv_len=kv_len, head_dim=hd,
                    kv_chunk=kv_chunk, src=0, dst=2, dtype=torch.bfloat16,
                    schedule="overlap"),
                "dma": sess.capture(dma)}, plan

    def drive(st, split) -> dict:
        u = split(u0)
        for _ in range(iters):
            (u,) = st["jacobi"](u)
        (g,) = st["gather"](split(gx))
        (ps,) = st["psum"](split(px))
        attn, new_kv = st["decode"](*(split(t) for t in (q, k, v, kv)))
        (y,) = st["dma"](split(dx))
        return {"jacobi": u, "gather": g, "psum": ps, "attn": attn,
                "kv": new_kv, "dma": y}

    stacked = CommSession(schedule="auto", device=dev)
    sst, plan = steps(stacked)
    want = drive(sst, lambda t: t)
    torch.cuda.synchronize()
    peer = CommSession(schedule="auto", devices=[dev] * n)
    pst, _ = steps(peer)
    t0 = time.perf_counter()
    entries = {name: step.resolve() for name, step in pst.items()}
    torch.cuda.synchronize()
    resolve_s = time.perf_counter() - t0
    for name, step in pst.items():
        a, b = sst[name].resolve(), entries[name]
        check((a.digest, a.key) == (b.digest, b.key),
              f"path W {name}: digest or GroupKey differs from the stacked "
              f"session's")
    d0 = peer.stats()["dispatches"]
    reset_launch_counts()
    got = drive(pst, lambda t: list(t.unbind(0)))
    torch.cuda.synchronize()
    read_path("W")
    calls = {"jacobi": iters, "gather": 1, "psum": 1, "decode": 1, "dma": 1}
    check(peer.stats()["dispatches"] - d0 == sum(calls.values()),
          f"path W took {peer.stats()['dispatches'] - d0} dispatches for "
          f"{sum(calls.values())} calls")
    expect: dict[str, int] = {}
    for name, e in entries.items():
        prog = e.compiled.program
        for kname, count in prog.replay_launches.items():
            expect[kname] = expect.get(kname, 0) + count * calls[name]
    check(per_path["W"] == expect, f"path W launches {per_path['W']}, "
          f"expected {expect} from the programs' replays")
    jprog = entries["jacobi"].compiled.program
    druns = len(jprog.copy_runs)
    check(jprog.replay_launches == {"jacobi": n, "multipath_dma": druns},
          f"path W Jacobi replay launches {jprog.replay_launches}, expected "
          f"{n} jacobi (one a logical device) and {druns} multipath_dma "
          f"(one a copy run on the one card)")
    for name in ("jacobi", "gather", "psum", "kv", "dma"):
        check(all(torch.equal(a, b) for a, b in
                  zip(got[name], want[name].unbind(0))),
              f"path W {name} differs from the stacked session's")
    errw, ok = bf16_err(torch.stack(got["attn"]), want["attn"])
    check(ok, f"path W attention: max abs err {errw} against the stacked "
          f"step, beyond {BF16_ATOL} + {BF16_RTOL} * |want|")
    q4, k4, v4 = (t.view(n, heads, kv_len, hd) for t in (q, k, v))
    errp, ok = bf16_err(torch.stack(got["attn"]).view(n, heads, kv_len, hd),
                        fk.flash_attention_plain(q4, k4, v4))
    errs["flash_attention"] = max(errs["flash_attention"], errp)
    check(ok, f"path W attention: max abs err {errp} against the plain "
          f"version")
    expect_kv = kv.clone()
    expect_kv[2] = kv[0]
    check(torch.equal(torch.stack(got["kv"]), expect_kv),
          "path W: the KV chunk did not land bitwise on device 2")
    moved = multipath_dma_transfer(dx, plan)
    check(torch.equal(torch.stack(got["dma"])[1], moved[2] * 0.5 - 1.0),
          "path W captured multipath_dma step differs from the eager "
          "composition")
    tables = nodes = 0
    for name, e in entries.items():
        prog = e.compiled.program
        for w in prog.walk:
            if isinstance(w, PeerCopyRun):
                check(plain_run_matches(w.table.items, prog.arenas,
                                        prog.arenas, prog.stages),
                      f"path W {name}: a copy run differs from its plain "
                      f"table")
                tables += 1
            elif isinstance(w, PeerNode):
                wp = w.program
                if isinstance(wp, rk.PeerRingProgram):
                    ok = all(torch.equal(a, b) for a, b in zip(
                        wp.out, rk.ring_allgather_peer_plain(wp.x)))
                else:
                    ok = plain_run_matches(wp.table.items, wp.x, wp.y,
                                           wp.stage)
                check(ok, f"path W {name}: the {w.node.kernel} node differs "
                      f"from its plain version")
                nodes += 1
    print(f"path W: captured Jacobi (10 iterations of {n}x({rows},{cols}) "
          f"f32), captured all-gather + compute, captured_psum of {n}x"
          f"{p_elems} f32, the decode step ({n}x(1, {heads}, {kv_len}, {hd}) "
          f"bf16 + {kv_chunk * 2 / MiB:.0f} MiB KV chunk 0->2, overlap) and "
          f"the captured multipath_dma step on CommSession(devices=[{dev}] "
          f"* {n}): bitwise the stacked session's (attention max abs err "
          f"{errw} against it, {errp} against plain), digests and keys "
          f"equal, one dispatch a call, {tables} copy-run tables and "
          f"{nodes} collective nodes equal to their plain versions; replay "
          f"launches: " + ", ".join(
              f"{name} {e.compiled.program.replay_launches}"
              for name, e in entries.items())
          + f"; resolve (build + capture) {resolve_s:.2f} s", flush=True)

    times: dict[str, list] = {}
    for label, e in (("stacked", sst["jacobi"].resolve()),
                     ("peer", entries["jacobi"]),
                     ("peer", entries["jacobi"]),
                     ("stacked", sst["jacobi"].resolve())):
        times.setdefault(label, []).append(
            cuda_time_ms(e.compiled.program.replay, 20))
    dtimes: dict[str, list] = {}
    for label, e in (("stacked", sst["decode"].resolve()),
                     ("peer", entries["decode"]),
                     ("peer", entries["decode"]),
                     ("stacked", sst["decode"].resolve())):
        dtimes.setdefault(label, []).append(
            cuda_time_ms(e.compiled.program.replay, 10))
    print(f"path W captured Jacobi iteration replay (CUDA events): peer "
          f"{times['peer'][0]:.4f} / {times['peer'][1]:.4f} ms, stacked "
          f"{times['stacked'][0]:.4f} / {times['stacked'][1]:.4f} ms (in "
          f"turns; path C's replay {at_c['jacobi_replay_ms']:.4f}); "
          f"decode step replay: peer {dtimes['peer'][0]:.4f} / "
          f"{dtimes['peer'][1]:.4f} ms, stacked {dtimes['stacked'][0]:.4f} "
          f"/ {dtimes['stacked'][1]:.4f} ms; walks: Jacobi "
          f"{[type(w).__name__ for w in jprog.walk]}, decode "
          f"{[type(w).__name__ for w in entries['decode'].compiled.program.walk]}",
          flush=True)


def same_tree(a, b) -> bool:
    """Every leaf of ``a`` bit for bit the leaf of ``b`` (dtypes equal)."""
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def in_turns(fns: dict, order: tuple, time_fn) -> dict:
    """``time_fn(fns[label])`` for each label of ``order`` (stacked, peer,
    peer, stacked): label -> its readings in call order."""
    out: dict[str, list] = {}
    for label in order:
        out.setdefault(label, []).append(time_fn(fns[label]))
    return out


def turns_text(times: dict) -> str:
    return ", ".join(f"{k} " + " / ".join(f"{v:.2f}" for v in vs)
                     for k, vs in times.items())


#: Path X's order of timed runs: the stacked session, the peer session
#: twice, the stacked session again.
TURNS = ("stacked", "peer", "peer", "stacked")


def peer_training_path(dev, errs, per_path, read_path, smi) -> None:
    """Main path X (phase 31): the training side on a peer session on the
    one card, ``CommSession(devices=["cuda:0"] * 4)``, each part held bit
    for bit to the same call on the stacked session, run first (and not
    counted), then with every counter set to 0 just before the peer run
    and read just after it: X1 path J's DP step and captured DP step at
    full width, 2 layers, float32 (TF32 off), one step from one tree (the
    captured step's every replica against the stacked step's state; one
    dispatch; the launches of a call its program's replay launches), and
    one more captured call from the per-device replicas against the
    stacked step fed its own state; X2 the eager
    DP step at 32 layers in bfloat16, one step from ``replicate_state``;
    X3 path Q's ``compressed_psum_tree`` over SmolLM-360M's leaves and
    ``compressed_psum_with_feedback`` at its embedding leaf, on per-device
    lists; X4 path P's pipeline of Llama-3 8B (4 stages placed one a
    logical device, 8 microbatches of (1, 2048), the planner's split),
    one exchange dispatch a tick and one for the surfacing psum. Then
    times in turns against the stacked session's (host clock, synced):
    the eager step at 32 layers, the captured step at 2 layers in
    bfloat16 (the two arenas do not fit the card together: each built,
    timed and freed in turn, its arena printed) and the pipeline call."""
    import dataclasses
    import math

    from repro_torch.comm import CommSession
    from repro_torch.configs import get_config
    from repro_torch.core.topology import Topology
    from repro_torch.data import DataConfig, SyntheticDataset, batch_to
    from repro_torch.kernels._graph import launch_counts, reset_launch_counts
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

    # -- 31. main path X: training on a peer session --------------------------
    t_path = time.perf_counter()
    n = 4
    full = get_config("smollm_360m")
    ts = TrainStepConfig()
    opt = OptimConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)

    def batches(cfg, count):
        ds = SyntheticDataset(cfg, DataConfig(seq_len=TRAIN_SEQ,
                                              global_batch=TRAIN_BATCH))
        return [batch_to(ds.batch_at(i), dev) for i in range(count)]

    def fresh(cfg, seed):
        return init_state(cfg, opt, generator=torch.Generator(
            device=dev).manual_seed(seed), device=dev)

    def free():
        gc.collect()
        torch.cuda.empty_cache()

    # X1: the DP steps at full width, 2 layers, float32
    cfg32 = dataclasses.replace(full, num_layers=2, dtype="float32")
    (batch,) = batches(cfg32, 1)
    state = fresh(cfg32, 51)
    stacked = CommSession(device=dev)
    want_eager, want_em = make_dp_train_step(cfg32, ts, opt, stacked)(
        state, batch)
    scap = make_captured_dp_train_step(cfg32, ts, opt, stacked, state, batch)
    want_one, want_cm = scap(state, batch)
    want_two, _ = scap(want_one, batch)
    s_entry = scap.capture.resolve()
    s_key = (s_entry.digest, s_entry.key)
    s_arena = arena_bytes(scap.capture.capture)
    del scap, s_entry, stacked
    free()
    peer = CommSession(devices=[dev] * n)
    reset_launch_counts()
    reps, em = make_dp_train_step(cfg32, ts, opt, peer)(state, batch)
    check(all(same_tree(r, want_eager) for r in reps)
          and all(torch.equal(em[k], want_em[k]) for k in want_em),
          "path X1: the peer eager DP step differs from the stacked one")
    del reps, want_eager
    pcap = make_captured_dp_train_step(cfg32, ts, opt, peer, state, batch)
    entry = pcap.capture.resolve()
    c0, d0 = launch_counts(), peer.stats()["dispatches"]
    rows, cm = pcap(state, batch)
    torch.cuda.synchronize()
    call_launches = {k: v - c0[k] for k, v in launch_counts().items()
                     if v != c0[k]}
    one_dispatch = peer.stats()["dispatches"] - d0 == 1
    again, _ = pcap(rows, batch)                 # each replica fed back
    torch.cuda.synchronize()
    read_path("X1")
    check(all(math.isfinite(float(r["params"]["final_norm"].sum()))
              for r in again), "path X1: a fed-back replica is not finite")
    check(all(same_tree(r, want_two) for r in again),
          "path X1: a fed-back captured replica differs from the stacked "
          "step fed its own state")
    del again, want_two
    check(all(same_tree(r, want_one) for r in rows),
          "path X1: a captured replica differs from the stacked step")
    check(all(torch.equal(cm[k], want_cm[k]) for k in want_cm),
          "path X1: the captured step's metrics differ from the stacked "
          "step's")
    check((entry.digest, entry.key) == s_key,
          "path X1: digest or GroupKey differs from the stacked step's")
    check(one_dispatch, "path X1: the captured call is not one dispatch")
    prog = entry.compiled.program
    check(call_launches == prog.replay_launches,
          f"path X1: a captured call launched {call_launches}, its program "
          f"replays {prog.replay_launches}")
    print(f"path X1 ({smi}): SmolLM-360M full width, 2 layers, float32, "
          f"TF32 off, {TRAIN_BATCH} x {TRAIN_SEQ} tokens on "
          f"CommSession(devices=[{dev}] * {n}): the eager DP step's {n} "
          f"replicas bitwise the stacked step's state, metrics equal; the "
          f"captured step's {n} replicas bitwise the stacked step's state "
          f"(a tree-ordered psum), metrics equal, digest and GroupKey the "
          f"stacked step's, one dispatch a call, launches a call "
          f"{call_launches} = its program's replay launches; arena "
          f"{s_arena / 1e9:.2f} GB, over {n} logical devices; a second "
          f"call fed the {n} replicas back bitwise the stacked step fed "
          f"its own state; launches {per_path['X1']}",
          flush=True)
    del state, pcap, entry, prog, rows, want_one, peer, batch
    free()

    # X2: the eager DP step at 32 layers, bfloat16
    bts = batches(full, 3)
    state = fresh(full, 52)
    stacked = CommSession(device=dev)
    sstep = make_dp_train_step(full, ts, opt, stacked)
    want, want_m = sstep(state, bts[0])
    peer = CommSession(devices=[dev] * n)
    pstep = make_dp_train_step(full, ts, opt, peer)
    reps = replicate_state(state, peer)
    torch.cuda.synchronize()
    reset_launch_counts()
    got, m = pstep(reps, bts[0])
    torch.cuda.synchronize()
    read_path("X2")
    check(all(same_tree(r, want) for r in got)
          and all(torch.equal(m[k], want_m[k]) for k in want_m),
          "path X2: the peer eager DP step at 32 layers differs from the "
          "stacked one")
    del got, want
    eager_ms = in_turns(
        {"stacked": lambda: sstep(state, bts[1]),
         "peer": lambda: pstep(reps, bts[1])},
        TURNS, lambda fn: host_time_ms(fn, 2, warmup=1))
    print(f"path X2 ({smi}): the eager DP step, SmolLM-360M full width, "
          f"32 layers, bfloat16, {TRAIN_BATCH} x {TRAIN_SEQ} tokens: the "
          f"{n} replicas bitwise the stacked step's; ms a step in turns "
          f"(host clock, synced, mean of 2): {turns_text(eager_ms)}; "
          f"launches {per_path['X2']}", flush=True)
    del state, reps, sstep, pstep, stacked, peer
    free()

    cfg2 = dataclasses.replace(full, num_layers=2)
    state = fresh(cfg2, 53)
    bts2 = batches(cfg2, 3)

    def captured_ms(label):
        sess = (CommSession(device=dev) if label == "stacked"
                else CommSession(devices=[dev] * n))
        step = make_captured_dp_train_step(cfg2, ts, opt, sess, state,
                                           bts2[0])
        t0 = time.perf_counter()
        step.capture.resolve()
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        ms = host_time_ms(lambda: step(state, bts2[1]), 3, warmup=1)
        peak = torch.cuda.max_memory_allocated() / 2**30
        del step, sess
        free()
        torch.cuda.reset_peak_memory_stats()
        return ms, build_s, peak

    cap_ms = in_turns({k: k for k in ("stacked", "peer")}, TURNS,
                      captured_ms)
    print(f"path X2 ({smi}): the captured DP step, full width, 2 layers, "
          f"bfloat16 (each arena built, timed and freed in turn: they do "
          f"not fit the card together): ms a step (host clock, synced, "
          f"mean of 3), build s, peak GiB: " + "; ".join(
              f"{k} " + " / ".join(f"{ms:.2f} ms, {b:.1f} s, {p:.1f} GiB"
                                   for ms, b, p in vs)
              for k, vs in cap_ms.items()), flush=True)
    del state, bts2, bts
    free()

    # X3: the compressed mean on per-device lists
    gen = torch.Generator(device=dev).manual_seed(54)
    grads = tree_map(lambda t: torch.randn((n,) + tuple(t.shape),
                                           generator=gen, device=dev)
                     .mul_(0.01), param_shapes(full))
    stacked = CommSession(device=dev, topology=Topology.full_mesh(n))
    peer = CommSession(devices=[dev] * n)
    want = comp.compressed_psum_tree(grads, stacked)
    eg = grads["embed"]
    res = torch.randn(eg.shape, generator=gen, device=dev) * 1e-3
    want_fb = comp.compressed_psum_with_feedback(eg, res, stacked)
    members = [tree_map(lambda g, d=d: g[d].clone(), grads)
               for d in range(n)]
    del grads
    torch.cuda.synchronize()
    reset_launch_counts()
    got = comp.compressed_psum_tree(members, peer)
    got_fb = comp.compressed_psum_with_feedback(
        [m["embed"] for m in members], list(res.unbind(0)), peer)
    torch.cuda.synchronize()
    read_path("X3")
    check(all(same_tree(g, tree_map(lambda t, d=d: t[d], want))
              for d, g in enumerate(got)),
          "path X3: the peer compressed mean differs from the stacked one")
    check(all(torch.equal(a, b) for out, w in zip(got_fb, want_fb)
              for a, b in zip(out, w.unbind(0))),
          "path X3: the peer feedback variant differs from the stacked one")
    tree_ms = host_time_ms(lambda: comp.compressed_psum_tree(members, peer),
                           2, warmup=1)
    pmean_ms = host_time_ms(lambda: [peer.collectives.pmean(list(r))
                                     for r in zip(*map(_leaves, members))],
                            2, warmup=1)
    print(f"path X3 ({smi}): compressed_psum_tree over "
          f"{len(_leaves(members[0]))} leaves of smollm_360m x {n} members "
          f"and compressed_psum_with_feedback at the {tuple(eg.shape[1:])} "
          f"embedding leaf on per-device lists: bitwise the stacked forms' "
          f"rows; {tree_ms:.2f} ms a tree, the peer pmean of the same "
          f"lists {pmean_ms:.2f} ms; launches {per_path['X3']}", flush=True)
    del want, want_fb, members, got, got_fb, eg, res, stacked, peer
    free()

    # X4: the pipeline of Llama-3 8B, a stage a logical device
    p, m, s = PIPE_STAGES, PIPE_MICRO, PIPE_SEQ
    cfg = get_config("llama3_8b")
    gen = torch.Generator(device=dev).manual_seed(0)
    params = {"layers": tfm.block_init(cfg, generator=gen, device=dev,
                                       lead=(cfg.num_layers,))}
    x = torch.randn(m, 1, s, cfg.d_model, generator=gen, device=dev).mul_(
        cfg.d_model ** -0.5).to(torch.bfloat16)
    positions = torch.arange(s, device=dev)
    stage_fn = make_block_stage_fn(cfg, p, positions)
    stages = block_stages(params, p)
    stacked = CommSession(device=dev, topology=Topology.full_mesh(p))
    peer = CommSession(devices=[dev] * p)
    placed = place_stages(stages, peer)
    ticks = m + p - 1
    with torch.no_grad():
        want = pipeline_apply(stage_fn, stages, x, microbatches=m,
                              multipath=True, session=stacked)
        torch.cuda.synchronize()
        d0 = peer.stats()["dispatches"]
        reset_launch_counts()
        got = pipeline_apply(stage_fn, placed, x, microbatches=m,
                             multipath=True, session=peer)
        torch.cuda.synchronize()
        read_path("X4")
        disp = peer.stats()["dispatches"] - d0
        check(torch.equal(got, want), "path X4: the peer pipeline differs "
              "from the stacked one")
        check(disp == ticks + 1, f"path X4: {disp} dispatches, want {ticks} "
              f"handoffs and the surfacing psum")
        check(per_path["X4"].get("flash_attention", 0)
              == ticks * cfg.num_layers,
              f"path X4: flash_attention launched "
              f"{per_path['X4'].get('flash_attention', 0)} times, want "
              f"{ticks * cfg.num_layers}")
        pipe_ms = in_turns(
            {"stacked": lambda: pipeline_apply(
                stage_fn, stages, x, microbatches=m, multipath=True,
                session=stacked),
             "peer": lambda: pipeline_apply(
                 stage_fn, placed, x, microbatches=m, multipath=True,
                 session=peer)},
            TURNS, lambda fn: host_time_ms(fn, 1, warmup=0))
    print(f"path X4 ({smi}): Llama-3 8B, {cfg.num_layers} layers in {p} "
          f"stages placed a logical device, {m} microbatches of (1, {s}), "
          f"the planner's split: bitwise the stacked session's pipeline, "
          f"{disp} dispatches ({ticks} handoffs and the surfacing psum); ms "
          f"a call in turns (host clock, synced): {turns_text(pipe_ms)}; "
          f"launches {per_path['X4']}; path X "
          f"{time.perf_counter() - t_path:.1f} s", flush=True)
    del params, stages, placed, x, want, got, stacked, peer
    free()


#: Path Z's limits against the stacked mesh's step: the losses' relative
#: difference, and a parameter's largest difference over the stacked
#: update's largest |change| (over every leaf).
PEER_TRAIN_LOSS_RTOL = 1e-3
PEER_TRAIN_DELTA_SHARE = 2e-2


def peer_moe_training_path(dev, per_path, read_path, smi) -> dict:
    """Main path Z (phase 33): Mixtral-8x22B trained expert parallel on a
    peer mesh of four logical devices on the one card,
    ``make_host_mesh((1, 4), devices=["cuda:0"] * 4)``: full width,
    ``remat="full"``, bfloat16 with bfloat16 moments, at path M's depth
    and tokens (8 x 512), 2 steps of ``make_train_step`` from
    ``place_state`` (the card's tree views of the whole state), each MoE
    combine the card's share of one peer psum and its backward another
    (f and g), the clip norm one scalar psum a step. Held against the
    stacked mesh's ``make_train_step`` from the same seed and batches, run
    first (not counted; only its updated parameters and the largest
    |change| kept): losses within rtol 1e-3, every updated parameter
    within 2e-2 of the stacked update's largest |change|. Counters set to
    0 just before the peer steps and read just after them. Prints the
    largest errors, the step ms (host clock, synced), the peak GiB and the
    launches a step."""
    import dataclasses
    import math

    from repro_torch.configs import get_config
    from repro_torch.kernels._graph import reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    from repro_torch.optim import OptimConfig
    from repro_torch.training import (TrainStepConfig, init_state,
                                      make_train_step)
    from repro_torch.training.sharding import place_state, unplace_state

    # -- 33. main path Z: Mixtral-8x22B trained on a peer mesh --------------
    t_path = time.perf_counter()
    full = get_config("mixtral_8x22b")
    opt = OptimConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                      moment_dtype=full.optimizer_dtype)
    free = torch.cuda.mem_get_info()[0]
    need, _ = update_bytes(dataclasses.replace(full, num_layers=2), opt)
    layers = 2 if free - need >= 15e9 else 1         # path M's depth
    cfg = dataclasses.replace(full, num_layers=layers)
    check((cfg.remat, cfg.dtype, cfg.d_model, cfg.num_experts)
          == ("full", "bfloat16", 6144, 8), f"path Z: not Mixtral-8x22B "
          f"at full width: {cfg}")
    ts = TrainStepConfig()
    batches = family_batches(cfg, dev, 8, 512, 2)

    def fresh():
        return init_state(cfg, opt, generator=torch.Generator(
            device=dev).manual_seed(61), device=dev)

    def run(mesh, start) -> tuple[list, list, object]:
        """2 steps under ``mesh`` from ``start()``'s state (made here, so
        that each step's old state is freed as it is replaced)."""
        step = make_train_step(cfg, ts, opt, device=dev)
        losses, times = [], []
        state = start()
        with set_mesh(mesh):
            for bt in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, m = step(state, bt)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(m["loss"]))
                del m
        return losses, times, state

    # the stacked mesh's step, its update kept as parameters and |change|
    first = []

    def stacked_start():
        state = fresh()
        first.append(state["params"])
        return state

    want_losses, want_ms, got = run(make_host_mesh((1, 4), device=dev),
                                    stacked_start)
    want = got["params"]
    delta = max((a.float() - b.float()).abs().max().item()
                for a, b in zip(_leaves(want), _leaves(first[0])))
    del got, first
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # the peer mesh's step, counted
    mesh = make_host_mesh((1, 4), devices=[dev] * 4)

    def peer_start():
        state = fresh()
        trees = place_state(state, mesh, cfg)
        views = all(a.untyped_storage().data_ptr()
                    == b.untyped_storage().data_ptr()
                    for a, b in zip(_leaves(trees[0]), _leaves(state)))
        check(len(trees) == 1 and views, "path Z: the placed state is not "
              "one tree of views of the whole on the one card")
        torch.cuda.synchronize()
        reset_launch_counts()
        return trees

    losses, step_ms, trees = run(mesh, peer_start)
    read_path("Z")
    peak = torch.cuda.max_memory_allocated() / 2**30
    got = unplace_state(trees, mesh, cfg)["params"]
    del trees
    worst, where = 0.0, ""
    for i, (a, b) in enumerate(zip(_leaves(got), _leaves(want))):
        err = (a.float() - b.float()).abs().max().item()
        if err >= worst:
            worst, where = err, f"leaf {i} {tuple(b.shape)}"
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want_losses))
    bitwise = all(torch.equal(a, b) for a, b in zip(_leaves(got),
                                                    _leaves(want)))
    del got, want
    counts = {k: v / len(batches) for k, v in per_path["Z"].items()}
    print(f"path Z ({smi}): Mixtral-8x22B make_train_step under {mesh} on "
          f"a peer session of 4 logical devices on {dev}, full width, "
          f"{layers} of 56 layers, remat full, bfloat16, bfloat16 moments, "
          f"8 x 512 tokens, 2 steps from place_state: losses {losses} "
          f"(stacked mesh {want_losses}; largest relative difference "
          f"{loss_rel:.3g}, limit {PEER_TRAIN_LOSS_RTOL}); parameters' "
          f"largest difference {worst} ({where}) against the stacked "
          f"update's largest |change| {delta} (limit "
          f"{PEER_TRAIN_DELTA_SHARE} of it; bit for bit: {bitwise}); step "
          f"ms {[round(t, 2) for t in step_ms]} (stacked "
          f"{[round(t, 2) for t in want_ms]}; host clock, synced, the "
          f"first with the ring's programs built); peak {peak:.2f} GiB; "
          f"launches a step {counts} ({time.perf_counter() - t_path:.1f} "
          f"s)", flush=True)
    check(loss_rel <= PEER_TRAIN_LOSS_RTOL and all(
        math.isfinite(x) for x in losses), f"path Z: losses {losses} vs "
          f"the stacked mesh's {want_losses}")
    check(worst <= PEER_TRAIN_DELTA_SHARE * delta, f"path Z: parameters "
          f"differ by {worst} ({where}), beyond {PEER_TRAIN_DELTA_SHARE} "
          f"of the stacked update's largest |change| {delta}")
    for name in ("multipath_dma", "ring_allgather", "flash_attention",
                 "flash_attention_bwd"):
        check(per_path["Z"].get(name, 0) > 0,
              f"path Z did not launch {name}")
    return {"layers": layers, "step_ms": step_ms, "peak_gib": peak,
            "launches_a_step": counts}


def launched_digests(engine) -> list:
    """Record the digest of every entry ``engine`` launches (sends,
    groups, probes and captured steps) into the returned list."""
    log = []
    launch, launch_step = engine._launch, engine._launch_step

    def rec(entry, messages, *, block):
        log.append(entry.digest)
        return launch(entry, messages, block=block)

    def rec_step(entry, arrays, *, block):
        log.append(entry.digest)
        return launch_step(entry, arrays, block=block)

    engine._launch, engine._launch_step = rec, rec_step
    return log


class LockstepPair:
    """A peer session of four logical devices on the one card and a
    stacked session on it, the same configuration, driven in lockstep by
    path AA and compared after every operation."""

    def __init__(self, dev, **cfg):
        from repro_torch.comm import CommConfig, CommSession

        self.peer = CommSession(CommConfig(**cfg), devices=[dev] * 4)
        self.stacked = CommSession(CommConfig(**cfg), device=dev)
        self.logs = [launched_digests(s.engine)
                     for s in (self.peer, self.stacked)]
        self.events: list = []

    @property
    def both(self):
        return (self.peer, self.stacked)

    def mutate(self, method: str, *args) -> None:
        for sess in self.both:
            getattr(sess.topology, method)(*args)

    def compare(self, what: str) -> None:
        """The two sessions' health, events, launched digests, quarantine
        and cache statistics equal; every peer cache key placed."""
        from repro_torch.comm.engine import PlacedKey

        p, s = (sess.stats() for sess in self.both)
        check(p["health"] == s["health"], f"path AA {what}: health "
              f"{p['health']} on peers, {s['health']} stacked")
        check(p["cache"] == s["cache"], f"path AA {what}: cache "
              f"{p['cache']} on peers, {s['cache']} stacked")
        pev, sev = (sess.drain_health_events() for sess in self.both)
        check(pev == sev, f"path AA {what}: events {pev} on peers, {sev} "
              f"stacked")
        self.events += pev
        check(self.logs[0] == self.logs[1], f"path AA {what}: launched "
              f"digests differ")
        check(self.peer.planner.quarantined
              == self.stacked.planner.quarantined,
              f"path AA {what}: quarantine sets differ")
        check(all(isinstance(k, PlacedKey)
                  for k in self.peer.engine.cache._store),
              f"path AA {what}: a peer plan-cache key is not a PlacedKey")

    def send(self, x, src: int, dst: int, what: str, **kw) -> list:
        outs = [sess.send(x, src, dst, **kw) for sess in self.both]
        torch.cuda.synchronize()
        check(all(torch.equal(o, x) for o in outs),
              f"path AA {what}: a send not bitwise")
        self.compare(what)
        return outs


def timed_sends(pair, x, what: str, **kw) -> list:
    """One lockstep send of ``x`` 0->1, each layout's own: host ms
    (synced), its sample's plan + lower + schedule and capture ms, and
    the backoff it slept."""
    rows = []
    sleep = time.sleep
    outs = []
    for sess in pair.both:
        slept = []

        def timed_sleep(seconds):         # the engine's backoff sleeps
            s0 = time.perf_counter_ns()
            sleep(seconds)
            slept.append(time.perf_counter_ns() - s0)

        torch.cuda.synchronize()
        time.sleep = timed_sleep
        try:
            t0 = time.perf_counter()
            outs.append(sess.send(x, 0, 1, **kw))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3
        finally:
            time.sleep = sleep
        st = sess.telemetry.samples()[-1].stages
        rows.append({"host_ms": wall,
                     "plan_ms": (st.plan_ns + st.lower_ns
                                 + st.schedule_ns) / 1e6,
                     "capture_ms": st.compile_ns / 1e6,
                     "backoff_ms": sum(slept) / 1e6})
    check(all(torch.equal(o, x) for o in outs),
          f"path AA {what}: a send not bitwise")
    pair.compare(what)
    return rows


def send_entry(sess, nelems: int, max_paths):
    """The fast-path entry of the session's float32 send of ``nelems``
    0->1 with ``max_paths`` (read without touching its counters)."""
    for sig, (_, entry) in sess.engine._fastpath._store.items():
        if sig[1] == ((0, 1, nelems, "float32"),) and sig[4] == max_paths:
            return entry
    raise KeyError((nelems, max_paths))


def split_text(rows) -> str:
    return " / ".join(f"{r['host_ms']:.3f} ms ({r['plan_ms']:.3f} + "
                      f"{r['capture_ms']:.3f} + {r['backoff_ms']:.3f})"
                      for r in rows)


def peer_health_path(dev, errs, per_path, read_path, smi: str) -> dict:
    """Main path AA (phase 34): the §4.6 ladder on a peer session of four
    logical devices on the one card, in lockstep with a stacked session,
    read with the counters set to 0 just before it. Returns its
    readings."""
    from repro_torch.kernels._graph import reset_launch_counts
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.serving import make_captured_decode_step

    # -- 34. main path AA: the health ladder on a peer session ----------------
    reset_launch_counts()
    g = torch.Generator(device=dev).manual_seed(34)
    big = torch.randn(1 << 26, generator=g, device=dev)      # 256 MiB f32
    nbytes = big.numel() * 4
    out: dict = {}

    # 1. a mid-traffic failure of (0, 1), its restore and readmission
    pair = LockstepPair(dev, telemetry=True)
    pre = [s.describe(0, 1, nbytes, max_paths=3)["graph"]["digest"]
           for s in pair.both]
    check(pre[0] == pre[1], "path AA: pre-fault digests differ")
    rows = []
    for i in range(10):
        if i == 3:
            pair.mutate("fail_link", 0, 1)
        if i == 6:
            pair.mutate("restore_link", 0, 1)
            links = [(0, 1), (2, 1), (3, 0)]
            for sess in pair.both:
                for link in links:
                    sess.monitor.quarantine_link(link, reason="droop")
            pair.compare("quarantine")
            sweeps = 0
            while pair.peer.planner.quarantined and sweeps < 10:
                verdicts = [s.probe_links() for s in pair.both]
                torch.cuda.synchronize()
                check(verdicts[0] == verdicts[1], f"path AA: probe "
                      f"verdicts {verdicts[0]} on peers, {verdicts[1]} "
                      f"stacked")
                pair.compare(f"probe sweep {sweeps}")
                sweeps += 1
            check(not pair.peer.planner.quarantined, "path AA: the "
                  "quarantined links were not readmitted")
            post = [s.describe(0, 1, nbytes, max_paths=3)["graph"]["digest"]
                    for s in pair.both]
            check(post == pre, "path AA: the post-readmit digest is not "
                  "the pre-fault one")
        cache0 = pair.peer.stats()["cache"]
        row = timed_sends(pair, big, f"send {i}", max_paths=3)
        cache1 = pair.peer.stats()["cache"]
        rows.append((i, row, cache1["misses"] - cache0["misses"]))
        level = pair.peer.stats()["health"]["ladder_level"]
        check(level == (1 if 3 <= i < 6 else 0),
              f"path AA: send {i} at ladder level {level}")
        entry = send_entry(pair.peer, big.numel(), 3)
        if 3 <= i < 6:
            check(all((0, 1) not in p.directional_links()
                      for p in entry.plans),
                  f"path AA: send {i} routed over the failed (0, 1)")
        if i in (2, 5):
            sentry = send_entry(pair.stacked, big.numel(), 3)
            times = {}
            for label, e in (("peer", entry), ("stacked", sentry),
                             ("stacked", sentry), ("peer", entry)):
                times.setdefault(label, []).append(
                    cuda_time_ms(e.compiled.program.replay, 20))
            out["healthy" if i == 2 else "fault"] = {
                "paths": [pa.route.via for pa in entry.plans[0].paths],
                "replay_ms": times}
        if i == 6:
            check(cache1["misses"] == cache0["misses"]
                  and cache1["hits"] == cache0["hits"] + 1,
                  "path AA: the readmitted send was not a plan-cache hit")
    small = big[:256]
    cache0 = pair.peer.stats()["cache"]
    pair.send(small, 0, 1, "the probed plan's send", max_paths=1)
    cache1 = pair.peer.stats()["cache"]
    check(cache1["misses"] == cache0["misses"]
          and cache1["hits"] == cache0["hits"] + 1,
          "path AA: the send of the probed plan was not a plan-cache hit")
    out["midtraffic"] = [{"send": i, "peer": r[0], "stacked": r[1],
                          "new_captures": n} for i, r, n in rows]
    out["probe_sweeps"] = sweeps
    h, f = out["healthy"], out["fault"]
    print(f"path AA ({smi}): 256 MiB sends 0->1, 3 paths, on a peer "
          f"session of 4 logical devices and a stacked session in "
          f"lockstep, (0, 1) failed before send 3 and restored before send "
          f"6, then (0, 1), (2, 1), (3, 0) quarantined and readmitted after "
          f"{sweeps} probe sweeps (a probe of each, peer and stacked "
          f"verdicts equal), the pre-fault digest back as a plan-cache hit "
          f"and the probed 1 KiB plan's send a hit: every output bitwise, "
          f"health, events, launched digests and cache statistics equal, "
          f"every peer cache key a PlacedKey; per send, peer / stacked, "
          f"host ms synced (plan+lower+schedule + capture + backoff): "
          + "; ".join(f"{i}: {split_text(r)}, {n} new" for i, r, n in rows)
          + f"; replay (CUDA events, in turns) healthy via {h['paths']} "
          f"peer {h['replay_ms']['peer']} stacked "
          f"{h['replay_ms']['stacked']} ms, under the fault via "
          f"{f['paths']} peer {f['replay_ms']['peer']} stacked "
          f"{f['replay_ms']['stacked']} ms", flush=True)
    del pair, entry, sentry
    gc.collect()
    torch.cuda.empty_cache()

    # 2. the injected schedule, on both layouts
    spec = "drop@2x2:0-2;degrade@6x4:0-3*0.25;flap@12~2x2:0-1"
    pair = LockstepPair(dev, faults=spec, telemetry=True)
    m16 = big[: 4 * MiB]                                     # 16 MiB f32
    backoff = []
    for i in range(20):
        backoff.append(timed_sends(pair, m16, f"injected send {i}",
                                   max_paths=3))
    counts = []
    for sess in pair.both:
        h = sess.stats()["health"]
        counts.append({k: h[k] for k in ("retries", "replans",
                                         "faults_seen")})
    check(counts[0] == counts[1] == {"retries": 1, "replans": 1,
                                     "faults_seen": 7},
          f"path AA: the injected schedule gave {counts}, not the CPU's "
          f"retries 1, replans 1, faults_seen 7")
    kinds = [e["kind"] for e in pair.events]
    total = [sum(r[k]["host_ms"] for r in backoff) for k in (0, 1)]
    slept = [sum(r[k]["backoff_ms"] for r in backoff) for k in (0, 1)]
    setup = [sum(r[k]["plan_ms"] for r in backoff) for k in (0, 1)]
    capture = [sum(r[k]["capture_ms"] for r in backoff) for k in (0, 1)]
    out["injected"] = {"spec": spec, "counts": counts[0],
                       "host_ms": total, "backoff_ms": slept,
                       "plan_ms": setup, "capture_ms": capture,
                       "captures": pair.peer.stats()["cache"]["misses"]}
    print(f"path AA ({smi}): {spec!r}, 20 sends of 16 MiB in lockstep, all "
          f"bitwise, health, events, digests and caches equal: "
          f"{counts[0]}, {pair.peer.stats()['cache']['misses']} captures; "
          f"peer / stacked ms in all {total[0]:.3f} / {total[1]:.3f}, of it "
          f"backoff {slept[0]:.3f} / {slept[1]:.3f}, plan+lower+schedule "
          f"{setup[0]:.3f} / {setup[1]:.3f}, capture {capture[0]:.3f} / "
          f"{capture[1]:.3f}; events {kinds}", flush=True)
    del pair
    gc.collect()
    torch.cuda.empty_cache()

    # 3. the host relay: every device link into 1 failed
    pair = LockstepPair(dev)
    for src in (0, 2, 3):
        pair.mutate("fail_link", src, 1)
    pair.send(big, 0, 1, "the host relay", max_paths=3)
    check(pair.peer.stats()["health"]["ladder_level"] == 3,
          "path AA: the relay did not leave ladder level 3")
    check([e["kind"] for e in pair.events].count("host_relay") == 1,
          "path AA: not one host_relay event a layout")
    relay = {}
    for label, sess in (("peer", pair.peer), ("stacked", pair.stacked),
                        ("stacked", pair.stacked), ("peer", pair.peer)):
        relay.setdefault(label, []).append(host_time_ms(
            lambda: sess.send(big, 0, 1, max_paths=3), 5, warmup=1))
    pair.compare("relays")
    out["relay"] = {"ms": relay, "gbps": {
        k: [nbytes / t / 1e6 for t in v] for k, v in relay.items()}}
    print(f"path AA ({smi}): host relay of 256 MiB 0->1, bitwise, one "
          f"host_relay event a layout, equal health: ms synced in turns "
          f"peer {[round(t, 3) for t in relay['peer']]}, stacked "
          f"{[round(t, 3) for t in relay['stacked']]}; GB/s of message "
          f"peer {[round(x, 2) for x in out['relay']['gbps']['peer']]}, "
          f"stacked {[round(x, 2) for x in out['relay']['gbps']['stacked']]}",
          flush=True)
    del pair
    gc.collect()
    torch.cuda.empty_cache()

    # 4. path F's captured decode step through a failure of (0, 2)
    pair = LockstepPair(dev)
    n = 4
    heads, kv_len, hd = 32, 2048, 128
    kv_chunk = 2 * 8 * kv_len * hd
    kw = dict(batch=1, heads=heads, kv_len=kv_len, head_dim=hd,
              kv_chunk=kv_chunk, src=0, dst=2, dtype=torch.bfloat16,
              schedule="overlap")
    steps = [make_captured_decode_step(s, **kw) for s in pair.both]
    q, k, v = (torch.randn((n, 1, heads, kv_len, hd), generator=g,
                           device=dev).to(torch.bfloat16) for _ in range(3))
    kv = torch.randn((n, kv_chunk), generator=g, device=dev).to(
        torch.bfloat16)
    q4, k4, v4 = (t.view(n, heads, kv_len, hd) for t in (q, k, v))
    want = fk.flash_attention_plain(q4, k4, v4)
    want_kv = kv.clone()
    want_kv[2] = kv[0]
    step_ms = {"peer": [], "stacked": []}
    for phase in ("healthy", "failed", "restored"):
        if phase == "failed":
            pair.mutate("fail_link", 0, 2)
        if phase == "restored":
            pair.mutate("restore_link", 0, 2)
        got = []
        for label, step, args in (
                ("peer", steps[0], [list(t.unbind(0))
                                    for t in (q, k, v, kv)]),
                ("stacked", steps[1], [q, k, v, kv])):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            attn, new_kv = step(*args)
            torch.cuda.synchronize()
            step_ms[label].append((time.perf_counter() - t0) * 1e3)
            if label == "peer":
                attn, new_kv = torch.stack(attn), torch.stack(new_kv)
            got.append((attn, new_kv))
        (pa, pkv), (sa, skv) = got
        check(torch.equal(pkv, skv) and torch.equal(pkv, want_kv),
              f"path AA: decode step ({phase}) KV chunk not bitwise")
        check(torch.equal(pa, sa), f"path AA: decode step ({phase}) "
              f"attention on peers not bitwise the stacked step's")
        for label, attn in (("peer", pa), ("stacked", sa)):
            err, ok = bf16_err(attn.view(n, heads, kv_len, hd), want)
            errs["flash_attention"] = max(errs["flash_attention"], err)
            check(ok, f"path AA: decode step ({phase}, {label}) attention "
                  f"max abs err {err}, beyond {BF16_ATOL} + {BF16_RTOL} * "
                  f"|want|")
        pair.compare(f"decode step ({phase})")
        entries = [s.resolve() for s in steps]
        check(entries[0].digest == entries[1].digest,
              f"path AA: decode step ({phase}) digests differ")
        if phase == "failed":
            for plan in entries[0].plans:
                check((0, 2) not in plan.directional_links(),
                      "path AA: the decode step routed over the failed "
                      "(0, 2)")
            fault_ms = cuda_time_ms(entries[0].compiled.program.replay, 10)
        if phase == "healthy":
            healthy_ms = cuda_time_ms(entries[0].compiled.program.replay,
                                      10)
    check(pair.peer.stats()["health"]["ladder_level"] == 1,
          "path AA: the decode step under the fault left no ladder level 1")
    out["decode"] = {"first_call_ms": step_ms,
                     "replay_ms": {"healthy": healthy_ms,
                                   "fault": fault_ms}}
    print(f"path AA ({smi}): path F's captured decode step through a "
          f"failure of (0, 2), peer (per-device lists) and stacked in "
          f"lockstep: KV chunk and attention bitwise the stacked step's, "
          f"attention within {BF16_ATOL} + {BF16_RTOL} * |want| of the "
          f"plain version, equal health, events, digests and caches; "
          f"first call healthy / failed / restored, peer "
          f"{[round(t, 3) for t in step_ms['peer']]} ms, stacked "
          f"{[round(t, 3) for t in step_ms['stacked']]} ms synced; the peer "
          f"replay (CUDA events) healthy {healthy_ms:.4f} ms, under the "
          f"fault {fault_ms:.4f} ms", flush=True)
    torch.cuda.synchronize()
    read_path("AA")
    for name in ("multipath_dma", "flash_attention"):
        check(per_path["AA"].get(name, 0) > 0,
              f"path AA did not launch {name}")
    out["launches"] = per_path["AA"]
    del pair, steps, q, k, v, q4, k4, v4, kv, want, want_kv, big, m16
    gc.collect()
    torch.cuda.empty_cache()
    return out


#: Path AB's emulated two-card layout on the one card: model-axis devices
#: 0 and 1 on one "card", 2 and 3 on the other.
AB_CARD_OF = (0, 0, 1, 1)


def tp_elements(cfg, cut) -> tuple[int, int]:
    """The elements of a decoder's tree under ``cut`` (a card's
    :class:`~repro_torch.models.tensor_parallel.DenseCut`), reckoned from
    the config alone, each cut dim at ``cut.part`` of its length: (those
    in the model's dtype: the matrices, Mamba's convolution; the float32
    ones: the norms, RWKV-6's ``mu``, ``u`` and ``ln_x``, Mamba's
    ``dt_bias``, ``A_log`` and ``D``)."""
    from repro_torch.models.ssm import CONV_K

    def part(n: int, on: bool) -> int:
        return cut.part(n) if on else n

    d, hd = cfg.d_model, cfg.head_dim_
    mats = 3 if cfg.mlp in ("swiglu", "geglu") else 2
    layer = mats * d * part(cfg.d_ff, cut.ff)
    f32 = 2 * d                                           # ln1, ln2
    if cfg.family == "ssm":
        rh = cfg.rwkv_head_dim
        width = part(d // rh, cut.time_mix) * rh          # the card's heads
        layer += 6 * d * width                            # w_r..w_g, w_out
        f32 += 5 * d + 2 * width                          # mu; u, ln_x
    else:
        layer += (2 * d * part(cfg.num_heads, cut.heads) * hd
                  + 2 * d * part(cfg.num_kv_heads, cut.kv) * hd)
    if cfg.family == "hybrid":
        di, n, r = part(d, cut.mamba), cfg.ssm_state, max(8, d // 64)
        # w_in (both halves), conv_w, conv_b, w_dt1, w_dt2, w_B, w_C, w_out
        layer += 3 * d * di + (CONV_K + 1) * di + 2 * di * r + 2 * di * n
        f32 += 2 * d + di * (n + 2)         # ln_a, ln_s; A_log, dt_bias, D
    return (2 * part(cfg.vocab_size, cut.vocab) * d + cfg.num_layers * layer,
            d + cfg.num_layers * f32)


def tp_reckoning(cfg, cut) -> int:
    """The bytes of a dense decoder's tree under ``cut`` (:func:`tp_elements`:
    the matrices in the model's dtype, the norms in float32)."""
    mats, norms = tp_elements(cfg, cut)
    isz = torch.empty((), dtype=getattr(torch, cfg.dtype)).element_size()
    return isz * mats + 4 * norms


def tp_state_reckoning(cfg, cut, moment_bytes: int) -> int:
    """The bytes of a dense decoder's train state under ``cut``: the
    parameters (:func:`tp_reckoning`), two moments of ``moment_bytes`` an
    element of every parameter and the 4-byte step."""
    mats, norms = tp_elements(cfg, cut)
    return tp_reckoning(cfg, cut) + 2 * moment_bytes * (mats + norms) + 4


class emulated_cards:
    """Inside: a peer mesh's cards are those of ``card_of`` (a card a
    model-axis device), all of them the one real card: the placement's
    layout (``sharding._card_layout``) and the session ring's
    (``PeerRing``'s ``card_of``), so each emulated card holds its own tree,
    cache and inputs and runs its share on a host thread of its own. The
    ring's steps run the real card's programs (its kernels) over every
    logical device at once; a one-card program cannot record a graph for
    a second card, so an emulated program runs eagerly
    (:func:`run_emulated`)."""

    def __init__(self, card_of, dev):
        self.card_of, self.dev = list(card_of), dev

    def __enter__(self):
        from repro_torch.comm import collectives as coll
        from repro_torch.training import sharding as shd

        n, dev, card_of = max(self.card_of) + 1, self.dev, self.card_of
        self.saved = coll.PeerRing, shd._card_layout
        base = coll.PeerRing

        class Cards(base):
            def __init__(self, engine):
                super().__init__(engine)
                self.card_of, self.cards = list(card_of), (dev,) * n

        coll.PeerRing = Cards
        shd._card_layout = lambda mesh, what: ((dev,) * n, [
            [d for d, c in enumerate(card_of) if c == k] for k in range(n)])
        return self

    def __exit__(self, *exc):
        from repro_torch.comm import collectives as coll
        from repro_torch.training import sharding as shd

        coll.PeerRing, shd._card_layout = self.saved
        return False


def run_emulated(prog, mesh) -> tuple[torch.Tensor, bool]:
    """One eager run of a serving program over emulated cards (its first
    run: one host thread a card in lockstep at the ring's steps), card 0's
    inputs staged to the others first: card 0's logits, copied, and
    whether every card's are the same bits."""
    from repro_torch.launch.mesh import set_mesh

    for c in range(1, len(prog.cards)):
        for dst, src in zip(prog.card_inputs(c), prog.card_inputs(0)):
            dst.copy_(src)
    with set_mesh(mesh):
        prog.run()
    torch.cuda.synchronize()
    first = prog.card_logits[0]
    return first.clone(), all(torch.equal(t, first.to(t.device))
                              for t in prog.card_logits[1:])


def tensor_parallel_path(dev, per_path, read_path, smi: str,
                         at_o: dict) -> None:
    """Main path AB (phase 35): dense tensor parallelism on a peer mesh on
    the one card, Nemotron-4 340B at path O's full width and 4 layers on
    path O's seeded weights and requests (``at_o``: path O's prompts,
    tokens, prefill and decode logits). (1) Four logical devices on the
    card, ``make_host_mesh((1, 4), devices=["cuda:0"] * 4)``: the card
    holds every device, so its cut is every whole leaf (views of the
    weights, bytes as reckoned) and tokens, prefill and decode logits are
    path O's bit for bit (counted run). (2) The two-card layout
    ``AB_CARD_OF`` emulated on the card (:class:`emulated_cards`): each
    card's tree its heads, hidden units and vocabulary blocks (bytes as
    :func:`tp_reckoning`), its cache its kv heads; one eager prefill and
    one decode step (counted), every psum and the logits' gather through
    the ring's kernels on the card (``multipath_dma`` three ring shifts a
    psum, ``ring_allgather`` one a psum and one for the logits); every
    card's logits the same bits and within 2e-2 of path O's largest
    |logit| (the bfloat16 bound of ``tests/test_torch_peer_tp.py``)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels._graph import reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    from repro_torch.serving import ServeEngine

    # -- 35. main path AB: dense tensor parallelism on a peer mesh ---------
    t_path = time.perf_counter()
    cfg = dataclasses.replace(get_config("nemotron_4_340b"),
                              num_layers=NEMOTRON_LAYERS)
    params = init_model(cfg, dev, "AB")
    prompts, new = at_o["prompts"], len(at_o["outs"][0])
    nl = cfg.num_layers
    mesh = make_host_mesh((1, 4), devices=[dev] * 4)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with set_mesh(mesh):
        engine = ServeEngine(cfg, params, max_len=1024, kv_chunks=4)
        (tree,) = engine.trees
        (cut,) = engine.cuts
        views = all(a.untyped_storage().data_ptr()
                    == b.untyped_storage().data_ptr()
                    for a, b in zip(_leaves(tree), _leaves(params)))
        placed = sum(t.numel() * t.element_size() for t in _leaves(tree))
        check(views and not cut.cuts and placed == tp_reckoning(cfg, cut),
              f"path AB: the one card's tree is not the whole weights' "
              f"views ({cut}, {placed} B against "
              f"{tp_reckoning(cfg, cut)})")
        toks, outs, logits, _, gen_s = serve_requests(
            cfg, engine, prompts, new, "AB", per_path, read_path)
        dec = decode_logits(engine, toks, logits)
        same = {"tokens": outs == at_o["outs"]
                and torch.equal(toks.cpu(), at_o["toks"]),
                "prefill logits": torch.equal(logits.cpu(), at_o["logits"]),
                "decode logits": torch.equal(dec.cpu(), at_o["dec"])}
        print(f"path AB: Nemotron-4 340B over {nl} layers under {mesh} on "
              f"a peer session of 4 logical devices on {dev}: the card "
              f"holds every device, so nothing is cut ({placed / 1e9:.3f} "
              f"GB placed, as reckoned, views of the weights); bit for bit "
              f"path O's: {same}", flush=True)
        check(all(same.values()), f"path AB differs from path O: {same}")
        prefill_ms, decode_ms = replay_times(engine, toks, logits, new)
        del engine, tree
    gc.collect()
    torch.cuda.empty_cache()
    b, plen = toks.shape
    with emulated_cards(AB_CARD_OF, dev), set_mesh(mesh):
        engine = ServeEngine(cfg, params, max_len=1024, kv_chunks=4)
        cuts = engine.cuts
        placed = [sum(t.numel() * t.element_size() for t in _leaves(tree))
                  for tree in engine.trees]
        reck = [tp_reckoning(cfg, c) for c in cuts]
        check(len(cuts) == 2 and all(c.heads and c.kv and c.ff and c.vocab
                                     for c in cuts) and placed == reck,
              f"path AB: the two-card layout's cuts {cuts} or bytes "
              f"{placed} (reckoned {reck})")
        prefill = engine.prefill_program(b, plen)
        decode = engine.decode_program(b)
        kv_heads = [c["k"].shape[2] for c in decode.caches]
        prefill.tokens.copy_(toks)
        tok = at_o["logits"][:, -1].argmax(-1)[:, None].to(dev)
        decode.tokens.copy_(tok)
        decode.cur_len.fill_(plen)
        reset_launch_counts()
        t0 = time.perf_counter()
        pre, pre_same = run_emulated(prefill, mesh)
        pre_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        step, step_same = run_emulated(decode, mesh)
        step_s = time.perf_counter() - t0
        read_path("AB-tp")
        psums = 1 + 2 * nl
        want_counts = {"multipath_dma": 2 * 3 * psums,
                       "ring_allgather": 2 * (psums + 1),
                       "flash_attention": 2 * nl}
        got_counts = {k: per_path["AB-tp"].get(k, 0) for k in want_counts}
        check(got_counts == want_counts, f"path AB's two-card layout "
              f"launched {got_counts}, not {want_counts} (three ring "
              f"shifts and one gather a psum, {psums} psums and the "
              f"logits' gather a forward; attention a card a layer a "
              f"prefill)")
        del engine
    ref_pre = at_o["logits"].to(dev).float()
    ref_dec = at_o["dec"].to(dev).float()
    errs_ab = {"prefill": (pre.float() - ref_pre).abs().max().item(),
               "decode": (step.float() - ref_dec).abs().max().item()}
    tops = {"prefill": ref_pre.abs().max().item(),
            "decode": ref_dec.abs().max().item()}
    agree = (pre[:, -1].argmax(-1).cpu()
             == at_o["logits"][:, -1].argmax(-1)).sum().item()
    same_cards = pre_same and step_same
    print(f"path AB: the two-card layout {list(AB_CARD_OF)} emulated on "
          f"{dev}: each card {placed[0] / 1e9:.3f} GB placed (reckoned "
          f"{reck[0] / 1e9:.3f}: its 48 of 96 heads, 4 of 8 kv heads, "
          f"36864 of 73728 hidden units, 128000 of 256000 vocabulary rows "
          f"and columns), caches at {kv_heads} kv heads; one eager "
          f"lockstep prefill {pre_s * 1e3:.1f} ms and decode step "
          f"{step_s * 1e3:.1f} ms (host clock, kernels on the card); "
          f"launches {got_counts}; every card's logits the same bits "
          f"{same_cards}; against path O: prefill max abs err "
          f"{errs_ab['prefill']} (max |logit| {tops['prefill']}), decode "
          f"{errs_ab['decode']} ({tops['decode']}), bound 2e-2 of max "
          f"|logit|; last-position argmax agrees in {agree} of {b}",
          flush=True)
    check(same_cards and all(errs_ab[k] <= 2e-2 * tops[k] for k in tops),
          f"path AB's two-card layout: every card the same bits "
          f"{same_cards}, errors {errs_ab} against 2e-2 of {tops}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del params, pre, step, ref_pre, ref_dec
    gc.collect()
    torch.cuda.empty_cache()
    gen1_s, gen2_s = gen_s
    print(f"path AB vs path O (no mesh), Nemotron-4 over {nl} layers on "
          f"{smi}: the one-card peer mesh's prefill replay "
          f"{prefill_ms:.2f} ms, captured decode step {decode_ms:.2f} ms "
          f"(CUDA events, {new - 1} steps, the better of two runs); "
          f"generate of {b} x {new} tokens {gen2_s:.3f} s = "
          f"{b * new / gen2_s:.1f} tokens/s (second call; first "
          f"{gen1_s:.3f} s); peak {peak:.2f} GiB "
          f"({time.perf_counter() - t_path:.1f} s)", flush=True)


#: Path AC's depths of Llama-3 8B at full width: the one-card layout's
#: bitwise check in the config's bfloat16, and the two-card layout's
#: check in float32 (TF32 off), as ``tools/peer_smoke.py --moe-train``
#: held its four cards. In bfloat16 path Z's parameter limit cannot hold
#: across two summation orders: each update rounds to bfloat16, so a
#: float32 update a few ulps apart lands one bfloat16 step away, and
#: AdamW moves every element whose |g| is below the bfloat16 noise of
#: its gradient by up to ±lr (on the CPU at reduced width: of 197,184
#: elements 6,047 one step apart and 1,303 further).
AC_LAYERS = 4
AC_TWO_CARD_LAYERS = 2


def tp_step_psums(layers: int) -> int:
    """The peer psums a card runs in one train step of a dense decoder
    whose every part is cut, under ``remat="full"``, as the code issues
    them: the embedding's g, the gold logit's g, f's on the final norm's
    output and the clip norm's; a layer's two g in the forward, the
    attention's g again in the recompute (the checkpoint stops its
    recompute once the tensors the backward saved are back, before the
    MLP's g, which saves none) and its two f in the backward. The loss's
    block log-sum-exps are one gather besides (``4 + 5L`` psums, not the
    ``4 + 6L`` of a recompute run to its end)."""
    return 4 + 5 * layers


def peer_update_diffs(got, want, delta: float, small, lr_sum: float
                      ) -> dict:
    """Leaf by leaf, the updated float32 parameters ``got`` of a
    tensor-parallel step against ``want`` (the unsharded step's) at path
    Z's limit, within PEER_TRAIN_DELTA_SHARE of ``delta`` (the unsharded
    update's largest |change|), counting what that limit does not take:
    ``eps``, elements whose unsharded |g| fell below EPS_CONDITIONED at
    some step (``small``, AdamW's ε region), held within twice the steps'
    summed lr; ``beyond``, every other element (none may be). Returns the
    counts, the largest difference and its leaf."""
    out = {"worst": 0.0, "where": "", "eps": 0, "beyond": 0,
           "eps_worst": 0.0, "elements": 0}
    bound = PEER_TRAIN_DELTA_SHARE * delta
    for i, (a, b, eps) in enumerate(zip(got, want, small)):
        diff = (a.float() - b.float()).abs()
        err = diff.max().item()
        if err >= out["worst"]:
            out["worst"], out["where"] = err, f"leaf {i} {tuple(b.shape)}"
        left = diff > bound
        held = left & eps & (diff <= 2 * lr_sum)
        out["eps"] += int(held.sum())
        if bool(held.any()):
            out["eps_worst"] = max(out["eps_worst"], diff[held].max().item())
        out["beyond"] += int((left & ~held).sum())
        out["elements"] += b.numel()
    return out


def train_run(cfg, mesh, box, batches, opt, dev, small=None
              ) -> tuple[list, list, list, list]:
    """``len(batches)`` steps of ``cfg`` under ``mesh`` (None: none) from
    ``box[0]`` (the only name on the state, so that each step's old state
    is freed as it is replaced): losses, grad norms, lrs, step ms (host
    clock, synced); the last state left in ``box``; with ``small`` (a
    list) the elements of each leaf whose |g| fell below EPS_CONDITIONED
    at some step put there."""
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.training import TrainStepConfig, make_train_step
    from repro_torch.training import train_step as tsm

    step = make_train_step(cfg, TrainStepConfig(), opt, device=dev)
    losses, norms, lrs, times = [], [], [], []
    update = tsm._update

    def record(params, grads, opt_state, opt_, **kw):
        now = [g.abs() < EPS_CONDITIONED for g in _leaves(grads)]
        small[:] = now if not small else [
            a | b for a, b in zip(small, now)]
        return update(params, grads, opt_state, opt_, **kw)

    if small is not None:
        tsm._update = record
    try:
        with set_mesh(mesh):
            for bt in batches:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                box[0], m = step(box[0], bt)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                losses.append(m["loss"].clone())
                norms.append(m["grad_norm"].clone())
                lrs.append(float(m["lr"]))
                del m
    finally:
        tsm._update = update
    return losses, norms, lrs, times


def unsharded_run(cfg, fresh, batches, opt, dev, small=None):
    """The unsharded step's run from ``fresh(cfg)`` (:func:`train_run`):
    its losses, norms, lrs and ms, its updated parameters and the
    update's largest |change|."""
    box = [fresh(cfg)]
    first = [t.clone() for t in _leaves(box[0]["params"])]
    out = train_run(cfg, None, box, batches, opt, dev, small)
    want = box[0]["params"]
    box.clear()
    delta = max((a.float() - b.float()).abs().max().item()
                for a, b in zip(_leaves(want), first))
    del first
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return out, want, delta


def state_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _leaves(tree))


def tp_training_path(dev, per_path, read_path, smi: str) -> dict:
    """Main path AC (phase 36): training under dense tensor parallelism
    on a peer mesh, Llama-3 8B at full width (``remat="full"``, float32
    moments, 8 x 512 tokens, 2 steps of ``make_train_step``), each peer
    run held against the unsharded step run just before it from the same
    seed and batches (not counted). (1) ``AC_LAYERS`` layers in the
    config's bfloat16, four logical devices on the card,
    ``make_host_mesh((1, 4), devices=["cuda:0"] * 4)``: the card holds
    every device, so ``place_state(state, mesh, cfg)`` cuts nothing
    (views of the state, bytes as :func:`tp_state_reckoning`) and both
    steps are the unsharded step's bit for bit: losses, ``grad_norm`` and
    every parameter (hard check; counted run). (2) ``AC_TWO_CARD_LAYERS``
    layers in float32, the two-card layout ``AB_CARD_OF`` emulated on
    the card (:class:`emulated_cards`): each card's state its blocks
    (bytes as reckoned); two steps, one host thread a card (counted
    run); every launch counted exactly (:func:`tp_step_psums` psums a
    step a card, each three ``multipath_dma`` ring shifts and one
    ``ring_allgather`` launch of the one real card, one more gather for
    the loss; attention forward and recompute, and its backward, a layer
    a card); every
    card's replicated leaves the same bits; losses within
    PEER_TRAIN_LOSS_RTOL of the unsharded step's and every parameter at
    path Z's limit but in AdamW's ε region (:func:`peer_update_diffs`;
    hard checks). Prints the step ms of each run (host clock, synced),
    the errors and the peak GiB."""
    import dataclasses
    import math

    from repro_torch.configs import get_config
    from repro_torch.kernels._graph import reset_launch_counts
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import OptimConfig
    from repro_torch.training import init_state
    from repro_torch.training import sharding as shd
    from repro_torch.tree import leaves_with_paths

    # -- 36. main path AC: training tensor parallel on a peer mesh ---------
    t_path = time.perf_counter()
    full = get_config("llama3_8b")
    check((full.remat, full.dtype, full.d_model, full.optimizer_dtype)
          == ("full", "bfloat16", 4096, "float32"), f"path AC: not Llama-3 "
          f"8B at full width: {full}")
    opt = OptimConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                      moment_dtype=full.optimizer_dtype)
    batches = family_batches(full, dev, 8, 512, 2)
    mbytes = torch.empty((), dtype=getattr(torch, opt.moment_dtype)
                         ).element_size()
    mesh = make_host_mesh((1, 4), devices=[dev] * 4)

    def fresh(cfg):
        return init_state(cfg, opt, generator=torch.Generator(
            device=dev).manual_seed(81), device=dev)

    # (1) four logical devices on the card, bfloat16: nothing cut
    cfg = dataclasses.replace(full, num_layers=AC_LAYERS)
    (want_losses, want_norms, _, want_ms), want, _ = unsharded_run(
        cfg, fresh, batches, opt, dev)
    state = fresh(cfg)
    trees = shd.place_state(state, mesh, cfg)
    (cut,) = shd.card_cuts(cfg, mesh)
    views = all(a.untyped_storage().data_ptr()
                == b.untyped_storage().data_ptr()
                for a, b in zip(_leaves(trees[0]), _leaves(state)))
    reck = tp_state_reckoning(cfg, cut, mbytes)
    check(len(trees) == 1 and views and not cut.cuts
          and state_bytes(trees[0]) == reck, f"path AC: the one card's "
          f"state is not the whole state's views ({cut}, "
          f"{state_bytes(trees[0])} B against {reck})")
    del state
    box = [trees]
    del trees
    torch.cuda.synchronize()
    reset_launch_counts()
    one_losses, one_norms, _, one_ms = train_run(cfg, mesh, box, batches,
                                                 opt, dev)
    read_path("AC-one")
    (tree,) = box[0]
    box.clear()
    bitwise = (all(torch.equal(a, b) for a, b in zip(one_losses,
                                                      want_losses))
               and all(torch.equal(a, b) for a, b in zip(one_norms,
                                                         want_norms))
               and all(torch.equal(a, b) for a, b in zip(
                   _leaves(tree["params"]), _leaves(want))))
    del tree, want
    print(f"path AC ({smi}): Llama-3 8B make_train_step under {mesh} on a "
          f"peer session of 4 logical devices on {dev}, full width, "
          f"{AC_LAYERS} of 32 layers, remat full, bfloat16, float32 "
          f"moments, 8 x 512 tokens, 2 steps from place_state: the card "
          f"holds every device, so nothing is cut ({reck / 1e9:.3f} GB of "
          f"state, as reckoned, views); losses, grad_norm and parameters "
          f"bit for bit the unsharded step's: {bitwise}; step ms "
          f"{[round(t, 2) for t in one_ms]} (unsharded "
          f"{[round(t, 2) for t in want_ms]}); launches "
          f"{per_path['AC-one']}", flush=True)
    check(bitwise, "path AC: the one-card layout's step is not the "
          "unsharded step bit for bit")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # (2) the two-card layout emulated on the card, float32
    cfg = dataclasses.replace(full, num_layers=AC_TWO_CARD_LAYERS,
                              dtype="float32")
    nl = cfg.num_layers
    small: list = []
    (want_losses, want_norms, lrs, want_ms), want, delta = unsharded_run(
        cfg, fresh, batches, opt, dev, small)
    lr_sum = sum(lrs)
    with emulated_cards(AB_CARD_OF, dev):
        cuts = shd.card_cuts(cfg, mesh)
        box = [shd.place_state(fresh(cfg), mesh, cfg)]
        placed = [state_bytes(tree) for tree in box[0]]
        reck2 = [tp_state_reckoning(cfg, c, mbytes) for c in cuts]
        check(len(cuts) == 2 and all(c.heads and c.kv and c.ff and c.vocab
                                     for c in cuts) and placed == reck2,
              f"path AC: the two-card layout's cuts {cuts} or state bytes "
              f"{placed} (reckoned {reck2})")
        torch.cuda.synchronize()
        reset_launch_counts()
        losses, norms, _, two_ms = train_run(cfg, mesh, box, batches, opt,
                                             dev)
        read_path("AC-tp")
        peak = torch.cuda.max_memory_allocated() / 2**30
        trees = box[0]
        box.clear()
        rep = [[t for path, t in leaves_with_paths(tree)
                if not shd.is_cut(path, cuts[0])] for tree in trees]
        replicas = all(torch.equal(a, b) for a, b in zip(*rep))
        del rep
        got = shd.unplace_state(trees, mesh, cfg)["params"]
        del trees
    psums = tp_step_psums(nl)
    steps = len(batches)
    # a ring program launches once a real card (both emulated cards'
    # parts in one launch); attention runs once a card a layer
    want_counts = {"multipath_dma": 3 * psums * steps,
                   "ring_allgather": (psums + 1) * steps,
                   "flash_attention": 2 * 2 * nl * steps,
                   "flash_attention_bwd": 2 * nl * steps}
    got_counts = {k: per_path["AC-tp"].get(k, 0) for k in want_counts}
    diffs = peer_update_diffs(_leaves(got), _leaves(want), delta, small,
                              lr_sum)
    losses = [float(x) for x in losses]
    want_l = [float(x) for x in want_losses]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want_l))
    norm_rel = max(abs(float(a) - float(b)) / float(b)
                   for a, b in zip(norms, want_norms))
    del got, want, small
    gc.collect()
    torch.cuda.empty_cache()
    print(f"path AC: the two-card layout {list(AB_CARD_OF)} emulated on "
          f"{dev}, {nl} layers in float32 (TF32 off): each card "
          f"{placed[0] / 1e9:.3f} GB of state (reckoned "
          f"{reck2[0] / 1e9:.3f}: its 16 of 32 heads, 4 of 8 kv heads, 7168 "
          f"of 14336 hidden units and 64128 of 128256 vocabulary rows and "
          f"columns, with their float32 moments); losses {losses} "
          f"(unsharded {want_l}; largest relative difference "
          f"{loss_rel:.3g}, limit {PEER_TRAIN_LOSS_RTOL}); grad_norm's "
          f"largest relative difference {norm_rel:.3g}; parameters' largest "
          f"difference {diffs['worst']} ({diffs['where']}) against the "
          f"unsharded update's largest |change| {delta} (limit "
          f"{PEER_TRAIN_DELTA_SHARE} of it): of {diffs['elements']} "
          f"elements {diffs['eps']} in AdamW's ε region beyond it (largest "
          f"{diffs['eps_worst']:.4g}, held within 2 x the summed lr "
          f"{2 * lr_sum:.4g}), {diffs['beyond']} others beyond; every "
          f"card's replicated leaves the same bits {replicas}; step ms "
          f"{[round(t, 2) for t in two_ms]} (unsharded "
          f"{[round(t, 2) for t in want_ms]}; host clock, synced, the "
          f"first with the ring's programs built; one host thread a card); "
          f"launches {got_counts} over {steps} steps ({psums} psums a step "
          f"a card and the loss's gather); peak {peak:.2f} GiB "
          f"({time.perf_counter() - t_path:.1f} s)", flush=True)
    check(got_counts == want_counts, f"path AC's two-card layout launched "
          f"{got_counts}, not {want_counts}")
    check(replicas, "path AC: the cards' replicated leaves differ")
    check(loss_rel <= PEER_TRAIN_LOSS_RTOL and all(
        math.isfinite(x) for x in losses), f"path AC: losses {losses} vs "
          f"the unsharded step's {want_l}")
    check(diffs["beyond"] == 0, f"path AC: {diffs['beyond']} parameters "
          f"differ beyond {PEER_TRAIN_DELTA_SHARE} of the unsharded update's "
          f"largest |change| {delta} outside AdamW's ε region ({diffs})")
    return {"one_card_layers": AC_LAYERS, "one_card_ms": one_ms,
            "two_card_layers": nl, "two_card_ms": two_ms,
            "unsharded_ms": want_ms, "peak_gib": peak,
            "loss_rel": loss_rel, "diffs": diffs, "delta": delta}


#: Path AD's depth of the float32 training check on the emulated
#: two-card layout (path AC's AC_TWO_CARD_LAYERS).
AD_TRAIN_LAYERS = 2
#: How many of a step's compared parameter elements may take AdamW's
#: ε-region exemption (:func:`peer_update_diffs`): at most
#: ``ceil(EPS_EXEMPT_SHARE · elements)``, the bound of
#: ``tests/test_torch_peer_moe_training.py`` (path AC measured 5,240 of
#: 1.49 B, 3.5e-6).
EPS_EXEMPT_SHARE = 2e-5


def ssm_serve_psums(cfg, cut) -> int:
    """The peer psums of one forward of an SSM-family decoder under a
    card's ``cut``: the embedding's where the vocabulary is cut; a layer
    RWKV-6's time mix and MLP, or Hymba's Mamba gates, Mamba output and
    MLP (and its attention where its heads are cut)."""
    a_layer = 2 if cfg.family == "ssm" else 3 + int(cut.heads)
    return int(cut.vocab) + a_layer * cfg.num_layers


def ssm_step_psums(cfg, cut) -> int:
    """The peer psums a card runs in one ``remat="full"`` train step of an
    SSM-family decoder under ``cut``, as the code issues them
    (``tests/test_torch_peer_tp_training.py``'s STEP_PSUMS counts them on
    the CPU): the clip norm's, and where the vocabulary is cut the
    embedding's g, the gold logit's g and f on the final norm's output;
    a layer of RWKV-6 the time mix's g in the forward and again in the
    recompute, the MLP's g, f on (x, mu) and on the MLP's input; a layer
    of Hymba the Mamba gates' and output's g in the forward and the
    recompute, the MLP's g, f on the gates, on Mamba's and on the MLP's
    input, and where its heads are cut the attention's g twice and its
    f. The checkpoint's recompute stops before the MLP's g (it saves
    nothing)."""
    a_layer = 5 if cfg.family == "ssm" else 8 + 3 * int(cut.heads)
    return 1 + 3 * int(cut.vocab) + a_layer * cfg.num_layers


#: The twin of path AD's and ``--ssm-tp``'s bfloat16 serving checks, by
#: family: the dtype in which the unsharded run and the cut's (eager, the
#: same weights) are held to each other within TWIN_BOUND of the largest
#: |logit| at every position. RWKV-6's in float64 through
#: :func:`twin_scan` (the kernel takes no float64), since in float32 its
#: per-head group norm leaves a few positions unfixed by the inputs (see
#: :func:`serve_twin`'s witnesses); Hymba's in float32 through its kernels.
TWIN_DTYPE = {"ssm": "float64", "hybrid": "float32"}
#: ``tests/test_torch_peer_tp.py``'s bound: 2e-2 of the largest |logit|.
TWIN_BOUND = 2e-2
#: The bfloat16 runs, whose unsharded run is itself far from the twin at
#: every position: the median over positions of each position's largest
#: distance from the twin's unsharded logits; the cut's at most
#: BF16_MEDIAN_FACTOR times the unsharded bfloat16 run's, and the
#: control's (the cut mixer's psum dropped) beyond that.
BF16_MEDIAN_FACTOR = 2.0


def twin_scan(r, k, v, w, u, *, chunk, out_dtype=None, return_state=False):
    """RWKV-6's scan as its recurrence, a position at a time in float64
    (the twin's; ``chunk`` and ``out_dtype`` unused): ``o_t = r_t·(S +
    diag(u)·k_tᵀv_t)``, then ``S ← diag(w_t)·S + k_tᵀv_t``."""
    b, s, h, dk = r.shape
    r, k, v, w, u = (t.double() for t in (r, k, v, w, u))
    state = torch.zeros((b, h, dk, v.shape[-1]), dtype=torch.float64,
                        device=r.device)
    out = []
    for t in range(s):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        out.append(torch.einsum("bhd,bhde->bhe", r[:, t],
                                state + u[..., None] * kv))
        state = w[:, t, :, :, None] * state + kv
    o = torch.stack(out, 1)
    return (o, state) if return_state else o


def plain_scan(r, k, v, w, u, *, chunk, out_dtype=None,
               return_state=False):
    """The scan's plain version on any device (differentiable by
    autograd): a witness of the kernel's."""
    from repro_torch.kernels.rwkv6_scan import kernel as sk

    return sk.rwkv6_scan_plain(r, k, v, w, u, chunk=chunk,
                               out_dtype=out_dtype, return_state=return_state)


class rwkv_patched:
    """Inside: RWKV-6's time mix runs ``scan`` (:func:`twin_scan`,
    :func:`plain_scan`) where given instead of the kernel, and with
    ``spread`` (a list) each full-sequence call's group-norm input mean
    square per (batch, position, head) is appended there."""

    def __init__(self, scan=None, spread: list | None = None):
        self.scan, self.spread = scan, spread

    def __enter__(self):
        from repro_torch.models import ssm

        self.saved = ssm.chunked_scan, ssm._rwkv6_finish
        finish, spread = ssm._rwkv6_finish, self.spread

        def recording(o, g, p, dtype):
            if o.dim() == 4:
                spread.append(o.double().square().mean(-1))
            return finish(o, g, p, dtype)

        if self.scan is not None:
            ssm.chunked_scan = self.scan
        if spread is not None:
            ssm._rwkv6_finish = recording
        return self

    def __exit__(self, *exc):
        from repro_torch.models import ssm

        ssm.chunked_scan, ssm._rwkv6_finish = self.saved
        return False


def unsharded_logits(cfg, params, toks, tok, max_len: int):
    """An eager unsharded prefill of ``toks`` and decode step of ``tok``
    after it: the logits of each."""
    from repro_torch.models import transformer as tfm

    spec = tfm.cache_spec(cfg, max_len)
    with torch.no_grad():
        pre, cache = tfm.prefill_forward(params, cfg, {"tokens": toks}, spec)
        dec, _ = tfm.decode_step(params, cfg, cache, tok, toks.shape[1],
                                 spec)
    return pre, dec


def cut_run(cfg, weights, toks, tok, mesh, max_len: int, counted=None):
    """One eager prefill of ``toks`` and decode step of ``tok`` of ``cfg``
    from ``weights`` (the tree, or a list holding it, popped so that the
    whole weights are freed once placed) on the peer mesh ``mesh`` (its
    cards real, or emulated inside :class:`emulated_cards`), the counters
    set to 0 just before
    them and read just after by ``counted()`` where given: every card's
    card 0's prefill and decode logits, and whether every card's are the
    same bits, the engine's cuts, each card's bytes and cache shapes, card
    0's layer 0 and the host seconds of each."""
    from repro_torch.kernels._graph import reset_launch_counts
    from repro_torch.launch.mesh import set_mesh
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import ServeEngine
    from repro_torch.tree import tree_map

    b, plen = toks.shape
    with set_mesh(mesh):
        engine = ServeEngine(cfg, weights.pop() if isinstance(weights, list)
                             else weights, max_len=max_len)
        prefill = engine.prefill_program(b, plen)
        decode = engine.decode_program(b)
        shapes = {k: [tuple(cc[k].shape) for cc in decode.caches]
                  for k in decode.caches[0]}
        placed = [state_bytes(t) for t in engine.trees]
        prefill.tokens.copy_(toks)
        decode.tokens.copy_(tok)
        decode.cur_len.fill_(plen)
        if counted:
            reset_launch_counts()
        t0 = time.perf_counter()
        pre, pre_same = run_emulated(prefill, mesh)
        pre_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        step, step_same = run_emulated(decode, mesh)
        step_s = time.perf_counter() - t0
        if counted:
            counted()
        out = {"cuts": engine.cuts, "placed": placed, "caches": shapes,
               "same": pre_same and step_same,
               "layer0": tree_map(lambda t: t.clone(),
                                  tfm.layer_params(engine.trees[0], 0)),
               "pre_s": pre_s, "step_s": step_s}
        del engine, prefill, decode
    gc.collect()
    torch.cuda.empty_cache()
    return pre, step, out


def with_leaf(params, mixer: str, key: str, value):
    """``params`` with layer leaf ``mixer``/``key`` replaced by ``value``."""
    layers = params["layers"]
    return {**params, "layers": {**layers, mixer: {**layers[mixer],
                                                   key: value}}}


def mixer_controls(cfg, params) -> dict:
    """Two faults of a two-card cut, as the unsharded model's weights would
    carry them: ``drop``, the cut mixer's psum dropped (the second card's
    rows of its ``w_out`` zeroed: card 0's partial alone); ``swap``, its
    two cards' blocks of a per-head or per-channel leaf swapped (RWKV-6's
    ``u`` heads, Mamba's ``w_dt2`` channels)."""
    mixer, key, dim = (("rwkv", "u", 1) if cfg.family == "ssm"
                       else ("ssm", "w_dt2", 2))
    lp = params["layers"][mixer]
    half = lp["w_out"].shape[1] // 2
    w_out = lp["w_out"].clone()
    w_out[:, half:] = 0
    first, second = lp[key].chunk(2, dim)
    return {"drop": with_leaf(params, mixer, "w_out", w_out),
            "swap": with_leaf(params, mixer, key,
                              torch.cat([second, first], dim))}


def position_distances(t: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Each position's largest |difference| of logits ``t`` from ``ref``
    (float64, a batch row at a time)."""
    return torch.stack([(a.to(r.device).double() - r.double()).abs().amax(-1)
                        for a, r in zip(t, ref)])


def serve_twin(cfg, params, toks, tok, mesh, max_len: int, cards=None,
               spread: list | None = None) -> dict:
    """The twin of a bfloat16 serving check: ``params`` in the family's
    TWIN_DTYPE served unsharded (:func:`unsharded_logits`) and on ``mesh``
    (:func:`cut_run`, inside ``cards()`` where given), and the faults of
    :func:`mixer_controls` unsharded in the twin's dtype and (``drop``)
    in the model's (the float32 leaves stay float32); RWKV-6 through
    :func:`twin_scan`, the unsharded prefill's group-norm spread in
    ``spread`` where given. Returns ``ref``, each phase's (``prefill``,
    ``decode``) unsharded twin logits, ``per``, each other run's
    :func:`position_distances` from them by phase (``tp`` the cut twin's,
    ``drop``, ``swap``, ``drop16``; a caller adds its own), and whether
    every card's twin logits are the same bits."""
    import contextlib
    import dataclasses

    from repro_torch.tree import tree_map

    dt = TWIN_DTYPE[cfg.family]
    c = dataclasses.replace(cfg, dtype=dt)
    # the model's dtype (the matrices) to the twin's; the float32 leaves
    # as they are (the decode step's state math is float32)
    p = tree_map(lambda t: t.to(getattr(torch, dt))
                 if t.dtype == getattr(torch, cfg.dtype) else t, params)
    twin = {"ref": {}, "per": {"prefill": {}, "decode": {}}, "dtype": dt}

    def put(name, pair):
        for phase, t in zip(("prefill", "decode"), pair):
            twin["per"][phase][name] = position_distances(
                t, twin["ref"][phase])

    with rwkv_patched(twin_scan if dt == "float64" else None):
        with rwkv_patched(spread=spread):
            twin["ref"]["prefill"], twin["ref"]["decode"] = unsharded_logits(
                c, p, toks, tok, max_len)
        for name, wrong in mixer_controls(c, p).items():
            put(name, unsharded_logits(c, wrong, toks, tok, max_len))
        del wrong
        box = [p]
        del p
        with (cards() if cards else contextlib.nullcontext()):
            pre, step, run = cut_run(c, box, toks, tok, mesh, max_len)
        put("tp", (pre, step))
        twin["same_cards"] = run["same"]
        del pre, step, run
    put("drop16", unsharded_logits(cfg, mixer_controls(cfg, params)["drop"],
                                   toks, tok, max_len))
    return twin


def twin_distances(twin: dict, bound: float = TWIN_BOUND) -> dict:
    """For each phase of ``twin`` (:func:`serve_twin`'s): the largest
    |logit| of its unsharded twin run, and for every other run the
    largest, the median and the share within ``bound`` of the largest
    |logit| of its :func:`position_distances`, and where the largest
    is."""
    out = {}
    for phase, runs in twin["per"].items():
        top = twin["ref"][phase].abs().max().item()
        row = {"max_abs_logit": top}
        for name, per in runs.items():
            flat = per.flatten()
            worst = int(flat.argmax())
            row[name] = {"max": flat[worst].item(),
                         "median": flat.median().item(),
                         "within": (flat <= bound * top).double().mean()
                         .item(),
                         "at": list(map(int, torch.unravel_index(
                             torch.tensor(worst), per.shape)))}
        out[phase] = row
    return out


def twin_verdict(dist: dict) -> dict:
    """The serving check's rules over :func:`twin_distances`: ``twin``, the
    cut's twin within TWIN_BOUND of the largest |logit| at every position;
    ``controls``, both faults' twins beyond it somewhere; ``bf16``, the
    cut's bfloat16 median distance at most BF16_MEDIAN_FACTOR times the
    unsharded bfloat16 run's and the dropped psum's beyond that."""
    def far(row, name):
        return row[name]["max"] > TWIN_BOUND * row["max_abs_logit"]

    return {"twin": all(not far(r, "tp") for r in dist.values()),
            "controls": all(far(dist["prefill"], n) for n in ("drop", "swap")),
            "bf16": all(r["tp16"]["median"] <= BF16_MEDIAN_FACTOR
                        * r["one16"]["median"] < r["drop16"]["median"]
                        for r in dist.values())}


def ssm_tp_serve(dev, per_path, read_path, cfg, at: dict, tag: str,
                 kernel: str, max_len: int) -> dict:
    """Path AD's serving of ``cfg`` (path ``tag``'s model on its seeded
    weights and requests, ``at``: its :func:`served_readings`): the
    one-card layout bit for bit path ``tag``'s (counted), then the
    emulated two-card layout's eager prefill and decode step (counted),
    held with its twin (:func:`serve_twin`, :func:`twin_verdict`). Returns
    the readings and card 0's layer 0 and the whole weights for the kernel
    checks."""
    import dataclasses

    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    from repro_torch.models import tensor_parallel as tp
    from repro_torch.models import transformer as tfm
    from repro_torch.serving import ServeEngine
    from repro_torch.tree import tree_map

    name, nl = cfg.name, cfg.num_layers
    torch.cuda.reset_peak_memory_stats()
    params = init_model(cfg, dev, "AD")
    prompts, new = at["prompts"], at["new"]
    mesh = make_host_mesh((1, 4), devices=[dev] * 4)
    with set_mesh(mesh):
        engine = ServeEngine(cfg, params, max_len=max_len)
        (tree,) = engine.trees
        (cut,) = engine.cuts
        views = all(a.untyped_storage().data_ptr()
                    == b.untyped_storage().data_ptr()
                    for a, b in zip(_leaves(tree), _leaves(params)))
        placed = state_bytes(tree)
        check(views and not cut.cuts and placed == tp_reckoning(cfg, cut),
              f"path AD: {name}'s one-card tree is not the whole weights' "
              f"views ({cut}, {placed} B against {tp_reckoning(cfg, cut)})")
        toks, outs, logits, _, gen_s = serve_requests(
            cfg, engine, prompts, new, f"AD-{tag}", per_path, read_path,
            kernel=kernel)
        dec = decode_logits(engine, toks, logits)
        same = {"tokens": outs == at["outs"]
                and torch.equal(toks.cpu(), at["toks"]),
                "prefill logits": torch.equal(logits.cpu(), at["logits"]),
                "decode logits": torch.equal(dec.cpu(), at["dec"])}
        del engine, tree, logits, dec
    print(f"path AD: {name} over {nl} layers under {mesh} on a peer session "
          f"of 4 logical devices on {dev}: the card holds every device, so "
          f"nothing is cut ({placed / 1e9:.3f} GB placed, as reckoned, views "
          f"of the weights); generate {gen_s[1]:.3f} s (second call); bit "
          f"for bit path {tag}'s: {same}", flush=True)
    check(all(same.values()), f"path AD differs from path {tag}: {same}")
    gc.collect()
    torch.cuda.empty_cache()
    b, plen = toks.shape
    tok = at["logits"][:, -1].argmax(-1)[:, None].to(dev)

    def cards():
        return emulated_cards(AB_CARD_OF, dev)

    with cards():
        pre, step, run = cut_run(cfg, params, toks, tok, mesh, max_len,
                                 lambda: read_path(f"AD-{tag}-tp"))
    cuts, placed, caches = run["cuts"], run["placed"], run["caches"]
    layer0, same_cards = run.pop("layer0"), run["same"]
    reck = [tp_reckoning(cfg, c) for c in cuts]
    mixer = "time_mix" if cfg.family == "ssm" else "mamba"
    check(len(cuts) == 2 and all(getattr(c, mixer) and c.ff for c in cuts)
          and placed == reck, f"path AD: {name}'s two-card cuts {cuts} or "
          f"bytes {placed} (reckoned {reck})")
    whole = tfm.cache_shapes(cfg, b, tfm.cache_spec(cfg, max_len))
    # each card's states: its half of the heads or channels, its kv
    # heads; the token-shift input whole
    kv = tp.heads(cfg, cuts[0])[1]
    part = {"rwkv_state": (2, 2), "ssm": (2, 2), "conv": (3, 2),
            "k": (2, cfg.num_kv_heads // max(kv, 1)),
            "v": (2, cfg.num_kv_heads // max(kv, 1))}
    check(sorted(caches) == sorted(whole) and all(
        shapes[0][part[k][0]] * part[k][1] == whole[k].shape[part[k][0]]
        if k in part else shapes[0] == tuple(whole[k].shape)
        for k, shapes in caches.items()), f"path AD: {name}'s card caches "
          f"{caches} against the whole "
          f"{ {k: tuple(t.shape) for k, t in whole.items()} }")
    psums = ssm_serve_psums(cfg, cuts[0])
    want_counts = {"multipath_dma": 2 * 3 * psums,
                   "ring_allgather": 2 * (psums + int(cuts[0].vocab)),
                   kernel: 2 * nl}
    got_counts = {k: per_path[f"AD-{tag}-tp"].get(k, 0) for k in want_counts}
    agree = (pre[:, -1].argmax(-1).cpu()
             == at["logits"][:, -1].argmax(-1)).sum().item()

    # the twin (TWIN_DTYPE) and its controls; RWKV-6's float32 runs
    # through the kernel beside it as witnesses, and its group norm's
    # input spread over the unsharded twin's prefill
    spread: list = []
    twin = serve_twin(cfg, params, toks, tok, mesh, max_len, cards,
                      spread if cfg.family == "ssm" else None)
    per = twin["per"]
    for phase, one16, tp16 in (("prefill", at["logits"], pre),
                               ("decode", at["dec"], step)):
        per[phase]["one16"] = position_distances(one16, twin["ref"][phase])
        per[phase]["tp16"] = position_distances(tp16, twin["ref"][phase])
    del pre, step
    if cfg.family == "ssm":
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        box = [tree_map(lambda t: t.float(), params)]
        one32 = unsharded_logits(cfg32, box[0], toks, tok, max_len)
        with cards():
            pre32, step32, _ = cut_run(cfg32, box, toks, tok, mesh, max_len)
        for phase, a, c in (("prefill", one32[0], pre32),
                            ("decode", one32[1], step32)):
            per[phase]["one32"] = position_distances(a, twin["ref"][phase])
            per[phase]["tp32"] = position_distances(c, twin["ref"][phase])
        del one32, pre32, step32
    dist = twin_distances(twin)
    verdict = twin_verdict(dist)
    twin_same = twin["same_cards"]
    witness = {}
    if spread:
        # the group norm's input mean square at the float32 cut's worst
        # prefill positions: the least over its layers and heads there,
        # against the median over every (layer, position, head)
        ms = torch.stack(spread)                       # (L, B, S, h)
        per32, one_per = per["prefill"]["tp32"], per["prefill"]["one32"]
        rows = []
        for i in per32.flatten().topk(3).indices.tolist():
            bi, si = divmod(i, per32.shape[1])
            here = ms[:, bi, si]                       # (L, h)
            li, hi = divmod(int(here.argmin()), here.shape[1])
            rows.append({"at": [bi, si], "tp32": per32[bi, si].item(),
                         "one32": one_per[bi, si].item(),
                         "least_mean_square": here.min().item(),
                         "layer_head": [li, hi]})
        witness = {"median_mean_square": ms.median().item(),
                   "least_mean_square": ms.min().item(),
                   "worst_positions": rows}
        del ms
    del twin, per, spread
    gc.collect()
    torch.cuda.empty_cache()
    print(f"path AD: {name}, the two-card layout {list(AB_CARD_OF)} emulated "
          f"on {dev}: cuts {cuts[0]}; each card {placed[0] / 1e9:.3f} GB "
          f"placed (reckoned {reck[0] / 1e9:.3f}), card caches {caches}; one "
          f"eager lockstep prefill {run['pre_s'] * 1e3:.1f} ms and decode "
          f"step {run['step_s'] * 1e3:.1f} ms (host clock, kernels on the "
          f"card); launches {got_counts} ({psums} psums a forward); every "
          f"card's logits the same bits {same_cards}, in the twin too "
          f"{twin_same}; last-position argmax agrees with path {tag}'s in "
          f"{agree} of {b}; peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"path AD: {name}'s logits against the unsharded "
          f"{TWIN_DTYPE[cfg.family]} twin's (each position's largest "
          f"distance: the largest, median, share within {TWIN_BOUND} of the "
          f"largest |logit|, where the largest is; tp the two-card twin, "
          f"drop and swap its controls, one16 path {tag}, tp16 the two-card "
          f"bfloat16 run, drop16 its control"
          + ("; one32 and tp32 the float32 runs through the kernel" if
             cfg.family == "ssm" else "") + f"): {dist}; verdict {verdict}"
          + (f"; the group norm's input mean square at tp32's worst prefill "
             f"positions: {witness}" if witness else ""), flush=True)
    check(got_counts == want_counts, f"path AD's two-card layout of {name} "
          f"launched {got_counts}, not {want_counts} (three ring shifts and "
          f"one gather a psum, {psums} psums a forward, the logits' gather "
          f"where the vocabulary is cut; the mixer's kernel a card a layer a "
          f"prefill)")
    check(same_cards and twin_same and all(verdict.values()),
          f"path AD's two-card layout of {name}: every card the same bits "
          f"{same_cards} (twin {twin_same}), {verdict}: {dist}")
    return {"placed_bytes": placed, "reckoned_bytes": reck,
            "launches": got_counts, "psums_a_forward": psums,
            "generate_s": gen_s, "prefill_eager_ms": run["pre_s"] * 1e3,
            "decode_eager_ms": run["step_s"] * 1e3, "distances": dist,
            "verdict": verdict, "group_norm": witness,
            "argmax_agree": agree}, layer0, params, toks


def ssm_tp_scans(randn, rand, errs, lp, params, toks, cfg,
                 rows: dict) -> dict:
    """Path AD (not counted): the ``rwkv6_scan`` kernel and its backward
    at a card's 16 of RWKV-6's 32 heads. The forward on layer 0's real
    prefill r/k/v/w of card 0's layer 0 ``lp`` (its heads' columns)
    against the plain version; both kernels at the card's head count on path G's and
    path M's random inputs against their plain versions, timed by CUDA
    events beside the whole-head times of ``rows`` (the kernel rows,
    measured the same way earlier in this run) and their bounds."""
    from repro_torch.kernels.rwkv6_scan import kernel as sk
    from repro_torch.models import layers, ssm

    hd = cfg.rwkv_head_dim
    x = layers.rms_norm(params["embed"][toks], lp["ln1"])
    shifted = torch.nn.functional.pad(x, (0, 0, 1, 0))[:, :-1]
    r, k, v, w, _ = ssm._rwkv6_project(x, shifted, lp["rwkv"], hd)
    u = lp["rwkv"]["u"].expand(toks.shape[0], -1, -1)
    o, st = sk.rwkv6_scan_cuda(r, k, v, w, u, out_dtype=torch.float32,
                               return_state=True)
    po, pst = sk.rwkv6_scan_plain(r, k, v, w, u, out_dtype=torch.float32,
                                  return_state=True)
    e_real = max(rel_err(o, po), rel_err(st, pst))
    errs["rwkv6_scan"] = max(errs["rwkv6_scan"], (o - po).abs().max().item())
    check(r.shape[2] == 16 and e_real < RWKV_REL, f"path AD: rwkv6_scan "
          f"at card 0's layer-0 prefill {tuple(r.shape)}: relative err "
          f"{e_real}")
    del x, shifted, r, k, v, w, u, o, st, po, pst

    b, s, _, dk, dv = RWKV_SHAPE
    h = 16
    chunk = sk.MAX_CHUNK
    r, k, v, w, u = rwkv_inputs(randn, rand, b, s, h, dk, dv,
                                dtype=torch.bfloat16)
    u = u[:1].expand(b, -1, -1)

    def fwd():
        return sk.rwkv6_scan_cuda(r, k, v, w, u, chunk=chunk,
                                  out_dtype=torch.float32, return_state=True)

    (o, st), (po, pst) = fwd(), sk.rwkv6_scan_plain(
        r, k, v, w, u, chunk=chunk, out_dtype=torch.float32,
        return_state=True)
    e_fwd = max(rel_err(o, po), rel_err(st, pst))
    errs["rwkv6_scan"] = max(errs["rwkv6_scan"], (o - po).abs().max().item())
    check(e_fwd < RWKV_REL, f"path AD: rwkv6_scan at {(b, s, h, dk, dv)}: "
          f"relative err {e_fwd}")
    fwd_ms = cuda_time_ms(fwd, 20)
    fwd_plain_ms = cuda_time_ms(lambda: sk.rwkv6_scan_plain(
        r, k, v, w, u, chunk=chunk, out_dtype=torch.float32,
        return_state=True), 5, warmup=1)
    fwd_bound = scan_bound(b, s, h, dk, dv, chunk)
    del r, k, v, w, u, o, st, po, pst

    b, s, _, dk, dv = RWKV_BWD_SHAPE
    r, k, v, w, u, do = rwkv_bwd_inputs(randn, rand, b, s, h, dk, dv, chunk,
                                        torch.bfloat16)
    e_bwd, err, states = scan_bwd_errs(r, k, v, w, u, do, chunk)
    errs["rwkv6_scan_bwd"] = max(errs["rwkv6_scan_bwd"], err)
    check(all(e <= RWKV_BWD_REL[r.dtype] for e in e_bwd.values()),
          f"path AD: rwkv6_scan_bwd at {(b, s, h, dk, dv)}: relative errs "
          f"{e_bwd}")

    def bwd():
        return sk.rwkv6_scan_bwd_cuda(r, k, v, w, u, do, states=states,
                                      chunk=chunk)

    bwd_ms = cuda_time_ms(bwd, 20)
    bwd_plain_ms = cuda_time_ms(lambda: sk.rwkv6_scan_bwd_plain(
        r, k, v, w, u, do, chunk=chunk, states=states), 3, warmup=1)
    bwd_bound = scan_bwd_bound(b, s, h, dk, dv, chunk, states.numel())
    del r, k, v, w, u, do, states
    out = {"rwkv6_scan": {"shape": list(RWKV_SHAPE[:2]) + [h, 64, 64],
                          "ms": fwd_ms, "plain_ms": fwd_plain_ms,
                          "bound_ms": fwd_bound["bound_ms"],
                          "whole_heads_ms": rows["rwkv6_scan"]["ms"]},
           "rwkv6_scan_bwd": {"shape": list(RWKV_BWD_SHAPE[:2]) + [h, 64, 64],
                              "ms": bwd_ms, "plain_ms": bwd_plain_ms,
                              "bound_ms": bwd_bound["bound_ms"],
                              "whole_heads_ms": rows["rwkv6_scan_bwd"]["ms"]}}
    for kname, row in out.items():
        print(f"path AD: {kname} at a card's 16 of 32 heads {row['shape']} "
              f"(bf16 r/k/v, f32 w/u): kernel {row['ms']:.4f} ms (CUDA "
              f"events, back to back), bound {row['bound_ms']:.4f} ms "
              f"({row['bound_ms'] / row['ms']:.1%} of it), plain "
              f"{row['plain_ms']:.4f} ms; at all 32 heads earlier in this "
              f"run {row['whole_heads_ms']:.4f} ms (ratio "
              f"{row['ms'] / row['whole_heads_ms']:.3f})", flush=True)
    print(f"path AD: the kernels against their plain versions at 16 heads: "
          f"rwkv6_scan on card 0's layer-0 prefill {e_real:.3g}, on random "
          f"inputs {e_fwd:.3g} (limit {RWKV_REL}); rwkv6_scan_bwd "
          + ", ".join(f"{n_} {e_:.3g}" for n_, e_ in e_bwd.items())
          + " (limit 2e-2)", flush=True)
    return out


class first_grads:
    """Inside: the gradients each card hands AdamW at its first step (an
    unsharded step's as card 0's), with their paths, copied: by card in
    ``self.grads``."""

    def __enter__(self):
        from repro_torch.models import moe_dist
        from repro_torch.training import train_step as tsm
        from repro_torch.tree import leaves_with_paths

        self.grads, self.saved = {}, tsm._update
        update, grads_ = self.saved, self.grads

        def record(params, grads, opt_state, opt_, **kw):
            share = moe_dist.current_share()
            card = 0 if share is None else share[1]
            if card not in grads_:
                grads_[card] = [(path, g.clone())
                                for path, g in leaves_with_paths(grads)]
            return update(params, grads, opt_state, opt_, **kw)

        tsm._update = record
        return self

    def __exit__(self, *exc):
        from repro_torch.training import train_step as tsm

        tsm._update = self.saved
        return False

    def by_card(self) -> list:
        return [self.grads[c] for c in sorted(self.grads)]


def grads_rel(got: list, want: list, cuts) -> tuple[float, str]:
    """The largest difference of each card's gradients (``got``, a list a
    card of :class:`first_grads`' entries) from its part (under its cut of
    ``cuts``, None: the whole) of the unsharded step's ``want``, as a share
    of that part's largest |g|, and where."""
    from repro_torch.training import sharding as shd

    worst = (0.0, "")
    for c, (cut, mine) in enumerate(zip(cuts, got)):
        for (path, g), (_, ref) in zip(mine, want):
            if cut is not None:
                ref = shd.cut_leaf(ref, path, list(cut.held), cut.model, cut)
            rel = ((g.float() - ref.float()).abs().max().item()
                   / max(ref.float().abs().max().item(), 1e-30))
            worst = max(worst, (rel, f"card {c} {'/'.join(path)}"))
    return worst


def ssm_tp_train(dev, per_path, read_path, full, mesh, tag: str,
                 kernels: tuple) -> dict:
    """Path AD's training of ``full`` at AD_TRAIN_LAYERS layers in float32
    (TF32 off), float32 moments, 8 x 512 tokens, 2 steps: the unsharded
    step (not counted), then the emulated two-card layout from
    ``place_state`` (counted: every launch exact, :func:`ssm_step_psums`
    psums a step a card), held as path AC holds its two-card layout:
    every card's replicated leaves the same bits, losses within
    PEER_TRAIN_LOSS_RTOL, parameters at path Z's limit but in AdamW's ε
    region (:func:`peer_update_diffs`), those at most EPS_EXEMPT_SHARE of
    the elements. Also held: step 1's gradients, each card's against its
    part of the unsharded step's, and its grad norm, within the family's
    DP_GRAD_REL of the leaf's largest |g| (path M's float32 bound); beside
    them the witness, the unsharded step's against its own from
    parameters nudged by a float32 rounding, and the control, the
    two-card step with f's backward psum skipped, which must exceed it.
    RWKV-6's parameters, which two steps of AdamW leave as far apart as
    its gradients' rounding moves their signs, within 2 x the summed lr
    (its gradients held as above)."""
    import dataclasses
    import math

    from repro_torch.kernels._graph import reset_launch_counts
    from repro_torch.models import tensor_parallel as tp
    from repro_torch.optim import OptimConfig
    from repro_torch.training import init_state
    from repro_torch.training import sharding as shd
    from repro_torch.tree import leaves_with_paths

    cfg = dataclasses.replace(full, num_layers=AD_TRAIN_LAYERS,
                              dtype="float32")
    nl, name = cfg.num_layers, full.name
    opt = OptimConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                      moment_dtype=full.optimizer_dtype)
    batches = family_batches(full, dev, 8, 512, 2)
    mbytes = torch.empty((), dtype=getattr(torch, opt.moment_dtype)
                         ).element_size()
    grad_bound = DP_GRAD_REL[cfg.family]

    def fresh(c):
        return init_state(c, opt, generator=torch.Generator(
            device=dev).manual_seed(81), device=dev)

    small: list = []
    with first_grads() as rec:
        (want_losses, want_norms, lrs, want_ms), want, delta = unsharded_run(
            cfg, fresh, batches, opt, dev, small)
    (want_g,) = rec.by_card()
    # the witness: the unsharded step from parameters nudged by about a
    # float32 rounding
    nudged = fresh(cfg)
    gen = torch.Generator(device=dev).manual_seed(82)
    for t in _leaves(nudged["params"]):
        t.mul_(1 + 1e-7 * torch.randn(t.shape, generator=gen, device=dev))
    with first_grads() as rec:
        train_run(cfg, None, [nudged], batches[:1], opt, dev)
    del nudged
    witness = grads_rel(rec.by_card(), want_g, [None])
    with emulated_cards(AB_CARD_OF, dev):
        cuts = shd.card_cuts(cfg, mesh)
        box = [shd.place_state(fresh(cfg), mesh, cfg)]
        placed = [state_bytes(tree) for tree in box[0]]
        reck = [tp_state_reckoning(cfg, c, mbytes) for c in cuts]
        check(len(cuts) == 2 and placed == reck, f"path AD: {name}'s "
              f"two-card state bytes {placed} (reckoned {reck})")
        torch.cuda.synchronize()
        with first_grads() as rec:
            reset_launch_counts()
            losses, norms, _, two_ms = train_run(cfg, mesh, box, batches,
                                                 opt, dev)
            read_path(f"AD-{tag}-train")
        got_g = rec.by_card()
        peak = torch.cuda.max_memory_allocated() / 2**30
        trees = box[0]
        box.clear()
        rep = [[t for path, t in leaves_with_paths(tree)
                if not shd.is_cut(path, cuts[0])] for tree in trees]
        replicas = all(torch.equal(a, b) for a, b in zip(*rep))
        del rep
        got = shd.unplace_state(trees, mesh, cfg)["params"]
        del trees
        # the control: f's backward psum skipped
        enter = tp.enter
        tp.enter = lambda *xs: xs
        try:
            with first_grads() as rec:
                train_run(cfg, mesh, [shd.place_state(fresh(cfg), mesh, cfg)],
                          batches[:1], opt, dev)
        finally:
            tp.enter = enter
        control = grads_rel(rec.by_card(), want_g, cuts)
    grad = grads_rel(got_g, want_g, cuts)
    del got_g, want_g, rec
    psums = ssm_step_psums(cfg, cuts[0])
    steps = len(batches)
    fwd, bwd = kernels
    # a ring program launches once a real card (both emulated cards'
    # parts in one launch); the mixer's kernel forward and recompute, and
    # its backward, once a card a layer
    want_counts = {"multipath_dma": 3 * psums * steps,
                   "ring_allgather": (psums + int(cuts[0].vocab)) * steps,
                   fwd: 2 * 2 * nl * steps, bwd: 2 * nl * steps}
    got_counts = {k: per_path[f"AD-{tag}-train"].get(k, 0)
                  for k in want_counts}
    diffs = peer_update_diffs(_leaves(got), _leaves(want), delta, small,
                              sum(lrs))
    exempt = math.ceil(EPS_EXEMPT_SHARE * diffs["elements"])
    losses = [float(x) for x in losses]
    want_l = [float(x) for x in want_losses]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses, want_l))
    norm_rels = [abs(float(a) - float(b)) / float(b)
                 for a, b in zip(norms, want_norms)]
    del got, want, small
    gc.collect()
    torch.cuda.empty_cache()
    print(f"path AD: {name} trained on the two-card layout "
          f"{list(AB_CARD_OF)} emulated on {dev}, {nl} layers in float32 "
          f"(TF32 off), remat full, 8 x 512 tokens: cuts {cuts[0]}; each "
          f"card {placed[0] / 1e9:.3f} GB of state (reckoned "
          f"{reck[0] / 1e9:.3f}, float32 moments); losses {losses} "
          f"(unsharded {want_l}; largest relative difference "
          f"{loss_rel:.3g}, limit {PEER_TRAIN_LOSS_RTOL}); step 1's "
          f"gradients, each card's against its part of the unsharded "
          f"step's, largest difference / the leaf's largest |g| "
          f"{grad[0]:.3g} ({grad[1]}; limit {grad_bound}); the witness, the "
          f"unsharded step's from parameters nudged by 1e-7, {witness[0]:.3g} "
          f"({witness[1]}); the control, f's psum skipped, {control[0]:.3g} "
          f"({control[1]}; must exceed the limit); grad_norm's relative "
          f"difference a step {[float(f'{x:.3g}') for x in norm_rels]} "
          f"(limit {grad_bound} at step 1, from the same parameters); "
          f"parameters' largest "
          f"difference {diffs['worst']} ({diffs['where']}) against the "
          f"unsharded update's largest |change| {delta} (limit "
          f"{PEER_TRAIN_DELTA_SHARE} of it): of {diffs['elements']} "
          f"elements {diffs['eps']} in AdamW's ε region beyond it (at most "
          f"{exempt}; largest {diffs['eps_worst']:.4g}, held within 2 x the "
          f"summed lr {2 * sum(lrs):.4g}), {diffs['beyond']} others beyond; "
          f"every card's replicated leaves the same bits {replicas}; step "
          f"ms {[round(t, 2) for t in two_ms]} (unsharded "
          f"{[round(t, 2) for t in want_ms]}; host clock, synced, one host "
          f"thread a card); launches {got_counts} over {steps} steps "
          f"({psums} psums a step a card); peak {peak:.2f} GiB", flush=True)
    check(got_counts == want_counts, f"path AD's two-card training of "
          f"{name} launched {got_counts}, not {want_counts}")
    check(replicas, f"path AD: {name}'s cards' replicated leaves differ")
    check(loss_rel <= PEER_TRAIN_LOSS_RTOL and all(
        math.isfinite(x) for x in losses), f"path AD: {name}'s losses "
          f"{losses} vs the unsharded step's {want_l}")
    check(grad[0] <= grad_bound < control[0]
          and norm_rels[0] <= grad_bound, f"path AD: {name}: step 1's "
          f"gradients {grad} and grad_norm {norm_rels[0]} against the limit "
          f"{grad_bound}; the control {control} must exceed it")
    if cfg.family == "ssm":
        check(diffs["worst"] <= 2 * sum(lrs), f"path AD: {name}: a "
              f"parameter differs by {diffs['worst']}, beyond 2 x the "
              f"summed lr {2 * sum(lrs)} ({diffs})")
    else:
        check(diffs["beyond"] == 0 and diffs["eps"] <= exempt, f"path AD: "
              f"{name}: {diffs['beyond']} parameters differ beyond "
              f"{PEER_TRAIN_DELTA_SHARE} of the unsharded update's largest "
              f"|change| {delta} outside AdamW's ε region, {diffs['eps']} "
              f"in it (at most {exempt}; {diffs})")
    return {"layers": nl, "placed_bytes": placed, "reckoned_bytes": reck,
            "psums_a_step": psums, "launches": got_counts, "step_ms": two_ms,
            "unsharded_ms": want_ms, "loss_rel": loss_rel,
            "norm_rel": norm_rels, "grad_rel": grad, "witness": witness,
            "control": control, "diffs": diffs, "delta": delta,
            "peak_gib": peak}


def ssm_tp_path(dev, errs, per_path, read_path, smi: str, at_g: dict,
                at_k: dict, rows: dict) -> dict:
    """Main path AD (phase 37): RWKV-6's time mix cut by whole heads and
    Hymba's Mamba by channels on a peer mesh on the one card, both at full
    width and depth in bfloat16 on paths G's and K's seeded weights and
    requests (``at_g``, ``at_k``). (1) Four logical devices on the card:
    nothing is cut, and tokens, prefill and decode logits are paths G's
    and K's bit for bit (counted runs). (2) The two-card layout
    ``AB_CARD_OF`` emulated on the card: each card's tree its 16 of 32
    RWKV-6 heads (or 800 of Hymba's 1600 Mamba channels), hidden units and
    vocabulary blocks (bytes as :func:`tp_reckoning`), its caches its
    heads' or channels' states; one eager prefill and decode step
    (counted: :func:`ssm_serve_psums` psums a forward), every card's
    logits the same bits, held with their twin (:func:`ssm_tp_serve`).
    (3) ``rwkv6_scan`` and its backward at a card's 16 heads against their
    plain versions and timed (:func:`ssm_tp_scans`, not counted). (4) Each
    model's float32 train step at AD_TRAIN_LAYERS layers on the emulated
    layout (:func:`ssm_tp_train`, counted)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_host_mesh

    # -- 37. main path AD: the state-space mixers tensor parallel ----------
    t_path = time.perf_counter()
    mesh = make_host_mesh((1, 4), devices=[dev] * 4)
    dev_gen = torch.Generator(device=dev).manual_seed(43)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=dev_gen, device=dev).to(dtype)

    def rand(*shape):
        return torch.rand(*shape, generator=dev_gen, device=dev)

    out = {}
    print(f"path AD: {torch.cuda.memory_allocated() / 2**30:.2f} GiB "
          f"allocated on the card as it starts", flush=True)
    rwkv, hymba = get_config("rwkv6_1_6b"), get_config("hymba_1_5b")
    out["rwkv6_1_6b"], layer0, params, toks = ssm_tp_serve(
        dev, per_path, read_path, rwkv, at_g, "G", "rwkv6_scan", 256)
    out["scans"] = ssm_tp_scans(randn, rand, errs, layer0, params, toks,
                                rwkv, rows)
    del layer0, params, toks
    gc.collect()
    torch.cuda.empty_cache()
    out["hymba_1_5b"], *rest = ssm_tp_serve(
        dev, per_path, read_path, hymba, at_k, "K", "flash_attention",
        at_k["toks"].shape[1] + at_k["new"])
    del rest
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["rwkv6_1_6b"]["train"] = ssm_tp_train(
        dev, per_path, read_path, rwkv, mesh, "G",
        ("rwkv6_scan", "rwkv6_scan_bwd"))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    out["hymba_1_5b"]["train"] = ssm_tp_train(
        dev, per_path, read_path, hymba, mesh, "K",
        ("flash_attention", "flash_attention_bwd"))
    out["seconds"] = time.perf_counter() - t_path
    print(f"path AD ({smi}): {out['seconds']:.1f} s", flush=True)
    return out


def main() -> int:
    t_run = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    from repro_torch.comm import (CommConfig, CommSession, PathPlanner,
                                  TransferRequest, lower)
    from repro_torch.core.topology import Topology
    from repro_torch.kernels import _build
    from repro_torch.kernels._graph import launch_counts
    from repro_torch.kernels.flash_attention import kernel as fk
    from repro_torch.kernels.jacobi import kernel as jk
    from repro_torch.kernels.multipath_dma import kernel as dk
    from repro_torch.kernels.multipath_dma import ops as dops
    from repro_torch.kernels.ring_allgather import kernel as rk

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    # -- 1. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"({', '.join(_build.KERNELS)}) into {_build.build_dir()}",
          flush=True)

    errs = {name: 0.0 for name in _build.KERNELS}
    gen = torch.Generator(device="cpu").manual_seed(0)
    dev_gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=dev_gen, device=dev).to(dtype)

    def rand(*shape):
        return torch.rand(*shape, generator=dev_gen, device=dev)

    def table_vs_plain(graph, nelems, dtypes, ndev, fill="zero"):
        """Run one scheduled graph through the kernel and the plain
        version on the same inputs; both outputs must match bit for bit
        and the completion counter must equal the copy-node count."""
        table = dk.build_node_table(graph, nelems,
                                    [d.itemsize for d in dtypes], ndev,
                                    fill=fill)
        kern = dk.DmaProgram(table, dtypes, dev)
        for buf in kern.inputs():
            buf.copy_(torch.randn(buf.shape, generator=gen).to(buf.dtype))
        plain_y = torch.zeros_like(kern.y)
        plain_stage = torch.empty_like(kern.stage)
        kern.run()
        done = kern.completed_nodes()
        plain_done = dk.run_node_table_plain(table.items, kern.x, plain_y,
                                             plain_stage)
        torch.cuda.synchronize()
        check(torch.equal(kern.y, plain_y), "multipath_dma differs from its "
              "plain version")
        check(done == graph.num_copy_nodes == plain_done,
              f"completion counter {done} (plain {plain_done}) != "
              f"{graph.num_copy_nodes} copy nodes")
        return kern

    # -- 2. multipath_dma vs plain ----------------------------------------
    t0 = time.perf_counter()
    planner = PathPlanner(Topology.full_mesh(4), multipath_threshold=0)
    n = 1_000_003
    cases = 0
    for dt in (torch.float32, torch.bfloat16):
        isz = dt.itemsize
        for paths in (1, 2, 3):
            for chunks in (1, 4, 8):
                plan = planner.plan(0, 1, n * isz, granularity=isz,
                                    max_paths=paths, num_chunks=chunks,
                                    include_host=False)
                x = randn(4, n, dtype=dt)
                got = dops.multipath_dma_transfer(x, plan)
                ref = x.clone()
                ref[plan.dst] = x[plan.src]
                check(torch.equal(got, ref), f"multipath_dma_transfer "
                      f"{dt} paths={paths} chunks={chunks}")
                for window in (1, 2):
                    table_vs_plain(lower(plan, window), [n], [dt], 4)
                    cases += 1
    group = planner.plan_group([TransferRequest(i, (i + 1) % 4, 4 * n, 4)
                                for i in range(4)])
    table_vs_plain(lower(group), [n] * 4, [torch.float32] * 4, 4)
    torus = CommSession(CommConfig(multipath_threshold=0), device=dev,
                        topology=Topology.torus2d(4, 4))
    msg = randn(n)
    got = torus.send(msg, 0, 1, max_paths=3, num_chunks=4)
    entry = next(iter(torus.engine._fastpath._store.values()))[1]
    hops = sorted(pa.route.num_hops for pa in entry.plans[0].paths)
    check(torch.equal(got, msg) and max(hops) == 3,
          f"torus2d(4,4) 3-hop send wrong (route hops {hops})")
    check(entry.compiled.program.completed_nodes()
          == entry.graph.num_copy_nodes, "torus completion counter")
    table_vs_plain(entry.graph, [n], [torch.float32], 16)
    print(f"multipath_dma vs plain: {cases} plan/window cases + exchange "
          f"group + torus2d(4,4) route hops {hops}: bitwise equal, "
          f"completion counter = copy nodes "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    # -- 3. jacobi vs plain -----------------------------------------------
    for dt, tol in ((torch.float32, 1e-6), (torch.bfloat16, 2e-2)):
        for w in (700, 1 << 22):
            ext = (torch.rand(8, w + 2, generator=gen) * 2 - 1).to(dt).to(dev)
            got = jk.jacobi_sweep_cuda(ext)
            ref = jk.jacobi_sweep_plain(ext)
            err = (got.float() - ref.float()).abs().max().item()
            errs["jacobi"] = max(errs["jacobi"], err)
            check(err <= tol, f"jacobi {dt} W={w}: max abs err {err} > {tol}")
            print(f"jacobi vs plain {str(dt)[6:]} W={w}: max abs err {err} "
                  f"(atol {tol})", flush=True)

    t0 = time.perf_counter()
    cases = 0
    for n_dev in (4, 8):
        for rows_, f_ in ((8, 128), (4, 64), (8, 7), (5, 3), (2048, 8192),
                          (1_572_864, 2)):
            for dt in (torch.float32, torch.bfloat16):
                xs = randn(n_dev, rows_, f_, dtype=dt)
                geo = rk.RingGeometry.for_shape(n_dev, rows_, f_, dt.itemsize)
                state = torch.empty(rk.STATE_WORDS, dtype=torch.int32,
                                    device=dev)
                got = rk.ring_allgather_cuda(xs, state=state)
                ref = rk.ring_allgather_plain(xs)
                check(torch.equal(got, ref), f"ring_allgather n={n_dev} "
                      f"({rows_}, {f_}) {dt} differs from plain")
                check(int(state[1].item()) == geo.num_items,
                      f"ring_allgather completed {int(state[1].item())} of "
                      f"{geo.num_items} items")
                cases += 1
                del xs, got, ref
    print(f"ring_allgather vs plain: {cases} cases bitwise equal, completed "
          f"items = table size ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    t0 = time.perf_counter()
    cases = 0

    def flash_case(shape, dtype, causal, window, atol, rtol):
        b, hq, hkv, s, d = shape
        q = (randn(b, hq, s, d) * 0.3).to(dtype)
        k = (randn(b, hkv, s, d) * 0.3).to(dtype)
        v = randn(b, hkv, s, d, dtype=dtype)
        got = fk.flash_attention_cuda(q, k, v, causal=causal, window=window)
        want = fk.flash_attention_plain(q, k, v, causal=causal,
                                        window=window)
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        errs["flash_attention"] = max(errs["flash_attention"], err)
        check(bool((diff <= atol + rtol * want.float().abs()).all()),
              f"flash_attention {shape} {dtype} causal={causal} "
              f"window={window}: max abs err {err} (atol {atol}, rtol "
              f"{rtol})")
        return err

    masks = ((True, None), (True, 64), (False, None))
    f32_err = bf16_err = 0.0
    for shape in ((1, 4, 2, 256, 64), (2, 4, 4, 128, 32), (1, 8, 2, 200, 64),
                  (1, 2, 1, 384, 128)):
        for causal, window in masks:
            f32_err = max(f32_err, flash_case(shape, torch.float32, causal,
                                              window, 3e-5, 1e-4))
            cases += 1
    f32_err = max(f32_err, flash_case((1, 32, 8, 512, 128), torch.float32,
                                      True, None, 3e-5, 1e-4))
    for causal, window in masks:
        bf16_err = max(bf16_err, flash_case((1, 4, 2, 128, 64),
                                            torch.bfloat16, causal, window,
                                            2e-2, 0.0))
        for d in (16, 32, 64):
            bf16_err = max(bf16_err, flash_case((1, 8, 2, 200, d),
                                                torch.bfloat16, causal,
                                                window, 2e-2, 0.0))
        bf16_err = max(bf16_err, flash_case((2, 32, 8, 300, 128),
                                            torch.bfloat16, causal, window,
                                            2e-2, 0.0))
    bf16_err = max(bf16_err, flash_case((1, 32, 16, 512, 128),
                                        torch.bfloat16, True, 64, 2e-2, 0.0))
    bf16_err = max(bf16_err, flash_case((1, 32, 8, 512, 128), torch.bfloat16,
                                        True, None, 2e-2, 0.0))
    print(f"flash_attention vs plain: {cases} float32 sweep cases + D=128 "
          f"32/8 heads (atol 3e-5, rtol 1e-4; max abs err {f32_err}), "
          f"bfloat16 sweep + D=16/32/64 at S=200 + (2, 32/8, 300, 128) + "
          f"Gemma-style window 64 at (1, 32/16, 512, 128) + 32/8 heads (max "
          f"abs 2e-2; max abs err {bf16_err}) "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)
    wide_head_dim_checks(randn, errs, flash_case)
    rwkv_checks(randn, rand, errs)

    main_launches = {name: 0 for name in _build.KERNELS}
    per_path: dict[str, dict[str, int]] = {}

    def read_path(name: str) -> None:
        """Add the launch counters since the last reset to the main-path
        totals and print them."""
        counts = launch_counts()
        per_path[name] = {k: v for k, v in counts.items() if v}
        for k, v in counts.items():
            main_launches[k] += v
        print(f"main path {name} launches: {per_path[name]}", flush=True)

    del torus, entry
    kernels, launch64 = comm_paths(dev, randn, errs, per_path, read_path)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.append(flash_times(randn, errs))
    kernels.append(rwkv_times(randn, rand, errs))
    serving_paths(dev, errs, per_path, read_path)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    at_g: dict = {}
    rwkv_path(dev, errs, per_path, read_path, at_g)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    calibration_path(dev, errs, per_path, read_path, launch64, smi)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    health_path(dev, errs, per_path, read_path, smi,
                launch64["replay256_ms"])
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.append(training_path(dev, errs, per_path, read_path, smi))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    at_k: dict = {}
    hymba_path(dev, errs, per_path, read_path, at_k)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    at_l = mixtral_path(dev, errs, per_path, read_path)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.append(families_training_path(dev, errs, per_path, read_path,
                                          smi))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fwd_n, bwd_n = hubert_training_path(dev, errs, per_path, read_path, smi)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    at_o_out: dict = {}
    at_o = serving_head_dims_path(dev, errs, per_path, read_path, smi,
                                  at_o_out)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    at_p = pipeline_path(dev, errs, per_path, read_path, smi)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    compression_path(dev, errs, per_path, read_path, smi)
    gc.collect()
    torch.cuda.empty_cache()
    captured_dma_check(dev)
    dryrun_cli_check()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    bwd_r = nemotron_training_path(dev, errs, per_path, read_path, smi)
    gc.collect()
    torch.cuda.empty_cache()
    mixtral_mesh_path(dev, errs, per_path, read_path, smi, at_l)
    gc.collect()
    torch.cuda.empty_cache()
    dryrun_probes_path(dev, errs, per_path, read_path, smi)
    gc.collect()
    torch.cuda.empty_cache()
    peer_path(dev, per_path, read_path, launch64)
    gc.collect()
    torch.cuda.empty_cache()
    peer_collectives_path(dev, per_path, read_path, launch64)
    gc.collect()
    torch.cuda.empty_cache()
    peer_capture_path(dev, errs, per_path, read_path, launch64)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    peer_training_path(dev, errs, per_path, read_path, smi)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    peer_moe_training_path(dev, per_path, read_path, smi)
    gc.collect()
    torch.cuda.empty_cache()
    peer_health_path(dev, errs, per_path, read_path, smi)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tensor_parallel_path(dev, per_path, read_path, smi, at_o_out)
    del at_o_out
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    tp_training_path(dev, per_path, read_path, smi)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    rows = {row["name"]: row for row in kernels}
    at_ad = ssm_tp_path(dev, errs, per_path, read_path, smi, at_g, at_k,
                        rows)
    del at_g, at_k
    gc.collect()
    torch.cuda.empty_cache()
    for name, share in at_ad["scans"].items():
        rows[name]["card_share"] = share
    for row in kernels:
        if row["name"] == "flash_attention":
            row["shapes"].update({"N": fwd_n, **at_o, "P": at_p})
        if row["name"] == "flash_attention_bwd":
            row["shapes"] = {"N": bwd_n, "R": bwd_r}
    print(f"main-path launches (paths A-AD): {main_launches}", flush=True)
    for name, count in main_launches.items():
        check(count > 0, f"{name} was not launched on the main path")

    # -- 38. report --------------------------------------------------------
    for row in kernels:
        row["launches"] = main_launches[row["name"]]
        row["max_abs_err"] = errs[row["name"]]
    print(f"chip_smoke: {time.perf_counter() - t_run:.1f} s in all, the "
          f"build included", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"card: {smi}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
