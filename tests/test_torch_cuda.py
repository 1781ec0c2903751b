"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA device and skip without one (the check runs
inside a fixture, never at import). On the card::

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest``: the shared ``conftest.py`` imports the reference
package, which the card's machine need not have.)

Copies are held bit for bit; the Jacobi sweep to float32 atol 1e-6 and
bfloat16 atol 2e-2 (the kernel rounds once, the plain version per add).
The all-gather (``-k ring_allgather``: the stacked kernel at path S's
combine shape and at shards that are not multiples of 16 bytes too) and
the captured Jacobi step (float32) are held bit for bit against their
plain or eager versions. Flash attention is held to
its plain version at the reference's tolerances (float32 atol 3e-5 /
rtol 1e-4, bfloat16 max abs 2e-2), its bfloat16 tile products to
torch.matmul (atol 1e-3 / rtol 1e-4), and the serving path on a reduced
model to the CPU's logits (atol 1e-3: cuBLAS and the CPU sum in other
orders). A send with telemetry on records a launch and an execute time within the
call's wall time, and sends stay bit for bit under a fitted profile.
The §4.6 ladder (``-k health``) on a stacked session, and on a peer
session of four logical devices in lockstep with a stacked one through a
failed link, a probe readmission and a host relay.
``ServeEngine``'s captured decode step is held bit for bit to
the eager ``make_serve_step`` (dense, ring, RWKV-6, hybrid (Mamba) and MoE
caches), the reduced Hymba, Mixtral and Kimi K2 served on the card
against the CPU, and its
programs' call and replay counts to one prefill and ``new - 1`` decode
steps per ``generate``; a failed capture raises. Flash attention runs at
the registered configs' head dims (80, 112, 192) and other widths the
rule admits (``-k "config_head_dims or wide_head_dim or hubert"``), its
backward at 80 and 112 through ``FlashAttentionFn``, reduced HuBERT's
gradients on the card against the CPU's, and reduced Kimi K2 (112) and
Nemotron-4 (192) served against the CPU. The RWKV-6 scan is held
to its plain version and to the literal
recurrence at the reference's tolerance (max error relative to the
largest output below 1e-4), outputs and final state, with bfloat16 r/k/v
beside float32 w, strided inputs, its first pass's chunk-start states
against the plain first pass at the same bound, and the reduced RWKV-6
model served against the CPU. ``-k rwkv`` runs the scan's tests alone.
Training (``-k "backward or train or grad or bwd"``): the attention
backward kernel against its plain version (float32 within 1e-4, bfloat16
within 2e-2 of the largest |want|) and through autograd, its bfloat16
tile products against torch.matmul (as the forward's), its alignment
checks, ``loss.backward()``
through the dense forward against the plain attention's gradients, the
RWKV-6 scan's backward kernel against its plain version (float32 within
1e-4, bfloat16 within 2e-2 of the largest |want|; float32 dw and du
within 1e-5) and through autograd,
reduced RWKV-6, Hymba and Mixtral gradients against the CPU's, and the
captured DP train step (dense and RWKV-6) against the eager steps at the
reference's tolerances. The pipeline and compression slice (``-k
"captured_multipath_dma or block_pipeline or compressed_psum"``): the
captured ``multipath_dma`` step bit for bit, a 4-stage pipeline of
reduced Llama-3 blocks through a CUDA session bit for bit as sequential
``block_apply``, and ``compressed_psum`` on the card against the CPU
within 1e-6. Peer sessions (``-k peer``): four logical devices on one
card, then on four cards (skipped below four cards that reach each
other), sends, a bidirectional, an exchange and Jacobi bit for bit as
the stacked session's, every result on its destination's device, one
``multipath_dma`` launch a replay a card; the peer ``ring_allgather``
(eager and replayed from a graph a card) bit for bit as its plain
version, every driver-level collective and every ``session.collectives``
op bit for bit as the stacked session's, one ``ring_allgather`` launch a
card a replay and one ``multipath_dma`` launch a card a ring shift.
Whole-iteration capture on a peer session (``-k peer_capture``): the
captured Jacobi step, ``captured_psum``, ``captured_ring_allgather`` with
a compute node, a migrating decode step and ``captured_multipath_dma``,
each bit for bit as the stacked session's (attention at path F's
tolerance), and a step whose hop-1 and hop-2 copies fall in different
runs, replayed three times bit for bit as the stacked program; on one
card, on four and on two cards holding two logical devices each. The
training side on a peer session (``-k peer_training``): the eager and
captured DP steps of a reduced SmolLM-360M (every replica on its own
device, bit for bit the stacked step's state, the captured replica d
row d of the stacked program over two chained calls), the compressed
mean on a per-device list and a reduced Llama-3 pipelined a stage a
device, each bit for bit as the stacked session's; on one card, on four
and on two cards holding two logical devices each.
Expert-parallel serving on a peer mesh (``-k peer_moe``): reduced
Mixtral served by ``ServeEngine`` under ``make_host_mesh((1, 4),
devices=...)``, tokens the stacked mesh's; on one card prefill and decode
logits bit for bit the stacked mesh's and one ``ring_allgather`` launch
a card a MoE layer a replay; on four cards and on two cards holding two
logical devices each (the attention and vocabulary then cut a card)
every card's logits the same bits, within 1e-5 of the stacked mesh's,
and one launch a card a psum and one for the logits; one graph a card a
program segment. Dense tensor parallelism (``-k tensor_parallel``): the
same for reduced Nemotron-4 at head dim 192.
Training under dense tensor parallelism on a peer mesh (``-k
tensor_parallel_training``): reduced Llama-3 (``remat="full"``, float32)
trained two steps from ``place_state(state, mesh, cfg)``: on one card bit
for bit the unsharded step; on four cards and on two cards holding two
logical devices each, within path Z's limits of it (AdamW's ε region
apart), every card's replicated leaves the same bits.
Expert-parallel training on a peer mesh (``-k peer_moe_training``):
reduced Mixtral (``remat="full"``) trained two steps by
``make_train_step`` from ``place_state`` under ``make_host_mesh((1, 4),
devices=...)`` against the stacked mesh's step, at path Z's limits
(losses rtol 1e-3, parameters within 2e-2 of the stacked update's
largest |change|), every card's replicated leaves the same bits; on one
card in bfloat16, and in float32 on four cards and on two cards holding
two logical devices each.
``multipath_dma`` at the edges of its copy paths (``-k edges``): tiles
whose ends differ mod 16, short items, tiles that are not multiples of 16
bytes, a 1-byte dtype of odd length, a window of 2 and a three-path plan,
each per-device table bit for bit as ``run_node_table_plain``'s, eagerly
and replayed, as four logical devices on one card and on four cards.
"""

import dataclasses
import time

import pytest
import torch

from repro_torch.comm import CommConfig, CommSession, PathPlanner, lower
from repro_torch.comm.engine import PlacedKey
from repro_torch.comm.passes import apply_schedule
from repro_torch.core.halo import jacobi_step, make_captured_jacobi_step
from repro_torch.configs import get_config
from repro_torch.core.topology import Topology
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.jacobi import kernel as jk
from repro_torch.kernels.multipath_dma import kernel as dk
from repro_torch.kernels.ring_allgather import kernel as rk
from repro_torch.kernels.rwkv6_scan import kernel as sk
from repro_torch.kernels.rwkv6_scan import ops as sops
from repro_torch.kernels.rwkv6_scan.ref import rwkv6_scan_ref
from repro_torch.models import layers
from repro_torch.models import transformer as tfm
from repro_torch.serving import (Request, ServeEngine,
                                 make_captured_decode_step, make_serve_step)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("schedule", ["round_robin", "critical_path"])
@pytest.mark.parametrize("window", [1, 2])
def test_multipath_dma_matches_plain(dev, schedule, window):
    topo = Topology.torus2d(4, 4)
    pp = PathPlanner(topo, multipath_threshold=4)
    group = pp.plan_group([(0, 1, 4 * 100_003, 4), (5, 6, 2 * 77_777, 2)])
    graph, _ = apply_schedule(lower(group, window), schedule, topo)
    table = dk.build_node_table(graph, [100_003, 77_777], [4, 2], 16,
                                tile_bytes=4096)
    prog = dk.DmaProgram(table, [torch.float32, torch.bfloat16], dev)
    for buf in prog.inputs():
        buf.copy_(torch.randn(buf.shape, device=dev).to(buf.dtype))
    prog.run()
    plain_y = torch.zeros_like(prog.y)
    plain_done = dk.run_node_table_plain(table.items, prog.x, plain_y,
                                         torch.empty_like(prog.stage))
    assert prog.completed_nodes() == graph.num_copy_nodes == plain_done
    assert torch.equal(prog.y, plain_y)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape", [(8, 702), (2, 5, 1027)])
def test_jacobi_matches_plain(dev, dtype, tol, shape):
    ext = (torch.rand(shape, device=dev) * 2 - 1).to(dtype)
    got = jk.jacobi_sweep_cuda(ext)
    ref = jk.jacobi_sweep_plain(ext)
    assert (got.float() - ref.float()).abs().max().item() <= tol


def test_session_send_replays_one_launch(dev):
    sess = CommSession(CommConfig(multipath_threshold=0), device=dev)
    x = torch.randn(1 << 20, device=dev)
    assert torch.equal(sess.send(x, 0, 3, max_paths=3, num_chunks=4), x)
    before = dk.LAUNCHES
    assert torch.equal(sess.send(x, 0, 3, max_paths=3, num_chunks=4), x)
    assert dk.LAUNCHES == before + 1
    assert sess.stats()["fastpath"]["hits"] == 1


def test_session_telemetry_times_the_replay_and_calibrates(dev, tmp_path):
    """Telemetry on the card: each send's sample has a launch and an
    execute time, with a stage sum within the call's wall time; a profile
    fitted from 3 sizes attaches, and later sends stay bitwise."""
    sess = CommSession(CommConfig(telemetry=True, multipath_threshold=0,
                                  profile_dir=str(tmp_path)), device=dev)
    sizes = (16 * 1024, 1 << 18, 1 << 22)                # 64 KiB – 16 MiB
    for n in sizes:
        x = torch.randn(n, device=dev)
        for _ in range(5):
            t0 = time.perf_counter_ns()
            got = sess.send(x, 0, 1, max_paths=3)
            wall = time.perf_counter_ns() - t0
            assert torch.equal(got, x)
            st = sess.telemetry.samples()[-1].stages
            assert st.launch_ns > 0 and st.execute_ns > 0
            assert st.total_ns <= wall
    assert len(sess.telemetry) == sess.stats()["dispatches"] == 15
    prof = sess.calibrate(min_samples=3, warmup=1, persist=True)
    assert sess.topology.calibration is prof
    assert prof.launch is not None and prof.link_bandwidth_gbps
    for n in sizes + (12_345,):
        x = torch.randn(n, device=dev)
        for _ in range(2):
            assert torch.equal(sess.send(x, 0, 1, max_paths=3), x)
    again = CommSession(CommConfig(profile_dir=str(tmp_path)), device=dev)
    assert again.topology.calibration.to_payload() == prof.to_payload()


@pytest.mark.parametrize("n", [1, 4, 8])
@pytest.mark.parametrize("rows,f", [(8, 128), (4, 64), (8, 7), (3, 1),
                                    (300, 1000), (1_572_864, 2), (5, 3)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_allgather_matches_plain(dev, n, rows, f, dtype):
    """(1572864, 2) bf16 is path S's combine gather; (5, 3) shards (60 and
    30 bytes) and (3, 1) are not multiples of 16 bytes, so the replicas'
    blocks sit at offsets that take narrower vectors."""
    xs = torch.randn(n, rows, f, device=dev).to(dtype)
    g = rk.RingGeometry.for_shape(n, rows, f, xs.element_size())
    state = torch.empty(rk.STATE_WORDS, dtype=torch.int32, device=dev)
    got = rk.ring_allgather_cuda(xs, state=state)
    assert int(state[1].item()) == g.num_items
    assert torch.equal(got, rk.ring_allgather_plain(xs))


def test_session_all_gather_is_one_replay(dev):
    sess = CommSession(device=dev)
    x = torch.randn(4 * 64, 96, device=dev)
    assert torch.equal(sess.all_gather(x), x)
    before = rk.LAUNCHES
    assert torch.equal(sess.all_gather(x), x)
    assert rk.LAUNCHES == before + 1
    assert sess.stats()["cache"]["hits"] == 1


def test_captured_jacobi_bitwise_eager_one_dispatch(dev):
    sess = CommSession(device=dev)
    u = torch.randn(4, 8, 1000, device=dev)
    step = make_captured_jacobi_step(sess, 8, 1000)
    (out,) = step(u)
    assert torch.equal(out, jacobi_step(u, session=sess))
    d0, j0, m0 = sess.stats()["dispatches"], jk.LAUNCHES, dk.LAUNCHES
    (out2,) = step(out)
    assert sess.stats()["dispatches"] == d0 + 1
    assert (jk.LAUNCHES, dk.LAUNCHES) == (j0 + 1, m0 + 1)
    assert torch.equal(out2, jacobi_step(out, session=sess))


FLASH_SWEEP = [(1, 4, 2, 256, 64), (2, 4, 4, 128, 32), (1, 8, 2, 200, 64),
               (1, 2, 1, 384, 128), (2, 4, 2, 77, 16), (1, 32, 8, 512, 128)]
FLASH_MASKS = [(True, None), (True, 64), (False, None), (False, 64)]


def _qkv(dev, b, hq, hkv, s, d, dtype=torch.float32):
    g = torch.Generator(device=dev).manual_seed(b * 1000 + s + d)
    q = torch.randn(b, hq, s, d, generator=g, device=dev) * 0.3
    k = torch.randn(b, hkv, s, d, generator=g, device=dev) * 0.3
    v = torch.randn(b, hkv, s, d, generator=g, device=dev)
    return q.to(dtype), k.to(dtype), v.to(dtype)


@pytest.mark.parametrize("b,hq,hkv,s,d", FLASH_SWEEP)
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
def test_flash_attention_matches_plain(dev, b, hq, hkv, s, d, causal,
                                       window):
    q, k, v = _qkv(dev, b, hq, hkv, s, d)
    before = fk.LAUNCHES
    got = fk.flash_attention_cuda(q, k, v, causal=causal, window=window)
    assert fk.LAUNCHES == before + 1
    want = fk.flash_attention_plain(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, atol=3e-5, rtol=1e-4)


#: Head dims the tensor-core kernels are built at without padding.
HEAD_DIMS = (16, 32, 64, 128)
#: The registered configs' head dims the kernels take padded (80: HuBERT,
#: 112: Kimi K2) or at their widest (192: Nemotron-4, forward only).
WIDE_DIMS = (80, 112, 192)

#: bfloat16 cases: every head dim, ragged lengths, GQA 32/8 and MHA.
FLASH_BF16 = ([(1, 4, 2, 128, 64), (1, 32, 8, 300, 128)]
              + [(1, 32, 8, 200, d) for d in HEAD_DIMS]
              + [(2, 4, 4, 300, d) for d in HEAD_DIMS])


@pytest.mark.parametrize("causal,window", FLASH_MASKS)
@pytest.mark.parametrize("shape", FLASH_BF16)
def test_flash_attention_bf16_matches_plain(dev, causal, window, shape):
    q, k, v = _qkv(dev, *shape, dtype=torch.bfloat16)
    got = fk.flash_attention_cuda(q, k, v, causal=causal, window=window)
    assert got.dtype == torch.bfloat16
    want = fk.flash_attention_plain(q, k, v, causal=causal, window=window)
    assert (got.float() - want.float()).abs().max().item() < 2e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", FLASH_MASKS)
@pytest.mark.parametrize("shape", [(1, 4, 2, 200), (2, 8, 8, 130)])
@pytest.mark.parametrize("d", WIDE_DIMS + (8, 40, 72, 96, 120))
def test_flash_attention_config_head_dims_match_plain(dev, d, shape, causal,
                                                      window, dtype):
    """At the configs' head dims and other widths the rule admits (a
    multiple of 8 up to 128: the bfloat16 kernel pads the tile to 16, 32,
    64 or 128 columns; 192), the kernel against its plain version: float32
    atol 3e-5 / rtol 1e-4, bfloat16 max abs 2e-2."""
    q, k, v = _qkv(dev, *shape, d, dtype=dtype)
    got = fk.flash_attention_cuda(q, k, v, causal=causal, window=window)
    assert got.shape == q.shape and got.dtype == dtype
    want = fk.flash_attention_plain(q, k, v, causal=causal, window=window)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=3e-5, rtol=1e-4)
    else:
        assert (got.float() - want.float()).abs().max().item() < 2e-2


@pytest.mark.parametrize("d", HEAD_DIMS + WIDE_DIMS)
def test_flash_attention_tile_products_match_matmul(dev, d):
    """One tile of Q·Kᵀ and P·V through the kernel's TMA loads, swizzled
    layouts and wgmma fragments against torch.matmul in float32: the
    products of bfloat16 values are exact, so only the order and rounding
    of the float32 sums differ (|q·kᵀ| reaches ~50 at D = 128). A layout
    fault gives errors of order 1."""
    g = torch.Generator(device=dev).manual_seed(d)
    q, k, v = (torch.randn(64, d, generator=g, device=dev).to(torch.bfloat16)
               for _ in range(3))
    p = torch.rand(64, 64, generator=g, device=dev).to(torch.bfloat16)
    s, o = fk.tile_products_cuda(q, k, v, p)
    torch.testing.assert_close(s, q.float() @ k.float().T, atol=1e-3,
                               rtol=1e-4)
    torch.testing.assert_close(o, p.float() @ v.float(), atol=1e-3,
                               rtol=1e-4)


def test_flash_attention_bf16_rejects_misaligned(dev):
    flat = torch.randn(2 * 64 * 64 + 1, device=dev)
    for dtype in (torch.bfloat16, torch.float32):
        x = flat.to(dtype)[1:].view(1, 2, 64, 64)
        if dtype == torch.bfloat16:
            with pytest.raises(ValueError, match="16-byte aligned"):
                fk.flash_attention_cuda(x, x, x)
        else:
            torch.testing.assert_close(fk.flash_attention_cuda(x, x, x),
                                       fk.flash_attention_plain(x, x, x),
                                       atol=3e-5, rtol=1e-4)
    wide = torch.randn(1, 2, 64, 68, device=dev).to(torch.bfloat16)
    with pytest.raises(ValueError, match="multiples of 8"):
        fk.flash_attention_cuda(wide[..., :64], wide[..., :64],
                                wide[..., :64])


def test_flash_attention_strided_and_rejects(dev):
    x = torch.randn(2, 96, 4, 64, device=dev)
    kv = torch.randn(2, 96, 2, 64, device=dev)
    q, k = x.transpose(1, 2), kv.transpose(1, 2)
    got = fk.flash_attention_cuda(q, k, k, window=40)
    want = fk.flash_attention_plain(q.contiguous(), k.contiguous(),
                                    k.contiguous(), window=40)
    torch.testing.assert_close(got, want, atol=3e-5, rtol=1e-4)
    for d in (4, 100, 136, 256):       # outside the head-dim rule
        t = torch.zeros(1, 2, 8, d, device=dev)
        with pytest.raises(ValueError, match="head dims"):
            fk.flash_attention_cuda(t, t, t)
    t = torch.zeros(1, 2, 16, 16, device=dev).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous head dim"):
        fk.flash_attention_cuda(t, t, t)


def test_blockwise_attention_runs_the_kernel(dev):
    q, k, v = _qkv(dev, 1, 4, 2, 130, 32)
    before = fk.LAUNCHES
    got = layers.blockwise_attention(q, k, v, causal=True, window=-1,
                                     scale=32 ** -0.5)
    assert fk.LAUNCHES == before + 1
    want = layers.blockwise_attention(q.cpu(), k.cpu(), v.cpu(),
                                      causal=True, window=-1,
                                      scale=32 ** -0.5)
    torch.testing.assert_close(got.cpu(), want, atol=3e-5, rtol=1e-4)


def test_serving_reduced_model_matches_cpu(dev):
    cfg = get_config("gemma3_27b").reduced()
    params = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    cuda_params = {"embed": params["embed"].to(dev),
                   "final_norm": params["final_norm"].to(dev),
                   "lm_head": params["lm_head"].to(dev),
                   "layers": {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                                  if isinstance(v, dict) else v.to(dev))
                              for k, v in params["layers"].items()}}
    toks = [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12], [5, 6, 7] * 4]
    cpu = ServeEngine(cfg, params, max_len=32, kv_chunks=4)
    gpu = ServeEngine(cfg, cuda_params, max_len=32, kv_chunks=4)
    lc, _ = cpu.prefill(toks)
    before = fk.LAUNCHES
    lg, _ = gpu.prefill(toks)
    assert fk.LAUNCHES == before + cfg.num_layers
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-3, rtol=0)
    reqs = [Request([1, 2, 3], 5), Request([7, 8, 9, 10], 6)]
    a = gpu.generate([Request(list(r.prompt), r.max_new_tokens)
                      for r in reqs])
    b = gpu.generate([Request(list(r.prompt), r.max_new_tokens)
                      for r in reqs])
    assert [r.out for r in a] == [r.out for r in b]


def _on(tree, dev):
    if isinstance(tree, dict):
        return {key: _on(t, dev) for key, t in tree.items()}
    return tree.to(dev)


def _served(dev, arch, swa=False):
    cfg = get_config(arch).reduced()
    if swa:
        cfg = dataclasses.replace(cfg, attention="swa", window=8)
    params = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    return cfg, _on(params, dev), ServeEngine(cfg, _on(params, dev),
                                              max_len=32, kv_chunks=4)


@pytest.mark.parametrize("arch,swa", [("llama3_8b", False),
                                      ("llama3_8b", True),
                                      ("gemma3_27b", False),
                                      ("rwkv6_1_6b", False),
                                      ("hymba_1_5b", False),
                                      ("mixtral_8x22b", False),
                                      ("kimi_k2_1t_a32b", False)],
                         ids=["llama3_8b", "llama3_8b-swa", "gemma3_27b",
                              "rwkv6_1_6b", "hymba_1_5b", "mixtral_8x22b",
                              "kimi_k2_1t_a32b"])
def test_captured_decode_logits_equal_the_eager_step(dev, arch, swa):
    """Three calls of the decode program (a capture, then two replays)
    against ``make_serve_step`` on a copy of the same cache, token and
    position: logits and cache bit for bit."""
    cfg, params, engine = _served(dev, arch, swa)
    prefill = engine.prefill_program(2, 12)
    prefill.tokens.copy_(torch.tensor([list(range(1, 13)), [5, 6, 7] * 4]))
    tok = prefill()[:, -1].argmax(-1)[:, None]
    decode = engine.decode_program(2)
    step = make_serve_step(cfg, engine.spec)
    for pos in range(12, 15):
        eager = {k: t.clone() for k, t in decode.cache.items()}
        want, _ = step(params, eager, tok, pos)
        decode.tokens.copy_(tok)
        decode.cur_len.fill_(pos)
        got = decode()
        assert torch.equal(got, want)
        assert all(torch.equal(decode.cache[k], eager[k]) for k in eager)
        tok = got.argmax(-1)[:, None]
    assert (decode.calls, decode.replays) == (3, 2)


@pytest.mark.parametrize("arch", ["hymba_1_5b", "mixtral_8x22b",
                                  "kimi_k2_1t_a32b"])
def test_hybrid_and_moe_serving_reduced_model_matches_cpu(dev, arch):
    """The reduced model's prefill on the card (attention through the
    kernel, one launch a layer) against the CPU's logits and cache within
    atol 1e-3 (cuBLAS and the CPU sum in other orders); captured
    ``generate`` twice gives the same tokens, and its greedy tokens equal
    an eager loop of ``make_serve_step`` on the card."""
    cfg = get_config(arch).reduced()
    params = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    toks = [list(range(1, 13)), [5, 6, 7] * 4]
    cpu = ServeEngine(cfg, params, max_len=32, kv_chunks=4)
    gpu = ServeEngine(cfg, _on(params, dev), max_len=32, kv_chunks=4)
    lc, cc = cpu.prefill(toks)
    before = fk.LAUNCHES
    lg, cg = gpu.prefill(toks)
    assert fk.LAUNCHES == before + cfg.num_layers
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-3, rtol=0)
    for key in cc:
        torch.testing.assert_close(cg[key].cpu(), cc[key], atol=1e-3,
                                   rtol=0)
    new = 6
    a = gpu.generate([Request(list(p), new) for p in toks])
    b = gpu.generate([Request(list(p), new) for p in toks])
    assert [r.out for r in a] == [r.out for r in b]
    logits, cache = tfm.prefill_forward(
        gpu.params, cfg, {"tokens": torch.tensor(toks, device=dev)},
        gpu.spec)
    step = make_serve_step(cfg, gpu.spec)
    tok = logits[:, -1].argmax(-1)
    eager = [tok]
    for i in range(new - 1):
        lg, cache = step(gpu.params, cache, tok[:, None], 12 + i)
        tok = lg.argmax(-1)
        eager.append(tok)
    assert [r.out for r in a] == torch.stack(eager, 1).tolist()


def test_generate_runs_through_the_programs(dev):
    """A ``generate`` of ``new`` tokens calls the prefill program once and
    the decode program ``new - 1`` times: the first ``generate`` captures
    both, the second only replays them (one prefill's ``flash_attention``
    launches), with the same tokens."""
    cfg, _, engine = _served(dev, "llama3_8b")
    new = 5

    def run():
        return [r.out for r in engine.generate(
            [Request([1, 2, 3], new), Request([7, 8, 9, 10], new)])]

    first = run()
    prefill, decode = engine._prefills[(2, 4)], engine._decodes[2]
    assert (prefill.calls, prefill.replays) == (1, 0)
    assert (decode.calls, decode.replays) == (new - 1, new - 2)
    before = fk.LAUNCHES
    assert run() == first
    assert fk.LAUNCHES == before + cfg.num_layers
    assert (prefill.calls, prefill.replays) == (2, 1)
    assert (decode.calls, decode.replays) == (2 * (new - 1), 2 * new - 3)
    assert prefill.held_bytes > 0 and decode.held_bytes > 0
    assert engine.graph_bytes() == prefill.held_bytes + decode.held_bytes


def test_a_failed_capture_raises(dev, monkeypatch):
    """A decode step that cannot be captured raises from ``generate``,
    every time, and the program stays uncaptured: nothing runs it eagerly
    instead."""
    _, _, engine = _served(dev, "llama3_8b")
    real = tfm.decode_step

    def uncapturable(*args, **kwargs):
        out = real(*args, **kwargs)
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("cannot be captured")
        return out

    monkeypatch.setattr(tfm, "decode_step", uncapturable)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="cannot be captured"):
            engine.generate([Request([1, 2, 3], 3)])
    decode = engine._decodes[1]
    assert not decode._graphs and decode.replays == 0
    assert decode.calls == 2


def test_captured_decode_step_one_dispatch(dev):
    sess = CommSession(device=dev)
    n = sess.num_devices
    step = make_captured_decode_step(sess, batch=1, heads=4, kv_len=256,
                                     head_dim=64, kv_chunk=1 << 20, src=0,
                                     dst=2, dtype=torch.bfloat16,
                                     schedule="overlap")
    q, k, v = _qkv(dev, n, 4, 4, 256, 64, dtype=torch.bfloat16)
    q, k, v = (t.view(n, 1, 4, 256, 64) for t in (q, k, v))
    kv = torch.randn(n, 1 << 20, device=dev).to(torch.bfloat16)
    step(q, k, v, kv)
    d0, f0, m0 = sess.stats()["dispatches"], fk.LAUNCHES, dk.LAUNCHES
    attn, new_kv = step(q, k, v, kv)
    assert sess.stats()["dispatches"] == d0 + 1
    assert fk.LAUNCHES == f0 + 1 and dk.LAUNCHES > m0
    want = fk.flash_attention_plain(q.view(n, 4, 256, 64),
                                    k.view(n, 4, 256, 64),
                                    v.view(n, 4, 256, 64))
    assert (attn.view(n, 4, 256, 64).float() - want.float()
            ).abs().max().item() < 2e-2
    expect = kv.clone()
    expect[2] = kv[0]
    assert torch.equal(new_kv, expect)


RWKV_SWEEP = [(2, 128, 32, 32, 32), (1, 200, 64, 64, 64),
              (4, 64, 16, 32, 16), (1, 96, 8, 8, 32)]


def _rwkv(dev, b, s, h, dk, dv, dtype=torch.float32):
    """Inputs of the reference sweep's distributions, (B, S, H, d)."""
    g = torch.Generator(device=dev).manual_seed(b * 1000 + s + dk + dv)
    r = torch.randn(b, s, h, dk, generator=g, device=dev) * 0.5
    k = torch.randn(b, s, h, dk, generator=g, device=dev) * 0.5
    v = torch.randn(b, s, h, dv, generator=g, device=dev)
    w = torch.rand(b, s, h, dk, generator=g, device=dev) * 0.149 + 0.85
    u = torch.randn(b, h, dk, generator=g, device=dev) * 0.3
    return r.to(dtype), k.to(dtype), v.to(dtype), w, u


def _rel(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("bh,s,dk,dv,chunk", RWKV_SWEEP)
def test_rwkv6_scan_matches_plain_and_recurrence(dev, bh, s, dk, dv, chunk):
    *rkvw, u = _rwkv(dev, bh, s, 1, dk, dv)
    r, k, v, w = (t[:, :, 0] for t in rkvw)
    u = u[:, 0]
    before = sk.LAUNCHES
    got = sops.rwkv6_scan(r, k, v, w, u, chunk=chunk)
    assert sk.LAUNCHES == before + 1
    plain = sops.rwkv6_scan(r.cpu(), k.cpu(), v.cpu(), w.cpu(), u.cpu(),
                            chunk=chunk)
    assert _rel(got.cpu(), plain) < 1e-4
    assert _rel(got, rwkv6_scan_ref(r, k, v, w, u)) < 1e-4


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_rwkv6_scan_bf16_inputs_and_final_state(dev, out_dtype):
    """The model's mix: bfloat16 r/k/v, float32 w and u, the bonus of a
    head broadcast over the batch, and the final state."""
    r, k, v, w, u = _rwkv(dev, 2, 256, 4, 64, 64, dtype=torch.bfloat16)
    u = u[:1].expand(2, -1, -1)
    o, st = sk.rwkv6_scan_cuda(r, k, v, w, u, chunk=64, out_dtype=out_dtype,
                               return_state=True)
    po, pst = sk.rwkv6_scan_plain(r, k, v, w, u, chunk=64,
                                  out_dtype=torch.float32, return_state=True)
    assert o.dtype == out_dtype and st.dtype == torch.float32
    assert _rel(st, pst) < 1e-4
    if out_dtype == torch.float32:
        assert _rel(o, po) < 1e-4
    else:
        diff = (o.float() - po).abs()
        assert bool((diff <= 4e-3 + 8e-3 * po.abs()).all())


def test_rwkv6_scan_strided_and_rejects(dev):
    r, k, v, w, u = _rwkv(dev, 2, 128, 3, 16, 32)
    heads_first = [t.transpose(1, 2).contiguous().transpose(1, 2)
                   for t in (r, k, v, w)]
    assert not heads_first[0].is_contiguous()
    a = sk.rwkv6_scan_cuda(r, k, v, w, u, chunk=32)
    b = sk.rwkv6_scan_cuda(*heads_first, u, chunk=32)
    assert torch.equal(a, b)
    for dk, dv in ((12, 16), (16, 128)):
        bad = _rwkv(dev, 1, 64, 1, dk, dv)
        with pytest.raises(ValueError, match="dk and dv"):
            sk.rwkv6_scan_cuda(*bad, chunk=64)
    with pytest.raises(ValueError, match="chunks up to 64"):
        sk.rwkv6_scan_cuda(r, k, v, w, u, chunk=128)
    with pytest.raises(ValueError, match="contiguous last dim"):
        t = r.transpose(2, 3).contiguous().transpose(2, 3)
        sk.rwkv6_scan_cuda(t, k, v, w, u, chunk=32)
    with pytest.raises(ValueError, match="float32 u"):
        sk.rwkv6_scan_cuda(r, k, v, w, u.to(torch.bfloat16), chunk=32)
    with pytest.raises(ValueError, match="float32 w"):
        sk.rwkv6_scan_cuda(r, k, v, w.to(torch.bfloat16), u, chunk=32)


@pytest.mark.parametrize("b,s,h,dk,dv,dtype", [
    (2, 256, 2, 64, 64, torch.float32), (2, 128, 3, 16, 32, torch.float32),
    (1, 96, 2, 8, 8, torch.float32), (4, 1024, 32, 64, 64, torch.bfloat16)])
def test_rwkv6_chunk_states_match_plain(dev, b, s, h, dk, dv, dtype):
    """The first pass's workspace (the state at every chunk's start) and
    final state against the plain first pass, at the model's shape too;
    the two passes launched apart give the scan's output bit for bit and
    do not count as a launch; a base off the 16-byte grid is copied and
    gives the same output."""
    r, k, v, w, u = _rwkv(dev, b, s, h, dk, dv, dtype=dtype)
    chunk = 64 if s % 64 == 0 else 32
    before = sk.LAUNCHES
    o, states, final = sk.rwkv6_scan_passes_cuda(
        r, k, v, w, u, chunk=chunk, out_dtype=torch.float32)
    assert sk.LAUNCHES == before
    pstates, pfinal = sk.rwkv6_chunk_states_plain(k, v, w, chunk=chunk)
    assert states.shape == pstates.shape == (b, h, s // chunk, dk, dv)
    assert _rel(states, pstates) < 1e-4 and _rel(final, pfinal) < 1e-4
    assert torch.equal(o, sk.rwkv6_scan_cuda(r, k, v, w, u, chunk=chunk,
                                             out_dtype=torch.float32))
    shifted = torch.empty(r.numel() + 1, dtype=dtype, device=dev)[1:]
    assert torch.equal(o, sk.rwkv6_scan_cuda(
        shifted.view(r.shape).copy_(r), k, v, w, u, chunk=chunk,
        out_dtype=torch.float32))


def test_rwkv_serving_reduced_model_matches_cpu(dev):
    cfg = get_config("rwkv6_1_6b").reduced()
    params = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0))

    def to(tree):
        if isinstance(tree, dict):
            return {key: to(t) for key, t in tree.items()}
        return tree.to(dev)

    toks = [[1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12], [5, 6, 7] * 4]
    cpu = ServeEngine(cfg, params, max_len=32)
    gpu = ServeEngine(cfg, to(params), max_len=32)
    lc, cc = cpu.prefill(toks)
    before = sk.LAUNCHES
    lg, cg = gpu.prefill(toks)
    assert sk.LAUNCHES == before + cfg.num_layers
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-3, rtol=0)
    torch.testing.assert_close(cg["rwkv_state"].cpu(), cc["rwkv_state"],
                               atol=1e-3, rtol=0)
    reqs = [Request([1, 2, 3], 5), Request([7, 8, 9, 10], 6)]
    a = gpu.generate([Request(list(r.prompt), r.max_new_tokens)
                      for r in reqs])
    b = gpu.generate([Request(list(r.prompt), r.max_new_tokens)
                      for r in reqs])
    assert [r.out for r in a] == [r.out for r in b]


def test_health_midtraffic_failure_bitwise_digest_restored(dev):
    """A send keeps arriving bitwise through a failure of (0, 1), never
    over it; after the restore the pre-fault digest comes back as a
    plan-cache hit (no new capture)."""
    sess = CommSession(device=dev)
    x = torch.randn(1 << 20, device=dev)
    pre = sess.describe(0, 1, x.numel() * 4, max_paths=3)["graph"]["digest"]
    assert torch.equal(sess.send(x, 0, 1, max_paths=3), x)
    sess.topology.fail_link(0, 1)
    for _ in range(2):
        assert torch.equal(sess.send(x, 0, 1, max_paths=3), x)
        misses = sess.stats()["cache"]["misses"]
        _, plan = sess.compiled_for(0, 1, x.numel(), max_paths=3)
        assert sess.stats()["cache"]["misses"] == misses   # the one sent
        assert (0, 1) not in plan.directional_links()
        assert sess.stats()["health"]["ladder_level"] == 1
    sess.topology.restore_link(0, 1)
    misses = sess.stats()["cache"]["misses"]
    assert torch.equal(sess.send(x, 0, 1, max_paths=3), x)
    assert sess.stats()["cache"]["misses"] == misses
    assert sess.stats()["health"]["ladder_level"] == 0
    assert sess.describe(0, 1, x.numel() * 4,
                         max_paths=3)["graph"]["digest"] == pre


def test_health_host_relay_bitwise_pinned(dev, monkeypatch):
    """With no device route left the send goes through a pinned host
    buffer, bitwise, at ladder level 3."""
    sess = CommSession(device=dev, topology=Topology.full_mesh(2))
    x = torch.randn(1 << 20, device=dev)
    sess.topology.fail_link(0, 1)
    pinned = []
    empty = torch.empty

    def spy(*args, **kw):
        out = empty(*args, **kw)
        if kw.get("pin_memory"):
            pinned.append(out.is_pinned())
        return out

    monkeypatch.setattr(torch, "empty", spy)
    out = sess.send(x, 0, 1)
    monkeypatch.undo()
    assert torch.equal(out, x) and out.device == x.device
    assert pinned == [True]
    health = sess.stats()["health"]
    assert health["ladder_level"] == 3 and health["host_relays"] == 1


def test_health_captured_decode_step_under_failed_link(dev):
    sess = CommSession(device=dev)
    n = sess.num_devices
    step = make_captured_decode_step(sess, batch=1, heads=4, kv_len=256,
                                     head_dim=64, kv_chunk=1 << 20, src=0,
                                     dst=2, dtype=torch.bfloat16,
                                     schedule="overlap")
    q, k, v = _qkv(dev, n, 4, 4, 256, 64, dtype=torch.bfloat16)
    want = fk.flash_attention_plain(q, k, v)
    q, k, v = (t.view(n, 1, 4, 256, 64) for t in (q, k, v))
    kv = torch.randn(n, 1 << 20, device=dev).to(torch.bfloat16)
    expect = kv.clone()
    expect[2] = kv[0]
    for fault in (None, "fail", "restore"):
        if fault == "fail":
            sess.topology.fail_link(0, 2)
        elif fault == "restore":
            sess.topology.restore_link(0, 2)
        attn, new_kv = step(q, k, v, kv)
        assert (attn.view(n, 4, 256, 64).float() - want.float()
                ).abs().max().item() < 2e-2
        assert torch.equal(new_kv, expect)
        if fault == "fail":
            for plan in step.resolve().plans:
                assert (0, 2) not in plan.directional_links()
            assert sess.stats()["health"]["ladder_level"] == 1


def test_health_ladder_on_a_peer_session_bitwise_stacked(dev):
    """Four logical devices on the card and a stacked session, in
    lockstep, through a failure of (0, 1), a quarantine of it readmitted
    by probes and a host relay: every send bitwise the stacked one's,
    equal health counters, events and cache statistics, every key of the
    peer plan cache a ``PlacedKey``."""
    peer = CommSession(devices=[dev] * 4)
    stacked = CommSession(device=dev)
    both = (peer, stacked)
    x = torch.randn(1 << 20, device=dev)

    def send():
        outs = [s.send(x, 0, 1, max_paths=3) for s in both]
        assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], x)
        a, b = (s.stats() for s in both)
        assert a["health"] == b["health"] and a["cache"] == b["cache"]
        assert peer.drain_health_events() == stacked.drain_health_events()
        return a["health"]

    assert send()["ladder_level"] == 0
    for s in both:
        s.topology.fail_link(0, 1)
    assert send()["ladder_level"] == 1
    for s in both:
        s.topology.restore_link(0, 1)
        s.monitor.quarantine_link((0, 1), reason="droop")
    for _ in range(peer.monitor.probe_healthy):
        assert peer.probe_links() == stacked.probe_links() == {(0, 1): True}
    assert not peer.planner.quarantined and not stacked.planner.quarantined
    assert send()["ladder_level"] == 0
    for s in both:
        for src in (0, 2, 3):
            s.topology.fail_link(src, 1)
    health = send()
    assert health["ladder_level"] == 3 and health["host_relays"] == 1
    assert all(isinstance(k, PlacedKey) for k in peer.engine.cache._store)


# -- training: the attention backward and the train steps --------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d", [(2, 15, 5, 512, 64),
                                          (1, 4, 2, 200, 32),
                                          (1, 2, 1, 130, 128),
                                          (2, 8, 2, 77, 16),
                                          (1, 4, 4, 64, 32),
                                          (1, 4, 2, 65, 128)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None), (False, 48)])
def test_flash_attention_backward_matches_plain(dev, dtype, b, hq, hkv, s, d,
                                                causal, window):
    """dQ, dK, dV within 1e-4 (float32) or 2e-2 (bfloat16) of the largest
    |want|, from the same forward output and lse; the lse within 1e-4 of
    the plain log-sum-exp."""
    g = torch.Generator(device=dev).manual_seed(s + d)
    q, k, v = ((torch.randn(b, h, s, d, generator=g, device=dev) * sc
                ).to(dtype) for h, sc in ((hq, 0.5), (hkv, 0.5), (hkv, 1.0)))
    do = torch.randn(b, hq, s, d, generator=g, device=dev).to(dtype)
    o, lse = fk.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                     return_lse=True)
    want_lse = fk.attention_lse_ref(q, k, causal=causal, window=window)
    assert (lse - want_lse).abs().max().item() <= 1e-4
    before = fk.LAUNCHES_BWD
    got = fk.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=causal,
                                      window=window)
    assert fk.LAUNCHES_BWD == before + 1
    want = fk.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                        window=window)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for x, y in zip(got, want):
        assert x.dtype == dtype and x.shape == y.shape
        top = y.float().abs().max().item()
        assert (x.float() - y.float()).abs().max().item() <= tol * top


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,d,causal,window", [
    (1, 2, 1, 1, 64, True, None), (1, 2, 1, 1, 64, False, None),
    (1, 4, 2, 65, 128, True, 1), (2, 8, 2, 77, 16, True, 1)])
def test_flash_attention_backward_rows_that_attend_one_key(dev, dtype, b,
                                                           hq, hkv, s, d,
                                                           causal, window):
    """Every row attends only its own key (one position, or a causal
    window of 1): P = 1, so dV = dO summed over the grouped heads, held
    to the plain version within 1e-4 (float32) or 2e-2 (bfloat16) of
    the largest |want|, and dS = dO·v − dO·o = 0, so dQ and dK are zero
    up to the rounding of dP against D (within 1e-5 absolute)."""
    g = torch.Generator(device=dev).manual_seed(s + d)
    q, k, v = ((torch.randn(b, h, s, d, generator=g, device=dev) * sc
                ).to(dtype) for h, sc in ((hq, 0.5), (hkv, 0.5), (hkv, 1.0)))
    do = torch.randn(b, hq, s, d, generator=g, device=dev).to(dtype)
    o, lse = fk.flash_attention_cuda(q, k, v, causal=causal, window=window,
                                     return_lse=True)
    dq, dk, dv = fk.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                             causal=causal, window=window)
    want = fk.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                        window=window)[2]
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    top = want.float().abs().max().item()
    assert (dv.float() - want.float()).abs().max().item() <= tol * top
    for x in (dq, dk):
        assert x.float().abs().max().item() <= 1e-5


def test_flash_attention_fn_matches_autograd_of_plain(dev):
    """Through ``ops.flash_attention`` with grad: the kernel's backward,
    with a strided q and a strided dO, against autograd of the plain
    version."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    g = torch.Generator(device=dev).manual_seed(3)
    q = (torch.randn(2, 128, 6, 32, generator=g, device=dev) * 0.5)
    k = (torch.randn(2, 3, 128, 32, generator=g, device=dev) * 0.5)
    v = torch.randn(2, 3, 128, 32, generator=g, device=dev)
    leaves_ = [t.requires_grad_() for t in (q, k, v)]
    qt = q.transpose(1, 2)                       # (B, H, S, D), strided
    out = flash_attention(qt, k, v, causal=True)
    assert out.grad_fn is not None
    do = torch.randn(2, 128, 6, 32, generator=g, device=dev).transpose(1, 2)
    before = fk.LAUNCHES_BWD
    got = torch.autograd.grad(out, leaves_, do)
    assert fk.LAUNCHES_BWD == before + 1
    want = torch.autograd.grad(fk.flash_attention_plain(qt, k, v,
                                                        causal=True),
                               leaves_, do)
    for x, y in zip(got, want):
        top = y.abs().max().item()
        assert (x - y).abs().max().item() <= 1e-4 * top
    with torch.no_grad():
        assert flash_attention(qt, k, v).grad_fn is None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [80, 112, 192])
def test_flash_attention_fn_at_config_head_dims(dev, d, dtype):
    """``FlashAttentionFn`` at HuBERT's, Kimi K2's and Nemotron-4's head
    dims, unmasked and causal: the backward kernel against autograd of the
    plain version (float32 within 1e-4, bfloat16 within 2e-2 of the
    largest |want|), one backward launch a call."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    g = torch.Generator(device=dev).manual_seed(d)
    bound = 1e-4 if dtype == torch.float32 else 2e-2
    for causal in (False, True):
        q = (torch.randn(2, 4, 130, d, generator=g, device=dev) * 0.5).to(
            dtype).requires_grad_()
        k = (torch.randn(2, 2, 130, d, generator=g, device=dev) * 0.5).to(
            dtype).requires_grad_()
        v = torch.randn(2, 2, 130, d, generator=g, device=dev).to(
            dtype).requires_grad_()
        do = torch.randn(2, 4, 130, d, generator=g, device=dev).to(dtype)
        before = fk.LAUNCHES_BWD
        got = torch.autograd.grad(flash_attention(q, k, v, causal=causal),
                                  (q, k, v), do)
        assert fk.LAUNCHES_BWD == before + 1
        want = torch.autograd.grad(fk.flash_attention_plain(
            q.float(), k.float(), v.float(), causal=causal), (q, k, v),
            do.float())
        for x, y in zip(got, want):
            top = y.float().abs().max().item()
            assert (x.float() - y.float()).abs().max().item() <= bound * top


@pytest.mark.parametrize("d", HEAD_DIMS + (80, 112))
def test_flash_attention_bwd_tile_products_match_matmul(dev, d):
    """One tile of each operand role of the backward's dK/dV kernel through
    its TMA loads, swizzled layouts and wgmma fragments against
    torch.matmul in float32: Sᵀ = K·Qᵀ (K as A, Q as K-major B), then Sᵀ
    rounded to bfloat16 from the accumulator as the A operand of Sᵀ·dO and
    Sᵀ·Q (dO and Q as MN-major B). Products of bfloat16 values are exact,
    so only the order of the float32 sums differs; a layout fault gives
    errors of order 1."""
    g = torch.Generator(device=dev).manual_seed(100 + d)
    k, q, do = (torch.randn(64, d, generator=g, device=dev).to(torch.bfloat16)
                for _ in range(3))
    st, pd, pq = fk.bwd_tile_products_cuda(k, q, do)
    torch.testing.assert_close(st, k.float() @ q.float().T, atol=1e-3,
                               rtol=1e-4)
    p = st.to(torch.bfloat16).float()    # the kernel rounds the same floats
    torch.testing.assert_close(pd, p @ do.float(), atol=1e-3, rtol=1e-4)
    torch.testing.assert_close(pq, p @ q.float(), atol=1e-3, rtol=1e-4)


def test_flash_attention_bwd_bf16_alignment(dev):
    """The bfloat16 backward raises on a misaligned do or o (TMA needs
    16-byte aligned bases and strides) and never falls back; through
    ``FlashAttentionFn`` a misaligned dO is copied first and the gradients
    equal those of an aligned copy."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    g = torch.Generator(device=dev).manual_seed(5)
    q, k, v = ((torch.randn(1, h, 128, 64, generator=g, device=dev) * 0.5
                ).to(torch.bfloat16) for h in (4, 2, 2))
    o, lse = fk.flash_attention_cuda(q, k, v, return_lse=True)
    flat = torch.randn(q.numel() + 1, generator=g, device=dev).to(
        torch.bfloat16)
    odd = flat[1:].view(q.shape)
    before = fk.LAUNCHES_BWD
    for name, args in (("do", (q, k, v, o, lse, odd)),
                       ("o", (q, k, v, odd, lse, o))):
        with pytest.raises(ValueError, match="16-byte aligned"):
            fk.flash_attention_bwd_cuda(*args)
    assert fk.LAUNCHES_BWD == before
    leaves_ = [t.clone().requires_grad_() for t in (q, k, v)]
    out = flash_attention(*leaves_)
    got = torch.autograd.grad(out, leaves_, odd, retain_graph=True)
    want = torch.autograd.grad(out, leaves_, odd.clone())
    for x, y in zip(got, want):
        assert torch.equal(x, y)


def test_dense_backward_gives_attention_the_plain_gradients(dev,
                                                            monkeypatch):
    """``loss.backward()`` through the port's dense forward on the card
    gives wq, wk and wv the gradients of the same forward with the plain
    attention (no detached kernel output)."""
    cfg = dataclasses.replace(get_config("smollm_360m").reduced(),
                              remat="full")
    params = tfm.init_params(cfg, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    toks = torch.randint(0, cfg.vocab_size, (2, 65),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1].to(dev), "labels": toks[:, 1:].to(dev)}

    def grads():
        for t in (params["layers"]["attn"][w] for w in ("wq", "wk", "wv")):
            t.grad = None
        for t in _tree_leaves(params):
            t.requires_grad_(True)
        tfm.loss_fn(params, cfg, batch).backward()
        return [params["layers"]["attn"][w].grad.clone()
                for w in ("wq", "wk", "wv")]

    before = fk.LAUNCHES_BWD
    got = grads()
    assert fk.LAUNCHES_BWD == before + cfg.num_layers
    monkeypatch.setattr(layers, "flash_attention",
                        lambda q, k, v, **kw: fk.flash_attention_plain(
                            q, k, v, **kw))
    want = grads()
    for x, y in zip(got, want):
        top = y.abs().max().item()
        assert top > 0 and (x - y).abs().max().item() <= 1e-4 * top


def _tree_leaves(tree):
    from repro_torch.tree import leaves
    return leaves(tree)


#: The RWKV-6 backward kernel against its plain version: the largest error
#: of each gradient relative to its largest |want| (float32 sums in
#: another order; bfloat16 gradients rounded once).
RWKV_BWD_REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _rwkv_bwd_inputs(dev, b, s, h, dk, dv, dtype, low, seed, chunk=1):
    """Random backward inputs; a sequence padded to a multiple of
    ``chunk`` as the model pads it (r, k, v and dO 0, w 1 past S)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    pad = (-s) % chunk

    def randn(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    r, k = (randn(b, s + pad, h, dk, scale=0.5).to(dtype) for _ in range(2))
    v = randn(b, s + pad, h, dv).to(dtype)
    w = low + (0.999 - low) * torch.rand(b, s + pad, h, dk, generator=g,
                                         device=dev)
    u = randn(h, dk, scale=0.3).expand(b, h, dk)
    do = randn(b, s + pad, h, dv)
    if pad:
        for t in (r, k, v, do):
            t[:, s:] = 0
        w[:, s:] = 1
    return r, k, v, w, u, do


@pytest.mark.parametrize("b,s,h,dk,dv,chunk,dtype,with_dstate,low", [
    (2, 256, 4, 64, 64, 64, torch.float32, False, 0.3),
    (2, 256, 4, 64, 64, 64, torch.bfloat16, True, 0.3),
    (1, 96, 3, 16, 32, 32, torch.float32, True, 0.3),
    (3, 64, 2, 32, 16, 16, torch.float32, True, 0.85),
    (1, 40, 2, 8, 8, 8, torch.bfloat16, False, 0.5),
    # chunks off the 16-row mma tile, on padded sequences; a dk or dv of 8
    # (one 8-wide mma tile, partly empty rows) beside 64
    (2, 100, 3, 64, 64, 40, torch.float32, True, 0.3),
    (2, 100, 3, 64, 64, 40, torch.bfloat16, True, 0.3),
    (1, 70, 2, 64, 8, 24, torch.float32, True, 0.3),
    (2, 50, 2, 8, 64, 24, torch.bfloat16, True, 0.3)])
def test_rwkv6_scan_backward_matches_plain(dev, b, s, h, dk, dv, chunk,
                                           dtype, with_dstate, low):
    """The backward kernel against its plain version from the forward
    kernel's chunk-start states (float32 within 1e-4, bfloat16 within 2e-2
    of each gradient's largest |want|), with decays down to 0.3 and a
    nonzero dState, chunks of 40 and 24 on padded sequences, dk or dv of
    8; its end-state gradients against the plain reverse pass's; one count
    a call."""
    r, k, v, w, u, do = _rwkv_bwd_inputs(dev, b, s, h, dk, dv, dtype, low,
                                         s + dk, chunk)
    dstate = (torch.randn(b, h, dk, dv, device=dev) if with_dstate
              else None)
    _, _, states = sk.rwkv6_scan_fwd_cuda(r, k, v, w, u, chunk=chunk,
                                          out_dtype=torch.float32)
    before = sk.LAUNCHES_BWD
    got = sk.rwkv6_scan_bwd_cuda(r, k, v, w, u, do, dstate, states=states,
                                 chunk=chunk)
    assert sk.LAUNCHES_BWD == before + 1
    want = sk.rwkv6_scan_bwd_plain(r, k, v, w, u, do, dstate, chunk=chunk)
    for name, x, y in zip(("dr", "dk", "dv", "dw", "du"), got, want):
        assert x.shape == y.shape and x.dtype == y.dtype, name
        top = y.float().abs().max().item()
        tol = RWKV_BWD_REL[x.dtype]
        assert (x.float() - y.float()).abs().max().item() <= tol * top, name
    bufs = sk._bwd_buffers(r, v, chunk)
    sk._launch_bwd(r, k, v, w, u, do, dstate, states, bufs, chunk)
    ends = bufs[4]
    pends = sk.rwkv6_chunk_state_grads_plain(r, w, do, dstate, chunk=chunk)
    assert _rel(ends, pends) < 1e-4


def test_rwkv6_scan_backward_float32_dw_du_within_1e5(dev):
    """The kernel's float32 dw and du at (2, 256, 4, 64, 64), chunks of
    64, within 1e-5 of their largest |want| (the plain version's):
    float32 accuracy, which a product in one TF32 pass (10-bit mantissa)
    misses."""
    r, k, v, w, u, do = _rwkv_bwd_inputs(dev, 2, 256, 4, 64, 64,
                                         torch.float32, 0.3, 11)
    dstate = torch.randn(2, 4, 64, 64, device=dev)
    _, _, states = sk.rwkv6_scan_fwd_cuda(r, k, v, w, u, chunk=64,
                                          out_dtype=torch.float32)
    got = sk.rwkv6_scan_bwd_cuda(r, k, v, w, u, do, dstate, states=states,
                                 chunk=64)
    want = sk.rwkv6_scan_bwd_plain(r, k, v, w, u, do, dstate, chunk=64)
    for name, x, y in (("dw", got[3], want[3]), ("du", got[4], want[4])):
        top = y.abs().max().item()
        assert (x - y).abs().max().item() <= 1e-5 * top, name


def test_rwkv6_scan_fn_matches_autograd_of_plain(dev):
    """Through ``ops.rwkv6_scan`` with grad (a sequence the wrapper pads,
    the backward kernel inside autograd): the gradients of r, k, v, w, u
    against autograd of the plain version within 1e-4 of the largest,
    one backward launch; without grad nothing is recorded."""
    g = torch.Generator(device=dev).manual_seed(7)
    bh, s, d = 6, 100, 32
    leaves_ = [(torch.randn(bh, s, d, generator=g, device=dev) * 0.5)
               .requires_grad_() for _ in range(3)]
    w = (0.3 + 0.69 * torch.rand(bh, s, d, generator=g, device=dev)
         ).requires_grad_()
    u = (torch.randn(bh, d, generator=g, device=dev) * 0.3).requires_grad_()
    do = torch.randn(bh, s, d, generator=g, device=dev)
    before = sk.LAUNCHES_BWD
    out = sops.rwkv6_scan(*leaves_, w, u, chunk=32)
    got = torch.autograd.grad(out, leaves_ + [w, u], do)
    assert sk.LAUNCHES_BWD == before + 1
    cpu = [t.detach().cpu().requires_grad_() for t in leaves_ + [w, u]]
    want = torch.autograd.grad(sops.rwkv6_scan(*cpu, chunk=32), cpu,
                               do.cpu())
    for x, y in zip(got, want):
        assert _rel(x.cpu(), y) < 1e-4
    with torch.no_grad():
        assert sops.rwkv6_scan(*leaves_, w, u, chunk=32).grad_fn is None


@pytest.mark.parametrize("arch", ["rwkv6_1_6b", "hymba_1_5b",
                                  "mixtral_8x22b"])
def test_reduced_model_grads_on_the_card_match_cpu(dev, arch):
    """``loss_fn``'s gradients of a reduced model (float32, TF32 off,
    ``remat="full"``) on the card against the same weights on the CPU
    (plain versions), within 1e-4 of each leaf's largest gradient: the
    scan's and the attention's backward kernels, the Mamba scan and the
    MoE routing under autograd; ``make_train_step`` takes a step."""
    from repro_torch.data import DataConfig, SyntheticDataset, batch_to
    from repro_torch.optim import OptimConfig
    from repro_torch.training import (TrainStepConfig, init_state,
                                      make_loss_fn, make_train_step)
    from repro_torch.training.train_step import _value_and_grad
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).reduced(), remat="full")
    params = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    batch = SyntheticDataset(cfg, DataConfig(64, 4)).batch_at(0)
    vg = _value_and_grad(make_loss_fn(cfg, TrainStepConfig()))
    before = (sk.LAUNCHES_BWD, fk.LAUNCHES_BWD)
    loss, grads = vg(tree_map(lambda t: t.to(dev), params),
                     batch_to(batch, dev))
    if arch == "rwkv6_1_6b":
        assert sk.LAUNCHES_BWD == before[0] + cfg.num_layers
    else:
        assert fk.LAUNCHES_BWD == before[1] + cfg.num_layers
    closs, cgrads = vg(params, batch_to(batch, "cpu"))
    assert abs(float(loss) - float(closs)) <= 1e-5 * abs(float(closs))
    for x, y in zip(_tree_leaves(grads), _tree_leaves(cgrads)):
        top = y.abs().max().item()
        assert (x.cpu() - y).abs().max().item() <= 1e-4 * max(top, 1e-30)
    opt = OptimConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    state = init_state(cfg, opt, device=dev)
    state, m = make_train_step(cfg, TrainStepConfig(), opt, device=dev)(
        state, batch_to(batch, dev))
    assert torch.isfinite(m["loss"]).item()


def test_reduced_hubert_grads_on_the_card_match_cpu(dev):
    """The audio encoder (reduced HuBERT-XLarge with its head dim of 80 put
    back, float32, TF32 off, ``remat="full"``): ``loss_fn``'s gradients on
    the card (non-causal attention through the padded kernels, one
    backward launch a layer) against the same weights and feature batch
    on the CPU, within 1e-4 of each leaf's largest gradient; the loss
    within rtol 1e-5; ``make_train_step`` takes a step."""
    from repro_torch.data import DataConfig, SyntheticDataset, batch_to
    from repro_torch.optim import OptimConfig
    from repro_torch.training import (TrainStepConfig, init_state,
                                      make_loss_fn, make_train_step)
    from repro_torch.training.train_step import _value_and_grad
    from repro_torch.tree import tree_map
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("hubert_xlarge").reduced(),
                              head_dim=80, remat="full")
    params = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                             device="cpu")
    batch = SyntheticDataset(cfg, DataConfig(64, 4)).batch_at(0)
    vg = _value_and_grad(make_loss_fn(cfg, TrainStepConfig()))
    before = fk.LAUNCHES_BWD
    loss, grads = vg(tree_map(lambda t: t.to(dev), params),
                     batch_to(batch, dev))
    assert fk.LAUNCHES_BWD == before + cfg.num_layers
    closs, cgrads = vg(params, batch_to(batch, "cpu"))
    assert abs(float(loss) - float(closs)) <= 1e-5 * abs(float(closs))
    for x, y in zip(_tree_leaves(grads), _tree_leaves(cgrads)):
        top = y.abs().max().item()
        assert (x.cpu() - y).abs().max().item() <= 1e-4 * max(top, 1e-30)
    opt = OptimConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    state = init_state(cfg, opt, device=dev)
    state, m = make_train_step(cfg, TrainStepConfig(), opt, device=dev)(
        state, batch_to(batch, dev))
    assert torch.isfinite(m["loss"]).item()


@pytest.mark.parametrize("arch,head_dim", [("kimi_k2_1t_a32b", 112),
                                           ("nemotron_4_340b", 192)])
def test_wide_head_dim_serving_reduced_model_matches_cpu(dev, arch,
                                                         head_dim):
    """Reduced Kimi K2 with its head dim of 112 and Nemotron-4 with 192 put
    back, served on the card: the prefill (one kernel launch a layer)
    against the CPU's logits and cache within atol 1e-3, and the captured
    decode step bit for bit against the eager step."""
    cfg = dataclasses.replace(get_config(arch).reduced(), head_dim=head_dim)
    params = tfm.init_params(cfg, generator=torch.Generator().manual_seed(0))
    toks = [list(range(1, 13)), [5, 6, 7] * 4]
    cpu = ServeEngine(cfg, params, max_len=32, kv_chunks=4)
    gpu = ServeEngine(cfg, _on(params, dev), max_len=32, kv_chunks=4)
    lc, cc = cpu.prefill(toks)
    before = fk.LAUNCHES
    lg, cg = gpu.prefill(toks)
    assert fk.LAUNCHES == before + cfg.num_layers
    torch.testing.assert_close(lg.cpu(), lc, atol=1e-3, rtol=0)
    for key in cc:
        torch.testing.assert_close(cg[key].cpu(), cc[key], atol=1e-3,
                                   rtol=0)
    prefill = gpu.prefill_program(2, 12)
    prefill.tokens.copy_(torch.tensor(toks))
    tok = prefill()[:, -1].argmax(-1)[:, None]
    decode = gpu.decode_program(2)
    eager = {k: t.clone() for k, t in decode.cache.items()}
    want, _ = make_serve_step(cfg, gpu.spec)(gpu.params, eager, tok, 12)
    decode.tokens.copy_(tok)
    decode.cur_len.fill_(12)
    assert torch.equal(decode(), want)
    assert all(torch.equal(decode.cache[k], eager[k]) for k in eager)


@pytest.mark.parametrize("arch", ["smollm_360m", "rwkv6_1_6b"])
def test_captured_train_step_on_the_card_matches_dp(dev, arch):
    """A reduced SmolLM-360M or RWKV-6 (float32): the captured step is one
    dispatch and equals the eager DP step, which equals the single-device
    step (loss rtol 1e-5, params atol 2e-5 / rtol 1e-4); its replay runs
    the model's backward kernel (the attention's or the scan's)."""
    from repro_torch.data import DataConfig, SyntheticDataset, batch_to
    from repro_torch.optim import OptimConfig
    from repro_torch.training import (TrainStepConfig, init_state,
                                      make_captured_dp_train_step,
                                      make_dp_train_step, make_train_step)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config(arch).reduced(), remat="full")
    opt = OptimConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    ts = TrainStepConfig()
    state = init_state(cfg, opt, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    batch = batch_to(SyntheticDataset(cfg, DataConfig(64, 8)).batch_at(0),
                     dev)
    s1, m1 = make_train_step(cfg, ts, opt, device=dev)(state, batch)
    s2, m2 = make_dp_train_step(cfg, ts, opt, CommSession(device=dev))(
        state, batch)
    sess = CommSession(device=dev)
    step = make_captured_dp_train_step(cfg, ts, opt, sess, state, batch)
    s3, m3 = step(state, batch)
    mod = fk if arch == "smollm_360m" else sk
    before = (mod.LAUNCHES, mod.LAUNCHES_BWD)
    s3, m3 = step(state, batch)
    assert sess.stats()["dispatches"] == 2
    assert mod.LAUNCHES > before[0] and mod.LAUNCHES_BWD > before[1]
    for (a, ma), (b, mb) in (((s2, m2), (s1, m1)), ((s3, m3), (s2, m2))):
        assert abs(float(ma["loss"]) - float(mb["loss"])) <= 1e-5 * abs(
            float(mb["loss"]))
        for x, y in zip(_tree_leaves(a["params"]),
                        _tree_leaves(b["params"])):
            assert torch.allclose(x, y, atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_captured_multipath_dma_bitwise_on_the_card(dev, dtype):
    """``captured_multipath_dma`` → ``cap.exchange`` → a compute node,
    replayed as one CUDA graph: bit for bit as the eager composition,
    one dispatch a call, ``multipath_dma`` launched once for the DMA node
    and once for each copy run."""
    from repro_torch.kernels.multipath_dma.ops import (
        captured_multipath_dma, multipath_dma_transfer)

    sess = CommSession(CommConfig(multipath_threshold=64), device=dev)
    n, nelems = sess.num_devices, 1 << 18
    plan = sess.plan(0, 2, nelems * dtype.itemsize, max_paths=3,
                     num_chunks=4, granularity=dtype.itemsize)

    def build(cap):
        y = captured_multipath_dma(cap, cap.input((nelems,), dtype), plan, n)
        (r,) = cap.exchange([(y, 2, 1)], max_paths=2, num_chunks=2)
        return cap.kernel(lambda v: v * 2.0, r, name="dbl")

    step = sess.capture(build)
    runs = len(step.resolve().compiled.program.copy_runs)
    xs = torch.randn(n, nelems, device=dev).to(dtype)
    before = dk.LAUNCHES
    (out,) = step(xs)
    torch.cuda.synchronize()
    assert dk.LAUNCHES - before == 1 + runs
    assert sess.stats()["dispatches"] == 1
    moved = multipath_dma_transfer(xs, plan)
    want = torch.zeros_like(xs)
    want[1] = sess.send(moved[2], 2, 1)
    assert torch.equal(out, want * 2.0)


def test_block_pipeline_through_the_session_bitwise(dev):
    """A 4-stage pipeline over 2 reduced Llama-3 blocks a stage, through a
    CUDA session (one exchange a tick): bit for bit as sequential
    ``block_apply``, with and without multipath."""
    from repro_torch.training.pipeline import (block_stages,
                                               make_block_stage_fn,
                                               pipeline_apply)

    cfg = dataclasses.replace(get_config("llama3_8b").reduced(),
                              num_layers=8, dtype="bfloat16")
    params = tfm.init_params(
        cfg, generator=torch.Generator(device=dev).manual_seed(0),
        device=dev)
    m, s = 3, 64
    x = torch.randn(m, 1, s, cfg.d_model, device=dev).to(torch.bfloat16)
    positions = torch.arange(s, device=dev)
    with torch.no_grad():
        seq = []
        for mb in range(m):
            h = x[mb]
            for i in range(cfg.num_layers):
                h, _ = tfm.block_apply(h, tfm.layer_params(params, i), cfg,
                                       -1, positions)
            seq.append(h)
        seq = torch.stack(seq)
        stage_fn = make_block_stage_fn(cfg, 4, positions)
        for multipath in (False, True):
            sess = CommSession(CommConfig(multipath_threshold=64),
                               device=dev, topology=Topology.full_mesh(4))
            before = fk.LAUNCHES
            got = pipeline_apply(stage_fn, block_stages(params, 4), x,
                                 microbatches=m, multipath=multipath,
                                 session=sess)
            assert torch.equal(got, seq)
            assert sess.stats()["dispatches"] == m + 4 - 1
            assert fk.LAUNCHES - before == (m + 4 - 1) * cfg.num_layers


def test_compressed_psum_on_the_card_matches_cpu(dev):
    """``compressed_psum`` on a CUDA session (the ring through the
    ``ring_allgather`` kernel) against the plain CPU result within 1e-6,
    and the int8 payloads equal."""
    from repro_torch.optim import compression as comp

    g = torch.randn(8, 37, 129, generator=torch.Generator().manual_seed(0))
    cpu = comp.compressed_psum(g, CommSession(
        device="cpu", topology=Topology.full_mesh(8)))
    before = rk.LAUNCHES
    got = comp.compressed_psum(g.to(dev), CommSession(
        device=dev, topology=Topology.full_mesh(8)))
    torch.cuda.synchronize()
    assert rk.LAUNCHES > before
    assert torch.allclose(got.cpu(), cpu, rtol=0,
                          atol=1e-6 * cpu.abs().max().item())
    q, scale = comp._quantize(g.to(dev))
    qc, sc = comp._quantize(g)
    assert torch.equal(q.cpu(), qc) and torch.equal(scale.cpu(), sc)


def test_moe_serving_under_a_mesh_on_the_card(dev):
    """Reduced Mixtral served under a ``(1, 4)`` mesh on the card (one
    expert a row): the prefill's logits within 1e-3 of the unsharded
    engine's; every MoE layer's combine one session psum, so
    ``ring_allgather`` runs once a layer a prefill and a decode step
    (the counters count a replay's launches); the captured decode step bit for
    bit as the eager step under the mesh; ``generate``'s tokens equal an
    eager loop's under the mesh."""
    from repro_torch.launch.mesh import make_host_mesh, set_mesh

    cfg, params, plain = _served(dev, "mixtral_8x22b")
    toks = [list(range(1, 13)), [5, 6, 7] * 4]
    want, _ = plain.prefill(toks)
    mesh = make_host_mesh((1, 4), device=dev)
    with set_mesh(mesh):
        engine = ServeEngine(cfg, params, max_len=32, kv_chunks=4)
        before = rk.LAUNCHES
        got, _ = engine.prefill(toks)
        assert rk.LAUNCHES - before == cfg.num_layers
        torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
        decode = engine.decode_program(2)
        step = make_serve_step(cfg, engine.spec)
        tok = got[:, -1].argmax(-1)[:, None]
        for pos in range(12, 15):
            eager = {k: t.clone() for k, t in decode.cache.items()}
            ref, _ = step(params, eager, tok, pos)
            decode.tokens.copy_(tok)
            decode.cur_len.fill_(pos)
            before = rk.LAUNCHES
            out = decode()
            assert rk.LAUNCHES - before == cfg.num_layers
            assert torch.equal(out, ref)
            tok = out.argmax(-1)[:, None]
        new = 5
        res = engine.generate([Request(list(p), new) for p in toks])
        logits, cache = tfm.prefill_forward(
            params, cfg, {"tokens": torch.tensor(toks, device=dev)},
            engine.spec)
        tok = logits[:, -1].argmax(-1)
        loop = [tok]
        for i in range(new - 1):
            lg, cache = step(params, cache, tok[:, None], 12 + i)
            tok = lg.argmax(-1)
            loop.append(tok)
    assert [r.out for r in res] == torch.stack(loop, 1).tolist()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_multipath_send_local_on_the_card(dev, dtype):
    """``multipath_send_local`` on a CUDA operand: one ``multipath_dma``
    launch, the message bit for bit as ``session.send`` of the same plan
    on the destination row, zeros elsewhere; recorded in a caller's CUDA
    graph, a replay gives the same."""
    from repro_torch.comm import multipath_send_local

    sess = CommSession(CommConfig(multipath_threshold=64), device=dev)
    n, nelems = sess.num_devices, (1 << 18) + 3
    plan = sess.plan(0, 2, nelems * dtype.itemsize, max_paths=3,
                     num_chunks=4, granularity=dtype.itemsize)
    xs = torch.randn(n, nelems, device=dev).to(dtype)
    before = dk.LAUNCHES
    got = multipath_send_local(xs, plan, topology=sess.topology)
    assert dk.LAUNCHES - before == 1
    want = sess.send(xs[0], 0, 2, max_paths=3, num_chunks=4)
    assert torch.equal(got[2], want) and torch.equal(want, xs[0])
    assert not got[[0, 1, 3]].any()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = multipath_send_local(xs, plan, topology=sess.topology)
    xs.mul_(2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out[2], xs[0]) and not out[[0, 1, 3]].any()


@pytest.mark.parametrize("arch,kind", [("llama3_8b", "train"),
                                       ("rwkv6_1_6b", "train"),
                                       ("nemotron_4_340b", "prefill"),
                                       ("mixtral_8x22b", "prefill")])
def test_cost_count_on_meta_equals_the_cards(dev, arch, kind):
    """A reduced cell's step (bfloat16, so the tensor-core kernels run)
    counted on meta tensors and on the card's (``launch.cost``): equal
    FLOPs, bytes, collective records, kernel calls and peak live bytes;
    the card's kernel calls equal the launch counters' rise. Mixtral runs
    under a ``(1, 4)`` mesh, its combine through the session's ring."""
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.kernels._graph import launch_counts
    from repro_torch.launch import cost
    from repro_torch.launch.mesh import LogicalMesh, make_host_mesh, set_mesh
    from repro_torch.launch.specs import input_specs, optim_for
    from repro_torch.training import init_state

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16",
                              num_layers=2)
    moe = bool(cfg.num_experts)
    mesh = (make_host_mesh((1, 4), device=dev) if moe
            else LogicalMesh(("data", "model"), (1, 1)))
    cell = input_specs(cfg, ShapeConfig("c", 64, 4, kind), mesh)
    gen = torch.Generator(device=dev).manual_seed(0)
    tokens = torch.randint(0, cfg.vocab_size, (4, 64), generator=gen,
                           device=dev, dtype=torch.int32)
    if kind == "train":
        args = (init_state(cfg, optim_for(cfg), generator=gen, device=dev),
                {"tokens": tokens, "labels": tokens,
                 "mask": torch.ones((4, 64), device=dev)})
    else:
        args = (tfm.init_params(cfg, generator=gen, device=dev),
                {"tokens": tokens})
    with set_mesh(mesh if moe else None):
        _, on_meta = cost.count(cell.fn, *cell.abstract_args)
        c0 = launch_counts()
        _, on_card = cost.count(cell.fn, *args)
        torch.cuda.synchronize()
    launched = {k: v - c0[k] for k, v in launch_counts().items()
                if v != c0[k]}
    assert on_meta.key() == on_card.key()
    assert launched == on_card.kernels and launched
    assert bool(on_card.collectives) == moe


# -- peer sessions: logical devices on distinct cards -----------------------


def peer_cards(count: int) -> list:
    """``count`` cards that all reach each other, or a skip."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < count:
        pytest.skip(f"needs {count} CUDA cards")
    cards = [torch.device("cuda", i) for i in range(count)]
    for a in cards:
        for b in cards:
            if a != b and not torch.cuda.can_device_access_peer(a, b):
                pytest.skip(f"{a} has no peer access to {b}")
    return cards


def peer_traffic(sess, stacked, dev):
    """A send over 3 paths (twice), a bidirectional and a 4-message
    exchange on a peer session, each bitwise the stacked session's and
    landing on its destination's device; returns the peer entries."""
    x = torch.randn(1 << 20, device=dev)
    for _ in range(2):
        got = sess.send(x, 0, 1, max_paths=3)
        assert got.device == sess.devices[1]
        assert torch.equal(got.to(dev), stacked.send(x, 0, 1, max_paths=3))
    fwd, rev = sess.bidirectional(x, 2, 3, max_paths=3)
    sfwd, srev = stacked.bidirectional(x, 2, 3, max_paths=3)
    assert torch.equal(fwd.to(dev), sfwd) and torch.equal(rev.to(dev), srev)
    msgs = [torch.randn(300_000 + 7 * i, device=dev) for i in range(4)]
    items = [(m, i, (i + 1) % 4) for i, m in enumerate(msgs)]
    got = sess.exchange(items, max_paths=3)
    want = stacked.exchange(items, max_paths=3)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.device == sess.devices[(i + 1) % 4]
        assert torch.equal(g.to(dev), w) and torch.equal(w, msgs[i])
    return [e for _, e in sess.engine._fastpath._store.values()]


def test_peer_session_on_one_card_bitwise_stacked(dev):
    """Four logical devices on one card: distinct allocations, one launch
    a replay (one card), every path bitwise as the stacked session's."""
    cfg = CommConfig(multipath_threshold=0)
    sess = CommSession(cfg, devices=[dev] * 4)
    stacked = CommSession(cfg, device=dev)
    entries = peer_traffic(sess, stacked, dev)
    for e in entries:
        prog = e.compiled.program
        assert isinstance(prog, dk.PeerDmaProgram) and len(prog.cards) == 1
        assert prog.replay_launches == {"multipath_dma": 1}
        assert prog.completed_nodes() == e.graph.num_copy_nodes
        plain_y = [torch.zeros_like(y) for y in prog.y]
        plain_stage = [torch.empty_like(s) for s in prog.stage]
        prog.replay()
        dk.run_node_table_plain(prog.table.items, prog.x, plain_y,
                                plain_stage)
        assert all(torch.equal(a, b) for a, b in zip(prog.y, plain_y))
    before = dk.LAUNCHES
    x = torch.randn(1 << 20, device=dev)
    assert torch.equal(sess.send(x, 0, 1, max_paths=3), x)
    assert dk.LAUNCHES == before + 1


def test_peer_jacobi_on_one_card_bitwise_stacked(dev):
    sess = CommSession(devices=[dev] * 4)
    stacked = CommSession(device=dev)
    u = torch.randn(4, 8, 1000, device=dev)
    blocks = list(u.clone().unbind(0))
    j0 = jk.LAUNCHES
    for _ in range(3):
        blocks = jacobi_step(blocks, session=sess)
        u = jacobi_step(u, session=stacked)
    assert jk.LAUNCHES - j0 == 3 * 4 + 3
    assert torch.equal(torch.stack(blocks), u)


def test_peer_session_across_four_cards(dev):
    cards = peer_cards(4)
    cfg = CommConfig(multipath_threshold=0)
    sess = CommSession(cfg, devices=cards)
    stacked = CommSession(cfg, device=cards[0])
    entries = peer_traffic(sess, stacked, cards[0])
    for e in entries:
        prog = e.compiled.program
        assert prog.cards == tuple(cards)
        assert prog.replay_launches == {"multipath_dma": 4}
        assert prog.completed_nodes() == e.graph.num_copy_nodes
    x = torch.randn(1 << 22, device=cards[0])
    for _ in range(20):                       # replays back to back
        sess.send(x, 0, 1, max_paths=3, block=False)
    out = sess.send(x, 0, 1, max_paths=3)
    assert torch.equal(out.to(cards[0]), x)


def test_peer_jacobi_across_four_cards(dev):
    cards = peer_cards(4)
    sess = CommSession(devices=cards)
    stacked = CommSession(device=cards[0])
    u = torch.randn(4, 8, 1000, device=cards[0])
    blocks = [u[i].to(cards[i]) for i in range(4)]
    for _ in range(3):
        blocks = jacobi_step(blocks, session=sess)
        u = jacobi_step(u, session=stacked)
    assert all(b.device == c for b, c in zip(blocks, cards))
    assert torch.equal(torch.stack([b.to(cards[0]) for b in blocks]), u)


# -- peer collectives: ring_allgather across cards ---------------------------

PEER_RING_SHAPES = [(8, 128, torch.float32), (8, 7, torch.bfloat16),
                    (3, 1, torch.float32), (2048, 8192, torch.float32),
                    (33, 17, torch.bfloat16), (1_572_864, 2, torch.bfloat16),
                    (5, 3, torch.bfloat16)]


def peer_ring_checks(devices):
    """The peer ring eagerly and as a program replayed three times (the
    epochs advance, flags are never zeroed), each bitwise its plain
    version; one launch a card a call."""
    cards = tuple(dict.fromkeys(devices))
    for rows, f, dt in PEER_RING_SHAPES:
        shards = [torch.randn(rows, f, device=d).to(dt) for d in devices]
        want = rk.ring_allgather_peer_plain(shards)
        before = rk.LAUNCHES
        got = rk.ring_allgather_peer_cuda(shards)
        assert rk.LAUNCHES == before + len(cards)
        for g, w, d in zip(got, want, devices):
            assert g.device == d and torch.equal(g, w)
        prog = rk.PeerRingProgram(rows, f, dt, devices)
        for buf, x in zip(prog.x, shards):
            buf.copy_(x)
        prog.capture()
        assert prog.replay_launches == {"ring_allgather": len(cards)}
        for _ in range(3):
            for buf in prog.out:
                buf.fill_(0)
            prog.replay()
            prog.synchronize()
            assert prog.completed_items() == prog.geometry.num_items
            assert all(torch.equal(o, w) for o, w in zip(prog.out, want))


PEER_CALLS = [("all_gather", (4 * 64, 96), torch.float32),
              ("all_gather", (4 * 5, 7), torch.bfloat16),
              ("all_gather", (4 * 8, 1), torch.float32),
              ("reduce_scatter", (4 * 64, 96), torch.float32),
              ("all_reduce", (4 * 64, 96), torch.bfloat16),
              ("all_to_all", (16, 1000), torch.float32),
              ("psum", (37, 11), torch.float32)]


def peer_collective_checks(devices, dev):
    """Every driver-level collective (twice: the second a cache hit) and
    every ``session.collectives`` op of a peer session bitwise as the
    stacked session's; launches a replay: one ``ring_allgather`` a card a
    gather, one ``multipath_dma`` a card a ring shift."""
    cards = tuple(dict.fromkeys(devices))
    sess = CommSession(devices=devices)
    stacked = CommSession(device=dev)
    for op, shape, dt in PEER_CALLS:
        x = torch.randn(*shape, device=dev).to(dt)
        want = getattr(stacked, op)(x)
        for _ in range(2):
            got = getattr(sess, op)(x)
            assert got.device == dev and torch.equal(got, want), op
    assert sess.stats()["dispatches"] == 2 * len(PEER_CALLS)
    assert sess.stats()["cache"]["hits"] == len(PEER_CALLS)
    for compiled in sess.cache.values():
        prog = compiled.program
        shifts = sum(isinstance(p, dk.PeerDmaProgram)
                     for p in prog.ring.programs)
        rings = len(prog.ring.programs) - shifts
        want_launches = {"multipath_dma": shifts * len(cards),
                         "ring_allgather": rings * len(cards)}
        assert prog.replay_launches == {k: v for k, v in
                                        want_launches.items() if v}
    xs = torch.randn(4, 64, 96, device=dev)
    parts = [x.to(d) for x, d in zip(xs.unbind(0), devices)]
    for op in ("all_gather", "reduce_scatter", "all_reduce", "psum",
               "pmean"):
        want = getattr(stacked.collectives, op)(xs)
        got = getattr(sess.collectives, op)(parts)
        assert all(g.device == d for g, d in zip(got, devices))
        assert torch.equal(torch.stack([g.to(dev) for g in got]), want), op
    blocks = xs[:, :4]
    got = sess.collectives.all_to_all([b.to(d) for b, d in
                                       zip(blocks.unbind(0), devices)])
    assert torch.equal(torch.stack([g.to(dev) for g in got]),
                       stacked.collectives.all_to_all(blocks))
    # a list call is one dispatch of its driver-level counterpart's
    # program: hits for the all_gather of PEER_CALLS[0]'s shape and for
    # pmean, which runs psum's
    stats = sess.stats()
    assert stats["dispatches"] == 2 * len(PEER_CALLS) + 6
    assert stats["cache"]["hits"] == len(PEER_CALLS) + 2


def test_peer_ring_allgather_on_one_card(dev):
    peer_ring_checks([dev] * 4)


def test_peer_collectives_on_one_card_bitwise_stacked(dev):
    peer_collective_checks([dev] * 4, dev)


def test_peer_ring_allgather_across_four_cards(dev):
    cards = peer_cards(4)
    peer_ring_checks(cards)
    peer_ring_checks([cards[0], cards[0], cards[1], cards[1]])


def test_peer_collectives_across_four_cards(dev):
    cards = peer_cards(4)
    peer_collective_checks(cards, cards[0])
    peer_collective_checks([cards[0], cards[0], cards[1], cards[1]],
                           cards[0])


# -- whole-iteration capture on a peer session -------------------------------

def peer_capture_checks(devices, dev):
    """Every captured step of the port on a peer session over
    ``devices``, bitwise (attention within 4e-3 + 8e-3·|want|) the same
    step on a stacked session on ``dev``, one dispatch a call, each
    output on its logical device."""
    from repro_torch.comm import captured_psum
    from repro_torch.kernels.multipath_dma.ops import captured_multipath_dma
    from repro_torch.kernels.ring_allgather.ops import (
        captured_ring_allgather)

    n = len(devices)
    cfg = CommConfig(multipath_threshold=64)
    peer = CommSession(cfg, devices=devices)
    stacked = CommSession(cfg, device=dev)
    plan = stacked.plan(0, 2, 4 * 300_001, max_paths=3, num_chunks=2,
                        granularity=4)

    def gather(cap):
        g = captured_ring_allgather(cap, cap.input((6, 40), torch.float32),
                                    n)
        return cap.kernel(lambda t: t * 2.0 + 1.0, g, name="affine")

    def psum(cap):
        return captured_psum(cap, cap.input((50_001,), torch.float32), n,
                             name="ps")

    def dma(cap):
        y = captured_multipath_dma(cap, cap.input((300_001,), torch.float32),
                                   plan, n)
        (r,) = cap.exchange([(y, 2, 1)], num_chunks=2)
        return cap.kernel(lambda t: t * 0.5, r, name="half")

    def decode(sess):
        return make_captured_decode_step(
            sess, batch=1, heads=4, kv_len=128, head_dim=128,
            kv_chunk=1 << 19, src=0, dst=2, dtype=torch.bfloat16,
            schedule="overlap", max_paths=3)

    cases = [
        (make_captured_jacobi_step(stacked, 8, 1000),
         make_captured_jacobi_step(peer, 8, 1000), [(n, 8, 1000)]),
        (stacked.capture(gather), peer.capture(gather), [(n, 6, 40)]),
        (stacked.capture(psum), peer.capture(psum), [(n, 50_001)]),
        (stacked.capture(dma), peer.capture(dma), [(n, 300_001)]),
        (decode(stacked), decode(peer),
         [(n, 1, 4, 128, 128)] * 3 + [(n, 1 << 19)])]
    for k, (sstep, pstep, shapes) in enumerate(cases):
        args = [torch.randn(sh, device=dev) for sh in shapes]
        if k == 4:
            args = [a.to(torch.bfloat16) for a in args]
        want = sstep(*args)
        per = [[a[d].to(devices[d]) for d in range(n)] for a in args]
        d0 = peer.stats()["dispatches"]
        for _ in range(3):
            got = pstep(*per)
        assert peer.stats()["dispatches"] == d0 + 3
        assert sstep.resolve().digest == pstep.resolve().digest
        for i, (g, w) in enumerate(zip(got, want)):
            assert all(t.device == torch.device(d)
                       for t, d in zip(g, devices))
            g = torch.stack([t.to(dev) for t in g])
            if k == 4 and i == 0:
                diff = (g.float() - w.float()).abs()
                assert bool((diff <= 4e-3 + 8e-3 * w.float().abs()).all())
            else:
                assert torch.equal(g, w), (k, i)


def peer_split_checks(devices, dev):
    """A step whose hop-1 and hop-2 copies fall in different copy runs,
    as a peer program over ``devices``, bit for bit as the stacked
    program on ``dev`` over three replays."""
    from repro_torch.comm import StepCapture, lower_step
    from repro_torch.comm.capture import PeerStepProgram, StepProgram
    from repro_torch.comm.passes import reindex

    sess = CommSession(CommConfig(multipath_threshold=64), device=dev)
    cap = StepCapture(4)
    x = cap.input((1 << 20,), torch.float32)
    z = cap.input((5,), torch.float32)
    y = cap.kernel(lambda v: v * 2.0, x, name="double")
    (r,) = cap.exchange([(y, 0, 1)], max_paths=3, num_chunks=2)
    w = cap.kernel(lambda v: v - 1.0, z, name="side")
    out = cap.kernel(lambda v: v + 1.0, r, name="inc")
    graph, _ = lower_step(cap, sess.engine.plan_group_for,
                          sess.topology.name)
    chain = next(e for e in graph.edges if e.kind == "hop")
    side = next(i for i, nd in enumerate(graph.nodes)
                if getattr(nd, "kernel", None) == "side")
    order = [i for i in range(graph.num_nodes) if i != side]
    order.insert(order.index(chain.dst), side)
    split = reindex(graph, order)
    outputs = (out.buf_id, w.buf_id)
    stacked = StepProgram(split, cap, outputs, 4, dev)
    peer = PeerStepProgram(split, cap, outputs, devices)
    assert len(peer.copy_runs) == 2
    stacked.capture()
    peer.capture()
    for _ in range(3):
        xs = torch.randn(4, 1 << 20, device=dev)
        zs = torch.randn(4, 5, device=dev)
        for buf, v in zip(stacked.inputs(), (xs, zs)):
            buf.copy_(v)
        for bufs, v in zip(peer.inputs(), (xs, zs)):
            for view, row in zip(bufs, v.unbind(0)):
                view[0].copy_(row)
        stacked.replay()
        peer.replay()
        peer.synchronize()
        for s_out, p_out in zip(stacked.outputs(), peer.outputs()):
            assert torch.equal(torch.stack([v[0].to(dev) for v in p_out]),
                               s_out)


def test_peer_capture_on_one_card_bitwise_stacked(dev):
    peer_capture_checks([dev] * 4, dev)
    peer_split_checks([dev] * 4, dev)


def test_kernels_with_large_shared_memory_on_every_peer_card(dev):
    """Kernels that raise their shared-memory limit do so on each card
    they run on, whichever ran first: flash attention (bfloat16 and
    float32 at head dim 128, and its backward) and the RWKV-6 scan on
    every card, each against its plain version, with the current device
    left at card 0."""
    from repro_torch.kernels.flash_attention.ops import flash_attention

    count = torch.cuda.device_count()
    if count < 2:
        pytest.skip("needs two or more CUDA cards")
    for i in range(count):
        card = torch.device("cuda", i)
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 3e-5)):
            q, k, v = (torch.randn(1, 8, 256, 128, device=card) * 0.3
                       for _ in range(3))
            q, k, v = (t.to(dt) for t in (q, k, v))
            got = fk.flash_attention_cuda(q, k, v, causal=True)
            want = fk.flash_attention_plain(q, k, v, causal=True)
            assert got.device == card
            assert (got.float() - want.float()).abs().max().item() <= tol
        q, k, v = (torch.randn(1, 8, 256, 128, device=card,
                               requires_grad=True) for _ in range(3))
        out = flash_attention(q, k, v)
        out.sum().backward()
        assert q.grad.device == card and torch.isfinite(q.grad).all()
        *rkvw, u = _rwkv(card, 2, 256, 1, 64, 64)
        r, k, v, w = (t[:, :, 0] for t in rkvw)
        got = sops.rwkv6_scan(r, k, v, w, u[:, 0], chunk=64)
        plain = sops.rwkv6_scan(r.cpu(), k.cpu(), v.cpu(), w.cpu(),
                                u[:, 0].cpu(), chunk=64)
        assert _rel(got.cpu(), plain) < 1e-4


def test_peer_capture_across_four_cards(dev):
    cards = peer_cards(4)
    for devices in (cards, [cards[0], cards[0], cards[1], cards[1]]):
        peer_capture_checks(devices, cards[0])
        peer_split_checks(devices, cards[0])


# -- the training side on a peer session -------------------------------------

def peer_training_checks(devices, dev):
    """The training side on ``CommSession(devices=devices)`` against the
    stacked session on ``dev``: a reduced SmolLM-360M (2 narrow layers,
    float32, TF32 off) through the eager DP step (every replica bitwise
    the stacked state) and the captured DP step (every replica bitwise
    the stacked step's state over two chained calls, each replica fed
    back its own outputs and the stacked step its own state; one dispatch
    a call; the stacked step's key), each
    replica on its own device; ``compressed_psum`` on a per-device list
    bitwise the stacked rows; a reduced Llama-3's 8 layers in 4 stages
    placed one a device, bfloat16, bitwise the stacked pipeline."""
    from repro_torch.data import DataConfig, SyntheticDataset, batch_to
    from repro_torch.optim import OptimConfig
    from repro_torch.optim import compression as comp
    from repro_torch.training import (TrainStepConfig, init_state,
                                      make_captured_dp_train_step,
                                      make_dp_train_step)
    from repro_torch.training.pipeline import (block_stages,
                                               make_block_stage_fn,
                                               pipeline_apply)
    torch.backends.cuda.matmul.allow_tf32 = False
    n = len(devices)
    cfg = get_config("smollm_360m").reduced()
    opt = OptimConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    ts = TrainStepConfig()
    state = init_state(cfg, opt, generator=torch.Generator(
        device=dev).manual_seed(0), device=dev)
    ds = SyntheticDataset(cfg, DataConfig(64, 8))
    batch = batch_to(ds.batch_at(0), dev)
    stacked, peer = CommSession(device=dev), CommSession(devices=devices)
    want, _ = make_dp_train_step(cfg, ts, opt, stacked)(state, batch)
    reps, _ = make_dp_train_step(cfg, ts, opt, peer)(state, batch)
    for rep, d in zip(reps, devices):
        for a, b in zip(_tree_leaves(rep), _tree_leaves(want)):
            assert a.device == d and torch.equal(a.to(dev), b)
    scap = make_captured_dp_train_step(cfg, ts, opt, stacked, state, batch)
    pcap = make_captured_dp_train_step(cfg, ts, opt, peer, state, batch)
    assert pcap.capture.resolve().key == scap.capture.resolve().key
    one, reps = state, state
    for s in range(2):
        bt = batch_to(ds.batch_at(s), dev)
        d0 = peer.stats()["dispatches"]
        reps, _ = pcap(reps, bt)
        assert peer.stats()["dispatches"] == d0 + 1
        one, _ = scap(one, bt)
        for rep, d in zip(reps, devices):
            for a, b in zip(_tree_leaves(rep), _tree_leaves(one)):
                assert a.device == d and torch.equal(a.to(dev), b)
    g = torch.randn(n, 3000, device=dev)
    got = comp.compressed_psum([g[i].to(d) for i, d in enumerate(devices)],
                               peer)
    assert all(torch.equal(a.to(dev), b) for a, b in
               zip(got, comp.compressed_psum(g, stacked).unbind(0)))
    lcfg = dataclasses.replace(get_config("llama3_8b").reduced(),
                               num_layers=8, dtype="bfloat16")
    params = tfm.init_params(lcfg, generator=torch.Generator(
        device=dev).manual_seed(1), device=dev)
    x = torch.randn(3, 1, 64, lcfg.d_model, device=dev).to(torch.bfloat16)
    stage_fn = make_block_stage_fn(lcfg, 4, torch.arange(64, device=dev))
    stages = block_stages(params, 4)
    with torch.no_grad():
        a = pipeline_apply(stage_fn, stages, x, microbatches=3,
                           multipath=True, session=stacked)
        b = pipeline_apply(stage_fn, stages, x, microbatches=3,
                           multipath=True, session=peer)
    assert b.device == devices[0] and torch.equal(b.to(dev), a)


def test_peer_training_on_one_card_bitwise_stacked(dev):
    peer_training_checks([dev] * 4, dev)


def test_peer_training_across_four_cards(dev):
    cards = peer_cards(4)
    for devices in (cards, [cards[0], cards[0], cards[1], cards[1]]):
        peer_training_checks(devices, cards[0])


def peer_serving_checks(devices, dev, arch: str = "mixtral_8x22b",
                        **replace):
    """Reduced ``arch`` (float32) served on a ``(1, 4)`` peer mesh over
    ``devices`` (its whole parameters placed by the engine) against the
    stacked mesh on ``dev``: ``generate``'s tokens the same; on one card
    the prefill's logits and three decode steps' logits bit for bit, and
    ``ring_allgather`` launched once a card a MoE layer a replay; across
    cards (each holding its heads, hidden units and vocabulary blocks)
    every card's logits the same bits and within 1e-5 of the stacked
    mesh's (``tests/test_torch_peer_tp.py``'s float32 bound), and
    ``ring_allgather`` launched once a card a psum (the embedding's,
    attention's, the MLP's or the combine, a layer) and once for the
    logits; each program one graph a card a segment."""
    from repro_torch.launch.mesh import make_host_mesh, set_mesh

    cfg = dataclasses.replace(get_config(arch).reduced(), **replace)
    params = _on(tfm.init_params(
        cfg, generator=torch.Generator().manual_seed(0)), dev)
    toks = [list(range(1, 13)), [5, 6, 7] * 4]

    def serve(mesh):
        with set_mesh(mesh):
            engine = ServeEngine(cfg, params, max_len=32, kv_chunks=4)
            res = engine.generate([Request(list(p), 5) for p in toks])
            logits, _ = engine.prefill(toks)
            decode = engine.decode_program(2)
            tok = logits[:, -1].argmax(-1)[:, None]
            steps, launched, same = [], [], []
            for pos in range(12, 15):
                decode.tokens.copy_(tok)
                decode.cur_len.fill_(pos)
                before = rk.LAUNCHES
                steps.append(decode().clone())
                launched.append(rk.LAUNCHES - before)
                same.append(all(torch.equal(t.to(dev), steps[-1].to(dev))
                                for t in decode.card_logits))
                tok = steps[-1].argmax(-1)[:, None]
        return engine, [r.out for r in res], logits, steps, launched, same

    _, souts, slogits, ssteps, _, _ = serve(
        make_host_mesh((1, 4), device=dev))
    engine, outs, logits, steps, launched, same = serve(
        make_host_mesh((1, 4), devices=devices))
    cards = tuple(dict.fromkeys(torch.device(d) for d in devices))
    assert engine.cards == cards and logits.device == cards[0]
    assert outs == souts and all(same)
    if len(cards) == 1:
        assert torch.equal(logits.to(dev), slogits)
        assert all(torch.equal(a.to(dev), b) for a, b in zip(steps, ssteps))
        per_card = cfg.num_layers if cfg.num_experts else 0
    else:
        prefill = engine.prefill_program(2, 12)
        assert all(torch.equal(t.to(dev), prefill.logits.to(dev))
                   for t in prefill.card_logits)
        for a, b in zip([logits, *steps], [slogits, *ssteps]):
            torch.testing.assert_close(a.to(dev), b, atol=1e-5, rtol=0)
        per_card = 1 + 2 * cfg.num_layers + 1
    for prog in (engine.decode_program(2), engine.prefill_program(2, 12)):
        assert len(prog._graphs) == len(cards) * len(prog.segments)
        assert prog.replays >= 1
    assert launched == [per_card * len(cards)] * 3


def test_peer_moe_serving_on_one_card_bitwise_stacked(dev):
    peer_serving_checks([dev] * 4, dev)


def test_peer_moe_serving_across_four_cards(dev):
    cards = peer_cards(4)
    for devices in (cards, [cards[0], cards[0], cards[1], cards[1]]):
        peer_serving_checks(devices, cards[0])


def test_tensor_parallel_serving_on_a_peer_mesh(dev):
    """Reduced Nemotron-4 (squared ReLU, head dim 192) served dense tensor
    parallel: a logical device a card on four cards and two a card on
    two, against the stacked mesh (:func:`peer_serving_checks`); on one
    card bit for bit."""
    peer_serving_checks([dev] * 4, dev, "nemotron_4_340b", head_dim=192)
    cards = peer_cards(4)
    for devices in (cards, [cards[0], cards[0], cards[1], cards[1]]):
        peer_serving_checks(devices, cards[0], "nemotron_4_340b",
                            head_dim=192)


def peer_moe_training_checks(devices, dev, dtype: str):
    """Reduced Mixtral (``remat="full"``, ``dtype``) trained 2 steps by
    ``make_train_step`` under ``make_host_mesh((1, 4), devices=devices)``
    from ``place_state``, against the stacked mesh's step on ``dev`` from
    the same state and batches, at path Z's limits: losses within rtol
    1e-3, every updated parameter within 2e-2 of the stacked update's
    largest |change|; every card's replicated leaves the same bits, and
    the ring's kernels and attention's backward launched."""
    from repro_torch.data import DataConfig, SyntheticDataset, batch_to
    from repro_torch.kernels._graph import launch_counts
    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    from repro_torch.optim import OptimConfig
    from repro_torch.training import (TrainStepConfig, init_state,
                                      make_train_step)
    from repro_torch.training.sharding import (card_cuts, is_cut,
                                               place_state, unplace_state)
    from repro_torch.tree import leaves_with_paths

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("mixtral_8x22b").reduced(),
                              remat="full", dtype=dtype)
    opt = OptimConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10,
                      moment_dtype="bfloat16")
    ds = SyntheticDataset(cfg, DataConfig(64, 8))
    batches = [batch_to(ds.batch_at(i), dev) for i in range(2)]

    def fresh():
        return init_state(cfg, opt, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev)

    def train(mesh, state):
        step = make_train_step(cfg, TrainStepConfig(), opt, device=dev)
        losses = []
        with set_mesh(mesh):
            for bt in batches:
                state, m = step(state, bt)
                losses.append(float(m["loss"]))
        return state, losses

    first = fresh()
    want, want_losses = train(make_host_mesh((1, 4), device=dev), first)
    peer = make_host_mesh((1, 4), devices=devices)
    before = launch_counts()
    trees, losses = train(peer, place_state(fresh(), peer, cfg))
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    cards = tuple(dict.fromkeys(torch.device(d) for d in devices))
    assert len(trees) == len(cards)
    assert all(t.device == card for tree, card in zip(trees, cards)
               for t in _tree_leaves(tree))
    cut = card_cuts(cfg, peer)[0]
    rep = [[t.to(dev) for path, t in leaves_with_paths(tree)
            if not is_cut(path, cut)] for tree in trees]
    assert all(torch.equal(a, b) for other in rep[1:]
               for a, b in zip(rep[0], other))
    assert all(abs(a - b) <= 1e-3 * abs(b)
               for a, b in zip(losses, want_losses)), (losses, want_losses)
    got = unplace_state(trees, peer, cfg)["params"]
    delta = max((a.float() - b.float()).abs().max().item() for a, b in
                zip(_tree_leaves(want["params"]),
                    _tree_leaves(first["params"])))
    worst = max((a.float() - b.float()).abs().max().item() for a, b in
                zip(_tree_leaves(got), _tree_leaves(want["params"])))
    assert worst <= 2e-2 * delta, (worst, delta)
    for name in ("multipath_dma", "ring_allgather", "flash_attention_bwd"):
        assert launched[name] > 0, name


def test_peer_moe_training_on_one_card(dev):
    peer_moe_training_checks([dev] * 4, dev, "bfloat16")


def test_peer_moe_training_across_four_cards(dev):
    cards = peer_cards(4)
    for devices in (cards, [cards[0], cards[0], cards[1], cards[1]]):
        peer_moe_training_checks(devices, cards[0], "float32")


def peer_tp_training_checks(devices, dev):
    """Reduced Llama-3 (``remat="full"``, float32, TF32 off) trained 2
    steps by ``make_train_step`` under ``make_host_mesh((1, 4),
    devices=devices)`` from ``place_state(state, mesh, cfg)``, against the
    unsharded step on ``dev`` from the same state and batches. One card:
    bit for bit (nothing is cut). Several: every card's loss-bearing
    replicated leaves the same bits; losses within rtol 1e-3 and every
    updated parameter within 2e-2 of the unsharded update's largest
    |change| (path Z's limits), but where the unsharded |g| fell below
    1e-6 (AdamW's ε region, held within twice the summed lr); the ring's
    kernels, attention and its backward launched."""
    from repro_torch.data import DataConfig, SyntheticDataset, batch_to
    from repro_torch.kernels._graph import launch_counts
    from repro_torch.launch.mesh import make_host_mesh, set_mesh
    from repro_torch.optim import OptimConfig
    from repro_torch.training import (TrainStepConfig, init_state,
                                      make_train_step)
    from repro_torch.training import sharding as shd
    from repro_torch.training import train_step as tsm
    from repro_torch.tree import leaves_with_paths

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(get_config("llama3_8b").reduced(),
                              remat="full", num_kv_heads=4)
    opt = OptimConfig(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    ds = SyntheticDataset(cfg, DataConfig(64, 8))
    batches = [batch_to(ds.batch_at(i), dev) for i in range(2)]
    small, lrs = [], []
    update = tsm._update

    def record(params, grads, opt_state, opt_, **kw):
        now = [g.abs() < 1e-6 for g in _tree_leaves(grads)]
        small[:] = now if not small else [a | b for a, b in zip(small, now)]
        return update(params, grads, opt_state, opt_, **kw)

    def fresh():
        return init_state(cfg, opt, generator=torch.Generator(
            device=dev).manual_seed(0), device=dev)

    def train(mesh, state):
        step = make_train_step(cfg, TrainStepConfig(), opt, device=dev)
        losses = []
        with set_mesh(mesh):
            for bt in batches:
                state, m = step(state, bt)
                losses.append(float(m["loss"]))
                lrs.append(float(m["lr"]))
        return state, losses

    first = fresh()
    tsm._update = record
    try:
        want, want_losses = train(None, first)
    finally:
        tsm._update = update
    lr_sum = sum(lrs)
    peer = make_host_mesh((1, 4), devices=devices)
    cuts = shd.card_cuts(cfg, peer)
    before = launch_counts()
    trees, losses = train(peer, shd.place_state(fresh(), peer, cfg))
    launched = {k: v - before[k] for k, v in launch_counts().items()}
    cards = tuple(dict.fromkeys(torch.device(d) for d in devices))
    assert len(trees) == len(cuts) == len(cards)
    assert all(t.device == card for tree, card in zip(trees, cards)
               for t in _tree_leaves(tree))
    got = shd.unplace_state(trees, peer, cfg)["params"]
    if len(cards) == 1:
        assert losses == want_losses
        assert all(torch.equal(a, b) for a, b in zip(
            _tree_leaves(got), _tree_leaves(want["params"])))
        return
    assert all(c.heads and c.kv and c.ff and c.vocab for c in cuts)
    rep = [[t.to(dev) for path, t in leaves_with_paths(tree)
            if not shd.is_cut(path, cuts[0])] for tree in trees]
    assert all(torch.equal(a, b) for other in rep[1:]
               for a, b in zip(rep[0], other))
    assert all(abs(a - b) <= 1e-3 * abs(b)
               for a, b in zip(losses, want_losses)), (losses, want_losses)
    delta = max((a - b).abs().max().item() for a, b in zip(
        _tree_leaves(want["params"]), _tree_leaves(first["params"])))
    for a, b, eps in zip(_tree_leaves(got), _tree_leaves(want["params"]),
                         small):
        diff = (a - b).abs()
        out = diff > 2e-2 * delta
        assert not bool((out & ~eps).any()), (diff.max().item(), delta)
        assert bool((diff[out] <= 2 * lr_sum).all())
    for name in ("multipath_dma", "ring_allgather", "flash_attention",
                 "flash_attention_bwd"):
        assert launched[name] > 0, name


def test_tensor_parallel_training_on_a_peer_mesh(dev):
    """Training under dense tensor parallelism on a peer mesh
    (:func:`peer_tp_training_checks`): four logical devices on one card
    bit for bit the unsharded step; then, where there are four cards that
    reach each other, a logical device a card and two a card on two."""
    peer_tp_training_checks([dev] * 4, dev)
    cards = peer_cards(4)
    for devices in (cards, [cards[0], cards[0], cards[1], cards[1]]):
        peer_tp_training_checks(devices, cards[0])


# -- multipath_dma at the edges of its copy paths -----------------------------

#: (name, messages (src, dst, nelems, dtype), window, max_paths, tile
#: bytes, byte shift of the terminal tiles' destinations). A tile's body
#: moves in 16-byte vectors when its source and destination agree mod 16,
#: its head and tail by bytes; else in 4-byte words or single bytes.
MULTIPATH_EDGES = [
    # destinations 4 bytes (1 byte) off their sources mod 16: the register
    # path's 4-byte (single-byte) copies
    ("offsets_differ_mod_16", [(0, 1, 300_001, torch.float32)], 1, 3,
     256 << 10, 4),
    ("offsets_differ_by_a_byte", [(2, 0, 70_001, torch.float32)], 1, 2,
     256 << 10, 1),
    # items of a few bytes to 12 KB, and tiles of 40,004 bytes, not a
    # multiple of 16 (a head and a tail on every tile)
    ("short_items", [(0, 1, 3_001, torch.float32),
                     (3, 2, 5, torch.float32)], 1, 3, 256 << 10, 0),
    ("tiles_not_multiples_of_16", [(0, 1, 1_000_000, torch.float32)], 1, 3,
     40_004, 0),
    ("one_byte_dtype_odd_length", [(1, 3, 1_000_003, torch.uint8)], 1, 3,
     256 << 10, 0),
    ("window_of_2", [(0, 1, 500_001, torch.float32),
                     (1, 0, 77_777, torch.bfloat16)], 2, 3, 96 << 10, 0),
    # direct + via 2 + via 3: every hop-2 tile reads what its hop-1 tile
    # wrote into the via's staging buffer
    ("three_paths_hop2_after_hop1", [(0, 1, 4_000_000, torch.float32)],
     1, 3, 256 << 10, 0),
]


def edge_program(devices, messages, window, max_paths, tile, shift):
    """A per-device ``multipath_dma`` program of ``messages`` planned on
    the 4-device full mesh (no fill), its terminal tiles' destinations
    moved ``shift`` bytes on (into the slack every output region keeps up
    to its next 256-byte boundary); inputs random bytes, outputs 7s."""
    topo = Topology.full_mesh(4)
    pp = PathPlanner(topo, multipath_threshold=0, chunk_bytes=64 << 10)
    group = pp.plan_group(
        [(s, d, n * dt.itemsize, dt.itemsize) for s, d, n, dt in messages],
        max_paths=max_paths)
    graph, _ = apply_schedule(lower(group, window), "critical_path", topo)
    table = dk.build_node_table(
        graph, [n for *_, n, _ in messages],
        [dt.itemsize for *_, dt in messages], 4, fill="none",
        per_device=True, tile_bytes=tile)
    if shift:
        items = table.items.copy()
        terminal = (items[:, dk.C_NODE] >= 0) & (
            items[:, dk.C_DST_SPACE] == dk.SPACE_OUT)
        items[terminal, dk.C_DST_OFF] += shift
        for lay in table.messages:
            assert 0 < lay.nbytes % 256 <= 256 - shift
        table = dataclasses.replace(table, items=items)
    prog = dk.PeerDmaProgram(table, [dt for *_, dt in messages], devices)
    gen = torch.Generator(device="cpu").manual_seed(len(messages) + shift)
    for buf in prog.x:
        buf.copy_(torch.randint(0, 256, buf.shape, generator=gen,
                                dtype=torch.uint8))
    return graph, prog


def edge_checks(devices, messages, window, max_paths, tile, shift):
    """Eagerly and replayed three times (epochs advance), every output
    and staging byte bitwise ``run_node_table_plain``'s on the same
    inputs, every copy node completed; one launch a card a replay."""
    graph, prog = edge_program(devices, messages, window, max_paths,
                                    tile, shift)
    assert graph.num_copy_nodes == prog.table.num_copy_nodes
    plain_y = [torch.full_like(y, 7) for y in prog.y]
    plain_stage = [torch.zeros_like(s) for s in prog.stage]
    assert dk.run_node_table_plain(prog.table.items, prog.x, plain_y,
                                   plain_stage) == graph.num_copy_nodes
    for y, s in zip(prog.y, prog.stage):
        y.fill_(7)
        s.zero_()
    prog.run()
    prog.synchronize()
    assert prog.completed_nodes() == graph.num_copy_nodes
    assert all(torch.equal(a, b) for a, b in zip(prog.y, plain_y))
    assert all(torch.equal(a, b) for a, b in zip(prog.stage, plain_stage))
    prog.record()
    assert prog.replay_launches == {"multipath_dma": len(prog.launches)}
    for _ in range(3):
        for y in prog.y:
            y.fill_(7)
        prog.replay()
        prog.synchronize()
        assert prog.completed_nodes() == graph.num_copy_nodes
        assert all(torch.equal(a, b) for a, b in zip(prog.y, plain_y))
    return prog


@pytest.mark.parametrize("case", MULTIPATH_EDGES,
                         ids=[c[0] for c in MULTIPATH_EDGES])
def test_multipath_dma_edges_on_one_card(dev, case):
    prog = edge_checks([dev] * 4, *case[1:])
    if case[0] == "three_paths_hop2_after_hop1":
        items = prog.table.items
        hop2 = items[items[:, dk.C_PRED] >= 0]
        assert len(hop2) and set(hop2[:, dk.C_EXEC].tolist()) == {2, 3}


@pytest.mark.parametrize("case", MULTIPATH_EDGES,
                         ids=[c[0] for c in MULTIPATH_EDGES])
def test_multipath_dma_edges_across_four_cards(dev, case):
    cards = peer_cards(4)
    edge_checks(cards, *case[1:])
    edge_checks([cards[0], cards[0], cards[1], cards[1]], *case[1:])
