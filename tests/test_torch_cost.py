"""The cost counter (``repro_torch.launch.cost``) and the kernels' meta
implementations, on the CPU.

* The counter's bytes rules (each input read once, a broadcast once, a
  gather's rows, a scatter's rows, views nothing), FLOPs of matmul-class
  ops by ``torch.utils.flop_counter``'s formulas, and peak live bytes
  with storages freed as they are collected.
* Every kernel wrapper on the model path takes a meta tensor the card's
  way: the CUDA wrapper's checks, empty outputs of the right shapes and
  dtypes, no launch (the launch counters stay), and the kernel's formula
  reported: attention's pairs under causal, windowed and full masks
  (every pair counted by brute force), its backward at 2.5×, the RWKV-6
  scan's and its backward's least work (the same minimum as a search over
  every chunking), the ring all-gather's bytes.
* The session's stacked collectives record one call each, with their
  result's bytes per row, and run their eager composition on meta.
* ``meta`` is a device only where the caller asks for it.
"""

import pytest
import torch

from repro_torch.comm.session import BoundCollectives, resolve_device
from repro_torch.kernels.flash_attention import kernel as fk
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.ring_allgather import kernel as rk
from repro_torch.kernels.ring_allgather.ops import ring_allgather
from repro_torch.kernels.rwkv6_scan import kernel as sk
from repro_torch.kernels.rwkv6_scan.ops import chunked_scan
from repro_torch.launch import cost


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_bytes_count_each_input_once_and_views_nothing():
    a, b = meta(64, 32), meta(1, 32)
    _, c = cost.count(torch.add, a, b)           # b broadcast: read once
    assert c.bytes == (64 * 32 + 32 + 64 * 32) * 4
    _, c = cost.count(lambda: a.expand(2, 64, 32).transpose(0, 1)[3])
    assert c.bytes == 0 and c.peak_bytes == 0
    _, c = cost.count(lambda: a.t().contiguous())
    assert c.bytes == 2 * 64 * 32 * 4
    idx = torch.empty((10,), dtype=torch.int64, device="meta")
    _, c = cost.count(lambda: a[idx])            # a gather: its rows
    assert c.bytes == 10 * 8 + 2 * 10 * 32 * 4
    buf = meta(64, 32)
    _, c = cost.count(lambda: buf.index_copy_(0, idx, meta(10, 32)))
    assert c.bytes == 10 * 8 + 2 * 10 * 32 * 4
    _, c = cost.count(lambda: buf.zero_())
    assert c.bytes == 64 * 32 * 4
    _, c = cost.count(lambda: buf.copy_(b.expand(64, 32)))
    assert c.bytes == (32 + 64 * 32) * 4


def test_flops_follow_the_flop_counters_formulas():
    x, w = meta(8, 16, 32), meta(32, 24)
    _, c = cost.count(torch.matmul, x, w)
    assert c.flops == 2 * 8 * 16 * 32 * 24
    _, c = cost.count(torch.einsum, "bij,bjk->bik", meta(4, 5, 6),
                      meta(4, 6, 7))
    assert c.flops == 2 * 4 * 5 * 6 * 7
    _, c = cost.count(lambda: torch.softmax(x, -1) * 2)
    assert c.flops == 0                           # elementwise: none


def test_peak_live_bytes_follow_the_storages():
    def step(x):
        y = x * 2                  # 4 KiB
        z = y + 1                  # 8 KiB live
        del y
        w = z * 3                  # 8 KiB live again
        return w.sum()
    (out, c) = cost.count(step, meta(1024))
    assert c.peak_bytes == 2 * 4096 + 4    # the sum beside z and w
    assert out.shape == ()
    # arguments that exist before the call are not counted
    _, c = cost.count(lambda x: x.add_(1), meta(1024))
    assert c.peak_bytes == 0 and c.bytes == 2 * 4096


ATTN_CASES = [(True, None), (True, 5), (False, None), (False, 5),
              (True, 40), (False, 40)]


@pytest.mark.parametrize("causal,window", ATTN_CASES)
def test_attention_pairs_are_the_masks_pairs(causal, window):
    for s in (1, 7, 32):
        rows = torch.arange(s)[:, None]
        cols = torch.arange(s)[None, :]
        keep = torch.ones(s, s, dtype=torch.bool)
        if causal:
            keep &= cols <= rows
        if window is not None:
            keep &= cols > rows - window
        assert cost.attention_pairs(s, causal, window) == int(keep.sum())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 16),
                                           (False, None)])
def test_flash_attention_on_meta_takes_the_cards_branch(dtype, causal,
                                                        window):
    b, hq, hkv, s, d = 2, 8, 2, 64, 80
    q = meta(b, hq, s, d, dtype=dtype).requires_grad_()
    k = meta(b, hkv, s, d, dtype=dtype).requires_grad_()
    v = meta(b, hkv, s, d, dtype=dtype).requires_grad_()
    launches = (fk.LAUNCHES, fk.LAUNCHES_BWD)
    item = torch.finfo(dtype).bits // 8
    fwd = cost.attention_flops(b, hq, s, d, causal, window)
    with torch.enable_grad():
        o, c = cost.count(flash_attention, q, k, v, causal=causal,
                          window=window)
        assert o.shape == q.shape and o.dtype == dtype
        assert o.device.type == "meta" and o.grad_fn is not None
        assert c.kernels == {"flash_attention": 1}
        assert c.flops == fwd
        # q, k, v read, the output and the float32 log-sum-exp written
        assert c.bytes == (2 * q.numel() + 2 * k.numel()) * item \
            + b * hq * s * 4
        grads, cb = cost.count(torch.autograd.grad, o, (q, k, v),
                               torch.empty_like(o))
    assert [g.shape for g in grads] == [q.shape, k.shape, v.shape]
    assert cb.kernels == {"flash_attention_bwd": 1}
    assert cb.flops == cost.attention_bwd_flops(b, hq, s, d, causal,
                                                window) == fwd * 5 // 2
    assert (fk.LAUNCHES, fk.LAUNCHES_BWD) == launches
    with pytest.raises(ValueError, match="head dims"):
        flash_attention(meta(1, 2, 8, 36), meta(1, 2, 8, 36),
                        meta(1, 2, 8, 36))


def test_flash_attention_on_meta_checks_tma_alignment_by_offset():
    base = meta(2, 4, 64, 72, dtype=torch.bfloat16)
    q = base[..., 8:]                     # offset 16 B: aligned, stride 72
    assert fk.tma_aligned(q)
    assert not fk.tma_aligned(base[..., 4:68])  # offset 8 B
    with pytest.raises(ValueError, match="16-byte aligned"):
        fk.flash_attention_cuda(base[..., 4:68], base[..., 4:68],
                                base[..., 4:68])


def search_least(per_position, s):
    return min(per_position(c) for c in range(1, s + 1))


@pytest.mark.parametrize("s", [8, 64, 512])
def test_rwkv6_formulas_are_the_least_work_of_any_chunking(s):
    dk = dv = 64
    fwd = search_least(lambda c: 4 * dk * dv + (c - 1) * dk + (c + 1) * dv
                       + dk * dv / c, s)
    assert cost.rwkv6_scan_flops(2, s, 3, dk, dv) == round(2 * 3 * s * fwd)
    bwd = search_least(lambda c: 4 * dk * dv + (c - 1) / 2 * (3 * dk + dv)
                       + (c + 1) / 2 * dv + dk * dv / c, s)
    assert cost.rwkv6_scan_bwd_flops(2, s, 3, dk, dv) == \
        round(2 * 2 * 3 * s * bwd)


def test_rwkv6_scan_on_meta_takes_the_cards_branch():
    b, s, h, d = 2, 128, 4, 64
    r, k, v = (meta(b, s, h, d, dtype=torch.bfloat16).requires_grad_()
               for _ in range(3))
    w = meta(b, s, h, d).requires_grad_()
    u = meta(b, h, d).requires_grad_()
    launches = (sk.LAUNCHES, sk.LAUNCHES_BWD)
    with torch.enable_grad():
        (o, state), c = cost.count(chunked_scan, r, k, v, w, u, chunk=64,
                                   out_dtype=torch.float32,
                                   return_state=True)
        assert (o.shape, o.dtype) == ((b, s, h, d), torch.float32)
        assert tuple(state.shape) == (b, h, d, d)
        assert c.kernels == {"rwkv6_scan": 1}
        assert c.flops == cost.rwkv6_scan_flops(b, s, h, d, d)
        grads, cb = cost.count(torch.autograd.grad, o, (r, k, v, w, u),
                               torch.empty_like(o))
    assert [g.shape for g in grads] == [t.shape for t in (r, k, v, w, u)]
    assert cb.kernels == {"rwkv6_scan_bwd": 1}
    assert cb.flops == cost.rwkv6_scan_bwd_flops(b, s, h, d, d)
    assert (sk.LAUNCHES, sk.LAUNCHES_BWD) == launches
    with pytest.raises(ValueError, match="dk and dv"):
        sk.rwkv6_scan_cuda(meta(1, 8, 1, 24), meta(1, 8, 1, 24),
                           meta(1, 8, 1, 24), meta(1, 8, 1, 24),
                           meta(1, 1, 24), chunk=8)


def test_ring_allgather_and_the_stacked_collectives_on_meta():
    launches = rk.LAUNCHES
    xs = meta(4, 6, 10)
    out, c = cost.count(ring_allgather, xs)
    assert tuple(out.shape) == (4, 4, 6, 10)
    assert c.kernels == {"ring_allgather": 1} and c.flops == 0
    assert rk.LAUNCHES == launches
    coll = BoundCollectives("model")
    stacked = meta(4, 8, 10)
    for op, fn, shape, row in [
            ("all-reduce", coll.psum, (4, 8, 10), 8 * 10 * 4),
            ("all-reduce", coll.pmean, (4, 8, 10), 8 * 10 * 4),
            ("all-gather", coll.all_gather, (4, 32, 10), 4 * 8 * 10 * 4),
            ("reduce-scatter", coll.reduce_scatter, (4, 2, 10),
             2 * 10 * 4)]:
        y, c = cost.count(fn, stacked)
        assert tuple(y.shape) == shape and y.device.type == "meta"
        assert c.collectives == [(op, row, 4)], op
    _, c = cost.count(coll.all_to_all, meta(4, 4, 3))
    assert c.collectives == [("all-to-all", 4 * 3 * 4, 4)]
    # the same calls with no counter in force record nothing and run
    assert coll.psum(torch.ones(4, 3)).tolist() == [[4.0] * 3] * 4


def test_counting_collectives_shapes_and_records():
    cc = cost.CountingCollectives()
    x = meta(4, 8, 10)
    with cost.CostCounter() as c:
        assert tuple(cc.psum(x).shape) == (4, 8, 10)
        assert tuple(cc.all_gather(x).shape) == (4, 32, 10)
    assert c.cost.collectives == [("all-reduce", 8 * 10 * 4, 4),
                                  ("all-gather", 4 * 8 * 10 * 4, 4)]
    assert c.cost.bytes == 0
    with pytest.raises(ValueError, match="meta tensors only"):
        cc.psum(torch.zeros(4, 2))


def test_meta_is_a_device_only_where_asked_for():
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    assert resolve_device("meta", allow_meta=True).type == "meta"
    assert resolve_device("cpu", allow_meta=True).type == "cpu"
    assert cost.active() is None
    cost.record_kernel("x", 1, (), ())            # no counter: nothing
    cost.record_collective("all-reduce", 1, 2)


@pytest.mark.parametrize("arch", ["llama3_8b", "mixtral_8x22b",
                                  "rwkv6_1_6b"])
def test_a_train_step_frees_what_it_drops_without_the_cyclic_collector(
        arch):
    """Reference counting alone frees a train step's garbage: with the
    cyclic collector off, the live bytes after each of three steps are
    the new state's, and the collector then frees no storage. (A recursive
    closure in the layers' unstacking was a reference cycle holding the
    old parameters' views until the collector ran, a layer's parameters
    more a step: at Nemotron-4's width the card ran out of memory.)"""
    import gc

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import ShapeConfig
    from repro_torch.launch.mesh import LogicalMesh
    from repro_torch.launch.specs import input_specs

    cfg = get_config(arch).reduced()
    cell = input_specs(cfg, ShapeConfig("t", 32, 4, "train"),
                       LogicalMesh(("data", "model"), (1, 1)))
    state, batch = cell.abstract_args
    gc.collect()
    gc.disable()
    try:
        with cost.CostCounter() as c:
            live = []
            for _ in range(3):
                state, metrics = cell.fn(state, batch)
                del metrics
                live.append(c._live_bytes)
            assert live[0] == live[1] == live[2] > 0
            gc.collect()
            assert c._live_bytes == live[2]
    finally:
        gc.enable()
