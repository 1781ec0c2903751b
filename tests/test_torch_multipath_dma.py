"""The port's ``multipath_dma`` module against the reference kernel.

On the CPU the port's wrapper runs the kernel's plain version (a loop of
slice copies over the work table). It must equal, BIT FOR BIT (a copy
does no arithmetic, so no tolerance applies), the reference Pallas kernel
run in TPU interpret mode on 4 CPU devices, the reference numpy oracles
(``multipath_transfer_ref``, ``replay_schedule``) and the port's own.
bfloat16 is compared through ``uint16`` views so the bits themselves are
held equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import PathPlanner as JPathPlanner
from repro.core import Topology as JTopology
from repro.kernels.multipath_dma import ops as jops
from repro.kernels.multipath_dma import ref as jref

from repro_torch.comm.graph import lower
from repro_torch.comm.passes import apply_schedule
from repro_torch.comm.planner import PathPlanner
from repro_torch.core.topology import Topology
from repro_torch.kernels.multipath_dma import kernel as dk
from repro_torch.kernels.multipath_dma import ops
from repro_torch.kernels.multipath_dma import ref


@pytest.fixture(scope="module")
def jmesh4():
    return jax.sharding.Mesh(np.array(jax.devices()[:4]), ("dev",))


def planners(threshold=4):
    return (JPathPlanner(JTopology.full_mesh(4), multipath_threshold=threshold),
            PathPlanner(Topology.full_mesh(4), multipath_threshold=threshold))


def bits(seed: int, shape, dtype: str) -> np.ndarray:
    """Random payload as raw bits: float32 values, or the top 16 bits of
    float32 values for bfloat16 (uint16)."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return x if dtype == "float32" else (x.view(np.uint32) >> 16).astype(
        np.uint16)


def to_torch(b: np.ndarray, dtype: str) -> torch.Tensor:
    t = torch.from_numpy(b.copy())
    return t if dtype == "float32" else t.view(torch.int16).view(
        torch.bfloat16)


def from_torch(t: torch.Tensor, dtype: str) -> np.ndarray:
    return t.numpy() if dtype == "float32" else t.view(torch.int16).numpy(
    ).view(np.uint16)


def to_jax(b: np.ndarray, dtype: str):
    a = jnp.asarray(b)
    return a if dtype == "float32" else a.view(jnp.bfloat16)


@pytest.mark.parametrize("nelems,paths,chunks,dtype", [
    (512, 1, 1, "float32"), (1024, 3, 4, "bfloat16"),
    (768, 3, 3, "float32"), (2048, 2, 8, "bfloat16")])
def test_plain_equals_interpret_kernel(jmesh4, nelems, paths, chunks, dtype):
    jp, pp = planners()
    isz = 4 if dtype == "float32" else 2
    kw = dict(granularity=isz, max_paths=paths, num_chunks=chunks)
    jplan = jp.plan(0, 1, nelems * isz, **kw)
    pplan = pp.plan(0, 1, nelems * isz, **kw)
    b = bits(nelems + paths, (4, nelems), dtype)
    got = from_torch(ops.multipath_dma_transfer(to_torch(b, dtype), pplan),
                     dtype)
    kern = jops.multipath_dma_transfer(to_jax(b, dtype), jplan, jmesh4)
    kern = np.asarray(kern.view(jnp.uint16) if dtype == "bfloat16"
                      else kern)
    np.testing.assert_array_equal(got, kern)
    np.testing.assert_array_equal(got, jref.multipath_transfer_ref(b, jplan))
    np.testing.assert_array_equal(got, jref.replay_schedule(b, jplan, isz))
    np.testing.assert_array_equal(got, ref.multipath_transfer_ref(b, pplan))
    np.testing.assert_array_equal(got, ref.replay_schedule(b, pplan, isz))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("paths,chunks", [(1, 1), (2, 3), (3, 8), (4, 5)])
def test_plain_equals_oracles_unaligned(dtype, paths, chunks):
    """Odd element counts: chunk offsets are element- but not 16-byte
    aligned, and tiles smaller than a chunk split every node."""
    jp, pp = planners()
    isz = 4 if dtype == "float32" else 2
    nelems = 1001
    jplan = jp.plan(2, 0, nelems * isz, granularity=isz, max_paths=paths,
                    num_chunks=chunks)
    pplan = pp.plan(2, 0, nelems * isz, granularity=isz, max_paths=paths,
                    num_chunks=chunks)
    b = bits(7, (4, nelems), dtype)
    x = to_torch(b, dtype)
    table = dk.build_node_table(lower(pplan), [nelems], [isz], 4,
                                fill="copy", tile_bytes=100)
    prog = dk.DmaProgram(table, [x.dtype], "cpu")
    prog.inputs()[0][0].copy_(x)
    prog.run()
    got = from_torch(prog.outputs()[0][0], dtype)
    np.testing.assert_array_equal(got, jref.replay_schedule(b, jplan, isz))
    assert prog.completed_nodes() == lower(pplan).num_copy_nodes


def test_rejects_three_hop_and_host():
    torus = PathPlanner(Topology.torus2d(4, 4), multipath_threshold=4)
    plan = torus.plan(0, 1, 4096, granularity=4, max_paths=3)
    assert max(p.route.num_hops for p in plan.paths) == 3
    with pytest.raises(NotImplementedError):
        ops.multipath_dma_transfer(torch.zeros(16, 1024), plan)
    _, pp = planners()
    hplan = pp.plan(0, 1, 4096, granularity=4, max_paths=4,
                    include_host=True)
    assert any(p.route.kind == "staged_host" for p in hplan.paths)
    with pytest.raises(ValueError, match="host"):
        ops.multipath_dma_transfer(torch.zeros(4, 1024), hplan)
    with pytest.raises(ValueError, match="host"):
        dk.build_node_table(lower(hplan), [1024], [4], 4)
    plan = pp.plan(0, 1, 4098, granularity=1, max_paths=2, num_chunks=3)
    with pytest.raises(ValueError, match="element-aligned"):
        dk.build_node_table(lower(plan), [1024 + 1], [4], 4)
    with pytest.raises(ValueError, match="fill"):
        dk.build_node_table(lower(plan), [4098], [1], 4, fill="ones")


def _coverage(table, copies_only=False):
    """Count how often each output byte is written (by every item, or by
    copy-node tiles only)."""
    cover = np.zeros(table.io_bytes, dtype=np.int64)
    for row in table.items:
        if row[dk.C_DST_SPACE] == dk.SPACE_OUT and (
                not copies_only or row[dk.C_NODE] >= 0):
            off, nb = row[dk.C_DST_OFF], row[dk.C_NBYTES]
            cover[off:off + nb] += 1
    return cover


@pytest.mark.parametrize("schedule", ["round_robin", "depth_first",
                                      "critical_path", "auto"])
@pytest.mark.parametrize("window", [1, 2])
def test_node_table_covers_each_message_once(schedule, window):
    topo = Topology.torus2d(4, 4)
    pp = PathPlanner(topo, multipath_threshold=4)
    group = pp.plan_group([(0, 1, 4004, 4), (5, 6, 1600, 2),
                           (3, 12, 4000, 4)])
    graph, _ = apply_schedule(lower(group, window), schedule, topo)
    nelems = [1001, 800, 1000]
    table = dk.build_node_table(graph, nelems, [4, 2, 4], 16,
                                tile_bytes=256)
    cover = _coverage(table)
    terminal = _coverage(table, copies_only=True)
    for lay in table.messages:
        region = cover[lay.base:lay.base + lay.nbytes]
        # every output byte of the message's region written exactly once:
        # the destination rows by terminal copies, every other row by fills
        assert (region == 1).all()
        for w in range(window):
            start = lay.row_offset(w, lay.dst)
            assert (terminal[start:start + lay.row_bytes] == 1).all()
    # predecessors point backwards (claimed earlier, so waits cannot
    # deadlock) and name a tile of the hop-predecessor node
    preds = graph.hop_predecessor
    for i, row in enumerate(table.items):
        if row[dk.C_PRED] >= 0:
            assert row[dk.C_PRED] < i
            pred_row = table.items[row[dk.C_PRED]]
            assert pred_row[dk.C_NODE] == preds[row[dk.C_NODE]]
            assert pred_row[dk.C_NBYTES] == row[dk.C_NBYTES]
    assert table.num_copy_nodes == graph.num_copy_nodes
    # zero-fill execution: destination rows hold the message, the rest 0
    prog = dk.DmaProgram(table, [torch.float32, torch.bfloat16,
                                 torch.float32], "cpu")
    msgs = [torch.randn(n).to(d) for n, d in
            zip(nelems, [torch.float32, torch.bfloat16, torch.float32])]
    for buf, m, lay in zip(prog.inputs(), msgs, table.messages):
        buf.fill_(7)
        buf[:, lay.src].copy_(m)
    prog.run()
    assert prog.completed_nodes() == graph.num_copy_nodes
    for y, m, lay in zip(prog.outputs(), msgs, table.messages):
        for w in range(window):
            assert torch.equal(y[w, lay.dst], m)
            others = [r for r in range(16) if r != lay.dst]
            assert not y[w, others].any()
