"""The port's CUDA kernels on the card, against their plain versions.

These tests need a CUDA device and skip without one (the check runs
inside a fixture, never at import). On the card::

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest``: the shared ``conftest.py`` imports the reference
package, which the card's machine need not have.)

Copies are held bit for bit; the Jacobi sweep to float32 atol 1e-6 and
bfloat16 atol 2e-2 (the kernel rounds once, the plain version per add).
The ring all-gather and the captured Jacobi step (float32) are held bit
for bit against their plain or eager versions.
"""

import pytest
import torch

from repro_torch.comm import CommConfig, CommSession, PathPlanner, lower
from repro_torch.comm.passes import apply_schedule
from repro_torch.core.halo import jacobi_step, make_captured_jacobi_step
from repro_torch.core.topology import Topology
from repro_torch.kernels.jacobi import kernel as jk
from repro_torch.kernels.multipath_dma import kernel as dk
from repro_torch.kernels.ring_allgather import kernel as rk

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


@pytest.mark.parametrize("n", [1, 4, 8])
@pytest.mark.parametrize("rows,f", [(8, 128), (4, 64), (8, 7), (3, 1),
                                    (300, 1000)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_allgather_matches_plain(dev, n, rows, f, dtype):
    xs = torch.randn(n, rows, f, device=dev).to(dtype)
    g = rk.RingGeometry.for_shape(n, rows, f, xs.element_size())
    state = torch.empty(2 + g.num_items, dtype=torch.int32, device=dev)
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
