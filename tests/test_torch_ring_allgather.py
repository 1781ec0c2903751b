"""The port's ``ring_allgather`` against the reference Pallas kernel.

The reference runs ``ops.ring_allgather`` (the Pallas kernel in interpret
mode) on n CPU devices; the port runs ``ring_allgather`` on the stacked
shards ``(n, rows, f)``, its plain version on the CPU. A gather does no
arithmetic, so every replica must equal the reference bit for bit. The
kernel itself runs only on the card (``tests/test_torch_cuda.py``); here
its work decomposition is replayed in index order by a Python model of
the item decode in ``csrc/ring_allgather.cu``.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ring_allgather import ops as jops

from repro_torch.comm import CommSession, StepCapture
from repro_torch.kernels.ring_allgather import kernel as rk
from repro_torch.kernels.ring_allgather import ops
from repro_torch.kernels.ring_allgather.ref import ring_allgather_ref


def shards(seed, n, rows, f, dtype):
    """(torch stacked shards, jax global array) from the same bits."""
    x = np.random.RandomState(seed).randn(n * rows, f).astype(np.float32)
    if dtype == "float32":
        return torch.from_numpy(x.copy()).view(n, rows, f), jnp.asarray(x)
    b = (x.view(np.uint32) >> 16).astype(np.uint16)
    t = torch.from_numpy(b.view(np.int16).copy()).view(torch.bfloat16)
    return t.view(n, rows, f), jnp.asarray(b).view(jnp.bfloat16)


def bits(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    return np.asarray(a.view(jnp.uint16) if a.dtype == jnp.bfloat16 else a)


@pytest.mark.parametrize("n", [4, 8])
@pytest.mark.parametrize("rows,f", [(8, 128), (4, 64), (8, 7)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_equals_reference_kernel(n, rows, f, dtype):
    xs, xj = shards(0, n, rows, f, dtype)
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:n]), ("dev",))
    want = bits(jops.ring_allgather(xj, mesh))
    got = ops.ring_allgather(xs)
    assert got.shape == (n, n, rows, f) and got.dtype == xs.dtype
    for d in range(n):
        np.testing.assert_array_equal(bits(got[d].reshape(n * rows, f)),
                                      want)


@pytest.mark.parametrize("n", [1, 2, 3, 5])
@pytest.mark.parametrize("rows,f", [(3, 1), (2, 2), (5, 9), (1, 33)])
def test_plain_equals_numpy_oracle(n, rows, f):
    x = np.random.RandomState(n).randn(n, rows, f).astype(np.float32)
    got = rk.ring_allgather_plain(torch.from_numpy(x))
    np.testing.assert_array_equal(got.numpy(), ring_allgather_ref(x))


def kernel_model(x: np.ndarray, tile_bytes: int) -> np.ndarray:
    """Execute the kernel's items in ticket order, as ``ring_allgather.cu``
    decodes them; every predecessor must be done before its item."""
    n, rows, f = x.shape
    g = rk.RingGeometry.for_shape(n, rows, f, x.itemsize, tile_bytes)
    out = np.full((n, n, rows, f), np.nan, x.dtype)
    tiles = g.rtiles * g.ctiles
    done = np.zeros(g.num_items, bool)
    for it in range(g.num_items):
        t, q = it % tiles, it // tiles
        dr, q = q % g.ndir, q // g.ndir
        d, p = q % n, q // n
        rt, ct = t // g.ctiles, t % g.ctiles
        lo = g.half if dr else 0
        width = g.f - g.half if dr else g.half
        c0, r0 = ct * g.cc, rt * g.rpt
        nr = min(g.rpt, rows - r0)
        w = 0 if c0 >= width else min(width - c0, g.cc)
        sd = (d + 1) % n if dr else (d + n - 1) % n
        b = d if p == 0 else ((d + p) % n if dr else (d + n - p) % n)
        if p > 0:
            pred = (((p - 1) * n + sd) * g.ndir + dr) * tiles + t
            assert pred < it and done[pred]
        src = x[d] if p == 0 else out[sd, b]
        tile = src[r0:r0 + nr, lo + c0:lo + c0 + w]
        assert not np.isnan(tile).any()
        out[d, b, r0:r0 + nr, lo + c0:lo + c0 + w] = tile
        done[it] = True
    return out


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("rows,f", [(8, 128), (8, 7), (33, 17), (3, 1)])
@pytest.mark.parametrize("tile_bytes", [16, 4096, rk.TILE_BYTES])
def test_kernel_work_decomposition(n, rows, f, tile_bytes):
    x = np.random.RandomState(1).randn(n, rows, f).astype(np.float32)
    np.testing.assert_array_equal(kernel_model(x, tile_bytes),
                                  ring_allgather_ref(x))


def test_geometry_of_the_main_path_shape():
    g = rk.RingGeometry.for_shape(4, 2048, 8192, 4)
    assert (g.half, g.ndir, g.cc, g.rpt) == (4096, 2, 4096, 8)
    assert g.num_items == 4 * 4 * 2 * 256
    # every one of the n² blocks of every replica is read and written once
    assert g.bytes_moved() == (16 * 2048 * 8192 * 4,) * 2
    narrow = rk.RingGeometry.for_shape(8, 8, 1, 2)
    assert (narrow.half, narrow.ndir) == (1, 1)


def test_wrappers_raise_instead_of_falling_back():
    """A CPU tensor into the kernel's wrapper raises, and so does a device
    other than the card, the CPU and meta; a meta tensor (a cost
    count's) takes the card's branch and launches nothing."""
    xs = torch.zeros(4, 2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        rk.ring_allgather_cuda(xs)
    other = types.SimpleNamespace(device=torch.device("xla", 0))
    with pytest.raises(ValueError, match="unsupported device"):
        ops.ring_allgather(other)
    launches = rk.LAUNCHES
    out = ops.ring_allgather(xs.to("meta"))
    assert out.device.type == "meta" and tuple(out.shape) == (4, 4, 2, 8)
    assert rk.LAUNCHES == launches


def test_captured_ring_allgather_records_one_node():
    sess = CommSession(device="cpu")
    n = sess.num_devices
    cap = StepCapture(n)
    x = cap.input((2, 4), torch.float32)
    out = ops.captured_ring_allgather(cap, x, n)
    assert cap.buffers[out.buf_id].shape == (n * 2, 4)
    (op,) = [o for o in cap.ops if o[0] == "kernel"]
    assert op[1:] == ("ring_allgather", (x.buf_id,), (out.buf_id,), 0, 0)
