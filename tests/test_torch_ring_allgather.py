"""The port's ``ring_allgather`` against the reference Pallas kernel.

The reference runs ``ops.ring_allgather`` (the Pallas kernel in interpret
mode) on n CPU devices; the port runs ``ring_allgather`` on the stacked
shards ``(n, rows, f)``, its plain version on the CPU. A gather does no
arithmetic, so every replica must equal the reference bit for bit. The
kernel itself runs only on the card (``tests/test_torch_cuda.py``); here
its work decomposition is replayed in a random order by a Python model of
the item decode in ``csrc/ring_allgather.cu``, byte by byte.
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


#: ``UNROLL`` of ``csrc/ring_allgather.cu``: vectors a thread loads before
#: its stores.
UNROLL = 4


def vector_bytes(*addresses: int) -> int:
    """The kernel's vector width for an item: 16 bytes when every address
    (and the length) is a multiple of 16, else 4, else 1."""
    a = 0
    for v in addresses:
        a |= v
    return 16 if a % 16 == 0 else 4 if a % 4 == 0 else 1


def thread_vectors(nv: int) -> np.ndarray:
    """Every vector index the block's threads touch in ``push_vec``:
    thread t, turn k, unrolled load u takes t + (k·UNROLL + u)·THREADS."""
    t = rk.THREADS
    turns = np.arange(0, nv, UNROLL * t)
    i = (turns[:, None, None] + np.arange(UNROLL)[None, :, None] * t
         + np.arange(t)[None, None, :]).ravel()
    return i[i < nv]


def kernel_model(x: np.ndarray, tile_bytes, seed: int = 0):
    """Execute the kernel's items as ``ring_allgather.cu`` decodes them,
    in a random order of completion, on the bytes of ``x: (n, rows, f)``
    (input and output bases 16-byte aligned, as torch allocates them).
    Returns the replicas ``(n, n, rows, f)``, how often each input byte
    was read and each output byte written, and each item's vector
    width."""
    n = x.shape[0]
    g = rk.RingGeometry.for_shape(n, *x.shape[1:], x.itemsize, tile_bytes)
    size = g.shard_bytes
    src = np.ascontiguousarray(x).view(np.uint8).reshape(-1)
    out = np.zeros(n * n * size, np.uint8)
    reads = np.zeros(n * size, np.int64)
    writes = np.zeros(n * n * size, np.int64)
    widths = []
    for it in np.random.RandomState(seed).permutation(g.num_items):
        b, c = divmod(int(it), g.chunks)
        off, length = g.chunk(c)
        s0 = b * size + off
        # receivers b, b + 1, ... (mod n): block b of each replica
        dsts = [(((b + j) % n) * n + b) * size + off for j in range(n)]
        w = vector_bytes(s0, length, *dsts)
        widths.append(w)
        assert length % w == 0
        vec = thread_vectors(length // w)
        assert np.array_equal(np.sort(vec), np.arange(length // w))
        byte = (vec[:, None] * w + np.arange(w)).ravel()
        reads[s0 + byte] += 1
        for d0 in dsts:
            out[d0 + byte] = src[s0 + byte]
            writes[d0 + byte] += 1
    return (out.view(x.dtype).reshape((n,) + x.shape), reads, writes,
            widths)


def payload(seed, shape, dtype) -> np.ndarray:
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if dtype == "bfloat16":
        return (x.view(np.uint32) >> 16).astype(np.uint16)
    return x


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("rows,f", [(8, 128), (8, 7), (33, 17), (3, 1),
                                    (1024, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tile_bytes", [16, 4096, None])
def test_kernel_work_decomposition(n, rows, f, dtype, tile_bytes):
    """Each shard byte is read once and each replica byte written once, so
    the kernel moves (n·S, n²·S) bytes; the replicas equal the oracle's;
    (rows, 2) shards (psum's) take 16-byte vectors, a shard whose size is
    not a multiple of 16 narrower ones, which still cover it."""
    x = payload(1, (n, rows, f), dtype)
    got, reads, writes, widths = kernel_model(x, tile_bytes)
    np.testing.assert_array_equal(got, ring_allgather_ref(x))
    assert (reads == 1).all() and (writes == 1).all()
    g = rk.RingGeometry.for_shape(n, rows, f, x.itemsize, tile_bytes)
    assert g.bytes_moved() == (reads.sum(), writes.sum())
    size = g.shard_bytes
    if size % 16 == 0 and g.chunk_bytes % 16 == 0:
        assert set(widths) == {16}
    else:
        assert min(widths) < 16


def test_geometry_of_the_main_path_shape():
    g = rk.RingGeometry.for_shape(4, 2048, 8192, 4)
    assert (g.chunk_bytes, g.chunks, g.num_items) == (128 << 10, 512, 2048)
    # each shard read once, written into all four replicas
    shard = 2048 * 8192 * 4
    assert g.bytes_moved() == (4 * shard, 16 * shard)
    # path S's combine gather, (rows, 2) bf16: chunks halved to 32 KiB for
    # enough items (768), and the psum of path V's (4097, 4095) to 64 KiB
    s = rk.RingGeometry.for_shape(4, 1_572_864, 2, 2)
    assert (s.chunk_bytes, s.num_items) == (32 << 10, 768)
    v = rk.RingGeometry.for_shape(4, 2_097_152, 2, 4)
    assert (v.chunk_bytes, v.num_items) == (64 << 10, 1024)
    tiny = rk.RingGeometry.for_shape(8, 8, 1, 2)
    assert (tiny.chunk_bytes, tiny.chunks, tiny.chunk(0)) == (
        rk.MIN_TILE_BYTES, 1, (0, 16))


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
