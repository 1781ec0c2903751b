"""The ``ring_allgather`` kernel: a bidirectional-ring all-gather in one launch.

Replaces the Pallas kernel ``build_ring_allgather`` of the reference package
(``src/repro/kernels/ring_allgather/kernel.py``). There, each chip holds one
shard ``(rows, f)`` and, over ``N - 1`` ring steps, forwards the first half
of the features clockwise and the second half counter-clockwise with remote
DMAs. Here the logical devices are rows of one stacked tensor
``xs: (n, rows, f)`` on one card, and device ``d``'s replica of the gather
is ``out[d]: (n, rows, f)``; the ring's copies run between replicas.

:func:`ring_allgather_cuda` launches the hand-written kernel
(``csrc/ring_allgather.cu``, built by :mod:`repro_torch.kernels._build`);
:func:`ring_allgather_plain` replays the same ring step by step with
``torch.roll`` and slice writes, the plain PyTorch version used for CPU
tensors and as the check of the kernel on the card. :data:`LAUNCHES` counts
kernel launches. A meta tensor, which a cost count
(:mod:`repro_torch.launch.cost`) passes, gets the CUDA wrapper's checks
and an empty output, launching nothing.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import _build
from repro_torch.launch import cost

#: Largest tile, in bytes, that one block copies in one work item.
TILE_BYTES = 128 << 10
#: Blocks per SM of the persistent grid.
_BLOCKS_PER_SM = 2

#: Kernel launches so far.
LAUNCHES = 0


def ring_half(f: int) -> int:
    """Width of the clockwise half: ``f // 2``, or ``f`` when that is 0
    (the narrow case runs one direction only)."""
    return f // 2 or f


def ring_allgather_plain(xs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``xs: (n, rows, f)`` → ``(n, n, rows, f)``,
    where ``out[d]`` is device ``d``'s replica of the tiled gather.

    Replays the ring: each step rolls the travelling halves one device on
    (clockwise for ``[..., :half]``, counter-clockwise for the rest) and
    writes them into the block they carry."""
    n, rows, f = xs.shape
    half = ring_half(f)
    out = xs.new_zeros((n, n, rows, f))
    dev = torch.arange(n, device=xs.device)
    out[dev, dev] = xs
    cur0, cur1 = xs[..., :half], xs[..., half:]
    for step in range(1, n):
        cur0 = torch.roll(cur0, 1, dims=0)        # d receives from d - 1
        out[dev, (dev - step) % n, :, :half] = cur0
        if half < f:
            cur1 = torch.roll(cur1, -1, dims=0)   # d receives from d + 1
            out[dev, (dev + step) % n, :, half:] = cur1
    return out


@dataclasses.dataclass(frozen=True)
class RingGeometry:
    """The kernel's work decomposition for one ``(n, rows, f)`` shape:
    items are ``(phase, device, direction, tile)`` with ``rtiles × ctiles``
    tiles of at most ``rpt`` rows by ``cc`` columns per direction."""

    n: int
    rows: int
    f: int
    itemsize: int
    half: int
    ndir: int
    rpt: int
    cc: int
    rtiles: int
    ctiles: int

    @classmethod
    def for_shape(cls, n: int, rows: int, f: int, itemsize: int,
                  tile_bytes: int = TILE_BYTES) -> "RingGeometry":
        half = ring_half(f)
        ndir = 2 if half < f else 1
        widest = max(half, f - half)
        cc = max(1, min(widest, tile_bytes // itemsize))
        rpt = max(1, tile_bytes // (cc * itemsize))
        return cls(n, rows, f, itemsize, half, ndir, rpt, cc,
                   -(-rows // rpt), -(-widest // cc))

    @property
    def num_items(self) -> int:
        return self.n * self.n * self.ndir * self.rtiles * self.ctiles

    def bytes_moved(self) -> tuple[int, int]:
        """(bytes read, bytes written) by the ring: every block of every
        replica is written once and read once (from the input shard or a
        neighbour's replica)."""
        block = self.rows * self.f * self.itemsize
        return self.n * self.n * block, self.n * self.n * block


def _lib():
    lib = _build.load("ring_allgather")
    fn = lib.ring_allgather_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] * 11
                   + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ring_allgather_cuda(xs: torch.Tensor, *,
                        state: torch.Tensor | None = None) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor ``xs: (n, rows, f)``; returns a
    new ``(n, n, rows, f)`` tensor. ``state``, when given, receives the
    kernel's state words (``state[1]`` = completed items after the run);
    it must hold at least ``2 + num_items`` int32 words. A meta tensor
    gets the same checks and an empty output, and launches nothing; both
    report the kernel's bytes to the cost counter
    (:func:`~repro_torch.launch.cost.record_kernel`)."""
    global LAUNCHES
    if xs.device.type not in ("cuda", "meta"):
        raise ValueError(f"ring_allgather kernel needs a CUDA tensor, got "
                         f"{xs.device}")
    if xs.dim() != 3 or xs.numel() == 0:
        raise ValueError(f"xs must be a non-empty (n, rows, f) tensor, got "
                         f"{tuple(xs.shape)}")
    xs = xs.contiguous()
    n, rows, f = xs.shape
    g = RingGeometry.for_shape(n, rows, f, xs.element_size())
    out = torch.empty((n, n, rows, f), dtype=xs.dtype, device=xs.device)
    if state is None:
        state = torch.empty(2 + g.num_items, dtype=torch.int32,
                            device=xs.device)
    elif (state.dtype != torch.int32 or state.device != xs.device
          or state.numel() < 2 + g.num_items):
        raise ValueError("state must be int32 on the input's device with "
                         f"at least {2 + g.num_items} words")
    state.zero_()
    if xs.device.type == "cuda":
        sms = torch.cuda.get_device_properties(
            xs.device).multi_processor_count
        grid = max(1, min(g.num_items, _BLOCKS_PER_SM * sms))
        rc = _lib()(xs.data_ptr(), out.data_ptr(), state.data_ptr(), g.n,
                    g.rows, g.f, g.itemsize, g.half, g.ndir, g.rpt, g.cc,
                    g.rtiles, g.ctiles, g.num_items, grid,
                    torch.cuda.current_stream(xs.device).cuda_stream)
        _build.check(rc, "ring_allgather")
        LAUNCHES += 1
    cost.record_kernel("ring_allgather", 0, (xs,), (out,))
    return out
