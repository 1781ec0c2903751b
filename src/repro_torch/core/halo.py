"""Multi-path halo exchange — the paper's Jacobi application (§5.4, Fig. 11).

A 1-D ring decomposition (the paper uses 4 ranks, each exchanging boundary
columns with its two neighbours). The domain is device-stacked: one
tensor ``(n, rows, cols)`` whose leading index is the rank, on one
``torch.device``; or, on a peer session (``CommSession(devices=...)``), a
list of ``n`` blocks ``(rows, cols)``, block *i* on ``devices[i]``, where
:func:`halo_exchange_group` and :func:`jacobi_step` take and return lists
(one fused exchange a step, then the ``jacobi`` kernel on each card's own
block). Rank *i*'s halos come either from the session's fused
exchange (:func:`halo_exchange_group`, through the ``multipath_dma``
kernel) or from row shifts of the stacked tensor (:func:`halo_exchange_ring`,
the counterpart of the reference's ``ppermute`` shifts, with the same
direct/staged split of each boundary). :func:`jacobi_step` masks the
global edge with Dirichlet zeros and sweeps with the ``jacobi`` kernel.
:func:`make_captured_jacobi_step` records one whole iteration (boundary
slices, the fused ring exchange, the sweep) with ``session.capture`` and
replays it as ONE dispatch per call: one CUDA graph on a stacked session,
one a card on a peer session, where the step takes and returns a list of
``n`` blocks ``(rows, cols)``, block *i* on ``devices[i]``.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from repro_torch.kernels.jacobi import ops as jacobi_ops
from repro_torch.kernels.jacobi.kernel import jacobi_sweep_plain

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.comm.session import CommSession


def _shift(x: torch.Tensor, shift: int) -> torch.Tensor:
    """Rank *i* sends to rank *i + shift*: row *j* of the result holds
    row *j - shift* of ``x`` (ring wrap-around)."""
    return torch.roll(x, shifts=shift, dims=0)


def halo_exchange_ring(left_bnd: torch.Tensor, right_bnd: torch.Tensor, *,
                       multipath: bool = False
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Exchange boundaries with ring neighbours over the stacked axis 0.

    ``left_bnd``/``right_bnd`` are every rank's own boundary slices,
    ``(n, ...)``. Returns ``(left_halo, right_halo)``: for rank *i* the
    right boundary of rank *i-1* and the left boundary of rank *i+1*.
    ``multipath=True`` splits each boundary in two stripes along the last
    axis: the first moves over the direct ±1 shift, the second is staged
    through the rank two hops around the ring (the idle diagonal of a
    4-rank node) — the same data movement, as two shifts.
    """
    n = left_bnd.shape[0]
    if n == 1:
        return right_bnd, left_bnd
    if not multipath or n < 3:
        return _shift(right_bnd, 1), _shift(left_bnd, -1)

    def split(b):
        h = b.shape[-1] // 2
        if h == 0:
            return b, b[..., :0]
        return b[..., :h], b[..., h:]

    r0, r1 = split(right_bnd)
    left_halo = torch.cat([_shift(r0, 1), _shift(_shift(r1, 2), -1)], dim=-1)
    l0, l1 = split(left_bnd)
    right_halo = torch.cat([_shift(l0, -1), _shift(_shift(l1, -2), 1)],
                           dim=-1)
    return left_halo, right_halo


def halo_exchange_group(session: "CommSession", blocks
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """Driver-level ring halo exchange as ONE fused transfer group.

    ``blocks`` is the column-decomposed domain ``(n, rows, cols)``, or a
    list of ``n`` per-device blocks ``(rows, cols)`` on a peer session.
    Every rank's two boundary columns ride a single ``2n``-message group
    through ``session.exchange`` — one graph replay. Returns
    ``(left_halos, right_halos)``, ``(n, rows, 1)`` each (lists of ``(rows,
    1)`` per device for a list): rank *i*'s left halo is rank *i-1*'s
    right boundary and vice versa (periodic; :func:`jacobi_step` applies
    the Dirichlet mask). Over peers each halo arrives on its rank's own
    device.
    """
    per_device = isinstance(blocks, (list, tuple))
    n = len(blocks) if per_device else blocks.shape[0]
    if n == 1:
        if per_device:
            return [blocks[0][:, -1:]], [blocks[0][:, :1]]
        return blocks[:, :, -1:], blocks[:, :, :1]
    items = []
    for i in range(n):
        items.append((blocks[i][:, -1:], i, (i + 1) % n))  # → right nbr
        items.append((blocks[i][:, :1], i, (i - 1) % n))   # → left nbr
    received = session.exchange(items)
    left_halos = [received[2 * ((i - 1) % n)] for i in range(n)]
    right_halos = [received[2 * ((i + 1) % n) + 1] for i in range(n)]
    if per_device:
        return left_halos, right_halos
    return torch.stack(left_halos), torch.stack(right_halos)


def make_captured_jacobi_step(session: "CommSession", rows: int, cols: int,
                              dtype=torch.float32, *,
                              schedule: str | None = None,
                              max_paths: int | None = None,
                              num_chunks: int | None = None):
    """Capture one whole Jacobi iteration (halo exchange + sweep) as ONE
    heterogeneous graph — the ``session.capture`` idiom.

    The returned :class:`~repro_torch.comm.capture.CapturedStep` takes the
    stacked domain ``(n, rows, cols)`` and returns the swept domain, same
    shape (on a peer session: a list of ``n`` blocks ``(rows, cols)``,
    block *i* on ``devices[i]``, in and out), in ONE dispatch: boundary
    extraction and the 5-point stencil are
    compute nodes, the ``2n``-message ring exchange is planned jointly
    (``max_paths``/``num_chunks`` as in :meth:`CommSession.exchange`), and
    the scheduler pass orders the graph. Each halo is joined from the
    exchange's reception buffers by exact zero-sum, the global edge gets
    Dirichlet zeros, and the sweep is ``jacobi_ops.jacobi_sweep`` — the
    ``jacobi`` kernel on a CUDA device, one launch a logical device over
    peers — so the result is bitwise the eager :func:`jacobi_step` with
    the same session.
    """
    from repro_torch.comm.capture import BufferSpec, axis_index, dtype_name

    n = session.engine.num_devices
    if n < 2:
        raise ValueError("captured Jacobi needs >= 2 devices (the ring "
                         "exchange cannot self-send)")

    def halo_slices(u_):
        return u_[:, :, -1], u_[:, :, 0]

    def sweep(u_, *halos):
        # device j's left halo is j-1's right boundary: of the n
        # right-going receptions exactly one is nonzero on each device.
        left_halo = halos[0]
        for h in halos[1:n]:
            left_halo = left_halo + h
        right_halo = halos[n]
        for h in halos[n + 1:]:
            right_halo = right_halo + h
        left_halo = left_halo.reshape(-1, rows, 1)
        right_halo = right_halo.reshape(-1, rows, 1)
        dev = axis_index(u_).view(-1, 1, 1)
        left_halo = torch.where(dev == 0, torch.zeros_like(left_halo),
                                left_halo)
        right_halo = torch.where(dev == n - 1,
                                 torch.zeros_like(right_halo), right_halo)
        ext = torch.cat([left_halo, u_, right_halo], dim=2)
        return jacobi_ops.jacobi_sweep(ext)

    def build(cap):
        u = cap.input((rows, cols), dtype)
        right, left = cap.kernel(halo_slices, u, name="halo_slices",
                                 flops=0)
        sends = ([(right, i, (i + 1) % n) for i in range(n)]
                 + [(left, i, (i - 1) % n) for i in range(n)])
        recvs = cap.exchange(sends, max_paths=max_paths,
                             num_chunks=num_chunks)
        return cap.kernel(sweep, u, *recvs, name="jacobi_sweep",
                          out=BufferSpec((rows, cols), dtype_name(dtype)),
                          flops=5 * rows * cols)

    return session.capture(build, schedule=schedule)


def jacobi_step(u, *, session: "CommSession | None" = None,
                multipath: bool = False,
                use_kernel: bool = True):
    """One Jacobi sweep of the stacked column-partitioned domain
    ``u: (n, rows, cols)``, or of a list of per-device blocks ``(rows,
    cols)`` on a peer session (returns a list, block *i* on its device).

    Halos come from ``session``'s fused exchange when one is given,
    otherwise from row shifts (:func:`halo_exchange_ring`, optionally
    multi-path; stacked only). The global edge gets Dirichlet zeros, then
    the 5-point stencil averages the four neighbours: the ``jacobi`` kernel
    on a CUDA tensor (``use_kernel=True``; one launch a block over peers),
    else the plain version.
    """
    sweep = jacobi_ops.jacobi_sweep if use_kernel else jacobi_sweep_plain
    if isinstance(u, (list, tuple)):
        if session is None:
            raise ValueError("per-device blocks take their halos from a "
                             "session's exchange; pass session=")
        left, right = halo_exchange_group(session, u)
        n = len(u)
        out = []
        for i, block in enumerate(u):
            lh = torch.zeros_like(left[i]) if i == 0 else left[i]
            rh = torch.zeros_like(right[i]) if i == n - 1 else right[i]
            out.append(sweep(torch.cat([lh, block, rh], dim=1)))
        return out
    if session is not None:
        left_halo, right_halo = halo_exchange_group(session, u)
    else:
        left_halo, right_halo = halo_exchange_ring(
            u[:, :, :1], u[:, :, -1:], multipath=multipath)
    left_halo = left_halo.clone()
    right_halo = right_halo.clone()
    left_halo[0] = 0       # global edge → Dirichlet zeros
    right_halo[-1] = 0
    return sweep(torch.cat([left_halo, u, right_halo], dim=2))
