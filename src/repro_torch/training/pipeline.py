"""Pipeline parallelism with multi-path stage-boundary transfers.

The stage-to-stage activation send in pipeline parallelism is exactly the
point-to-point transfer the paper accelerates: each microbatch handoff is a
large contiguous buffer moving between neighbouring stages while the
diagonal links idle. :func:`pipeline_apply` runs a GPipe schedule on the
device-stacked state — stage *i* is row *i* of every ``(P, ...)`` tensor,
as in :mod:`repro_torch.core.halo` — and every handoff is one
:func:`send_next_stage`:

* without a session it is the reference package's ``ppermute`` shifts as
  ``torch.roll`` over the stage dim: direct, or with ``multipath=True``
  the first half of the last dim over the direct ring link and the second
  half staged through the next-next stage (the Fig. 2(b) pattern, halves
  hard-coded as in the reference);
* with a session it is ONE ``session.exchange`` of the P messages
  ``h[i]: i → (i+1) % P`` — one dispatch and one ``multipath_dma`` replay
  a tick — and the split is the one the planner takes (``max_paths=1``
  for the direct send). Either way the delivered tensor is the same, bit
  for bit.

On a peer session (``CommSession(devices=[...])``) stage *s* lives on
``devices[s]`` (:func:`place_stages`) and the activations are a list of
one tensor a stage on its device: each tick's P stage calls are launched
one a card before the handoff, so the stages of a tick run concurrently;
the handoff is the same one exchange of the P messages, each landing in
the next stage's memory; the last stage's outputs come back by
``session.collectives.psum`` of the masked per-device list. The result is
the stacked session's bit for bit.

The schedule runs ``M + P − 1`` ticks (fill + drain); activations for
microbatch *m* exit stage *P−1* at tick ``m + P − 1``. Every stage runs
every tick, bubbles included, as the reference does.
:func:`block_stages` and :func:`make_block_stage_fn` pipeline a model's
block stack: each stage applies ``block_apply`` over its ``L/P`` layers.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Callable

import torch

from repro_torch.comm.session import on_device
from repro_torch.models.transformer import (block_apply, layer_params,
                                            layer_windows)
from repro_torch.tree import leaves, tree_map

if TYPE_CHECKING:  # pragma: no cover - typing only
    from repro_torch.comm.session import CommSession


def send_next_stage(h, num_stages: int, *, multipath: bool = False,
                    session: "CommSession | None" = None):
    """Move activations one stage forward (the stage boundary P2P): row
    ``(i+1) % P`` of the result holds row ``i`` of ``h: (P, ...)``.

    Fewer than 3 stages always send direct (no stage to stage through).
    With ``session`` the move is one exchange of the P rows, planned
    jointly; ``multipath`` leaves the path count to the session's
    planner, else it is 1. On a peer session ``h`` is a list of the P
    stages' activations, ``h[i]`` on ``devices[i]``, and so is the
    result, each stage's handoff in the next stage's memory.
    """
    p = num_stages
    if len(h) != p:
        raise ValueError(f"h must be stacked over {p} stages, got {len(h)}")
    striped = multipath and p >= 3
    if session is not None:
        received = session.exchange(
            [(h[i], i, (i + 1) % p) for i in range(p)],
            max_paths=None if striped else 1)
        shifted = [received[(j - 1) % p] for j in range(p)]
        return shifted if isinstance(h, list) else torch.stack(shifted)
    if not striped:
        return torch.roll(h, 1, dims=0)
    half = h.shape[-1] // 2
    direct = torch.roll(h[..., :half], 1, dims=0)
    staged = torch.roll(h[..., half:], 2, dims=0)        # hop-1: skip
    staged = torch.roll(staged, -1, dims=0)              # hop-2: back
    return torch.cat([direct, staged], dim=-1)


def place_stages(stage_params, comm: "CommSession") -> list:
    """The stage-stacked ``stage_params`` (every leaf ``(P, ...)``) as a
    list of the P stages' trees, stage *s* a copy on ``devices[s]`` of
    the peer session ``comm``."""
    p = leaves(stage_params)[0].shape[0]
    if p != comm.num_devices:
        raise ValueError(f"{p} stages for a session of {comm.num_devices} "
                         f"devices")
    return [tree_map(lambda t, s=s: t[s].to(dev, copy=True), stage_params)
            for s, dev in enumerate(comm.devices)]


def _pipeline_surfaced(stage_fn: Callable, stage_params, x: torch.Tensor,
                       *, microbatches: int, multipath: bool = False,
                       session: "CommSession | None" = None):
    """:func:`pipeline_apply` before the last step: the surfaced outputs,
    every stage holding the last stage's. The stacked ``(P, M, mb, ...)``
    without a session or on a stacked one; on a peer session a list, the
    copy of stage *s* on ``devices[s]``.

    One tick loop over the list of the P stages' parameters: each tick
    launches the P stage calls, each under its stage's device, and hands
    the outputs on in one :func:`send_next_stage`, stacked first unless
    the session is a peer one."""
    peer = session is not None and session.devices is not None
    if not peer:
        p = leaves(stage_params)[0].shape[0]
        stages = [tree_map(lambda t, i=i: t[i], stage_params)
                  for i in range(p)]
        devices = [x.device] * p
    else:
        stages = (stage_params if isinstance(stage_params, list)
                  else place_stages(stage_params, session))
        devices = session.devices
        p = len(devices)
        if len(stages) != p:
            raise ValueError(f"{len(stages)} stages for a session of {p} "
                             f"devices")
    m = microbatches
    if x.shape[0] != m:
        raise ValueError(f"x must hold {m} microbatches, got "
                         f"{tuple(x.shape)}")
    mb_shape = tuple(x.shape[1:])
    h = [torch.zeros(mb_shape, dtype=x.dtype, device=d) for d in devices]
    outs = torch.zeros((m,) + mb_shape, dtype=x.dtype, device=devices[-1])
    for t in range(m + p - 1):
        # stage 0 ingests microbatch t during the fill phase, zeros after
        h[0] = x[t].to(devices[0]) if t < m else torch.zeros_like(h[0])
        h_out = []
        for dev, params, h_i in zip(devices, stages, h):
            with on_device(dev):
                h_out.append(stage_fn(params, h_i))
        mb_idx = t - (p - 1)      # microbatch leaving the last stage
        if 0 <= mb_idx < m:
            outs[mb_idx] = h_out[p - 1]
        h = list(send_next_stage(h_out if peer else torch.stack(h_out), p,
                                 multipath=multipath, session=session))
    # surface the last stage's outputs on every stage: a masked psum
    masked = [outs if s == p - 1 else torch.zeros_like(outs, device=dev)
              for s, dev in enumerate(devices)]
    if peer:
        return session.collectives.psum(masked)
    masked = torch.stack(masked)
    if session is not None:
        return session.collectives.psum(masked)
    return masked.sum(dim=0, keepdim=True).expand_as(masked).contiguous()


def pipeline_apply(stage_fn: Callable, stage_params, x: torch.Tensor, *,
                   microbatches: int, multipath: bool = False,
                   session: "CommSession | None" = None) -> torch.Tensor:
    """GPipe forward over ``P`` stacked stages.

    ``stage_params``: tree with a leading stage dim P; ``stage_fn(params_i,
    h_i)`` maps one stage's params and one microbatch ``(mb, ...)`` to
    its output of the same shape. ``x``: ``(M, mb, ...)`` inputs. Returns
    ``(M, mb, ...)``, the last stage's outputs, surfaced on every stage
    by a masked psum (the session's ring psum with a session).

    On a peer session ``stage_params`` may also be the list of
    :func:`place_stages` (a stacked tree is placed first), and the
    result is the copy surfaced on ``devices[0]``.
    """
    return _pipeline_surfaced(stage_fn, stage_params, x,
                              microbatches=microbatches, multipath=multipath,
                              session=session)[0]


def block_stages(params, num_stages: int):
    """The model's layer-stacked ``params["layers"]`` as ``num_stages``
    stages: every leaf ``(L, ...)`` viewed as ``(P, L/P, ...)``."""
    def split(t):
        if t.shape[0] % num_stages:
            raise ValueError(f"{t.shape[0]} layers do not split into "
                             f"{num_stages} stages")
        return t.reshape((num_stages, t.shape[0] // num_stages)
                         + tuple(t.shape[1:]))
    return tree_map(split, params["layers"])


def make_block_stage_fn(cfg, num_stages: int,
                        positions: torch.Tensor) -> Callable:
    """The stage function of a block stack split by :func:`block_stages`:
    ``block_apply`` over the stage's ``L/P`` layers in order, with the
    microbatch's ``positions`` closed over (each layer's auxiliary loss is
    dropped; on a peer session each stage's device gets its own copy of
    them). Every stage must see the same attention windows."""
    windows = layer_windows(cfg)
    per = len(windows) // num_stages
    if per * num_stages != len(windows) or any(
            windows[i * per:(i + 1) * per] != windows[:per]
            for i in range(num_stages)):
        raise ValueError(f"layer windows {windows} do not repeat over "
                         f"{num_stages} stages")

    positions_on = {positions.device: positions}

    def stage_fn(stage_layers, h: torch.Tensor) -> torch.Tensor:
        pos = positions_on.get(h.device)
        if pos is None:
            pos = positions_on[h.device] = positions.to(h.device)
        for j in range(per):
            h, _ = block_apply(h, layer_params({"layers": stage_layers}, j),
                               cfg, windows[j], pos)
        return h
    return stage_fn
