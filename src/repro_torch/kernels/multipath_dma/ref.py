"""Plain numpy oracle for the multipath DMA kernel.

Semantics of one plan execution over the device-stacked buffer
``x: (num_devices, nelems)``:

* destination device ends with the source's message,
* every other device keeps its own buffer (identity — the kernel's local
  init copy),
* chunk moves are also replayed hop-by-hop (``replay_schedule``) so property
  tests can check the §4.5 invariants at every intermediate step.
"""

from __future__ import annotations

import numpy as np

from repro_torch.comm.plan import TransferPlan
from repro_torch.core.pipelining import build_schedule


def multipath_transfer_ref(x: np.ndarray, plan: TransferPlan) -> np.ndarray:
    """End-state oracle: x -> y with y[dst] = x[src], rest identity."""
    y = np.array(x, copy=True)
    y[plan.dst] = x[plan.src]
    return y


def replay_schedule(x: np.ndarray, plan: TransferPlan,
                    itemsize: int) -> np.ndarray:
    """Hop-by-hop replay through explicit staging buffers.

    Validates that executing the chunk schedule literally (each chunk moving
    through its route's staging stops) reconstructs the message — i.e. the
    schedule itself is correct, independent of the kernel.
    """
    y = np.array(x, copy=True)
    stage: dict[tuple[int, int, int], np.ndarray] = {}
    for task in build_schedule(plan):
        off = task.offset // itemsize
        size = task.nbytes // itemsize
        payload = x[plan.src, off:off + size]
        for hop_idx, (a, b) in enumerate(task.hops):
            key = (task.path_idx, task.chunk_idx, hop_idx)
            if hop_idx == 0:
                moving = payload
            else:
                moving = stage[(task.path_idx, task.chunk_idx, hop_idx - 1)]
            if hop_idx == len(task.hops) - 1:
                y[b, off:off + size] = moving
            else:
                stage[key] = moving.copy()
    return y
