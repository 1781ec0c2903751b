"""Plain numpy oracle for the ring all-gather: the tiled gather."""

from __future__ import annotations

import numpy as np


def ring_allgather_ref(xs: np.ndarray) -> np.ndarray:
    """``xs: (n, rows, f)`` stacked shards → ``(n, n, rows, f)``: every
    device's replica holds all ``n`` shards in device order."""
    n = xs.shape[0]
    return np.broadcast_to(xs[None], (n,) + xs.shape).copy()
