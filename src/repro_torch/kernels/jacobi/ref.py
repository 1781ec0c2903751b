"""Plain numpy oracle for the Jacobi sweep."""

from __future__ import annotations

import numpy as np


def jacobi_sweep_ref(ext: np.ndarray) -> np.ndarray:
    """5-point Jacobi update of the interior of ``ext: (rows, W + 2)`` with
    Dirichlet-zero top/bottom boundaries, in ``ext``'s dtype."""
    c = ext[:, 1:-1]
    up = np.pad(c[:-1, :], ((1, 0), (0, 0)))
    down = np.pad(c[1:, :], ((0, 1), (0, 0)))
    return 0.25 * (ext[:, :-2] + ext[:, 2:] + up + down)
