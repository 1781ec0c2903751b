"""Wrapper of the Jacobi sweep: the kernel on the card, the plain version
on the CPU."""

from __future__ import annotations

import torch

from repro_torch.kernels.jacobi.kernel import (jacobi_sweep_cuda,
                                               jacobi_sweep_plain)


def jacobi_sweep(ext: torch.Tensor) -> torch.Tensor:
    """One 5-point Jacobi sweep of ``ext: (..., rows, W + 2)`` →
    ``(..., rows, W)``. A CUDA tensor goes through the hand-written kernel
    (or raises); a CPU tensor through the plain version."""
    if ext.device.type == "cuda":
        return jacobi_sweep_cuda(ext)
    if ext.device.type == "cpu":
        return jacobi_sweep_plain(ext)
    raise ValueError(f"unsupported device {ext.device}")
