"""The ``jacobi`` kernel: one 5-point sweep over halo-extended blocks.

Replaces the Pallas kernel ``jacobi_sweep_kernel`` of the reference package
(``src/repro/kernels/jacobi/kernel.py``). The CUDA source is
``csrc/jacobi.cu`` (one thread per output column, rows walked in
registers), built by :mod:`repro_torch.kernels._build`.
:func:`jacobi_sweep_plain` is the plain PyTorch version of the same
function (slicing and ``F.pad``), used for CPU tensors and as the check
of the kernel on the card. :data:`LAUNCHES` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

#: Kernel launches so far.
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def jacobi_sweep_plain(ext: torch.Tensor) -> torch.Tensor:
    """``0.25 * (left + right + up + down)`` over the interior of
    ``ext: (..., rows, W + 2)``, Dirichlet zeros above the first and below
    the last row; returns ``(..., rows, W)`` in ``ext``'s dtype."""
    c = ext[..., 1:-1]
    up = F.pad(c[..., :-1, :], (0, 0, 1, 0))
    down = F.pad(c[..., 1:, :], (0, 0, 0, 1))
    return 0.25 * (ext[..., :-2] + ext[..., 2:] + up + down)


def _lib():
    lib = _build.load("jacobi")
    fn = lib.jacobi_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def jacobi_sweep_cuda(ext: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a CUDA tensor ``ext: (..., rows, W + 2)``
    (float32 or bfloat16); returns a new ``(..., rows, W)`` tensor."""
    global LAUNCHES
    if ext.device.type != "cuda":
        raise ValueError(f"jacobi kernel needs a CUDA tensor, got "
                         f"{ext.device}")
    if ext.dtype not in _DTYPE_CODES:
        raise ValueError(f"jacobi kernel takes float32 or bfloat16, got "
                         f"{ext.dtype}")
    if ext.dim() < 2 or ext.shape[-1] < 3:
        raise ValueError(f"ext must be (..., rows, W + 2) with W >= 1, got "
                         f"{tuple(ext.shape)}")
    ext = ext.contiguous()
    *lead, rows, wp2 = ext.shape
    w = wp2 - 2
    batch = 1
    for d in lead:
        batch *= d
    out = torch.empty((*lead, rows, w), dtype=ext.dtype, device=ext.device)
    with torch.cuda.device(ext.device):     # the stream's own card
        rc = _lib()(ext.data_ptr(), out.data_ptr(), batch, rows, w,
                    _DTYPE_CODES[ext.dtype],
                    torch.cuda.current_stream(ext.device).cuda_stream)
    _build.check(rc, "jacobi")
    LAUNCHES += 1
    return out
