"""The port's ``jacobi`` module against the reference Pallas kernel.

On the CPU the port's ``jacobi_sweep`` runs the plain version (slicing and
``F.pad``). It is held against the reference kernel in interpret mode and
both packages' oracles with the tolerances of ``tests/test_kernels.py``:
float32 atol 1e-6, bfloat16 atol 2e-2 (the reference adds in bfloat16,
rounding after every add; the CUDA kernel sums in float32 and rounds once).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.jacobi import ops as jops
from repro.kernels.jacobi import ref as jref

from repro_torch.kernels.jacobi import kernel as jk
from repro_torch.kernels.jacobi import ops
from repro_torch.kernels.jacobi import ref

TOL = {"float32": 1e-6, "bfloat16": 2e-2}


def ext_of(seed, shape, dtype):
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    if dtype == "float32":
        return x, torch.from_numpy(x.copy()), jnp.asarray(x)
    b = (x.view(np.uint32) >> 16).astype(np.uint16)
    return (b.astype(np.uint32) << 16).view(np.float32), torch.from_numpy(
        b.view(np.int16).copy()).view(torch.bfloat16), jnp.asarray(
        b).view(jnp.bfloat16)


@pytest.mark.parametrize("rows,w", [(8, 1024), (8, 700), (16, 256),
                                    (8, 128), (3, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sweep_matches_reference(rows, w, dtype):
    x32, xt, xj = ext_of(rows + w, (rows, w + 2), dtype)
    got = ops.jacobi_sweep(xt)
    assert got.shape == (rows, w) and got.dtype == xt.dtype
    got = got.float().numpy()
    kern = np.asarray(jops.jacobi_sweep(xj), np.float32)
    np.testing.assert_allclose(got, kern, atol=TOL[dtype])
    np.testing.assert_allclose(got, np.asarray(jref.jacobi_sweep_ref(xj),
                                               np.float32), atol=TOL[dtype])
    np.testing.assert_allclose(got, ref.jacobi_sweep_ref(x32),
                               atol=TOL[dtype])


def test_sweep_is_batched_over_leading_dims():
    x = torch.randn(2, 3, 8, 66)
    out = ops.jacobi_sweep(x)
    assert out.shape == (2, 3, 8, 64)
    for i in range(2):
        for j in range(3):
            assert torch.equal(out[i, j], jk.jacobi_sweep_plain(x[i, j]))


def test_cuda_wrapper_checks_its_input():
    with pytest.raises(ValueError, match="CUDA"):
        jk.jacobi_sweep_cuda(torch.zeros(8, 10))
    with pytest.raises(ValueError, match="device"):
        ops.jacobi_sweep(torch.zeros(8, 10, device="meta"))
