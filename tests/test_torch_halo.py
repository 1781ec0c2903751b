"""The port's Jacobi application against the reference.

The reference runs ``jacobi_step(..., use_kernel=True)`` under
``shard_map`` on 4 CPU devices (the Pallas sweep in interpret mode); the
port runs ``jacobi_step`` on the device-stacked domain, with halos from
``halo_exchange_group`` through its session or from row shifts, and the
plain sweep on the CPU. Tolerances: float32 atol 1e-6 (the same adds in
the same order; only the reference's interpret-mode kernel may fuse
differently), bfloat16 atol 2e-2 (the reference rounds after every add).
The halo exchange itself moves bits and must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.comm import CommSession as JCommSession
from repro.compat import shard_map
from repro.core import halo as jhalo

from repro_torch.comm import CommSession
from repro_torch.core import halo

TOL = {"float32": 1e-6, "bfloat16": 2e-2}


@pytest.fixture(scope="module")
def jmesh4():
    return jax.sharding.Mesh(np.array(jax.devices()[:4]), ("dev",))


def domain(seed, dtype, n=4, rows=8, cols=24):
    x = np.random.RandomState(seed).randn(n, rows, cols).astype(np.float32)
    if dtype == "float32":
        return torch.from_numpy(x.copy()), jnp.asarray(x)
    b = (x.view(np.uint32) >> 16).astype(np.uint16)
    return (torch.from_numpy(b.view(np.int16).copy()).view(torch.bfloat16),
            jnp.asarray(b).view(jnp.bfloat16))


def ref_steps(mesh, u, iters, multipath):
    step = jax.jit(shard_map(
        lambda ul: jhalo.jacobi_step(ul[0], "dev", multipath=multipath,
                                     use_kernel=True)[None],
        mesh=mesh, in_specs=P("dev"), out_specs=P("dev"), check_vma=False))
    for _ in range(iters):
        u = step(u)
    return np.asarray(u, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_group_exchange_step_matches_reference(jmesh4, dtype):
    ut, uj = domain(0, dtype)
    want = ref_steps(jmesh4, uj, 3, multipath=False)
    sess = CommSession(device="cpu")
    got = ut
    for _ in range(3):
        got = halo.jacobi_step(got, session=sess)
    assert got.shape == ut.shape and got.dtype == ut.dtype
    np.testing.assert_allclose(got.float().numpy(), want, atol=TOL[dtype])
    assert sess.stats()["dispatches"] == 3    # one fused exchange per step


@pytest.mark.parametrize("multipath", [False, True])
def test_ring_shift_step_matches_reference(jmesh4, multipath):
    ut, uj = domain(1, "float32", cols=31)
    want = ref_steps(jmesh4, uj, 2, multipath=multipath)
    got = ut
    for _ in range(2):
        got = halo.jacobi_step(got, multipath=multipath, use_kernel=False)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL["float32"])


def test_halo_exchange_group_equals_reference(jmesh4):
    ut, uj = domain(2, "float32", rows=5, cols=9)
    jl, jr = jhalo.halo_exchange_group(JCommSession(mesh=jmesh4), uj)
    pl, pr = halo.halo_exchange_group(CommSession(device="cpu"), ut)
    np.testing.assert_array_equal(pl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(pr.numpy(), np.asarray(jr))
    # the ring-shift exchange moves the same bits
    rl, rr = halo.halo_exchange_ring(ut[:, :, :1], ut[:, :, -1:],
                                     multipath=True)
    assert torch.equal(rl, pl) and torch.equal(rr, pr)


def test_single_rank_has_no_exchange():
    u = torch.randn(1, 4, 6)
    sess = CommSession(device="cpu")
    lh, rh = halo.halo_exchange_group(sess, u)
    assert torch.equal(lh, u[:, :, -1:]) and torch.equal(rh, u[:, :, :1])
    out = halo.jacobi_step(u, session=sess)
    assert out.shape == u.shape and sess.stats()["dispatches"] == 0
