"""The port's int8 gradient compression against the reference's.

The reference functions run under ``shard_map`` on the 8-device CPU mesh,
one member's leaf per device; the port's take the same leaves stacked
``(8, ...)`` and an 8-device CPU session. The int8 payloads and scales
must be EQUAL; the means equal within 1e-6 relative (the same float32
quantities, summed through each package's ring). The reference's own
checks — the error bound of 0.02 and error feedback's smaller
accumulated bias — are held on the port. The error-feedback residual, a
cancellation, agrees within 1e-6 of the quantized target.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.compat import shard_map
from repro.optim import compression as jcomp

from repro_torch.comm import CommSession
from repro_torch.core.topology import Topology
from repro_torch.optim import compression as comp

N = 8
SHAPES = [(256,), (3, 5), (7, 64), (1,), (2, 3, 4)]


@pytest.fixture(scope="module")
def sess():
    return CommSession(device="cpu", topology=Topology.full_mesh(N))


def grads(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).randn(N, *shape) * scale
            ).astype(np.float32)


def _shard(fn, mesh, n_in, n_out):
    spec = P("dev")
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=(spec,) * n_in,
                             out_specs=spec if n_out == 1 else (spec,) * n_out,
                             check_vma=False))


def close(got, want, rel=1e-6):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * (np.abs(want).max() + 1e-30))


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_payload_and_scale_equal_reference(shape):
    g = grads(0, shape)
    q, scale = comp._quantize(torch.from_numpy(g))
    for i in range(N):
        jq, js = jcomp._quantize(jnp.asarray(g[i]))
        assert q.dtype == torch.int8 and scale.dtype == torch.float32
        np.testing.assert_array_equal(q[i].numpy(), np.asarray(jq))
        assert scale[i].item() == float(js)


def test_quantize_rounds_half_to_even():
    # a row max of 127 makes the scale 1.0 in float32 (the 1e-12 is lost),
    # so the quotients are the halves themselves
    g = np.array([[127.0, 0.5, 1.5, 2.5, -0.5, -2.5]] * N, np.float32)
    q, scale = comp._quantize(torch.from_numpy(g))
    jq, js = jcomp._quantize(jnp.asarray(g[0]))
    assert scale[0].item() == float(js) == 1.0
    assert q[0].tolist() == np.asarray(jq).tolist() == [127, 0, 2, 2, 0, -2]


@pytest.mark.parametrize("shape", SHAPES)
def test_compressed_psum_equals_reference(dev_mesh, sess, shape):
    g = grads(1, shape)
    want = _shard(lambda v: jcomp.compressed_psum(v[0], "dev")[None],
                  dev_mesh, 1, 1)(g.reshape(N, *shape))
    got = comp.compressed_psum(torch.from_numpy(g), sess)
    assert got.dtype == torch.float32 and got.shape == (N,) + shape
    close(got.numpy(), np.asarray(want))
    for i in range(1, N):
        assert torch.equal(got[i], got[0])


def test_compressed_psum_tree_equals_reference(dev_mesh, sess):
    tree = {"w": grads(2, (4, 6)), "b": {"x": grads(3, (5,)),
                                         "y": grads(4, (2, 2, 3))}}

    def body(w, x, y):
        out = jcomp.compressed_psum_tree(
            {"w": w[0], "b": {"x": x[0], "y": y[0]}}, "dev")
        return out["w"][None], out["b"]["x"][None], out["b"]["y"][None]

    jw, jx, jy = _shard(body, dev_mesh, 3, 3)(tree["w"], tree["b"]["x"],
                                             tree["b"]["y"])
    got = comp.compressed_psum_tree(
        {"w": torch.from_numpy(tree["w"]),
         "b": {"x": torch.from_numpy(tree["b"]["x"]),
               "y": torch.from_numpy(tree["b"]["y"])}}, sess)
    close(got["w"].numpy(), np.asarray(jw))
    close(got["b"]["x"].numpy(), np.asarray(jx))
    close(got["b"]["y"].numpy(), np.asarray(jy))


@pytest.mark.parametrize("shape", [(128,), (6, 10)])
def test_compressed_psum_with_feedback_equals_reference(dev_mesh, sess,
                                                        shape):
    g = grads(5, shape, 0.1)
    res = grads(6, shape, 1e-3)

    def body(v, r):
        out, nr = jcomp.compressed_psum_with_feedback(v[0], r[0], "dev")
        return out[None], nr[None]

    jout, jres = _shard(body, dev_mesh, 2, 2)(g, res)
    out, new_res = comp.compressed_psum_with_feedback(
        torch.from_numpy(g), torch.from_numpy(res), sess)
    close(out.numpy(), np.asarray(jout))
    # The residual is a cancellation, target - q·scale. The reference's
    # compiled function rounds it once (a fused multiply-add); the port
    # rounds the product first. So the reference's residual is exactly
    # the once-rounded form, and the port's within 1e-6 of the target.
    target = torch.from_numpy(g) + torch.from_numpy(res)
    q, scale = comp._quantize(target)
    fused = (target.double() - q.double()
             * scale.double().reshape((N,) + (1,) * len(shape))).float()
    np.testing.assert_array_equal(fused.numpy(), np.asarray(jres))
    np.testing.assert_allclose(new_res.numpy(), np.asarray(jres), rtol=0,
                               atol=1e-6 * target.abs().max().item())


def test_bfloat16_leaf_is_quantized_in_float32(dev_mesh, sess):
    g = grads(7, (64,))
    gb = torch.from_numpy(g).to(torch.bfloat16)
    want = _shard(lambda v: jcomp.compressed_psum(v[0], "dev")[None],
                  dev_mesh, 1, 1)(jnp.asarray(gb.float().numpy(),
                                              jnp.bfloat16))
    got = comp.compressed_psum(gb, sess)
    assert got.dtype == torch.float32
    close(got.numpy(), np.asarray(want))


def test_compressed_psum_error_bound(sess):
    """The reference's bound (``tests/test_optim.py``): int8 error below
    0.02 of the mean's largest magnitude."""
    x = torch.from_numpy(np.random.RandomState(1).randn(N, 256)
                         .astype(np.float32))
    got = comp.compressed_psum(x, sess)
    ref = x.mean(dim=0)
    rel = (got[0] - ref).abs().max() / (ref.abs().max() + 1e-9)
    assert rel < 0.02


def test_error_feedback_reduces_bias(sess):
    """Residual carrying keeps the multi-step mean error near zero (the
    reference's check, 30 steps at (8, 128))."""
    rng = np.random.RandomState(2)
    steps = 30
    g = torch.from_numpy(rng.randn(N, 128).astype(np.float32)) * 0.1

    def run(with_feedback):
        res = torch.zeros(N, 128)
        acc = torch.zeros(128)
        for _ in range(steps):
            if with_feedback:
                out, res = comp.compressed_psum_with_feedback(g, res, sess)
            else:
                out = comp.compressed_psum(g, sess)
            acc = acc + out[0]
        return acc / steps

    exact = g.mean(dim=0)
    err_fb = (run(True) - exact).abs().mean()
    err_nofb = (run(False) - exact).abs().mean()
    assert err_fb < err_nofb


def test_compression_exports():
    from repro_torch import optim
    assert optim.compressed_psum is comp.compressed_psum
    assert optim.compressed_psum_tree is comp.compressed_psum_tree
    assert (optim.compressed_psum_with_feedback
            is comp.compressed_psum_with_feedback)
