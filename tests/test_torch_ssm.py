"""The port's SSM mixers against the reference's ``models/ssm.py``.

RWKV-6: the reference draws the weights (``rwkv6_init``) at a reduced
width (d 64, heads of 16); ``params_from_numpy`` carries them into the
port, so both sides compute with the same numbers. ``rwkv6_apply``
(output, final state and shift state) and ``rwkv6_decode`` agree within
atol 1e-4 in float32: the same arithmetic summed in another order. On the
CPU the scan is the kernel's plain version, in the port's chunks of 64
against the reference's 128 (the chunked form is exact for any chunk):
the lengths 130 and 200 span several chunks of each.

Mamba (Hymba's SSM heads): the reference's ``mamba_init`` weights at d 64,
state 8, carried the same way. ``mamba_apply`` (output, final SSM state
and conv inputs) at odd and even lengths, shorter than the conv's width
and long enough for several levels of the associative scan, and
``mamba_decode`` (output and both new states) agree within atol 1e-4 in
float32; the scan agrees with the sequential recurrence, and a prefill's
states continue in decode steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ssm as jssm

from repro_torch.carry import params_from_numpy
from repro_torch.models import ssm

D, HD = 64, 16
N_STATE = 8
ATOL = 1e-4


@pytest.fixture(scope="module")
def params():
    """(reference params, port params) of one time-mix."""
    jp = jssm.rwkv6_init(jax.random.key(0), D, HD, jnp.float32)
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


def x_of(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("length", [1, 12, 128, 130])
def test_apply_matches_reference(params, length):
    jp, p = params
    x = x_of(length, 2, length, D)
    want = jssm.rwkv6_apply(jnp.asarray(x), jp, head_dim=HD)
    got = ssm.rwkv6_apply(torch.from_numpy(x), p, head_dim=HD)
    assert got.shape == (2, length, D)
    close(got, want)


@pytest.mark.parametrize("length", [12, 130, 200])
def test_apply_returns_the_reference_state(params, length):
    jp, p = params
    x = x_of(length + 1, 2, length, D)
    want, (jst, jsh) = jssm.rwkv6_apply(jnp.asarray(x), jp, head_dim=HD,
                                        return_state=True)
    got, (st, sh) = ssm.rwkv6_apply(torch.from_numpy(x), p, head_dim=HD,
                                    return_state=True)
    close(got, want)
    assert st.shape == (2, D // HD, HD, HD) and st.dtype == torch.float32
    close(st, jst)
    assert torch.equal(sh, torch.from_numpy(x[:, -1]))
    np.testing.assert_array_equal(sh.numpy(), np.asarray(jsh))


def test_decode_matches_reference(params):
    jp, p = params
    x = x_of(8, 3, D)
    state = x_of(9, 3, D // HD, HD, HD) * 0.1
    shift = x_of(10, 3, D)
    want, jst, jsh = jssm.rwkv6_decode(jnp.asarray(x), jp,
                                       jnp.asarray(state),
                                       jnp.asarray(shift), head_dim=HD)
    got, st, sh = ssm.rwkv6_decode(torch.from_numpy(x), p,
                                   torch.from_numpy(state),
                                   torch.from_numpy(shift), head_dim=HD)
    close(got, want)
    close(st, jst)
    np.testing.assert_array_equal(sh.numpy(), np.asarray(jsh))


def test_prefill_state_continues_in_decode(params):
    """A prefill of the first positions, then one decode step per later
    position, gives the full-sequence outputs."""
    _, p = params
    x = torch.from_numpy(x_of(11, 2, 20, D))
    full = ssm.rwkv6_apply(x, p, head_dim=HD)
    _, (state, shift) = ssm.rwkv6_apply(x[:, :14], p, head_dim=HD,
                                        return_state=True)
    for t in range(14, 20):
        out, state, shift = ssm.rwkv6_decode(x[:, t], p, state, shift,
                                             head_dim=HD)
        torch.testing.assert_close(out, full[:, t], atol=ATOL, rtol=0)


def test_init_shapes_dtypes_and_scales():
    p = ssm.rwkv6_init(256, 64, torch.bfloat16,
                       generator=torch.Generator().manual_seed(0),
                       lead=(2,))
    ref = jax.eval_shape(lambda k: jssm.rwkv6_init(k, 256, 64, jnp.bfloat16),
                         jax.random.key(0))
    assert sorted(p) == sorted(ref)
    for name, leaf in ref.items():
        assert tuple(p[name].shape) == (2,) + leaf.shape, name
        assert str(p[name].dtype).removeprefix("torch.") == \
            str(leaf.dtype), name
    assert float(p["mu"].min()) >= 0.0 and float(p["mu"].max()) < 1.0
    assert float(p["ln_x"].abs().max()) == 0.0
    assert abs(p["w_r"].float().std().item() - 256 ** -0.5) < 0.005
    assert abs(p["w_w"].float().std().item() - 0.1 * 256 ** -0.5) < 0.0005
    assert abs(p["u"].std().item() - 0.3) < 0.05


# -- Mamba ---------------------------------------------------------------


@pytest.fixture(scope="module")
def mamba():
    """(reference params, port params) of one Mamba mixer; ``conv_b`` is
    drawn nonzero so that the bias is exercised."""
    jp = jssm.mamba_init(jax.random.key(1), D, N_STATE, jnp.float32)
    jp["conv_b"] = jax.random.normal(jax.random.key(2), (D,)) * 0.1
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("length", [1, 2, 3, 12, 33, 64, 101])
def test_mamba_apply_matches_reference(mamba, length):
    jp, p = mamba
    x = x_of(length + 20, 2, length, D)
    want = jssm.mamba_apply(jnp.asarray(x), jp)
    got = ssm.mamba_apply(torch.from_numpy(x), p)
    assert got.shape == (2, length, D)
    close(got, want)


@pytest.mark.parametrize("length", [2, 7, 12, 40])
def test_mamba_apply_returns_the_reference_states(mamba, length):
    jp, p = mamba
    x = x_of(length + 30, 3, length, D)
    want, (jst, jconv) = jssm.mamba_apply(jnp.asarray(x), jp,
                                          return_state=True)
    got, (st, conv) = ssm.mamba_apply(torch.from_numpy(x), p,
                                      return_state=True)
    close(got, want)
    assert st.shape == (3, D, N_STATE) and st.dtype == torch.float32
    assert conv.shape == (3, ssm.CONV_K - 1, D)
    close(st, jst)
    close(conv, jconv)


def test_mamba_decode_matches_reference(mamba):
    jp, p = mamba
    x = x_of(40, 3, D)
    state = x_of(41, 3, D, N_STATE) * 0.1
    conv = x_of(42, 3, ssm.CONV_K - 1, D)
    want, jst, jconv = jssm.mamba_decode(jnp.asarray(x), jp,
                                         jnp.asarray(state),
                                         jnp.asarray(conv))
    st_in, conv_in = torch.from_numpy(state), torch.from_numpy(conv)
    got, st, new_conv = ssm.mamba_decode(torch.from_numpy(x), p, st_in,
                                         conv_in)
    close(got, want)
    close(st, jst)
    close(new_conv, jconv)
    # the inputs are left as they were: a caller copies the new states in
    assert torch.equal(st_in, torch.from_numpy(state))
    assert torch.equal(conv_in, torch.from_numpy(conv))


@pytest.mark.parametrize("length", [1, 2, 5, 8, 13, 31])
def test_associative_scan_is_the_recurrence(length):
    rng = np.random.RandomState(length)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, length, 3, 4))
                         .astype(np.float32))
    b = torch.from_numpy(rng.randn(2, length, 3, 4).astype(np.float32))
    ha, hb = ssm.associative_scan(a, b, need_a=True)
    h, prod = torch.zeros(2, 3, 4), torch.ones(2, 3, 4)
    for t in range(length):
        h = a[:, t] * h + b[:, t]
        prod = prod * a[:, t]
        torch.testing.assert_close(hb[:, t], h, atol=1e-5, rtol=1e-5)
        torch.testing.assert_close(ha[:, t], prod, atol=1e-6, rtol=1e-5)
    assert torch.equal(ssm.associative_scan(a, b), hb)


def test_mamba_prefill_state_continues_in_decode(mamba):
    """A prefill of the first positions, then one decode step per later
    position, gives the full-sequence outputs."""
    _, p = mamba
    x = torch.from_numpy(x_of(50, 2, 20, D))
    full = ssm.mamba_apply(x, p)
    _, (state, conv) = ssm.mamba_apply(x[:, :13], p, return_state=True)
    for t in range(13, 20):
        out, state, conv = ssm.mamba_decode(x[:, t], p, state, conv)
        torch.testing.assert_close(out, full[:, t], atol=ATOL, rtol=0)


def test_mamba_init_shapes_dtypes_and_scales():
    p = ssm.mamba_init(128, 16, torch.bfloat16,
                       generator=torch.Generator().manual_seed(0),
                       lead=(2,))
    ref = jax.eval_shape(lambda k: jssm.mamba_init(k, 128, 16, jnp.bfloat16),
                         jax.random.key(0))
    assert sorted(p) == sorted(ref)
    for name, leaf in ref.items():
        assert tuple(p[name].shape) == (2,) + leaf.shape, name
        assert str(p[name].dtype).removeprefix("torch.") == \
            str(leaf.dtype), name
    assert float(p["dt_bias"].max()) == float(p["dt_bias"].min()) == -1.0
    assert float(p["A_log"].abs().max()) == 0.0
    assert float(p["D"].min()) == 1.0
    assert float(p["conv_b"].float().abs().max()) == 0.0
    assert abs(p["conv_w"].float().std().item() - 0.3) < 0.03
    assert abs(p["w_dt2"].float().std().item() - 8 ** -0.5) < 0.03
