"""Plain PyTorch versions of the two conv kernels (spsg_tpu_torch/ops/conv3x3.py)
held against the JAX package's Pallas kernels (interpret mode on the CPU) and
against lax.conv_general_dilated, on identical numpy inputs.

On the CPU the wrappers take the plain versions, so these tests also cover
the wrappers' argument checks. The CUDA kernels themselves are compared with
the plain versions on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.ops import pallas_conv as pc
from spsg_tpu_torch.ops import conv3x3 as tc

# one intra-op thread: the suite runs several workers side by side, and the JAX
# package's multi-device CPU tests abort when their collectives are starved
torch.set_num_threads(1)

# (B, Z, Y, X, Cin, Cout): the Pallas tests' shape, a ragged one, a Cout=1 head
SHAPES = [(2, 4, 8, 8, 5, 6), (1, 4, 6, 10, 7, 3), (1, 4, 8, 8, 10, 1)]


def _data(shape, seed=0):
    B, Z, Y, X, Ci, Co = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, Z, Y, X, Ci)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, Ci, Co)) * 0.2).astype(np.float32)
    b = (rng.standard_normal((Co,)) * 0.1).astype(np.float32)
    return x, w, b


def _lax_conv(x, w):
    return jax.lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w), (1, 1, 1), [(1, 1)] * 3,
        dimension_numbers=("NDHWC", "DHWIO", "NDHWC"),
        precision=jax.lax.Precision.HIGHEST,
    )


@pytest.mark.parametrize("shape", SHAPES)
def test_conv3x3_plain_matches_pallas_and_lax(shape):
    x, w, _ = _data(shape)
    got = tc.conv3x3(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert got.shape == shape[:4] + (shape[5],) and got.dtype == np.float32
    # y: atol 2e-5 (the tolerance the Pallas kernel is held to against lax)
    np.testing.assert_allclose(got, np.asarray(pc.conv3x3(jnp.asarray(x), jnp.asarray(w))), atol=2e-5)
    np.testing.assert_allclose(got, np.asarray(_lax_conv(x, w)), atol=2e-5)


@pytest.mark.parametrize("shape", SHAPES)
def test_conv3x3_act_stats_plain_matches_pallas_and_lax(shape):
    x, w, b = _data(shape, seed=1)
    y, s, ss = (t.numpy() for t in tc.conv3x3_act_stats(
        torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b)))
    py, ps, pss = (np.asarray(a) for a in pc.conv3x3_act_stats(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    np.testing.assert_allclose(y, py, atol=2e-5)
    # float32 sums over a few hundred to a thousand voxels, other order
    np.testing.assert_allclose(s, ps, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ss, pss, rtol=1e-4)
    ref = np.asarray(_lax_conv(x, w)) + b
    ref = np.where(ref > 0, ref, 0.2 * ref)
    np.testing.assert_allclose(y, ref, atol=2e-5)
    np.testing.assert_allclose(s, ref.sum((0, 1, 2, 3)), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ss, (ref * ref).sum((0, 1, 2, 3)), rtol=1e-4)


def test_bfloat16_storage_float32_accumulation():
    """bf16 in, f32 accumulate, bf16 out; the statistics are those of the
    STORED values, as in the Pallas kernel."""
    x, w, b = _data(SHAPES[0], seed=2)
    xb, wb = (torch.from_numpy(a).to(torch.bfloat16) for a in (x, w))
    y, s, ss = tc.conv3x3_act_stats(xb, wb, torch.from_numpy(b))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    py, ps, pss = pc.conv3x3_act_stats(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w).astype(jnp.bfloat16), jnp.asarray(b))
    # one bf16 rounding step of values up to ~4 (2**-7 * 4), where the two
    # float32 accumulation orders straddle a rounding boundary
    np.testing.assert_allclose(y.float().numpy(), np.asarray(py.astype(jnp.float32)), atol=3.2e-2)
    np.testing.assert_allclose(s.numpy(), np.asarray(ps), rtol=1e-2, atol=0.5)
    np.testing.assert_allclose(ss.numpy(), np.asarray(pss), rtol=1e-2)
    yf = y.float()
    torch.testing.assert_close(s, yf.sum((0, 1, 2, 3)))
    torch.testing.assert_close(ss, (yf * yf).sum((0, 1, 2, 3)))
    assert tc.conv3x3(xb, wb).dtype == torch.bfloat16


def test_plain_versions_are_differentiable():
    """The CPU path trains: gradients of the plain versions equal those of
    the Pallas kernels' custom VJPs."""
    x, w, b = _data(SHAPES[0], seed=3)

    def jloss(x, w, b):
        y, s, ss = pc.conv3x3_act_stats(x, w, b)
        return jnp.sum(jnp.sin(y)) + jnp.sum(s * 0.3) + jnp.sum(jnp.sqrt(ss + 1.0))

    jg = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    y, s, ss = tc.conv3x3_act_stats(tx, tw, tb)
    (torch.sin(y).sum() + (s * 0.3).sum() + torch.sqrt(ss + 1.0).sum()).backward()
    for got, ref, n in zip((tx, tw, tb), jg, "xwb"):
        # the weight gradient sums 512 voxels to values of a few hundred:
        # float32 rounding, other order
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-4,
                                   err_msg=n)


@pytest.mark.parametrize("case", ["rank", "taps", "cin", "dtype", "mixed", "bias"])
def test_wrappers_reject_what_the_kernels_do_not_take(case):
    x = torch.zeros(1, 2, 4, 4, 3)
    w = torch.zeros(3, 3, 3, 3, 2)
    b = torch.zeros(2)
    if case == "rank":
        with pytest.raises(ValueError):
            tc.conv3x3(x[0], w)
    elif case == "taps":
        with pytest.raises(ValueError):
            tc.conv3x3(x, torch.zeros(5, 5, 5, 3, 2))
    elif case == "cin":
        with pytest.raises(ValueError):
            tc.conv3x3(x, torch.zeros(3, 3, 3, 4, 2))
    elif case == "dtype":
        with pytest.raises(TypeError):
            tc.conv3x3(x.double(), w.double())
    elif case == "mixed":
        with pytest.raises(TypeError):
            tc.conv3x3(x, w.to(torch.bfloat16))
    else:
        with pytest.raises(ValueError):
            tc.conv3x3_act_stats(x, w, torch.zeros(3))
    assert tc.conv3x3_act_stats(x, w, b)[0].shape == (1, 2, 4, 4, 2)


def test_cpu_calls_launch_no_kernel():
    """The launch counters count kernel launches and nothing else."""
    tc.reset_launch_counts()
    x, w, b = (torch.from_numpy(a) for a in _data(SHAPES[0]))
    tc.conv3x3(x, w)
    tc.conv3x3_act_stats(x, w, b)
    assert tc.launch_counts == {"conv3x3": 0, "conv3x3_act_stats": 0}
