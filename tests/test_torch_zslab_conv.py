"""The port's z-slab conv (spsg_tpu_torch/ops/zslab_conv.py) against the JAX
package's (spsg_tpu/ops/zslab_conv.py) on the CPU, on the layer zoo of
tests/test_zslab_conv.py: the same seeded numpy inputs through both, values
and gradients, at that file's tolerances."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.ops.zslab_conv import conv3d_zslab as jax_zslab
from spsg_tpu_torch.ops.zslab_conv import conv3d_zslab

import test_zslab_conv as Z


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


@pytest.mark.parametrize("shape,kshape,stride,pad,dil", Z._CASES)
def test_forward_matches_jax(shape, kshape, stride, pad, dil):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape, np.float32)
    k = rng.standard_normal(kshape, np.float32)
    ref = np.asarray(jax_zslab(jnp.asarray(x), jnp.asarray(k), stride, pad, dil))
    with torch.no_grad():
        got = conv3d_zslab(_t(x), _t(k), stride, pad, dil).numpy()
    assert got.shape == ref.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("shape,kshape,stride,pad,dil", Z._CASES[:4])
def test_gradients_match_jax(shape, kshape, stride, pad, dil):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape, np.float32)
    k = rng.standard_normal(kshape, np.float32)
    out_shape = jax.eval_shape(lambda a, b: jax_zslab(a, b, stride, pad, dil),
                               jnp.asarray(x), jnp.asarray(k)).shape
    ct = rng.standard_normal(out_shape, np.float32)
    ref = jax.jit(jax.grad(lambda a, b: jnp.sum(jax_zslab(a, b, stride, pad, dil) * ct),
                           (0, 1)))(jnp.asarray(x), jnp.asarray(k))
    xt, kt = _t(x, True), _t(k, True)
    (conv3d_zslab(xt, kt, stride, pad, dil) * _t(ct)).sum().backward()
    for got, want, name in ((xt.grad, ref[0], "dx"), (kt.grad, ref[1], "dkernel")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("kernel,stride,pad", [(5, 1, 2), (4, 2, 1)])
def test_a_slab_with_its_y_halo_gives_the_volume_rows(kernel, stride, pad):
    """Y-sharded serving (the generator's z-slab route with ``spatial``): a
    slab that carries the ``pad`` rows the conv reads beyond each of its Y
    ends, convolved with Y padding 0, gives the unsharded conv's rows of the
    slab: a 5^3 entry conv and a 4^3 stride-2 downsampler."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((1, 6, 16, 8, 4), np.float32)
    k = rng.standard_normal((kernel,) * 3 + (4, 2), np.float32)
    ref = np.asarray(jax_zslab(jnp.asarray(x), jnp.asarray(k), stride, pad, 1))
    lo, hi = 4, 12  # the slab's rows of the volume
    with torch.no_grad():
        got = conv3d_zslab(_t(x[:, :, lo - pad: hi + pad]), _t(k), stride, (pad, 0, pad),
                           1).numpy()
    np.testing.assert_allclose(got, ref[:, :, lo // stride: hi // stride], atol=1e-4, rtol=1e-5)


def test_rejects_channel_mismatch():
    with pytest.raises(ValueError, match="in-channels"):
        conv3d_zslab(torch.zeros(1, 4, 4, 4, 3), torch.zeros(3, 3, 3, 2, 4))


def test_bf16_matches_jax_bf16():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 4, 8, 16, 20), np.float32)
    k = rng.standard_normal((3, 3, 3, 20, 20), np.float32) * 0.1
    ref = np.asarray(jax_zslab(jnp.asarray(x).astype(jnp.bfloat16),
                               jnp.asarray(k).astype(jnp.bfloat16)).astype(jnp.float32))
    with torch.no_grad():
        got = conv3d_zslab(_t(x).bfloat16(), _t(k).bfloat16())
    assert got.dtype == torch.bfloat16
    # both round bf16 products summed in other orders: the JAX test's bounds
    np.testing.assert_allclose(got.float().numpy(), ref, atol=0.15, rtol=0.05)
