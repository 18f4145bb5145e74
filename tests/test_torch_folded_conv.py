"""The port's output-folded conv (spsg_tpu_torch/ops/folded_conv.py) against
the JAX package's (spsg_tpu/ops/folded_conv.py) on the CPU: the fold picker
on a grid of layer sizes, values and gradients on the cases of
tests/test_folded_conv.py at that file's tolerances, and the refusals."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.ops import folded_conv as jfold
from spsg_tpu_torch.ops import folded_conv as fold


def _t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


@pytest.mark.parametrize("k", [3, 5])
def test_fold_picker_matches_jax(k):
    """One configuration picks one fold in both packages."""
    dims = (1, 2, 4, 6, 8, 12, 16, 20, 32, 36, 48, 64, 68, 84, 128, 160, 164, 192)
    for y, x, f in itertools.product(dims, (8, 12, 48, 64, 96, 192), (1, 2, 3, 10, 14, 20, 40)):
        assert fold.pick_fold(y, x, f, k=k) == jfold.pick_fold(y, x, f, k=k), (y, x, f)
    for gy, gx in itertools.product((1, 2, 4, 8), repeat=2):
        assert fold.fold_win(gy, gx, k) == jfold.fold_win(gy, gx, k)


def _jax_forward_and_vjp(x, k, fold_yx, ct):
    """The JAX conv's values and its gradients under the cotangent ``ct``, in
    one compiled call."""
    def f(a, b, c):
        y, vjp = jax.vjp(lambda a, b: jfold.conv_folded(a, b, fold_yx), a, b)
        return y, vjp(c)

    return jax.jit(f)(jnp.asarray(x), jnp.asarray(k), jnp.asarray(ct))


def _check(x, k, fold_yx, atol_grad):
    xt, kt = _t(x, True), _t(k, True)
    got = fold.conv_folded(xt, kt, fold_yx)
    ct = np.random.default_rng(4).standard_normal(tuple(got.shape), np.float32)
    ref, want = _jax_forward_and_vjp(x, k, fold_yx, ct)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), atol=1e-4, rtol=1e-5)
    (got * _t(ct)).sum().backward()
    for g, w, name in ((xt.grad, want[0], "dx"), (kt.grad, want[1], "dkernel")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=atol_grad, rtol=1e-5,
                                   err_msg=name)


@pytest.mark.parametrize("shape,feat,fold_yx", [
    ((2, 6, 8, 12, 5), 7, (2, 4)),
    ((1, 4, 8, 8, 3), 1, (8, 8)),
    ((2, 5, 16, 8, 20), 10, (4, 2)),
    ((1, 3, 4, 4, 4), 4, (1, 2)),
    ((2, 4, 8, 8, 13), 40, (2, 1)),
])
def test_3x3x3_matches_jax(shape, feat, fold_yx):
    rng = np.random.default_rng(0)
    x = rng.standard_normal(shape, np.float32)
    k = rng.standard_normal((3, 3, 3, shape[-1], feat), np.float32)
    _check(x, k, fold_yx, atol_grad=2e-4)
    assert fold.conv3x3_folded(_t(x), _t(k), fold_yx).shape == shape[:4] + (feat,)


@pytest.mark.parametrize("fold_yx", [(2, 4), (4, 4), (1, 2)])
def test_5x5x5_matches_jax(fold_yx):
    """The generator's full-resolution entry convs geo_0a / encoder_0a."""
    rng = np.random.default_rng(3)
    _check(rng.standard_normal((1, 6, 8, 8, 4), np.float32),
           rng.standard_normal((5, 5, 5, 4, 2), np.float32), fold_yx, atol_grad=2e-4)


def test_bf16_matches_jax_bf16():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((1, 4, 8, 16, 20), np.float32)
    k = rng.standard_normal((3, 3, 3, 20, 20), np.float32) * 0.1
    ref = jfold.conv3x3_folded(jnp.asarray(x).astype(jnp.bfloat16),
                               jnp.asarray(k).astype(jnp.bfloat16), (2, 2))
    with torch.no_grad():
        got = fold.conv3x3_folded(_t(x).bfloat16(), _t(k).bfloat16(), (2, 2))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(ref.astype(jnp.float32)),
                               atol=0.15, rtol=0.05)


def test_rejects_even_kernel():
    with pytest.raises(ValueError, match="odd"):
        fold.conv_folded(torch.zeros(1, 4, 4, 4, 3), torch.zeros(4, 4, 4, 3, 4), (2, 2))


def test_rejects_a_fold_that_does_not_divide():
    with pytest.raises(ValueError, match="divide"):
        fold.conv3x3_folded(torch.zeros(1, 4, 6, 8, 3), torch.zeros(3, 3, 3, 3, 4), (4, 2))
