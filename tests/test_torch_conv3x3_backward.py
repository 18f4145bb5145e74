"""The weight-gradient function and the backward of the two conv functions
(spsg_tpu_torch/ops/conv3x3.py) against the JAX package's Pallas kernels and
their custom VJPs (interpret mode on the CPU) and against autograd of the plain
PyTorch versions, on identical numpy inputs.

On the CPU the autograd Functions run the kernels' plain versions, so what is
tested here is the hand-derived backward algebra that launches the CUDA kernels
on a card; the kernels themselves are held against the plain versions on the
card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.ops import pallas_conv as pc
from spsg_tpu_torch.ops import conv3x3 as tc

torch.set_num_threads(1)  # as in test_torch_conv3x3.py

# (B, Z, Y, X, Cin, Cout): the shapes of tests/test_pallas_conv.py and
# test_torch_conv3x3.py, and the ragged channel counts that the backward of the
# generator's heads gives the forward kernel (Cin of 1, 3 and 14)
SHAPES = [(2, 4, 8, 8, 5, 6), (1, 4, 6, 10, 7, 3), (1, 4, 8, 8, 10, 1)]
RAGGED = [(1, 4, 8, 8, 1, 10), (1, 4, 8, 8, 3, 10), (1, 4, 8, 8, 14, 20)]


def _data(shape, seed=0):
    B, Z, Y, X, Ci, Co = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, Z, Y, X, Ci)).astype(np.float32)
    w = (rng.standard_normal((3, 3, 3, Ci, Co)) * 0.2).astype(np.float32)
    b = (rng.standard_normal((Co,)) * 0.1).astype(np.float32)
    dy = rng.standard_normal((B, Z, Y, X, Co)).astype(np.float32)
    ds = (rng.standard_normal((Co,)) * 0.5).astype(np.float32)
    dss = (rng.standard_normal((Co,)) * 0.05).astype(np.float32)
    return x, w, b, dy, ds, dss


def _close(got, ref, rel, what):
    """Within ``rel`` of the largest entry of ``ref``: float32 sums over a few
    hundred to a thousand voxels, taken in another order."""
    ref = np.asarray(ref, np.float32)
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape, what
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max() + 1e-12, err_msg=what)


@pytest.mark.parametrize("shape", SHAPES + RAGGED)
def test_dw_plain_matches_the_pallas_kernel(shape):
    x, _, _, dy, _, _ = _data(shape)
    ref = pc._conv3x3_dw_impl(jnp.asarray(x), jnp.asarray(dy), interpret=True)
    got = tc.conv3x3_dw(torch.from_numpy(x), torch.from_numpy(dy))
    assert got.dtype == torch.float32 and tuple(got.shape) == (3, 3, 3, shape[4], shape[5])
    _close(got, ref, 1e-5, "dW")
    assert torch.equal(got, tc.conv3x3_dw_plain(torch.from_numpy(x), torch.from_numpy(dy)))


def test_dw_bfloat16_inputs_accumulate_in_float32():
    x, _, _, dy, _, _ = _data(SHAPES[0], seed=1)
    xb, db = torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(dy).to(torch.bfloat16)
    got = tc.conv3x3_dw(xb, db)
    assert got.dtype == torch.float32
    ref = pc._conv3x3_dw_impl(jnp.asarray(x).astype(jnp.bfloat16),
                              jnp.asarray(dy).astype(jnp.bfloat16), interpret=True)
    assert ref.dtype == jnp.float32
    # the same rounded inputs, products exact in float32: only the order differs
    _close(got, ref, 1e-5, "dW bf16")


@pytest.mark.parametrize("shape", SHAPES + RAGGED)
def test_conv3x3_backward_matches_the_pallas_vjp_and_plain_autograd(shape):
    x, w, _, dy, _, _ = _data(shape, seed=2)
    _, vjp = jax.vjp(lambda x, w: pc.conv3x3(x, w, True), jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    dx, dw = torch.autograd.grad(tc.conv3x3(tx, tw), (tx, tw), torch.from_numpy(dy))
    _close(dx, jdx, 1e-4, "dx vs pallas")
    _close(dw, jdw, 1e-4, "dW vs pallas")
    px, pw = torch.autograd.grad(tc.conv3x3_plain(tx, tw), (tx, tw), torch.from_numpy(dy))
    _close(dx, px.numpy(), 1e-4, "dx vs autograd")
    _close(dw, pw.numpy(), 1e-4, "dW vs autograd")


@pytest.mark.parametrize("shape", SHAPES + RAGGED)
def test_act_stats_backward_matches_the_pallas_vjp_and_plain_autograd(shape):
    """All three outputs carry a cotangent: ds and dss are not zero."""
    x, w, b, dy, ds, dss = _data(shape, seed=3)
    _, vjp = jax.vjp(lambda x, w, b: pc.conv3x3_act_stats(x, w, b, True),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    jref = vjp((jnp.asarray(dy), jnp.asarray(ds), jnp.asarray(dss)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    cts = tuple(torch.from_numpy(a) for a in (dy, ds, dss))
    got = torch.autograd.grad(tc.conv3x3_act_stats(*leaves), leaves, cts)
    plain = torch.autograd.grad(tc.conv3x3_act_stats_plain(*leaves), leaves, cts)
    for g, j, p, name in zip(got, jref, plain, ("dx", "dW", "db")):
        assert g.dtype == torch.float32
        _close(g, j, 1e-4, f"{name} vs pallas")
        _close(g, p.numpy(), 1e-4, f"{name} vs autograd")


def test_act_stats_backward_bfloat16_follows_the_jax_order_of_casts():
    """dconv is rounded to bfloat16 before db is summed and before dx and dW
    are computed from it; dW is accumulated in float32 and cast at the end."""
    x, w, b, dy, ds, dss = _data(SHAPES[0], seed=4)
    bf = jnp.bfloat16
    _, vjp = jax.vjp(lambda x, w, b: pc.conv3x3_act_stats(x, w, b, True),
                     jnp.asarray(x).astype(bf), jnp.asarray(w).astype(bf), jnp.asarray(b))
    jdx, jdw, jdb = vjp((jnp.asarray(dy).astype(bf), jnp.asarray(ds), jnp.asarray(dss)))
    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_()
    tw = torch.from_numpy(w).to(torch.bfloat16).requires_grad_()
    tb = torch.from_numpy(b).requires_grad_()
    cts = (torch.from_numpy(dy).to(torch.bfloat16), torch.from_numpy(ds), torch.from_numpy(dss))
    dx, dw, db = torch.autograd.grad(tc.conv3x3_act_stats(tx, tw, tb), (tx, tw, tb), cts)
    assert dx.dtype == torch.bfloat16 and dw.dtype == torch.bfloat16 and db.dtype == torch.float32
    jdx = np.asarray(jdx.astype(jnp.float32))
    # one bfloat16 step (2**-8 relative, round to nearest) of each entry of dx,
    # where the two float32 sums straddle a rounding boundary; the forward
    # activations y differ the same way, which flips a slope here and there:
    # such voxels are few
    err = np.abs(dx.float().numpy() - jdx)
    step = np.maximum(np.abs(jdx), 1e-3) * 2.0 ** -7
    assert (err <= step).mean() >= 0.995, (err > step).mean()
    _close(dw, np.asarray(jdw.astype(jnp.float32)), 2e-2, "dW bf16")
    _close(db, jdb, 2e-2, "db bf16")


def test_backward_takes_a_non_contiguous_cotangent():
    """Autograd hands over slices of a cat and expands of an upsample; the
    kernels want contiguous memory, so backward makes it so."""
    x, w, b, _, _, _ = _data(SHAPES[0], seed=5)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    rng = np.random.default_rng(6)
    other = torch.from_numpy(rng.standard_normal(x.shape[:4] + (3,)).astype(np.float32))
    coef = torch.from_numpy(rng.standard_normal(x.shape[:4] + (9,)).astype(np.float32))

    def loss(fn):
        y = fn(*leaves)[0]
        return (torch.cat([other, y], dim=-1) * coef).sum()  # dy is a slice of coef

    got = torch.autograd.grad(loss(tc.conv3x3_act_stats), leaves)
    ref = torch.autograd.grad(loss(tc.conv3x3_act_stats_plain), leaves)
    for g, r, name in zip(got, ref, ("dx", "dW", "db")):
        _close(g, r.numpy(), 1e-4, name)

    seen = []
    real = tc._conv

    def spy(x, w):
        seen.append(x.is_contiguous())
        return real(x, w)

    tc._conv = spy
    try:
        tx, tw = leaves[:2]
        y = tc.conv3x3(tx, tw)
        y.backward(coef[..., 3:])  # a non-contiguous cotangent, handed in directly
    finally:
        tc._conv = real
    assert seen == [True, True] and not coef[..., 3:].is_contiguous()


@pytest.mark.parametrize("needs", ["x", "w", "b", "xw", "wb", "none"])
def test_backward_respects_needs_input_grad(needs):
    x, w, b, dy, ds, dss = _data(SHAPES[1], seed=7)
    leaves = {n: torch.from_numpy(a).requires_grad_(n in needs) for n, a in zip("xwb", (x, w, b))}
    calls = {"conv": 0, "dw": 0}
    real_conv, real_dw = tc._conv, tc.conv3x3_dw

    def conv(x, w):
        calls["conv"] += 1
        return real_conv(x, w)

    def dw(x, dy):
        calls["dw"] += 1
        return real_dw(x, dy)

    tc._conv, tc.conv3x3_dw = conv, dw
    try:
        out = tc.conv3x3_act_stats(leaves["x"], leaves["w"], leaves["b"])
        if needs == "none":
            assert not any(o.requires_grad for o in out)
            return
        torch.autograd.backward(out, tuple(torch.from_numpy(a) for a in (dy, ds, dss)))
    finally:
        tc._conv, tc.conv3x3_dw = real_conv, real_dw
    # the forward goes through _conv_act_stats; _conv is dx, conv3x3_dw is dW
    assert calls == {"conv": int("x" in needs), "dw": int("w" in needs)}
    for n, t in leaves.items():
        assert (t.grad is not None) == (n in needs)


def test_absent_statistics_cotangents_count_as_zero():
    """Eval-mode BatchNorm ignores the sums: their cotangents are None."""
    x, w, b, dy, _, _ = _data(SHAPES[0], seed=8)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (x, w, b)]
    y, s, ss = tc.conv3x3_act_stats(*leaves)
    got = torch.autograd.grad(y, leaves, torch.from_numpy(dy))
    zeros = (torch.zeros_like(s), torch.zeros_like(ss))
    ref = torch.autograd.grad(tc.conv3x3_act_stats(*leaves), leaves,
                              (torch.from_numpy(dy),) + zeros)
    assert all(torch.equal(g, r) for g, r in zip(got, ref))
    # and only the sums used: dy is None
    got = torch.autograd.grad(tc.conv3x3_act_stats(*leaves)[1].sum(), leaves)
    ref = torch.autograd.grad(tc.conv3x3_act_stats_plain(*leaves)[1].sum(), leaves)
    for g, r, name in zip(got, ref, ("dx", "dW", "db")):
        _close(g, r.numpy(), 1e-4, name)


@pytest.mark.parametrize("case", ["shape", "dtype", "mixed", "rank"])
def test_dw_wrapper_rejects_what_the_kernel_does_not_take(case):
    x = torch.zeros(1, 2, 4, 4, 3)
    dy = torch.zeros(1, 2, 4, 4, 2)
    if case == "shape":
        with pytest.raises(ValueError):
            tc.conv3x3_dw(x, torch.zeros(1, 2, 4, 5, 2))
    elif case == "dtype":
        with pytest.raises(TypeError):
            tc.conv3x3_dw(x.double(), dy.double())
    elif case == "mixed":
        with pytest.raises(TypeError):
            tc.conv3x3_dw(x, dy.to(torch.bfloat16))
    else:
        with pytest.raises(ValueError):
            tc.conv3x3_dw(x[0], dy[0])
    assert tc.conv3x3_dw(x, dy).shape == (3, 3, 3, 3, 2)
