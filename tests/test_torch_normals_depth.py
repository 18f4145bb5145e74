"""The port's SDF-gradient normals (spsg_tpu_torch/ops/normals3d.py) and depth
chain (spsg_tpu_torch/ops/depth.py) against the JAX package's on the CPU: the
six tests of tests/test_depth_ops.py on the port, parity on rendered frames
with punched holes (filled depth and all_valid within 1e-6; the port decides
per frame, so it is held against the JAX chain on each frame alone), the
frame of the nf-20 golden's synthetic_7 filled to the bit, normals with a
rotation, and a finite SDF gradient where the normal's gradient is zero."""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.data import synthetic as jax_synthetic
from spsg_tpu.ops import depth as JD
from spsg_tpu.ops import normals3d as JN
from spsg_tpu_torch.ops import depth as D
from spsg_tpu_torch.ops import normals3d as N

import torch_port_helpers as H

sys.path.insert(0, H.REPO)
import chip_smoke as cs  # noqa: E402


# --- the six tests of tests/test_depth_ops.py, on the port ---------------------

def test_bilateral_preserves_constant():
    d = np.full((1, 16, 16), 2.0, np.float32)
    out = D.bilateral_filter(H.t(d)).numpy()
    np.testing.assert_allclose(out, d, atol=1e-5)


def test_bilateral_keeps_holes():
    d = np.full((1, 16, 16), 2.0, np.float32)
    d[0, 5, 5] = 0.0
    out = D.bilateral_filter(H.t(d)).numpy()
    assert out[0, 5, 5] == 0.0
    assert abs(out[0, 8, 8] - 2.0) < 1e-4


def test_median_fill_fills_hole():
    d = np.full((1, 16, 16), 1.5, np.float32)
    d[0, 7, 7] = 0.0
    out = D.median_fill(H.t(d)).numpy()
    assert abs(out[0, 7, 7] - 1.5) < 1e-3
    np.testing.assert_allclose(out[0, 0, 0], 1.5)


def test_fill_depth_holes_early_exit():
    d = np.full((1, 16, 16), 1.5, np.float32)
    D.reset_host_syncs()
    out, ok = D.fill_depth_holes(H.t(d), max_iters=4)
    assert bool(ok[0])
    np.testing.assert_allclose(out.numpy(), d)  # untouched when no holes
    assert D.host_syncs["fill_depth_holes"] == 1


def test_fill_depth_holes_large_hole():
    d = np.full((1, 24, 24), 2.0, np.float32)
    d[0, 4:16, 4:16] = 0.0
    D.reset_host_syncs()
    out, ok = D.fill_depth_holes(H.t(d), max_iters=40)
    assert bool(ok[0])
    assert np.abs(out.numpy() - 2.0).max() < 0.01
    # the check before the fill and one per iteration until no hole is left
    assert 2 < D.host_syncs["fill_depth_holes"] <= 41


def test_unprojection_and_normals_plane():
    Hh, W = 32, 40
    depth = np.full((1, Hh, W), 2.0, np.float32)
    intr = np.array([[40.0, 40.0, W / 2, Hh / 2]], np.float32)
    pts = D.depth_to_camera_space(H.t(depth), H.t(intr)).numpy()
    assert abs(pts[0, Hh // 2, W // 2, 2] - 2.0) < 1e-5
    normals = D.camera_space_normals(H.t(pts)).numpy()
    nz = normals[0, 2:-2, 2:-2][..., 2]
    assert np.abs(np.abs(nz) - 1.0).max() < 1e-3
    assert (np.sign(nz) == np.sign(nz.flat[0])).all()


# --- parity with the JAX package on rendered frames ----------------------------

@pytest.fixture(scope="module")
def frames():
    b = jax_synthetic.make_chunk_batch(2, (16, 16, 16), image_dims=(48, 32), seed=2,
                                       with_frames=True)
    return b["images_depth"], b["images_intrinsic"]


def _punch(depth, which, seed=0):
    d = depth.copy()
    rng = np.random.default_rng(seed)
    for b in which:
        y, x = rng.integers(4, 24), rng.integers(4, 40)
        d[b, y:y + 5, x:x + 6] = 0.0
        d[b, rng.integers(0, 32, 20), rng.integers(0, 48, 20)] = 0.0
    return d


@pytest.mark.parametrize("holes", ["none", "one_frame", "both_frames", "unfillable"])
def test_depth_to_normals_matches_jax(frames, holes):
    depth, intr = frames
    if holes == "one_frame":
        # frame 1 has no hole: it passes through untouched, where the JAX
        # package's batch-wide decision filters and iterates it
        depth = _punch(np.where(depth == 0, 1.0, depth).astype(np.float32), [0])
    elif holes == "both_frames":
        depth = _punch(depth, [0, 1], seed=1)
    elif holes == "unfillable":
        depth = depth.copy()
        depth[1] = 0.0
    elif (depth == 0).any():
        depth = np.where(depth == 0, 1.0, depth).astype(np.float32)
    # the port decides per frame (ROADMAP.md Queue C): JAX's chain on each frame alone
    per = [JD.depth_to_normals(jnp.asarray(depth[i:i + 1]), jnp.asarray(intr[i:i + 1]), 8)
           for i in range(len(depth))]
    jn, jf, jok = (np.concatenate([np.asarray(p[k]) for p in per]) for k in range(3))
    tn, tf, tok = D.depth_to_normals(H.t(depth), H.t(intr), 8)
    np.testing.assert_array_equal(tok.numpy(), jok)
    np.testing.assert_allclose(tf.numpy(), jf, rtol=0, atol=1e-6)
    # unfiltered frames give the same depth to the bit and normals within 1e-6.
    # A filtered frame's depth differs by float32 rounding of exp and of the
    # weighted sums (< 1e-6 m), and the cross product of neighbour differences
    # (~0.02 m apart) magnifies that: measured 8.6e-6 on the unit normals
    filtered = holes != "none"
    np.testing.assert_allclose(tn.numpy(), jn, rtol=0, atol=2e-5 if filtered else 1e-6)
    if holes == "one_frame":
        np.testing.assert_array_equal(tf.numpy()[1], depth[1])
        assert jok.all()
        # the deviation: the JAX package on the whole batch filters frame 1 all the same
        _, jf_batch, _ = JD.depth_to_normals(jnp.asarray(depth), jnp.asarray(intr), 8)
        assert not np.array_equal(np.asarray(jf_batch)[1], depth[1])
        np.testing.assert_allclose(tf.numpy()[0], np.asarray(jf_batch)[0], rtol=0, atol=1e-6)
    if holes == "unfillable":
        assert list(jok) == [True, False]


def test_median_fill_and_bilateral_match_jax(frames):
    depth = _punch(frames[0], [0, 1], seed=3)
    np.testing.assert_allclose(D.bilateral_filter(H.t(depth)).numpy(),
                               np.asarray(JD.bilateral_filter(jnp.asarray(depth))), atol=1e-6)
    np.testing.assert_array_equal(D.median_fill(H.t(depth)).numpy(),
                                  np.asarray(JD.median_fill(jnp.asarray(depth))))


def test_depth_chain_matches_jax_to_the_bit_where_the_millimetres_flipped():
    """The frame of synthetic_7 of the nf-20 run's validation set as
    golden_val.json took it (seed 200007, (128,64,64) / 320x256, rendered by
    the port on the CPU: chip_smoke.py's golden_validation_set). Before the
    depth chain took XLA's arithmetic, the bilateral filter's output differed
    from the JAX package's on 56 % of its pixels, six pixels' millimetres
    flipped in the median fill and the fill spread them (normals up to 0.074
    apart). Now the filled depth (seeded by the bilateral output) and
    all_valid are the jitted JAX chain's to the bit; the normals are held to
    the existing 2e-5."""
    _, val, _, _ = cs.load_goldens()
    sample = cs.golden_validation_set(cs.run_config(val["args"]), val, [7])[0]
    depth, intr = sample["images_depth"][None], sample["images_intrinsic"][None]
    assert depth.shape == (1, 256, 320) and (depth == 0).sum() > 1000
    jn, jf, jok = (np.asarray(a) for a in JD.depth_to_normals(depth, intr, 40))
    tn, tf, tok = D.depth_to_normals(H.t(depth), H.t(intr), 40)
    np.testing.assert_array_equal(tf.numpy().view(np.int32), jf.view(np.int32))
    np.testing.assert_array_equal(tok.numpy(), jok)
    np.testing.assert_allclose(tn.numpy(), jn, rtol=0, atol=2e-5)


# --- normals ----------------------------------------------------------------------

def _rotations(n, seed):
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.normal(size=(n, 3, 3)))
    return q.astype(np.float32)


@pytest.mark.parametrize("rotated", [False, True])
def test_surface_normals_match_jax(rotated):
    rng = np.random.default_rng(4)
    sdf = np.clip(rng.normal(0, 2, (2, 10, 12, 14)), -3, 3).astype(np.float32)
    valid = np.abs(sdf) < 2.0
    rot = _rotations(2, 5) if rotated else None
    want = np.asarray(JN.surface_normals(jnp.asarray(sdf), jnp.asarray(valid),
                                         None if rot is None else jnp.asarray(rot)))
    got = N.surface_normals(H.t(sdf), H.t(valid), None if rot is None else H.t(rot)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(N.sdf_gradient(H.t(sdf)).numpy(),
                                  np.asarray(JN.sdf_gradient(jnp.asarray(sdf))))
    # the zero boundary
    assert (got[:, 0] == 0).all() and (got[:, :, :, -1] == 0).all()


def test_normal_gradient_is_finite_where_the_sdf_gradient_is_zero():
    """A constant patch has a zero SDF gradient: the backward of a plain norm
    would be 0 * inf = NaN there; the safe norm keeps it finite, as in JAX."""
    sdf = np.zeros((1, 6, 6, 6), np.float32)
    sdf[0, :, :, 4:] = 1.0  # constant on both sides of a step
    valid = np.ones_like(sdf, bool)
    rot = _rotations(1, 6)
    w = np.random.default_rng(7).normal(size=sdf.shape + (3,)).astype(np.float32)
    x = H.t(sdf).requires_grad_()
    (N.surface_normals(x, H.t(valid), H.t(rot)) * H.t(w)).sum().backward()
    assert torch.isfinite(x.grad).all()

    def f(s):
        return jnp.sum(JN.surface_normals(s, jnp.asarray(valid), jnp.asarray(rot)) * w)

    want = np.asarray(jax.grad(f)(jnp.asarray(sdf)))
    np.testing.assert_allclose(x.grad.numpy(), want, rtol=1e-5, atol=1e-5)
