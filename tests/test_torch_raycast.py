"""The port's raycaster (spsg_tpu_torch/ops/raycast.py: the plain versions of
the march, shade and scatter kernels, which CPU tensors take) against the JAX
package's on the CPU: the analytic plane / sphere goldens and the gradient
scatter semantics of tests/test_raycast.py, JAX's ``raycast`` with its
default config (coarse skip on) on make_chunk_batch grids, the backward, the
zero-normal rule, non-finite cotangents, and the framed make_chunk_batch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.data import synthetic as jax_synthetic
from spsg_tpu.ops import raycast as jr
from spsg_tpu_torch.data import synthetic
from spsg_tpu_torch.ops import raycast as R

import torch_port_helpers as H


def _plane_scene(dims=(64, 48, 48), z0=20.0, trunc=3.0):
    Z, Y, X = dims
    z = np.arange(Z, dtype=np.float32)[:, None, None]
    sdf = np.clip(np.broadcast_to(z - z0, dims), -trunc, trunc).astype(np.float32)
    return sdf, np.abs(sdf) < trunc


def _down_camera(dims, height_z, image=(32, 24)):
    Z, Y, X = dims
    w, h = image
    intr = np.array([32.0, 32.0, w / 2.0, h / 2.0], dtype=np.float32)
    cam2grid = np.array([[1, 0, 0, X / 2.0], [0, 1, 0, Y / 2.0], [0, 0, -1, height_z],
                         [0, 0, 0, 1]], dtype=np.float32)
    return cam2grid, intr


def _cfg(image=(32, 24), depth_min=2.0, depth_max=80.0):
    return R.RaycastConfig(width=image[0], height=image[1], depth_min=depth_min,
                           depth_max=depth_max, ray_increment=0.9, thresh_sample_dist=45.45)


def _render(sdf, valid, color=None, normal=None, sem=None, view=None, intr=None, cfg=None):
    opt = (lambda a: None if a is None else H.t(a[None]))
    return R.raycast(H.t(sdf[None]), H.t(valid[None]), opt(color), opt(normal), opt(sem),
                     H.t(view[None]), H.t(intr[None]), cfg)


# --- the goldens of tests/test_raycast.py ----------------------------------------

def test_plane_depth():
    dims, z0, cam_z = (64, 48, 48), 20.0, 60.0
    sdf, valid = _plane_scene(dims, z0)
    view, intr = _down_camera(dims, cam_z)
    depth = _render(sdf, valid, view=view, intr=intr, cfg=_cfg()).depth.numpy()[0]
    hit = depth != -np.inf
    assert hit.mean() > 0.9
    np.testing.assert_allclose(depth[hit], cam_z - z0, atol=0.6)


def test_plane_color_and_semantic():
    dims = (64, 48, 48)
    sdf, valid = _plane_scene(dims)
    color = np.zeros(dims + (3,), np.float32)
    color[..., :] = [0.25, 0.5, 0.75]
    sem = np.zeros(dims + (14,), np.float32)
    sem[..., 5] = 7.0
    view, intr = _down_camera(dims, 60.0)
    out = _render(sdf, valid, color=color, sem=sem, view=view, intr=intr, cfg=_cfg())
    c = out.color.numpy()[0]
    hit = c[..., 0] != -np.inf
    assert hit.mean() > 0.9
    np.testing.assert_allclose(c[hit], np.broadcast_to([0.25, 0.5, 0.75], c[hit].shape), atol=1e-5)
    np.testing.assert_allclose(out.semantic.numpy()[0][hit][:, 5], 7.0, atol=1e-5)
    # no normal grid: every normal is zero, so every normal stays invalid
    assert (out.normal.numpy() == -np.inf).all()


def test_sphere_depth():
    dims = (64, 64, 64)
    c, r = np.array([24.0, 32.0, 32.0]), 12.0
    zz, yy, xx = np.meshgrid(*(np.arange(n, dtype=np.float32) for n in dims), indexing="ij")
    d = np.sqrt((zz - c[0]) ** 2 + (yy - c[1]) ** 2 + (xx - c[2]) ** 2) - r
    sdf = np.clip(d, -3.0, 3.0).astype(np.float32)
    cam_z = 60.0
    view, intr = _down_camera(dims, cam_z)
    cfg = _cfg()
    depth = _render(sdf, np.abs(sdf) < 3.0, view=view, intr=intr, cfg=cfg).depth.numpy()[0]
    assert depth[cfg.height // 2, cfg.width // 2] == pytest.approx(cam_z - (c[0] + r), abs=0.5)


def test_gradient_scatter_semantics():
    """d sum(colour image) / d colour grid is exactly 1 at every hit voxel (the
    sum over its pixels of 1/count) and 0 elsewhere; the depth gradient goes to
    the SDF of the same voxels."""
    dims = (48, 32, 32)
    sdf, valid = _plane_scene(dims, z0=16.0)
    color = np.full(dims + (3,), 0.5, np.float32)
    view, intr = _down_camera(dims, 40.0, image=(16, 12))
    cfg = _cfg(image=(16, 12), depth_max=60.0)
    col = H.t(color[None]).requires_grad_()
    c = R.raycast(H.t(sdf[None]), H.t(valid[None]), col, None, None, H.t(view[None]),
                  H.t(intr[None]), cfg).color
    torch.where(c != -torch.inf, c, 0.0).sum().backward()
    g = col.grad.numpy()[0]
    hit_voxels = np.abs(g[..., 0]) > 1e-8
    assert hit_voxels.sum() > 0
    np.testing.assert_allclose(g[hit_voxels], 1.0, atol=1e-5)
    s = H.t(sdf[None]).requires_grad_()
    d = R.raycast(s, H.t(valid[None]), H.t(color[None]), None, None, H.t(view[None]),
                  H.t(intr[None]), cfg).depth
    torch.where(d != -torch.inf, d, 0.0).sum().backward()
    gs = s.grad.numpy()[0]
    np.testing.assert_allclose(gs[np.abs(gs) > 1e-8], 1.0, atol=1e-5)
    assert np.array_equal(np.abs(gs) > 1e-8, hit_voxels)


# --- against the JAX package on make_chunk_batch grids --------------------------

DIMS, IMAGE = (16, 16, 16), (48, 32)


@pytest.fixture(scope="module")
def scene():
    b = jax_synthetic.make_chunk_batch(2, DIMS, image_dims=IMAGE, seed=1, with_frames=True)
    tgt = np.clip(b["target_sdf"], -3.0, 3.0)
    noise = np.random.default_rng(0).normal(0, 0.5, tgt.shape).astype(np.float32)
    grids = {"input": b["input"][..., 0], "target": tgt, "prediction": tgt + noise}
    rng = np.random.default_rng(1)
    attrs = dict(color=rng.uniform(0, 1, (2,) + DIMS + (3,)).astype(np.float32),
                 normal=rng.normal(0, 1, (2,) + DIMS + (3,)).astype(np.float32),
                 semantic=rng.normal(0, 1, (2,) + DIMS + (14,)).astype(np.float32))
    attrs["normal"][:, ::3] = 0.0  # voxels whose normal is zero
    return grids, attrs, b["images_view"], b["images_intrinsic"]


def _kw():
    return dict(width=IMAGE[0], height=IMAGE[1], depth_min=0.1 / 0.02, depth_max=6.0 / 0.02,
                ray_increment=0.9, thresh_sample_dist=50.5 * 0.9)


@pytest.mark.parametrize("grid", ["input", "target", "prediction"])
def test_raycast_matches_jax_default_config(scene, grid):
    grids, attrs, view, intr = scene
    sdf = grids[grid]
    valid = np.abs(sdf) < 3.0
    jcfg = jr.RaycastConfig(**_kw())
    assert jcfg.coarse_skip  # the JAX package's default march
    cts = np.random.default_rng(2).normal(0, 1, (2, IMAGE[1], IMAGE[0], 21)).astype(np.float32)
    split = (lambda c: (c[..., 0:3], c[..., 3], c[..., 4:7], c[..., 7:21]))

    def jax_fn(s, col, nrm, sem):
        out = jr.raycast(s, jnp.asarray(valid), col, nrm, sem, jnp.asarray(view),
                         jnp.asarray(intr), jcfg)
        loss = sum(jnp.sum(jnp.where(jnp.isfinite(o), o, 0.0) * w)
                   for o, w in zip(out, split(cts)))
        return loss, out

    grads, jout = jax.jit(jax.grad(jax_fn, argnums=(0, 1, 2, 3), has_aux=True))(
        jnp.asarray(sdf), *(jnp.asarray(attrs[k]) for k in ("color", "normal", "semantic")))
    jhits = jax.jit(lambda s: jr.find_surface_crossings(
        s, jnp.asarray(valid), jnp.asarray(view), jnp.asarray(intr), jcfg))(jnp.asarray(sdf))

    cfg = R.RaycastConfig(**_kw())
    hits = R.find_surface_crossings(H.t(sdf), H.t(valid), H.t(view), H.t(intr), cfg)
    jhit = np.asarray(jhits["hit"])
    assert jhit.sum() > 100
    np.testing.assert_array_equal(hits["hit"].numpy(), jhit)
    np.testing.assert_array_equal(hits["hit_idx"].numpy(), np.asarray(jhits["hit_idx"]))
    np.testing.assert_allclose(hits["depth"].numpy()[jhit], np.asarray(jhits["depth"])[jhit],
                               rtol=0, atol=1e-4)

    leaves = [H.t(sdf).requires_grad_()] + [H.t(attrs[k]).requires_grad_()
                                            for k in ("color", "normal", "semantic")]
    out = R.raycast(leaves[0], H.t(valid), *leaves[1:], H.t(view), H.t(intr), cfg)
    for o, j in zip(out, jout):
        j = np.asarray(j)
        np.testing.assert_array_equal(np.isfinite(o.detach().numpy()), np.isfinite(j))
        fin = np.isfinite(j)
        np.testing.assert_allclose(o.detach().numpy()[fin], j[fin], rtol=0, atol=1e-4)
    loss = sum((torch.where(torch.isfinite(o), o, 0.0) * H.t(np.ascontiguousarray(w))).sum()
               for o, w in zip(out, split(cts)))
    loss.backward()
    for leaf, g in zip(leaves, grads):
        g = np.asarray(g)
        err = np.abs(leaf.grad.numpy() - g).max() / np.abs(g).max()
        assert err <= 1e-5, err


def test_non_finite_cotangents_are_zeroed_and_still_counted():
    """A hit pixel whose cotangent is NaN or inf adds 0 to its voxel but still
    counts among the pixels that hit it; the rest average as usual."""
    hit = torch.tensor([[True, True, True, False]])
    hit_idx = torch.tensor([[2, 2, 0, 2]], dtype=torch.int32)
    g_color = torch.tensor([[[1.0, float("nan"), 2.0], [3.0, 4.0, float("inf")],
                             [5.0, 6.0, 7.0], [100.0, 100.0, 100.0]]])
    g_depth = torch.tensor([[1.0, float("-inf"), 3.0, 100.0]])
    d_sdf, d_color, d_normal, d_sem = R.scatter(g_color, None, None, g_depth, hit, hit_idx, 4)
    np.testing.assert_allclose(d_color[0, 2].numpy(), [2.0, 2.0, 1.0])
    np.testing.assert_allclose(d_color[0, 0].numpy(), [5.0, 6.0, 7.0])
    assert d_sdf[0, 2] == 0.5 and d_sdf[0, 0] == 3.0
    assert (d_color[0, [1, 3]] == 0).all() and (d_normal == 0).all() and (d_sem == 0).all()


def test_zero_normal_rule_and_invalid_pixels():
    hit = torch.tensor([[True, True, False]])
    hit_idx = torch.tensor([[0, 1, 0]], dtype=torch.int32)
    depth = torch.tensor([[4.0, 5.0, 6.0]])
    normal = torch.tensor([[[0.0, 0.0, 0.0], [0.0, -0.5, 0.0]]])
    color = torch.tensor([[[0.1, 0.2, 0.3], [0.4, 0.5, 0.6]]])
    c, d, n, s = R.shade(color, normal, None, hit, hit_idx, depth)
    assert (n[0, 0] == -np.inf).all() and n[0, 1].tolist() == [0.0, -0.5, 0.0]
    assert (n[0, 2] == -np.inf).all() and (c[0, 2] == -np.inf).all() and d[0, 2] == -np.inf
    assert c[0, 0].tolist() == pytest.approx([0.1, 0.2, 0.3]) and d[0].tolist()[:2] == [4.0, 5.0]
    assert (s[0, :2] == 0).all() and (s[0, 2] == -np.inf).all()


def test_dispatch_is_by_device_and_builds_nothing_on_the_cpu():
    """A CPU tensor takes the plain versions and builds no kernel; a device
    that is neither the CPU nor CUDA is refused (a CUDA tensor launches the
    kernel or raises: chip_smoke.py holds that on the card)."""
    assert R._device_kind(torch.zeros(1), "x") == "cpu"
    with pytest.raises(ValueError, match="unsupported device"):
        R._device_kind(torch.zeros(1, device="meta"), "raycast_march")
    assert not R._libs  # nothing was built on the CPU path


def test_framed_chunk_batch_matches_the_jax_packages():
    ref = jax_synthetic.make_chunk_batch(2, DIMS, image_dims=IMAGE, seed=1, with_frames=True)
    got = synthetic.make_chunk_batch(2, DIMS, image_dims=IMAGE, seed=1, with_frames=True,
                                     device="cpu")
    assert set(got) == set(ref)
    for k in ("images_color", "images_view", "images_intrinsic"):
        assert got[k].dtype == ref[k].dtype
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    hole = ref["images_depth"] == 0
    np.testing.assert_array_equal(got["images_depth"] == 0, hole)
    # metres; the port's march rounds a * b + c twice where XLA fuses it
    np.testing.assert_allclose(got["images_depth"], ref["images_depth"], rtol=0, atol=1e-6)
    assert (~hole).sum() > 100
    for k in ("input", "target_sdf", "target_colors", "semantics"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    if not torch.cuda.is_available():  # frames are rendered on the GPU unless asked otherwise
        with pytest.raises(RuntimeError, match="device='cpu'"):
            synthetic.make_chunk_batch(1, DIMS, image_dims=IMAGE, with_frames=True)
