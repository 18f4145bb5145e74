"""The occupancy raycast (spsg_tpu_torch/ops/raycast.py::raycast_occ, kernel
K7 on a card) on the CPU: its plain version against the JAX package's
raycast_occ on the slab and blob scenes of tests/test_raycast.py (down and
oblique cameras), on the training step's masks of make_chunk_batch grids and
on an all-empty grid: identical on every pixel (no pixel differed, so no
tolerance is agreed); and K7's per-ray loop written out in numpy float32
(each operation rounded once, as the kernel compiled with -fmad=false does)
against the plain version's image and count of samples."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.data import synthetic as jax_synthetic
from spsg_tpu.losses import geo as jax_geo
from spsg_tpu.ops import raycast as jr
from spsg_tpu_torch.ops import raycast as R

import test_raycast as TR  # the JAX package's scenes and cameras
import torch_port_helpers as H


def _configs(image, depth_max, depth_min=2.0):
    jc = dataclasses.replace(TR._cfg(image=image, depth_max=depth_max), depth_min=depth_min)
    rc = R.RaycastConfig(width=image[0], height=image[1], depth_min=jc.depth_min,
                         depth_max=jc.depth_max, ray_increment=jc.ray_increment,
                         thresh_sample_dist=jc.thresh_sample_dist, march_block=jc.march_block)
    return jc, rc


def _slab():
    dims = (48, 32, 32)
    occ = np.zeros(dims, np.uint8)
    occ[10:14, 8:24, 8:24] = 1
    view, intr = TR._down_camera(dims, 40.0, image=(16, 12))
    return occ[None], view[None], intr[None], _configs((16, 12), 60.0)


def _blob(camera):
    dims = (64, 64, 64)
    sdf, _ = TR._blob_scene(dims, seed=3)
    occ = (np.abs(sdf) < 1.5).astype(np.uint8)
    view, intr = (TR._down_camera(dims, 60.0) if camera == "down"
                  else TR._oblique_camera(dims))
    return occ[None], view[None], intr[None], _configs((32, 24), 200.0)


def _chunk_masks(dims, image, which):
    """The step's two masks (training/step.py::_occupancy_masks) of a
    make_chunk_batch with frames, at raycast_occ_depth_max (4 m)."""
    b = jax_synthetic.make_chunk_batch(2, dims, image_dims=image, seed=1, with_frames=True)
    trunc = 3.0
    tgt = np.asarray(jax_geo.compute_targets(jnp.asarray(b["target_sdf"]), trunc))
    if which == "missing":
        inp = b["input"][..., 0]
        occ = np.asarray(jax_geo.missing_geo_mask(jnp.asarray(np.abs(inp) < trunc - 0.01),
                                                  jnp.asarray(tgt), trunc))
    else:
        occ = np.abs(tgt) < 1
    cfgs = _configs(image, 4.0 / 0.02, depth_min=0.1 / 0.02)
    return occ.astype(np.uint8), b["images_view"], b["images_intrinsic"], cfgs


SCENES = {
    "slab_down": _slab,
    "blob_down": lambda: _blob("down"),
    "blob_oblique": lambda: _blob("oblique"),
    "chunk16_target_band": lambda: _chunk_masks((16, 16, 16), (48, 32), "target"),
    "chunk16_missing": lambda: _chunk_masks((16, 16, 16), (48, 32), "missing"),
    "chunk64_target_band": lambda: _chunk_masks((64, 32, 32), (160, 128), "target"),
    "chunk64_missing": lambda: _chunk_masks((64, 32, 32), (160, 128), "missing"),
}


@pytest.mark.parametrize("scene", list(SCENES))
def test_raycast_occ_matches_jax(scene):
    occ, view, intr, (jc, rc) = SCENES[scene]()
    want = np.asarray(jr.raycast_occ(jnp.asarray(occ), jnp.asarray(view), jnp.asarray(intr), jc))
    got = R.raycast_occ(H.t(occ), H.t(view), H.t(intr), rc)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    # identical on every pixel (measured: no pixel differs on any scene here)
    np.testing.assert_array_equal(got.numpy(), want)
    if scene != "chunk16_missing":  # 8^3 blocks without input are rare at 16^3
        assert want.sum() > 10
    # the wrapper on a CPU tensor is the plain version; bool and uint8 alike
    plain = R.raycast_occ_plain(H.t(occ.astype(bool)), H.t(view), H.t(intr), rc)
    assert torch.equal(plain, got)


def test_raycast_occ_of_an_empty_grid_is_zero():
    occ, view, intr, (jc, rc) = _blob("oblique")
    empty = np.zeros_like(occ)
    want = np.asarray(jr.raycast_occ(jnp.asarray(empty), jnp.asarray(view), jnp.asarray(intr),
                                     jc))
    occ_b, setup = R.occ_setup(H.t(empty), H.t(view), H.t(intr), rc)
    got, samples = R.occ_march_plain(occ_b, setup, rc, return_samples=True)
    assert not want.any() and not got.any()
    # the box of no voxel is inverted, and the ray-box slab test reads an
    # inverted box as a box: the rays still walk (and find nothing)
    assert int(samples.sum()) > 0


def _kernel_loop(occ, setup, step, k_max):
    """K7's loop for every ray, in numpy float32 (one rounding an operation)."""
    B, Z, Y, X = occ.shape
    origin, direction, _, t0, t_stop = (a.numpy() for a in setup)
    f32 = np.float32
    hit = np.zeros(t0.shape, np.uint8)
    samples = np.zeros(t0.shape, np.int64)
    for b in range(B):
        o = origin[b]
        for r in range(t0.shape[1]):
            d = direction[b, r]
            k = 0
            while k < k_max:
                t = f32(t0[b, r] + f32(f32(k) * f32(step)))
                if not t <= t_stop[b, r]:
                    break
                v = [np.floor(f32(f32(o[i] + f32(t * d[i])) + f32(0.5))) for i in range(3)]
                if (min(v) >= 0 and v[0] < X and v[1] < Y and v[2] < Z
                        and occ[b, int(v[2]), int(v[1]), int(v[0])]):
                    hit[b, r] = 1
                    k += 1
                    break
                k += 1
            samples[b, r] = k
    return hit, samples


@pytest.mark.parametrize("scene", ["slab_down", "blob_oblique"])
def test_kernel_loop_matches_the_plain_version(scene):
    occ, view, intr, (_, rc) = SCENES[scene]()
    if scene == "blob_oblique":  # a band of rows keeps the loop in Python short
        rc = dataclasses.replace(rc, height=6)
        intr = intr.copy()
        intr[:, 3] -= 9.0
    occ_b, setup = R.occ_setup(H.t(occ), H.t(view), H.t(intr), rc)
    hit, samples = _kernel_loop(occ != 0, setup, rc.ray_increment, rc.max_samples)
    got, got_samples = R.occ_march_plain(occ_b, setup, rc, return_samples=True)
    assert hit.sum() > 0
    np.testing.assert_array_equal(got.numpy(), hit)
    np.testing.assert_array_equal(got_samples.numpy(), samples)


def test_raycast_occ_checks_its_input():
    rc = R.RaycastConfig(width=4, height=2)
    with pytest.raises(ValueError, match="B,Z,Y,X"):
        R.raycast_occ(torch.zeros(4, 4, 4, dtype=torch.bool), torch.eye(4)[None],
                      torch.ones(1, 4), rc)
    assert R.launch_counts["raycast_occ"] == 0


@pytest.mark.parametrize("with_k7", [True, False])
def test_bind_declares_k7_where_the_library_has_it(with_k7):
    """_bind types a library's functions; one built from a raycast.cu from
    before K7 (a baseline to time K4-K6 against) binds too."""
    from types import SimpleNamespace

    names = ["spsg_raycast_march", "spsg_raycast_shade", "spsg_raycast_scatter"]
    lib = SimpleNamespace(**{n: SimpleNamespace() for n in
                             names + (["spsg_raycast_occ"] if with_k7 else [])})
    assert R._bind(lib) is lib
    for n in names:
        assert getattr(lib, n).restype is not None and getattr(lib, n).argtypes
    assert hasattr(lib, "spsg_raycast_occ") == with_k7
    if with_k7:
        assert len(lib.spsg_raycast_occ.argtypes) == 16
