"""The port's triangle rasterizer (spsg_tpu_torch/datagen/raster.py and its
native raster_native/rasterize.cpp): the tests of tests/test_raster.py on
the port's copy, and the port's native rasterizer and numpy fallback against
the JAX package's on the same meshes and cameras, identical to the bit."""

import numpy as np
import pytest

from spsg_tpu.datagen import raster as jraster
from spsg_tpu_torch.data import formats
from spsg_tpu_torch.datagen import fusion, raster, scan

import test_torch_fusion as TF


def _quad(z0=2.0, half=1.0, colors=((255, 0, 0), (0, 255, 0), (0, 0, 255), (255, 255, 0))):
    """Two triangles spanning a camera-facing square at camera z=z0 (the
    camera at the origin looks down +z)."""
    verts = np.array(
        [[-half, -half, z0], [half, -half, z0], [half, half, z0], [-half, half, z0]],
        np.float32,
    )
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    return verts, faces, np.array(colors, np.uint8)


CAM_ID = np.eye(4, dtype=np.float32)
INTR = dict(fx=60.0, fy=60.0, cx=32.0, cy=24.0, width=64, height=48)


def test_rasterize_plane_depth_analytic():
    verts, faces, colors = _quad(z0=2.0)
    depth, color = raster.rasterize_depth(
        verts, faces, colors, CAM_ID, depth_min=0.4, depth_max=4.0, **INTR
    )
    assert depth[24, 32] == pytest.approx(2.0, abs=1e-5)
    inside = depth > 0
    assert inside[24, 2:62].all()
    np.testing.assert_allclose(depth[inside], 2.0, atol=1e-4)
    assert color is not None and color.shape == (48, 64, 3)


def test_rasterize_color_interpolation_perspective_correct():
    verts = np.array([[-0.5, 0.0, 1.0], [2.0, 0.0, 4.0], [0.0, 1.0, 2.0]], np.float32)
    faces = np.array([[0, 1, 2]])
    colors = np.array([[0, 0, 0], [255, 255, 255], [0, 0, 0]], np.uint8)
    depth, color = raster.rasterize_depth(
        verts, faces, colors, CAM_ID, depth_min=0.1, depth_max=10.0, **INTR
    )
    ys, xs = np.nonzero(depth)
    assert len(ys) > 20
    row = depth[25]
    cols = np.nonzero(row)[0]
    assert len(cols) > 5
    dr = row[cols]
    assert dr[-1] > dr[0]


def test_near_plane_clipping():
    verts = np.array([[0.0, -0.2, -0.5], [0.3, 0.2, 2.0], [-0.3, 0.2, 2.0]], np.float32)
    faces = np.array([[0, 1, 2]])
    depth, _ = raster.rasterize_depth(
        verts, faces, None, CAM_ID, depth_min=0.4, depth_max=4.0, **INTR
    )
    assert (depth > 0).sum() > 10
    assert depth[depth > 0].min() >= 0.4 - 1e-5
    assert depth[depth > 0].max() <= 2.0 + 1e-4


def test_depth_range_validation():
    verts, faces, _ = _quad(z0=5.0)
    depth, _ = raster.rasterize_depth(
        verts, faces, None, CAM_ID, depth_min=0.4, depth_max=4.0, **INTR
    )
    assert (depth == 0).all()


def test_raster_fills_splat_holes():
    verts, faces, _ = _quad(z0=1.5, half=2.0)
    sc = scan.ScanConfig(width=64, height=48, fx=60.0, fy=60.0, samples_per_area=200.0)
    pts = np.concatenate([verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]])
    d_splat, _ = scan.render_depth_from_points(pts, None, CAM_ID, sc)
    d_rast, _ = raster.rasterize_depth(
        verts, faces, None, CAM_ID, depth_min=0.4, depth_max=4.0, **INTR
    )
    assert (d_rast > 0).sum() > 10 * max(1, (d_splat > 0).sum())


def _five_vertex_mesh():
    verts = np.array(
        [[-0.5, -0.3, 1.2], [0.8, -0.1, 2.5], [0.1, 0.7, 1.8],
         [-0.4, 0.5, 3.0], [0.6, 0.6, 1.1]], np.float32,
    )
    faces = np.array([[0, 1, 2], [2, 3, 0], [1, 4, 2]], np.int64)
    colors = np.array(
        [[10, 20, 30], [200, 100, 0], [0, 255, 128], [255, 0, 255], [50, 50, 50]], np.uint8,
    )
    return verts, faces, colors, np.array([1.0, 0.6, 0.8], np.float32)


def test_native_matches_numpy_fallback():
    assert raster._build_native() is not None  # g++ builds it where these tests run
    verts, faces, colors, shade = _five_vertex_mesh()
    kw = dict(cam2world=CAM_ID, depth_min=0.4, depth_max=4.0, face_shade=shade, **INTR)
    d_nat, c_nat = raster.rasterize_depth(verts, faces, colors, **kw)
    d_np, c_np = raster._rasterize_numpy(
        verts.copy(), colors.astype(np.float32), faces.astype(np.int32), shade,
        INTR["fx"], INTR["fy"], INTR["cx"], INTR["cy"], INTR["width"], INTR["height"], 0.4, 4.0,
    )
    both = (d_np > 0) & (d_nat > 0)
    assert both.sum() > 500
    np.testing.assert_allclose(d_np[both], d_nat[both], atol=1e-4)
    assert ((d_np > 0) != (d_nat > 0)).sum() <= 5
    c_np_u8 = np.clip(np.round(c_np), 0, 255).astype(np.uint8)
    diff = np.abs(c_np_u8.astype(int) - c_nat.astype(int))[both]
    assert (diff > 1).mean() < 0.01


def test_virtual_scan_raster_end_to_end(tmp_path):
    half = 1.0
    verts = np.array(
        [[-half, -half, 0], [half, -half, 0], [half, half, 0], [-half, half, 0]], np.float32,
    )
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    colors = np.full((4, 3), 180, np.uint8)
    traj = scan.orbit_trajectory(np.zeros(3), radius=1.5, height=1.2, num_frames=6)
    inc, cmp_ = str(tmp_path / "room__inc__0"), str(tmp_path / "room__cmp__0")
    scan.virtual_scan(verts, faces, colors, traj, inc, cmp_,
                      fusion_cfg=fusion.FusionConfig(voxelsize=0.05),
                      scan_cfg=scan.ScanConfig(renderer="raster"), seed=3, device="cpu")
    cmp_data = formats.load_sdf(cmp_ + ".sdf", load_color=True, color_path=cmp_ + ".colors")
    assert len(cmp_data.locs) > 0
    assert cmp_data.colors is not None


@pytest.mark.parametrize("shade", [False, True])
def test_native_rasterizer_is_the_jax_packages_to_the_bit(shade):
    """Both packages' native libraries (one source, built apart) on a
    room mesh from several cameras: depth and colour identical."""
    assert raster._build_native() is not None and jraster._build_native() is not None
    verts, faces, colors = TF.room_mesh(seed=2, boxes=6)
    fshade = (np.random.default_rng(3).uniform(0.5, 1.0, len(faces)).astype(np.float32)
              if shade else None)
    covered = 0
    for angle in (0.0, 1.3, 2.9, 4.4):
        cam = TF.room_camera(angle=angle)
        args = (verts, faces, colors, cam, 60.0, 60.0, 32.0, 24.0, 64, 48, 0.4, 4.0)
        d1, c1 = raster.rasterize_depth(*args, face_shade=fshade)
        d2, c2 = jraster.rasterize_depth(*args, face_shade=fshade)
        assert np.array_equal(d1.view(np.int32), d2.view(np.int32))
        assert c1.dtype == c2.dtype == np.uint8 and np.array_equal(c1, c2)
        covered += int((d1 > 0).sum())
    assert covered > 4 * 64 * 48 // 2


def test_numpy_fallback_is_the_jax_packages_to_the_bit():
    verts, faces, colors, shade = _five_vertex_mesh()
    args = (verts.copy(), colors.astype(np.float32), faces.astype(np.int32), shade,
            60.0, 60.0, 32.0, 24.0, 64, 48, 0.4, 4.0)
    d1, c1 = raster._rasterize_numpy(*args)
    d2, c2 = jraster._rasterize_numpy(*args)
    assert (d1 > 0).sum() > 500
    assert np.array_equal(d1.view(np.int32), d2.view(np.int32))
    assert np.array_equal(c1.view(np.int32), c2.view(np.int32))
