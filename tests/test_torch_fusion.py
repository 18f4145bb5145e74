"""The port's TSDF fusion (spsg_tpu_torch/datagen/fusion.py) against the JAX
package's (spsg_tpu/datagen/fusion.py) on the CPU: grid_from_bounds and
known_encoding identical; integrate_plain against the JAX integrate on the
same frames and grids; save_grid's files byte for byte; fuse_frames.

Tolerance of integrate. Both packages compute the voxel -> camera map in
float32 (the JAX package on its device, the port on the host, either may be
an ulp off the other), and XLA on the CPU contracts a * b + c into fused
multiply-adds where PyTorch rounds twice. A voxel whose u or v lies within
rounding of a .5 boundary can therefore read the neighbouring pixel. Those
voxels are found in float64 (|frac(u) - 0.5| < 1e-3 px, u = fx px / pz + mx,
in front of the camera): only they may differ, and the voxels that differ at
all must be at most 1e-4 of the grid. On every other voxel the sdf agrees
within 1e-6 m and weight, colour and free_ctr are identical (the depth weight
follows XLA's arithmetic: fusion.one_minus_depth01). Measured on these
frames: no voxel differs in any field, the sdf agrees within 6e-8 m; the
boundary sets hold 0.23 % of the room grids and 4.7 % of the plane's (a
camera square to an axis-aligned grid puts whole slices on a boundary), so
the 1e-4 bound is held on the voxels that differ, not on the boundary set
(ROADMAP.md Queue C)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.datagen import fusion as jfusion
from spsg_tpu.datagen import raster as jraster
from spsg_tpu.datagen import scan as jscan
from spsg_tpu.ops import mesh as jmesh
from spsg_tpu_torch.datagen import fusion

CFG = fusion.FusionConfig(voxelsize=0.05)
JCFG = jfusion.FusionConfig(voxelsize=0.05)
FIELDS = ("sdf", "weight", "color", "free_ctr")
# the largest share of the grid that may differ at all (the docstring's rule)
DIFFERING_SHARE = 1e-4


def _plane_frame():
    """tests/test_datagen.py::test_fuse_plane_depth's frame: a plane 1 m
    below a camera looking straight down, 128x96."""
    verts = np.array([[-1, -1, 0.5], [1, -1, 0.5], [1, 1, 0.5], [-1, 1, 0.5]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    sc = jscan.ScanConfig(width=128, height=96, fx=120.0, fy=120.0)
    cam = np.array([[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 1.5], [0, 0, 0, 1]], np.float32)
    pts = jmesh.sample_point_cloud(verts, faces, 200000, seed=0)
    depth, _ = jscan.render_depth_from_points(pts, None, cam, sc)
    intr = np.array([sc.fx, sc.fy, sc.width / 2, sc.height / 2], np.float32)
    return depth.astype(np.float32), None, intr, cam, ([-0.4, -0.4, 0.0], [0.4, 0.4, 1.0])


def room_mesh(seed=0, size=(2.0, 1.6, 1.2), boxes=4):
    """Floor, four walls and a few boxes, vertex colours from ``seed``."""
    rng = np.random.default_rng(seed)
    sx, sy, sz = size
    verts, faces = [], []

    def quad(a, b, c, d):
        n = sum(len(v) for v in verts)
        verts.append(np.array([a, b, c, d], np.float32))
        faces.extend([[n, n + 1, n + 2], [n, n + 2, n + 3]])

    quad([0, 0, 0], [sx, 0, 0], [sx, sy, 0], [0, sy, 0])
    quad([0, 0, 0], [0, 0, sz], [sx, 0, sz], [sx, 0, 0])
    quad([0, sy, 0], [sx, sy, 0], [sx, sy, sz], [0, sy, sz])
    quad([0, 0, 0], [0, sy, 0], [0, sy, sz], [0, 0, sz])
    quad([sx, 0, 0], [sx, 0, sz], [sx, sy, sz], [sx, sy, 0])
    for _ in range(boxes):
        x0, y0 = rng.uniform(0.2, sx - 0.6), rng.uniform(0.2, sy - 0.6)
        w, d, h = rng.uniform(0.2, 0.4, 3)
        x1, y1 = x0 + w, y0 + d
        quad([x0, y0, h], [x1, y0, h], [x1, y1, h], [x0, y1, h])
        quad([x0, y0, 0], [x1, y0, 0], [x1, y0, h], [x0, y0, h])
        quad([x0, y1, 0], [x0, y1, h], [x1, y1, h], [x1, y1, 0])
        quad([x0, y0, 0], [x0, y0, h], [x0, y1, h], [x0, y1, 0])
        quad([x1, y0, 0], [x1, y1, 0], [x1, y1, h], [x1, y0, h])
    verts = np.concatenate(verts)
    colors = rng.integers(0, 256, (len(verts), 3)).astype(np.uint8)
    return verts, np.array(faces, np.int64), colors


def room_camera(size=(2.0, 1.6, 1.2), angle=0.3):
    """A camera in the room's middle, looking outward and down."""
    eye = np.array([size[0] / 2, size[1] / 2, size[2] * 0.8])
    fwd = np.array([np.cos(angle), np.sin(angle), -0.5])
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    cam = np.eye(4, dtype=np.float32)
    cam[:3, 0], cam[:3, 1], cam[:3, 2], cam[:3, 3] = right, np.cross(fwd, right), fwd, eye
    return cam


def _room_frame(seed=1, angle=0.3):
    """A rasterized room frame (64x48) with colour, NaN and 0 holes and depths
    below 0.4 m and beyond 4.0 m."""
    verts, faces, colors = room_mesh(seed)
    cam = room_camera(angle=angle)
    intr = np.array([60.0, 60.0, 32.0, 24.0], np.float32)
    depth, color = jraster.rasterize_depth(verts, faces, colors, cam, *intr, 64, 48, 0.1, 10.0)
    rng = np.random.default_rng(seed)
    depth = depth.copy()
    depth[rng.random(depth.shape) < 0.05] = 0.0
    depth[rng.random(depth.shape) < 0.05] = np.nan
    depth[rng.random(depth.shape) < 0.03] = 0.3
    depth[rng.random(depth.shape) < 0.03] = 4.5
    assert np.isfinite(depth).any() and (depth > 4.0).any() and ((depth > 0) & (depth < 0.4)).any()
    bounds = (verts.min(0), verts.max(0))
    return depth.astype(np.float32), color.astype(np.float32), intr, cam, bounds


def _boundary_voxels(shape, depth_shape, intr, cam, w2g):
    """Voxels whose u or v lies within 1e-3 px of a rounding boundary, in
    float64."""
    Z, Y, X = shape
    zz, yy, xx = np.meshgrid(np.arange(Z), np.arange(Y), np.arange(X), indexing="ij")
    m = np.linalg.inv(np.asarray(cam, np.float64)) @ np.linalg.inv(np.asarray(w2g, np.float64))
    p = [m[r, 0] * xx + m[r, 1] * yy + m[r, 2] * zz + m[r, 3] for r in range(3)]
    with np.errstate(divide="ignore", invalid="ignore"):
        u = intr[0] * p[0] / p[2] + intr[2]
        v = intr[1] * p[1] / p[2] + intr[3]
    near = lambda a: np.abs(a - np.floor(a) - 0.5) < 1e-3
    return (near(u) | near(v)) & (p[2] > 0)


def _start_grid(dims, mixed, seed=0):
    """Numpy grid: empty, or (``mixed``) -inf voxels beside finite ones of
    weight 252 (so one frame takes the first-observation, merge and 255-cap
    branches: a frame adds 1 to 4.5)."""
    g = {k: np.asarray(v) for k, v in jfusion.make_grid(dims).items()}
    if mixed:
        rng = np.random.default_rng(seed)
        seen = rng.random(dims) < 0.5
        g["sdf"] = np.where(seen, rng.uniform(-0.2, 0.2, dims), -np.inf).astype(np.float32)
        g["weight"] = np.where(seen, 252.0, 0.0).astype(np.float32)
        g["color"] = np.where(seen[..., None], rng.integers(0, 256, dims + (3,)), 0).astype(
            np.float32)
        g["free_ctr"] = rng.integers(0, 5, dims).astype(np.int32)
    return g


def _run_both(grid_np, depth, color, intr, cam, w2g):
    jg = jfusion.integrate({k: jnp.asarray(v) for k, v in grid_np.items()}, jnp.asarray(depth),
                           None if color is None else jnp.asarray(color), jnp.asarray(intr),
                           jnp.asarray(cam), jnp.asarray(w2g), JCFG)
    tg = {k: torch.from_numpy(v.copy()) for k, v in grid_np.items()}
    out = fusion.integrate(tg, torch.from_numpy(depth),
                           None if color is None else torch.from_numpy(color), intr, cam, w2g, CFG)
    assert out is tg  # in place
    return {k: np.asarray(v) for k, v in jg.items()}, {k: v.numpy() for k, v in tg.items()}


def _assert_fusion_close(ref, got, boundary):
    """Outside ``boundary``: sdf within 1e-6, the rest identical; voxels that
    differ at all at most DIFFERING_SHARE of the grid."""
    differ = np.zeros(boundary.shape, bool)
    for k in FIELDS:
        a, b = ref[k], got[k]
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k == "sdf":
            fa, fb = np.isfinite(a), np.isfinite(b)
            with np.errstate(invalid="ignore"):
                bad = (fa != fb) | (fa & fb & (np.abs(a - b) > 1e-6)) | (~fa & ~fb & (a != b))
        else:
            bad = a != b
            if bad.ndim == 4:
                bad = bad.any(-1)
        assert not (bad & ~boundary).any(), (k, int((bad & ~boundary).sum()))
        differ |= bad
    assert differ.mean() <= DIFFERING_SHARE, differ.mean()


CASES = {
    "plane": dict(frame=_plane_frame, mixed=False),
    "room": dict(frame=_room_frame, mixed=False),
    "room_on_mixed_grid": dict(frame=_room_frame, mixed=True),
    "room_without_colour": dict(frame=_room_frame, mixed=True, no_color=True),
    "colour_larger_than_depth": dict(frame=_room_frame, mixed=True, big_color=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_integrate_plain_matches_the_jax_integrate(case):
    kw = CASES[case]
    depth, color, intr, cam, bounds = kw["frame"]()
    if kw.get("no_color"):
        color = None
    if kw.get("big_color"):
        # a (H+5, W+7) colour image: the depth image's flat index reads it
        # unclipped, at another position than its own pixel
        rng = np.random.default_rng(5)
        color = rng.integers(0, 256, (depth.shape[0] + 5, depth.shape[1] + 7, 3)).astype(np.float32)
    dims, w2g = fusion.grid_from_bounds(*bounds, CFG)
    grid = _start_grid(dims, kw["mixed"])
    ref, got = _run_both(grid, depth, color, intr, cam, w2g)
    assert (ref["weight"] != grid["weight"]).any()
    if kw["mixed"]:
        upd = ref["weight"] != grid["weight"]
        seen = np.isfinite(grid["sdf"])
        # all three branches taken: first observation, merge, cap at 255
        assert (upd & ~seen).any() and (upd & seen).any() and (ref["weight"][upd] == 255).any()
    _assert_fusion_close(ref, got, _boundary_voxels(dims, depth.shape, intr, cam, w2g))


def test_colour_smaller_than_depth_is_clipped_to_its_last_pixel():
    depth, _, intr, cam, bounds = _room_frame()
    small = np.random.default_rng(2).integers(0, 256, (10, 10, 3)).astype(np.float32)
    dims, w2g = fusion.grid_from_bounds(*bounds, CFG)
    ref, got = _run_both(_start_grid(dims, False), depth, small, intr, cam, w2g)
    _assert_fusion_close(ref, got, _boundary_voxels(dims, depth.shape, intr, cam, w2g))
    # most voxels read past the colour's end: its last pixel
    seen = ref["weight"] > 0
    assert (got["color"][seen] == small[-1, -1]).all(-1).mean() > 0.5


def test_integrate_plain_on_two_frames_follows_the_jax_package():
    """The second frame merges into the first's voxels (weights summed, the
    colour blended)."""
    depth, color, intr, cam, bounds = _room_frame(seed=1, angle=0.3)
    depth2, color2, _, cam2, _ = _room_frame(seed=1, angle=0.5)
    dims, w2g = fusion.grid_from_bounds(*bounds, CFG)
    ref, got = _run_both(_start_grid(dims, False), depth, color, intr, cam, w2g)
    b1 = _boundary_voxels(dims, depth.shape, intr, cam, w2g)
    ref2, got2 = _run_both(ref, depth2, color2, intr, cam2, w2g)
    b2 = _boundary_voxels(dims, depth.shape, intr, cam2, w2g)
    assert (ref2["weight"] > ref["weight"])[ref["weight"] > 0].any()
    _assert_fusion_close(ref2, got2, b1 | b2)


def test_int_cast_of_far_projections_cannot_enter_the_image():
    """A voxel just in front of the camera plane (safe_z tiny) projects far
    outside the int32 range: the port decides in_img on the float, so no
    cast can bring it into the image whatever the platform's conversion."""
    depth = np.full((8, 8), 1.0, np.float32)
    intr = np.array([10.0, 10.0, 4.0, 4.0], np.float32)
    # grid voxel (0, 0, 0) at camera (1, 1, 1e-12): u = 10 * 1 / 1e-9 + 4
    w2g = np.eye(4, dtype=np.float32)
    cam = np.eye(4, dtype=np.float32)
    cam[:3, 3] = [-1.0, -1.0, -1e-12]
    grid = {k: torch.from_numpy(v.copy()) for k, v in _start_grid((1, 1, 1), False).items()}
    fusion.integrate(grid, torch.from_numpy(depth), None, intr, cam, w2g, CFG)
    assert grid["weight"].item() == 0 and grid["free_ctr"].item() == 0
    pz, flat, d, d_ok = fusion._project((1, 1, 1), torch.from_numpy(depth), intr, cam, w2g, CFG)
    assert not d_ok.any() and 0 <= int(flat) < depth.size


def test_grid_from_bounds_and_known_encoding_are_the_jax_packages():
    for cfg_kw, bounds in ((dict(voxelsize=0.05, scene_pad=2, height_pad=1),
                            ([0, 0, 0], [1.0, 0.5, 0.25])),
                           (dict(), ([-1.3, 0.2, -0.1], [4.7, 5.2, 2.7]))):
        d1, w1 = fusion.grid_from_bounds(*bounds, fusion.FusionConfig(**cfg_kw))
        d2, w2 = jfusion.grid_from_bounds(*bounds, jfusion.FusionConfig(**cfg_kw))
        assert d1 == d2 and w1.dtype == w2.dtype and np.array_equal(w1, w2)
    rng = np.random.default_rng(0)
    sdf = rng.uniform(-0.5, 0.5, (6, 7, 8)).astype(np.float32)
    sdf[rng.random(sdf.shape) < 0.2] = -np.inf
    for vs in (0.02, 0.05):
        k1, k2 = fusion.known_encoding(sdf, vs), jfusion.known_encoding(sdf, vs)
        assert k1.dtype == k2.dtype == np.uint8 and np.array_equal(k1, k2)


def test_save_grid_writes_the_jax_packages_files(tmp_path):
    """One fused grid through both save_grid: .sdf, .colors and .knw
    identical byte for byte."""
    depth, color, intr, cam, bounds = _room_frame()
    dims, w2g = fusion.grid_from_bounds(*bounds, CFG)
    grid = {k: np.asarray(v) for k, v in jfusion.integrate(
        jfusion.make_grid(dims), jnp.asarray(depth), jnp.asarray(color), jnp.asarray(intr),
        jnp.asarray(cam), jnp.asarray(w2g), JCFG).items()}
    jfusion.save_grid(str(tmp_path / "jax"), {k: jnp.asarray(v) for k, v in grid.items()}, w2g,
                      JCFG)
    fusion.save_grid(str(tmp_path / "port"), {k: torch.from_numpy(v) for k, v in grid.items()},
                     w2g, CFG)
    for ext in (".sdf", ".colors", ".knw"):
        a = (tmp_path / ("jax" + ext)).read_bytes()
        assert len(a) > 100 and a == (tmp_path / ("port" + ext)).read_bytes(), ext


def test_fuse_frames_matches_the_jax_package_and_keeps_the_grid_on_its_device():
    frames = [_room_frame(seed=1, angle=a) for a in (0.2, 0.6, 1.0)]
    dims, w2g = fusion.grid_from_bounds(*frames[0][4], CFG)
    seq = [(d, c.astype(np.uint8), i, cam) for d, c, i, cam, _ in frames]
    got = fusion.fuse_frames(dims, w2g, seq, CFG, device="cpu")
    assert all(v.device.type == "cpu" for v in got.values())
    ref = jfusion.fuse_frames(dims, w2g, seq, JCFG)
    boundary = np.zeros(dims, bool)
    for d, _, i, cam, _ in frames:
        boundary |= _boundary_voxels(dims, d.shape, i, cam, w2g)
    _assert_fusion_close({k: np.asarray(v) for k, v in ref.items()},
                         {k: v.numpy() for k, v in got.items()}, boundary)
    assert fusion.launch_counts["tsdf_integrate"] == 0  # the CPU takes the plain version


def test_integrate_without_a_gpu_raises_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fusion.make_grid((2, 2, 2))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        fusion.fuse_frames((2, 2, 2), np.eye(4), [])
