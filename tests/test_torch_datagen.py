"""The port's dataset generation (spsg_tpu_torch/datagen/) on the CPU, each
test of tests/test_datagen.py ported and held against the JAX package's
function on the same inputs: the numpy copies give identical arrays and
files; what fuses (virtual_scan, fuse_sens) writes .sdf / .colors / .knw
files identical to the JAX package's, or within the fusion tolerance of
tests/test_torch_fusion.py where a voxel lies on a pixel boundary
(assert_same_files)."""

import json
import os
import struct

import numpy as np
import pytest

from spsg_tpu.datagen import chunks as jchunks
from spsg_tpu.datagen import fusion as jfusion
from spsg_tpu.datagen import params as jparams
from spsg_tpu.datagen import scan as jscan
from spsg_tpu.datagen import semantics as jsem
from spsg_tpu.datagen import sens as jsens
from spsg_tpu_torch.data import formats
from spsg_tpu_torch.datagen import chunks, fusion, params, scan, semantics, sens
from spsg_tpu_torch.ops import mesh as mesh_ops

import test_torch_fusion as TF

# the share of a grid whose voxels may differ (tests/test_torch_fusion.py)
DIFFERING_SHARE = 1e-4


def _plane_mesh(z0=0.5, half=1.0):
    verts = np.array([[-half, -half, z0], [half, -half, z0], [half, half, z0],
                      [-half, half, z0]], np.float32)
    return verts, np.array([[0, 1, 2], [0, 2, 3]], np.int64)


def _load_dense(stem):
    """A scene (sidecar .colors / .knw) or a chunk (known, colours and
    semantics inline) as dense grids: (header, sdf with +inf where not
    stored, {name: dense grid})."""
    path = stem + ".sdf"
    if os.path.isfile(stem + ".colors"):
        data = formats.load_sdf(path, load_color=True, color_path=stem + ".colors")
        grids = dict(colors=data.colors)
        if os.path.isfile(stem + ".knw"):
            grids["known"] = formats.load_known(stem + ".knw")[0]
    else:
        data = formats.load_sdf(path, load_known=True, load_color=True,
                                load_semantic="__sem__" in os.path.basename(stem))
        grids = dict(known=data.known, colors=data.colors, semantics=data.semantics)
    sdf = formats.sparse_to_dense(data.locs, data.sdf, data.dims, np.inf)
    return data, sdf, {k: v for k, v in grids.items() if v is not None}


def scan_boundary(dims, world2grid, cams, intrinsics):
    """Union over a scan's frames of the voxels of a grid (``dims``,
    ``world2grid``) on a pixel boundary (test_torch_fusion.py::_boundary_voxels)."""
    out = np.zeros(dims, bool)
    for cam in cams:
        out |= TF._boundary_voxels(dims, None, intrinsics, cam, world2grid)
    return out


def _assert_close_grid(a, b, views):
    """Two grids (scene or chunk) of one fusion, where their files are not
    identical: stored voxels, values (within 1e-6 m), known codes, colours
    and labels agree but on voxels on a pixel boundary of the scan's frames
    (``views``: cameras, intrinsics), or, without views, on at most
    DIFFERING_SHARE of the grid."""
    da, sa, ga = _load_dense(a)
    db, sb, gb = _load_dense(b)
    assert da.dims == db.dims and da.voxelsize == db.voxelsize and ga.keys() == gb.keys()
    np.testing.assert_array_equal(da.world2grid, db.world2grid)
    differ = np.isfinite(sa) != np.isfinite(sb)
    both = np.isfinite(sa) & np.isfinite(sb)
    differ |= both & (np.abs(np.where(both, sa - sb, 0)) * da.voxelsize > 1e-6)
    for k, g in ga.items():
        bad = g != gb[k]
        differ |= bad.any(-1) if bad.ndim == 4 else bad
    if views is not None:
        boundary = scan_boundary(da.dims, da.world2grid, *views)
        assert not (differ & ~boundary).any(), (a, int((differ & ~boundary).sum()))
    else:
        assert differ.sum() <= DIFFERING_SHARE * differ.size, (a, int(differ.sum()))


def assert_same_files(dir_a, dir_b, views=None):
    """Every file of two output trees: the same names; identical bytes, or
    for the .sdf / .colors / .knw of a grid the fusion tolerance
    (_assert_close_grid); .npz arrays identical. Returns (files, grids
    not identical)."""
    names = sorted(os.path.relpath(os.path.join(r, f), dir_a)
                   for r, _, fs in os.walk(dir_a) for f in fs)
    names_b = sorted(os.path.relpath(os.path.join(r, f), dir_b)
                     for r, _, fs in os.walk(dir_b) for f in fs)
    assert names == names_b and names
    inexact = set()
    for name in names:
        pa, pb = os.path.join(dir_a, name), os.path.join(dir_b, name)
        if name.endswith(".npz"):
            za, zb = np.load(pa), np.load(pb)
            assert sorted(za.files) == sorted(zb.files)
            for k in za.files:
                assert np.array_equal(za[k], zb[k]), (name, k)
            continue
        if open(pa, "rb").read() == open(pb, "rb").read():
            continue
        stem, ext = os.path.splitext(pa)
        assert ext in (".sdf", ".colors", ".knw"), name
        inexact.add(stem)
    for stem in inexact:
        _assert_close_grid(stem, os.path.join(dir_b, os.path.relpath(stem, dir_a)), views)
    return len(names), len(inexact)


def test_fuse_plane_depth():
    """Straight-down views of a plane: the fused SDF matches the analytic
    distance near the surface (tests/test_datagen.py::test_fuse_plane_depth)."""
    cfg = fusion.FusionConfig(voxelsize=0.05)
    dims, w2g = fusion.grid_from_bounds([-0.4, -0.4, 0.0], [0.4, 0.4, 1.0], cfg)
    sc = scan.ScanConfig(width=128, height=96, fx=120.0, fy=120.0)
    cam = np.array([[1, 0, 0, 0], [0, -1, 0, 0], [0, 0, -1, 1.5], [0, 0, 0, 1]], np.float32)
    verts, faces = _plane_mesh(z0=0.5)
    pts = mesh_ops.sample_point_cloud(verts, faces, 200000, seed=0)
    depth, _ = scan.render_depth_from_points(pts, None, cam, sc)
    jdepth, _ = jscan.render_depth_from_points(pts, None, cam, sc)
    assert np.array_equal(depth, jdepth) and (depth > 0).mean() > 0.3
    intr = np.array([sc.fx, sc.fy, sc.width / 2, sc.height / 2])
    sdf = fusion.fuse_frames(dims, w2g, [(depth, None, intr, cam)], cfg, device="cpu")["sdf"]
    sdf = sdf.numpy()
    g = w2g @ np.array([0, 0, 0.5, 1.0])
    vz, vy, vx = int(round(g[2])), int(round(g[1])), int(round(g[0]))
    assert np.isfinite(sdf[vz, vy, vx]) and abs(sdf[vz, vy, vx]) < 0.06
    g2 = w2g @ np.array([0, 0, 0.6, 1.0])
    assert sdf[int(round(g2[2])), vy, vx] == pytest.approx(0.1, abs=0.06)


@pytest.mark.parametrize("renderer", ["raster", "splat"])
def test_virtual_scan_end_to_end_matches_the_jax_package(tmp_path, renderer):
    """A floor plane scanned on an orbit, frames exported: the __inc__ /
    __cmp__ files, the frames and the trajectory sidecar against the JAX
    package's virtual_scan on the same mesh; the files load and feed the
    chunk cutter."""
    verts, faces = _plane_mesh(z0=0.0, half=1.0)
    colors = np.full((len(verts), 3), 180, np.uint8)
    traj = scan.orbit_trajectory(np.zeros(3), radius=1.5, height=1.2, num_frames=8)
    out = {}
    for pkg, mod, cfg_mod, kw in (("port", scan, fusion, dict(device="cpu")),
                                  ("jax", jscan, jfusion, {})):
        d = tmp_path / pkg
        out[pkg] = mod.virtual_scan(
            verts, faces, colors, traj, str(d / "room__inc__0"), str(d / "room__cmp__0"),
            fusion_cfg=cfg_mod.FusionConfig(voxelsize=0.05),
            scan_cfg=mod.ScanConfig(renderer=renderer), seed=3,
            frame_export_dir=str(d / "frames"), **kw)
    assert out["port"][0] == out["jax"][0] and np.array_equal(out["port"][1], out["jax"][1])
    sc = scan.ScanConfig()
    views = (traj, [sc.fx, sc.fy, sc.width / 2, sc.height / 2])
    n, inexact = assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"), views)
    assert n == 2 * 3 + 1 + 3 * 8  # two scenes, the sidecar, 8 frames of 3 files
    inc = formats.load_sdf(str(tmp_path / "port" / "room__inc__0.sdf"))
    cmp_ = formats.load_sdf(str(tmp_path / "port" / "room__cmp__0.sdf"))
    assert len(cmp_.locs) >= len(inc.locs) > 0
    known, vs, _ = formats.load_known(str(tmp_path / "port" / "room__cmp__0.knw"))
    assert known.shape == cmp_.dims and vs == pytest.approx(0.05)
    files = chunks.cut_scene_to_chunks(
        str(tmp_path / "port" / "room__inc__0"), str(tmp_path / "port" / "room__cmp__0"),
        str(tmp_path / "chunks"), "room", chunk_dims=(16, 16, 16), min_surface_voxels=20)
    jfiles = jchunks.cut_scene_to_chunks(
        str(tmp_path / "port" / "room__inc__0"), str(tmp_path / "port" / "room__cmp__0"),
        str(tmp_path / "jchunks"), "room", chunk_dims=(16, 16, 16), min_surface_voxels=20)
    assert files and [os.path.basename(f) for f in files] == [os.path.basename(f) for f in jfiles]
    assert assert_same_files(str(tmp_path / "chunks"), str(tmp_path / "jchunks"))[1] == 0


def test_splat_semantics():
    w2g = np.eye(4)
    w2g[:3, :3] *= 10.0
    pts = np.array([[0.55, 0.35, 0.25]])
    labels = np.array([5])
    dense = semantics.splat_semantics(pts, labels, w2g, (8, 8, 8))
    assert dense[2, 4, 6] == 5 or dense[3, 4, 6] == 5
    assert dense[2, 3, 5] == 5
    assert (dense == 5).sum() >= 8
    assert (dense == semantics.UNLABELED).sum() > 400
    rng = np.random.default_rng(0)
    pts = rng.uniform(0, 0.8, (500, 3))
    labels = rng.integers(0, 20, 500)
    assert np.array_equal(semantics.splat_semantics(pts, labels, w2g, (8, 8, 8)),
                          jsem.splat_semantics(pts, labels, w2g, (8, 8, 8)))


def test_extend_sdf_file_roundtrip(tmp_path):
    dims = (8, 8, 8)
    locs = np.array([[2, 2, 2], [3, 3, 3]], np.int32)
    sdf = np.array([0.5, -0.5], np.float32)
    w2g = np.eye(4, dtype=np.float32) * 10.0
    w2g[3, 3] = 1.0
    src = str(tmp_path / "c__cmp__0.sdf")
    formats.save_sdf(src, dims, 0.1, w2g, locs, sdf, known=np.zeros(dims, np.uint8),
                     colors=np.zeros(dims + (3,), np.uint8))
    pts = np.array([[0.25, 0.25, 0.25], [0.41, 0.52, 0.33]])
    semantics.extend_sdf_file(src, str(tmp_path / "c__sem__0.sdf"), pts, np.array([7, 3]))
    jsem.extend_sdf_file(src, str(tmp_path / "j__sem__0.sdf"), pts, np.array([7, 3]))
    data = formats.load_sdf(str(tmp_path / "c__sem__0.sdf"), load_known=True, load_color=True,
                            load_semantic=True)
    assert data.semantics is not None and (data.semantics == 7).sum() >= 8
    assert (tmp_path / "c__sem__0.sdf").read_bytes() == (tmp_path / "j__sem__0.sdf").read_bytes()


def write_labeled_ply(path, verts, faces, cats):
    """A region-segmentation PLY: binary vertices, faces with a category."""
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0", f"element vertex {len(verts)}",
               "property float x", "property float y", "property float z",
               f"element face {len(faces)}", "property list uchar int vertex_indices",
               "property int category_id", "end_header"]
        f.write(("\n".join(hdr) + "\n").encode())
        f.write(np.asarray(verts, "<f4").tobytes())
        for face, cat in zip(faces, cats):
            f.write(struct.pack("B", 3))
            f.write(np.asarray(face, "<i4").tobytes())
            f.write(struct.pack("<i", int(cat)))


def test_labeled_ply_roundtrip_and_sampling(tmp_path):
    verts = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 0, 2], [1, 0, 2], [1, 1, 2]],
                     np.float32)
    faces = np.array([[0, 1, 2], [3, 4, 5]], np.int32)
    cats = np.array([5, 12], np.int32)
    p = str(tmp_path / "region.ply")
    write_labeled_ply(p, verts, faces, cats)
    v2, f2, c2 = semantics.read_labeled_ply(p)
    for a, b in zip((v2, f2, c2), jsem.read_labeled_ply(p)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    np.testing.assert_allclose(v2, verts)
    np.testing.assert_array_equal(f2, faces)
    np.testing.assert_array_equal(c2, cats)
    pts, labels = semantics.sample_labeled_mesh(v2, f2, c2, samples_per_face=50)
    jpts, jlabels = jsem.sample_labeled_mesh(v2, f2, c2, samples_per_face=50)
    assert np.array_equal(pts, jpts) and np.array_equal(labels, jlabels)
    assert len(pts) == 100
    np.testing.assert_array_equal(labels[np.abs(pts[:, 2]) < 1e-5], 5)
    np.testing.assert_array_equal(labels[np.abs(pts[:, 2] - 2) < 1e-5], 12)


def test_sens_roundtrip_and_fusion(tmp_path):
    """.sens write -> read -> fuse (ScanNet SensorData format), against the
    JAX package's reader and fuse_sens on the same file."""
    verts, faces = _plane_mesh(z0=0.5)
    pts = mesh_ops.sample_point_cloud(verts, faces, 100000, seed=0)
    sc = scan.ScanConfig(width=64, height=48, fx=60.0, fy=60.0)
    cams, depths = [], []
    for k in range(3):
        cam = np.array([[1, 0, 0, 0.05 * k], [0, -1, 0, 0], [0, 0, -1, 1.6], [0, 0, 0, 1]],
                       np.float32)
        cams.append(cam)
        depths.append(scan.render_depth_from_points(pts, None, cam, sc)[0])
    colors = np.random.default_rng(0).integers(0, 256, (3, 48, 64, 3)).astype(np.uint8)
    intr = np.array([[60.0, 0, 32, 0], [0, 60.0, 24, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32)
    p, jp = str(tmp_path / "scan.sens"), str(tmp_path / "jscan.sens")
    sens.write_sens(p, np.stack(depths), colors, np.stack(cams), intr)
    jsens.write_sens(jp, np.stack(depths), colors, np.stack(cams), intr)
    assert open(p, "rb").read() == open(jp, "rb").read()

    r, jr = sens.SensReader(p), jsens.SensReader(p)
    assert r.num_frames == 3 and r.depth_width == 64 and r.depth_height == 48
    np.testing.assert_allclose(r.depth_intrinsics_params, [60, 60, 32, 24])
    frames, jframes = list(r.frames()), list(jr.frames())
    for f, jf in zip(frames, jframes):
        for a, b in zip(f, jf):
            assert np.array_equal(a, b)
    np.testing.assert_allclose(frames[0][0], depths[0], atol=1e-3)
    np.testing.assert_allclose(frames[2][2], cams[2], atol=1e-6)
    r.close()
    jr.close()

    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    dims, w2g = sens.fuse_sens(p, str(tmp_path / "port" / "fused"), voxelsize=0.05,
                               device="cpu")
    jdims, jw2g = jsens.fuse_sens(p, str(tmp_path / "jax" / "fused"), voxelsize=0.05)
    assert dims == jdims and np.array_equal(w2g, jw2g)
    assert len(formats.load_sdf(str(tmp_path / "port" / "fused.sdf")).locs) > 0
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"),
                      (cams, [60.0, 60.0, 32.0, 24.0]))


def test_parameter_file_reader(tmp_path):
    p = str(tmp_path / "zParams.txt")
    open(p, "w").write(
        """
s_bDebugVis = false;
s_voxelSize = 0.05f;	//in m
s_renderWidth = 160;	// render width
s_chanceDropFrames = 0.7f;
s_sceneFileList = "../fileLists/rooms.txt";
s_scenePadding = 6; 		//on each side
"""
    )
    d = params.load_parameter_file(p)
    assert d == jparams.load_parameter_file(p)
    assert d["s_bDebugVis"] is False and d["s_voxelSize"] == 0.05
    assert d["s_renderWidth"] == 160 and d["s_sceneFileList"] == "../fileLists/rooms.txt"
    fc, sc = params.scan_configs_from_params(d)
    jfc, jsc = jparams.scan_configs_from_params(d)
    assert fc.voxelsize == 0.05 and fc.scene_pad == 6
    assert sc.width == 160 and sc.chance_drop_frames == 0.7
    assert type(fc).__module__ == "spsg_tpu_torch.datagen.fusion"
    assert vars(fc) == vars(jfc) and vars(sc) == vars(jsc)


def test_matterport_semseg_vsegs_ingestion(tmp_path):
    """Raw Matterport annotation pair -> per-vertex labels -> __sem__ chunks
    through the port's CLI (--device cpu), against the JAX CLI's files."""
    from spsg_tpu.cli import datagen as jdg
    from spsg_tpu_torch.cli import datagen as dg

    verts = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]], np.float32)
    faces = np.array([[0, 1, 2], [0, 2, 3]], np.int64)
    mesh_path = str(tmp_path / "scene.ply")
    mesh_ops.save_ply(mesh_path, verts, faces, np.full((4, 3), 99, np.uint8))
    vsegs = {"params": {"kThresh": "0.01"}, "segIndices": [7, 7, 12, -1]}
    semseg = {"sceneId": "scene", "appId": "test", "segGroups": [
        {"id": 0, "objectId": 0, "label": "bed", "segments": [7]},
        {"id": 1, "objectId": 1, "label": "wall", "segments": [12]}]}
    (tmp_path / "scene.vsegs.json").write_text(json.dumps(vsegs))
    (tmp_path / "scene.semseg.json").write_text(json.dumps(semseg))
    mapping = tmp_path / "category_mapping.tsv"
    mapping.write_text("index\traw_category\teigen13id\n1\tbed\t1\n2\twall\t12\n3\tdoor\t4\n")
    args = (str(tmp_path / "scene.vsegs.json"), str(tmp_path / "scene.semseg.json"),
            str(mapping))
    vlabels = semantics.vertex_labels_from_segmentation(*args)
    np.testing.assert_array_equal(vlabels, [1, 1, 12, 14])
    assert np.array_equal(vlabels, jsem.vertex_labels_from_segmentation(*args))
    flabels = semantics.face_labels_from_vertex_labels(faces, vlabels)
    np.testing.assert_array_equal(flabels, [1, 1])

    for pkg, cli, extra in (("port", dg, ["--device", "cpu"]), ("jax", jdg, [])):
        root = tmp_path / pkg
        scans, chunks_dir = str(root / "scans"), str(root / "chunks")
        cli.main(["scan", "--mesh", mesh_path, "--output_dir", scans, "--voxelsize", "0.08",
                  "--num_frames", "6"] + extra)
        cli.main(["chunk", "--inc", os.path.join(scans, "scene__inc__0"),
                  "--cmp", os.path.join(scans, "scene__cmp__0"), "--output_dir", chunks_dir,
                  "--name", "scene", "--chunk_dims", "16", "16", "16",
                  "--min_surface_voxels", "20"])
        cli.main(["semantics", "--vsegs", args[0], "--semseg", args[1], "--mesh", mesh_path,
                  "--mapping", str(mapping),
                  "--sdf_glob", os.path.join(chunks_dir, "*__cmp__*.sdf"),
                  "--samples_per_face", "400"])
    chunks_dir = str(tmp_path / "port" / "chunks")
    sem_chunks = [f for f in os.listdir(chunks_dir) if "__sem__" in f]
    assert sem_chunks
    data = formats.load_sdf(os.path.join(chunks_dir, sem_chunks[0]), load_semantic=True)
    assert {1, 12} & set(np.unique(data.semantics))
    assert_same_files(str(tmp_path / "port"), str(tmp_path / "jax"))
