"""Cut fused room scans into fixed-size training chunks.

The training data consumed by the reference (chunk ``__inc__``/``__cmp__``
.sdf files with inline known + dense colors, data_util.py:93-132) is produced
by cutting whole-room scans into 64x64x128 windows. This tool performs that
step on the outputs of :mod:`spsg_tpu_torch.datagen.scan` (scene-layout .sdf +
.colors + .knw)."""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np

from ..data import formats


def _load_scene(prefix: str):
    data = formats.load_sdf(
        prefix + ".sdf",
        load_color=os.path.isfile(prefix + ".colors"),
        color_path=prefix + ".colors" if os.path.isfile(prefix + ".colors") else None,
    )
    known = None
    if os.path.isfile(prefix + ".knw"):
        known, _, _ = formats.load_known(prefix + ".knw")
    return data, known


def chunk_visible_frames(
    w2g_chunk: np.ndarray,
    chunk_dims_zyx: Tuple[int, int, int],
    cam2world: np.ndarray,  # (F, 4, 4)
    intrinsics: np.ndarray,  # [fx, fy, mx, my]
    image_dims: Tuple[int, int] = (320, 256),  # (w, h)
    depth_range: Tuple[float, float] = (0.1, 6.0),
    min_frames: int = 30,
) -> np.ndarray:
    """Frame ids viewing a chunk, nearest first (reference frame selection:
    trajectory frames whose frustum sees the room OBB plus the 30 closest as
    fallback, datagen/src/Scene.h:51-96 via Visualizer.h:25-34).

    A frame "sees" the chunk when (a) any of the chunk AABB's 8 world-space
    corners or its center projects inside the image within depth_range, (b)
    any sample of the camera frustum (a 5x4 pixel grid at 4 depths) lands
    inside the AABB — catching close-up views where the chunk fills the
    image and every corner projects outside it — or (c) the camera sits
    inside the AABB."""
    cz, cy, cx = chunk_dims_zyx
    g2w = np.linalg.inv(w2g_chunk)
    corners_g = np.array(
        [[x, y, z, 1.0] for z in (0, cz) for y in (0, cy) for x in (0, cx)]
        + [[cx / 2, cy / 2, cz / 2, 1.0]],
        np.float32,
    )
    pts_w = corners_g @ g2w.T  # (9, 4) world, xyz order
    fx, fy, mx, my = (float(v) for v in intrinsics[:4])
    w, h = image_dims
    F = cam2world.shape[0]
    vis = np.zeros(F, bool)
    cam_pos = cam2world[:, :3, 3]
    lo_w = pts_w[:8, :3].min(0)
    hi_w = pts_w[:8, :3].max(0)
    inside = np.all((cam_pos >= lo_w) & (cam_pos <= hi_w), axis=1)
    # frustum sample points in camera space: pixel grid x depth levels
    us = np.linspace(0, w - 1, 5)
    vs = np.linspace(0, h - 1, 4)
    ds = np.linspace(max(depth_range[0], 0.2), depth_range[1], 4)
    uu, vv, dd = np.meshgrid(us, vs, ds, indexing="ij")
    fr_cam = np.stack(
        [(uu - mx) / fx * dd, (vv - my) / fy * dd, dd], axis=-1
    ).reshape(-1, 3)
    for fi in range(F):
        w2c = np.linalg.inv(cam2world[fi])
        p = pts_w[:, :3] @ w2c[:3, :3].T + w2c[:3, 3]
        z = p[:, 2]
        ok = (z > depth_range[0]) & (z < depth_range[1])
        u = fx * p[:, 0] / np.maximum(z, 1e-9) + mx
        v = fy * p[:, 1] / np.maximum(z, 1e-9) + my
        ok &= (u >= 0) & (v >= 0) & (u < w) & (v < h)
        hit = inside[fi] or bool(ok.any())
        if not hit:
            fr_w = fr_cam @ cam2world[fi][:3, :3].T + cam_pos[fi]
            hit = bool(np.any(np.all((fr_w >= lo_w) & (fr_w <= hi_w), axis=1)))
        vis[fi] = hit
    center_w = pts_w[8, :3]
    dist = np.linalg.norm(cam_pos - center_w, axis=1)
    order = np.argsort(dist, kind="stable")
    chosen = [int(f) for f in order if vis[f]]
    if len(chosen) < min_frames:  # closest-frames fallback (Scene.h:84-96)
        extra = [int(f) for f in order if not vis[f]]
        chosen = chosen + extra[: min_frames - len(chosen)]
    return np.asarray(chosen, np.int32)


def cut_scene_to_chunks(
    inc_prefix: str,
    cmp_prefix: str,
    output_dir: str,
    name: str,
    chunk_dims: Tuple[int, int, int] = (128, 64, 64),  # zyx
    stride: Optional[Tuple[int, int]] = None,  # (y, x); default = chunk size
    min_surface_voxels: int = 500,
    trunc_store: float = 6.0,
    frame_info_dir: Optional[str] = None,
    image_dims: Optional[Tuple[int, int]] = None,
) -> List[str]:
    """Write ``<name>__inc__<k>.sdf`` / ``__cmp__<k>.sdf`` chunk files (inline
    known + colors) for every sufficiently-occupied window. Returns the list
    of incomplete chunk paths.

    When the scan left a ``<cmp_prefix>.traj.npz`` trajectory sidecar (see
    scan.save_trajectory), a ``<name>__cmp__<k>.txt`` frame-association list
    is written per chunk into ``frame_info_dir`` (default: output_dir) in the
    loader's format (one frame id per line, reference data_util.py:764-771),
    closing the datagen -> 2D-loss-training loop."""
    os.makedirs(output_dir, exist_ok=True)
    inc, _ = _load_scene(inc_prefix)
    cmp_, known = _load_scene(cmp_prefix)
    traj = None
    if os.path.isfile(cmp_prefix + ".traj.npz"):
        traj = np.load(cmp_prefix + ".traj.npz")
        if image_dims is None:
            # the scan renders with principal point at the image center
            # (scan.py ScanConfig), so the true raster size is (2mx, 2my)
            intr = traj["intrinsics"]
            image_dims = (int(round(2 * intr[2])), int(round(2 * intr[3])))
        if frame_info_dir is None:
            frame_info_dir = output_dir
        os.makedirs(frame_info_dir, exist_ok=True)
    dims = cmp_.dims
    cz, cy, cx = chunk_dims
    sy, sx = stride if stride is not None else (cy, cx)

    inc_dense = formats.sparse_to_dense(inc.locs, inc.sdf[:, None], inc.dims, np.inf)
    cmp_dense = formats.sparse_to_dense(cmp_.locs, cmp_.sdf[:, None], dims, np.inf)
    inc_colors = inc.colors if inc.colors is not None else np.zeros(inc.dims + (3,), np.uint8)
    cmp_colors = cmp_.colors if cmp_.colors is not None else np.zeros(dims + (3,), np.uint8)
    if known is None:
        known = np.full(dims, 255, np.uint8)

    out_files = []
    k = 0
    voxelsize = cmp_.voxelsize
    for y in range(0, max(1, dims[1] - cy // 2), sy):
        for x in range(0, max(1, dims[2] - cx // 2), sx):
            win_cmp = np.full(chunk_dims, np.inf, np.float32)
            win_inc = np.full(chunk_dims, np.inf, np.float32)
            win_kn = np.full(chunk_dims, 255, np.uint8)
            win_ccol = np.zeros(chunk_dims + (3,), np.uint8)
            win_icol = np.zeros(chunk_dims + (3,), np.uint8)
            fz = min(dims[0], cz)
            fy = min(dims[1] - y, cy)
            fx = min(dims[2] - x, cx)
            if fy <= 0 or fx <= 0:
                continue
            win_cmp[:fz, :fy, :fx] = cmp_dense[:cz, y : y + fy, x : x + fx]
            win_inc[:fz, :fy, :fx] = inc_dense[:cz, y : y + fy, x : x + fx]
            win_kn[:fz, :fy, :fx] = known[:cz, y : y + fy, x : x + fx]
            win_ccol[:fz, :fy, :fx] = cmp_colors[:cz, y : y + fy, x : x + fx]
            win_icol[:fz, :fy, :fx] = inc_colors[:cz, y : y + fy, x : x + fx]

            with np.errstate(invalid="ignore"):
                n_surf = int(np.sum(np.abs(win_cmp) < 3.0))
            if n_surf < min_surface_voxels:
                continue

            # chunk-local world2grid: translate the scene transform
            w2g = cmp_.world2grid.copy()
            w2g[0, 3] -= x
            w2g[1, 3] -= y

            def save(tag, grid, colors):
                with np.errstate(invalid="ignore"):
                    m = np.isfinite(grid) & (np.abs(grid) <= trunc_store)
                locs = np.argwhere(m).astype(np.int32)
                path = os.path.join(output_dir, f"{name}__{tag}__{k}.sdf")
                formats.save_sdf(
                    path, chunk_dims, voxelsize, w2g, locs, grid[m],
                    known=win_kn, colors=colors,
                )
                return path

            p_inc = save("inc", win_inc, win_icol)
            save("cmp", win_cmp, win_ccol)
            if traj is not None:
                ids = chunk_visible_frames(
                    w2g, chunk_dims, traj["cam2world"], traj["intrinsics"],
                    image_dims=image_dims,
                    depth_range=(0.1, 6.0),
                )
                ids = traj["frame_ids"][ids]
                with open(
                    os.path.join(frame_info_dir, f"{name}__cmp__{k}.txt"), "w"
                ) as f:
                    f.write("\n".join(str(int(i)) for i in ids) + "\n")
            out_files.append(p_inc)
            k += 1
    return out_files
