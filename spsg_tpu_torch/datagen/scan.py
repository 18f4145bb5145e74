"""Virtual scanning: render depth/color frames from meshes and drive the
incomplete/complete fusion pipeline (PyTorch counterpart of
``spsg_tpu/datagen/scan.py``; rebuild of the reference's Win32/D3D11
datagen app, datagen/src/Visualizer.cpp:99-219 + Scene.cpp:169-287 +
Fuser.cpp:21-186). Frames render through a native z-buffered triangle
rasterizer by default (datagen/raster.py — the reference's D3D11 fidelity:
every covered pixel filled, interpolated vertex colors); a vectorized
point-splat renderer remains as ``ScanConfig(renderer="splat")``.

Pipeline (Visualizer::process): per room, take the trajectory frames viewing
the room, randomly drop ``chance_drop_frames`` of them for the *incomplete*
scan (Visualizer.h:37-51, default 0.8 from zParametersScanMP.txt:48), fuse
the kept frames, save ``__inc__``; continue fusing the remaining frames and
save ``__cmp__``. Rendering is host code (numpy and the native rasterizer);
the fusion runs on ``device`` (K8 on a card), each frame's images uploaded
once and the grid kept there between the two saves."""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import fusion
from ..ops import mesh as mesh_ops


@dataclasses.dataclass
class ScanConfig:
    width: int = 320
    height: int = 256
    fx: float = 269.112
    fy: float = 269.297
    depth_min: float = 0.4
    depth_max: float = 4.0
    chance_drop_frames: float = 0.8  # zParametersScanMP.txt:48
    samples_per_area: float = 8000.0  # surface samples per square meter
    # randomized directional lighting of rendered colors (reference
    # datagen/src/Lighting.h randomizes a light per frame); 0 disables
    lighting_strength: float = 0.0
    lighting_seed: int = 0
    # "raster" = z-buffered triangle rasterization (reference fidelity,
    # Scene.cpp:169-227 — every covered pixel filled exactly, no
    # sample-density holes); "splat" = the point-splat approximation
    renderer: str = "raster"


def frame_light(cfg: ScanConfig, frame_id: int) -> np.ndarray:
    """Per-frame randomized directional light, unit-norm, from above
    (reference datagen/src/Lighting.h). Shared by the raster and splat paths
    so their shading stays numerically identical."""
    rng = np.random.default_rng(cfg.lighting_seed * 100003 + frame_id)
    light = rng.standard_normal(3)
    light[2] = -abs(light[2])
    light /= np.linalg.norm(light)
    return light


def lambert_shade(cfg: ScanConfig, normals: np.ndarray, light: np.ndarray) -> np.ndarray:
    """Lambertian blend factor per normal: (1-s) + s*|n.l|."""
    lambert = np.abs(normals @ light)
    return (1.0 - cfg.lighting_strength) + cfg.lighting_strength * lambert


def render_depth_from_points(
    points: np.ndarray,  # (N, 3) world
    colors: Optional[np.ndarray],  # (N, 3) uint8
    cam2world: np.ndarray,
    cfg: ScanConfig,
    normals: Optional[np.ndarray] = None,  # (N, 3) world, for lighting
    frame_id: int = 0,
):
    """Z-buffer point-splat rendering: project surface samples, keep the
    nearest per pixel (replaces the reference's D3D11 rasterization,
    Scene.cpp:169-227). With ``normals`` and lighting_strength > 0, applies
    per-frame randomized Lambertian directional lighting (reference
    datagen/src/Lighting.h). Returns (depth (H,W) m with 0 holes,
    color (H,W,3) u8 or None)."""
    world2cam = np.linalg.inv(cam2world)
    p = points @ world2cam[:3, :3].T + world2cam[:3, 3]
    z = p[:, 2]
    ok = (z > cfg.depth_min) & (z < cfg.depth_max)
    u = np.round(cfg.fx * p[:, 0] / np.maximum(z, 1e-9) + cfg.width / 2).astype(int)
    v = np.round(cfg.fy * p[:, 1] / np.maximum(z, 1e-9) + cfg.height / 2).astype(int)
    ok &= (u >= 0) & (v >= 0) & (u < cfg.width) & (v < cfg.height)
    u, v, z = u[ok], v[ok], z[ok]
    flat = v * cfg.width + u
    depth = np.full(cfg.height * cfg.width, np.inf, np.float32)
    np.minimum.at(depth, flat, z)
    out_color = None
    if colors is not None:
        csel = colors[ok].astype(np.float32)
        if cfg.lighting_strength > 0 and normals is not None:
            shade = lambert_shade(cfg, normals[ok], frame_light(cfg, frame_id))
            csel = csel * shade[:, None]
        # winner-take-all by re-checking the z-buffer
        win = z <= depth[flat] + 1e-6
        out_color = np.zeros((cfg.height * cfg.width, 3), np.uint8)
        out_color[flat[win]] = np.clip(csel[win], 0, 255).astype(np.uint8)
        out_color = out_color.reshape(cfg.height, cfg.width, 3)
    depth = np.where(np.isfinite(depth), depth, 0.0).reshape(cfg.height, cfg.width)
    return depth, out_color


def export_frame(
    frame_dir: str,
    frame_id: int,
    depth_m: np.ndarray,  # (H, W) meters, 0 = hole
    color: Optional[np.ndarray],  # (H, W, 3) uint8
    cam2world: np.ndarray,
    intrinsics: np.ndarray,  # [fx, fy, mx, my]
):
    """Write one RGB-D frame in the layout the 2D-loss loader consumes
    (reference frame files, data_util.py:764-787, 837-859):
    ``depth/<id>.png`` (u16 millimeters), ``color/<id>.jpg``,
    ``camera/<id>.txt`` (4x4 cam->world pose rows then 4x4 intrinsic rows)."""
    from PIL import Image

    for sub in ("depth", "color", "camera"):
        os.makedirs(os.path.join(frame_dir, sub), exist_ok=True)
    d_mm = np.clip(np.nan_to_num(depth_m) * 1000.0, 0, 65535).astype(np.uint16)
    Image.fromarray(d_mm).save(os.path.join(frame_dir, "depth", f"{frame_id}.png"))
    if color is None:
        color = np.zeros(depth_m.shape + (3,), np.uint8)
    Image.fromarray(color.astype(np.uint8)).save(
        os.path.join(frame_dir, "color", f"{frame_id}.jpg"), quality=95
    )
    fx, fy, mx, my = (float(v) for v in intrinsics[:4])
    K = np.array(
        [[fx, 0, mx, 0], [0, fy, my, 0], [0, 0, 1, 0], [0, 0, 0, 1]], np.float32
    )
    with open(os.path.join(frame_dir, "camera", f"{frame_id}.txt"), "w") as f:
        for row in np.asarray(cam2world, np.float32)[:4]:
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
        for row in K:
            f.write(" ".join(f"{v:.6f}" for v in row) + "\n")


def save_trajectory(path: str, trajectory: Sequence[np.ndarray], intrinsics, frame_ids):
    """Sidecar trajectory record consumed by the chunker to compute per-chunk
    frame associations (the reference datagen keeps the trajectory in memory,
    Scene.h:51-96; a sidecar keeps the scan and chunk CLIs composable)."""
    np.savez(
        path,
        cam2world=np.stack([np.asarray(t, np.float32) for t in trajectory]),
        intrinsics=np.asarray(intrinsics, np.float32),
        frame_ids=np.asarray(frame_ids, np.int32),
    )


def virtual_scan(
    verts: np.ndarray,
    faces: np.ndarray,
    vert_colors: Optional[np.ndarray],
    trajectory: Sequence[np.ndarray],  # cam2world matrices
    output_prefix_inc: str,
    output_prefix_cmp: str,
    fusion_cfg: fusion.FusionConfig = fusion.FusionConfig(),
    scan_cfg: ScanConfig = ScanConfig(),
    seed: int = 0,
    frame_export_dir: Optional[str] = None,
    device="cuda",
) -> Tuple[tuple, np.ndarray]:
    """Scan one room mesh along a camera trajectory, writing incomplete and
    complete .sdf/.colors/.knw (Fuser::fuse, Fuser.cpp:21-186). With
    ``frame_export_dir``, every rendered frame is also written in the
    training frame layout (depth/color/camera, see export_frame) using its
    trajectory index as the frame id, plus a ``<cmp>.traj.npz`` sidecar for
    the chunker's frame association. The grid lives on ``device`` ("cuda"
    unless the caller asks for the CPU). Returns (dims_zyx, world2grid)."""
    rng = np.random.default_rng(seed)
    v0 = verts[faces[:, 0]]
    v1 = verts[faces[:, 1]]
    v2 = verts[faces[:, 2]]
    cross = np.cross(v1 - v0, v2 - v0)
    face_normals = cross / np.maximum(np.linalg.norm(cross, axis=1, keepdims=True), 1e-12)
    use_raster = scan_cfg.renderer == "raster"
    points = normals = colors = None
    if not use_raster:
        # surface samples for splatting
        areas = 0.5 * np.linalg.norm(cross, axis=1)
        area = float(areas.sum())
        n_samples = max(10000, int(area * scan_cfg.samples_per_area))
        rng_s = np.random.default_rng(seed)
        fidx = rng_s.choice(len(faces), size=n_samples, p=areas / max(area, 1e-12))
        r1 = np.sqrt(rng_s.random(n_samples))
        r2 = rng_s.random(n_samples)
        a = (1.0 - r1)[:, None]
        b = (r1 * (1.0 - r2))[:, None]
        c = (r1 * r2)[:, None]
        points = (a * v0[fidx] + b * v1[fidx] + c * v2[fidx]).astype(np.float32)
        normals = face_normals[fidx].astype(np.float32)
        if vert_colors is not None:
            # nearest-vertex colors for the samples
            from scipy.spatial import cKDTree

            tree = cKDTree(verts)
            _, idx = tree.query(points, k=1)
            colors = vert_colors[idx]

    dims_zyx, world2grid = fusion.grid_from_bounds(
        verts.min(0), verts.max(0), fusion_cfg
    )
    intr = np.array(
        [scan_cfg.fx, scan_cfg.fy, scan_cfg.width / 2, scan_cfg.height / 2], np.float32
    )

    # frame split (Visualizer.h:37-51): drop p of the frames for the
    # incomplete scan, fuse the rest afterwards for the complete one
    keep = rng.random(len(trajectory)) >= scan_cfg.chance_drop_frames
    if not keep.any():
        keep[rng.integers(len(trajectory))] = True
    inc_frames = [(fi, t) for fi, (t, k) in enumerate(zip(trajectory, keep)) if k]
    rest_frames = [(fi, t) for fi, (t, k) in enumerate(zip(trajectory, keep)) if not k]

    def frame_iter(cams):
        for fi, cam in cams:
            if use_raster:
                from . import raster

                face_shade = None
                if scan_cfg.lighting_strength > 0:
                    # flat (per-face) shading with the shared per-frame light
                    # (frame_light/lambert_shade keep raster and splat paths
                    # numerically identical)
                    face_shade = lambert_shade(
                        scan_cfg, face_normals, frame_light(scan_cfg, fi)
                    ).astype(np.float32)
                depth, color = raster.rasterize_depth(
                    verts, faces, vert_colors, cam,
                    scan_cfg.fx, scan_cfg.fy,
                    scan_cfg.width / 2, scan_cfg.height / 2,
                    scan_cfg.width, scan_cfg.height,
                    scan_cfg.depth_min, scan_cfg.depth_max,
                    face_shade=face_shade,
                )
            else:
                depth, color = render_depth_from_points(
                    points, colors, cam, scan_cfg, normals=normals, frame_id=fi
                )
            if frame_export_dir is not None:
                export_frame(frame_export_dir, fi, depth, color, cam, intr)
            yield depth, color.astype(np.float32) if color is not None else None, intr, cam

    grid = fusion.make_grid(dims_zyx, device)
    dev = grid["sdf"].device

    def fuse(frames):
        for d, c, i, cam in frame_iter(frames):
            fusion.integrate(grid, torch.as_tensor(np.asarray(d, np.float32), device=dev),
                             torch.as_tensor(c, device=dev) if c is not None else None,
                             i, cam, world2grid, fusion_cfg)

    fuse(inc_frames)
    fusion.save_grid(output_prefix_inc, grid, world2grid, fusion_cfg)
    fuse(rest_frames)
    fusion.save_grid(output_prefix_cmp, grid, world2grid, fusion_cfg)
    if frame_export_dir is not None:
        save_trajectory(
            output_prefix_cmp + ".traj.npz", list(trajectory), intr,
            np.arange(len(trajectory)),
        )
    return dims_zyx, world2grid


def orbit_trajectory(
    center: np.ndarray, radius: float, height: float, num_frames: int = 24
) -> List[np.ndarray]:
    """A simple inward-looking orbit trajectory for synthetic scans (the
    reference uses recorded .sens trajectories; any cam2world source works)."""
    cams = []
    for k in range(num_frames):
        ang = 2 * np.pi * k / num_frames
        eye = center + np.array([radius * np.cos(ang), radius * np.sin(ang), height])
        fwd = center - eye
        fwd = fwd / np.linalg.norm(fwd)
        up = np.array([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        cam = np.eye(4, dtype=np.float32)
        cam[:3, 0] = right
        cam[:3, 1] = down
        cam[:3, 2] = fwd
        cam[:3, 3] = eye
        cams.append(cam)
    return cams
