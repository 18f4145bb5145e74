"""The training cells' chunks, made on the device the caller names: each chunk
by the benchmark's room recipe (``gen/scenes.py``, with the counts of the
port's ``data/synthetic.py::make_scene``), assembled as the port's
``data/pipeline.py::assemble_sample`` does it (lab colours, the input mask,
truncation), stacked, and one frame a chunk rendered by the reference's plain
raycaster (``reference/raycast.py``) from the camera of a frozen copy of
``make_camera``. The batch is handed over as host arrays, as the training loop
reads it. The same seed gives the same batch."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from gen.scenes import make_room
from reference import colorspace
from reference.raycast import RaycastConfig, raycast


def make_camera(
    dims=(128, 64, 64),
    image_dims=(320, 256),
    seed: int = 0,
    fov_deg: float = 60.0,
):
    """A camera looking at the scene centre from above/behind (a copy of the
    JAX package's, plain numpy). Returns (cam2grid (4,4) float32, intrinsics
    (4,) = [fx, fy, mx, my]); cam2grid is the view matrix the raycaster takes
    (reference torch/train.py:534 + raycast_rgbd.py:77-85)."""
    rng = np.random.default_rng(seed)
    width, height = image_dims
    fx = 0.5 * width / np.tan(np.radians(fov_deg) / 2)
    fy = fx
    intrinsics = np.array([fx, fy, width / 2.0, height / 2.0], dtype=np.float32)

    target = np.array([dims[0] * 0.25, dims[1] * 0.5, dims[2] * 0.5], dtype=np.float32)
    eye = np.array(
        [
            dims[0] * (0.6 + 0.3 * rng.random()),
            dims[1] * (0.7 + 0.25 * rng.random()),
            dims[2] * (0.7 + 0.25 * rng.random()),
        ],
        dtype=np.float32,
    )
    # camera axes in grid space: +z forward (pinhole model marches +z),
    # +x right, +y down (image convention)
    fwd = target - eye
    fwd /= np.linalg.norm(fwd)
    up_hint = np.array([-1.0, 0.0, 0.0], dtype=np.float32)  # grid z is up -> image up = -grid z
    right = np.cross(fwd, up_hint)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    down /= np.linalg.norm(down)
    cam2grid = np.eye(4, dtype=np.float32)
    cam2grid[:3, 0] = right
    cam2grid[:3, 1] = down
    cam2grid[:3, 2] = fwd
    cam2grid[:3, 3] = eye
    return cam2grid, intrinsics



def assemble_sample(room: Dict[str, torch.Tensor], truncation: float, voxelsize: float):
    """One training sample of a room (reference scene_dataloader.py:194-264,
    no hue augmentation): target colours as lab01 x 255, the input's as
    lab01, -inf counting as empty, the mask of observed voxels behind the
    surface, the input SDF clamped to the truncation."""
    sdf_input = room["sdf_input"]
    empty = sdf_input.abs() > truncation
    in_lab = colorspace.rgb_to_lab01(room["input_colors"].float() / 255.0, xp=torch)
    world2grid = torch.eye(4, dtype=torch.float32, device=sdf_input.device)
    world2grid[0, 0] = world2grid[1, 1] = world2grid[2, 2] = 1.0 / voxelsize
    return {
        "input": torch.cat([sdf_input.clamp(-truncation, truncation)[..., None],
                            torch.where(empty[..., None], 0.0, in_lab)], dim=-1),
        "mask": ((sdf_input <= -1) & ~empty).float()[..., None],
        "target_sdf": room["target_sdf"],
        "target_colors": colorspace.rgb_to_lab01(room["colors"].float() / 255.0, xp=torch) * 255.0,
        "world2grid": world2grid,
        "semantics": room["semantics"],
        "known": room["known"],
    }


def make_chunk_batch(batch_size: int, dims, image_dims, seed: int, voxelsize: float = 0.02,
                     truncation: float = 3.0, device="cuda") -> Dict[str, np.ndarray]:
    """A batch of synthetic chunks in the port's layout (channel-last, as
    ``make_chunk_batch(with_frames=True)`` gives it), one frame a chunk
    rendered from the complete TSDF by the plain raycaster."""
    samples = [assemble_sample(make_room(dims, seed * 1000 + b, device), truncation, voxelsize)
               for b in range(batch_size)]
    batch = {k: torch.stack([s[k] for s in samples]) for k in samples[0]}
    cams = [make_camera(dims, image_dims, seed=seed * 1000 + b) for b in range(batch_size)]
    views = torch.as_tensor(np.stack([c[0] for c in cams]), device=device)
    intr = torch.as_tensor(np.stack([c[1] for c in cams]), device=device)
    cfg = RaycastConfig(width=image_dims[0], height=image_dims[1], depth_min=0.1 / voxelsize,
                        depth_max=6.0 / voxelsize, ray_increment=0.3 * truncation,
                        thresh_sample_dist=50.5 * 0.3 * truncation)
    tsdf = batch["target_sdf"]
    with torch.no_grad():
        out = raycast(tsdf.clamp(-truncation, truncation), tsdf.abs() < truncation,
                      batch["target_colors"] / 255.0, None, None, views, intr, cfg)
    batch["images_depth"] = torch.where(torch.isfinite(out.depth), out.depth * voxelsize, 0.0)
    batch["images_color"] = torch.where(torch.isfinite(out.color), out.color,
                                        0.0).permute(0, 3, 1, 2)
    batch["images_view"] = views
    batch["images_intrinsic"] = intr
    return {k: v.contiguous().cpu().numpy() for k, v in batch.items()}
