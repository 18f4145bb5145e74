"""Synthetic indoor-scene TSDF generator.

Produces analytic room-like scenes (floor + walls + furniture primitives) as
dense TSDF grids with per-voxel color, semantics and known-space masks, plus
camera poses — everything the training/eval pipeline consumes — without the
100+ GB Matterport3D download. The reference has no equivalent (its tests are
manual, SURVEY.md §4); this module is the foundation of the test pyramid and
of ``chip_smoke.py``.

``make_chunk_batch`` builds training batches of chunks without frames; the
frames of the JAX package (``with_frames=True``, ``make_camera``) are rendered
with the raycaster and arrive with the raycaster's port (ROADMAP.md).

Grid conventions match the on-disk formats (``spsg_tpu_torch.data.formats``):
dense zyx grids, z is the up axis (reference train.py:113 ``UP_AXIS = 0``),
SDF in voxel units, unobserved = -inf in the dense input grid
(reference data_util.py:158).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from . import category


@dataclasses.dataclass
class SyntheticScene:
    dims: Tuple[int, int, int]  # (dimz, dimy, dimx)
    voxelsize: float
    world2grid: np.ndarray  # (4, 4)
    sdf_complete: np.ndarray  # (Z, Y, X) float32, voxel units, clamped to +-trunc_store
    sdf_input: np.ndarray  # (Z, Y, X) float32, -inf where unobserved
    colors: np.ndarray  # (Z, Y, X, 3) uint8 (target colors)
    input_colors: np.ndarray  # (Z, Y, X, 3) uint8
    semantics: np.ndarray  # (Z, Y, X) uint8 (14 = unlabeled)
    known: np.ndarray  # (Z, Y, X) uint8 {0 empty, 1 occ, >=2 unknown}


def _grid_coords(dims):
    z, y, x = np.meshgrid(
        np.arange(dims[0], dtype=np.float32),
        np.arange(dims[1], dtype=np.float32),
        np.arange(dims[2], dtype=np.float32),
        indexing="ij",
    )
    return z, y, x


def _sd_box(z, y, x, center, half):
    dz = np.abs(z - center[0]) - half[0]
    dy = np.abs(y - center[1]) - half[1]
    dx = np.abs(x - center[2]) - half[2]
    outside = np.sqrt(
        np.maximum(dz, 0) ** 2 + np.maximum(dy, 0) ** 2 + np.maximum(dx, 0) ** 2
    )
    inside = np.minimum(np.maximum(dz, np.maximum(dy, dx)), 0.0)
    return outside + inside


def _sd_sphere(z, y, x, center, r):
    return (
        np.sqrt((z - center[0]) ** 2 + (y - center[1]) ** 2 + (x - center[2]) ** 2) - r
    )


def make_scene(
    dims=(128, 64, 64),
    voxelsize: float = 0.02,
    seed: int = 0,
    trunc_store: float = 6.0,
    num_objects: int = 3,
    drop_fraction: float = 0.35,
) -> SyntheticScene:
    """Build one synthetic scene.

    ``trunc_store`` mimics the datagen truncation of 6 voxels
    (reference datagen/src/Fuser.cpp:35). ``drop_fraction`` emulates the
    frame-dropping that produces incomplete scans
    (reference datagen/src/Visualizer.h:37-51, chanceDropFrames=0.8).
    """
    rng = np.random.default_rng(seed)
    dims = tuple(int(d) for d in dims)
    z, y, x = _grid_coords(dims)

    floor_h = float(rng.integers(3, 7))
    sdf = z - floor_h  # floor plane, up = +z
    sem = np.full(dims, 5, dtype=np.uint8)  # Floor
    col = np.zeros(dims + (3,), dtype=np.float32)
    col[...] = np.array([0.55, 0.45, 0.35]) + 0.08 * rng.standard_normal(3)

    def _apply(d_obj, label, base_color):
        nonlocal sdf, sem, col
        closer = d_obj < sdf
        sdf = np.minimum(sdf, d_obj)
        sem = np.where(closer, np.uint8(label), sem)
        c = np.clip(np.array(base_color) + 0.05 * rng.standard_normal(3), 0, 1)
        col = np.where(closer[..., None], c.astype(np.float32), col)

    # two walls (label 12 = Wall)
    wall_y = float(rng.integers(2, 5))
    _apply(y - wall_y, 12, [0.8, 0.78, 0.7])
    wall_x = float(rng.integers(2, 5))
    _apply(x - wall_x, 12, [0.75, 0.75, 0.72])

    obj_labels = [1, 4, 6, 7, 9, 10]  # Bed, Chair, Furniture, Objects, Sofa, Table
    for _ in range(num_objects):
        label = int(rng.choice(obj_labels))
        cz = floor_h + float(rng.integers(4, max(5, min(14, dims[0] - int(floor_h) - 2))))
        ylo = int(min(wall_y + 8, dims[1] - 9)) if dims[1] > 17 else 4
        xlo = int(min(wall_x + 8, dims[2] - 9)) if dims[2] > 17 else 4
        cy = float(rng.integers(ylo, max(ylo + 1, dims[1] - 8)))
        cx = float(rng.integers(xlo, max(xlo + 1, dims[2] - 8)))
        color = rng.uniform(0.2, 0.9, size=3)
        if rng.random() < 0.5:
            r = float(rng.integers(4, 10))
            _apply(_sd_sphere(z, y, x, (cz, cy, cx), r), label, color)
        else:
            half = rng.integers(3, 9, size=3).astype(np.float32)
            half[0] = min(half[0], cz - floor_h)
            _apply(_sd_box(z, y, x, (cz, cy, cx), half), label, color)

    sdf = np.clip(sdf, -trunc_store, trunc_store).astype(np.float32)
    colors_u8 = np.clip(col * 255.0, 0, 255).astype(np.uint8)
    # colors only meaningful near the surface (datagen stores sparse colors)
    surface = np.abs(sdf) < trunc_store
    colors_u8 = np.where(surface[..., None], colors_u8, 0)
    sem = np.where(np.abs(sdf) < 2.0, sem, np.uint8(category.UNLABELED))

    # known-space: 0 = observed empty (in front of surface), 1 = observed
    # surface, 2 = unknown (behind surface) — datagen VoxelGrid.h:321-340.
    known = np.full(dims, 2, dtype=np.uint8)
    known[sdf > 1.0] = 0
    known[np.abs(sdf) <= 1.0] = 1

    # incomplete input: carve out random spherical regions of observation
    observed = np.abs(sdf) < trunc_store
    num_holes = max(1, int(drop_fraction * 6))
    for _ in range(num_holes):
        hc = (
            float(rng.integers(0, dims[0])),
            float(rng.integers(0, dims[1])),
            float(rng.integers(0, dims[2])),
        )
        hr = float(rng.integers(4, max(6, min(dims) // 2)))
        hole = _sd_sphere(z, y, x, hc, hr) < 0
        observed &= ~hole
    sdf_input = np.where(observed, sdf, -np.inf).astype(np.float32)
    input_colors = np.where(observed[..., None], colors_u8, 0)

    world2grid = np.eye(4, dtype=np.float32)
    world2grid[0, 0] = world2grid[1, 1] = world2grid[2, 2] = 1.0 / voxelsize

    return SyntheticScene(
        dims=dims,
        voxelsize=voxelsize,
        world2grid=world2grid,
        sdf_complete=sdf,
        sdf_input=sdf_input,
        colors=colors_u8,
        input_colors=input_colors,
        semantics=sem,
        known=known,
    )


def make_chunk_batch(
    batch_size: int = 2,
    dims=(128, 64, 64),
    image_dims=(320, 256),
    seed: int = 0,
    with_frames: bool = False,
    voxelsize: float = 0.02,
    truncation: float = 3.0,
):
    """Generate a ready-to-train batch of synthetic chunks as a dict of numpy
    arrays in the layout of :mod:`spsg_tpu_torch.data.pipeline` (channel-last).
    The same seeds give the same batch as the JAX package's function.

    ``with_frames`` (depth/color frames rendered from the complete TSDF) needs
    the raycaster, which is not ported yet."""
    from . import pipeline

    if with_frames:
        raise NotImplementedError(
            "make_chunk_batch(with_frames=True): frames are rendered with the raycaster, "
            "which is not ported yet (ROADMAP.md)"
        )
    samples = []
    for b in range(batch_size):
        scene = make_scene(dims=dims, voxelsize=voxelsize, seed=seed * 1000 + b)
        sample = pipeline.assemble_sample(
            sdf_input=scene.sdf_input,
            sdf_target=scene.sdf_complete,
            input_colors=scene.input_colors,
            target_colors=scene.colors,
            semantics=scene.semantics,
            known=scene.known,
            world2grid=scene.world2grid,
            truncation=truncation,
            color_space="lab",
            augment_hue_scale=None,
        )
        sample["name"] = f"synthetic_{seed}_{b}"
        samples.append(sample)
    return pipeline.collate(samples)
