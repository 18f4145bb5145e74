"""The benchmark's one room recipe, in torch on the device the caller names:
the port's ``data/synthetic.py::make_scene`` written again so that a training
chunk or a served room is made on the card in milliseconds. The recipe: a
floor, two walls, box and sphere furniture with colours and semantic labels,
the SDF clamped at 6 voxels, colours on the surface band, labels within 2
voxels of it, the known-space grid, and the input carved by spherical holes
(-inf where unobserved). Its parameters are drawn from
``numpy.random.default_rng(seed)`` in ``make_scene``'s order, so that with
``make_scene``'s counts (3 objects, 2 holes) a chunk is the port's synthetic
chunk; the same seed gives the same room."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

FLOOR, WALL, UNLABELED = 5, 12, 14
OBJECT_LABELS = (1, 4, 6, 7, 9, 10)  # Bed, Chair, Furniture, Objects, Sofa, Table
TRUNC_STORE = 6.0  # the datagen's truncation (reference datagen/src/Fuser.cpp:35)


def make_room(dims: Sequence[int], seed: int, device, n_objects: int = 3, n_holes: int = 2,
              hole_radius_hi: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One room of ``dims`` (Z, Y, X) on ``device``: ``sdf_input`` (float32,
    -inf unobserved), ``input_colors`` and ``colors`` (uint8 RGB, observed and
    complete), ``target_sdf`` (float32), ``known`` and ``semantics`` (uint8).
    A hole's radius is drawn from [4, ``hole_radius_hi``), by default
    ``make_scene``'s max(6, min(dims) // 2)."""
    rng = np.random.default_rng(seed)
    Z, Y, X = (int(d) for d in dims)
    f32 = dict(dtype=torch.float32, device=device)
    z = torch.arange(Z, **f32).view(Z, 1, 1)
    y = torch.arange(Y, **f32).view(1, Y, 1)
    x = torch.arange(X, **f32).view(1, 1, X)
    floor_h = float(rng.integers(3, 7))
    sdf = (z - floor_h).expand(Z, Y, X).clone()
    sem = torch.full((Z, Y, X), FLOOR, dtype=torch.uint8, device=device)
    base = np.array([0.55, 0.45, 0.35]) + 0.08 * rng.standard_normal(3)
    col = torch.as_tensor(base, **f32).expand(Z, Y, X, 3).clone()

    def apply(d_obj, label, color):
        closer = d_obj < sdf
        torch.minimum(sdf, d_obj, out=sdf)
        sem[closer] = label
        c = np.clip(np.asarray(color) + 0.05 * rng.standard_normal(3), 0, 1)
        col[closer] = torch.as_tensor(c, **f32)

    def sphere(c, r):
        return torch.sqrt((z - c[0]) ** 2 + (y - c[1]) ** 2 + (x - c[2]) ** 2) - r

    wall_y = float(rng.integers(2, 5))
    apply((y - wall_y).expand(Z, Y, X), WALL, [0.8, 0.78, 0.7])
    wall_x = float(rng.integers(2, 5))
    apply((x - wall_x).expand(Z, Y, X), WALL, [0.75, 0.75, 0.72])
    for _ in range(n_objects):
        label = int(rng.choice(OBJECT_LABELS))
        cz = floor_h + float(rng.integers(4, max(5, min(14, Z - int(floor_h) - 2))))
        ylo = int(min(wall_y + 8, Y - 9)) if Y > 17 else 4
        xlo = int(min(wall_x + 8, X - 9)) if X > 17 else 4
        cy = float(rng.integers(ylo, max(ylo + 1, Y - 8)))
        cx = float(rng.integers(xlo, max(xlo + 1, X - 8)))
        color = rng.uniform(0.2, 0.9, size=3)
        if rng.random() < 0.5:
            apply(sphere((cz, cy, cx), float(rng.integers(4, 10))), label, color)
        else:
            half = rng.integers(3, 9, size=3).astype(np.float32)
            half[0] = min(half[0], cz - floor_h)
            dz = (z - cz).abs() - float(half[0])
            dy, dx = (y - cy).abs() - float(half[1]), (x - cx).abs() - float(half[2])
            outside = torch.sqrt(dz.clamp(min=0) ** 2 + dy.clamp(min=0) ** 2
                                 + dx.clamp(min=0) ** 2)
            apply(outside + torch.clamp(torch.maximum(dz, torch.maximum(dy, dx)), max=0.0),
                  label, color)

    sdf.clamp_(-TRUNC_STORE, TRUNC_STORE)
    surface = sdf.abs() < TRUNC_STORE
    colors = torch.where(surface[..., None], (col * 255.0).clamp(0, 255).to(torch.uint8), 0)
    sem = torch.where(sdf.abs() < 2.0, sem, UNLABELED)
    # 0 observed empty, 1 observed surface, 2 unknown (datagen VoxelGrid.h:321-340)
    known = torch.full((Z, Y, X), 2, dtype=torch.uint8, device=device)
    known[sdf > 1.0] = 0
    known[sdf.abs() <= 1.0] = 1
    observed = surface.clone()
    hi = hole_radius_hi if hole_radius_hi is not None else max(6, min(Z, Y, X) // 2)
    for _ in range(n_holes):
        hc = (float(rng.integers(0, Z)), float(rng.integers(0, Y)), float(rng.integers(0, X)))
        observed &= ~(sphere(hc, float(rng.integers(4, hi))) < 0)
    return dict(sdf_input=torch.where(observed, sdf, -float("inf")),
                input_colors=torch.where(observed[..., None], colors, 0), colors=colors,
                target_sdf=sdf, known=known, semantics=sem)


def served_room(dims: Sequence[int], seed: int, device, traffic: Dict) -> Dict[str, np.ndarray]:
    """A room of the serving traffic as the serving CLI reads it from disk
    (host arrays): the recipe's counts of a ``chunk_footprint`` (Y, X) times
    the room's footprints, hole radii as in such a chunk."""
    fy, fx = traffic["chunk_footprint"]
    footprints = dims[1] * dims[2] / (fy * fx)
    room = make_room(dims, seed, device,
                     n_objects=int(round(traffic["objects_per_chunk"] * footprints)),
                     n_holes=int(round(traffic["holes_per_chunk"] * footprints)),
                     hole_radius_hi=max(6, min(dims[0], fy, fx) // 2))
    return {k: room[k].cpu().numpy()
            for k in ("sdf_input", "input_colors", "target_sdf", "known", "semantics")}

