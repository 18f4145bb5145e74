"""Prediction/target visual dumps: meshes + images (reference
torch/data_util.py:587-761 save_predictions). Channel-last dense grids in,
PLY meshes + PNGs out."""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from ..data import category, colorspace
from ..ops import mesh


def _to_u8(img: np.ndarray) -> np.ndarray:
    return np.clip(img, 0, 255).astype(np.uint8)


def save_png(path: str, img: np.ndarray) -> None:
    from PIL import Image

    Image.fromarray(_to_u8(img)).save(path)


def lab255_to_rgb_u8(colors255: np.ndarray) -> np.ndarray:
    """[0,255]-scaled lab01 -> RGB uint8 with the reference's contrast bump
    (data_util.py:629-635: 1.368*(rgb-128)+128)."""
    rgb = colorspace.lab01_to_rgb(colors255.astype(np.float32) / 255.0, xp=np) * 255.0
    rgb = np.clip(1.368 * (rgb - 128.0) + 128.0, 0, 255)
    return rgb.astype(np.uint8)


def colors_to_rgb_u8(colors255: np.ndarray, color_space: str) -> np.ndarray:
    if color_space == "lab":
        return lab255_to_rgb_u8(colors255)
    return _to_u8(colors255)


def depth_to_vis(depth: np.ndarray, depth_max: float) -> np.ndarray:
    """Depth as an HSV colormap image (reference vis_depth_as_hsv,
    data_util.py:395-407)."""
    d = np.where(np.isfinite(depth), depth, 0.0)
    h = 359.0 * np.clip(d / depth_max, 0, 1)
    hsv = np.stack([h, np.ones_like(h), np.full_like(h, 0.5)], axis=-1)
    return _to_u8(colorspace.hsv_to_rgb_np(hsv) * 255.0)


def normals_to_vis(normals: np.ndarray) -> np.ndarray:
    n = np.where(np.isfinite(normals), normals, 0.0)
    return _to_u8((n + 1.0) * 0.5 * 255.0)


def save_predictions(
    output_path: str,
    name: str,
    input_grid: Optional[np.ndarray],  # (Z,Y,X,4) sdf+colors
    target_sdf: Optional[np.ndarray],  # (Z,Y,X)
    target_colors: Optional[np.ndarray],  # (Z,Y,X,3) [0,255]
    target_semantics: Optional[np.ndarray],  # (Z,Y,X)
    pred_sdf: Optional[np.ndarray],  # (Z,Y,X), -inf empty
    pred_colors: Optional[np.ndarray],  # (Z,Y,X,3) in [0,1]
    pred_semantics: Optional[np.ndarray],  # (Z,Y,X,C) logits or (Z,Y,X) labels
    truncation: float = 3.0,
    color_space: str = "lab",
    images: Optional[Dict[str, np.ndarray]] = None,
    raycast_depth_max: float = 6.0,
) -> None:
    """Dump *_input-mesh/_pred-mesh/_target-mesh(.ply) (+semantic variants)
    and 2D image panels. ``images`` maps suffix -> array:
      'input'/'pred'/'target'      : (H,W,3) color in the training space
      'pred-normals'/...-normals   : (H,W,3)
      'pred-depth'/'target-depth'  : (H,W) meters
      'pred-semantics'/...         : (H,W) labels
    """
    os.makedirs(output_path, exist_ok=True)
    name = name.replace("/", "_")
    trunc_vis = truncation - 0.1

    def mesh_dump(sdf, colors_u8, suffix):
        verts, vcol, faces = mesh.marching_cubes(
            sdf, colors_u8, isovalue=0.0, truncation=trunc_vis
        )
        if len(verts):
            mesh.save_ply(os.path.join(output_path, f"{name}_{suffix}.ply"), verts, faces, vcol)

    if input_grid is not None:
        in_colors = _to_u8(input_grid[..., 1:4] * 255.0)
        if color_space == "lab":
            in_colors = lab255_to_rgb_u8(in_colors.astype(np.float32))
        mesh_dump(input_grid[..., 0], in_colors, "input-mesh")
    if pred_sdf is not None:
        pcol = None
        if pred_colors is not None:
            pcol = colors_to_rgb_u8((pred_colors + 1.0) * 0.5 * 255.0, color_space)
        mesh_dump(pred_sdf, pcol, "pred-mesh")
        if pred_semantics is not None:
            # (Z,Y,X,C) logits or (Z,Y,X) precomputed labels
            labels = (
                pred_semantics
                if pred_semantics.ndim == 3
                else np.argmax(pred_semantics, axis=-1)
            )
            sem_col = category.map_label_to_color(labels)
            mesh_dump(pred_sdf, sem_col, "pred-sem-mesh")
    if target_sdf is not None:
        tcol = None
        if target_colors is not None:
            tcol = colors_to_rgb_u8(target_colors, color_space)
        mesh_dump(target_sdf, tcol, "target-mesh")
        if target_semantics is not None:
            sem_col = category.map_label_to_color(target_semantics)
            mesh_dump(target_sdf, sem_col, "target-sem-mesh")

    if images:
        for suffix, img in images.items():
            if img is None:
                continue
            p = os.path.join(output_path, f"{name}_{suffix}.png")
            if suffix.endswith("depth"):
                save_png(p, depth_to_vis(img, raycast_depth_max))
            elif suffix.endswith("normals"):
                save_png(p, normals_to_vis(img))
            elif suffix.endswith("semantics"):
                save_png(p, category.map_label_to_color(img))
            else:  # color image in training space, [0,1]
                c = np.where(np.isfinite(img), img, 0.0)
                if color_space == "lab":
                    rgb = colorspace.lab01_to_rgb(c, xp=np) * 255.0
                else:
                    rgb = c * 255.0
                save_png(p, rgb)
