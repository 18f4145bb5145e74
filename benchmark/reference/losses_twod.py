"""2D view-guided losses (PyTorch counterpart of ``spsg_tpu/losses/twod.py``;
reference torch/loss.py:246-356 + train.py:524-752).

They work on raycast images with ``-inf`` for invalid pixels; every boolean
select of the reference is a masked mean, as in the JAX package. With
``mesh`` the means are over the global batch (``losses/geo.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from .losses_geo import masked_mean


def depth_l1_loss(raycast_depth: torch.Tensor, image_depth: torch.Tensor,
                  voxelsize: float, mesh=None) -> torch.Tensor:
    """L1 between the rendered depth (voxels -> metres) and the target depth
    (metres, 0 = hole) where both are valid (reference train.py:634-638)."""
    pred_m = raycast_depth * voxelsize
    valid = (raycast_depth != -torch.inf) & (image_depth != 0.0)
    diff = torch.where(valid, pred_m - image_depth, 0.0).abs()
    return masked_mean(diff, valid, mesh=mesh)


def color_l1_loss(raycast_color: torch.Tensor, image_color: torch.Tensor,
                  weight: Optional[torch.Tensor] = None, mesh=None) -> torch.Tensor:
    """L1 between rendered and target colour over valid pixels; an optional
    (B, H, W) weight multiplies both sides (reference loss.py:246-257)."""
    valid = raycast_color != -torch.inf
    pred, tgt = raycast_color, image_color
    if weight is not None:
        pred = pred * weight[..., None]
        tgt = tgt * weight[..., None]
    diff = torch.where(valid, pred - tgt, 0.0).abs()
    return masked_mean(diff, valid, mesh=mesh)


def filter_proj_target(raycast_color: torch.Tensor, color_thresh: float,
                       color_space: str) -> torch.Tensor:
    """(B, H, W) mask of pixels whose projected target colour is (near) black
    or LAB-neutral: holes of the sparse colour volume (reference
    loss.py:333-345)."""
    c = raycast_color
    if color_space == "rgb":
        thresh = float(color_thresh) / 255.0
        return (c[..., 0] < thresh) & (c[..., 1] < thresh) & (c[..., 2] < thresh)
    if color_space == "lab":
        t = 0.01
        return ((c[..., 0] < t) & (c[..., 1] > 0.5 - t) & (c[..., 1] < 0.5 + t)
                & (c[..., 2] > 0.5 - t) & (c[..., 2] < 0.5 + t))
    raise ValueError(color_space)


def preprocess_rendered_target_images(render: torch.Tensor, target: torch.Tensor):
    """Copy target pixels into the invalid (-inf) pixels of the render
    (reference style.py:24-29). Returns (render', target)."""
    return torch.where(render == -torch.inf, target, render), target
