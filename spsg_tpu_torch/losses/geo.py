"""3D geometry losses (PyTorch counterpart of ``spsg_tpu/losses/geo.py``;
reference torch/loss.py:8-243 + train.py:448-512).

All losses are dense masked reductions over (B, Z, Y, X[, C]) grids, as in the
JAX package: ``masked_mean(x, m) == x[m].mean()`` exactly, without the dynamic
shapes (and the host synchronisation) of a boolean select. Every function
returns device tensors; none reads a value back to the host."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def masked_mean(x: torch.Tensor, mask: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    m = mask.to(x.dtype)
    return (x * m).sum() / torch.clamp(m.sum(), min=eps)


def apply_log_transform(sdf: torch.Tensor) -> torch.Tensor:
    """sign(x) * log(|x| + 1) (reference loss.py:15-19)."""
    return torch.sign(sdf) * torch.log1p(sdf.abs())


def compute_targets(target_sdf: torch.Tensor, truncation: float) -> torch.Tensor:
    """Clamp targets to +-truncation; -inf (unobserved) becomes -truncation
    (reference loss.py:8-12 + data_util.py:187-190)."""
    return torch.clamp(target_sdf, -truncation, truncation)


def dense_geo_weights(
    target_sdf: torch.Tensor,
    input_occ: torch.Tensor,
    truncation: float,
    weight_surf_geo: float,
    weight_missing_geo: float,
) -> torch.Tensor:
    """Per-voxel weights: surface voxels get weight_surf_geo, surface voxels
    missing from the input get weight_missing_geo (reference loss.py:29-35)."""
    w = torch.ones_like(target_sdf)
    surf = target_sdf.abs() < truncation - 0.01
    if weight_surf_geo > 1:
        w = torch.where(surf, weight_surf_geo, w)
    if weight_missing_geo > 1:
        w = torch.where(surf & ~input_occ, weight_missing_geo, w)
    return w


def occ_loss(
    target_sdf: torch.Tensor,
    occ_logits: torch.Tensor,
    known: Optional[torch.Tensor],
    weight: Optional[torch.Tensor],
    truncation: float,
) -> torch.Tensor:
    """Weighted BCE-with-logits on occupancy, masked to known space
    (reference compute_geo_occ_loss_dense, loss.py:130-146), in the stable
    form max(l, 0) - l*t + log1p(exp(-|l|))."""
    target = (target_sdf.abs() < truncation).float()
    logits = occ_logits
    bce = torch.clamp(logits, min=0) - logits * target + torch.log1p(torch.exp(-logits.abs()))
    if weight is not None:
        bce = bce * weight
    mask = torch.ones_like(target) if known is None else known.float()
    return masked_mean(bce, mask)


def occ_iou(
    target_sdf: torch.Tensor,
    occ_logits: torch.Tensor,
    known: Optional[torch.Tensor],
    truncation: float,
) -> torch.Tensor:
    """Occupancy IoU at sigmoid > 0.5, within known space (reference
    compute_iou_occ_dense, loss.py:216-231). Returns -1 when the union is
    empty."""
    target = target_sdf.abs() < truncation
    pred = torch.sigmoid(occ_logits) > 0.5
    if known is not None:
        k = known.bool()
        target = target & k
        pred = pred & k
    inter = (pred & target).sum()
    union = (pred | target).sum()
    iou = inter.float() / torch.clamp(union, min=1).float()
    return torch.where(union > 0, iou, torch.full_like(iou, -1.0))


def sdf_l1_loss(
    target_sdf: torch.Tensor,
    pred_sdf: torch.Tensor,
    known: Optional[torch.Tensor],
    weight: Optional[torch.Tensor],
    log_transform: bool = True,
) -> torch.Tensor:
    """(log-)L1 SDF regression, masked to known space (reference
    compute_geo_loss_dense, loss.py:86-114)."""
    t = target_sdf
    p = pred_sdf
    if log_transform:
        t = apply_log_transform(t)
        p = apply_log_transform(p)
    l1 = (t - p).abs()
    if weight is not None:
        l1 = l1 * weight
    mask = torch.ones_like(l1) if known is None else known.float()
    return masked_mean(l1, mask)


def missing_geo_mask(input_occ: torch.Tensor, target_sdf: torch.Tensor,
                     truncation: float) -> torch.Tensor:
    """Target-surface voxels in 8x8x8 blocks with no input geometry
    (reference compute_missing_geo_mask, loss.py:348-356). Inputs are
    (B, Z, Y, X) bool/float."""
    pooled = F.max_pool3d(input_occ.float()[:, None], kernel_size=8, stride=8)[:, 0]
    up = pooled.repeat_interleave(8, 1).repeat_interleave(8, 2).repeat_interleave(8, 3)
    mask = target_sdf.abs() < truncation
    return mask & ~(up > 0)
