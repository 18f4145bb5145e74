"""Semantic cross-entropy losses, 3D and 2D (PyTorch counterpart of
``spsg_tpu/losses/semantic.py``; reference train.py:736-752).

The reference computes ``F.cross_entropy`` with per-class weights over
dynamically selected voxels/pixels; here, as in the JAX package, they are dense
masked reductions. The weighted CE is normalised by the sum of the selected
samples' class weights, which is what ``F.cross_entropy(weight=...)`` does.
With ``mesh`` both sums are over the global batch (``losses/geo.py``)."""

from __future__ import annotations

import torch

from ._single import global_sum

UNLABELED = 14


def weighted_cross_entropy(
    logits: torch.Tensor,  # (..., C)
    labels: torch.Tensor,  # (...) int
    mask: torch.Tensor,  # (...) bool
    class_weights: torch.Tensor,  # (C,)
    mesh=None,
) -> torch.Tensor:
    """sum_i m_i * w[y_i] * ce_i / sum_i m_i * w[y_i] (used at reference
    train.py:741,745). Labels are clipped into range before the gather, so an
    unlabeled voxel may carry any value as long as its mask is off."""
    c = logits.shape[-1]
    labels_c = torch.clamp(labels.long(), 0, c - 1)
    logp = torch.log_softmax(logits, dim=-1)
    ce = -torch.gather(logp, -1, labels_c[..., None])[..., 0]
    w = class_weights[labels_c] * mask.to(logits.dtype)
    return global_sum((w * ce).sum(), mesh) / torch.clamp(global_sum(w.sum(), mesh), min=1e-12)


def semantic_3d_loss(
    sem_logits: torch.Tensor,  # (B, Z, Y, X, C)
    target_sem: torch.Tensor,  # (B, Z, Y, X) uint8
    surface_mask: torch.Tensor,  # (B, Z, Y, X) bool: predicted surface voxels
    class_weights: torch.Tensor,
    mesh=None,
) -> torch.Tensor:
    """3D semantic CE over predicted-surface voxels with labeled targets
    (reference train.py:736-742: locs from |pred sdf|<trunc & ~empty, targets
    < 14)."""
    labels = target_sem.long()
    mask = surface_mask & (labels < UNLABELED)
    return weighted_cross_entropy(sem_logits, labels, mask, class_weights, mesh)


def semantic_2d_loss(
    raycast_sem: torch.Tensor,  # (B, H, W, C) rendered logits (-inf invalid)
    target_label: torch.Tensor,  # (B, H, W) int labels (UNLABELED = ignore)
    class_weights: torch.Tensor,
    mesh=None,
) -> torch.Tensor:
    """2D semantic CE on rendered logits vs rendered target labels
    (reference train.py:743-747)."""
    valid = (target_label < UNLABELED) & (raycast_sem[..., 0] != -torch.inf)
    logits = torch.where(torch.isfinite(raycast_sem), raycast_sem, 0.0)
    return weighted_cross_entropy(logits, target_label, valid, class_weights, mesh)


def rendered_semantic_label(raycast_sem: torch.Tensor) -> torch.Tensor:
    """argmax over rendered semantic channels with an implicit always-1
    "unlabeled" channel appended (reference train.py:613-616, 749-752):
    invalid (-inf) pixels and low-score pixels map to UNLABELED."""
    ones = torch.ones(raycast_sem.shape[:-1] + (1,), dtype=raycast_sem.dtype,
                      device=raycast_sem.device)
    return torch.argmax(torch.cat([raycast_sem, ones], dim=-1), dim=-1).to(torch.int32)
