"""SDF-gradient normals on dense voxel grids (PyTorch counterpart of
``spsg_tpu/ops/normals3d.py``; reference torch/loss.py:261-306).

Unscaled central differences with a zero boundary, an optional grid->camera
rotation, and the *negated* L2-normalised result, channel-last. Plain PyTorch:
a few elementwise passes that autograd differentiates."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def sdf_gradient(sdf: torch.Tensor) -> torch.Tensor:
    """Unscaled central differences of a (B, Z, Y, X) grid -> (B, Z, Y, X, 3)
    in (x, y, z) component order. Boundary voxels are zero (the reference pads
    them with -inf and later zeroes them, loss.py:272-275)."""
    gx = sdf[:, 1:-1, 1:-1, 2:] - sdf[:, 1:-1, 1:-1, :-2]
    gy = sdf[:, 1:-1, 2:, 1:-1] - sdf[:, 1:-1, :-2, 1:-1]
    gz = sdf[:, 2:, 1:-1, 1:-1] - sdf[:, :-2, 1:-1, 1:-1]
    pad = (1, 1, 1, 1, 1, 1)
    return torch.stack([F.pad(gx, pad), F.pad(gy, pad), F.pad(gz, pad)], dim=-1)


def surface_normals(
    sdf: torch.Tensor,
    valid: torch.Tensor,
    rotation: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Dense surface normals of a sparsified SDF grid: ``-normalize(R @ grad)``
    of the grid with non-surface voxels set to 0, zero where the gradient is
    zero. sdf, valid (B, Z, Y, X); rotation optional (B, 3, 3) grid->camera.
    Returns (B, Z, Y, X, 3)."""
    masked = torch.where(valid, sdf, 0.0)
    g = sdf_gradient(masked)
    if rotation is not None:
        r = rotation[:, None, None, None]  # (B,1,1,1,3,3)
        g = torch.stack([r[..., i, 0] * g[..., 0] + r[..., i, 1] * g[..., 1]
                         + r[..., i, 2] * g[..., 2] for i in range(3)], dim=-1)
    # safe norm: sqrt(max(|g|^2, eps^2)) has a finite gradient at g = 0, where
    # the backward of norm(g) is 0 * inf = NaN (these normals are shaded by the
    # prediction's raycast and carry gradient back to the SDF)
    norm2 = (g * g).sum(dim=-1, keepdim=True)
    norm = torch.sqrt(torch.clamp(norm2, min=1e-10))
    return -g / norm
