"""Evaluation metrics (PyTorch counterpart of ``spsg_tpu/inference/metrics.py``;
reference torch/metrics.py:1-104): SSIM on rendered images, bidirectional
Chamfer distance on surface samples, voxelised surface IoU / recall, FID, and
Feature-l1 through Inception-v3.

The host metrics (``ssim``, ``chamfer_distance``, ``chamfer_between_meshes``,
``voxelize_mesh``, ``mesh_iou_recall``, ``fid``) are numpy / scipy, copies of
the JAX package's. Inception-v3 (``feature_l1``, ``image_features``) runs on
``device``: the GPU unless the caller asks for the CPU; ``"cuda"`` without a
GPU raises. The module is loaded once per (weights path, device)."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def ssim(img1: np.ndarray, img2: np.ndarray, window: int = 11, sigma: float = 1.5,
         data_range: float = 255.0) -> float:
    """Gaussian-weighted SSIM (Wang et al. 2004; replaces SSIM_PIL at
    reference metrics.py:84-103). img: (H, W[, C]) float/uint8."""
    from scipy.ndimage import gaussian_filter

    x = np.asarray(img1, np.float64)
    y = np.asarray(img2, np.float64)
    if x.ndim == 3:
        return float(np.mean([ssim(x[..., c], y[..., c], window, sigma, data_range)
                              for c in range(x.shape[-1])]))
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    mu_x = gaussian_filter(x, sigma)
    mu_y = gaussian_filter(y, sigma)
    mu_x2 = mu_x * mu_x
    mu_y2 = mu_y * mu_y
    mu_xy = mu_x * mu_y
    sx = gaussian_filter(x * x, sigma) - mu_x2
    sy = gaussian_filter(y * y, sigma) - mu_y2
    sxy = gaussian_filter(x * y, sigma) - mu_xy
    s = ((2 * mu_xy + c1) * (2 * sxy + c2)) / ((mu_x2 + mu_y2 + c1) * (sx + sy + c2))
    return float(s.mean())


def chamfer_distance(
    pts_a: np.ndarray, pts_b: np.ndarray, bidirectional: bool = True
) -> float:
    """Mean squared nearest-neighbor distance, both directions summed
    (reference metrics.py:43,67-82 via chamferdist). pts: (N, 3)."""
    from scipy.spatial import cKDTree

    ta = cKDTree(pts_a)
    tb = cKDTree(pts_b)
    d_ab, _ = tb.query(pts_a, k=1)
    total = float(np.mean(d_ab**2))
    if bidirectional:
        d_ba, _ = ta.query(pts_b, k=1)
        total += float(np.mean(d_ba**2))
    return total


def chamfer_between_meshes(
    verts_a, faces_a, verts_b, faces_b, num_samples: int = 30000, seed: int = 0
) -> float:
    """Chamfer on 30k area-uniform surface samples (reference
    metrics.py:43,67-82)."""
    from ..ops.mesh import sample_point_cloud

    pa = sample_point_cloud(np.asarray(verts_a), np.asarray(faces_a), num_samples, seed)
    pb = sample_point_cloud(np.asarray(verts_b), np.asarray(faces_b), num_samples, seed + 1)
    return chamfer_distance(pa, pb)


_INCEPTION_PATH = ""
_INCEPTION_MODELS: Dict[Tuple[str, str], object] = {}


def set_inception_path(path: str) -> None:
    """Point the extractor at a torchvision inception_v3 .pth
    (--inception_v3_path, reference metrics.py:37); the next call loads it."""
    global _INCEPTION_PATH
    _INCEPTION_PATH = path
    _INCEPTION_MODELS.clear()


def _inception(device):
    """Inception-v3 on ``device`` (reference: torchvision inception_v3,
    metrics.py:45-53; rebuilt in models/inception.py), loaded once per weights
    path and device. Pretrained when a torchvision .pth is found, else
    fixed-seed random features (still a distance, not ImageNet-aligned; a
    warning fires). Returns (module, its device)."""
    from ..models.inception import load_inception
    from ..training.state import resolve_device

    device = resolve_device(device)
    key = (_INCEPTION_PATH, str(device))
    if key not in _INCEPTION_MODELS:
        _INCEPTION_MODELS[key] = load_inception(_INCEPTION_PATH, device)
    return _INCEPTION_MODELS[key], device


def _inception_outputs(images, device):
    """[(pool (1, 2048), logits (1, 1000))] of each (H, W, 3) RGB image in
    [0, 1], one forward an image (the images of a set may differ in size)."""
    from ..models.inception import preprocess

    model, device = _inception(device)
    out = []
    with torch.no_grad():
        for im in images:
            x = torch.as_tensor(np.asarray(im, np.float32), device=device)[None]
            out.append(model(preprocess(x)))
    return out


def feature_l1(img1: np.ndarray, img2: np.ndarray, device="cuda") -> float:
    """Mean absolute difference of the Inception-v3 logits of two RGB images
    in [0, 1] (reference metrics.py:92-100 feeds the images through eval
    inception_v3, i.e. class logits, and differences the outputs; the mean of
    |.| here, as in the JAX package, where the reference's raw ``sum(a - b)``
    would cancel signs)."""
    (_, fa), (_, fb) = _inception_outputs([img1, img2], device)
    return float((fa - fb).abs().mean())


def voxelize_mesh(
    verts: np.ndarray,
    faces: np.ndarray,
    voxel_size: float,
    origin: Optional[np.ndarray] = None,
    dims: Optional[Tuple[int, int, int]] = None,
    samples_per_voxel_area: float = 4.0,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray]:
    """Surface-voxelize a triangle mesh: mark every voxel the surface passes
    through (dense area-proportional sampling at ``samples_per_voxel_area``
    points per voxel_size^2 of surface, plus all vertices — conservative
    enough for metric purposes). Returns (occ (Z,Y,X) bool, origin xyz).

    Completes the reference's own unfinished metric ("TODO voxelize mesh
    (with interior?) -> for IoU and Recall", metrics.py:64): the sampled
    voxelization matches how the reference measures meshes elsewhere (30k
    surface samples for Chamfer, metrics.py:69-75)."""
    verts = np.asarray(verts, np.float32)
    faces = np.asarray(faces, np.int64)
    if origin is None:
        origin = np.floor(verts.min(0) / voxel_size) * voxel_size - voxel_size
    origin = np.asarray(origin, np.float32)
    if dims is None:
        hi = verts.max(0)
        n = np.ceil((hi - origin) / voxel_size).astype(np.int64) + 2
        dims = (int(n[2]), int(n[1]), int(n[0]))  # zyx
    v0, v1, v2 = verts[faces[:, 0]], verts[faces[:, 1]], verts[faces[:, 2]]
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    total = float(areas.sum())
    n_samples = int(max(1, samples_per_voxel_area * total / (voxel_size**2)))
    n_samples = min(n_samples, 20_000_000)  # cap host memory
    from ..ops.mesh import sample_point_cloud

    pts = sample_point_cloud(verts, faces, n_samples, seed)
    pts = np.concatenate([pts, verts], axis=0)
    ijk = np.floor((pts - origin) / voxel_size).astype(np.int64)  # xyz order
    Z, Y, X = dims
    ok = (
        (ijk[:, 0] >= 0) & (ijk[:, 0] < X)
        & (ijk[:, 1] >= 0) & (ijk[:, 1] < Y)
        & (ijk[:, 2] >= 0) & (ijk[:, 2] < Z)
    )
    ijk = ijk[ok]
    occ = np.zeros(dims, bool)
    occ[ijk[:, 2], ijk[:, 1], ijk[:, 0]] = True
    return occ, origin


def mesh_iou_recall(
    pred_verts, pred_faces, tgt_verts, tgt_faces, voxel_size: float = 0.02,
    samples_per_voxel_area: float = 4.0,
) -> Tuple[float, float]:
    """Voxelized surface IoU and Recall (|pred ∩ tgt| / |tgt|) between two
    meshes on a shared grid (reference metrics.py:64 TODO, completed)."""
    pv = np.asarray(pred_verts, np.float32)
    tv = np.asarray(tgt_verts, np.float32)
    allv = np.concatenate([pv, tv], axis=0) if len(pv) and len(tv) else (pv if len(pv) else tv)
    origin = np.floor(allv.min(0) / voxel_size) * voxel_size - voxel_size
    hi = allv.max(0)
    n = np.ceil((hi - origin) / voxel_size).astype(np.int64) + 2
    dims = (int(n[2]), int(n[1]), int(n[0]))
    po, _ = voxelize_mesh(pv, pred_faces, voxel_size, origin, dims, samples_per_voxel_area)
    to, _ = voxelize_mesh(tv, tgt_faces, voxel_size, origin, dims, samples_per_voxel_area)
    inter = int(np.sum(po & to))
    union = int(np.sum(po | to))
    iou = inter / union if union else float("nan")
    recall = inter / int(np.sum(to)) if to.any() else float("nan")
    return iou, recall


def fid(features_a: np.ndarray, features_b: np.ndarray, eps: float = 1e-6) -> float:
    """Frechet distance between two Gaussian fits of feature sets
    (Heusel et al. 2017). The reference only points at the external TTUR
    repo (metrics.py:7 docstring); this is a self-contained implementation.
    features: (N, D) pooled deep features per image."""
    import scipy.linalg

    a = np.asarray(features_a, np.float64)
    b = np.asarray(features_b, np.float64)
    mu_a, mu_b = a.mean(0), b.mean(0)
    ca = np.cov(a, rowvar=False) + eps * np.eye(a.shape[1])
    cb = np.cov(b, rowvar=False) + eps * np.eye(b.shape[1])
    # without ``disp``, which SciPy 1.18 removed (the JAX package's copy passes
    # disp=False); the same matrix on the versions that still take it
    covmean = np.real(scipy.linalg.sqrtm(ca @ cb))
    diff = mu_a - mu_b
    return float(diff @ diff + np.trace(ca) + np.trace(cb) - 2.0 * np.trace(covmean))


def image_features(images, device="cuda") -> np.ndarray:
    """Inception-v3 2048-dim pool features (N, 2048) of a list of RGB images
    in [0, 1] (what fid() takes; the standard FID feature layer)."""
    return np.stack([pool[0].cpu().numpy() for pool, _ in _inception_outputs(images, device)])
