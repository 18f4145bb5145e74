"""Color-space conversions (RGB <-> HSV <-> CIELAB).

Host-side numpy versions for the data pipeline (replacing the reference's
skimage + scalar C++ color_utils, torch/data_util.py:339-576 and
torch/utils/color_utils_cpu); the LAB functions also take torch tensors
(``xp=torch``, differentiable, any device; replacing
torch/data_util.py:492-576).

Conventions follow the reference exactly:
  - HSV: H in [0, 360), S,V in [0, 1].
  - LAB: L in [0, 100], a,b roughly [-100, 100] (D65, sRGB gamma).
  - "lab01": L/100 in [0,1], (ab+100)/200 in [0,1] — the network color space.
"""

from __future__ import annotations

import numpy as np
import torch

# sRGB <-> XYZ matrices (reference torch/data_util.py:502-504, 538-540)
_XYZ_FROM_RGB = np.array(
    [
        [0.412453, 0.357580, 0.180423],
        [0.212671, 0.715160, 0.072169],
        [0.019334, 0.119193, 0.950227],
    ],
    dtype=np.float32,
)
_RGB_FROM_XYZ = np.array(
    [
        [3.2405, -1.5372, -0.4985],
        [-0.9693, 1.8760, 0.0416],
        [0.0556, -0.2040, 1.0573],
    ],
    dtype=np.float32,
)
_D65_WHITE = np.array([0.95047, 1.0, 1.08883], dtype=np.float32)


# ---------------------------------------------------------------------------
# HSV (numpy; used for hue augmentation on the host — reference
# torch/data_util.py:366-468, scene_dataloader.py:194-220)
# ---------------------------------------------------------------------------


def rgb_to_hsv_np(rgb: np.ndarray) -> np.ndarray:
    """RGB [0,1] -> HSV (H in [0,360)); rgb shape (..., 3).

    Matches reference convert_rgbgrid_to_hsvgrid (data_util.py:366-392)
    including its zero-sum masking behavior."""
    rgb = rgb.astype(np.float32)
    mn = np.min(rgb, axis=-1)
    mx = np.max(rgb, axis=-1)
    nonzero = np.sum(rgb, axis=-1) > 0.01
    hsv = np.zeros_like(rgb)
    hsv[..., 2] = mx
    delta = mx - mn
    safe_mx = np.where(mx == 0, 1.0, mx)
    s = np.where(nonzero, delta / safe_mx, 0.0)
    hsv[..., 1] = np.where(nonzero, s, hsv[..., 1])

    safe_delta = np.where(delta == 0, 1.0, delta)
    h_r = 60.0 * (0 + (rgb[..., 1] - rgb[..., 2]) / safe_delta)
    h_g = 60.0 * (2 + (rgb[..., 2] - rgb[..., 0]) / safe_delta)
    h_b = 60.0 * (4 + (rgb[..., 0] - rgb[..., 1]) / safe_delta)
    h = np.zeros_like(mx)
    is_r = rgb[..., 0] == mx
    is_g = (rgb[..., 1] == mx) & ~is_r
    is_b = (rgb[..., 2] == mx) & ~is_r & ~is_g
    h = np.where(is_b, h_b, h)
    h = np.where(is_g, h_g, h)
    h = np.where(is_r, h_r, h)
    h = np.where(delta == 0, 0.0, h)
    h = np.where(h < 0, h + 360.0, h)
    hsv[..., 0] = h
    return hsv


def hsv_to_rgb_np(hsv: np.ndarray) -> np.ndarray:
    """HSV (H in [0,360]) -> RGB [0,1]; hsv shape (..., 3).

    Matches reference convert_hsvgrid_to_rgbgrid (data_util.py:418-468)."""
    hd = hsv[..., 0] / 60.0
    h = np.floor(hd)
    f = hd - h
    v = hsv[..., 2]
    s = hsv[..., 1]
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    rgb = np.zeros_like(hsv)
    cases = [
        (np.logical_or(h == 0, h == 6), (v, t, p)),
        (h == 1, (q, v, p)),
        (h == 2, (p, v, t)),
        (h == 3, (p, q, v)),
        (h == 4, (t, p, v)),
        (h == 5, (v, p, q)),
    ]
    for mask, (r_, g_, b_) in cases:
        rgb[..., 0] = np.where(mask, r_, rgb[..., 0])
        rgb[..., 1] = np.where(mask, g_, rgb[..., 1])
        rgb[..., 2] = np.where(mask, b_, rgb[..., 2])
    return rgb


def augment_hue_np(rgb_u8: np.ndarray, scale: float) -> np.ndarray:
    """Hue-scale augmentation of a uint8 RGB grid (reference
    scene_dataloader.py:194-211): h' = (h * scale) mod 360."""
    hsv = rgb_to_hsv_np(rgb_u8.astype(np.float32) / 255.0)
    scaled = hsv[..., 0] * scale
    hsv[..., 0] = np.where(scaled >= 360.0, scaled % 360.0, scaled)
    return np.clip(hsv_to_rgb_np(hsv) * 255.0, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# LAB (numpy host + differentiable torch device versions)
# ---------------------------------------------------------------------------


def _const(a, like, xp):
    """A module constant as ``xp``'s array type, on ``like``'s device."""
    if xp is np:
        return a
    return torch.as_tensor(a, dtype=like.dtype, device=like.device)


def _stack(parts, xp):
    return np.stack(parts, axis=-1) if xp is np else torch.stack(parts, dim=-1)


def _concat(parts, xp):
    return np.concatenate(parts, axis=-1) if xp is np else torch.cat(parts, dim=-1)


def _srgb_to_linear(c, xp):
    mask = c > 0.0405  # reference data_util.py:498 uses 0.0405
    return xp.where(mask, ((c + 0.055) / 1.055) ** 2.4, c / 12.92)


def _linear_to_srgb(c, xp):
    mask = c > 0.0031308
    safe = xp.where(mask, c, 1.0)
    return xp.where(mask, 1.055 * safe ** (1.0 / 2.4) - 0.055, c * 12.92)


def _f_lab(t, xp):
    mask = t > 0.008856
    safe = xp.where(mask, t, 1.0)
    return xp.where(mask, safe ** (1.0 / 3.0), 7.787 * t + 16.0 / 116.0)


def rgb_to_lab(rgb, xp=np):
    """RGB [0,1] -> LAB (L [0,100], ab ~[-100,100]); shape (..., 3).

    Matches reference convert_rgb_to_lab_pt (data_util.py:492-517); works with
    numpy (xp=np) or torch tensors (xp=torch, differentiable)."""
    lin = _srgb_to_linear(rgb, xp)
    xyz = lin @ _const(_XYZ_FROM_RGB.T, lin, xp)
    xyz = xyz / _const(_D65_WHITE, lin, xp)
    fxyz = _f_lab(xyz, xp)
    l = 116.0 * fxyz[..., 1] - 16.0
    a = 500.0 * (fxyz[..., 0] - fxyz[..., 1])
    b = 200.0 * (fxyz[..., 1] - fxyz[..., 2])
    return _stack([l, a, b], xp)


def lab_to_rgb(lab, xp=np):
    """LAB -> RGB [0,1]; matches reference convert_lab_to_rgb_pt
    (data_util.py:520-548) including its z<0 clamp."""
    y = (lab[..., 0] + 16.0) / 116.0
    x = lab[..., 1] / 500.0 + y
    z = y - lab[..., 2] / 200.0
    z = xp.where(z < 0, 0.0, z)
    xyz = _stack([x, y, z], xp)
    mask = xyz > 0.2068966
    safe = xp.where(mask, xyz, 1.0)
    xyz = xp.where(mask, safe**3.0, (xyz - 16.0 / 116.0) / 7.787)
    xyz = xyz * _const(_D65_WHITE, xyz, xp)
    rgb = xyz @ _const(_RGB_FROM_XYZ.T, xyz, xp)
    rgb = _linear_to_srgb(rgb, xp)
    return xp.clip(rgb, 0.0, 1.0)


def lab01_to_rgb(lab01, xp=torch):
    """Network color space ([0,1]-normalized LAB) -> RGB [0,1]
    (reference convert_lab01_to_rgb_pt, data_util.py:566-576)."""
    l = lab01[..., :1] * 100.0
    ab = (lab01[..., 1:] * 2.0 - 1.0) * 100.0
    return lab_to_rgb(_concat([l, ab], xp), xp=xp)


def rgb_to_lab01(rgb, xp=np):
    """RGB [0,1] -> [0,1]-normalized LAB (the encoding used for network
    inputs/targets; reference scene_dataloader.py:222-231)."""
    lab = rgb_to_lab(rgb, xp=xp)
    l = lab[..., :1] / 100.0
    ab = (lab[..., 1:] + 100.0) / 200.0
    return _concat([l, ab], xp)
