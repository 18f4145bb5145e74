"""Output-folded odd-kernel stride-1 conv: a (gy, gx) block of output pixels
per matmul row (PyTorch counterpart of ``spsg_tpu/ops/folded_conv.py``).

    P (B*Z*Ty*Tx, kz*(gy+ky-1)*(gx+kx-1)*C)  @  W' (K, gy*gx*F)

where P holds the *union* input patch of the gy*gx output phases and W' is
the kernel scattered block-Toeplitz-style: output phase (jy, jx) reads union
taps (uy, ux) = (jy+dy, jx+dx), zero elsewhere. The JAX package widens the
TPU matmul's lane dimension this way (F = 20 fills 20 of 128 lanes); on a card
the product is one ``torch.matmul`` (cuBLAS, in the input's type) and the
fold only chooses the product's shape. The patch tensor is
kz*(gy+ky-1)*(gx+kx-1)/(gy*gx) times the input, so the backward recomputes it
from the padded input instead of keeping it (the JAX package's
``jax.checkpoint``). The port's generator does not call it: with
``GeneratorConfig.folded_conv`` the layers the JAX package folds (the 5^3
entry convs) take the z-slab form of ``ops/zslab_conv.py``, which is the
faster of the two on an H100 for both; ``chip_smoke.py`` (phase
``conv_forms``) times this form beside the other two on those layers.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["pick_fold", "fold_win", "conv3x3_folded", "conv_folded"]


def fold_win(gy: int, gx: int, k: int = 3) -> float:
    """The JAX package's figure of merit: the matmul-lane work of a
    lane-padded F < 128 conv, k^3*C*128 per output pixel, over that of the
    folded union-patch product, k*(gy+k-1)*(gx+k-1)*C*128/(gy*gx)."""
    return k * k * gy * gx / ((gy + k - 1) * (gx + k - 1))


def pick_fold(y_dim: int, x_dim: int, features: int, max_lanes: int = 128,
              folds: Tuple[int, ...] = (1, 2, 4, 8), k: int = 3) -> Tuple[int, int]:
    """The (gy, gx) that maximises :func:`fold_win` among those that divide
    (y_dim, x_dim) within the lane budget gy*gx*features <= max_lanes; (1, 1)
    when no fold helps (features >= 128 already fills the lanes).

    The rule, the 128-lane budget included, is the JAX package's, so that one
    configuration picks the same fold in both packages. A card has no lanes to
    fill: there the fold only chooses the product's tile (rows by gy*gx*F
    columns)."""
    best, best_win = (1, 1), 1.0
    for gy in folds:
        if y_dim % gy:
            continue
        for gx in folds:
            if x_dim % gx or gy * gx == 1:
                continue
            if gy * gx * features > max_lanes:
                continue
            w = fold_win(gy, gx, k)
            if w > best_win + 1e-9:
                best, best_win = (gy, gx), w
    return best


@functools.lru_cache(maxsize=None)
def _selector(g: int, k: int) -> np.ndarray:
    """S[u, j, d] = 1 where union tap u == output phase j + kernel tap d."""
    s = np.zeros((g + k - 1, g, k), np.float32)
    for j in range(g):
        for d in range(k):
            s[j + d, j, d] = 1.0
    return s


def _fold_weights(kernel: torch.Tensor, gy: int, gx: int) -> torch.Tensor:
    """(kz,ky,kx,C,F) kernel -> ((gx+kx-1)*(gy+ky-1)*kz*C, gy*gx*F) matrix.

    Row index order (ux, uy, dz, c) matches :func:`_extract`'s patch layout;
    column index order (jy, jx, f) matches the output phase unfold in
    :func:`conv_folded`."""
    kz, ky, kx, c, f = kernel.shape
    sy = torch.from_numpy(_selector(gy, ky)).to(kernel.device, kernel.dtype)
    sx = torch.from_numpy(_selector(gx, kx)).to(kernel.device, kernel.dtype)
    w = torch.einsum("zyxcf,ujy,vkx->vuzcjkf", kernel, sy, sx)
    return w.reshape((gx + kx - 1) * (gy + ky - 1) * kz * c, gy * gx * f)


def _extract(xp: torch.Tensor, gy: int, gx: int, kz: int, ky: int, kx: int) -> torch.Tensor:
    """Union patches of a SAME-padded (B, Z+kz-1, Y+ky-1, X+kx-1, C) input.

    Returns (B, Z, Ty, Tx, (gx+kx-1)*(gy+ky-1)*kz*C) with patch index (ux,
    uy, dz, c), built from kz + (gy+ky-1) + (gx+kx-1) strided slices (z, then
    y, then x)."""
    _, zp, yp, xpd, _ = xp.shape
    z, y, x = zp - (kz - 1), yp - (ky - 1), xpd - (kx - 1)
    ty, tx = y // gy, x // gx
    # z unfold: (B, Z, Y+ky-1, X+kx-1, kz*C), channel index (dz, c)
    v = torch.cat([xp[:, dz: dz + z] for dz in range(kz)], dim=-1)
    # y unfold (strided): (B, Z, Ty, X+kx-1, (gy+ky-1)*kz*C), index (uy, dz, c)
    v = torch.cat([v[:, :, uy: uy + gy * (ty - 1) + 1: gy] for uy in range(gy + ky - 1)],
                  dim=-1)
    # x unfold (strided): index (ux, uy, dz, c)
    return torch.cat([v[:, :, :, ux: ux + gx * (tx - 1) + 1: gx] for ux in range(gx + kx - 1)],
                     dim=-1)


class _PatchMatmul(torch.autograd.Function):
    """``_extract(xp) @ w`` that keeps the padded input, not the patches: the
    backward extracts them again for the weight's gradient, and takes the
    input's through the adjoint of the extraction (autograd of the slices)."""

    @staticmethod
    def forward(ctx, xp, w, geom):
        ctx.geom = geom
        ctx.save_for_backward(xp, w)
        return torch.matmul(_extract(xp, *geom), w)

    @staticmethod
    def backward(ctx, dy):
        xp, w = ctx.saved_tensors
        need_x, need_w = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            xl = xp.detach().requires_grad_(need_x)
            patches = _extract(xl, *ctx.geom)
        dxp = dw = None
        if need_w:
            dw = patches.detach().reshape(-1, w.shape[0]).t() @ dy.reshape(-1, w.shape[1])
        if need_x:
            (dxp,) = torch.autograd.grad(patches, xl, torch.matmul(dy, w.t()))
        return dxp, dw, None


def conv_folded(x: torch.Tensor, kernel: torch.Tensor, fold: Tuple[int, int]) -> torch.Tensor:
    """Odd-kernel stride-1 SAME conv of channel-last ``x`` with ``kernel``
    (kz,ky,kx,C,F), computed as one patch product with gy*gx*F columns.
    ``fold`` = (gy, gx) must divide the output's (Y, X): use :func:`pick_fold`.
    Bias is the caller's."""
    gy, gx = fold
    b, z, y, x_dim, _ = x.shape
    kz, ky, kx, _, f = kernel.shape
    if kz % 2 == 0 or ky % 2 == 0 or kx % 2 == 0:
        raise ValueError(f"conv_folded needs odd kernel dims, got {(kz, ky, kx)}")
    if y % gy or x_dim % gx:
        raise ValueError(f"fold {fold} does not divide spatial dims {(y, x_dim)}")
    ty, tx = y // gy, x_dim // gx
    xp = F.pad(x, (0, 0, kx // 2, kx // 2, ky // 2, ky // 2, kz // 2, kz // 2))
    ymat = _PatchMatmul.apply(xp, _fold_weights(kernel, gy, gx), (gy, gx, kz, ky, kx))
    yblk = ymat.reshape(b, z, ty, tx, gy, gx, f)  # (B, Z, Ty, Tx, gy*gx*F) unfolded
    return yblk.permute(0, 1, 2, 4, 3, 5, 6).reshape(b, z, y, x_dim, f)


def conv3x3_folded(x: torch.Tensor, kernel: torch.Tensor, fold: Tuple[int, int]) -> torch.Tensor:
    """3x3x3 alias of :func:`conv_folded` (the JAX package's first entry point)."""
    return conv_folded(x, kernel, fold)
