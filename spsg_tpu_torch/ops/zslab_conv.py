"""Z-slab conv: a channel-last 3D conv computed as ONE 2D conv by folding the
kz kernel taps into the channel dimension (PyTorch counterpart of
``spsg_tpu/ops/zslab_conv.py``).

    x_slab (B*Zo, Y, X, kz*C)  =  concat_dz x_padded[:, dz*dil_z :: sz]
    y = conv2d(x_slab, W (F, kz*C, ky, kx), strides (sy, sx))

Output z index zo reads input taps ``zo*sz - pz + dz*dil_z``, so the form
covers every conv of the generator: odd and even kernels (5^3 pad 2, 4^3
stride 2 pad 1, 3^3 pad 1), anisotropic strides and kernel dilation. The
z-neighbour stack is a pad, kz strided slices and a concatenation; its
transient is kz*C channels, freed after the conv. The 2D conv is cuDNN's on a
card (``F.conv2d`` on the channels-last 4D view: no copy into NCHW), in the
input's type; autograd is PyTorch's. ``generator.ConvBlock`` sends every conv
that the hand kernels of ``ops/conv3x3.py`` do not take through it with
``GeneratorConfig.zslab_conv``.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F

__all__ = ["conv3d_zslab"]

_IntOr3 = Union[int, Sequence[int]]


def _tup3(v: _IntOr3) -> Tuple[int, int, int]:
    return (v, v, v) if isinstance(v, int) else tuple(v)  # type: ignore


def conv3d_zslab(x: torch.Tensor, w: torch.Tensor, strides: _IntOr3 = 1,
                 padding: _IntOr3 = 1, dilation: _IntOr3 = 1) -> torch.Tensor:
    """3D conv (channel-last input, zero padding) via one 2D conv.

    Args:
      x: (B, Z, Y, X, C) input.
      w: (kz, ky, kx, C, F) kernel (the JAX package's layout).
      strides/padding/dilation: int or (z, y, x) ints; padding is symmetric
        per dim (torch Conv3d-style), dilation is kernel dilation.
    Returns: (B, Zo, Yo, Xo, F), the values of ``F.conv3d`` on the
      channel-first view up to the order of the sums.
    """
    B, Z, Y, X, C = x.shape
    kz, ky, kx, ci, nf = w.shape
    if ci != C:
        raise ValueError(f"kernel in-channels {ci} != input channels {C}")
    sz, sy, sx = _tup3(strides)
    pz, py, px = _tup3(padding)
    dz, dy, dx = _tup3(dilation)

    zo = (Z + 2 * pz - ((kz - 1) * dz + 1)) // sz + 1
    xp = F.pad(x, (0, 0, 0, 0, 0, 0, pz, pz)) if pz else x
    # tap t of output zo reads padded-input z = zo*sz + t*dz
    slabs = [xp[:, t * dz: t * dz + sz * (zo - 1) + 1: sz] for t in range(kz)]
    xs = torch.cat(slabs, dim=-1).reshape(B * zo, Y, X, kz * C)
    # the kernel's z taps concatenate along the input-channel dim in slab order:
    # (F, kz*C, ky, kx) with channel t*C + c
    w4 = w.permute(4, 0, 3, 1, 2).reshape(nf, kz * C, ky, kx)
    y = F.conv2d(xs.permute(0, 3, 1, 2), w4, None, (sy, sx), (py, px), (dy, dx))
    return y.permute(0, 2, 3, 1).reshape(B, zo, y.shape[2], y.shape[3], nf)
