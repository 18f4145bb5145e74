"""Two-branch volumetric generator (PyTorch counterpart of
``spsg_tpu/models/generator.py``, itself a rebuild of reference
torch/model.py:167-396).

Architecture: a geometry encoder-decoder over the truncated-SDF channel
producing occupancy + refined SDF, and a color/semantics encoder-decoder over
masked colors that consumes the geometry decoder's features
(``pass_geo_feats``) and a U-Net skip (``encoded_half``), with
nearest-neighbor x2 upsampling. Heads: color (3ch, clamped to [-1,1]) and
semantics (14ch logits).

Layout: inputs, outputs and every activation are contiguous channel-last
``(B, Z, Y, X, C)``. The 28 convs that are 3x3x3 / stride 1 / pad 1 /
dilation 1 go through ``ops.conv3x3`` (hand-written CUDA kernels on a CUDA
tensor, their plain versions on a CPU tensor; no flag): the 23 followed by
LeakyReLU + BatchNorm through the fused ``conv3x3_act_stats``, the 5 bare ones
through ``conv3x3`` plus a bias add. The other 7 (5^3 entry convs, 4^3
stride-2 downsamplers) are ``F.conv3d`` on the ``(B, C, Z, Y, X)`` view of the
same memory (``channels_last_3d`` strides, no copy).

Parameters: one convention for every conv, PyTorch's: ``weight``
``(Cout, Cin, kz, ky, kx)`` and ``bias`` ``(Cout,)``. Eligible layers permute
the weight to the kernels' ``(3, 3, 3, Cin, Cout)`` at call time (27*Cin*Cout
elements). ``models/convert.py`` maps this to and from the JAX package's
variable tree.

Parity notes: conv -> LeakyReLU(0.2) -> BatchNorm ordering; BatchNorm follows
the JAX package, not ``nn.BatchNorm3d``: the running variance is updated with
the *biased* batch variance ``max(E[x^2] - E[x]^2, 0)`` (momentum 0.1 in
PyTorch's convention = flax 0.9, eps 1e-5).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import conv3x3 as conv_ops

NUM_CLASSES = 14


def use_true_float32() -> None:
    """Turn TF32 off for cuDNN convolutions and cuBLAS products.

    PyTorch runs float32 cuDNN convolutions in TF32 by default (about three
    decimal digits). The seven library convs of the generator would then
    disagree with the CPU path and with the JAX package; the port computes
    them in true float32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@dataclasses.dataclass(frozen=True)
class GeneratorConfig:
    nf: int = 20  # reference --nf_gen default (train.py:96)
    nf_in_geo: int = 1
    nf_in_color: int = 4  # 3 + input mask channel (train.py:153)
    pass_geo_feats: bool = True
    truncation: float = 3.0
    max_dilation: int = 1
    input_mask: bool = True  # nf_in_color > 3 (model.py:172)
    num_classes: int = NUM_CLASSES
    dtype: Optional[str] = None  # 'bfloat16' at this level is not ported yet


def leaky_relu(x):
    """LeakyReLU(0.2) with the JAX package's derivative at exactly 0: 1, as
    ``jax.nn.leaky_relu`` (``where(x >= 0, x, 0.2 x)``) has it, where
    ``F.leaky_relu`` has 0.2. The two only differ in the backward pass and
    only where a pre-activation is exactly 0, which is common in the entry
    convs: with a zero bias they give exact zeros wherever their 5^3 window
    sees only masked-out (zero) input."""
    return torch.where(x >= 0, x, 0.2 * x)


class BatchNorm(nn.Module):
    """Channel-last BatchNorm with the JAX package's statistics: mean and
    biased variance ``max(E[x^2] - E[x]^2, 0)`` in float32, running statistics
    updated with that same biased variance. ``stats=(sum, sumsq)`` hands in
    the sums the fused conv kernel already computed (train mode); in eval
    mode they are ignored."""

    def __init__(self, channels: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x, stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None):
        if self.training:
            n = x.numel() // x.shape[-1]
            if stats is None:
                xf = x.float()
                dims = tuple(range(x.dim() - 1))
                stats = (xf.sum(dims), (xf * xf).sum(dims))
            mean = stats[0] / n
            var = torch.clamp(stats[1] / n - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean) * mul + self.bias


class ConvBlock(nn.Module):
    """Conv3d -> optional LeakyReLU(0.2) -> optional BatchNorm on a
    channel-last ``(B, Z, Y, X, C)`` tensor (reference ordering inside every
    nn.Sequential of model.py).

    ``plain_convs`` is a testing hook: it sends eligible layers through the
    kernels' plain versions on any device, so that a run with the kernels can
    be held against a run without them. It is not consulted as a fallback."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, dilation: int = 1, act: bool = True, bn: bool = True,
                 plain_convs: bool = False):
        super().__init__()
        self.stride, self.padding, self.dilation, self.act = stride, padding, dilation, act
        self.plain_convs = plain_convs
        self.eligible = kernel == 3 and stride == 1 and padding == 1 and dilation == 1
        self.weight = nn.Parameter(torch.empty(features, cin, kernel, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        # torch Conv3d default: kaiming_uniform(a=sqrt(5)) == U(+-sqrt(1/fan_in));
        # training/state.py::init_generator re-draws from an explicit Generator
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        self.bn = BatchNorm(features) if bn else None

    def forward(self, x):
        if self.eligible:
            wk = self.weight.permute(2, 3, 4, 1, 0).contiguous()  # (3,3,3,Cin,Cout)
            x = x.contiguous()
            if self.act and self.bn is not None:
                fused = (conv_ops.conv3x3_act_stats_plain if self.plain_convs
                         else conv_ops.conv3x3_act_stats)
                y, s, ss = fused(x, wk, self.bias)
                return self.bn(y, (s, ss))
            conv = conv_ops.conv3x3_plain if self.plain_convs else conv_ops.conv3x3
            x = conv(x, wk) + self.bias
        else:
            y = F.conv3d(x.permute(0, 4, 1, 2, 3), self.weight, self.bias, self.stride,
                         self.padding, self.dilation)
            x = y.permute(0, 2, 3, 4, 1).contiguous()
        if self.act:
            x = leaky_relu(x)
        if self.bn is not None:
            x = self.bn(x)
        return x


def upsample2x(x):
    """Nearest-neighbor x2 in all three spatial dims of a channel-last
    volume (reference F.interpolate(scale_factor=2, mode='nearest'),
    model.py:358), as one copy."""
    B, Z, Y, X, C = x.shape
    x = x[:, :, None, :, None, :, None, :].expand(B, Z, 2, Y, 2, X, 2, C)
    return x.reshape(B, 2 * Z, 2 * Y, 2 * X, C)


class Generator(nn.Module):
    def __init__(self, cfg: GeneratorConfig = GeneratorConfig(), plain_convs: bool = False):
        super().__init__()
        if cfg.dtype is not None:
            raise NotImplementedError(
                f"GeneratorConfig.dtype={cfg.dtype!r}: reduced-precision compute at the "
                "generator level is not ported yet (ROADMAP.md); the conv kernels "
                "themselves take bfloat16"
            )
        self.cfg = cfg
        nf = cfg.nf
        dil = min(2, cfg.max_dilation)

        def block(cin, features, kernel=3, stride=1, padding=1, **kw):
            return ConvBlock(cin, features, kernel, stride, padding,
                             plain_convs=plain_convs, **kw)

        # geometry branch (model.py:194-242)
        self.geo_0a = block(cfg.nf_in_geo, nf // 2, 5, 1, 2)
        self.geo_0b = block(nf // 2, nf, 4, 2, 1)
        self.geo_0c = block(nf, nf)
        self.geo_1a = block(nf, 2 * nf, 4, 2, 1)
        self.geo_1b = block(2 * nf, 2 * nf)
        self.geo_1c = block(2 * nf, 2 * nf)
        self.geo_1d = block(2 * nf, 2 * nf, 3, 1, dil, dilation=dil)
        self.geo_2a = block(2 * nf, nf)
        self.geo_2b = block(nf, nf)
        self.geo_occ_a = block(nf, nf // 2)
        self.geo_occ_b = block(nf // 2, 1, act=False, bn=False)
        self.geo_3a = block(nf, nf // 2)
        self.geo_3b = block(nf // 2, nf // 2)
        self.geo_3c = block(nf // 2, 1, act=False, bn=False)

        # color/semantics branch (model.py:244-325)
        n_enc_in = 4 if cfg.input_mask else 3
        self.encoder_0a = block(n_enc_in, nf, 5, 1, 2)
        self.encoder_0b = block(nf, 2 * nf, 4, 2, 1)
        self.encoder_0c = block(2 * nf, 2 * nf)
        n_half = 2 * nf
        if cfg.pass_geo_feats:
            self.encoder_geo = block(nf, nf, 4, 2, 1)
            n_half += nf
        self.encoder_1a = block(n_half, 5 * nf, 4, 2, 1)
        self.encoder_1b = block(5 * nf, 5 * nf)
        self.encoder_1c = block(5 * nf, 5 * nf)
        self.decoder_2a = block(5 * nf, 2 * nf)
        self.decoder_2b = block(2 * nf, 2 * nf)
        self.decoder_2c = block(2 * nf, 2 * nf)
        self.decoder_3a = block(2 * nf + n_half, 2 * nf)
        self.decoder_3b = block(2 * nf, 2 * nf)
        self.decoder_3c = block(2 * nf, nf)
        self.decoder_3d = block(nf, nf)
        self.decoder_3e = block(nf, nf, act=False, bn=False)
        n_dec = nf + (5 if cfg.input_mask else 4)
        self.color_head_bn0 = BatchNorm(n_dec)
        self.color_head_a = block(n_dec, nf)
        self.color_head_b = block(nf, nf // 2)
        self.color_head_c = block(nf // 2, 3, act=False, bn=False)
        self.semantic_head_bn0 = BatchNorm(n_dec)
        self.semantic_head_a = block(n_dec, nf)
        self.semantic_head_b = block(nf, nf)
        self.semantic_head_c = block(nf, cfg.num_classes, act=False, bn=False)

    def forward(self, x, mask, pred_color: bool, pred_sdf: bool = True,
                pred_semantic: bool = False):
        """Args: x (B,Z,Y,X,4) = [tsdf, color x3]; mask (B,Z,Y,X,1).
        Returns (occ_logits (B,Z,Y,X,1), sdf (B,Z,Y,X,1), color, semantic) —
        color/semantic are None unless requested (reference forward,
        model.py:345-396). Train or eval mode is the module's
        (``.train()`` / ``.eval()``)."""
        cfg = self.cfg
        if cfg.input_mask:
            x = torch.cat([x, mask], dim=-1)
        x_geo = x[..., :1]
        # zero out truncated-empty voxels (model.py:352). The reference's
        # in-place masking mutates x's first channel through the view, so the
        # zeroed SDF also reaches the decoder's final concat (model.py:384).
        x_geo = torch.where(x_geo.abs() >= cfg.truncation - 0.01, 0.0, x_geo)
        x = torch.cat([x_geo, x[..., 1:]], dim=-1)

        g = self.geo_0a(x_geo)
        g = self.geo_0b(g)
        g = self.geo_0c(g)
        g = self.geo_1a(g)
        g = self.geo_1b(g)
        g = self.geo_1c(g)
        g = self.geo_1d(g)
        g = upsample2x(g)
        g = self.geo_2a(g)
        g = self.geo_2b(g)
        geo = upsample2x(g)

        out_occ = self.geo_occ_b(self.geo_occ_a(geo))
        out_sdf = self.geo_3c(self.geo_3b(self.geo_3a(geo)))

        out_color = None
        out_semantic = None
        if pred_color or pred_semantic:
            x_color = x[..., 1:4] * 2.0 - 1.0
            if cfg.input_mask:
                m = x[..., 4:]
                masked_x = x_color * (1.0 - m) + m
                enc_in = torch.cat([masked_x, m], dim=-1)
            else:
                enc_in = x_color
            e = self.encoder_0a(enc_in)
            e = self.encoder_0b(e)
            e = self.encoder_0c(e)
            if cfg.pass_geo_feats:
                e = torch.cat([e, self.encoder_geo(geo)], dim=-1)
            encoded_half = e
            e = self.encoder_1a(e)
            e = self.encoder_1b(e)
            e = self.encoder_1c(e)
            dec = upsample2x(e)
            dec = self.decoder_2a(dec)
            dec = self.decoder_2b(dec)
            dec = self.decoder_2c(dec)
            dec = torch.cat([dec, encoded_half], dim=-1)
            dec = upsample2x(dec)
            dec = self.decoder_3a(dec)
            dec = self.decoder_3b(dec)
            dec = self.decoder_3c(dec)
            dec = self.decoder_3d(dec)
            dec = self.decoder_3e(dec)
            dec = torch.cat([dec, x], dim=-1)

            if pred_color:
                c = leaky_relu(self.color_head_bn0(dec))
                c = self.color_head_c(self.color_head_b(self.color_head_a(c)))
                out_color = torch.clamp(c, -1.0, 1.0)
            if pred_semantic:
                t = leaky_relu(self.semantic_head_bn0(dec))
                out_semantic = self.semantic_head_c(
                    self.semantic_head_b(self.semantic_head_a(t)))
        return out_occ, out_sdf, out_color, out_semantic

