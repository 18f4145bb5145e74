"""Plain SPSG generator of the reference (the port's ``models/generator.py``,
reference torch/model.py:167-396), written again in plain PyTorch: every conv
is ``F.conv3d`` on ``(B, C, Z, Y, X)`` tensors in float32 (the caller turns
TF32 off), no hand kernel, no fused statistics. Parameter names and layouts
are the port's, so one state dict loads into both.

Semantics kept from the port: conv -> LeakyReLU(0.2) -> BatchNorm; BatchNorm
with the biased variance ``max(E[x^2] - E[x]^2, 0)`` in its normalisation and
its running statistics (momentum 0.1, eps 1e-5); LeakyReLU's slope at exactly
0 is 1 after a library conv (``where(x >= 0, ...)``) and 0.2 after a 3^3 conv
with BatchNorm (the port's fused kernel reads the slope from ``y > 0``); the
input's truncated-empty SDF zeroed before both branches; nearest x2 upsampling.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

NUM_CLASSES = 14


class BatchNorm(nn.Module):
    def __init__(self, channels: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x):  # x (B, C, Z, Y, X)
        shape = (1, -1, 1, 1, 1)
        if self.training:
            dims = (0, 2, 3, 4)
            n = x.numel() // x.shape[1]
            mean = x.sum(dims) / n
            var = torch.clamp((x * x).sum(dims) / n - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1 - m).add_(m * mean)
                self.running_var.mul_(1 - m).add_(m * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(shape)) * mul.view(shape) + self.bias.view(shape)


class ConvBlock(nn.Module):
    def __init__(self, cin, features, kernel=3, stride=1, padding=1, dilation=1,
                 act=True, bn=True):
        super().__init__()
        self.stride, self.padding, self.dilation, self.act = stride, padding, dilation, act
        self.weight = nn.Parameter(torch.empty(features, cin, kernel, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        self.bn = BatchNorm(features) if bn else None
        # the port's fused 3^3 kernel: slope from y > 0
        self.fused = kernel == 3 and stride == 1 and padding == 1 and dilation == 1 and act and bn

    def forward(self, x):
        y = F.conv3d(x, self.weight, self.bias, self.stride, self.padding, self.dilation)
        if self.act:
            y = torch.where(y > 0, y, 0.2 * y) if self.fused else torch.where(y >= 0, y, 0.2 * y)
        if self.bn is not None:
            y = self.bn(y)
        return y


def _up(x):
    return x.repeat_interleave(2, 2).repeat_interleave(2, 3).repeat_interleave(2, 4)


class Generator(nn.Module):
    def __init__(self, nf: int = 20, truncation: float = 3.0, num_classes: int = NUM_CLASSES):
        super().__init__()
        self.truncation = truncation
        b = ConvBlock
        self.geo_0a = b(1, nf // 2, 5, 1, 2)
        self.geo_0b = b(nf // 2, nf, 4, 2, 1)
        self.geo_0c = b(nf, nf)
        self.geo_1a = b(nf, 2 * nf, 4, 2, 1)
        self.geo_1b = b(2 * nf, 2 * nf)
        self.geo_1c = b(2 * nf, 2 * nf)
        self.geo_1d = b(2 * nf, 2 * nf)
        self.geo_2a = b(2 * nf, nf)
        self.geo_2b = b(nf, nf)
        self.geo_occ_a = b(nf, nf // 2)
        self.geo_occ_b = b(nf // 2, 1, act=False, bn=False)
        self.geo_3a = b(nf, nf // 2)
        self.geo_3b = b(nf // 2, nf // 2)
        self.geo_3c = b(nf // 2, 1, act=False, bn=False)
        self.encoder_0a = b(4, nf, 5, 1, 2)
        self.encoder_0b = b(nf, 2 * nf, 4, 2, 1)
        self.encoder_0c = b(2 * nf, 2 * nf)
        self.encoder_geo = b(nf, nf, 4, 2, 1)
        n_half = 3 * nf
        self.encoder_1a = b(n_half, 5 * nf, 4, 2, 1)
        self.encoder_1b = b(5 * nf, 5 * nf)
        self.encoder_1c = b(5 * nf, 5 * nf)
        self.decoder_2a = b(5 * nf, 2 * nf)
        self.decoder_2b = b(2 * nf, 2 * nf)
        self.decoder_2c = b(2 * nf, 2 * nf)
        self.decoder_3a = b(2 * nf + n_half, 2 * nf)
        self.decoder_3b = b(2 * nf, 2 * nf)
        self.decoder_3c = b(2 * nf, nf)
        self.decoder_3d = b(nf, nf)
        self.decoder_3e = b(nf, nf, act=False, bn=False)
        n_dec = nf + 5
        self.color_head_bn0 = BatchNorm(n_dec)
        self.color_head_a = b(n_dec, nf)
        self.color_head_b = b(nf, nf // 2)
        self.color_head_c = b(nf // 2, 3, act=False, bn=False)
        self.semantic_head_bn0 = BatchNorm(n_dec)
        self.semantic_head_a = b(n_dec, nf)
        self.semantic_head_b = b(nf, nf)
        self.semantic_head_c = b(nf, num_classes, act=False, bn=False)

    def forward(self, x, mask, pred_color=True, pred_semantic=True):
        """x (B,Z,Y,X,4), mask (B,Z,Y,X,1), channel-last as the port takes them.
        Returns channel-last (occ logits, sdf, colour or None, semantic or None)."""
        x = torch.cat([x, mask], dim=-1).permute(0, 4, 1, 2, 3)
        g0 = x[:, :1]
        g0 = torch.where(g0.abs() >= self.truncation - 0.01, 0.0, g0)
        x = torch.cat([g0, x[:, 1:]], dim=1)
        g = self.geo_0c(self.geo_0b(self.geo_0a(g0)))
        g = self.geo_1d(self.geo_1c(self.geo_1b(self.geo_1a(g))))
        g = self.geo_2b(self.geo_2a(_up(g)))
        geo = _up(g)
        occ = self.geo_occ_b(self.geo_occ_a(geo))
        sdf = self.geo_3c(self.geo_3b(self.geo_3a(geo)))
        color = sem = None
        if pred_color or pred_semantic:
            xc = x[:, 1:4] * 2.0 - 1.0
            m = x[:, 4:]
            e = self.encoder_0c(self.encoder_0b(self.encoder_0a(
                torch.cat([xc * (1.0 - m) + m, m], dim=1))))
            half = torch.cat([e, self.encoder_geo(geo)], dim=1)
            e = self.encoder_1c(self.encoder_1b(self.encoder_1a(half)))
            d = self.decoder_2c(self.decoder_2b(self.decoder_2a(_up(e))))
            d = _up(torch.cat([d, half], dim=1))
            for blk in (self.decoder_3a, self.decoder_3b, self.decoder_3c, self.decoder_3d,
                        self.decoder_3e):
                d = blk(d)
            d = torch.cat([d, x], dim=1)

            def lrelu(t):
                return torch.where(t >= 0, t, 0.2 * t)

            if pred_color:
                c = lrelu(self.color_head_bn0(d))
                c = self.color_head_c(self.color_head_b(self.color_head_a(c)))
                color = torch.clamp(c, -1.0, 1.0).permute(0, 2, 3, 4, 1)
            if pred_semantic:
                t = lrelu(self.semantic_head_bn0(d))
                sem = self.semantic_head_c(self.semantic_head_b(self.semantic_head_a(t)))
                sem = sem.permute(0, 2, 3, 4, 1)
        return occ.permute(0, 2, 3, 4, 1), sdf.permute(0, 2, 3, 4, 1), color, sem
