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
dilation 1 go through ``ops.conv3x3`` under every flag (hand-written CUDA
kernels on a CUDA tensor, their plain versions on a CPU tensor): the 23
followed by LeakyReLU + BatchNorm through the fused ``conv3x3_act_stats``, the
5 bare ones through ``conv3x3`` plus a bias add. That is the JAX package's
generator with ``pallas_conv`` and ``fused_conv``, and its precedence decides
the other 7 (the 5^3 entry convs ``geo_0a`` / ``encoder_0a``, the 4^3 stride-2
downsamplers; ``geo_1d`` too with ``max_dilation > 1``):

- ``GeneratorConfig.zslab_conv``: every one of them as one 2D conv over
  z-slabs (``ops/zslab_conv.py``);
- else ``folded_conv``: the odd, cubic, stride-1, dilation-1 SAME ones (the
  two 5^3 entry convs), which the JAX package folds into one patch product
  (``ops/folded_conv.py``), as z-slab convs too: on an H100 the z-slab form
  is the faster of the two on both layers (PERF.md, the conv forms' table);
- else (the default) ``F.conv3d`` on the ``(B, C, Z, Y, X)`` view of the same
  memory (``channels_last_3d`` strides, no copy). A layer that trains in
  float32 with dilation 1 (train mode, grad enabled, the weight requiring it)
  takes the same forward and input gradient through
  ``ops/libconv_dw.py::library_conv``, whose weight gradient is a hand kernel;
  each such call counts ``train.libconv_dw`` (``utils/timing.py``), and each
  other library conv of a training forward counts 0 there.

``GeneratorConfig.remat`` (train mode) recomputes each conv block's
activations in the backward instead of keeping them (the JAX package's
``nn.remat(ConvBlock)``): ``torch.utils.checkpoint``, non-reentrant, around
every block call but the two head BatchNorms; the recompute leaves the
BatchNorm running statistics alone, so they move once a step.

Parameters: one convention for every conv, PyTorch's: ``weight``
``(Cout, Cin, kz, ky, kx)`` and ``bias`` ``(Cout,)``. Eligible layers permute
the weight to the kernels' ``(3, 3, 3, Cin, Cout)`` at call time (27*Cin*Cout
elements). ``models/convert.py`` maps this to and from the JAX package's
variable tree.

Parity notes: conv -> LeakyReLU(0.2) -> BatchNorm ordering; BatchNorm follows
the JAX package, not ``nn.BatchNorm3d``: the running variance is updated with
the *biased* batch variance ``max(E[x^2] - E[x]^2, 0)`` (momentum 0.1 in
PyTorch's convention = flax 0.9, eps 1e-5).

``GeneratorConfig.dtype="bfloat16"`` is the JAX package's generator-level
bf16: parameters stay float32; the input and every block compute in bf16 (the
conv kernels' bf16 variants, bf16 library convs), rounding where Flax rounds:
a conv's output, its bias add and LeakyReLU in bf16, BatchNorm in float32 with
its output rounded to bf16 (Flax's ``_normalize``). The four heads
(``geo_occ_b``, ``geo_3c``, ``color_head_c``, ``semantic_head_c``) have no
dtype in the JAX package, so they promote their bf16 input to float32 and
compute in float32, as here. The fused kernel adds the bias and applies the
LeakyReLU to its float32 sum before it rounds once, where Flax rounds three
times (ROADMAP.md Queue C states the tolerance that results).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops import conv3x3 as conv_ops
from ..ops.libconv_dw import library_conv
from ..ops.zslab_conv import conv3d_zslab
from ..parallel import mesh as pmesh
from ..utils import timing

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
    dtype: Optional[str] = None  # 'bfloat16': the blocks compute in bf16, the heads in f32
    # the convs the hand kernels do not take as z-slab 2D convs
    # (ops/zslab_conv.py): all of them, or with folded_conv only the 5^3 entry
    # convs, the layers the JAX package folds. Parameters identical either way
    folded_conv: bool = False
    zslab_conv: bool = False
    # recompute each conv block's activations in the backward (train mode):
    # less activation memory for more work (the JAX package's nn.remat)
    remat: bool = False


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
    mode they are ignored. A bfloat16 input is normalised in float32 and the
    result rounded to bfloat16 (Flax's ``BatchNorm(dtype=bfloat16)``).

    ``mesh`` (``parallel.Mesh``): in train mode the per-channel sums and the
    voxel count are summed over the ranks before the mean and the variance
    are formed (one all-reduce, whose backward sums the gradient over the
    ranks), so that the statistics, and the running statistics updated from
    them, are the global batch's on every rank. Eval mode is local.

    ``update_running`` False (while :meth:`ConvBlock.replaying` recomputes a
    rematerialised block) normalises with the batch statistics as before and
    leaves the running statistics alone: they move once a step."""

    def __init__(self, channels: int, momentum: float = 0.1, eps: float = 1e-5):
        super().__init__()
        self.momentum = momentum
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))
        self.update_running = True

    def forward(self, x, stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                mesh=None):
        if self.training:
            n = x.numel() // x.shape[-1]
            if stats is None:
                xf = x.float()
                dims = tuple(range(x.dim() - 1))
                stats = (xf.sum(dims), (xf * xf).sum(dims))
            if pmesh.active(mesh):
                c = x.shape[-1]
                packed = torch.cat([stats[0], stats[1], stats[0].new_full((1,), float(n))])
                packed = pmesh.shared_sum(packed, mesh)
                stats, n = (packed[:c], packed[c:2 * c]), packed[2 * c]
            mean = stats[0] / n
            var = torch.clamp(stats[1] / n - mean * mean, min=0.0)
            if self.update_running:
                with torch.no_grad():
                    m = self.momentum
                    self.running_mean.mul_(1 - m).add_(m * mean)
                    self.running_var.mul_(1 - m).add_(m * var)
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean) * mul + self.bias).to(x.dtype)


class ConvBlock(nn.Module):
    """Conv3d -> optional LeakyReLU(0.2) -> optional BatchNorm on a
    channel-last ``(B, Z, Y, X, C)`` tensor (reference ordering inside every
    nn.Sequential of model.py).

    ``dtype`` is the compute type (``torch.bfloat16``); None computes in
    float32, whatever the input's type (Flax's promotion of the input with the
    float32 kernel).

    ``plain_convs`` is a testing hook: it sends eligible layers through the
    kernels' plain versions and the library convs' weight gradient through the
    library on any device, so that a run with the kernels can be held against
    a run without them. It is not consulted as a fallback.

    ``route`` says how the conv is computed: ``"hand"`` (eligible: the kernels
    of ``ops/conv3x3.py``, under every flag), ``"zslab"`` (``zslab_conv``: every
    other conv; ``folded_conv``: the odd, cubic, stride-1, dilation-1 SAME
    convs that are not eligible) or ``"library"`` (``F.conv3d``; its weight
    gradient by hand where :meth:`hand_dw` says so).

    ``forward(x, mesh, spatial)``: ``mesh`` makes a train-mode BatchNorm's
    statistics global (:class:`BatchNorm`). ``spatial`` (eval mode) serves a
    volume split along Y over the mesh's ranks, ``x`` being this rank's slab:
    the slab takes ``padding`` rows from each neighbour
    (``parallel/mesh.py::halo_exchange``, zeros at the volume's edges), which
    is every row a 3^3 pad-1, a 5^3 pad-2, a dilation-2 pad-2 or a 4^3
    stride-2 pad-1 conv reads across the slab's edge when slabs start at even
    rows. The library and z-slab convs then run with no Y padding; the hand
    kernels, which pad by one themselves, run on the ``Y + 2`` slab unchanged
    and its first and last output rows are dropped."""

    def __init__(self, cin: int, features: int, kernel: int = 3, stride: int = 1,
                 padding: int = 1, dilation: int = 1, act: bool = True, bn: bool = True,
                 dtype: Optional[torch.dtype] = None, plain_convs: bool = False,
                 zslab_conv: bool = False, folded_conv: bool = False):
        super().__init__()
        self.stride, self.padding, self.dilation, self.act = stride, padding, dilation, act
        self.dtype = dtype or torch.float32
        self.plain_convs = plain_convs
        self.eligible = kernel == 3 and stride == 1 and padding == 1 and dilation == 1
        foldable = (kernel % 2 == 1 and stride == 1 and dilation == 1
                    and padding == kernel // 2)
        self.route = ("hand" if self.eligible
                      else "zslab" if zslab_conv or (folded_conv and foldable) else "library")
        self.weight = nn.Parameter(torch.empty(features, cin, kernel, kernel, kernel))
        self.bias = nn.Parameter(torch.zeros(features))
        # torch Conv3d default: kaiming_uniform(a=sqrt(5)) == U(+-sqrt(1/fan_in));
        # training/state.py::init_generator re-draws from an explicit Generator
        nn.init.kaiming_uniform_(self.weight, a=math.sqrt(5))
        self.bn = BatchNorm(features) if bn else None
        self.replay = False

    @contextlib.contextmanager
    def replaying(self):
        """While a rematerialised block is recomputed in the backward: its
        BatchNorm leaves the running statistics alone, and the block counts
        nothing."""
        self.replay = True
        if self.bn is not None:
            self.bn.update_running = False
        try:
            yield
        finally:
            self.replay = False
            if self.bn is not None:
                self.bn.update_running = True

    def hand_dw(self, dt) -> bool:
        """Whether a ``"library"`` conv computing in ``dt`` takes
        ``library_conv``, whose weight gradient is the hand kernel: float32,
        dilation 1, in training with a weight gradient to compute (and not
        under the ``plain_convs`` hook, which runs no hand kernel)."""
        return (self.route == "library" and self.dilation == 1 and dt == torch.float32
                and self.training and torch.is_grad_enabled() and self.weight.requires_grad
                and not self.plain_convs)

    def _library_conv(self, x, dt, halo):
        """The conv of a layer the hand kernels do not take, by its route;
        channel-last in and out, without the bias."""
        p = self.padding
        w = self.weight.to(dt)
        if self.route == "zslab":
            return conv3d_zslab(x, w.permute(2, 3, 4, 1, 0), self.stride,
                                (p, 0, p) if halo else p, self.dilation)
        hand = self.hand_dw(dt)
        if self.training and torch.is_grad_enabled() and not self.replay:
            # a layer that keeps the library's weight gradient (bf16, dilation 2)
            # counts 0: where none takes the hand kernel the counter reads 0
            timing.count("train.libconv_dw", int(hand))
        if hand:
            return library_conv(x, w, self.stride, p)
        y = F.conv3d(x.permute(0, 4, 1, 2, 3), w, None, self.stride,
                     (p, 0, p) if halo else p, self.dilation)
        return y.permute(0, 2, 3, 4, 1)

    def forward(self, x, mesh=None, spatial: bool = False):
        dt = self.dtype
        x = x.to(dt)
        halo = self.padding if spatial else 0  # Y rows taken from the neighbours
        if halo:
            x = pmesh.halo_exchange(x, halo, mesh, dim=2)
        if self.eligible:
            wk = self.weight.permute(2, 3, 4, 1, 0).to(dt).contiguous()  # (3,3,3,Cin,Cout)
            x = x.contiguous()
            if self.act and self.bn is not None:
                fused = (conv_ops.conv3x3_act_stats_plain if self.plain_convs
                         else conv_ops.conv3x3_act_stats)
                y, s, ss = fused(x, wk, self.bias)
                if halo:  # eval mode: the sums, which count the halo rows, are not used
                    return self.bn(y[:, :, 1:-1])
                return self.bn(y, (s, ss), mesh)
            conv = conv_ops.conv3x3_plain if self.plain_convs else conv_ops.conv3x3
            y = conv(x, wk)
            x = (y[:, :, 1:-1] if halo else y) + self.bias.to(dt)
        else:
            x = (self._library_conv(x, dt, halo) + self.bias.to(dt)).contiguous()
        if self.act:
            x = leaky_relu(x)
        if self.bn is not None:
            x = self.bn(x, mesh=mesh)
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
        if cfg.dtype not in (None, "bfloat16"):
            raise ValueError(f"GeneratorConfig.dtype={cfg.dtype!r}: None or 'bfloat16'")
        self.cfg = cfg
        nf = cfg.nf
        dil = min(2, cfg.max_dilation)
        self.dtype = torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32

        def block(cin, features, kernel=3, stride=1, padding=1, dtype=self.dtype, **kw):
            return ConvBlock(cin, features, kernel, stride, padding, dtype=dtype,
                             plain_convs=plain_convs, zslab_conv=cfg.zslab_conv,
                             folded_conv=cfg.folded_conv, **kw)

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
        # the four heads compute in float32 (they have no dtype in the JAX package)
        self.geo_occ_b = block(nf // 2, 1, act=False, bn=False, dtype=None)
        self.geo_3a = block(nf, nf // 2)
        self.geo_3b = block(nf // 2, nf // 2)
        self.geo_3c = block(nf // 2, 1, act=False, bn=False, dtype=None)

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
        self.color_head_c = block(nf // 2, 3, act=False, bn=False, dtype=None)
        self.semantic_head_bn0 = BatchNorm(n_dec)
        self.semantic_head_a = block(n_dec, nf)
        self.semantic_head_b = block(nf, nf)
        self.semantic_head_c = block(nf, cfg.num_classes, act=False, bn=False, dtype=None)

    def forward(self, x, mask, pred_color: bool, pred_sdf: bool = True,
                pred_semantic: bool = False, mesh=None, spatial: bool = False):
        """Args: x (B,Z,Y,X,4) = [tsdf, color x3]; mask (B,Z,Y,X,1).
        Returns (occ_logits (B,Z,Y,X,1), sdf (B,Z,Y,X,1), color, semantic) —
        color/semantic are None unless requested (reference forward,
        model.py:345-396). Train or eval mode is the module's
        (``.train()`` / ``.eval()``).

        ``mesh`` (``parallel.Mesh``): train-mode BatchNorm statistics over
        the global batch. ``spatial``: ``x`` and ``mask`` are this rank's
        Y-slab of a volume split in rank order into equal slabs of a multiple
        of 4 rows, and the outputs are the slab's (:class:`ConvBlock`);
        eval mode only."""
        cfg = self.cfg
        if spatial and self.training:
            raise ValueError("Generator: spatial sharding serves in eval mode only")

        remat = cfg.remat and self.training and torch.is_grad_enabled()

        def run(block, h):
            if remat:
                # the blocks draw no random numbers: no RNG state to stash
                return checkpoint(block, h, mesh, spatial, use_reentrant=False,
                                  preserve_rng_state=False,
                                  context_fn=lambda: (contextlib.nullcontext(), block.replaying()))
            return block(h, mesh, spatial)

        if cfg.input_mask:
            x = torch.cat([x, mask], dim=-1)
        x_geo = x[..., :1]
        # zero out truncated-empty voxels (model.py:352). The reference's
        # in-place masking mutates x's first channel through the view, so the
        # zeroed SDF also reaches the decoder's final concat (model.py:384).
        x_geo = torch.where(x_geo.abs() >= cfg.truncation - 0.01, 0.0, x_geo)
        x = torch.cat([x_geo, x[..., 1:]], dim=-1)

        g = run(self.geo_0a, x_geo)
        g = run(self.geo_0b, g)
        g = run(self.geo_0c, g)
        g = run(self.geo_1a, g)
        g = run(self.geo_1b, g)
        g = run(self.geo_1c, g)
        g = run(self.geo_1d, g)
        g = upsample2x(g)
        g = run(self.geo_2a, g)
        g = run(self.geo_2b, g)
        geo = upsample2x(g)

        out_occ = run(self.geo_occ_b, run(self.geo_occ_a, geo))
        out_sdf = run(self.geo_3c, run(self.geo_3b, run(self.geo_3a, geo)))

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
            e = run(self.encoder_0a, enc_in)
            e = run(self.encoder_0b, e)
            e = run(self.encoder_0c, e)
            if cfg.pass_geo_feats:
                e = torch.cat([e, run(self.encoder_geo, geo)], dim=-1)
            encoded_half = e
            e = run(self.encoder_1a, e)
            e = run(self.encoder_1b, e)
            e = run(self.encoder_1c, e)
            dec = upsample2x(e)
            dec = run(self.decoder_2a, dec)
            dec = run(self.decoder_2b, dec)
            dec = run(self.decoder_2c, dec)
            dec = torch.cat([dec, encoded_half], dim=-1)
            dec = upsample2x(dec)
            dec = run(self.decoder_3a, dec)
            dec = run(self.decoder_3b, dec)
            dec = run(self.decoder_3c, dec)
            dec = run(self.decoder_3d, dec)
            dec = run(self.decoder_3e, dec)
            dec = torch.cat([dec, x.to(dec.dtype)], dim=-1)

            if pred_color:
                c = leaky_relu(self.color_head_bn0(dec, mesh=mesh))
                c = run(self.color_head_c, run(self.color_head_b, run(self.color_head_a, c)))
                out_color = torch.clamp(c, -1.0, 1.0)
            if pred_semantic:
                t = leaky_relu(self.semantic_head_bn0(dec, mesh=mesh))
                out_semantic = run(self.semantic_head_c,
                    run(self.semantic_head_b, run(self.semantic_head_a, t)))
        return out_occ, out_sdf, out_color, out_semantic

