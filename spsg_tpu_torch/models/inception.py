"""Inception-v3 feature extractor for Feature-l1 / FID (PyTorch counterpart
of ``spsg_tpu/models/inception.py``; reference torch/metrics.py:45-53 loads
torchvision's ``inception_v3`` from a local ``--inception_v3_path`` .pth).

Plain ``torch.nn`` (no torchvision), eval only: BatchNorm from its running
statistics, no dropout, no auxiliary head. The modules carry torchvision's
names (``Conv2d_1a_3x3.conv.weight``, ``Mixed_5b.branch1x1.bn.running_mean``,
``fc.weight`` ...), so a torchvision state_dict loads after
:func:`convert_inception_state_dict` checks it against the architecture table.
The convs are cuDNN's ``conv2d`` on a card (the JAX package leaves them to
XLA's ``conv_general_dilated``; there is no Pallas kernel to port), in true
float32. With no checkpoint the weights are :func:`fabricate_state_dict`'s,
the JAX package's fixed-seed numpy draw, so both packages' fallback features
agree.

Public functions take and return channel-last (B, H, W, 3) images, as the
JAX package's do.
"""

from __future__ import annotations

import os
import pickle
import warnings
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

_BN_EPS = 1e-3  # torchvision BasicConv2d: BatchNorm2d(eps=0.001)
COLOR_MEAN = (0.485, 0.456, 0.406)
COLOR_STD = (0.229, 0.224, 0.225)
IMAGE_SIZE = 299

# The conv table: torchvision module name -> (in, out, (kh, kw), stride,
# (pad_h, pad_w)). It builds the modules, fabricates weights and validates a
# converted state_dict; the blocks below only wire the branches together.
_CONVS: Dict[str, Tuple[int, int, Tuple[int, int], int, Tuple[int, int]]] = {
    "Conv2d_1a_3x3": (3, 32, (3, 3), 2, (0, 0)),
    "Conv2d_2a_3x3": (32, 32, (3, 3), 1, (0, 0)),
    "Conv2d_2b_3x3": (32, 64, (3, 3), 1, (1, 1)),
    "Conv2d_3b_1x1": (64, 80, (1, 1), 1, (0, 0)),
    "Conv2d_4a_3x3": (80, 192, (3, 3), 1, (0, 0)),
}
_1x1 = ((1, 1), 1, (0, 0))
_3x3 = ((3, 3), 1, (1, 1))
_3x3_s2 = ((3, 3), 2, (0, 0))
_1x7 = ((1, 7), 1, (0, 3))
_7x1 = ((7, 1), 1, (3, 0))
_1x3 = ((1, 3), 1, (0, 1))
_3x1 = ((3, 1), 1, (1, 0))


def _inception_a(prefix: str, cin: int, pool: int) -> None:
    _CONVS[f"{prefix}.branch1x1"] = (cin, 64, *_1x1)
    _CONVS[f"{prefix}.branch5x5_1"] = (cin, 48, *_1x1)
    _CONVS[f"{prefix}.branch5x5_2"] = (48, 64, (5, 5), 1, (2, 2))
    _CONVS[f"{prefix}.branch3x3dbl_1"] = (cin, 64, *_1x1)
    _CONVS[f"{prefix}.branch3x3dbl_2"] = (64, 96, *_3x3)
    _CONVS[f"{prefix}.branch3x3dbl_3"] = (96, 96, *_3x3)
    _CONVS[f"{prefix}.branch_pool"] = (cin, pool, *_1x1)


def _inception_c(prefix: str, c7: int) -> None:
    cin = 768
    _CONVS[f"{prefix}.branch1x1"] = (cin, 192, *_1x1)
    _CONVS[f"{prefix}.branch7x7_1"] = (cin, c7, *_1x1)
    _CONVS[f"{prefix}.branch7x7_2"] = (c7, c7, *_1x7)
    _CONVS[f"{prefix}.branch7x7_3"] = (c7, 192, *_7x1)
    _CONVS[f"{prefix}.branch7x7dbl_1"] = (cin, c7, *_1x1)
    _CONVS[f"{prefix}.branch7x7dbl_2"] = (c7, c7, *_7x1)
    _CONVS[f"{prefix}.branch7x7dbl_3"] = (c7, c7, *_1x7)
    _CONVS[f"{prefix}.branch7x7dbl_4"] = (c7, c7, *_7x1)
    _CONVS[f"{prefix}.branch7x7dbl_5"] = (c7, 192, *_1x7)
    _CONVS[f"{prefix}.branch_pool"] = (cin, 192, *_1x1)


def _inception_e(prefix: str, cin: int) -> None:
    _CONVS[f"{prefix}.branch1x1"] = (cin, 320, *_1x1)
    _CONVS[f"{prefix}.branch3x3_1"] = (cin, 384, *_1x1)
    _CONVS[f"{prefix}.branch3x3_2a"] = (384, 384, *_1x3)
    _CONVS[f"{prefix}.branch3x3_2b"] = (384, 384, *_3x1)
    _CONVS[f"{prefix}.branch3x3dbl_1"] = (cin, 448, *_1x1)
    _CONVS[f"{prefix}.branch3x3dbl_2"] = (448, 384, *_3x3)
    _CONVS[f"{prefix}.branch3x3dbl_3a"] = (384, 384, *_1x3)
    _CONVS[f"{prefix}.branch3x3dbl_3b"] = (384, 384, *_3x1)
    _CONVS[f"{prefix}.branch_pool"] = (cin, 192, *_1x1)


_inception_a("Mixed_5b", 192, 32)
_inception_a("Mixed_5c", 256, 64)
_inception_a("Mixed_5d", 288, 64)
# Mixed_6a (InceptionB)
_CONVS["Mixed_6a.branch3x3"] = (288, 384, *_3x3_s2)
_CONVS["Mixed_6a.branch3x3dbl_1"] = (288, 64, *_1x1)
_CONVS["Mixed_6a.branch3x3dbl_2"] = (64, 96, *_3x3)
_CONVS["Mixed_6a.branch3x3dbl_3"] = (96, 96, *_3x3_s2)
for _name, _c7 in (("Mixed_6b", 128), ("Mixed_6c", 160), ("Mixed_6d", 160), ("Mixed_6e", 192)):
    _inception_c(_name, _c7)
# Mixed_7a (InceptionD)
_CONVS["Mixed_7a.branch3x3_1"] = (768, 192, *_1x1)
_CONVS["Mixed_7a.branch3x3_2"] = (192, 320, *_3x3_s2)
_CONVS["Mixed_7a.branch7x7x3_1"] = (768, 192, *_1x1)
_CONVS["Mixed_7a.branch7x7x3_2"] = (192, 192, *_1x7)
_CONVS["Mixed_7a.branch7x7x3_3"] = (192, 192, *_7x1)
_CONVS["Mixed_7a.branch7x7x3_4"] = (192, 192, *_3x3_s2)
_inception_e("Mixed_7b", 1280)
_inception_e("Mixed_7c", 2048)

NUM_CLASSES = 1000
POOL_DIM = 2048


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


class BasicConv2d(nn.Module):
    """A conv without bias, BatchNorm (eps 1e-3) and ReLU: torchvision's
    BasicConv2d, eval mode in every caller (``load_inception``)."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int], stride: int,
                 pad: Tuple[int, int]):
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, kernel, stride, pad, bias=False)
        self.bn = nn.BatchNorm2d(cout, eps=_BN_EPS)

    def forward(self, x):
        return F.relu(self.bn(self.conv(x)))


def _max_pool(x):
    return F.max_pool2d(x, 3, 2)  # VALID


def _avg_pool_3_1_1(x):
    return F.avg_pool2d(x, 3, 1, 1, count_include_pad=True)


class InceptionV3(nn.Module):
    """Eval-mode Inception-v3 with torchvision's module names. ``forward``
    takes (B, H, W, 3) ImageNet-normalised RGB (H = W = 299 canonical; any
    size >= 75 works) and returns (pool (B, 2048), logits (B, 1000)): the
    adaptive-average-pooled features (the FID feature) and the class logits
    (what the reference's ``inception_v3(img)`` gives in eval,
    metrics.py:92-100)."""

    def __init__(self):
        super().__init__()
        for name, geometry in _CONVS.items():
            parent = self
            *path, leaf = name.split(".")
            for part in path:
                if not hasattr(parent, part):
                    parent.add_module(part, nn.Module())
                parent = getattr(parent, part)
            parent.add_module(leaf, BasicConv2d(*geometry))
        self.fc = nn.Linear(POOL_DIM, NUM_CLASSES)

    def _block_a(self, x, prefix):
        g = self.get_submodule(prefix)
        b1 = g.branch1x1(x)
        b5 = g.branch5x5_2(g.branch5x5_1(x))
        b3 = g.branch3x3dbl_3(g.branch3x3dbl_2(g.branch3x3dbl_1(x)))
        bp = g.branch_pool(_avg_pool_3_1_1(x))
        return torch.cat([b1, b5, b3, bp], dim=1)

    def _block_b(self, x):  # Mixed_6a
        g = self.Mixed_6a
        bd = g.branch3x3dbl_3(g.branch3x3dbl_2(g.branch3x3dbl_1(x)))
        return torch.cat([g.branch3x3(x), bd, _max_pool(x)], dim=1)

    def _block_c(self, x, prefix):
        g = self.get_submodule(prefix)
        b7 = g.branch7x7_3(g.branch7x7_2(g.branch7x7_1(x)))
        bd = g.branch7x7dbl_1(x)
        for layer in (g.branch7x7dbl_2, g.branch7x7dbl_3, g.branch7x7dbl_4, g.branch7x7dbl_5):
            bd = layer(bd)
        bp = g.branch_pool(_avg_pool_3_1_1(x))
        return torch.cat([g.branch1x1(x), b7, bd, bp], dim=1)

    def _block_d(self, x):  # Mixed_7a
        g = self.Mixed_7a
        b3 = g.branch3x3_2(g.branch3x3_1(x))
        b7 = g.branch7x7x3_4(g.branch7x7x3_3(g.branch7x7x3_2(g.branch7x7x3_1(x))))
        return torch.cat([b3, b7, _max_pool(x)], dim=1)

    def _block_e(self, x, prefix):
        g = self.get_submodule(prefix)
        b3 = g.branch3x3_1(x)
        b3 = torch.cat([g.branch3x3_2a(b3), g.branch3x3_2b(b3)], dim=1)
        bd = g.branch3x3dbl_2(g.branch3x3dbl_1(x))
        bd = torch.cat([g.branch3x3dbl_3a(bd), g.branch3x3dbl_3b(bd)], dim=1)
        bp = g.branch_pool(_avg_pool_3_1_1(x))
        return torch.cat([g.branch1x1(x), b3, bd, bp], dim=1)

    def forward(self, x: torch.Tensor):
        # torchvision's transform_input (set for its pretrained weights): the
        # ImageNet-normalised input re-scaled to the convention the weights
        # were trained with
        x = torch.cat([
            x[..., 0:1] * (0.229 / 0.5) + (0.485 - 0.5) / 0.5,
            x[..., 1:2] * (0.224 / 0.5) + (0.456 - 0.5) / 0.5,
            x[..., 2:3] * (0.225 / 0.5) + (0.406 - 0.5) / 0.5,
        ], dim=-1)
        x = x.permute(0, 3, 1, 2)
        x = self.Conv2d_1a_3x3(x)
        x = self.Conv2d_2a_3x3(x)
        x = self.Conv2d_2b_3x3(x)
        x = _max_pool(x)
        x = self.Conv2d_3b_1x1(x)
        x = self.Conv2d_4a_3x3(x)
        x = _max_pool(x)
        for prefix in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
            x = self._block_a(x, prefix)
        x = self._block_b(x)
        for prefix in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
            x = self._block_c(x, prefix)
        x = self._block_d(x)
        x = self._block_e(x, "Mixed_7b")
        x = self._block_e(x, "Mixed_7c")
        pool = x.mean(dim=(2, 3))  # adaptive average pool to 1x1
        return pool, self.fc(pool)


def preprocess(images: torch.Tensor) -> torch.Tensor:
    """RGB [0, 1] (B, H, W, 3) -> the 299x299 ImageNet-normalised input
    (torchvision's eval transform: bilinear resize, then mean / std).

    The resize is the JAX package's ``jax.image.resize(method="bilinear")``:
    a triangle filter centred at (i + 0.5) * in / out - 0.5 whose support
    widens by in / out when it shrinks an image (antialiased; the test_scene
    CLI's 480x384 renders) and plain bilinear interpolation when it grows one,
    the weights normalised over the input. ``F.interpolate(mode="bilinear",
    antialias=True, align_corners=False)`` is that filter in both directions
    (PIL's convention, which ``jax.image.scale_and_translate`` shares), so it
    is the call used; without ``antialias`` it differs as soon as the image
    shrinks. tests/test_torch_inception.py holds it within 1e-6 of the JAX
    filter's product in float64, and within 1e-5 of the JAX package's own
    float32 result, which is the less exact of the two (ROADMAP.md Queue C)."""
    x = F.interpolate(images.permute(0, 3, 1, 2), size=(IMAGE_SIZE, IMAGE_SIZE),
                      mode="bilinear", align_corners=False, antialias=True)
    x = x.permute(0, 2, 3, 1)
    mean = torch.tensor(COLOR_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(COLOR_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def convert_inception_state_dict(state_dict) -> Dict[str, torch.Tensor]:
    """A torchvision ``inception_v3`` state_dict (tensors or numpy arrays) ->
    the :class:`InceptionV3` state_dict. Every conv of the table is checked
    for its shape (a mismatch raises ``ValueError`` naming the layer);
    ``AuxLogits.*`` (the train-only head) and anything else outside the table
    is left out."""
    def arr(key):
        v = state_dict[key]
        v = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        return torch.from_numpy(np.array(v, np.float32))

    out: Dict[str, torch.Tensor] = {}
    for name, (cin, cout, (kh, kw), _, _) in _CONVS.items():
        w = arr(f"{name}.conv.weight")
        if tuple(w.shape) != (cout, cin, kh, kw):
            raise ValueError(f"{name}: expected {(cout, cin, kh, kw)}, got {tuple(w.shape)}")
        out[f"{name}.conv.weight"] = w
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            out[f"{name}.bn.{leaf}"] = arr(f"{name}.bn.{leaf}")
        out[f"{name}.bn.num_batches_tracked"] = torch.tensor(0)
    out["fc.weight"] = arr("fc.weight")
    out["fc.bias"] = arr("fc.bias")
    return out


def fabricate_state_dict(seed: int = 42) -> Dict[str, np.ndarray]:
    """A torchvision-shaped random state_dict (He-initialised convs, identity
    BatchNorm), numpy: the JAX package's draw, the same arrays to the bit. The
    no-pretrained-weights fallback, and the tests' weights."""
    rng = np.random.default_rng(seed)
    sd: Dict[str, np.ndarray] = {}
    for name, (cin, cout, (kh, kw), _, _) in _CONVS.items():
        fan_in = cin * kh * kw
        sd[f"{name}.conv.weight"] = (
            rng.standard_normal((cout, cin, kh, kw)) * np.sqrt(2.0 / fan_in)
        ).astype(np.float32)
        sd[f"{name}.bn.weight"] = np.ones(cout, np.float32)
        sd[f"{name}.bn.bias"] = np.zeros(cout, np.float32)
        sd[f"{name}.bn.running_mean"] = np.zeros(cout, np.float32)
        sd[f"{name}.bn.running_var"] = np.ones(cout, np.float32)
    sd["fc.weight"] = (
        rng.standard_normal((NUM_CLASSES, POOL_DIM)) * np.sqrt(1.0 / POOL_DIM)
    ).astype(np.float32)
    sd["fc.bias"] = np.zeros(NUM_CLASSES, np.float32)
    return sd


def load_inception(path: str = "", device="cuda") -> InceptionV3:
    """Inception-v3 on ``device``, eval mode, parameters frozen. Weight search
    order, the JAX package's:
      1. ``path`` (--inception_v3_path, reference metrics.py:37,45-50);
      2. $SPSG_INCEPTION_WEIGHTS;
      3. the torch hub cache (inception_v3_google-0cc3c7bd.pth);
      4. fixed-seed random weights (:func:`fabricate_state_dict`) with a
         warning: Feature-l1 and FID stay well-defined, self-consistent
         distances, but they are not ImageNet features and not comparable to
         reference or paper numbers.
    A checkpoint is read with ``torch.load(weights_only=True)``: a state_dict
    (torchvision's files are), optionally under ``"state_dict"``."""
    from ..training.state import resolve_device
    from .generator import use_true_float32

    device = resolve_device(device)
    here = os.path.expanduser(os.environ.get("TORCH_HOME", "~/.cache/torch"))
    candidates = [
        path,
        os.environ.get("SPSG_INCEPTION_WEIGHTS", ""),
        os.path.join(here, "hub", "checkpoints", "inception_v3_google-0cc3c7bd.pth"),
    ]
    params = None
    for cand in candidates:
        if not cand or not os.path.isfile(cand):
            continue
        try:
            sd = torch.load(cand, map_location="cpu", weights_only=True)
            params = convert_inception_state_dict(sd.get("state_dict", sd))
            print(f"inception: loaded pretrained weights from {cand}")
            break
        except (OSError, KeyError, ValueError, RuntimeError, pickle.UnpicklingError) as e:
            print(f"inception: failed to load {cand} ({e})")
    if params is None:
        warnings.warn(
            "spsg-tpu: no pretrained Inception-v3 weights found — Feature-l1/FID "
            "use FIXED-SEED RANDOM Inception features and are not comparable to "
            "reference numbers. Point --inception_v3_path or "
            "SPSG_INCEPTION_WEIGHTS at a torchvision inception_v3 .pth "
            "(the same artifact the reference downloads, metrics.py:45-50).",
            stacklevel=2,
        )
        params = convert_inception_state_dict(fabricate_state_dict())
    model = InceptionV3()
    model.load_state_dict(params, strict=True)
    if device.type == "cuda":
        use_true_float32()
    return model.to(device).eval().requires_grad_(False)
