"""VGG19 feature extractor for the style / content losses (PyTorch counterpart
of ``spsg_tpu/models/vgg.py``; reference torch/style.py:91-157: torchvision's
vgg19 cut after conv_8 == conv3_4, with ImageNet normalisation;
style_layers_default=[8]).

Plain ``torch.nn`` (no torchvision): eight 3x3 ``nn.Conv2d`` named ``conv_1``
... ``conv_8``. The convs are cuDNN's ``conv2d`` on a card, as the JAX package
leaves them to XLA's ``nn.Conv``: there is no Pallas kernel to port, and they
run in true float32 (``use_true_float32``).

Pretrained weights load from a converted ``.npz`` (``tools/convert_vgg19.py``,
the same file the JAX package reads) or a torchvision ``.pth``. With neither,
the extractor falls back to fixed-seed weights drawn from a CPU
``torch.Generator``, with the JAX package's warning. That fallback cannot
reproduce Flax's ``PRNGKey(42)`` initialisation, so the two packages' fallback
features differ; tests hand the port the JAX package's parameters through
``models/convert.py::vgg_params_from_jax`` instead.
"""

from __future__ import annotations

import os
import pickle
import warnings
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

COLOR_MEAN = (0.485, 0.456, 0.406)  # reference train.py:25-26
COLOR_STD = (0.229, 0.224, 0.225)

# vgg19's conv plan up to conv_8 (conv3_4): (out_channels, pool_before)
_VGG19_PREFIX = [
    (64, False),
    (64, False),
    (128, True),
    (128, False),
    (256, True),
    (256, False),
    (256, False),
    (256, False),
]
# torchvision vgg19 ``features`` indices of those convs
_TORCHVISION_IDX = [0, 2, 5, 7, 10, 12, 14, 16]
_SEED = 42  # the JAX package's PRNGKey(42), as a torch.Generator seed


class VGGFeatures(nn.Module):
    """The feature maps at ``style_layers`` (1-indexed conv indices), taken
    before their ReLU (reference style.py:123-129). Takes (B, H, W, 3) RGB in
    [0, 1] and returns a list of (B, H', W', C) tensors, channel-last like the
    JAX package's; the forward stops after the last requested layer."""

    def __init__(self, style_layers: Sequence[int] = (8,)):
        super().__init__()
        self.style_layers = tuple(style_layers)
        cin = 3
        for i, (width, _) in enumerate(_VGG19_PREFIX):
            setattr(self, f"conv_{i + 1}", nn.Conv2d(cin, width, 3, padding=1))
            cin = width
        self.register_buffer("mean", torch.tensor(COLOR_MEAN), persistent=False)
        self.register_buffer("std", torch.tensor(COLOR_STD), persistent=False)

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = ((x - self.mean) / self.std).permute(0, 3, 1, 2)
        outputs = []
        for i, (_, pool_before) in enumerate(_VGG19_PREFIX):
            if pool_before:
                x = F.max_pool2d(x, 2, 2)
            conv_out = getattr(self, f"conv_{i + 1}")(x)
            if (i + 1) in self.style_layers:
                outputs.append(conv_out.permute(0, 2, 3, 1))
            if len(outputs) == len(self.style_layers):
                break
            x = F.relu(conv_out)
        return outputs


def convert_torchvision_weights(state_dict) -> Dict[str, torch.Tensor]:
    """torchvision vgg19 ``features.*`` tensors -> the ``VGGFeatures``
    state_dict (the same OIHW layout, renamed keys)."""
    out = {}
    for i, fi in enumerate(_TORCHVISION_IDX):
        out[f"conv_{i + 1}.weight"] = torch.as_tensor(
            np.asarray(state_dict[f"features.{fi}.weight"], np.float32))
        out[f"conv_{i + 1}.bias"] = torch.as_tensor(
            np.asarray(state_dict[f"features.{fi}.bias"], np.float32))
    return out


def _npz_to_params(path: str) -> Dict[str, torch.Tensor]:
    """A converted ``.npz`` (``conv_i.kernel`` HWIO, ``conv_i.bias``) -> the
    ``VGGFeatures`` state_dict."""
    data = np.load(path)
    out = {}
    for i in range(len(_VGG19_PREFIX)):
        kernel = np.asarray(data[f"conv_{i + 1}.kernel"], np.float32)
        out[f"conv_{i + 1}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(kernel, (3, 2, 0, 1))))
        out[f"conv_{i + 1}.bias"] = torch.from_numpy(
            np.asarray(data[f"conv_{i + 1}.bias"], np.float32))
    return out


def _fixed_seed_params() -> Dict[str, torch.Tensor]:
    """LeCun-normal kernels and zero biases (Flax ``nn.Conv``'s defaults)
    drawn from a CPU ``torch.Generator`` seeded with 42."""
    rng = torch.Generator().manual_seed(_SEED)
    out, cin = {}, 3
    for i, (width, _) in enumerate(_VGG19_PREFIX):
        out[f"conv_{i + 1}.weight"] = (torch.randn((width, cin, 3, 3), generator=rng)
                                       * (1.0 / (cin * 9)) ** 0.5)
        out[f"conv_{i + 1}.bias"] = torch.zeros(width)
        cin = width
    return out


def load_vgg_for_style(style_layers=(8,), device="cuda") -> VGGFeatures:
    """The extractor on ``device``, in eval mode with its parameters frozen
    (they are not trained). Weight search order, the JAX package's:
      1. $SPSG_VGG_WEIGHTS: a converted .npz (tools/convert_vgg19.py) or a
         torchvision vgg19 .pth;
      2. the packaged file spsg_tpu_torch/models/vgg19_conv8.npz;
      3. the torch hub cache ($TORCH_HOME/hub/checkpoints/vgg19-dcbb9e9d.pth);
      4. fixed-seed random weights with a warning: style / content then stay
         well-defined, self-consistent losses, but they are not ImageNet
         features and not comparable to reference numbers."""
    from ..training.state import resolve_device
    from .generator import use_true_float32

    device = resolve_device(device)
    here = os.path.dirname(os.path.abspath(__file__))
    candidates = [
        os.environ.get("SPSG_VGG_WEIGHTS", ""),
        os.path.join(here, "vgg19_conv8.npz"),
        os.path.join(
            os.path.expanduser(os.environ.get("TORCH_HOME", "~/.cache/torch")),
            "hub", "checkpoints", "vgg19-dcbb9e9d.pth",
        ),
    ]
    params = None
    for path in candidates:
        if not path or not os.path.isfile(path):
            continue
        try:
            if path.endswith(".npz"):
                params = _npz_to_params(path)
            else:
                sd = torch.load(path, map_location="cpu", weights_only=True)
                params = convert_torchvision_weights(sd.get("state_dict", sd))
            print(f"vgg: loaded pretrained weights from {path}")
            break
        except (OSError, KeyError, ValueError, RuntimeError, pickle.UnpicklingError) as e:
            print(f"vgg: failed to load {path} ({e})")
    if params is None:
        params = _fixed_seed_params()
        warnings.warn(
            "spsg-tpu: no pretrained VGG19 weights found — style/content "
            "losses and Feature-l1 use FIXED-SEED RANDOM features and are "
            "not comparable to reference numbers. Convert torchvision's "
            "vgg19 once with tools/convert_vgg19.py (see its docstring) "
            "or point SPSG_VGG_WEIGHTS at a vgg19 .pth/.npz.",
            stacklevel=2,
        )
    model = VGGFeatures(style_layers)
    model.load_state_dict(params, strict=True)
    if device.type == "cuda":
        use_true_float32()
    return model.to(device).eval().requires_grad_(False)
