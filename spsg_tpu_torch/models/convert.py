"""The weight bridge between the JAX package's generator variables and this
package's ``Generator.state_dict()``.

Works on nested dicts of **numpy arrays** shaped like the JAX package's
``{"params": ..., "batch_stats": ...}`` (block names ``geo_0a`` ...
``semantic_head_c``; per block ``Conv_0/{kernel,bias}`` and, where the block
normalises, ``BatchNorm_0/{scale,bias}`` + ``BatchNorm_0/{mean,var}``; the two
bare head norms ``color_head_bn0`` / ``semantic_head_bn0`` hold
``{scale,bias}`` / ``{mean,var}`` directly), so it imports neither framework
of the other side.

One convention for every conv, eligible for the CUDA kernels or not: the
kernel ``(kz, ky, kx, Cin, Cout)`` becomes PyTorch's ``weight``
``(Cout, Cin, kz, ky, kx)``. Both directions only transpose and copy, so the
round trip is exact. :func:`generator_grads_to_flax` carries a module's
gradients across under the same names, to hold them against ``jax.grad``.

The discriminator half: the JAX package's ``params`` (``sn_conv_<k>`` and
``final``, each ``{kernel (kh,kw,Cin,Cout), bias}``) and ``spectral_stats``
(``SpectralNorm_<k>`` / ``sn_conv_<k>/kernel/{u,sigma}``) become the
``Discriminator2D`` state_dict (``convs.<k>.{weight (Cout,Cin,kh,kw), bias}``,
``final.{weight,bias}``) and its spectral state ``{"sn_conv_<k>": {"u",
"sigma"}}``; ``u`` keeps its (1, Cout) shape.

Checkpoints of the original PyTorch reference (``.pth``): its generator's and
discriminator's state_dicts become this package's under the reference's
layout tables (:func:`reference_to_torch_generator`,
:func:`reference_to_torch_discriminator`), as the JAX package's converter maps
them onto its variables.

The perceptual extractors: the JAX package's VGG19 params
(:func:`vgg_params_from_jax`) and its Inception-v3 pytree
(:func:`inception_params_from_jax`) become this package's modules'
state_dicts, kernels transposed HWIO -> OIHW, so that a test can hand both
packages the same weights.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_BN_KEYS = (("scale", "weight"), ("bias", "bias"))
_STAT_KEYS = (("mean", "running_mean"), ("var", "running_var"))


def flax_to_torch_generator(variables) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` (numpy leaves) -> generator state_dict."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    sd: Dict[str, torch.Tensor] = {}

    def put(key, arr):
        sd[key] = torch.from_numpy(np.ascontiguousarray(np.asarray(arr)))

    for name, p in params.items():
        if "Conv_0" in p:
            put(f"{name}.weight", np.transpose(np.asarray(p["Conv_0"]["kernel"]), (4, 3, 0, 1, 2)))
            put(f"{name}.bias", p["Conv_0"]["bias"])
            if "BatchNorm_0" in p:
                for src, dst in _BN_KEYS:
                    put(f"{name}.bn.{dst}", p["BatchNorm_0"][src])
                for src, dst in _STAT_KEYS:
                    put(f"{name}.bn.{dst}", stats[name]["BatchNorm_0"][src])
        else:  # a bare BatchNorm at the top level of the generator
            for src, dst in _BN_KEYS:
                put(f"{name}.{dst}", p[src])
            for src, dst in _STAT_KEYS:
                put(f"{name}.{dst}", stats[name][src])
    return sd


def torch_to_flax_generator(state_dict) -> Dict:
    """Generator state_dict -> ``{"params", "batch_stats"}`` (numpy leaves)."""
    sd = {k: v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
          for k, v in state_dict.items()}
    params: Dict = {}
    stats: Dict = {}
    for key, arr in sd.items():
        parts = key.split(".")
        name = parts[0]
        if len(parts) == 2 and parts[1] == "weight" and arr.ndim == 5:
            params.setdefault(name, {}).setdefault("Conv_0", {})["kernel"] = np.ascontiguousarray(
                np.transpose(arr, (2, 3, 4, 1, 0)))
        elif len(parts) == 2 and parts[1] == "bias" and f"{name}.weight" in sd \
                and sd[f"{name}.weight"].ndim == 5:
            params.setdefault(name, {}).setdefault("Conv_0", {})["bias"] = arr.copy()
        else:
            leaf = parts[-1]
            in_block = len(parts) == 3  # "<block>.bn.<leaf>"
            for tree, keys in ((params, _BN_KEYS), (stats, _STAT_KEYS)):
                for dst, src in keys:
                    if leaf == src:
                        node = tree.setdefault(name, {})
                        if in_block:
                            node = node.setdefault("BatchNorm_0", {})
                        node[dst] = arr.copy()
    return {"params": params, "batch_stats": stats}


def generator_grads_to_flax(generator) -> Dict:
    """The ``.grad`` of every parameter of a generator module as the JAX
    package's ``params`` tree (numpy leaves); a parameter without a gradient
    gives zeros, which is what ``jax.grad`` reports for it."""
    grads = {name: (p.grad if p.grad is not None else torch.zeros_like(p))
             for name, p in generator.named_parameters()}
    return torch_to_flax_generator(grads)["params"]


def flax_to_torch_discriminator(params, spectral_stats=None):
    """Discriminator ``params`` (+ ``spectral_stats``), numpy leaves ->
    (state_dict, spectral state); the spectral state is {} without stats."""
    sd: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        key = "final" if name == "final" else f"convs.{int(name.rsplit('_', 1)[1])}"
        sd[f"{key}.weight"] = torch.from_numpy(
            np.ascontiguousarray(np.transpose(np.asarray(p["kernel"]), (3, 2, 0, 1))))
        sd[f"{key}.bias"] = torch.from_numpy(np.array(p["bias"]))
    sn = {}
    for node in (spectral_stats or {}).values():
        for leaf, v in node.items():
            conv, _, what = leaf.split("/")
            sn.setdefault(conv, {})[what] = torch.from_numpy(np.array(v, dtype=np.float32))
    return sd, sn


def torch_to_flax_discriminator(state_dict, sn_state=None):
    """(Discriminator2D state_dict, spectral state) -> (``params``,
    ``spectral_stats``) with numpy leaves, the inverse of
    :func:`flax_to_torch_discriminator` (``SpectralNorm_<k>`` numbers the
    spectral-normalised convs in order, as Flax names them)."""
    params: Dict = {}
    for key, v in state_dict.items():
        mod, leaf = key.rsplit(".", 1)
        name = "final" if mod == "final" else f"sn_conv_{mod.split('.')[1]}"
        arr = v.detach().cpu().numpy()
        params.setdefault(name, {})["kernel" if leaf == "weight" else "bias"] = (
            np.ascontiguousarray(np.transpose(arr, (2, 3, 1, 0))) if leaf == "weight" else arr.copy())
    stats = {}
    for conv, node in (sn_state or {}).items():
        k = int(conv.rsplit("_", 1)[1])
        stats[f"SpectralNorm_{k}"] = {f"{conv}/kernel/{what}": v.detach().cpu().numpy()
                                      for what, v in node.items()}
    return params, stats


# ---------------------------------------------------------------------------
# checkpoints of the original PyTorch reference (``.pth``)
# ---------------------------------------------------------------------------

# The reference generator's nn.Sequential members (torch/model.py:194-325):
# module prefix -> ordered (conv index, BatchNorm index or None, block of this
# package). The layout tables of the JAX package's models/convert.py, copied.
REFERENCE_GENERATOR_LAYOUT = {
    "geo_0": [(0, 2, "geo_0a"), (3, 5, "geo_0b"), (6, 8, "geo_0c")],
    "geo_1": [(0, 2, "geo_1a"), (3, 5, "geo_1b"), (6, 8, "geo_1c"), (9, 11, "geo_1d")],
    "geo_2": [(0, 2, "geo_2a"), (3, 5, "geo_2b")],
    "geo_occ": [(0, 2, "geo_occ_a"), (3, None, "geo_occ_b")],
    "geo_3": [(0, 2, "geo_3a"), (3, 5, "geo_3b"), (6, None, "geo_3c")],
    "encoder_0": [(0, 2, "encoder_0a"), (3, 5, "encoder_0b"), (6, 8, "encoder_0c")],
    "encoder_geo": [(0, 2, "encoder_geo")],
    "encoder_1": [(0, 2, "encoder_1a"), (3, 5, "encoder_1b"), (6, 8, "encoder_1c")],
    "decoder_2": [(0, 2, "decoder_2a"), (3, 5, "decoder_2b"), (6, 8, "decoder_2c")],
    "decoder_3": [
        (0, 2, "decoder_3a"),
        (3, 5, "decoder_3b"),
        (6, 8, "decoder_3c"),
        (9, 11, "decoder_3d"),
        (12, None, "decoder_3e"),
    ],
    # the heads start with a standalone BatchNorm (model.py:303-325)
    "color_head": [(2, 4, "color_head_a"), (5, 7, "color_head_b"), (8, None, "color_head_c")],
    "semantic_head": [
        (2, 4, "semantic_head_a"),
        (5, 7, "semantic_head_b"),
        (8, None, "semantic_head_c"),
    ],
}
# module prefix -> (this package's BatchNorm, index of the reference's)
REFERENCE_HEAD_BN = {"color_head": ("color_head_bn0", 0),
                     "semantic_head": ("semantic_head_bn0", 0)}
_REFERENCE_BN = ("weight", "bias", "running_mean", "running_var")


def is_reference_state_dict(state_dict) -> bool:
    """True for a state_dict with the reference's module names (``geo_0.0.weight``,
    ``discriminator_net.0.conv2d.weight_orig``): members of an nn.Sequential
    are numbered, this package names its blocks."""
    return any(k.split(".")[1:2] and k.split(".")[1].isdigit() for k in state_dict)


def is_reference_discriminator(state_dict) -> bool:
    return any(k.startswith("discriminator_net.") for k in state_dict)


def _tensor(v) -> torch.Tensor:
    return (v if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))).detach().clone()


def reference_to_torch_generator(state_dict) -> Dict[str, torch.Tensor]:
    """A reference Generator state_dict -> this package's generator
    state_dict. Conv weights keep their (O, I, kz, ky, kx) layout; BatchNorm
    scale, shift and running statistics come across (``num_batches_tracked`` is
    dropped). A branch the reference model was built without (no
    ``pass_geo_feats``: no ``encoder_geo``) is skipped, as the JAX package
    skips it."""
    sd = state_dict
    out: Dict[str, torch.Tensor] = {}
    for prefix, layout in REFERENCE_GENERATOR_LAYOUT.items():
        if f"{prefix}.{layout[0][0]}.weight" not in sd:
            continue
        for conv_i, bn_i, name in layout:
            for leaf in ("weight", "bias"):
                out[f"{name}.{leaf}"] = _tensor(sd[f"{prefix}.{conv_i}.{leaf}"])
            if bn_i is not None:
                for leaf in _REFERENCE_BN:
                    out[f"{name}.bn.{leaf}"] = _tensor(sd[f"{prefix}.{bn_i}.{leaf}"])
    for prefix, (name, bn_i) in REFERENCE_HEAD_BN.items():
        if f"{prefix}.{bn_i}.weight" in sd:
            for leaf in _REFERENCE_BN:
                out[f"{name}.{leaf}"] = _tensor(sd[f"{prefix}.{bn_i}.{leaf}"])
    return out


def reference_to_torch_discriminator(state_dict):
    """A reference Discriminator2D state_dict -> (this package's discriminator
    state_dict, spectral state for the convs that carry power-iteration vectors).

    The reference wraps each 4x4 stride-2 conv in ``torch.nn.utils.spectral_norm``
    (model.py:19-24): ``weight_orig`` becomes the kernel and ``weight_u`` the
    stored ``u`` (1, Cout). ``sigma`` = u^T W v is recomputed in float32 from
    ``weight_v`` (or, without it, from v = normalise(W^T u)) as the JAX
    package's converter does; a call reads only ``u``. The Sequential's members
    are ``0``, then ``p1``, ``p2``, ... (model.py:57-76); the 1x1 ``final`` conv
    is not spectral-normalised."""
    sd = {k: np.asarray(v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v)
          for k, v in state_dict.items()}
    out: Dict[str, torch.Tensor] = {}
    sn = {}
    k = 0
    while True:
        base = f"discriminator_net.{'0' if k == 0 else f'p{k}'}.conv2d"
        wkey = f"{base}.weight_orig" if f"{base}.weight_orig" in sd else f"{base}.weight"
        if wkey not in sd:
            break
        w = sd[wkey]  # (O, I, kh, kw), this package's layout too
        out[f"convs.{k}.weight"] = _tensor(w)
        if f"{base}.bias" in sd:
            out[f"convs.{k}.bias"] = _tensor(sd[f"{base}.bias"])
        if f"{base}.weight_u" in sd:
            u = sd[f"{base}.weight_u"].astype(np.float32)  # (O,)
            wm = w.reshape(w.shape[0], -1).astype(np.float32)  # (O, I*kh*kw)
            if f"{base}.weight_v" in sd:
                v = sd[f"{base}.weight_v"].astype(np.float32)
            else:
                v = wm.T @ u
                v /= max(float(np.linalg.norm(v)), 1e-12)
            sigma = float(u @ (wm @ v))
            sn[f"sn_conv_{k}"] = {"u": torch.from_numpy(u[None, :].copy()),
                                  "sigma": torch.tensor(sigma, dtype=torch.float32)}
        k += 1
    for leaf in ("weight", "bias"):
        if f"final.{leaf}" in sd:
            out[f"final.{leaf}"] = _tensor(sd[f"final.{leaf}"])
    return out, sn


# ---------------------------------------------------------------------------
# the perceptual feature extractors (``models/vgg.py``, ``models/inception.py``)
# ---------------------------------------------------------------------------


def _oihw(hwio) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(
        np.transpose(np.asarray(hwio, np.float32), (3, 2, 0, 1))))


def vgg_params_from_jax(params) -> Dict[str, torch.Tensor]:
    """The JAX package's ``VGGFeatures`` params (``conv_i/{kernel (3,3,Cin,Cout),
    bias}``, numpy leaves) -> the ``VGGFeatures`` state_dict of this package
    (``conv_i.{weight (Cout,Cin,3,3), bias}``)."""
    out: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        out[f"{name}.weight"] = _oihw(p["kernel"])
        out[f"{name}.bias"] = torch.from_numpy(np.array(p["bias"], np.float32))
    return out


def inception_params_from_jax(params) -> Dict[str, torch.Tensor]:
    """The JAX package's Inception-v3 pytree (per conv ``{w (kh,kw,Cin,Cout),
    scale, bias, mean, var}``, and ``fc: {w (2048,1000), b}``; numpy leaves) ->
    the ``InceptionV3`` state_dict of this package under torchvision's key
    names (``<conv>.conv.weight``, ``<conv>.bn.{weight,bias,running_mean,
    running_var,num_batches_tracked}``, ``fc.{weight,bias}``)."""
    out: Dict[str, torch.Tensor] = {}
    for name, p in params.items():
        if name == "fc":
            out["fc.weight"] = torch.from_numpy(
                np.ascontiguousarray(np.asarray(p["w"], np.float32).T))
            out["fc.bias"] = torch.from_numpy(np.array(p["b"], np.float32))
            continue
        out[f"{name}.conv.weight"] = _oihw(p["w"])
        for mine, theirs in (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"),
                             ("var", "running_var")):
            out[f"{name}.bn.{theirs}"] = torch.from_numpy(np.array(p[mine], np.float32))
        out[f"{name}.bn.num_batches_tracked"] = torch.tensor(0)
    return out
