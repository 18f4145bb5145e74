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
