"""Shared helpers of the tests/test_torch_*.py files: the same numpy inputs
and the same weights (carried across spsg_tpu_torch.models.convert) for the
JAX package and for the PyTorch port. Not a test file."""

import functools
import os

import jax
import numpy as np
import torch

from spsg_tpu.models.convert import _GENERATOR_LAYOUT, _HEAD_BN
from spsg_tpu.training.config import TrainConfig as JaxTrainConfig
from spsg_tpu.training.state import init_states, load_checkpoint
from spsg_tpu_torch.models.convert import flax_to_torch_generator
from spsg_tpu_torch.models.generator import Generator, GeneratorConfig

# one intra-op thread: the suite runs several workers side by side, and the JAX
# package's multi-device CPU tests abort when their collectives are starved
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPOCH39 = os.path.join(REPO, "docs", "evidence", "curriculum_r4", "model-epoch39")
CHUNK = (16, 16, 16)


def to_numpy_tree(tree):
    return jax.tree_util.tree_map(lambda a: np.array(a), tree)


@functools.lru_cache(maxsize=None)
def _jax_init(nf):
    cfg = JaxTrainConfig(input_dim=CHUNK, nf_gen=nf, weight_disc_loss=0.0)
    gs, _ = init_states(cfg, jax.random.PRNGKey(0), with_disc=False)
    return to_numpy_tree({"params": gs.params, "batch_stats": gs.batch_stats})


def initial_variables(nf=4):
    """JAX-initialised generator variables (numpy), untouched."""
    return jax.tree_util.tree_map(np.copy, _jax_init(nf))


def random_variables(nf=4, seed=0):
    """JAX-initialised generator variables (numpy) whose BatchNorm scale,
    bias and running statistics are randomised, so that no BatchNorm is the
    identity and a mix-up of any two leaves shows."""
    variables = jax.tree_util.tree_map(np.copy, _jax_init(nf))
    rng = np.random.default_rng(seed)

    def walk(node, kind):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, kind)
            elif kind == "stats":
                node[k] = (rng.uniform(0.5, 1.5, v.shape) if k == "var"
                           else rng.normal(0, 0.1, v.shape)).astype(np.float32)
            elif k == "scale":
                node[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "bias":
                node[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)

    walk(variables["params"], "params")
    walk(variables["batch_stats"], "stats")
    return variables


@functools.lru_cache(maxsize=None)
def epoch39_variables():
    """The trained nf=4 / 16^3 checkpoint committed under docs/evidence,
    restored by the JAX package's own loader (it was saved with a
    discriminator, so the template has one)."""
    cfg = JaxTrainConfig(input_dim=CHUNK, nf_gen=4, nf_disc=4, style_width=48,
                         style_height=32, patch_size=16)
    gs, ds = init_states(cfg, jax.random.PRNGKey(0), with_disc=True)
    gs, _, epoch = load_checkpoint(EPOCH39, gs, ds)
    assert epoch == 40
    return to_numpy_tree({"params": gs.params, "batch_stats": gs.batch_stats})


def torch_generator(variables, nf=4, **cfg_kw):
    gen = Generator(GeneratorConfig(nf=nf, **cfg_kw))
    gen.load_state_dict(flax_to_torch_generator(variables), strict=True)
    return gen


def chunk_inputs(batch=2, dims=CHUNK, seed=0):
    """(x (B,Z,Y,X,4), mask (B,Z,Y,X,1)) float32: a truncated SDF channel that
    reaches +-truncation, colors in [0,1], a 0/1 mask."""
    rng = np.random.default_rng(seed)
    sdf = np.clip(rng.normal(0, 2.5, (batch,) + tuple(dims) + (1,)), -3, 3)
    col = rng.uniform(0, 1, (batch,) + tuple(dims) + (3,))
    mask = (rng.uniform(0, 1, (batch,) + tuple(dims) + (1,)) < 0.3)
    return (np.concatenate([sdf, col], -1).astype(np.float32), mask.astype(np.float32))


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def reference_generator_state_dict(variables, seed):
    """A reference Generator state_dict (torch/model.py module names) holding
    ``variables`` (the JAX package's tree, numpy), plus the
    ``num_batches_tracked`` counters a reference file carries."""
    params, stats = variables["params"], variables["batch_stats"]
    sd = {}
    for prefix, layout in _GENERATOR_LAYOUT.items():
        for conv_i, bn_i, name in layout:
            conv = params[name]["Conv_0"]
            sd[f"{prefix}.{conv_i}.weight"] = np.transpose(conv["kernel"], (4, 3, 0, 1, 2))
            sd[f"{prefix}.{conv_i}.bias"] = conv["bias"]
            if bn_i is not None:
                bn, st = params[name]["BatchNorm_0"], stats[name]["BatchNorm_0"]
                sd.update({f"{prefix}.{bn_i}.weight": bn["scale"],
                           f"{prefix}.{bn_i}.bias": bn["bias"],
                           f"{prefix}.{bn_i}.running_mean": st["mean"],
                           f"{prefix}.{bn_i}.running_var": st["var"],
                           f"{prefix}.{bn_i}.num_batches_tracked": np.int64(seed)})
    for prefix, (name, bn_i) in _HEAD_BN.items():
        sd.update({f"{prefix}.{bn_i}.weight": params[name]["scale"],
                   f"{prefix}.{bn_i}.bias": params[name]["bias"],
                   f"{prefix}.{bn_i}.running_mean": stats[name]["mean"],
                   f"{prefix}.{bn_i}.running_var": stats[name]["var"]})
    return {k: torch.as_tensor(np.ascontiguousarray(v)) for k, v in sd.items()}
