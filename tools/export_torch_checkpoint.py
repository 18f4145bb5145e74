#!/usr/bin/env python
"""Convert a checkpoint trained with the JAX package into the PyTorch port's
``.pt`` file, so that ``spsg_tpu_torch`` can serve it.

Reads the orbax checkpoint directory with
``spsg_tpu.training.state.load_checkpoint`` (this needs jax, flax and orbax),
carries the generator's parameters and BatchNorm statistics across
``spsg_tpu_torch.models.convert`` and writes ``{"epoch", "state_dict"}`` with
``torch.save``. This script is the only place where the two packages meet
outside the tests.

The restore needs the shapes the run was made with. They are read from the
``args.txt`` that ``spsg_tpu.cli.train`` writes beside its checkpoints, or
given by flags:

  python tools/export_torch_checkpoint.py docs/evidence/curriculum_r4/model-epoch39 out.pt
  python tools/export_torch_checkpoint.py run/model-epoch9 out.pt --nf_gen 20 --no_disc
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def config_from_args_txt(path: str, overrides: dict):
    """TrainConfig of the run that wrote ``path`` (the train CLI's args.txt),
    with ``overrides`` (flag values that are not None) applied on top."""
    from spsg_tpu.training.config import TrainConfig

    raw = {}
    if os.path.isfile(path):
        with open(path) as f:
            raw = json.load(f)
    raw.update({k: v for k, v in overrides.items() if v is not None})
    fields = {}
    if "input_dim" in raw:
        d = raw["input_dim"]
        d = (128, 64, 64) if d == 0 else d
        fields["input_dim"] = tuple(d) if isinstance(d, (list, tuple)) else (int(d),) * 3
    for k in ("nf_gen", "nf_disc", "style_width", "style_height", "patch_size",
              "weight_disc_loss", "weight_depth_loss", "weight_color_loss", "truncation",
              "pass_geo_feats", "disc_loss_type", "patch_disc"):
        if k in raw:
            fields[k] = raw[k]
    if "input_mask" in raw:
        fields["input_mask"] = bool(raw["input_mask"])
    return TrainConfig(**fields)


def export(checkpoint: str, out: str, cfg=None, with_disc=None) -> int:
    """Write ``out`` from the orbax ``checkpoint``; returns the epoch."""
    import jax
    import torch

    from spsg_tpu.training.config import TrainConfig
    from spsg_tpu.training.state import init_states, load_checkpoint
    from spsg_tpu_torch.models.convert import flax_to_torch_generator

    cfg = cfg or TrainConfig()
    if with_disc is None:
        with_disc = cfg.weight_disc_loss > 0
    gen_state, disc_state = init_states(cfg, jax.random.PRNGKey(0), with_disc=with_disc)
    gen_state, _, epoch = load_checkpoint(checkpoint, gen_state, disc_state)
    variables = jax.tree_util.tree_map(
        np.asarray, {"params": gen_state.params, "batch_stats": gen_state.batch_stats})
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    torch.save({"epoch": int(epoch), "state_dict": flax_to_torch_generator(variables)}, out)
    return int(epoch)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("checkpoint", help="orbax checkpoint directory (model-epochN)")
    p.add_argument("out", help="path of the .pt file to write")
    p.add_argument("--args_txt", default="",
                   help="args.txt of the run (default: beside the checkpoint)")
    p.add_argument("--nf_gen", type=int, default=None)
    p.add_argument("--nf_disc", type=int, default=None)
    p.add_argument("--input_dim", type=int, default=None, help="0 = (128,64,64)")
    p.add_argument("--no_disc", action="store_true",
                   help="the checkpoint was saved without a discriminator")
    args = p.parse_args(argv)
    args_txt = args.args_txt or os.path.join(
        os.path.dirname(os.path.abspath(args.checkpoint)), "args.txt")
    cfg = config_from_args_txt(
        args_txt, dict(nf_gen=args.nf_gen, nf_disc=args.nf_disc, input_dim=args.input_dim))
    epoch = export(args.checkpoint, args.out, cfg, with_disc=False if args.no_disc else None)
    print(f"wrote {args.out} (epoch {epoch}, nf_gen {cfg.nf_gen})")


if __name__ == "__main__":
    main()
