"""The port's whole-scene CLI on the CPU at 16^3 / nf=4, its checkpoints, and
its refusal to run on a CPU it was not asked to use."""

import os
import re
import sys

import numpy as np
import pytest
import torch

from spsg_tpu_torch.cli import test_scene_as_chunks as cli
from spsg_tpu_torch.data import category
from spsg_tpu_torch.training import TrainConfig
from spsg_tpu_torch.training import state

import torch_port_helpers as H

sys.path.insert(0, os.path.join(H.REPO, "tools"))
import export_torch_checkpoint  # noqa: E402

TINY = ["--device", "cpu", "--synthetic_scenes", "1", "--input_dim", "16",
        "--nf_gen", "4", "--stride", "8"]


def _check_iou_txt(path, summary):
    """IoU.txt in the reference's format: geo IoU, 14 names, 14 values, mean."""
    lines = open(path).read().split("\n")
    assert len(lines) == 1 + 14 + 14 + 1
    assert float(lines[0]) == summary["geo_iou"]
    assert lines[1:15] == list(category.CLASS_NAMES)
    assert all(re.fullmatch(r"\d\.\d{3}", v) for v in lines[15:29])
    assert lines[29] == f"Mean: {summary['mean_iou']}"


def test_cli_writes_iou_txt_and_meshes(tmp_path):
    out = str(tmp_path / "out")
    summary = cli.main(TINY + ["--model_path", "", "--output", out, "--num_to_vis", "1"])
    assert 0.0 < summary["geo_iou"] <= 1.0 and 0.0 <= summary["mean_iou"] <= 1.0
    _check_iou_txt(os.path.join(out, "IoU.txt"), summary)
    vis = os.listdir(os.path.join(out, "vis"))
    assert "synthetic_scene_0_target-mesh.ply" in vis
    assert "synthetic_scene_0_input-mesh.ply" in vis


def test_cli_accepts_the_jax_cli_flags_without_effect(tmp_path):
    base = cli.main(TINY + ["--output", str(tmp_path / "a"), "--num_to_vis", "0"])
    flags = cli.main(TINY + ["--output", str(tmp_path / "b"), "--num_to_vis", "0",
                             "--scan_windows", "--stitch_slices", "--gpu", "3"])
    assert base == flags
    assert open(tmp_path / "a" / "IoU.txt").read() == open(tmp_path / "b" / "IoU.txt").read()


class _Built(Exception):
    """Raised by a stand-in for init_generator: the CLI got as far as building
    its generator, and the test stops it there."""


def built_generator_config(main, argv, monkeypatch):
    """The GeneratorConfig a CLI's ``main(argv)`` builds its generator with,
    without running anything after that."""
    seen = {}

    def init_generator(cfg, rng, device="cuda", plain_convs=False):
        seen["cfg"] = state.make_generator(cfg, device).cfg
        raise _Built

    monkeypatch.setattr(state, "init_generator", init_generator)
    with pytest.raises(_Built):
        main(argv)
    return seen["cfg"]


@pytest.mark.parametrize("flags", [[], ["--zslab_conv"], ["--folded_conv"],
                                   ["--zslab_conv", "--folded_conv"]])
def test_conv_form_flags_reach_the_generator(tmp_path, monkeypatch, flags):
    cfg = built_generator_config(cli.main, TINY + ["--output", str(tmp_path / "o")] + flags,
                                 monkeypatch)
    assert (cfg.zslab_conv, cfg.folded_conv, cfg.remat) == (
        "--zslab_conv" in flags, "--folded_conv" in flags, False)


def test_exported_checkpoint_loads_and_serves(tmp_path):
    """tools/export_torch_checkpoint.py: orbax checkpoint of the JAX package ->
    .pt -> the port's CLI; the file holds exactly the bridged variables."""
    pt = str(tmp_path / "epoch39.pt")
    cfg = export_torch_checkpoint.config_from_args_txt(
        os.path.join(os.path.dirname(H.EPOCH39), "args.txt"), {})
    assert (cfg.nf_gen, cfg.input_dim, cfg.nf_disc) == (4, (16, 16, 16), 4)
    assert export_torch_checkpoint.export(H.EPOCH39, pt, cfg) == 40

    gen = state.make_generator(TrainConfig(input_dim=H.CHUNK, nf_gen=4), device="cpu")
    gen, epoch = state.load_checkpoint(pt, gen)
    assert epoch == 40
    ref = H.torch_generator(H.epoch39_variables()).state_dict()
    assert all(torch.equal(ref[k], v) for k, v in gen.state_dict().items())

    out = str(tmp_path / "out")
    summary = cli.main(TINY + ["--model_path", pt, "--output", out, "--num_to_vis", "0"])
    # trained weights on a scene of the kind they were trained on (random
    # weights give 0.37 here; parity with the JAX package: test_torch_chunked.py)
    assert summary["geo_iou"] > 0.45 and summary["mean_iou"] > 0.2
    _check_iou_txt(os.path.join(out, "IoU.txt"), summary)


def test_exported_checkpoint_with_a_discriminator_loads_into_a_trainer(tmp_path):
    """tools/export_torch_checkpoint.py carries the discriminator and its
    spectral state across too: an orbax checkpoint of the JAX package written
    here (nf_gen 4, a discriminator), exported and loaded into a port Trainer,
    gives the same generator, discriminator and spectral state; both Adams
    start afresh (the export carries no moments)."""
    import jax

    from spsg_tpu.training import TrainConfig as JaxTrainConfig
    from spsg_tpu.training.state import init_states, save_checkpoint
    from spsg_tpu_torch.models.convert import (
        flax_to_torch_discriminator, flax_to_torch_generator)
    from spsg_tpu_torch.training.step import Trainer

    kw = dict(input_dim=H.CHUNK, nf_gen=4, nf_disc=4, style_width=48, style_height=32,
              patch_size=16)
    jcfg = JaxTrainConfig(**kw)
    gs, ds = init_states(jcfg, jax.random.PRNGKey(3))
    orbax_dir = str(tmp_path / "model-epoch4")
    save_checkpoint(orbax_dir, gs, ds, 5)
    pt = str(tmp_path / "epoch4.pt")
    assert export_torch_checkpoint.export(orbax_dir, pt, jcfg) == 5

    trainer = Trainer(TrainConfig(**kw), device="cpu", seed=0)
    trainer, epoch = state.load_checkpoint(pt, trainer)
    assert epoch == 5
    gen = flax_to_torch_generator(H.to_numpy_tree(
        {"params": gs.params, "batch_stats": gs.batch_stats}))
    disc, sn = flax_to_torch_discriminator(H.to_numpy_tree(ds.params),
                                           H.to_numpy_tree(ds.spectral_stats))
    for got, want in ((trainer.generator.state_dict(), gen),
                      (trainer.discriminator.state_dict(), disc)):
        assert got.keys() == want.keys()
        assert all(torch.equal(v, want[k]) for k, v in got.items())
    assert sn.keys() == trainer.sn_state.keys() and len(sn) == 2  # 2 convs at 16-pixel patches
    assert all(torch.equal(trainer.sn_state[k][kk], v) for k, s in sn.items()
               for kk, v in s.items())
    assert not trainer.optimizer.state and not trainer.disc_optimizer.state


def test_checkpoint_round_trip_and_foreign_files(tmp_path):
    cfg = TrainConfig(input_dim=H.CHUNK, nf_gen=4)
    a = state.init_generator(cfg, torch.Generator().manual_seed(1), device="cpu")
    b = state.init_generator(cfg, torch.Generator().manual_seed(2), device="cpu")
    assert not torch.equal(a.geo_0a.weight, b.geo_0a.weight)
    path = str(tmp_path / "ckpt" / "model-epoch7.pt")
    state.save_checkpoint(path, a, 7)
    b, epoch = state.load_checkpoint(path, b)
    assert epoch == 7
    assert all(torch.equal(v, b.state_dict()[k]) for k, v in a.state_dict().items())
    # same seed, same draw; conv weights within the kaiming-uniform bound
    c = state.init_generator(cfg, torch.Generator().manual_seed(1), device="cpu")
    assert torch.equal(a.decoder_3a.weight, c.decoder_3a.weight)
    w = a.decoder_3a.weight
    assert float(w.detach().abs().max()) <= 1 / np.sqrt(w[0].numel())
    assert float(a.decoder_3a.bias.detach().abs().max()) == 0
    # a checkpoint of the original reference is recognised by its names, not
    # misread: load_checkpoint sends it to load_any_checkpoint, which converts
    # it (tests/test_torch_reference_checkpoint.py) and refuses this torso
    foreign = str(tmp_path / "ref.pth")
    torch.save({"epoch": 1, "state_dict": {"geo_0.0.weight": torch.zeros(1)}}, foreign)
    with pytest.raises(ValueError, match="load_any_checkpoint"):
        state.load_checkpoint(foreign, b)
    with pytest.raises(KeyError, match="geo_0.0.bias"):
        state.load_any_checkpoint(foreign, b)


@pytest.mark.parametrize("entry", ["cli", "run_chunked_inference", "make_generator"])
def test_default_device_without_a_gpu_raises(entry, tmp_path, monkeypatch):
    """Entry points default to the GPU and do not fall back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        if entry == "cli":
            cli.main(["--synthetic_scenes", "1", "--input_dim", "16", "--nf_gen", "4",
                      "--output", str(tmp_path / "o")])
        elif entry == "run_chunked_inference":
            from spsg_tpu_torch.inference import chunked
            x = np.zeros((16, 16, 16, 4), np.float32)
            chunked.run_chunked_inference(None, x, x[..., :1], None, None, None,
                                          chunk_dims=H.CHUNK)
        else:
            state.make_generator(TrainConfig(input_dim=H.CHUNK, nf_gen=4))
    assert not os.path.exists(tmp_path / "o")


@pytest.mark.parametrize("argv", [["--compact_feed", "--augment_rgb_scaling"],
                                  ["--compute_dtype", "float16"]])
def test_cli_unported_options_raise(argv, tmp_path):
    """--compact_feed and --compute_dtype bfloat16 are ported
    (tests/test_torch_compact_feed.py, tests/test_torch_generator_bf16.py);
    what the CLI still refuses: the compact feed with hue augmentation, as the
    JAX package's CLI does, and a compute type other than bfloat16."""
    err = SystemExit if "--compact_feed" in argv else ValueError
    with pytest.raises(err, match="augment_rgb_scaling|bfloat16"):
        cli.main(TINY + ["--output", str(tmp_path / "o")] + argv)
