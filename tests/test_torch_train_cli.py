"""The port's train CLI (spsg_tpu_torch/cli/train.py) on the CPU at 16^3 /
nf 4: what it writes (args.txt, log.csv with the JAX CLI's header,
log_val.csv, model-epoch*.pt), the serving CLI on its checkpoint, --retrain
and --retrain_disc, the style / content losses with a VGG converted from a
fabricated torchvision file, the options it does not port yet, the JAX CLI's
compiler flags, and its refusal to run on a CPU it was not asked to use."""

import json
import os
import runpy
import sys

import numpy as np
import pytest
import torch

from spsg_tpu.utils.logging import make_header
from spsg_tpu_torch.cli import test_scene_as_chunks as serve_cli
from spsg_tpu_torch.cli import train as cli

import test_torch_style as style_tests
import torch_port_helpers as H

TINY = ["--device", "cpu", "--synthetic_chunks", "4", "--input_dim", "16", "--nf_gen", "4",
        "--num_iters_geo_only", "1"]
GEO = TINY + ["--weight_disc_loss", "0", "--weight_depth_loss", "0"]
# the full step at 48x32 with a discriminator of 4 features and 16-pixel patches
FULL = TINY + ["--style_width", "48", "--style_height", "32", "--patch_size", "16",
               "--nf_disc", "4", "--max_depth_fill_iters", "20"]
XLA_ONLY = ["--pallas_conv", "--fused_conv", "--compact_resid", "--channels_first",
            "--pair_raycast", "--compact_global", "--march_group", "2", "--steps_per_call", "4"]


@pytest.fixture(scope="module")
def geo_run(tmp_path_factory):
    save = str(tmp_path_factory.mktemp("geo") / "run")
    result = cli.main(GEO + ["--max_epoch", "1", "--save", save])
    return save, result


def _val_rows(save):
    """log_val.csv's rows without the time column."""
    lines = open(os.path.join(save, "log_val.csv")).read().splitlines()
    return [line.rsplit(",", 1)[0] for line in lines]


def test_cli_writes_its_logs_and_checkpoints(geo_run):
    save, result = geo_run
    assert sorted(f for f in os.listdir(save) if not f.startswith("iter")) == [
        "args.txt", "log.csv", "log_val.csv", "model-epoch0.pt"]
    args = json.load(open(os.path.join(save, "args.txt")))
    assert args["device"] == "cpu" and args["nf_gen"] == 4 and args["input_dim"] == 16
    log = open(os.path.join(save, "log.csv")).read().splitlines()
    assert log == [",".join(make_header(["train"]))]  # too short a run for a train row
    val = _val_rows(save)
    assert len(val) == 2 and val[1].startswith("0,2,")
    ckpt = torch.load(os.path.join(save, "model-epoch0.pt"), weights_only=True)
    assert ckpt["epoch"] == 1 and sorted(ckpt) == ["epoch", "optimizer", "state_dict"]
    assert result.iteration == 2 and result.trainer.device.type == "cpu"
    # the epoch's visual dump of the last batch
    assert os.listdir(os.path.join(save, "iter2-epoch0", "train"))


def test_serving_cli_serves_a_training_checkpoint(geo_run, tmp_path):
    save, result = geo_run
    summary = serve_cli.main(["--device", "cpu", "--synthetic_scenes", "1", "--input_dim", "16",
                              "--nf_gen", "4", "--stride", "8", "--num_to_vis", "0",
                              "--model_path", os.path.join(save, "model-epoch0.pt"),
                              "--output", str(tmp_path / "out")])
    assert 0.0 < summary["geo_iou"] <= 1.0
    assert os.path.isfile(tmp_path / "out" / "IoU.txt")


def test_retrain_continues_the_run(geo_run, tmp_path):
    save, first = geo_run
    resumed = cli.main(GEO + ["--max_epoch", "2", "--save", str(tmp_path / "more"),
                              "--retrain", os.path.join(save, "model-epoch0.pt")])
    # epoch 1 only, counted on from the checkpoint's epoch
    assert resumed.iteration == 4
    val = _val_rows(str(tmp_path / "more"))
    assert len(val) == 2 and val[1].startswith("1,4,")
    assert all(int(s["step"]) == 4 for s in resumed.trainer.optimizer.state.values())


def test_retrain_disc_takes_the_discriminator_of_another_run(geo_run, tmp_path):
    with_disc = cli.main(FULL + ["--max_epoch", "1", "--num_iters_geo_only", "0",
                                 "--save", str(tmp_path / "disc")])
    ckpt = str(tmp_path / "disc" / "model-epoch0.pt")
    saved = torch.load(ckpt, weights_only=True)
    assert {"disc_state_dict", "sn_state", "disc_optimizer"} <= set(saved)
    # no epoch to run: the state right after loading
    loaded = cli.main(FULL + ["--start_epoch", "1", "--max_epoch", "1", "--retrain_disc", ckpt,
                              "--save", str(tmp_path / "other")]).trainer
    sd = with_disc.trainer.discriminator.state_dict()
    assert all(torch.equal(v, sd[k]) for k, v in loaded.discriminator.state_dict().items())
    assert all(torch.equal(v, with_disc.trainer.sn_state[k][kk])
               for k, s in loaded.sn_state.items() for kk, v in s.items())
    assert not torch.equal(loaded.generator.geo_0a.weight, with_disc.trainer.generator.geo_0a.weight)
    # a checkpoint without a discriminator is refused
    with pytest.raises(ValueError, match="no discriminator"):
        cli.main(FULL + ["--max_epoch", "1", "--save", str(tmp_path / "bad"),
                         "--retrain_disc", os.path.join(geo_run[0], "model-epoch0.pt")])


@pytest.mark.parametrize("argv", [["--distributed"]])
def test_unported_options_raise(argv, tmp_path, monkeypatch):
    """--distributed needs the SPSG_* variables of a process group and raises
    without them, before it writes anything (two ranks:
    tests/test_torch_parallel_cli.py)."""
    for var in ("SPSG_COORDINATOR", "SPSG_NUM_PROCESSES", "SPSG_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(RuntimeError, match="SPSG_COORDINATOR"):
        cli.main(GEO + argv + ["--save", str(tmp_path / "run")])
    assert not os.path.exists(tmp_path / "run")


def test_cli_trains_in_bfloat16_and_resumes_in_bfloat16(tmp_path):
    """--compute_dtype bfloat16: two full steps with finite losses, args.txt
    records the type, and a run resumed from the checkpoint with the same
    arguments trains the bf16 generator on the saved float32 weights."""
    bf16 = FULL + ["--num_iters_geo_only", "0", "--compute_dtype", "bfloat16", "--no_vis"]
    save = str(tmp_path / "bf16")
    first = cli.main(bf16 + ["--max_epoch", "1", "--save", save])
    assert first.iteration == 2 and first.trainer.generator.cfg.dtype == "bfloat16"
    assert json.load(open(os.path.join(save, "args.txt")))["compute_dtype"] == "bfloat16"
    rows = open(os.path.join(save, "log_val.csv")).read().splitlines()
    vals = [float(x) for x in rows[-1].split(",")[2:] if x]
    assert len(rows) == 2 and vals and all(np.isfinite(vals))
    ckpt = os.path.join(save, "model-epoch0.pt")
    saved = torch.load(ckpt, weights_only=True)
    assert all(v.dtype == torch.float32 for v in saved["state_dict"].values()
               if v.is_floating_point())
    # no epoch to run: the state right after loading
    resumed = cli.main(bf16 + ["--start_epoch", "1", "--max_epoch", "1", "--retrain", ckpt,
                               "--save", str(tmp_path / "again")]).trainer
    assert resumed.generator.cfg.dtype == "bfloat16"
    sd = resumed.generator.state_dict()
    assert all(torch.equal(v, sd[k]) for k, v in saved["state_dict"].items())
    assert all(int(s["step"]) == 2 for s in resumed.optimizer.state.values())


def test_the_jax_cli_compiler_flags_are_accepted_without_effect(geo_run, tmp_path):
    save = str(tmp_path / "flags")
    cli.main(GEO + XLA_ONLY + ["--max_epoch", "1", "--save", save, "--no_vis",
                               "--profile_dir", str(tmp_path / "trace")])
    assert _val_rows(save) == _val_rows(geo_run[0])
    assert os.path.isfile(tmp_path / "trace" / "trace.json")
    assert not any(f.startswith("iter") for f in os.listdir(save))  # --no_vis


@pytest.mark.parametrize("flags", [["--zslab_conv"], ["--folded_conv"], ["--remat"],
                                   ["--zslab_conv", "--folded_conv", "--remat"]])
def test_conv_form_and_remat_flags_reach_the_generator(flags):
    from spsg_tpu_torch.training.state import make_generator

    cfg = cli.config_from_args(cli.build_parser().parse_args(GEO + flags))
    gen_cfg = make_generator(cfg, "cpu").cfg
    want = tuple(f"--{n}" in flags for n in ("zslab_conv", "folded_conv", "remat"))
    assert (cfg.zslab_conv, cfg.folded_conv, cfg.remat) == want
    assert (gen_cfg.zslab_conv, gen_cfg.folded_conv, gen_cfg.remat) == want


def test_cli_without_a_gpu_raises_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [a for a in GEO if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(argv + ["--save", str(tmp_path / "run")])
    assert not os.path.exists(tmp_path / "run")


def test_cli_trains_with_style_and_content(tmp_path, monkeypatch):
    """--weight_style_loss / --weight_content_loss with the VGG from an .npz
    that tools/convert_vgg19.py wrote from a fabricated torchvision file
    ($SPSG_VGG_WEIGHTS): 20 full steps with style and content from the first
    (--num_iters_before_content 0), so log.csv has its train row, and both
    columns in it are finite and positive."""
    pth, npz = str(tmp_path / "vgg19.pth"), str(tmp_path / "vgg19_conv8.npz")
    style_tests.fabricate_vgg19_pth(pth)
    monkeypatch.setattr(sys, "argv", ["convert_vgg19.py", "--src", pth, "--out", npz])
    runpy.run_path(os.path.join(H.REPO, "tools", "convert_vgg19.py"), run_name="__main__")
    monkeypatch.setenv("SPSG_VGG_WEIGHTS", npz)
    save = str(tmp_path / "style")
    # the later --synthetic_chunks wins
    result = cli.main(FULL + ["--synthetic_chunks", "40", "--max_epoch", "1",
                              "--num_iters_geo_only", "0", "--num_iters_before_content", "0",
                              "--weight_style_loss", "1", "--weight_content_loss", "1",
                              "--no_vis", "--save", save])
    assert result.iteration == 20
    vgg = result.trainer.vgg
    assert vgg is not None and result.trainer.device.type == "cpu"
    assert torch.equal(vgg.conv_1.weight.cpu(), torch.load(pth)["features.0.weight"])
    header, row = open(os.path.join(save, "log.csv")).read().splitlines()
    values = dict(zip(header.split(","), row.split(",")))
    for col in ("train_loss(style)", "train_loss(content)"):
        v = float(values[col])
        assert np.isfinite(v) and v > 0, (col, v)
    # the VGG is not trained and not saved
    saved = torch.load(os.path.join(save, "model-epoch0.pt"), weights_only=True)
    assert not any("conv_1" in k for k in saved["state_dict"])
