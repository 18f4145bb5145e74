"""The port's single-shot whole-scene CLI (spsg_tpu_torch/cli/test_scene.py)
against the JAX package's (spsg_tpu/cli/test_scene.py) on the CPU, with the
arguments of tests/test_cli.py::test_scene_eval_cli_synthetic and one
reference-format .pth (the trained nf=4 checkpoint under the reference's
module names) given to both."""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from spsg_tpu.cli import test_scene as jcli
from spsg_tpu_torch.cli import test_scene as cli

import torch_port_helpers as H

ARGS = ["--synthetic_scenes", "1", "--nf_gen", "4", "--max_input_height", "16",
        "--style_width", "48", "--style_height", "32", "--num_to_vis", "1"]


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    """Both CLIs' output folders, one run each, from the same .pth."""
    tmp = tmp_path_factory.mktemp("scene_cli")
    pth = str(tmp / "model-epoch39.pth")
    torch.save({"epoch": 40, "state_dict": H.reference_generator_state_dict(
        H.epoch39_variables(), 40), "optimizer": {}}, pth)
    jax_out, port_out = str(tmp / "jax"), str(tmp / "port")
    jcli.main(ARGS + ["--model_path", pth, "--output", jax_out])
    cli.main(ARGS + ["--model_path", pth, "--output", port_out, "--device", "cpu"])
    return jax_out, port_out


def test_cli_writes_the_jax_clis_files(outputs):
    jax_out, port_out = outputs
    names = sorted(os.listdir(port_out))
    assert names == sorted(os.listdir(jax_out))
    # what tests/test_cli.py::test_scene_eval_cli_synthetic asks of the JAX CLI
    assert "synthetic_scene_0_pred-mesh.ply" in names
    assert {f"synthetic_scene_0_{k}.png" for k in (
        "input", "input-normals", "target", "target-normals", "target-depth",
        "target-semantics", "pred", "pred-normals", "pred-depth", "pred-semantics")} <= set(names)


def test_pth_renders_match_the_jax_cli(outputs):
    """Every image (the prediction's renders from the .pth, and the input's and
    target's) within 1 grey level of the JAX CLI's on >= 99.9 % of its values;
    the prediction's renders are not blank."""
    jax_out, port_out = outputs
    pngs = sorted(f for f in os.listdir(jax_out) if f.endswith(".png"))
    assert len(pngs) == 10
    for name in pngs:
        a = np.asarray(Image.open(os.path.join(port_out, name)), np.int16)
        b = np.asarray(Image.open(os.path.join(jax_out, name)), np.int16)
        assert a.shape == b.shape, name
        assert (np.abs(a - b) <= 1).mean() >= 0.999, name
    pred = np.asarray(Image.open(os.path.join(port_out, "synthetic_scene_0_pred-normals.png")))
    assert (pred > 0).any()


def test_default_device_without_a_gpu_raises(tmp_path, monkeypatch):
    """The CLI runs on the GPU unless asked otherwise, and does not fall back."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        cli.main(ARGS + ["--output", str(tmp_path / "o")])
    assert not os.path.exists(tmp_path / "o")


def test_cpu_flag_and_unported_options(tmp_path):
    """--cpu means --device cpu (here with a bf16 generator, the scene cut by
    --input_dim, and the flags the JAX package's compiler reads);
    --spatial_shard without a process group is a world of one and runs
    (two ranks: tests/test_torch_parallel_cli.py)."""
    out = str(tmp_path / "bf16")
    cli.main(ARGS + ["--cpu", "--compute_dtype", "bfloat16", "--num_to_vis", "0",
                     "--input_dim", "16", "64", "64", "--output", out, "--zslab_conv",
                     "--folded_conv"])
    assert os.listdir(out) == []
    out = str(tmp_path / "s")
    cli.main(ARGS + ["--device", "cpu", "--spatial_shard", "--num_to_vis", "0",
                     "--input_dim", "16", "64", "64", "--output", out])
    assert os.listdir(out) == []


@pytest.mark.parametrize("flags", [["--zslab_conv"], ["--folded_conv"]])
def test_conv_form_flags_reach_the_generator(tmp_path, monkeypatch, flags):
    from test_torch_cli import built_generator_config

    cfg = built_generator_config(
        cli.main, ARGS + ["--device", "cpu", "--output", str(tmp_path / "o")] + flags,
        monkeypatch)
    assert (cfg.zslab_conv, cfg.folded_conv) == ("--zslab_conv" in flags,
                                                 "--folded_conv" in flags)
