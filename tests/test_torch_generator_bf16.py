"""Generator-level bfloat16 (GeneratorConfig.dtype="bfloat16") of the port
against the JAX package's bf16 forward on the CPU at nf=4: the blocks compute
in bf16, the four heads in float32, the parameters stay float32; training in
bf16 builds the same generator (its step: tests/test_torch_train_step_bf16.py).

Tolerance (ROADMAP.md Queue C). The two packages round at different places:
the fused conv kernel (and its plain version) adds the bias and applies the
LeakyReLU to its float32 sum before rounding once, where the JAX package's
nn.Conv path rounds the conv, the bias add and the LeakyReLU, and XLA may keep
excess precision across its fusions. So the port's bf16 output is held to the
JAX package's by the size of bf16 rounding itself, measured on the same
inputs: per output, with rms over all elements and d(a, b) = rms(a - b),
  d(port bf16, port f32) <= 2.0 * d(JAX bf16, JAX f32)   (the port's bf16 error
                                                          at most twice JAX's)
  d(port bf16, JAX bf16) <= 1.5 * d(JAX bf16, JAX f32)
Measured on these inputs: at most 1.39x and 1.19x."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.models.generator import Generator as JaxGenerator
from spsg_tpu.models.generator import GeneratorConfig as JaxGeneratorConfig
from spsg_tpu_torch.cli import test_scene_as_chunks as cli
from spsg_tpu_torch.models import generator as tg
from spsg_tpu_torch.training import TrainConfig
from spsg_tpu_torch.training.step import Trainer

import torch_port_helpers as H

HEADS = {"geo_occ_b", "geo_3c", "color_head_c", "semantic_head_c"}
NAMES = ("occ", "sdf", "color", "semantic")


def _rms(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


def _forwards(v, x, m):
    """{(package, dtype): the four outputs as numpy} in eval mode."""
    out = {}
    for dt in (None, "bfloat16"):
        jax_gen = JaxGenerator(JaxGeneratorConfig(nf=4, dtype=dt))
        fwd = jax.jit(lambda v, x, m: jax_gen.apply(
            v, x, m, pred_color=True, pred_sdf=True, pred_semantic=True, train=False))
        out["jax", dt] = [np.asarray(o) for o in fwd(v, jnp.asarray(x), jnp.asarray(m))]
        with torch.no_grad():
            out["port", dt] = [o.numpy() for o in H.torch_generator(v, dtype=dt).eval()(
                H.t(x), H.t(m), pred_color=True, pred_semantic=True)]
    return out


@pytest.mark.parametrize("weights", ["random", "trained"])
def test_bf16_forward_matches_the_jax_bf16_forward(weights):
    v = H.random_variables(4, seed=3) if weights == "random" else H.epoch39_variables()
    x, m = H.chunk_inputs(batch=2, seed=2)
    out = _forwards(v, x, m)
    for i, name in enumerate(NAMES):
        pbf, jbf = out["port", "bfloat16"][i], out["jax", "bfloat16"][i]
        assert pbf.dtype == np.float32 and np.isfinite(pbf).all(), name
        d_jax = _rms(jbf, out["jax", None][i])
        d_port = _rms(pbf, out["port", None][i])
        assert d_jax > 0, name
        assert d_port <= 2.0 * d_jax, (name, d_port, d_jax)
        assert _rms(pbf, jbf) <= 1.5 * d_jax, (name, _rms(pbf, jbf), d_jax)


def test_blocks_compute_in_bf16_heads_and_parameters_in_float32():
    """Every block's output is bf16 but the heads' (float32, as the JAX
    package's heads without a dtype); parameters and statistics stay float32
    and a bf16 generator's state_dict loads into a float32 one as it is."""
    v = H.random_variables(4, seed=1)
    gen = H.torch_generator(v, dtype="bfloat16").eval()
    seen = {}
    for name, mod in gen.named_modules():
        if isinstance(mod, (tg.ConvBlock, tg.BatchNorm)) and "." not in name:
            mod.register_forward_hook(lambda m, i, o, name=name: seen.__setitem__(name, o.dtype))
    x, m = H.chunk_inputs(batch=1, seed=4)
    with torch.no_grad():
        outs = gen(H.t(x), H.t(m), pred_color=True, pred_semantic=True)
    assert len(seen) == 37
    assert {n for n, dt in seen.items() if dt == torch.float32} == HEADS
    assert all(dt == torch.bfloat16 for n, dt in seen.items() if n not in HEADS)
    assert all(o.dtype == torch.float32 for o in outs)
    assert all(t.dtype == torch.float32 for t in gen.state_dict().values()
               if t.is_floating_point())
    f32 = tg.Generator(tg.GeneratorConfig(nf=4))
    f32.load_state_dict(gen.state_dict(), strict=True)
    with pytest.raises(ValueError, match="bfloat16"):
        tg.Generator(tg.GeneratorConfig(nf=4, dtype="float16"))


def test_training_in_bf16_raises_naming_the_roadmap(monkeypatch):
    """Training in bf16 is ported (tests/test_torch_train_step_bf16.py): the
    Trainer builds the bf16 generator. The train CLI's --distributed is ported
    too (tests/test_torch_parallel_cli.py) and, without the SPSG_* variables
    of a process group, raises naming them."""
    from spsg_tpu_torch.cli import train as train_cli

    for var in ("SPSG_COORDINATOR", "SPSG_NUM_PROCESSES", "SPSG_PROCESS_ID"):
        monkeypatch.delenv(var, raising=False)
    trainer = Trainer(TrainConfig(input_dim=H.CHUNK, nf_gen=4, compute_dtype="bfloat16"),
                      device="cpu")
    assert trainer.generator.cfg.dtype == "bfloat16"
    with pytest.raises(RuntimeError, match="SPSG_COORDINATOR"):
        train_cli.main(["--device", "cpu", "--synthetic_chunks", "2", "--input_dim", "16",
                        "--nf_gen", "4", "--compute_dtype", "bfloat16", "--distributed"])


def test_chunked_cli_in_bf16(tmp_path):
    """--compute_dtype bfloat16 serves through the chunked CLI; its IoU is
    the float32 run's up to voxels whose occupancy flips in bf16."""
    args = ["--device", "cpu", "--synthetic_scenes", "1", "--input_dim", "16", "--nf_gen", "4",
            "--stride", "8", "--num_to_vis", "0"]
    f32 = cli.main(args + ["--output", str(tmp_path / "a")])
    bf16 = cli.main(args + ["--output", str(tmp_path / "b"), "--compute_dtype", "bfloat16"])
    assert abs(bf16["geo_iou"] - f32["geo_iou"]) <= 0.02
