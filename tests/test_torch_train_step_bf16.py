"""The port's full training step in bfloat16 (TrainConfig.compute_dtype =
"bfloat16": the generator's blocks compute in bf16, its parameters, their
Adam state, the heads, the losses and the discriminator stay float32)
against the JAX package's Trainer.step with the same compute type, on the
CPU: the tiny config and the framed batch of tests/test_torch_train_step_2d.py,
the same initial weights of both networks.

Tolerance (ROADMAP.md Queue C). The two packages round at different places
in bf16, so the port's bf16 step is held to the JAX package's by the size of
bf16 rounding itself, measured on the same inputs, with d(a, b) = |a - b| for
a metric and rms(a - b) for a gradient leaf:
  (a) d(port bf16, JAX bf16) <= 1.5 * max(d(JAX bf16, JAX f32),
                                          d(port bf16, port f32))
      per metric (floored at 1e-3 of its value) and per gradient leaf of the
      generator: the two bf16 steps no further apart than the larger of the
      two packages' own bf16 errors;
  (b) d(port bf16, port f32) <= 2.0 * d(JAX bf16, JAX f32) per metric,
      floored at 1e-3 of its value for the 3D metrics and at 5e-3 for the 2D
      and adversarial ones (a prediction pixel whose hit flips in bf16 moves
      them: ROADMAP.md Queue C), and for the gradients over all leaves at once,
      each leaf scaled by its float32 rms (a leaf of rounding noise in float32,
      decoder_3e's bias, left out), with (a) over all leaves too.
The rule as the generator's forward states it (1.5x / 2x per output, leaf by
leaf, on JAX's spread alone) does not hold for one step's scalars and leaves:
a single sample of bf16 noise on the JAX side can be small by chance. On
three seeds the JAX package's own bf16 step moved loss_depth by up to 34 %
against its float32 step; per leaf the port's bf16 gradient was up to 11.9x
the JAX spread on geo_3a's BatchNorm bias while the port's own spread there
was 11.6x; over all leaves the port was 0.98-1.08x JAX's spread from JAX's
bf16 step and 0.11-0.51x from its own float32 step (this file's seed:
0.99x and 0.11x). Two JAX steps compile here: the bf16 step and the float32
step, its yardstick."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.training import StepFlags as JaxStepFlags
from spsg_tpu.training import TrainConfig as JaxTrainConfig
from spsg_tpu.training.step import Trainer as JaxTrainer
from spsg_tpu_torch.models.convert import generator_grads_to_flax
from spsg_tpu_torch.training import StepFlags, TrainConfig
from spsg_tpu_torch.training.step import Trainer

import test_torch_train_step_2d as T2

BF16 = dict(compute_dtype="bfloat16")


def _rms(a, b):
    return float(np.sqrt(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)))


def _port_twin(port, **cfg_kw):
    """A port trainer of another compute type with ``port``'s weights and
    spectral state."""
    twin = Trainer(TrainConfig(**{**T2.TINY, **cfg_kw}), device="cpu")
    twin.generator.load_state_dict(port.generator.state_dict(), strict=True)
    twin.discriminator.load_state_dict(port.discriminator.state_dict(), strict=True)
    twin.sn_state = {k: {kk: vv.clone() for kk, vv in v.items()} for k, v in port.sn_state.items()}
    return twin


@pytest.fixture(scope="module")
def steps():
    """One step of four trainers from the same weights on the same batch:
    {("jax" | "port", "bf16" | "f32"): (metrics, generator gradients by flax
    path)}, and the port's bf16 trainer after its step."""
    jt, gs, ds, port_bf = T2._pair(**BF16)
    jt32 = JaxTrainer(JaxTrainConfig(**T2.TINY))
    jt32.gen_tx, jt32.disc_tx = T2._recording(jt32.gen_tx), T2._recording(jt32.disc_tx)
    # copies: the float32 step donates its state, as tests/test_torch_train_step_2d.py's
    # default case does, so that the two share one compiled step
    gs32, ds32 = jax.tree_util.tree_map(jnp.copy, (
        gs.replace(opt_state=jt32.gen_tx.init(gs.params)),
        ds.replace(opt_state=jt32.disc_tx.init(ds.params))))
    port32 = _port_twin(port_bf)
    batch = T2._numpy_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    rng = jax.random.PRNGKey(1)
    alpha = T2._jax_alpha(rng)
    out = {}
    for key, trainer, state, donate in (("bf16", jt, (gs, ds), False),
                                        ("f32", jt32, (gs32, ds32), True)):
        g1, _, jm = trainer.step(*state, jbatch, rng, JaxStepFlags(**T2.FULL), donate=donate)
        out["jax", key] = ({k: float(v) for k, v in jm.items()},
                           T2._flat(T2.H.to_numpy_tree(g1.opt_state[0])))
    before = {k: v.clone() for k, v in port_bf.generator.state_dict().items()}
    for key, trainer in (("bf16", port_bf), ("f32", port32)):
        m = trainer.step(batch, StepFlags(**T2.FULL), gp_alpha=alpha)
        out["port", key] = ({k: float(v) for k, v in m.items()},
                            T2._flat(generator_grads_to_flax(trainer.generator)))
    return out, port_bf, before


METRICS_3D = ("loss_occ", "iou_occ", "loss_sdf", "loss_semantic")


def test_bf16_step_metrics_follow_the_rms_rule(steps):
    out, _, _ = steps
    jbf, j32 = out["jax", "bf16"][0], out["jax", "f32"][0]
    pbf, p32 = out["port", "bf16"][0], out["port", "f32"][0]
    assert set(pbf) == set(jbf) == set(p32)
    for k in jbf:
        assert np.isfinite(pbf[k]), k
        d_jax, d_port = abs(jbf[k] - j32[k]), abs(pbf[k] - p32[k])
        bound_a = max(1.5 * max(d_jax, d_port), 1e-3 * abs(jbf[k]))
        bound_b = max(2.0 * d_jax, (1e-3 if k in METRICS_3D else 5e-3) * abs(jbf[k]))
        assert abs(pbf[k] - jbf[k]) <= bound_a, (k, pbf[k], jbf[k], j32[k], p32[k])
        assert d_port <= bound_b, (k, pbf[k], p32[k], jbf[k], j32[k])


def test_bf16_step_gradients_follow_the_rms_rule(steps):
    out, _, _ = steps
    jbf, j32 = out["jax", "bf16"][1], out["jax", "f32"][1]
    pbf, p32 = out["port", "bf16"][1], out["port", "f32"][1]
    assert pbf.keys() == jbf.keys() == p32.keys()
    scale = {k: _rms(j32[k], 0.0) for k in j32}
    leaves = [k for k in j32 if scale[k] > 1e-6 * max(scale.values())]
    assert len(leaves) >= len(j32) - 1
    for k in jbf:
        assert np.isfinite(pbf[k]).all(), k
    rel = np.array([[_rms(pbf[k], jbf[k]), _rms(pbf[k], p32[k]), _rms(jbf[k], j32[k])]
                    for k in leaves]) / np.array([[scale[k]] for k in leaves])
    for (d_pj, d_port, d_jax), k in zip(rel, leaves):
        assert d_pj <= 1.5 * max(d_jax, d_port), (k, d_pj, d_port, d_jax)
    agg = np.sqrt(np.mean(rel ** 2, axis=0))
    assert agg[0] <= 1.5 * agg[2] and agg[1] <= 2.0 * agg[2], agg


def test_bf16_step_keeps_parameters_and_adam_in_float32(steps):
    """After the step: parameters, gradients, Adam moments float32 and
    finite; one Adam step moved each parameter by at most 2 lr (Queue C's
    Adam rule) and the blocks still compute in bf16."""
    _, port_bf, before = steps
    lr = port_bf.cfg.lr
    for name, p in port_bf.generator.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, name
        assert torch.isfinite(p).all() and torch.isfinite(p.grad).all(), name
        assert (p - before[name]).abs().max().item() <= 2 * lr + 1e-7, name
    moments = [v for s in port_bf.optimizer.state.values() for k, v in s.items()
               if k in ("exp_avg", "exp_avg_sq")]
    assert moments and all(m.dtype == torch.float32 and torch.isfinite(m).all() for m in moments)
    assert all(p.dtype == torch.float32 for p in port_bf.discriminator.parameters())
    assert port_bf.generator.cfg.dtype == "bfloat16" and port_bf.iteration == 1
