"""The port's 3D-loss train step (spsg_tpu_torch/training/step.py) against the
JAX package's Trainer on the CPU: (2,16,16,16) synthetic chunks, nf 4, the same
numpy batch and the same initial weights (carried across by the weight bridge).

On the CPU the port's convs run the autograd Functions of ops/conv3x3.py with
the kernels' plain versions inside, i.e. the same hand-derived backward that
launches the CUDA kernels on a card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.data import synthetic as jax_synthetic
from spsg_tpu.training import StepFlags as JaxStepFlags
from spsg_tpu.training import TrainConfig as JaxTrainConfig
from spsg_tpu.training.state import init_states
from spsg_tpu.training.step import Trainer as JaxTrainer
from spsg_tpu_torch.data import synthetic
from spsg_tpu_torch.models.convert import (
    flax_to_torch_generator, generator_grads_to_flax, torch_to_flax_generator)
from spsg_tpu_torch.training import StepFlags, TrainConfig
from spsg_tpu_torch.training.step import Trainer

import torch_port_helpers as H

DIMS = (16, 16, 16)
# tests/test_train_step.py::_tiny_cfg(weight_disc_loss=0, weight_depth_loss=0)
TINY = dict(input_dim=DIMS, nf_gen=4, nf_disc=4, batch_size=2, style_width=48, style_height=32,
            patch_size=16, num_iters_geo_only=2, max_depth_fill_iters=8, min_num_valid_2d=10,
            weight_disc_loss=0.0, weight_depth_loss=0.0)
FLAGS = {
    "geo": dict(pred_sdf=True, pred_color=False, pred_semantic=False),
    "full3d": dict(pred_sdf=True, pred_color=True, pred_semantic=True),
}


def _numpy_batch():
    batch = synthetic.make_chunk_batch(batch_size=2, dims=DIMS, seed=1)
    batch.pop("name")
    batch["weight_occ"] = np.float32(1.0)
    return batch


def _pair(**cfg_kw):
    """(jax trainer, its initial GenState, port trainer with the same weights)."""
    jcfg = JaxTrainConfig(**{**TINY, **cfg_kw})
    gs, ds = init_states(jcfg, jax.random.PRNGKey(0))
    assert ds is None
    cfg_kw.pop("fused_conv", None)  # the port has one conv path; the flag is the JAX side's
    trainer = Trainer(TrainConfig(**{**TINY, **cfg_kw}), device="cpu")
    variables = H.to_numpy_tree({"params": gs.params, "batch_stats": gs.batch_stats})
    trainer.generator.load_state_dict(flax_to_torch_generator(variables), strict=True)
    return JaxTrainer(jcfg), gs, trainer


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(a)
            for k, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_metrics(got, ref, rtol=1e-5):
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dim() == 0
        # float32 reductions over 8192 voxels in another order
        np.testing.assert_allclose(float(got[k].detach()), float(ref[k]), rtol=rtol, atol=1e-6, err_msg=k)


def test_synthetic_chunk_batch_is_the_jax_packages():
    ref = jax_synthetic.make_chunk_batch(batch_size=2, dims=DIMS, image_dims=(48, 32), seed=1)
    got = synthetic.make_chunk_batch(batch_size=2, dims=DIMS, image_dims=(48, 32), seed=1)
    assert set(got) == set(ref) and got["name"] == ref["name"]
    for k in ref:
        if k != "name":
            assert got[k].dtype == ref[k].dtype and np.array_equal(got[k], ref[k]), k
    # frames are rendered by the port's raycaster (tests/test_torch_raycast.py)
    framed = synthetic.make_chunk_batch(batch_size=1, dims=DIMS, image_dims=(48, 32),
                                        with_frames=True, device="cpu")
    assert framed["images_depth"].shape == (1, 32, 48)
    assert framed["images_color"].shape == (1, 3, 32, 48)


def _float64(tree):
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float64) if np.asarray(a).dtype == np.float32 else jnp.asarray(a),
        tree)


@pytest.mark.parametrize("flags", ["geo", "full3d"])
def test_losses_and_parameter_gradients_match_jax_grad(flags):
    jt, gs, trainer = _pair()
    batch = _numpy_batch()
    jflags = JaxStepFlags(**FLAGS[flags])

    def loss_fn(params, batch_stats, jbatch):
        (loss, _), aux = jt._forward_losses(params, batch_stats, jbatch, jflags)
        return loss, aux["metrics"]

    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, jmetrics), jgrads = grad_fn(gs.params, gs.batch_stats, jbatch)
    # the same function of the JAX package in float64: what both float32
    # gradients are rounded versions of
    with jax.enable_x64(True):
        _, jgrads64 = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            _float64(H.to_numpy_tree(gs.params)), _float64(H.to_numpy_tree(gs.batch_stats)),
            _float64(batch))
        jgrads64 = H.to_numpy_tree(jgrads64)

    trainer.generator.train()
    loss, metrics, _ = trainer._forward_losses(trainer._to_device(batch),
                                               StepFlags(**FLAGS[flags]))
    loss.backward()
    _assert_metrics({**metrics, "loss": loss.detach()}, {**jmetrics, "loss": jloss})
    want = {"loss_occ", "iou_occ", "loss_sdf"} | ({"loss_semantic"} if flags == "full3d" else set())
    assert set(metrics) == want

    got, ref, ref64 = (_flat(generator_grads_to_flax(trainer.generator)), _flat(jgrads),
                       _flat(jgrads64))
    assert got.keys() == ref.keys() == ref64.keys()
    reached = 0
    for k in ref:
        # 1e-4 of the leaf's largest entry (float32 sums over 8192 voxels in
        # another order), plus 2e-7: leaves whose entries are below 1e-3 are
        # sums that cancel, and carry that much rounding in either package.
        # Against jax.grad in float32 also what jax.grad itself is off by.
        scale = np.abs(ref64[k]).max()
        atol = 1e-4 * scale + 2e-7
        np.testing.assert_allclose(got[k], ref64[k], rtol=0, atol=atol, err_msg=k)
        own = np.abs(ref[k] - ref64[k]).max()
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=atol + 2 * own, err_msg=k)
        reached += scale > 1e-7
    # the loss reaches the geometry branch only, or everything but the colour
    # head; a conv bias that feeds nothing but train-mode BatchNorm has none
    assert reached == {"geo": 52, "full3d": 121}[flags], reached
    if flags == "full3d":
        assert trainer.generator.color_head_c.weight.grad is None
        assert np.abs(ref["['color_head_c']['Conv_0']['kernel']"]).max() == 0


# decoder_3e is a bare conv whose output feeds only the two train-mode head
# BatchNorms, which remove any constant: in exact arithmetic its bias has no
# gradient, in float32 it has rounding noise (1e-8 and below, of either sign),
# and Adam's first update is lr * g / (|g| + eps). The two packages therefore
# part there by up to lr, and the layers around it follow at a tenth of that.
NOISE_DRIVEN = "['decoder_3e']['Conv_0']['bias']"


@pytest.mark.parametrize("flags,jax_path,weight_decay", [
    ("geo", "xla", 0.0),
    ("geo", "pallas", 0.0),
    ("full3d", "xla", 0.0),
    # the colour head has no loss without 2D terms: JAX hands it zero gradients
    # and still decays it; Adam in PyTorch would skip a parameter without .grad
    ("full3d", "xla", 1e-2),
])
def test_three_adam_steps_match_the_jax_trainer(flags, jax_path, weight_decay):
    kw = dict(weight_decay=weight_decay)
    if jax_path == "pallas":
        kw["fused_conv"] = True  # Pallas kernels in interpret mode on the CPU
    jt, gs, trainer = _pair(**kw)
    lr = trainer.cfg.lr
    batch = _numpy_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    before = {k: v.clone() for k, v in trainer.generator.state_dict().items()}
    for i in range(3):
        gs, _, jmetrics = jt.step(gs, None, jbatch, jax.random.PRNGKey(i), JaxStepFlags(**FLAGS[flags]))
        metrics = trainer.step(batch, StepFlags(**FLAGS[flags]))
        _assert_metrics(metrics, jmetrics, rtol=1e-5 if (flags == "geo" or i == 0) else 5e-5)
        got = torch_to_flax_generator(trainer.generator.state_dict())
        diffs = []
        for part, ref in (("params", gs.params), ("batch_stats", gs.batch_stats)):
            a, b = _flat(got[part]), _flat(ref)
            assert a.keys() == b.keys()
            for k in b:
                d = np.abs(a[k] - b[k])
                diffs.append(d.ravel())
                if flags == "geo" or (i == 0 and k != NOISE_DRIVEN):
                    assert d.max() <= 1e-5, (part, k, i, d.max())
                else:
                    # no further apart than the Adam steps both sides have taken
                    # (each at most lr); measured 1.6e-4 after the third step
                    assert d.max() <= 2 * lr * (i + 1), (part, k, i, d.max())
        diffs = np.concatenate(diffs)
        # measured: 99.1 % within 1e-5 and 99.99 % within 1e-4 after the third step
        assert (diffs <= 1e-5).mean() >= 0.95 and (diffs <= 1e-4).mean() >= 0.995
    assert trainer.iteration == 3 and int(gs.step) == 3

    after = trainer.generator.state_dict()
    assert not torch.equal(after["geo_0a.weight"], before["geo_0a.weight"])
    assert not torch.equal(after["geo_0c.bn.running_mean"], before["geo_0c.bn.running_mean"])
    head = "color_head_c.weight"
    if weight_decay > 0:
        # three decayed Adam steps on a zero gradient: g = wd * w, each update -lr * sign(w)
        moved = (after[head] - before[head]).abs().max().item()
        assert 2.5 * lr < moved <= 3.01 * lr
    else:
        assert torch.equal(after[head], before[head])


def test_validation_pass_changes_nothing_and_matches_jax():
    jt, gs, trainer = _pair()
    batch = _numpy_batch()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    before = {k: v.clone() for k, v in trainer.generator.state_dict().items()}
    metrics = trainer.step(batch, StepFlags(train=False, **FLAGS["geo"]))
    new_gs, _, jmetrics = jt.step(gs, None, jbatch, jax.random.PRNGKey(0),
                                  JaxStepFlags(train=False, **FLAGS["geo"]))
    _assert_metrics(metrics, jmetrics)
    assert trainer.iteration == 0 and int(new_gs.step) == 0
    assert not trainer.generator.training
    after = trainer.generator.state_dict()
    assert all(torch.equal(after[k], before[k]) for k in before)
    assert all(p.grad is None for p in trainer.generator.parameters())
    assert not trainer.optimizer.state


def test_geo_overfit_loss_decreases():
    """The convergence smoke test of tests/test_train_step.py, on the port."""
    _, _, trainer = _pair(lr=1e-3)  # the JAX package's initial weights, as in its test
    batch = _numpy_batch()
    losses = [float(trainer.step(batch, StepFlags(pred_sdf=True))["loss"]) for _ in range(20)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5]) * 0.8


def test_colour_branch_is_skipped_when_not_asked_for():
    trainer = Trainer(TrainConfig(**TINY), device="cpu")
    ran = []
    for name in ("encoder_0a", "decoder_3a", "color_head_a", "semantic_head_a", "geo_3a"):
        getattr(trainer.generator, name).register_forward_hook(lambda *a, n=name: ran.append(n))
    x, m = H.chunk_inputs()
    with torch.no_grad():
        out = trainer.generator(H.t(x), H.t(m), pred_color=False, pred_semantic=False)
    assert out[2] is None and out[3] is None and ran == ["geo_3a"]
    ran.clear()
    with torch.no_grad():
        out = trainer.generator(H.t(x), H.t(m), pred_color=False, pred_semantic=True)
    assert out[2] is None and out[3].shape == (2,) + DIMS + (14,)
    assert ran == ["geo_3a", "encoder_0a", "decoder_3a", "semantic_head_a"]


# what the step refuses, under the flags that reach it: style / content
# without a VGG extractor (Trainer(..., vgg=...)), under use_2d and on their own
UNPORTED = {
    "use_disc": (dict(weight_disc_loss=0.5), dict(use_2d=True, use_disc=True,
                                                  compute_style=True)),
    "compute_style": ({}, dict(compute_style=True)),
    "compute_content": ({}, dict(compute_content=True)),
}


@pytest.mark.parametrize("flag", list(UNPORTED))
def test_unported_flags_raise(flag):
    cfg_kw, flags = UNPORTED[flag]
    trainer = Trainer(TrainConfig(**{**TINY, **cfg_kw}), device="cpu")
    with pytest.raises(ValueError, match="VGG"):
        trainer.step(_numpy_batch(), StepFlags(**flags))
    assert trainer.iteration == 0


def test_trainer_runs_on_the_gpu_unless_asked_otherwise():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(TrainConfig(**TINY))
