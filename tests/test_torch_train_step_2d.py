"""The port's full training step (spsg_tpu_torch/training/step.py with
use_2d and use_disc: normals, three raycasts, the depth chain, the 2D
losses, the discriminator's update and the adversarial term) against the JAX
package's Trainer.step on the CPU: the tiny config of
tests/test_train_step.py::_tiny_cfg (16^3, nf 4, 48x32, patch 16, nf_disc
4), the same numpy batch (frames rendered by the JAX package) and the same
initial weights of both networks (carried across by the weight bridges):
metrics, both networks' gradients (the JAX optimizers keep them in their
state) and their parameters and spectral statistics after the step.

Five JAX steps are compiled here (the default flags, wgan_gp with percent
weights, two frames a chunk, the 2D semantic loss, the missing-colour
weights); the other tests check the port on its own."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from spsg_tpu.data import synthetic as jax_synthetic
from spsg_tpu.training import StepFlags as JaxStepFlags
from spsg_tpu.training import TrainConfig as JaxTrainConfig
from spsg_tpu.training.state import init_states
from spsg_tpu.training.step import Trainer as JaxTrainer
from spsg_tpu_torch.models.convert import (
    flax_to_torch_discriminator, flax_to_torch_generator, generator_grads_to_flax,
    torch_to_flax_discriminator, torch_to_flax_generator)
from spsg_tpu_torch.ops import raycast as raycast_ops
from spsg_tpu_torch.training import StepFlags, TrainConfig
from spsg_tpu_torch.training.step import Trainer

import torch_port_helpers as H

DIMS = (16, 16, 16)
# tests/test_train_step.py::_tiny_cfg
TINY = dict(input_dim=DIMS, nf_gen=4, nf_disc=4, batch_size=2, style_width=48, style_height=32,
            patch_size=16, num_iters_geo_only=2, max_depth_fill_iters=8, min_num_valid_2d=10)
FULL = dict(pred_sdf=True, pred_color=True, pred_semantic=True, use_2d=True, use_disc=True)


def _numpy_batch(frames=1, punch=False):
    batch = jax_synthetic.make_chunk_batch(2, DIMS, image_dims=(48, 32), seed=1,
                                           with_frames=True)
    batch.pop("name")
    batch["weight_occ"] = np.float32(1.0)
    if punch:
        # an 8^3 block of the input emptied: its target surface is what
        # weight_missing_color weights (~10 % of the pixels)
        batch["input"] = batch["input"].copy()
        batch["input"][:, 0:8, 8:16, 8:16, 0] = 3.0
    if frames > 1:
        for k in ("images_depth", "images_color", "images_view", "images_intrinsic"):
            batch[k] = np.stack([batch[k]] * frames, axis=1)
    return batch


def _recording(tx):
    """``tx`` behind a stage that passes the gradients on unchanged and keeps
    them as its state: the step's gradients, read back from the optimizer
    state it returns (``opt_state[0]``), with the same update as ``tx``."""
    keep = optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (grads, grads))
    return optax.chain(keep, tx)


def _pair(**cfg_kw):
    """(jax trainer whose optimizers keep the step's gradients, its initial
    GenState and DiscState, port trainer with the same weights and spectral
    state)."""
    jcfg = JaxTrainConfig(**{**TINY, **cfg_kw})
    gs, ds = init_states(jcfg, jax.random.PRNGKey(0))
    jt = JaxTrainer(jcfg)
    jt.gen_tx, jt.disc_tx = _recording(jt.gen_tx), _recording(jt.disc_tx)
    gs = gs.replace(opt_state=jt.gen_tx.init(gs.params))
    ds = ds.replace(opt_state=jt.disc_tx.init(ds.params))
    trainer = Trainer(TrainConfig(**{**TINY, **cfg_kw}), device="cpu")
    trainer.generator.load_state_dict(flax_to_torch_generator(H.to_numpy_tree(
        {"params": gs.params, "batch_stats": gs.batch_stats})), strict=True)
    sd, sn = flax_to_torch_discriminator(H.to_numpy_tree(ds.params),
                                         H.to_numpy_tree(ds.spectral_stats))
    trainer.discriminator.load_state_dict(sd, strict=True)
    trainer.sn_state = sn
    return jt, gs, ds, trainer


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(a)
            for k, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_alpha(rng):
    """The gradient penalty's draw inside the JAX step (step.py:863, gan.py:86)."""
    _, gp_rng = jax.random.split(rng)
    return np.array(jax.random.uniform(gp_rng, (2, 1, 1, 1)))


# decoder_3e's bias feeds only train-mode BatchNorms: its gradient is rounding
# noise in both packages, and Adam's first update turns it into +-lr
# (tests/test_torch_train_step.py)
NOISE_DRIVEN = "['decoder_3e']['Conv_0']['bias']"


def _assert_same_after_step(jt_out, trainer, metrics, lr):
    g1, d1, jm = jt_out
    assert set(metrics) == set(jm)
    for k in jm:
        assert metrics[k].dim() == 0
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    got = torch_to_flax_generator(trainer.generator.state_dict())
    diffs = []
    for part, ref in (("params", g1.params), ("batch_stats", g1.batch_stats)):
        a, b = _flat(got[part]), _flat(H.to_numpy_tree(ref))
        assert a.keys() == b.keys()
        for k in b:
            d = np.abs(a[k] - b[k])
            diffs.append(d.ravel())
            # no further apart than the one Adam step each side took (each at most
            # lr): an element whose gradient is rounding noise (Queue C) moves by
            # up to lr in either direction
            assert d.max() <= 2 * lr, (part, k, d.max())
    diffs = np.concatenate(diffs)
    # measured: all but one element within 1e-5 besides decoder_3e's bias
    assert (diffs <= 1e-5).mean() >= 0.999 and (diffs <= 1e-4).mean() >= 0.9995
    for p in trainer.generator.parameters():
        assert torch.isfinite(p).all()
    dp, dstats = torch_to_flax_discriminator(trainer.discriminator.state_dict(), trainer.sn_state)
    a, b = _flat(dp), _flat(H.to_numpy_tree(d1.params))
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=1e-6, err_msg=k)
        assert np.isfinite(a[k]).all()
    a, b = _flat(dstats), _flat(H.to_numpy_tree(d1.spectral_stats))
    assert a.keys() == b.keys()
    for k in b:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6, err_msg=k)


def _assert_same_gradients(jt_out, trainer):
    """The step's gradients against the JAX step's, read back from its
    optimizer state (``_recording``): the generator's of the whole loss, the
    2D and adversarial terms included (the adversarial term reaches a leaf at
    up to 2.5e-3 of its largest entry, so a detached render shows), and the
    discriminator's of its own loss. Both sides are float32 sums over the
    batch's voxels and pixels in other orders: each leaf within 5e-4 of its
    largest entry plus 2e-7, for sums that cancel (measured: 2.2e-4 at most,
    the median 9e-6; decoder_3e's bias is rounding noise on both sides);
    the discriminator's within 1e-4 (measured: 7e-6)."""
    g1, d1, _ = jt_out
    got = _flat(generator_grads_to_flax(trainer.generator))
    ref = _flat(H.to_numpy_tree(g1.opt_state[0]))
    assert got.keys() == ref.keys()
    for k in ref:
        atol = 5e-4 * np.abs(ref[k]).max() + 2e-7
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=atol, err_msg=k)
    grads = {n: p.grad for n, p in trainer.discriminator.named_parameters()}
    got = _flat(torch_to_flax_discriminator(grads)[0])
    ref = _flat(H.to_numpy_tree(d1.opt_state[0]))
    assert got.keys() == ref.keys()
    for k in ref:
        scale = np.abs(ref[k]).max()
        assert scale > 0, k  # the gate is open: the discriminator has a loss
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-4 * scale, err_msg=k)


CASES = {
    "default": {},
    "wgan_gp_percent_pixels": dict(disc_loss_type="wgan_gp", weight_by_percent_pixels=True),
    "two_frames": {},
    # the semantic loss on the rendered labels instead of the voxels
    "semantic_2d": dict(pred_3d_semantic=False),
    # colour L1 and discriminator patches weighted where the input misses the
    # target (two occupancy raycasts, raycast_occ)
    "missing_colour": dict(weight_missing_color=2.0),
}


@pytest.mark.parametrize("case", list(CASES))
def test_full_step_matches_the_jax_trainer(case):
    kw = CASES[case]
    jt, gs, ds, trainer = _pair(**kw)
    batch = _numpy_batch(frames=2 if case == "two_frames" else 1,
                         punch=case == "missing_colour")
    rng = jax.random.PRNGKey(1)
    out = jt.step(gs, ds, {k: jnp.asarray(v) for k, v in batch.items()}, rng,
                  JaxStepFlags(**FULL))
    raycast_ops.reset_launch_counts()
    metrics = trainer.step(batch, StepFlags(**FULL), gp_alpha=_jax_alpha(rng))
    want = {"loss", "loss_occ", "iou_occ", "loss_sdf", "loss_semantic", "loss_depth",
            "loss_color", "loss_disc", "loss_disc_real", "loss_disc_fake", "loss_gen"}
    assert set(metrics) == want
    _assert_same_after_step(out, trainer, metrics, trainer.cfg.lr)
    _assert_same_gradients(out, trainer)
    assert trainer.iteration == 1
    # the CPU takes the plain versions: no kernel was launched
    assert not any(raycast_ops.launch_counts.values())


def _port_trainer(**kw):
    return Trainer(TrainConfig(**{**TINY, **kw}), device="cpu", seed=0)


def _snapshot(trainer):
    return ({k: v.clone() for k, v in trainer.generator.state_dict().items()},
            {k: v.clone() for k, v in trainer.discriminator.state_dict().items()},
            {k: {kk: vv.clone() for kk, vv in v.items()} for k, v in trainer.sn_state.items()})


def _same(a, b):
    return all(torch.equal(v, b[k]) for k, v in a.items())


def _sn_same(a, b):
    return all(torch.equal(v[kk], b[k][kk]) for k, v in a.items() for kk in v)


def test_validation_pass_changes_nothing():
    trainer = _port_trainer()
    batch = _numpy_batch()
    trainer.step(batch, StepFlags(**FULL))
    gen, disc, sn = _snapshot(trainer)
    opt_state = [v.clone() for s in trainer.disc_optimizer.state.values() for v in s.values()]
    metrics = trainer.step(batch, StepFlags(train=False, **FULL))
    assert {"loss_disc", "loss_gen", "loss_depth"} <= set(metrics)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    g2, d2, sn2 = _snapshot(trainer)
    assert _same(g2, gen) and _same(d2, disc) and _sn_same(sn2, sn)
    assert trainer.iteration == 1 and not trainer.generator.training
    after = [v for s in trainer.disc_optimizer.state.values() for v in s.values()]
    assert len(after) == len(opt_state) and all(map(torch.equal, after, opt_state))


def test_skip_batch_on_bad_depth():
    """An unfillable frame skips the whole batch: no generator or
    discriminator step, no running statistics, no iteration; clean depth with
    the same config does step."""
    trainer = _port_trainer(skip_batch_on_bad_depth=True)
    batch = _numpy_batch()
    bad = dict(batch, images_depth=batch["images_depth"].copy())
    bad["images_depth"][0] = 0.0
    gen, disc, _ = _snapshot(trainer)
    metrics = trainer.step(bad, StepFlags(**FULL))
    assert np.isfinite(float(metrics["loss"]))
    g1, d1, _ = _snapshot(trainer)
    assert _same(g1, gen) and _same(d1, disc) and trainer.iteration == 0
    assert not trainer.optimizer.state and not trainer.disc_optimizer.state
    trainer.step(batch, StepFlags(**FULL))
    g2, _, _ = _snapshot(trainer)
    assert trainer.iteration == 1 and not _same(g2, gen)


def test_closed_numvalid_gate_leaves_the_discriminator_but_moves_its_stats():
    """With too few valid rendered pixels the discriminator's parameters and
    Adam state stay, its spectral statistics move (both branches of the JAX
    package store them), and the generator still steps without the
    adversarial term."""
    trainer = _port_trainer(min_num_valid_2d=10 ** 9)
    batch = _numpy_batch()
    gen, disc, sn = _snapshot(trainer)
    metrics = trainer.step(batch, StepFlags(**FULL))
    g1, d1, sn1 = _snapshot(trainer)
    assert _same(d1, disc) and not trainer.disc_optimizer.state
    assert not _sn_same(sn1, sn)
    assert not _same(g1, gen) and trainer.iteration == 1
    assert np.isfinite(float(metrics["loss_gen"]))
    # the adversarial term is gated out of the loss
    total = sum(float(metrics[k]) * w for k, w in (
        ("loss_occ", 1.0), ("loss_sdf", 0.1), ("loss_semantic", 0.1), ("loss_depth", 1.0),
        ("loss_color", 1.0)))
    np.testing.assert_allclose(float(metrics["loss"]), total, rtol=1e-5)


@pytest.mark.parametrize("case", ["use_2d", "use_disc"])
def test_discriminator_update_comes_before_the_adversarial_loss(case, monkeypatch):
    """With use_disc and the gate open the discriminator steps once (its
    parameters move, its Adam state counts one step), after its two updating
    calls and before the adversarial call; with use_2d alone it is not
    called."""
    trainer = _port_trainer()
    batch = _numpy_batch()
    order = []
    real_step = trainer.disc_optimizer.step
    monkeypatch.setattr(trainer.disc_optimizer, "step",
                        lambda *a, **k: (order.append("disc_step"), real_step(*a, **k))[1])
    real_disc = trainer.discriminator.forward
    monkeypatch.setattr(trainer.discriminator, "forward",
                        lambda x, sn, update_sn_stats=False: (
                            order.append(("disc", update_sn_stats)),
                            real_disc(x, sn, update_sn_stats))[1])
    _, disc, _ = _snapshot(trainer)
    flags = StepFlags(**FULL) if case == "use_disc" else StepFlags(
        **dict(FULL, use_disc=False))
    trainer.step(batch, flags)
    _, d1, _ = _snapshot(trainer)
    if case == "use_disc":
        assert order == [("disc", True), ("disc", True), "disc_step", ("disc", False)]
        assert not _same(d1, disc)
        assert all(int(s["step"]) == 1 for s in trainer.disc_optimizer.state.values())
    else:
        assert order == [] and _same(d1, disc)


def test_trainer_runs_on_the_gpu_unless_asked_otherwise():
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(TrainConfig(**TINY))
