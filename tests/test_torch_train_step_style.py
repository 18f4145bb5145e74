"""The port's full training step with the VGG style / content losses
(spsg_tpu_torch/training/step.py, ``compute_style`` / ``compute_content``)
against the JAX package's Trainer.step on the CPU: the tiny config and
framed batch of tests/test_torch_train_step_2d.py, both weights 1, the same
initial weights of the generator, the discriminator and the VGG (the JAX
package's initialisation, carried across by the weight bridges).

Held: the metrics (``loss_style`` and ``loss_content`` among them) within
1e-4 relative; the parameters after one Adam step under ROADMAP.md Queue C's
Adam rule; the discriminator's gradients within 1e-4 of each leaf's largest
entry; and the style block's backward against the JAX package's on the same
render, within 1e-5 of the largest entry. The generator's gradients of the
whole step are held within 1e-2 of each leaf's largest entry, not 5e-4 as in
the step without style: the style / content gradient at the image jumps where
a 2x2 max-pool of the VGG holds a near-tie (the render's clipped RGB pixels
form flat regions), and the two packages' renders differ by float32 rounding.
Measured on the lab_holes render: 1e-7 of noise moves that gradient by 8 % of
its largest entry; the whole step's generator gradients differ by up to
4.6e-3 of a leaf's largest entry, 9.8e-4 at the median (ROADMAP.md Queue C).

Two JAX steps are compiled here: the default LAB colour space, whose render
has holes (the sanitise-before-LAB trap: every generator gradient must stay
finite), and ``weight_missing_color`` 2 (target pixels copied into the render
outside the missing regions). Style alone is checked on the port against the
first case."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.data import colorspace as jax_colorspace
from spsg_tpu.losses import style as jax_style
from spsg_tpu.losses import twod as jax_twod
from spsg_tpu.models import vgg as jax_vgg
from spsg_tpu.training import StepFlags as JaxStepFlags
from spsg_tpu.training import TrainConfig as JaxTrainConfig
from spsg_tpu.training.state import init_states
from spsg_tpu.training.step import Trainer as JaxTrainer
from spsg_tpu.training.step import _sanitize as jax_sanitize
from spsg_tpu_torch.models import vgg
from spsg_tpu_torch.models.convert import (
    flax_to_torch_discriminator, flax_to_torch_generator, generator_grads_to_flax,
    torch_to_flax_discriminator, torch_to_flax_generator, vgg_params_from_jax)
from spsg_tpu_torch.ops import raycast as raycast_ops
from spsg_tpu_torch.training import StepFlags, TrainConfig
from spsg_tpu_torch.training.step import Trainer

import test_torch_train_step_2d as S2
import torch_port_helpers as H

WEIGHTS = dict(weight_style_loss=1.0, weight_content_loss=1.0)
FLAGS = dict(S2.FULL, compute_style=True, compute_content=True)


def _vgg_params():
    """JAX-initialised VGG parameters (numpy), kernels scaled by 1.6 and
    biases drawn, so that the features stay O(1) through the eight layers and
    the style loss is far from rounding."""
    params = H.to_numpy_tree(jax_vgg.VGGFeatures().init(
        jax.random.PRNGKey(42), jnp.zeros((1, 64, 64, 3)))["params"])
    rng = np.random.default_rng(5)
    for p in params.values():
        p["kernel"] = p["kernel"] * np.float32(1.6)
        p["bias"] = rng.normal(0, 0.05, p["bias"].shape).astype(np.float32)
    return params


def _port_vgg(params):
    model = vgg.VGGFeatures()
    model.load_state_dict(vgg_params_from_jax(params), strict=True)
    return model


def _pair(**cfg_kw):
    """As test_torch_train_step_2d.py::_pair, with the same VGG on both
    sides: (jax trainer whose optimizers keep the step's gradients, its
    GenState and DiscState, port trainer)."""
    vp = _vgg_params()
    jcfg = JaxTrainConfig(**{**S2.TINY, **WEIGHTS, **cfg_kw})
    gs, ds = init_states(jcfg, jax.random.PRNGKey(0))
    jt = JaxTrainer(jcfg, vgg=(jax_vgg.VGGFeatures(), jax.tree_util.tree_map(jnp.asarray, vp)))
    jt.gen_tx, jt.disc_tx = S2._recording(jt.gen_tx), S2._recording(jt.disc_tx)
    gs = gs.replace(opt_state=jt.gen_tx.init(gs.params))
    ds = ds.replace(opt_state=jt.disc_tx.init(ds.params))
    trainer = _port_trainer(gs, ds, vp, **cfg_kw)
    return jt, gs, ds, trainer


def _port_trainer(gs, ds, vp, **cfg_kw):
    trainer = Trainer(TrainConfig(**{**S2.TINY, **WEIGHTS, **cfg_kw}), device="cpu",
                      vgg=_port_vgg(vp))
    trainer.generator.load_state_dict(flax_to_torch_generator(H.to_numpy_tree(
        {"params": gs.params, "batch_stats": gs.batch_stats})), strict=True)
    sd, sn = flax_to_torch_discriminator(H.to_numpy_tree(ds.params),
                                         H.to_numpy_tree(ds.spectral_stats))
    trainer.discriminator.load_state_dict(sd, strict=True)
    trainer.sn_state = sn
    return trainer


def _recording_style(trainer):
    """Record what the step hands its style block: (render, target frames,
    missing2d), detached."""
    seen = {}
    real = trainer._style_content

    def style_content(render, images, missing2d, flags):
        seen.update(render=render.detach().clone(), images=images.detach().clone(),
                    missing2d=None if missing2d is None else missing2d.clone())
        return real(render, images, missing2d, flags)

    trainer._style_content = style_content
    return seen


CASES = {
    # the default LAB colour space; the render has holes
    "lab_holes": {},
    # style and content restricted to the regions the input misses
    "missing_colour": dict(weight_missing_color=2.0),
}


@pytest.fixture(scope="module")
def lab_case():
    """The default case, stepped on both sides once for the tests below."""
    return _stepped("lab_holes")


def _stepped(case):
    jt, gs, ds, trainer = _pair(**CASES[case])
    gs0, ds0 = jax.tree_util.tree_map(np.array, (gs, ds))
    batch = S2._numpy_batch(punch=case == "missing_colour")
    rng = jax.random.PRNGKey(1)
    out = jt.step(gs, ds, {k: jnp.asarray(v) for k, v in batch.items()}, rng,
                  JaxStepFlags(**FLAGS))
    raycast_ops.reset_launch_counts()
    seen = _recording_style(trainer)
    metrics = trainer.step(batch, StepFlags(**FLAGS))
    del trainer._style_content
    return dict(out=out, trainer=trainer, metrics=metrics, seen=seen, batch=batch,
                initial=(gs0, ds0))


@pytest.fixture(scope="module")
def missing_case():
    return _stepped("missing_colour")


def _case(case, request):
    return request.getfixturevalue("lab_case" if case == "lab_holes" else "missing_case")


def _assert_same_after_step(jt_out, trainer, metrics, lr):
    """Metrics within 1e-4 relative; Queue C's Adam rule on the parameters
    (each element within 2 lr, one Adam step either side, plus the rounding
    of the parameter's value; >= 99.9 % within 1e-5); the discriminator's
    parameters within 1e-6 and its spectral statistics within 1e-5."""
    g1, d1, jm = jt_out
    assert set(metrics) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-4, atol=1e-7,
                                   err_msg=k)
    got = torch_to_flax_generator(trainer.generator.state_dict())
    diffs = []
    for part, ref in (("params", g1.params), ("batch_stats", g1.batch_stats)):
        a, b = S2._flat(got[part]), S2._flat(H.to_numpy_tree(ref))
        assert a.keys() == b.keys()
        for k in b:
            d = np.abs(a[k] - b[k])
            diffs.append(d.ravel())
            assert (d <= 2 * lr + 1e-7 * np.maximum(np.abs(b[k]), 1.0)).all(), (part, k, d.max())
    diffs = np.concatenate(diffs)
    assert (diffs <= 1e-5).mean() >= 0.999, (diffs <= 1e-5).mean()
    dp, dstats = torch_to_flax_discriminator(trainer.discriminator.state_dict(), trainer.sn_state)
    for mine, ref, tol in ((dp, d1.params, 1e-6), (dstats, d1.spectral_stats, 1e-5)):
        a, b = S2._flat(mine), S2._flat(H.to_numpy_tree(ref))
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=tol, atol=tol, err_msg=k)


def _assert_same_gradients(jt_out, trainer):
    """The generator's gradients within 1e-2 of each leaf's largest entry
    (the module docstring says why not 5e-4), the discriminator's within 1e-4
    (the style block does not reach it)."""
    g1, d1, _ = jt_out
    got = S2._flat(generator_grads_to_flax(trainer.generator))
    ref = S2._flat(H.to_numpy_tree(g1.opt_state[0]))
    assert got.keys() == ref.keys()
    for k in ref:
        if k == S2.NOISE_DRIVEN:
            # its gradient is 0 but for rounding on both sides (it feeds only
            # train-mode BatchNorms; Queue C)
            assert max(np.abs(got[k]).max(), np.abs(ref[k]).max()) <= 1e-6, k
            continue
        atol = 1e-2 * np.abs(ref[k]).max() + 2e-7
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=atol, err_msg=k)
    grads = {n: p.grad for n, p in trainer.discriminator.named_parameters()}
    got = S2._flat(torch_to_flax_discriminator(grads)[0])
    ref = S2._flat(H.to_numpy_tree(d1.opt_state[0]))
    for k in ref:
        scale = np.abs(ref[k]).max()
        assert scale > 0, k  # the gate is open: the discriminator has a loss
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=1e-4 * scale, err_msg=k)


@pytest.mark.parametrize("case", list(CASES))
def test_style_step_matches_the_jax_trainer(case, request):
    r = _case(case, request)
    trainer, metrics = r["trainer"], r["metrics"]
    want = {"loss", "loss_occ", "iou_occ", "loss_sdf", "loss_semantic", "loss_depth",
            "loss_color", "loss_disc", "loss_disc_real", "loss_disc_fake", "loss_gen",
            "loss_style", "loss_content"}
    assert set(metrics) == want
    assert float(metrics["loss_style"]) > 1e-3 and float(metrics["loss_content"]) > 1e-3
    # the render has holes: the LAB conversion must not turn them into NaN
    # gradients (the JAX package's _sanitize before lab01_to_rgb)
    assert torch.isinf(r["seen"]["render"]).any()
    assert all(torch.isfinite(p.grad).all() for p in trainer.generator.parameters())
    _assert_same_after_step(r["out"], trainer, metrics, trainer.cfg.lr)
    _assert_same_gradients(r["out"], trainer)
    assert trainer.iteration == 1
    assert not any(raycast_ops.launch_counts.values())  # the CPU: plain versions
    # the VGG is frozen and outside the optimizer
    assert not any(p.requires_grad for p in trainer.vgg.parameters())
    assert not {id(p) for p in trainer.vgg.parameters()} & {
        id(p) for g in trainer.optimizer.param_groups for p in g["params"]}
    if case == "missing_colour":
        m = r["seen"]["missing2d"]
        assert m is not None and 0 < int((m != 0).sum()) < m.numel()


def _jax_style_block(render, images, missing2d, vgg_params):
    """The JAX package's style / content block (spsg_tpu/training/step.py:
    712-749, LAB colour space) as a function of the render: (style + content,
    (style, content)). ``missing2d`` all true stands for the block without
    the missing-colour copy (the select then passes the render through), so
    that both cases share one compile."""
    invalid = render == -jnp.inf
    pred = jnp.where(invalid, -jnp.inf, jax_colorspace.lab01_to_rgb(jax_sanitize(render)))
    tgt = jax_colorspace.lab01_to_rgb(images)
    pred, tgt = jax_twod.preprocess_rendered_target_images(pred, tgt)
    pred = jnp.where(missing2d[..., None], pred, tgt)
    model = jax_vgg.VGGFeatures()
    ls, lc = jax_style.style_content_loss(model.apply({"params": vgg_params}, pred),
                                          model.apply({"params": vgg_params}, tgt), True, True)
    return ls + lc, (ls, lc)


_jax_style_block_grad = jax.jit(jax.value_and_grad(_jax_style_block, has_aux=True))


@pytest.mark.parametrize("case", list(CASES))
def test_style_block_backward_matches_jax_on_the_same_render(case, request):
    """The style block of the port's step (``Trainer._style_content``: LAB to
    RGB, the copy of target pixels, both VGG forwards, the losses) and its
    backward to the render, against the JAX package's block on the render the
    port's step produced: losses within 1e-5 relative (means of squared
    differences of features that agree within 1e-5 of their largest entry),
    the gradient within 1e-5 of its largest entry and finite (the render has
    -inf holes)."""
    r = _case(case, request)
    seen, trainer = r["seen"], r["trainer"]
    render = seen["render"].clone().requires_grad_(True)
    ls, lc = trainer._style_content(render, seen["images"], seen["missing2d"],
                                    StepFlags(**FLAGS))
    (ls + lc).backward()
    vp = jax.tree_util.tree_map(jnp.asarray, _vgg_params())
    missing2d = (np.ones(seen["render"].shape[:3], bool) if seen["missing2d"] is None
                 else seen["missing2d"].numpy() != 0)
    (_, (jls, jlc)), ref = _jax_style_block_grad(
        jnp.asarray(seen["render"].numpy()), jnp.asarray(seen["images"].numpy()),
        jnp.asarray(missing2d), vp)
    np.testing.assert_allclose(float(ls), float(jls), rtol=1e-5)
    np.testing.assert_allclose(float(lc), float(jlc), rtol=1e-5)
    ref = np.asarray(ref)
    got = render.grad.numpy()
    assert np.isfinite(got).all() and np.abs(ref).max() > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    assert (got[np.isinf(seen["render"].numpy())] == 0).all()


def test_style_alone_matches_the_full_case(lab_case):
    """compute_style without compute_content: the same style loss, no content
    metric, and the total short of exactly the content term (the gate is
    open: the discriminator stepped in the full case)."""
    gs0, ds0 = lab_case["initial"]
    trainer = _port_trainer(gs0, ds0, _vgg_params())
    full = lab_case["metrics"]
    metrics = trainer.step(lab_case["batch"], StepFlags(**dict(FLAGS, compute_content=False)))
    assert "loss_content" not in metrics and set(metrics) == set(full) - {"loss_content"}
    np.testing.assert_allclose(float(metrics["loss_style"]), float(full["loss_style"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(full["loss"]) - float(full["loss_content"]), rtol=1e-5)
    assert all(torch.isfinite(p.grad).all() for p in trainer.generator.parameters())


def test_trainer_with_a_vgg_runs_on_the_gpu_unless_asked_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(TrainConfig(**S2.TINY), vgg=vgg.VGGFeatures())
