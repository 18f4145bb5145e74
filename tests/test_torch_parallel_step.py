"""The port's data-parallel training step (Trainer(..., mesh=...)) on two gloo
ranks on the CPU (tests/torch_parallel_worker.py), each on its half of the
global batch, against the JAX package's single-device step on the global
batch and against the port's one-process step on it. The ranks run every
step of the file in one launch (the ``two_ranks`` fixture).

The configurations, batches and JAX steps are those of
tests/test_torch_train_step.py (3D losses) and tests/test_torch_train_step_2d.py
(the full 2D + GAN step), so that their compiled JAX steps come from
.jax_cache. ROADMAP.md Queue C's rule holds for the metrics, the
discriminator's gradients and the parameters after one Adam step. The
generator's gradients of a step with the colour branch are held within 1e-2
of the whole gradient's L2 norm and each leaf within 1e-1 of its largest
entry (measured: 2.6e-3 and 4.3e-2 on the full step): the global BatchNorm
sums of two ranks are the one-process sums added in another order, which
moves an activation by a rounding and flips a pre-activation within rounding
of 0 to the other LeakyReLU slope, and that voxel's share of a 16^3 loss moves
every gradient upstream of it (ROADMAP.md Queue C has the voxels). The
geometry-only step, which has no such voxel, holds the JAX rule of 5e-4 of
each leaf's largest entry and 1e-5 against the one-process step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.training import StepFlags as JaxStepFlags
from spsg_tpu_torch.models.convert import generator_grads_to_flax, torch_to_flax_generator
from spsg_tpu_torch.training import StepFlags, TrainConfig
from spsg_tpu_torch.training.step import Trainer

import test_torch_train_step as S3
import test_torch_train_step_2d as S2
import test_torch_train_step_style as ST
import torch_parallel_worker as W
import torch_port_helpers as H


def _arrays(trainer, batch):
    out = {f"gen/{k}": v.numpy() for k, v in trainer.generator.state_dict().items()}
    if trainer.vgg is not None:
        out.update({f"vgg/{k}": v.numpy() for k, v in trainer.vgg.state_dict().items()})
    if trainer.discriminator is not None:
        out.update({f"disc/{k}": v.numpy() for k, v in trainer.discriminator.state_dict().items()})
        out.update({f"sn/{c}.{k}": v.numpy() for c, s in trainer.sn_state.items()
                    for k, v in s.items()})
    out.update({f"batch/{k}": np.asarray(v) for k, v in batch.items()})
    return out


# the gate test's configuration: wgan_gp, so the penalty's draw is on the path
HOLES = dict(S2.TINY, disc_loss_type="wgan_gp", weight_by_percent_pixels=True,
             skip_batch_on_bad_depth=True)


def _holes_batch():
    """Rank 0's frame a depth map of holes that no fill reaches, rank 1's whole."""
    batch = S2._numpy_batch()
    batch["images_depth"] = batch["images_depth"].copy()
    batch["images_depth"][0] = 0.0
    return batch


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Every step of this file on two ranks, in one launch: for each run its
    port trainer before the step (a test steps it on the global batch in this
    process) with the JAX pair it came from, and rank 0's results. Asserts that
    both ranks end with the same metrics, parameters, buffers, gradients and
    spectral state."""
    pairs = {"geo": S3._pair(), "full3d": S3._pair(), "full": S2._pair(), "style": ST._pair(),
             "holes": (Trainer(TrainConfig(**HOLES), device="cpu"),)}
    pairs["full3d_remat"] = pairs["full3d"]  # the same weights, stepped with remat
    runs = {"geo": (S3._numpy_batch(), S3.TINY, S3.FLAGS["geo"]),
            "full3d": (S3._numpy_batch(), S3.TINY, S3.FLAGS["full3d"]),
            "full3d_remat": (S3._numpy_batch(), dict(S3.TINY, remat=True), S3.FLAGS["full3d"]),
            "full": (S2._numpy_batch(), S2.TINY, S2.FULL),
            "style": (S2._numpy_batch(), dict(S2.TINY, **ST.WEIGHTS), ST.FLAGS),
            "holes": (_holes_batch(), HOLES, S2.FULL)}
    arrays = {}
    for name, (batch, _, _) in runs.items():
        arrays.update({f"{name}/{k}": v for k, v in _arrays(pairs[name][-1], batch).items()})
    directory = tmp_path_factory.mktemp("steps")
    W.save_inputs(directory, arrays, runs={name: dict(cfg=cfg_kw, flags=flags)
                                           for name, (_, cfg_kw, flags) in runs.items()})
    r0, r1 = W.run_ranks("steps", directory)
    assert r0.keys() == r1.keys()
    for k in r0:
        assert np.array_equal(r0[k], r1[k]), k
    return {name: (pairs[name], W._sub(r0, name)) for name in runs}


def _loaded(cfg_kw, r):
    """A CPU trainer holding a rank's state after the step, its gradients in
    ``.grad`` and its metrics as 0-dim tensors."""
    t = Trainer(TrainConfig(**cfg_kw), device="cpu")
    t.generator.load_state_dict(W._tensors(W._sub(r, "gen")), strict=True)
    for n, p in t.generator.named_parameters():
        p.grad = torch.from_numpy(r[f"grad/{n}"])
    if t.discriminator is not None:
        t.discriminator.load_state_dict(W._tensors(W._sub(r, "disc")), strict=True)
        for n, p in t.discriminator.named_parameters():
            p.grad = torch.from_numpy(r[f"dgrad/{n}"])
        t.sn_state = W._sn_state(W._sub(r, "sn"))
    t.iteration = int(r["iteration"])
    return t, {k: torch.from_numpy(v) for k, v in W._sub(r, "metric").items()}


# the generator's gradient where a LeakyReLU slope flips (the header)
FLIP = dict(rel=1e-1, l2=1e-2)


def _grads_close(got_tree, ref_tree, rel, l2=None):
    """Each leaf within ``rel`` of its largest entry plus 2e-7 (decoder_3e's
    bias, rounding noise, within 1e-6 on both sides) and, with ``l2``, the
    whole difference within ``l2`` of the whole gradient's L2 norm."""
    got, ref = S3._flat(got_tree), S3._flat(ref_tree)
    assert got.keys() == ref.keys()
    num = den = 0.0
    for k in ref:
        if k == S2.NOISE_DRIVEN:
            # 0 but for rounding on both sides: it feeds only train-mode BatchNorms
            # (Queue C, Adam on a zero gradient)
            assert max(np.abs(got[k]).max(), np.abs(ref[k]).max()) <= 1e-6, k
            continue
        scale = np.abs(ref[k]).max()
        np.testing.assert_allclose(got[k], ref[k], rtol=0, atol=rel * scale + 2e-7, err_msg=k)
        num += float(((got[k].astype(np.float64) - ref[k]) ** 2).sum())
        den += float((ref[k].astype(np.float64) ** 2).sum())
    if l2 is not None:
        assert np.sqrt(num / den) <= l2, np.sqrt(num / den)


def _params_close(got_sd, ref_sd, atol, share_1e5):
    a = torch_to_flax_generator(got_sd)
    b = torch_to_flax_generator(ref_sd)
    diffs = []
    for part in ("params", "batch_stats"):
        fa, fb = S3._flat(a[part]), S3._flat(b[part])
        for k in fb:
            d = np.abs(fa[k] - fb[k])
            assert d.max() <= atol, (part, k, d.max())
            diffs.append(d.ravel())
    assert (np.concatenate(diffs) <= 1e-5).mean() >= share_1e5


@pytest.mark.parametrize("flags,grad_rule", [("geo", dict(rel=5e-4)), ("full3d", FLIP)])
def test_3d_step_on_two_ranks_matches_jax_and_one_process(two_ranks, flags, grad_rule):
    (jt, gs, trainer), r = two_ranks[flags]
    batch = S3._numpy_batch()
    jflags = JaxStepFlags(**S3.FLAGS[flags])
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss_fn(params, batch_stats, jb):
        (loss, _), aux = jt._forward_losses(params, batch_stats, jb, jflags)
        return loss, aux["metrics"]

    # the gradient as tests/test_torch_train_step.py takes it: the JAX
    # package's loss in float64, what every float32 gradient is a rounding of
    with jax.enable_x64(True):
        _, jgrads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
            S3._float64(H.to_numpy_tree(gs.params)),
            S3._float64(H.to_numpy_tree(gs.batch_stats)), S3._float64(batch))
        jgrads = H.to_numpy_tree(jgrads)
    gs1, _, jmetrics = jt.step(gs, None, jbatch, jax.random.PRNGKey(0), jflags)
    got, metrics = _loaded(S3.TINY, r)
    lr = trainer.cfg.lr

    # against the JAX package on the global batch (Queue C)
    S3._assert_metrics(metrics, jmetrics, rtol=1e-5)
    _grads_close(generator_grads_to_flax(got.generator), jgrads, **grad_rule)
    _params_close(got.generator.state_dict(),
                  flax_state(gs1), 1e-5 if flags == "geo" else 2 * lr, 0.999)

    # against the port's own step on the global batch, more tightly
    one = trainer.step(batch, StepFlags(**S3.FLAGS[flags]))
    for k in one:
        np.testing.assert_allclose(float(metrics[k]), float(one[k]), rtol=1e-6, atol=1e-8,
                                   err_msg=k)
    _grads_close(generator_grads_to_flax(got.generator),
                 generator_grads_to_flax(trainer.generator),
                 **(dict(rel=1e-5) if flags == "geo" else FLIP))
    _params_close(got.generator.state_dict(), trainer.generator.state_dict(),
                  1e-6 if flags == "geo" else 2 * lr, 0.9999)
    assert got.iteration == trainer.iteration == 1


def test_3d_step_with_remat_on_two_ranks_is_the_step_without_it(two_ranks):
    """TrainConfig.remat on two ranks: each rank recomputes its conv blocks in
    the backward, BatchNorm's all-reduce of the global sums with them, in the
    same order on both ranks. The metrics, the gradients and the state after
    the step (the running statistics moved once) equal the step without remat
    on the same weights and batch to the bit."""
    _, plain = two_ranks["full3d"]
    _, remat = two_ranks["full3d_remat"]
    assert plain.keys() == remat.keys()
    assert any(k.startswith("grad/") for k in plain)
    for k in plain:
        assert np.array_equal(plain[k], remat[k]), k


def flax_state(gs):
    from spsg_tpu_torch.models.convert import flax_to_torch_generator

    return {k: torch.as_tensor(v) for k, v in flax_to_torch_generator(H.to_numpy_tree(
        {"params": gs.params, "batch_stats": gs.batch_stats})).items()}


def test_full_step_on_two_ranks_matches_jax_and_one_process(two_ranks):
    """The default full step (2D losses, discriminator, adversarial term),
    one framed chunk a rank: metrics, both networks' parameters and the
    spectral state after the step by tests/test_torch_train_step_2d.py's rule,
    the discriminator's gradients within 1e-4 of a leaf's largest entry and
    the generator's by the flip rule of the header."""
    (jt, gs, ds, trainer), r = two_ranks["full"]
    batch = S2._numpy_batch()
    rng = jax.random.PRNGKey(1)
    out = jt.step(gs, ds, {k: jnp.asarray(v) for k, v in batch.items()}, rng,
                  JaxStepFlags(**S2.FULL))
    got, metrics = _loaded(S2.TINY, r)
    S2._assert_same_after_step(out, got, metrics, trainer.cfg.lr)
    g1, d1, _ = out
    _grads_close(generator_grads_to_flax(got.generator), g1.opt_state[0], **FLIP)
    dgrads = {n: p.grad for n, p in got.discriminator.named_parameters()}
    from spsg_tpu_torch.models.convert import torch_to_flax_discriminator

    _grads_close(torch_to_flax_discriminator(dgrads)[0], d1.opt_state[0], 1e-4)

    one = trainer.step(batch, StepFlags(**S2.FULL))
    for k in one:
        np.testing.assert_allclose(float(metrics[k]), float(one[k]), rtol=1e-6, atol=1e-8,
                                   err_msg=k)
    _grads_close(generator_grads_to_flax(got.generator),
                 generator_grads_to_flax(trainer.generator), **FLIP)
    for n, p in trainer.discriminator.named_parameters():
        np.testing.assert_allclose(got.discriminator.state_dict()[n].numpy(),
                                   p.detach().numpy(), rtol=0, atol=1e-6, err_msg=n)
    assert got.iteration == trainer.iteration == 1


def test_style_step_on_two_ranks_matches_jax_and_one_process(two_ranks):
    """The full step with the VGG style and content losses
    (tests/test_torch_train_step_style.py's LAB case, its JAX step from the
    cache): the Gram matrices of the global batch from the features every rank
    gathers, the content loss's global mean. Metrics and parameters as the
    full step's; the generator's gradients by the flip rule of the header,
    the discriminator's within 1e-4."""
    (jt, gs, ds, trainer), r = two_ranks["style"]
    batch = S2._numpy_batch()
    out = jt.step(gs, ds, {k: jnp.asarray(v) for k, v in batch.items()},
                  jax.random.PRNGKey(1), JaxStepFlags(**ST.FLAGS))
    got, metrics = _loaded(dict(S2.TINY, **ST.WEIGHTS), r)
    assert {"loss_style", "loss_content"} <= set(metrics)
    ST._assert_same_after_step(out, got, metrics, trainer.cfg.lr)
    g1, d1, _ = out
    _grads_close(generator_grads_to_flax(got.generator), g1.opt_state[0], **FLIP)

    one = trainer.step(batch, StepFlags(**ST.FLAGS))
    for k in one:
        np.testing.assert_allclose(float(metrics[k]), float(one[k]), rtol=1e-6, atol=1e-8,
                                   err_msg=k)
    _grads_close(generator_grads_to_flax(got.generator),
                 generator_grads_to_flax(trainer.generator), **FLIP)
    for n, p in trainer.discriminator.named_parameters():
        g = got.discriminator.get_parameter(n).grad.numpy()
        np.testing.assert_allclose(g, p.grad.numpy(), rtol=0,
                                   atol=1e-4 * np.abs(p.grad.numpy()).max() + 1e-9, err_msg=n)


def test_global_gate_closes_on_both_ranks_when_one_frame_has_holes(two_ranks):
    """Rank 0's frame is a depth map of holes that no fill reaches, rank 1's
    is whole: gate2d is 0 on both ranks (the 2D and adversarial terms off, the
    discriminator not stepped, skip_batch_on_bad_depth skipping the whole
    step on both), and the step equals the one-process step on the batch.
    wgan_gp: the gradient penalty's alpha is drawn for the global batch from
    the trainers' own generator, the same draw as one process's."""
    (trainer,), r = two_ranks["holes"]
    before = {k: v.clone() for k, v in trainer.generator.state_dict().items()}
    dbefore = {k: v.clone() for k, v in trainer.discriminator.state_dict().items()}
    got, metrics = _loaded(HOLES, r)
    one = trainer.step(_holes_batch(), StepFlags(**S2.FULL))
    assert set(metrics) == set(one)
    for k in one:
        np.testing.assert_allclose(float(metrics[k]), float(one[k]), rtol=1e-6, atol=1e-8,
                                   err_msg=k)
    # skipped on both: no optimizer step, no running statistics, no iteration
    assert got.iteration == trainer.iteration == 0
    for k, v in got.generator.state_dict().items():
        assert torch.equal(v, before[k]), k
    for k, v in got.discriminator.state_dict().items():
        assert torch.equal(v, dbefore[k]), k
    for n, p in trainer.discriminator.named_parameters():
        g = got.discriminator.get_parameter(n).grad.numpy()
        np.testing.assert_allclose(g, p.grad.numpy(), rtol=0,
                                   atol=1e-4 * np.abs(p.grad.numpy()).max() + 1e-9, err_msg=n)
