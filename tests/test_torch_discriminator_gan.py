"""The port's discriminator (spsg_tpu_torch/models/discriminator.py, with its
weight bridge in models/convert.py) and GAN losses (losses/gan.py) against
the JAX package's on the CPU: the layer-count rule, compute_valids, the four
loss types, the gradient penalty with a fed alpha, and the discriminator's
outputs and stored u / sigma through the update / no-update call sequence of
a train step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.losses import gan as JG
from spsg_tpu.models import discriminator as JDm
from spsg_tpu.training.config import TrainConfig as JaxTrainConfig
from spsg_tpu.training.state import init_states, make_discriminator as jax_make_discriminator
from spsg_tpu_torch.losses import gan as G
from spsg_tpu_torch.models import discriminator as Dm
from spsg_tpu_torch.models.convert import flax_to_torch_discriminator, torch_to_flax_discriminator
from spsg_tpu_torch.training import TrainConfig
from spsg_tpu_torch.training.state import disc_optimizer, init_discriminator, make_discriminator

import torch_port_helpers as H

TINY = dict(input_dim=(16, 16, 16), nf_gen=4, nf_disc=4, style_width=48, style_height=32,
            patch_size=16)


@pytest.mark.parametrize("patch_size,dims,patch", [
    (96, (256, 320), True), (16, (32, 48), True), (4, (256, 320), True),
    (500, (256, 320), True), (96, (256, 320), False), (96, (20, 40), True)])
def test_num_disc_layers_rule(patch_size, dims, patch):
    assert Dm.num_disc_layers(patch_size, dims, patch) == JDm.num_disc_layers(
        patch_size, dims, patch)


def test_compute_valids_matches_flax():
    rng = np.random.default_rng(0)
    valid = (rng.uniform(size=(2, 32, 48, 1)) < 0.6).astype(np.float32)
    jd = JDm.Discriminator2D(nf_in=12, nf=4, patch_size=16, image_dims=(32, 48))
    want = np.asarray(jd.compute_valids(jnp.asarray(valid)))
    disc = Dm.Discriminator2D(nf_in=12, nf=4, patch_size=16, image_dims=(32, 48))
    got = disc.compute_valids(H.t(valid)).numpy()
    assert got.shape == want.shape == (2, 8, 12, 1)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("loss_type", ["vanilla", "hinge", "wgan", "wgan_gp"])
@pytest.mark.parametrize("masked", [False, True])
def test_gan_losses_match_jax(loss_type, masked):
    rng = np.random.default_rng(1)
    d_real, d_fake = (rng.normal(0, 2, (2, 4, 6, 1)).astype(np.float32) for _ in range(2))
    valid = rng.uniform(size=(2, 4, 6)) < 0.7 if masked else None
    weight = rng.uniform(0.5, 1.5, (2, 4, 6, 1)).astype(np.float32) if masked else None
    sw = rng.uniform(0, 1, (2,)).astype(np.float32) if masked else None
    opt = (lambda a: None if a is None else jnp.asarray(a))
    optt = (lambda a: None if a is None else H.t(a))
    want = JG.discriminator_loss(loss_type, jnp.asarray(d_real), jnp.asarray(d_fake), opt(valid),
                                 opt(weight), sample_weight_real=opt(sw),
                                 sample_weight_fake=opt(sw))
    got = G.discriminator_loss(loss_type, H.t(d_real), H.t(d_fake), optt(valid), optt(weight),
                               sample_weight_real=optt(sw), sample_weight_fake=optt(sw))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(G.generator_loss(loss_type, H.t(d_fake))),
                               float(JG.generator_loss(loss_type, jnp.asarray(d_fake))),
                               rtol=1e-6, atol=1e-7)


@pytest.fixture(scope="module")
def flax_disc():
    """The JAX package's discriminator of the tiny config, its initial
    variables (numpy) and two image batches."""
    jcfg = JaxTrainConfig(**TINY)
    _, ds = init_states(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(2)
    shape = (2, jcfg.style_height, jcfg.style_width, jcfg.disc_nf_in)
    real, fake = (rng.normal(0, 1, shape).astype(np.float32) for _ in range(2))
    return (jax_make_discriminator(jcfg), H.to_numpy_tree(ds.params),
            H.to_numpy_tree(ds.spectral_stats), real, fake)


def _port(params, stats):
    disc = make_discriminator(TrainConfig(**TINY), device="cpu")
    sd, sn = flax_to_torch_discriminator(params, stats)
    disc.load_state_dict(sd, strict=True)
    return disc, sn


def test_weight_bridge_round_trips(flax_disc):
    _, params, stats, _, _ = flax_disc
    disc, sn = _port(params, stats)
    p2, s2 = torch_to_flax_discriminator(disc.state_dict(), sn)
    flat = (lambda t: {jax.tree_util.keystr(k): np.asarray(a)
                       for k, a in jax.tree_util.tree_flatten_with_path(t)[0]})
    for a, b in ((flat(p2), flat(params)), (flat(s2), flat(stats))):
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert sn["sn_conv_0"]["u"].shape == (1, 8) and sn["sn_conv_1"]["sigma"].shape == ()


def test_call_sequence_of_a_step_matches_flax(flax_disc):
    """d_real with an update, d_fake with an update from the u d_real left, a
    call without an update from the original stats, then one after a
    parameter update: outputs and stored u / sigma as Flax has them."""
    model, params, stats, real, fake = flax_disc
    disc, sn0 = _port(params, stats)

    def japply(p, s, x, update):
        v = {"params": p, "spectral_stats": s}
        if update:
            out, mut = model.apply(v, jnp.asarray(x), update_sn_stats=True,
                                   mutable=["spectral_stats"])
            return np.asarray(out), H.to_numpy_tree(mut["spectral_stats"])
        return np.asarray(model.apply(v, jnp.asarray(x), update_sn_stats=False)), s

    j_real, js1 = japply(params, stats, real, True)
    j_fake, js2 = japply(params, js1, fake, True)
    j_pen, _ = japply(params, stats, fake, False)
    t_real, sn1 = disc(H.t(real), sn0, True)
    t_fake, sn2 = disc(H.t(fake), sn1, True)
    t_pen, same = disc(H.t(fake), sn0, False)
    assert same is sn0
    for got, want in ((t_real, j_real), (t_fake, j_fake), (t_pen, j_pen)):
        np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=2e-6)
    for got, want in ((sn1, js1), (sn2, js2)):
        _, flax_stats = torch_to_flax_discriminator(disc.state_dict(), got)
        for k, node in want.items():
            for leaf, v in node.items():
                np.testing.assert_allclose(flax_stats[k][leaf], v, rtol=1e-6, atol=1e-6,
                                           err_msg=leaf)
    # the u of each call differs from the one before: one power iteration a call
    assert not torch.equal(sn1["sn_conv_0"]["u"], sn0["sn_conv_0"]["u"])
    assert not torch.equal(sn2["sn_conv_0"]["u"], sn1["sn_conv_0"]["u"])
    # a gradient reaches the kernel through sigma, not the stored state
    t_real.sum().backward()
    assert all(p.grad is not None and torch.isfinite(p.grad).all() for p in disc.parameters())
    assert not sn1["sn_conv_0"]["u"].requires_grad

    # after a parameter update, with the updated stats and no update
    new = jax.tree_util.tree_map(lambda a: a * 1.01 + 0.001, params)
    j_adv, _ = japply(new, js2, fake, False)
    disc2, _ = _port(new, None)
    t_adv, _ = disc2(H.t(fake), sn2, False)
    np.testing.assert_allclose(t_adv.detach().numpy(), j_adv, rtol=0, atol=2e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_gradient_penalty_with_a_fed_alpha_matches_jax(flax_disc, seed):
    model, params, stats, real, fake = flax_disc
    disc, sn = _port(params, stats)
    key = jax.random.PRNGKey(seed)
    alpha = np.array(jax.random.uniform(key, (2, 1, 1, 1)))

    def jpen(p):
        return JG.gradient_penalty(
            lambda x: model.apply({"params": p, "spectral_stats": stats}, x,
                                  update_sn_stats=False),
            jnp.asarray(real), jnp.asarray(fake), key)

    want, want_grads = jax.value_and_grad(jpen)(params)
    got = G.gradient_penalty(lambda x: disc(x, sn, False)[0], H.t(real), H.t(fake), H.t(alpha))
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    got.backward()
    # the penalty's gradient in the parameters (double backward)
    # (none reaches the final bias: jax.grad reports zeros there)
    gp, _ = torch_to_flax_discriminator(
        {k: torch.zeros_like(p) if p.grad is None else p.grad for k, p in disc.named_parameters()})
    for name, node in H.to_numpy_tree(want_grads).items():
        for leaf, w in node.items():
            err = np.abs(gp[name][leaf] - w).max() / max(np.abs(w).max(), 1e-12)
            assert err <= 1e-4, (name, leaf, err)


def test_seeded_init_and_optimizer():
    cfg = TrainConfig(**TINY)
    a, sa = init_discriminator(cfg, torch.Generator().manual_seed(3), "cpu")
    b, sb = init_discriminator(cfg, torch.Generator().manual_seed(3), "cpu")
    for (ka, va), (_, vb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(va, vb), ka
        if ka.endswith("bias"):
            assert (va == 0).all()
        else:  # U(+-sqrt(1/fan_in))
            assert va.abs().max() <= 1.0 / np.sqrt(va[0].numel())
    assert torch.equal(sa["sn_conv_1"]["u"], sb["sn_conv_1"]["u"])
    assert float(sa["sn_conv_0"]["sigma"]) == 1.0
    opt = disc_optimizer(cfg, a.parameters())
    assert opt.defaults["lr"] == cfg.d_lr_factor * cfg.lr
    assert opt.defaults["betas"] == (0.9, 0.999) and opt.defaults["eps"] == 1e-8
