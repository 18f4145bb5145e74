"""Checkpoints of the original PyTorch reference (``.pth``) in the port
(training/state.py::load_any_checkpoint, models/convert.py) against the JAX
package's load_any_checkpoint of the same files. The reference-named
state_dicts are fabricated from a seed under the JAX package's layout tables
(no reference code needed): generator and discriminator, with and without the
power-iteration vector v."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.models.generator import Generator as JaxGenerator
from spsg_tpu.models.generator import GeneratorConfig as JaxGeneratorConfig
from spsg_tpu.training.config import TrainConfig as JaxTrainConfig
from spsg_tpu.training.state import (
    init_states, load_any_checkpoint as jax_load_any, make_discriminator as jax_make_disc)
from spsg_tpu_torch.data import synthetic
from spsg_tpu_torch.models import convert
from spsg_tpu_torch.training import StepFlags, TrainConfig
from spsg_tpu_torch.training import state
from spsg_tpu_torch.training.step import Trainer

import torch_port_helpers as H

TINY = dict(input_dim=H.CHUNK, nf_gen=4, nf_disc=4, style_width=48, style_height=32,
            patch_size=16)


@functools.lru_cache(maxsize=None)
def jax_states(with_disc=True):
    """The JAX package's initial (GenState, DiscState) of the tiny config
    (immutable, so shared by the tests)."""
    return init_states(JaxTrainConfig(**TINY), jax.random.PRNGKey(0), with_disc=with_disc)


def reference_discriminator_state_dict(seed, with_v=True):
    """A reference Discriminator2D state_dict (spectral_norm's ``weight_orig``,
    ``weight_u``, ``weight_v``; Sequential members ``0``, ``p1``, ...) of the
    tiny config's shapes, drawn from ``seed``; the second conv lacks
    ``weight_v`` unless ``with_v``."""
    _, ds = jax_states()
    rng = np.random.default_rng(seed)
    sd = {}
    n = len([k for k in ds.params if k.startswith("sn_conv_")])
    for k in range(n):
        kh, kw, ci, co = ds.params[f"sn_conv_{k}"]["kernel"].shape
        base = f"discriminator_net.{'0' if k == 0 else f'p{k}'}.conv2d"
        sd[f"{base}.weight_orig"] = rng.normal(0, 0.2, (co, ci, kh, kw))
        sd[f"{base}.bias"] = rng.normal(0, 0.1, co)
        u = rng.normal(0, 1, co)
        sd[f"{base}.weight_u"] = u / np.linalg.norm(u)
        if with_v or k == 0:
            v = rng.normal(0, 1, ci * kh * kw)
            sd[f"{base}.weight_v"] = v / np.linalg.norm(v)
    kh, kw, ci, co = ds.params["final"]["kernel"].shape
    sd["final.weight"] = rng.normal(0, 0.2, (co, ci, kh, kw))
    sd["final.bias"] = rng.normal(0, 0.1, co)
    return {k: torch.as_tensor(np.asarray(v, np.float32)) for k, v in sd.items()}


def _save(path, sd, epoch):
    torch.save({"epoch": epoch, "state_dict": sd, "optimizer": {}}, path)
    return str(path)


@pytest.fixture(scope="module")
def generator_pth(tmp_path_factory):
    """A reference generator .pth (epoch 7), the variables it holds, and the
    JAX package's forward after its load_any_checkpoint of it."""
    variables = H.random_variables(4, seed=4)
    sd = H.reference_generator_state_dict(variables, seed=4)
    pth = _save(tmp_path_factory.mktemp("pth") / "model-iter10-epoch7.pth", sd, 7)
    gs, _, jepoch = jax_load_any(pth, jax_states(with_disc=False)[0], None)
    assert jepoch == 7
    x, m = H.chunk_inputs(batch=1, seed=3)
    gen = JaxGenerator(JaxGeneratorConfig(nf=4))
    fwd = jax.jit(lambda v, a, b: gen.apply(v, a, b, pred_color=True, pred_sdf=True,
                                              pred_semantic=True, train=False))
    ref = [np.asarray(o) for o in fwd({"params": gs.params, "batch_stats": gs.batch_stats},
                                      jnp.asarray(x), jnp.asarray(m))]
    return variables, sd, pth, (x, m), ref


@pytest.mark.parametrize("suffix", [".pth", ".pt"])
def test_generator_pth_computes_what_jax_computes_after_loading(tmp_path, generator_pth, suffix):
    """The port's forward after load_any_checkpoint equals the JAX package's
    forward after its load_any_checkpoint of the same .pth, within 1e-5; a .pt
    with the reference's module names loads the same way; the epoch comes back
    and num_batches_tracked is dropped."""
    variables, sd, pth, (x, m), ref = generator_pth
    path = pth if suffix == ".pth" else _save(tmp_path / "reference-names.pt", sd, 7)
    gen = state.make_generator(TrainConfig(**TINY), device="cpu")
    gen, epoch = state.load_any_checkpoint(path, gen)
    assert epoch == 7
    want = convert.flax_to_torch_generator(variables)
    assert gen.state_dict().keys() == want.keys()
    assert all(torch.equal(v, want[k]) for k, v in gen.state_dict().items())

    with torch.no_grad():
        got = gen.eval()(H.t(x), H.t(m), pred_color=True, pred_semantic=True)
    for g, r, name in zip(got, ref, ("occ", "sdf", "color", "semantic")):
        np.testing.assert_allclose(g.numpy(), r, rtol=0, atol=1e-5, err_msg=name)


def test_generator_pth_into_a_trainer_restarts_adam(tmp_path):
    """Into a Trainer: the generator's weights and the epoch; its Adam starts
    afresh (the reference's moments are not carried over, as in the JAX
    package)."""
    variables = H.random_variables(4, seed=5)
    pth = _save(tmp_path / "model.pth", H.reference_generator_state_dict(variables, 5), 3)
    trainer = Trainer(TrainConfig(**TINY, weight_disc_loss=0.0), device="cpu")
    trainer.step(dict(synthetic.make_chunk_batch(1, H.CHUNK, seed=1), weight_occ=1.0),
                 StepFlags(pred_sdf=True, pred_color=False, pred_semantic=False))
    assert trainer.optimizer.state
    trainer, epoch = state.load_any_checkpoint(pth, trainer)
    assert epoch == 3 and not trainer.optimizer.state
    want = convert.flax_to_torch_generator(variables)
    assert all(torch.equal(v, want[k]) for k, v in trainer.generator.state_dict().items())


@pytest.fixture(scope="module")
def jax_disc_images():
    rng = np.random.default_rng(6)
    jcfg = JaxTrainConfig(**TINY)
    return rng.normal(0, 1, (2, jcfg.style_height, jcfg.style_width,
                             jcfg.disc_nf_in)).astype(np.float32)


@pytest.mark.parametrize("with_v", [True, False])
def test_discriminator_pth_matches_jax(tmp_path, jax_disc_images, with_v):
    """A discriminator .pth: parameters identical to the JAX package's after
    its load_any_checkpoint, u identical, sigma within 1e-6, the forward
    (which runs a power iteration from the stored u) within 1e-5; the
    generator and its Adam are untouched, the discriminator's Adam restarts."""
    sd = reference_discriminator_state_dict(seed=7, with_v=with_v)
    pth = _save(tmp_path / "disc-iter10-epoch2.pth", sd, 2)
    jcfg = JaxTrainConfig(**TINY)
    gs, ds = jax_states()
    gs2, ds2, jepoch = jax_load_any(pth, gs, ds)
    assert gs2 is gs

    trainer = Trainer(TrainConfig(**TINY), device="cpu")
    gen_before = {k: v.clone() for k, v in trainer.generator.state_dict().items()}
    trainer.disc_optimizer.state[next(trainer.discriminator.parameters())] = {"step": 1}
    trainer, epoch = state.load_any_checkpoint(pth, trainer)
    assert epoch == jepoch == 2
    assert all(torch.equal(v, gen_before[k]) for k, v in trainer.generator.state_dict().items())
    assert not trainer.disc_optimizer.state

    want_sd, want_sn = convert.flax_to_torch_discriminator(
        H.to_numpy_tree(ds2.params), H.to_numpy_tree(ds2.spectral_stats))
    got_sd = trainer.discriminator.state_dict()
    assert got_sd.keys() == want_sd.keys()
    assert all(torch.equal(v, want_sd[k]) for k, v in got_sd.items())
    assert trainer.sn_state.keys() == want_sn.keys()
    for k, node in want_sn.items():
        assert torch.equal(trainer.sn_state[k]["u"], node["u"]), k
        assert abs(float(trainer.sn_state[k]["sigma"]) - float(node["sigma"])) <= 1e-6, k

    model = jax_make_disc(jcfg)
    ref = np.asarray(model.apply({"params": ds2.params, "spectral_stats": ds2.spectral_stats},
                                 jnp.asarray(jax_disc_images), update_sn_stats=False))
    with torch.no_grad():
        got, _ = trainer.discriminator(H.t(jax_disc_images), trainer.sn_state, False)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5)

    # --retrain_disc takes the same file the same way
    other = Trainer(TrainConfig(**TINY), device="cpu", seed=3)
    state.load_discriminator(pth, other)
    assert all(torch.equal(v, got_sd[k]) for k, v in other.discriminator.state_dict().items())


def test_reference_files_and_errors_as_in_jax(tmp_path):
    """A discriminator file without a discriminator configured raises
    ValueError in both packages; load_checkpoint refuses reference names and
    names load_any_checkpoint; a reference file is recognised by its names."""
    pth = _save(tmp_path / "disc.pth", reference_discriminator_state_dict(seed=8), 0)
    with pytest.raises(ValueError, match="discriminator"):
        jax_load_any(pth, jax_states(with_disc=False)[0], None)
    for model in (Trainer(TrainConfig(**TINY, weight_disc_loss=0.0), device="cpu"),
                  state.make_generator(TrainConfig(**TINY), device="cpu")):
        with pytest.raises(ValueError, match="no discriminator"):
            state.load_any_checkpoint(pth, model)
    gen = state.make_generator(TrainConfig(**TINY), device="cpu")
    with pytest.raises(ValueError, match="load_any_checkpoint"):
        state.load_checkpoint(pth, gen)
    sd = H.reference_generator_state_dict(H.random_variables(4, seed=1), 1)
    assert convert.is_reference_state_dict(sd) and not convert.is_reference_discriminator(sd)
    assert not convert.is_reference_state_dict(gen.state_dict())
    # a generator file whose weights do not fit the configured generator
    wide = state.make_generator(TrainConfig(**dict(TINY, nf_gen=8)), device="cpu")
    with pytest.raises(RuntimeError, match="size mismatch"):
        state.load_any_checkpoint(_save(tmp_path / "g.pth", sd, 0), wide)
