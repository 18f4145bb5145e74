"""The port's generator and weight bridge against the JAX package's generator
(plain XLA convs and the Pallas kernels in interpret mode), on the CPU at
(2,16,16,16) / nf=4 with identical numpy inputs and weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.models.generator import Generator as JaxGenerator
from spsg_tpu.models.generator import GeneratorConfig as JaxGeneratorConfig
from spsg_tpu_torch.models import generator as tg
from spsg_tpu_torch.models.convert import flax_to_torch_generator, torch_to_flax_generator
from spsg_tpu_torch.ops import conv3x3 as conv_ops

import torch_port_helpers as H


def _jax_forward(variables, x, m, pred_color, pred_semantic, train=False, **cfg_kw):
    gen = JaxGenerator(JaxGeneratorConfig(nf=4, **cfg_kw))

    def f(v, x, m):
        return gen.apply(v, x, m, pred_color=pred_color, pred_sdf=True,
                         pred_semantic=pred_semantic, train=train,
                         mutable=["batch_stats"] if train else False)

    out = jax.jit(f)(variables, jnp.asarray(x), jnp.asarray(m))
    outs, new = out if train else (out, None)
    return [None if o is None else np.asarray(o) for o in outs], new


def _torch_forward(gen, x, m, pred_color, pred_semantic):
    with torch.no_grad():
        outs = gen(H.t(x), H.t(m), pred_color=pred_color, pred_semantic=pred_semantic)
    return [None if o is None else o.numpy() for o in outs]


def _assert_outputs_close(got, ref, atol):
    for g, r, name in zip(got, ref, ("occ", "sdf", "color", "semantic")):
        assert (g is None) == (r is None), name
        if g is not None:
            assert g.shape == r.shape and g.dtype == np.float32, name
            np.testing.assert_allclose(g, r, atol=atol, err_msg=name)


def test_bridge_round_trip_is_exact():
    v = H.random_variables()
    sd = flax_to_torch_generator(v)
    back = torch_to_flax_generator(sd)
    flat = lambda tree: {jax.tree_util.keystr(k): a for k, a in
                         jax.tree_util.tree_flatten_with_path(tree)[0]}
    a, b = flat(v), flat(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    # and the other way round, through a module
    gen = H.torch_generator(v)
    sd2 = flax_to_torch_generator(torch_to_flax_generator(gen.state_dict()))
    assert sd2.keys() == gen.state_dict().keys()
    assert all(torch.equal(sd2[k], p) for k, p in gen.state_dict().items())
    # layout convention: flax (kz,ky,kx,I,O) -> torch (O,I,kz,ky,kx)
    k = v["params"]["geo_0b"]["Conv_0"]["kernel"]
    assert sd["geo_0b.weight"].shape == (k.shape[4], k.shape[3]) + k.shape[:3]
    assert sd["geo_0b.weight"][3, 1, 0, 2, 1].item() == k[0, 2, 1, 1, 3]


# eval-mode outputs: atol 5e-4 (the tolerance the JAX package itself used
# against the original PyTorch model); float32 on both sides, other sum order
@pytest.mark.parametrize("pred_color,pred_semantic", [(True, True), (False, False), (True, False)])
@pytest.mark.parametrize("jax_path", ["xla", "pallas"])
def test_eval_forward_matches_jax(pred_color, pred_semantic, jax_path):
    v = H.random_variables()
    x, m = H.chunk_inputs()
    kw = dict(pallas_conv=True, fused_conv=True) if jax_path == "pallas" else {}
    ref, _ = _jax_forward(v, x, m, pred_color, pred_semantic, **kw)
    gen = H.torch_generator(v).eval()
    got = _torch_forward(gen, x, m, pred_color, pred_semantic)
    _assert_outputs_close(got, ref, atol=5e-4)
    if pred_color:
        assert np.abs(got[2]).max() <= 1.0


@pytest.mark.parametrize("jax_path", ["xla", "pallas"])
def test_train_forward_and_running_stats_match_jax(jax_path):
    """Train mode: batch statistics normalise, and the running statistics move
    with the BIASED batch variance (nn.BatchNorm3d would use the unbiased
    one, off by N/(N-1) with N = 128 voxels at the coarsest level)."""
    v = H.random_variables(seed=1)
    x, m = H.chunk_inputs(seed=1)
    kw = dict(pallas_conv=True, fused_conv=True) if jax_path == "pallas" else {}
    ref, new = _jax_forward(v, x, m, True, True, train=True, **kw)
    gen = H.torch_generator(v).train()
    got = _torch_forward(gen, x, m, True, True)
    _assert_outputs_close(got, ref, atol=1e-4)
    new_stats = H.to_numpy_tree(new["batch_stats"])
    got_stats = torch_to_flax_generator(gen.state_dict())["batch_stats"]
    moved = 0
    for (ka, a), (kb, b) in zip(
            jax.tree_util.tree_flatten_with_path(got_stats)[0],
            jax.tree_util.tree_flatten_with_path(new_stats)[0]):
        assert ka == kb
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=jax.tree_util.keystr(ka))
        moved += 1
    assert moved == 2 * 32  # 30 block norms + 2 head norms, mean and var each
    old = v["batch_stats"]["encoder_1c"]["BatchNorm_0"]["var"]
    assert not np.allclose(got_stats["encoder_1c"]["BatchNorm_0"]["var"], old)


def test_batchnorm_updates_with_biased_variance():
    bn = tg.BatchNorm(3).train()
    x = torch.from_numpy(np.random.default_rng(0).normal(1.0, 2.0, (2, 2, 2, 2, 3)).astype(np.float32))
    y = bn(x)
    flat = x.reshape(-1, 3)
    var_b = flat.var(0, unbiased=False)
    torch.testing.assert_close(bn.running_var, 0.9 * torch.ones(3) + 0.1 * var_b)
    torch.testing.assert_close(bn.running_mean, 0.1 * flat.mean(0))
    torch.testing.assert_close(y, (x - flat.mean(0)) * torch.rsqrt(var_b + 1e-5), atol=1e-5, rtol=1e-5)
    # the fused kernel's sums give the same result as computing them here
    bn2 = tg.BatchNorm(3).train()
    y2 = bn2(x, (flat.sum(0), (flat * flat).sum(0)))
    torch.testing.assert_close(y2, y)
    torch.testing.assert_close(bn2.running_var, bn.running_var)


def test_eligible_layers_and_dilation_routing(monkeypatch):
    """28 of the 35 convs are eligible for the kernels (23 fused, 5 bare);
    max_dilation=2 takes geo_1d off them and onto F.conv3d with dilation 2."""
    calls = {"fused": 0, "bare": 0}
    real_f, real_b = conv_ops.conv3x3_act_stats, conv_ops.conv3x3

    def fused(x, w, b):
        calls["fused"] += 1
        return real_f(x, w, b)

    def bare(x, w):
        calls["bare"] += 1
        return real_b(x, w)

    monkeypatch.setattr(conv_ops, "conv3x3_act_stats", fused)
    monkeypatch.setattr(conv_ops, "conv3x3", bare)
    v = H.random_variables()
    x, m = H.chunk_inputs(batch=1)
    gen = H.torch_generator(v).eval()
    blocks = [b for b in gen.modules() if isinstance(b, tg.ConvBlock)]
    assert len(blocks) == 35 and sum(b.eligible for b in blocks) == 28
    _torch_forward(gen, x, m, True, True)
    assert calls == {"fused": 23, "bare": 5}

    calls.update(fused=0, bare=0)
    gen2 = H.torch_generator(v, max_dilation=2).eval()
    assert not gen2.geo_1d.eligible and gen2.geo_1d.dilation == 2
    got = _torch_forward(gen2, x, m, False, False)
    assert calls == {"fused": 8, "bare": 2}  # geometry branch only, geo_1d elsewhere
    ref, _ = _jax_forward(v, x, m, False, False, max_dilation=2)
    _assert_outputs_close(got, ref, atol=5e-4)


def test_plain_convs_hook_gives_the_same_outputs():
    v = H.random_variables()
    x, m = H.chunk_inputs(batch=1)
    a = _torch_forward(H.torch_generator(v).eval(), x, m, True, True)
    gen = tg.Generator(tg.GeneratorConfig(nf=4), plain_convs=True)
    gen.load_state_dict(flax_to_torch_generator(v))
    b = _torch_forward(gen.eval(), x, m, True, True)
    for p, q in zip(a, b):
        assert np.array_equal(p, q)  # on the CPU both take the plain versions


def test_trained_checkpoint_gives_the_same_outputs():
    v = H.epoch39_variables()
    x, m = H.chunk_inputs(seed=2)
    ref, _ = _jax_forward(v, x, m, True, True)
    got = _torch_forward(H.torch_generator(v).eval(), x, m, True, True)
    _assert_outputs_close(got, ref, atol=5e-4)


def test_generator_level_bfloat16_is_not_ported():
    """Serving and training in bfloat16 are ported
    (tests/test_torch_generator_bf16.py, tests/test_torch_train_step_bf16.py):
    a Trainer with compute_dtype "bfloat16" builds the bf16 generator; a
    compute type other than bfloat16 is not ported and is refused."""
    from spsg_tpu_torch.training import TrainConfig
    from spsg_tpu_torch.training.step import Trainer

    trainer = Trainer(TrainConfig(input_dim=H.CHUNK, nf_gen=4, compute_dtype="bfloat16"),
                      device="cpu")
    assert trainer.generator.cfg.dtype == "bfloat16"
    with pytest.raises(ValueError, match="bfloat16"):
        tg.Generator(tg.GeneratorConfig(nf=4, dtype="float16"))
