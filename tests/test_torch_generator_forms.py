"""The port's generator with GeneratorConfig.zslab_conv, folded_conv and remat
against the JAX package's generator with the same flag, on the CPU at nf 4,
16^3, batch 2, with the inputs and the loss of tests/test_zslab_conv.py /
tests/test_folded_conv.py and the JAX-initialised weights carried across by
models/convert.py. The port keeps its hand kernels (their plain versions
here) on the 28 eligible layers under every flag, where the JAX generator
with the flag alone computes those in the flag's form too: both are the same
convs, so the JAX tests' tolerances hold. Remat is held against the port's
own run without it to the bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.models.generator import Generator as JaxGenerator
from spsg_tpu.models.generator import GeneratorConfig as JaxGeneratorConfig
from spsg_tpu_torch.models import generator as tg
from spsg_tpu_torch.models.convert import generator_grads_to_flax, torch_to_flax_generator
from spsg_tpu_torch.ops import conv3x3 as conv_ops

import torch_port_helpers as H

FLAGS = ("zslab_conv", "folded_conv", "remat")
KW = dict(pred_color=True, pred_sdf=True, pred_semantic=True)


def _inputs():
    """tests/test_zslab_conv.py's generator inputs."""
    rng = np.random.default_rng(5)
    x = rng.uniform(-3, 3, (2, 16, 16, 16, 4)).astype(np.float32)
    m = (rng.random((2, 16, 16, 16, 1)) > 0.5).astype(np.float32)
    return x, m


def _loss(outs):
    return sum((o ** 2).mean() for o in outs)


@functools.lru_cache(maxsize=None)
def _jax_run(flag):
    """The JAX generator with ``flag``: eval outputs, train outputs, the
    updated running statistics and the gradients of the JAX tests' loss, in
    one compiled call."""
    v = H.initial_variables()
    x, m = _inputs()
    gen = JaxGenerator(JaxGeneratorConfig(nf=4, **{flag: True}))

    def run(v, x, m):
        ev = gen.apply(v, x, m, train=False, **KW)

        def loss(p):
            outs, upd = gen.apply({"params": p, "batch_stats": v["batch_stats"]}, x, m,
                                  train=True, mutable=["batch_stats"], **KW)
            return sum(jnp.mean(o ** 2) for o in outs), (outs, upd["batch_stats"])

        grads, (tr, stats) = jax.grad(loss, has_aux=True)(v["params"])
        return ev, tr, stats, grads

    return H.to_numpy_tree(jax.jit(run)(v, jnp.asarray(x), jnp.asarray(m)))


def _port_run(**cfg_kw):
    """The port's generator: eval outputs, then one train forward and backward
    of the same loss; returns (eval outputs, train outputs, generator)."""
    x, m = (H.t(a) for a in _inputs())
    gen = H.torch_generator(H.initial_variables(), **cfg_kw).eval()
    with torch.no_grad():
        ev = [o.numpy() for o in gen(x, m, pred_color=True, pred_semantic=True)]
    gen.train()
    tr = gen(x, m, pred_color=True, pred_semantic=True)
    _loss(tr).backward()
    return ev, [o.detach().numpy() for o in tr], gen


def _flat(tree):
    return {jax.tree_util.keystr(k): np.asarray(a)
            for k, a in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("flag", FLAGS)
def test_generator_with_the_flag_matches_jax(flag):
    ev_ref, tr_ref, stats_ref, grads_ref = _jax_run(flag)
    ev, tr, gen = _port_run(**{flag: True})
    for got, ref, atol in ((ev, ev_ref, 5e-5), (tr, tr_ref, 2e-4)):
        for g, r, name in zip(got, ref, ("occ", "sdf", "color", "semantic")):
            assert g.shape == r.shape, name
            np.testing.assert_allclose(g, r, rtol=0, atol=atol, err_msg=name)
    got_stats = _flat(torch_to_flax_generator(gen.state_dict())["batch_stats"])
    ref_stats = _flat(stats_ref)
    assert got_stats.keys() == ref_stats.keys() and len(got_stats) == 2 * 32
    for k, r in ref_stats.items():
        np.testing.assert_allclose(got_stats[k], r, rtol=0, atol=2e-4, err_msg=k)
    got_g, ref_g = _flat(generator_grads_to_flax(gen)), _flat(grads_ref)
    assert got_g.keys() == ref_g.keys()
    for k, r in ref_g.items():
        # + 2e-7: decoder_3e's bias, which feeds only train-mode BatchNorms, has a
        # gradient of rounding noise (~1e-8) on both sides
        np.testing.assert_allclose(got_g[k], r, rtol=0, atol=5e-4 * np.abs(r).max() + 2e-7,
                                   err_msg=k)


def test_state_dict_is_the_same_under_every_flag():
    base = tg.Generator(tg.GeneratorConfig(nf=4)).state_dict()
    for kw in ({"zslab_conv": True}, {"folded_conv": True}, {"remat": True},
               {"zslab_conv": True, "folded_conv": True, "remat": True}):
        sd = tg.Generator(tg.GeneratorConfig(nf=4, **kw)).state_dict()
        assert list(sd) == list(base), kw
        assert all(sd[k].shape == base[k].shape for k in base), kw


def test_remat_is_the_run_without_it_to_the_bit():
    """Outputs, the running statistics after one train forward (moved once,
    not again by the recompute) and every gradient, with and without remat,
    also together with the z-slab form."""
    for extra in ({}, {"zslab_conv": True}):
        ev_a, tr_a, a = _port_run(**extra)
        ev_b, tr_b, b = _port_run(remat=True, **extra)
        for p, q in zip(ev_a + tr_a, ev_b + tr_b):
            assert np.array_equal(p, q)
        sa, sb = a.state_dict(), b.state_dict()
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k
        moved = H.initial_variables()["batch_stats"]["encoder_1c"]["BatchNorm_0"]["var"]
        assert not np.allclose(sb["encoder_1c.bn.running_var"].numpy(), moved)
        gb = dict(b.named_parameters())
        for n, p in a.named_parameters():
            assert torch.equal(p.grad, gb[n].grad), n


@pytest.mark.parametrize("max_dilation", [1, 2])
def test_routing_keeps_the_hand_kernels_on_every_eligible_layer(monkeypatch, max_dilation):
    """Under every flag the eligible layers take the conv kernels (23 fused,
    5 bare at max_dilation 1); zslab_conv sends every other conv through the
    z-slab form, folded_conv the odd stride-1 dilation-1 ones (the 5^3 entry
    convs the JAX package folds; not a dilated geo_1d)."""
    calls = {"fused": 0, "bare": 0, "zslab": 0}

    def counting(name, fn):
        def run(*a, **kw):
            calls[name] += 1
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(conv_ops, "conv3x3_act_stats",
                        counting("fused", conv_ops.conv3x3_act_stats))
    monkeypatch.setattr(conv_ops, "conv3x3", counting("bare", conv_ops.conv3x3))
    monkeypatch.setattr(tg, "conv3d_zslab", counting("zslab", tg.conv3d_zslab))
    x, m = (H.t(a[:1]) for a in _inputs())
    eligible = (8 if max_dilation > 1 else 9) + 14 + 5  # geo_1d leaves at dilation 2
    want = {"zslab_conv": 35 - eligible, "folded_conv": 2, "": 0}
    for flag, zslab in want.items():
        calls.update(fused=0, bare=0, zslab=0)
        kw = {flag: True} if flag else {}
        gen = H.torch_generator(H.initial_variables(), max_dilation=max_dilation, **kw).eval()
        routes = {n: b.route for n, b in gen.named_modules() if isinstance(b, tg.ConvBlock)}
        with torch.no_grad():
            gen(x, m, pred_color=True, pred_semantic=True)
        assert calls["fused"] + calls["bare"] == eligible, flag
        assert calls["zslab"] == zslab, flag
        assert routes["geo_1d"] == ("hand" if max_dilation == 1 else
                                    "zslab" if flag == "zslab_conv" else "library")
        if flag == "folded_conv":
            assert {n for n, r in routes.items() if r == "zslab"} == {"geo_0a", "encoder_0a"}
