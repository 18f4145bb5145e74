"""The port's style / content losses (spsg_tpu_torch/losses/style.py) and VGG19
extractor (spsg_tpu_torch/models/vgg.py) against the JAX package's on the
CPU: the Gram matrix and both losses within 1e-6 relative; the features of
JAX-initialised parameters (carried across models/convert.py::
vgg_params_from_jax) within 1e-5 of the largest |feature|; a fabricated
torchvision .pth converted by tools/convert_vgg19.py loading in both
packages with the same features; the weight search order and the fallback's
warning."""

import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.losses import style as jax_style
from spsg_tpu.models import vgg as jax_vgg
from spsg_tpu_torch.losses import style
from spsg_tpu_torch.models import vgg
from spsg_tpu_torch.models.convert import vgg_params_from_jax

import torch_port_helpers as H

# torchvision vgg19 `features` indices of the 8 convs the extractor keeps
CONV_IDX = [0, 2, 5, 7, 10, 12, 14, 16]
WIDTHS = [64, 64, 128, 128, 256, 256, 256, 256]


def fabricate_vgg19_pth(path, seed=7):
    """A state dict with torchvision vgg19's key names and shapes (OIHW) and
    seeded values (tests/test_vgg_weights.py's)."""
    rng = np.random.default_rng(seed)
    sd, cin = {}, 3
    for fi, width in zip(CONV_IDX, WIDTHS):
        sd[f"features.{fi}.weight"] = torch.from_numpy(
            rng.standard_normal((width, cin, 3, 3)).astype(np.float32) * 0.05)
        sd[f"features.{fi}.bias"] = torch.from_numpy(
            rng.standard_normal((width,)).astype(np.float32) * 0.05)
        cin = width
    torch.save(sd, path)
    return sd


def jax_vgg_params(seed=0):
    """JAX-initialised VGGFeatures parameters (numpy) with random biases, so
    that a bias lost or mixed up shows."""
    params = jax_vgg.VGGFeatures().init(jax.random.PRNGKey(seed),
                                        jnp.zeros((1, 32, 32, 3)))["params"]
    params = H.to_numpy_tree(params)
    rng = np.random.default_rng(seed)
    for p in params.values():
        p["bias"] = rng.normal(0, 0.1, p["bias"].shape).astype(np.float32)
    return params


def _features(style_layers, params, x):
    model = vgg.VGGFeatures(style_layers)
    model.load_state_dict(vgg_params_from_jax(params), strict=True)
    with torch.no_grad():
        return [f.numpy() for f in model(H.t(x))]


@pytest.mark.parametrize("shape", [(2, 8, 8, 4), (1, 6, 10, 16)])
def test_gram_and_losses_match_jax(shape):
    rng = np.random.default_rng(3)
    a = rng.standard_normal(shape).astype(np.float32)
    b = (a * 1.1 + 0.2 * rng.standard_normal(shape)).astype(np.float32)
    g = style.gram_matrix(H.t(a))
    assert g.shape == (shape[0] * shape[3],) * 2  # (B*C, B*C)
    np.testing.assert_allclose(g.numpy(), np.asarray(jax_style.gram_matrix(jnp.asarray(a))),
                               rtol=1e-6, atol=1e-7)
    for flags in ((True, True), (True, False), (False, True)):
        got = style.style_content_loss([H.t(a), H.t(b)], [H.t(b), H.t(a)], *flags)
        ref = jax_style.style_content_loss([jnp.asarray(a), jnp.asarray(b)],
                                           [jnp.asarray(b), jnp.asarray(a)], *flags)
        for x, y, on in zip(got, ref, flags):
            assert (float(x) > 0) == on
            np.testing.assert_allclose(float(x), float(y), rtol=1e-6)


@pytest.mark.parametrize("style_layers", [(8,), (2, 4, 8)])
def test_vgg_features_match_jax(style_layers):
    params = jax_vgg_params()
    x = np.random.default_rng(1).random((2, 32, 48, 3)).astype(np.float32)
    got = _features(style_layers, params, x)
    ref = jax_vgg.VGGFeatures(style_layers=style_layers).apply(
        {"params": params}, jnp.asarray(x))
    assert len(got) == len(ref) == len(style_layers)
    for a, b in zip(got, ref):
        b = np.asarray(b)
        assert a.shape == b.shape  # channel-last, pooled before conv 3 and conv 5
        scale = np.abs(b).max()
        assert scale > 0 and (b < 0).any()  # pre-ReLU
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale)


def test_vgg_stops_after_the_last_requested_layer():
    model = vgg.VGGFeatures((2,))
    ran = []
    for i in range(1, 9):
        conv = getattr(model, f"conv_{i}")
        conv.register_forward_hook(lambda m, a, o, i=i: ran.append(i))
    out = model(torch.rand(1, 16, 16, 3))
    assert ran == [1, 2] and out[0].shape == (1, 16, 16, 64)


@pytest.fixture(scope="module")
def converted(tmp_path_factory):
    """(the fabricated .pth and its state dict, the .npz tools/convert_vgg19.py
    wrote from it)."""
    d = tmp_path_factory.mktemp("vgg")
    pth, npz = str(d / "vgg19-fabricated.pth"), str(d / "vgg19_conv8.npz")
    sd = fabricate_vgg19_pth(pth)
    r = subprocess.run([sys.executable, os.path.join(H.REPO, "tools", "convert_vgg19.py"),
                        "--src", pth, "--out", npz], capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr
    return pth, sd, npz


def test_converted_npz_loads_in_both_packages_with_the_same_features(converted, monkeypatch,
                                                                       tmp_path):
    pth, sd, npz = converted
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))  # no hub cache
    monkeypatch.setenv("SPSG_VGG_WEIGHTS", npz)
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # a fallback would warn
        model = vgg.load_vgg_for_style(device="cpu")
        jmodel, jparams = jax_vgg.load_vgg_for_style()
    for i, fi in enumerate(CONV_IDX):
        assert torch.equal(getattr(model, f"conv_{i + 1}").weight, sd[f"features.{fi}.weight"])
        assert torch.equal(getattr(model, f"conv_{i + 1}").bias, sd[f"features.{fi}.bias"])
    assert not any(p.requires_grad for p in model.parameters()) and not model.training
    x = np.random.default_rng(2).random((1, 32, 32, 3)).astype(np.float32)
    with torch.no_grad():
        got = model(H.t(x))[0].numpy()
    ref = np.asarray(jmodel.apply({"params": jparams}, jnp.asarray(x))[0])
    assert got.shape == (1, 8, 8, 256)  # conv3_4 after two pools
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    # the .pth itself through $SPSG_VGG_WEIGHTS: the same weights
    monkeypatch.setenv("SPSG_VGG_WEIGHTS", pth)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        from_pth = vgg.load_vgg_for_style(device="cpu")
    assert all(torch.equal(v, model.state_dict()[k]) for k, v in from_pth.state_dict().items())


def test_weight_search_order_and_the_fallback(converted, monkeypatch, tmp_path):
    """$SPSG_VGG_WEIGHTS before the hub cache; the hub cache when the variable
    is unset; fixed-seed weights with the JAX package's warning when neither
    is there, and style losses that differ from the loaded weights'."""
    pth, sd, npz = converted
    hub = tmp_path / "hub" / "checkpoints"
    hub.mkdir(parents=True)
    other = fabricate_vgg19_pth(str(hub / "vgg19-dcbb9e9d.pth"), seed=8)
    monkeypatch.setenv("TORCH_HOME", str(tmp_path))
    monkeypatch.setenv("SPSG_VGG_WEIGHTS", npz)
    assert torch.equal(vgg.load_vgg_for_style(device="cpu").conv_1.weight,
                       sd["features.0.weight"])
    monkeypatch.delenv("SPSG_VGG_WEIGHTS")
    loaded = vgg.load_vgg_for_style(device="cpu")
    assert torch.equal(loaded.conv_1.weight, other["features.0.weight"])
    monkeypatch.setenv("TORCH_HOME", str(tmp_path / "empty"))
    monkeypatch.setenv("SPSG_VGG_WEIGHTS", str(tmp_path / "missing.npz"))
    with pytest.warns(UserWarning, match="FIXED-SEED RANDOM"):
        fallback = vgg.load_vgg_for_style(device="cpu")
    with pytest.warns(UserWarning, match="FIXED-SEED RANDOM"):
        again = vgg.load_vgg_for_style(device="cpu")
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in fallback.state_dict().items())
    rng = np.random.default_rng(0)
    a, b = (H.t(rng.random((1, 32, 32, 3)).astype(np.float32)) for _ in range(2))
    with torch.no_grad():
        losses = [float(style.style_content_loss(m(a), m(b), True, False)[0])
                  for m in (loaded, fallback)]
    assert all(np.isfinite(losses)) and losses[0] != losses[1]


def test_vgg_on_the_gpu_unless_asked_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        vgg.load_vgg_for_style()
