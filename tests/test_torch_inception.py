"""The port's Inception-v3 (spsg_tpu_torch/models/inception.py) against the
JAX package's on the CPU: tests/test_inception.py's four tests, ported; the
fabricated torchvision state_dict equal to the JAX package's to the bit; the
forward on it at (1, 299, 299, 3), pool and logits within 1e-4 of their
largest entry, through models/convert.py::inception_params_from_jax and
through a torchvision-format .pth; ``preprocess`` within 1e-5 of the JAX
package's when it grows an image and when it shrinks one (the JAX resize
antialiases then; F.interpolate without ``antialias`` does not), and within
1e-6 of the JAX filter's product in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from spsg_tpu.models import inception as jax_inception
from spsg_tpu_torch.models import inception
from spsg_tpu_torch.models.convert import inception_params_from_jax

import torch_port_helpers as H


def _model(state_dict):
    model = inception.InceptionV3().eval()
    model.load_state_dict(state_dict, strict=True)
    return model


@pytest.fixture(scope="module")
def jax_reference():
    """(input (1,299,299,3), the JAX package's pool and logits on it, its
    params) on fabricate_state_dict()."""
    params = jax_inception.convert_inception_state_dict(jax_inception.fabricate_state_dict())
    x = np.random.default_rng(0).random((1, 299, 299, 3)).astype(np.float32)
    pool, logits = jax.jit(jax_inception.inception_v3)(params, jnp.asarray(x))
    return x, np.asarray(pool), np.asarray(logits), params


def test_inception_forward_shapes(jax_reference):
    x = jax_reference[0]
    model = _model(inception.convert_inception_state_dict(inception.fabricate_state_dict()))
    with torch.no_grad():
        pool, logits = model(H.t(x))
    assert pool.shape == (1, inception.POOL_DIM)
    assert logits.shape == (1, inception.NUM_CLASSES)
    assert torch.isfinite(pool).all() and torch.isfinite(logits).all()


def test_inception_preprocess():
    x = torch.ones((2, 64, 80, 3)) * 0.5
    y = inception.preprocess(x)
    assert y.shape == (2, 299, 299, 3)
    # 0.5 grey maps to (0.5 - mean) / std
    np.testing.assert_allclose(
        y[0, 0, 0].numpy(),
        (0.5 - np.array([0.485, 0.456, 0.406])) / np.array([0.229, 0.224, 0.225]), atol=1e-5)


def test_inception_pth_load(tmp_path):
    """load_inception reads a torchvision-format .pth as the reference's
    --inception_v3_path does (metrics.py:45-50); the auxiliary head's keys
    are left out."""
    sd = inception.fabricate_state_dict(7)
    sd["AuxLogits.conv0.conv.weight"] = np.zeros((128, 768, 1, 1), np.float32)
    p = str(tmp_path / "inception_v3.pth")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, p)
    model = inception.load_inception(p, device="cpu")
    direct = inception.convert_inception_state_dict(sd)
    got = model.state_dict()
    assert set(got) == set(direct) and not any(k.startswith("AuxLogits") for k in got)
    for k, v in direct.items():
        assert torch.equal(got[k], v), k
    assert not model.training and not any(q.requires_grad for q in model.parameters())


def test_converter_rejects_wrong_shapes():
    sd = inception.fabricate_state_dict()
    sd["Mixed_5b.branch1x1.conv.weight"] = np.zeros((65, 192, 1, 1), np.float32)
    with pytest.raises(ValueError, match="Mixed_5b.branch1x1"):
        inception.convert_inception_state_dict(sd)


@pytest.mark.parametrize("seed", [42, 7])
def test_fabricated_state_dict_is_the_jax_packages_to_the_bit(seed):
    a, b = inception.fabricate_state_dict(seed), jax_inception.fabricate_state_dict(seed)
    assert list(a) == list(b)
    for k in b:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("route", ["jax_params", "torchvision_pth"])
def test_inception_matches_jax(route, jax_reference, tmp_path):
    x, pool_ref, logits_ref, params = jax_reference
    if route == "jax_params":
        model = _model(inception_params_from_jax(H.to_numpy_tree(params)))
    else:
        p = str(tmp_path / "inception_v3_google.pth")
        torch.save({k: torch.from_numpy(v)
                    for k, v in inception.fabricate_state_dict().items()}, p)
        model = inception.load_inception(p, device="cpu")
    with torch.no_grad():
        pool, logits = model(H.t(x))
    for got, ref in ((pool, pool_ref), (logits, logits_ref)):
        scale = np.abs(ref).max()
        assert scale > 0
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-4 * scale)


def _resized(normalised):
    """The resized image in [0, 1] behind a preprocess output."""
    return (np.asarray(normalised) * np.array(inception.COLOR_STD, np.float32)
            + np.array(inception.COLOR_MEAN, np.float32))


@pytest.mark.parametrize("shape", [(2, 64, 80, 3), (1, 384, 480, 3)],
                         ids=["grows", "shrinks"])
def test_preprocess_matches_jax(shape):
    """The resize against the JAX package's filter: within 1e-6 of its
    weights' product in float64 (jax.image's own compute_weight_mat), and
    within 1e-5 of jax.image.resize's float32 result, whose sums on XLA:CPU
    land up to 8e-6 from that float64 product (the port's: 2.4e-7). Compared
    in [0, 1], before the normalisation (which divides by std ~0.22); the
    normalisation itself as in test_inception_preprocess. F.interpolate
    without antialias: the same filter when growing (within 1e-5), not when
    shrinking."""
    from jax._src.image import scale as jax_scale

    x = np.random.default_rng(1).random(shape).astype(np.float32)
    ref = _resized(jax_inception.preprocess(jnp.asarray(x)))
    got = _resized(inception.preprocess(H.t(x)).numpy())
    assert got.shape == ref.shape == (shape[0], 299, 299, 3)
    kernel = jax_scale._kernels[jax.image.ResizeMethod.LINEAR]
    wh, ww = (np.asarray(jax_scale.compute_weight_mat(n, 299, 299 / n, 0.0, kernel, True),
                         np.float64) for n in shape[1:3])
    exact = np.einsum("bhwc,hH,wW->bHWc", x.astype(np.float64), wh, ww, optimize=True)
    np.testing.assert_allclose(got, exact, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    plain = F.interpolate(H.t(x).permute(0, 3, 1, 2), size=(299, 299), mode="bilinear",
                          align_corners=False).permute(0, 2, 3, 1).numpy()
    gap = np.abs(plain - exact).max()
    assert gap < 1e-5 if shape[1] < 299 else gap > 1e-2


def test_inception_on_the_gpu_unless_asked_otherwise(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inception.load_inception()
