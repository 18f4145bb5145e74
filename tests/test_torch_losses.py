"""Every function of spsg_tpu_torch/losses/{geo,semantic}.py against its
counterpart in the JAX package, on identical numpy inputs: values within 1e-5
relative (float32 reductions over a few thousand voxels in another order),
integers and masks exactly."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.data import category as jax_category
from spsg_tpu.losses import geo as jgeo
from spsg_tpu.losses import semantic as jsem
from spsg_tpu_torch.data import category
from spsg_tpu_torch.losses import geo as tgeo
from spsg_tpu_torch.losses import semantic as tsem

torch.set_num_threads(1)

SHAPE = (2, 16, 16, 16)
TRUNC = 3.0


def _grids(seed=0):
    rng = np.random.default_rng(seed)
    target = rng.normal(0, 2.5, SHAPE).astype(np.float32)
    target[rng.uniform(size=SHAPE) < 0.1] = -np.inf  # unobserved
    logits = rng.normal(0, 3, SHAPE).astype(np.float32)
    pred = rng.normal(0, 2.5, SHAPE).astype(np.float32)
    known = rng.integers(0, 4, SHAPE).astype(np.uint8) <= 1
    weight = rng.choice([0.0, 1.0, 5.0], SHAPE).astype(np.float32)
    input_occ = rng.uniform(size=SHAPE) < 0.3
    return target, logits, pred, known, weight, input_occ


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _j(a):
    return None if a is None else jnp.asarray(a)


def _same(got, ref, what=""):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape, what
    if ref.dtype == bool or np.issubdtype(ref.dtype, np.integer):
        assert got.dtype == ref.dtype or np.issubdtype(got.dtype, np.integer), what
        assert np.array_equal(got, ref), what
    else:
        assert got.dtype == np.float32, what
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7, err_msg=what)


def test_masked_mean_is_the_mean_of_the_selected():
    target, logits, _, known, _, _ = _grids()
    _same(tgeo.masked_mean(_t(logits), _t(known)), jgeo.masked_mean(_j(logits), _j(known)))
    np.testing.assert_allclose(tgeo.masked_mean(_t(logits), _t(known)).item(), logits[known].mean(),
                               rtol=1e-5)
    # an empty mask gives 0 by the 1e-12 floor, not NaN
    none = np.zeros(SHAPE, bool)
    assert tgeo.masked_mean(_t(logits), _t(none)).item() == 0.0
    assert float(jgeo.masked_mean(_j(logits), _j(none))) == 0.0


def test_log_transform_and_targets():
    target, _, pred, _, _, _ = _grids(1)
    _same(tgeo.apply_log_transform(_t(pred)), jgeo.apply_log_transform(_j(pred)))
    got = tgeo.compute_targets(_t(target), TRUNC)
    _same(got, jgeo.compute_targets(_j(target), TRUNC))
    assert np.isneginf(target).any() and torch.isfinite(got).all()
    assert (got[torch.from_numpy(np.isneginf(target))] == -TRUNC).all()


@pytest.mark.parametrize("w_surf,w_missing", [(1.0, 5.0), (3.0, 1.0), (2.0, 5.0), (1.0, 1.0)])
def test_dense_geo_weights(w_surf, w_missing):
    target, _, _, _, _, input_occ = _grids(2)
    target = np.clip(target, -TRUNC, TRUNC)
    got = tgeo.dense_geo_weights(_t(target), _t(input_occ), TRUNC, w_surf, w_missing)
    ref = jgeo.dense_geo_weights(_j(target), _j(input_occ), TRUNC, w_surf, w_missing)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert set(np.unique(got.numpy())) <= {1.0, w_surf, w_missing}


@pytest.mark.parametrize("use_known", [True, False])
@pytest.mark.parametrize("use_weight", [True, False])
def test_occ_loss_iou_and_sdf_loss(use_known, use_weight):
    target, logits, pred, known, weight, _ = _grids(3)
    target = np.clip(target, -TRUNC, TRUNC)
    k = known if use_known else None
    w = weight if use_weight else None
    _same(tgeo.occ_loss(_t(target), _t(logits), _t(k), _t(w), TRUNC),
          jgeo.occ_loss(_j(target), _j(logits), _j(k), _j(w), TRUNC), "occ_loss")
    _same(tgeo.occ_iou(_t(target), _t(logits), _t(k), TRUNC),
          jgeo.occ_iou(_j(target), _j(logits), _j(k), TRUNC), "occ_iou")
    for log in (True, False):
        _same(tgeo.sdf_l1_loss(_t(target), _t(pred), _t(k), _t(w), log),
              jgeo.sdf_l1_loss(_j(target), _j(pred), _j(k), _j(w), log), f"sdf_l1 log={log}")


def test_occ_loss_is_the_stable_form_of_bce_with_logits():
    target, logits, _, known, weight, _ = _grids(4)
    target = np.clip(target, -TRUNC, TRUNC)
    logits = logits * 40  # exp(|l|) overflows float32 beyond 88
    got = tgeo.occ_loss(_t(target), _t(logits), _t(known), _t(weight), TRUNC)
    assert torch.isfinite(got)
    ref = torch.nn.functional.binary_cross_entropy_with_logits(
        _t(logits), (_t(target).abs() < TRUNC).float(), reduction="none")
    np.testing.assert_allclose(got.item(), ((ref * _t(weight))[_t(known)]).mean().item(), rtol=1e-5)
    _same(got, jgeo.occ_loss(_j(target), _j(logits), _j(known), _j(weight), TRUNC))


def test_occ_iou_of_an_empty_union_is_minus_one():
    target = np.full(SHAPE, TRUNC, np.float32)  # nothing within truncation
    logits = np.full(SHAPE, -5.0, np.float32)   # nothing predicted
    got = tgeo.occ_iou(_t(target), _t(logits), None, TRUNC)
    assert got.item() == -1.0 and got.dim() == 0
    assert float(jgeo.occ_iou(_j(target), _j(logits), None, TRUNC)) == -1.0
    # an empty known mask empties the union too
    known = np.zeros(SHAPE, bool)
    assert tgeo.occ_iou(_t(target * 0), _t(-logits), _t(known), TRUNC).item() == -1.0


def test_missing_geo_mask():
    target, _, _, _, _, _ = _grids(5)
    target = np.clip(target, -TRUNC, TRUNC)
    occ = np.zeros(SHAPE, bool)
    occ[0, 3, 9, 2] = occ[1, 8:, :, 15] = True
    got = tgeo.missing_geo_mask(_t(occ), _t(target), TRUNC)
    ref = jgeo.missing_geo_mask(_j(occ), _j(target), TRUNC)
    assert got.dtype == torch.bool and np.array_equal(got.numpy(), np.asarray(ref))
    assert not got[0, :8, 8:, :8].any() and got[0, 8:, :8, :8].any()
    # float occupancy, as the reference also passes it
    got_f = tgeo.missing_geo_mask(_t(occ.astype(np.float32)), _t(target), TRUNC)
    assert torch.equal(got, got_f)


def test_class_weights_are_the_jax_packages():
    assert np.array_equal(category.CLASS_WEIGHTS, jax_category.CLASS_WEIGHTS)
    assert tsem.UNLABELED == jsem.UNLABELED == category.UNLABELED == 14


def _semantic(seed=6):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, SHAPE + (14,)).astype(np.float32)
    labels = rng.integers(0, 15, SHAPE).astype(np.uint8)  # 14 = unlabeled
    surface = rng.uniform(size=SHAPE) < 0.4
    weights = np.asarray(category.CLASS_WEIGHTS, np.float32)
    return logits, labels, surface, weights


def test_weighted_cross_entropy_is_torch_cross_entropy_with_weights():
    logits, labels, surface, weights = _semantic()
    mask = surface & (labels < 14)
    got = tsem.weighted_cross_entropy(_t(logits), _t(labels), _t(mask), _t(weights))
    ref = jsem.weighted_cross_entropy(_j(logits), _j(labels.astype(np.int32)), _j(mask), _j(weights))
    _same(got, ref)
    # the reference's own form: F.cross_entropy(weight=...) over the selected voxels
    sel = torch.from_numpy(mask)
    ce = torch.nn.functional.cross_entropy(_t(logits)[sel], _t(labels)[sel].long(), weight=_t(weights))
    np.testing.assert_allclose(got.item(), ce.item(), rtol=1e-5)


def test_semantic_3d_loss_and_its_corner_cases():
    logits, labels, surface, weights = _semantic(7)
    _same(tsem.semantic_3d_loss(_t(logits), _t(labels), _t(surface), _t(weights)),
          jsem.semantic_3d_loss(_j(logits), _j(labels), _j(surface), _j(weights)))
    # no labelled voxel on the surface: 0 by the 1e-12 floor, with a zero gradient
    unl = np.full(SHAPE, 14, np.uint8)
    tl = _t(logits).requires_grad_()
    got = tsem.semantic_3d_loss(tl, _t(unl), _t(surface), _t(weights))
    assert got.item() == 0.0
    assert float(jsem.semantic_3d_loss(_j(logits), _j(unl), _j(surface), _j(weights))) == 0.0
    got.backward()
    assert torch.count_nonzero(tl.grad) == 0
    # labels beyond the classes are clipped before the gather and masked out
    wild = labels.copy()
    wild[labels == 14] = 200
    a = tsem.semantic_3d_loss(_t(logits), _t(wild), _t(surface), _t(weights))
    b = tsem.semantic_3d_loss(_t(logits), _t(labels), _t(surface), _t(weights))
    assert a.item() == b.item()


def test_2d_semantic_functions():
    rng = np.random.default_rng(8)
    sem = rng.normal(0, 2, (2, 12, 10, 14)).astype(np.float32)
    sem[rng.uniform(size=(2, 12, 10)) < 0.3] = -np.inf  # pixels no ray hit
    labels = rng.integers(0, 15, (2, 12, 10)).astype(np.int32)
    weights = np.asarray(category.CLASS_WEIGHTS, np.float32)
    _same(tsem.semantic_2d_loss(_t(sem), _t(labels), _t(weights)),
          jsem.semantic_2d_loss(_j(sem), _j(labels), _j(weights)))
    got = tsem.rendered_semantic_label(_t(sem))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(jsem.rendered_semantic_label(_j(sem))))
    assert (got[torch.from_numpy(np.isneginf(sem[..., 0]))] == 14).all()


def test_loss_gradients_match_jax():
    """The losses are differentiated by autograd: hold one gradient of each
    branch against jax.grad (1e-5 of the largest entry)."""
    import jax

    target, logits, pred, known, weight, _ = _grids(9)
    target = np.clip(target, -TRUNC, TRUNC)
    tl, tp = _t(logits).requires_grad_(), _t(pred).requires_grad_()
    (tgeo.occ_loss(_t(target), tl, _t(known), _t(weight), TRUNC)
     + tgeo.sdf_l1_loss(_t(target), tp, _t(known), _t(weight), True)).backward()
    jl, jp = jax.grad(
        lambda l, p: jgeo.occ_loss(_j(target), l, _j(known), _j(weight), TRUNC)
        + jgeo.sdf_l1_loss(_j(target), p, _j(known), _j(weight), True), argnums=(0, 1))(
            _j(logits), _j(pred))
    for got, ref in ((tl.grad, jl), (tp.grad, jp)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    slog, labels, surface, weights = _semantic(10)
    ts = _t(slog).requires_grad_()
    tsem.semantic_3d_loss(ts, _t(labels), _t(surface), _t(weights)).backward()
    js = np.asarray(jax.grad(lambda s: jsem.semantic_3d_loss(s, _j(labels), _j(surface), _j(weights)))(
        _j(slog)))
    np.testing.assert_allclose(ts.grad.numpy(), js, rtol=0, atol=1e-5 * np.abs(js).max())
