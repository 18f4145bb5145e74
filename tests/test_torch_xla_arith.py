"""spsg_tpu_torch/ops/xla_arith.py (float32 arithmetic in the forms XLA
compiles the JAX package to on the CPU) against exact rational arithmetic and
against XLA itself, and the port's ray set-up built of it against the JAX
package's jitted set-up, bit for bit. The JAX programs take their arrays as
arguments, as the JAX package's step passes them: a closure's arrays would be
folded into constants at compile time, and XLA then turns a division by the
focal length into a product with its folded reciprocal."""

import sys
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.data import synthetic as jax_synthetic
from spsg_tpu.ops import raycast as jr
from spsg_tpu_torch.ops import raycast as R
from spsg_tpu_torch.ops.xla_arith import block_sum, div_const, exp32, fma32, recip_const, sqrt32

import torch_port_helpers as H

sys.path.insert(0, H.REPO)
import chip_smoke as cs  # noqa: E402


def _nearest32(x: Fraction) -> np.float32:
    """The float32 nearest to the rational x, ties to even."""
    f = np.float32(float(x))  # float64 first: at most one float32 ulp off
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    dist = [abs(Fraction(float(c)) - x) for c in cands]
    best = min(dist)
    ties = [c for c, d in zip(cands, dist) if d == best]
    return min(ties, key=lambda c: int(np.array(c).view(np.int32)) & 1)


def _bits(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.int32)


def test_fma32_is_the_correctly_rounded_fused_multiply_add():
    rng = np.random.default_rng(0)
    n = 3000
    a, b, c = (rng.standard_normal(n) * 10.0 ** rng.integers(-6, 7, n) for _ in range(3))
    a, b, c = (np.asarray(v, dtype=np.float32) for v in (a, b, c))
    # c near -a*b too: the sum cancels
    third = a[::3].astype(np.float64) * b[::3]
    c[::3] = np.float32(-third * (1 + rng.standard_normal(len(third)) * 1e-6))
    # triples just off a float32 halfway point, the ones chip_smoke.py checks on the card
    ha, hb, hc = cs.halfway_triples().numpy()
    a, b, c = (np.concatenate([v, h]) for v, h in ((a, ha), (b, hb), (c, hc)))
    got = fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    want = np.array([_nearest32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                     for x, y, z in zip(a, b, c)], dtype=np.float32)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the halfway cases are the ones a float64 sum then a cast gets wrong
    naive = (ha.astype(np.float64) * hb + hc).astype(np.float32)
    assert (_bits(naive) != _bits(got[-len(ha):])).all()


def test_fma32_equals_a_times_b_plus_c_where_both_are_exact():
    """Small integers and dyadic fractions: the product and the sum are exact
    in float32, so the fused and the twice-rounded forms agree; Python
    scalars are taken as float32."""
    rng = np.random.default_rng(1)
    a, b, c = (rng.integers(-2048, 2048, 5000).astype(np.float32) / 8 for _ in range(3))
    ta, tb, tc = (torch.from_numpy(v) for v in (a, b, c))
    np.testing.assert_array_equal(_bits(fma32(ta, tb, tc)), _bits(ta * tb + tc))
    np.testing.assert_array_equal(_bits(fma32(ta, 0.75, 0.5)), _bits(ta * 0.75 + 0.5))
    # inf and NaN pass through as in a*b + c
    x = torch.tensor([np.inf, -np.inf, np.nan, 1.0])
    y = fma32(x, torch.tensor(2.0), torch.tensor([1.0, 1.0, 1.0, np.inf]))
    assert y[0] == np.inf and y[1] == -np.inf and torch.isnan(y[2]) and y[3] == np.inf


@pytest.mark.parametrize("form", ["exp", "bilateral_range", "bilateral_spatial"])
def test_exp32_is_xlas_exp(form):
    """exp32 against jitted jnp.exp: alone, and as the JAX package's bilateral
    filter takes it (-(d^2) / (2 sigma^2), the division a product), over the
    whole range, the clamps included."""
    rng = np.random.default_rng(2)
    if form == "exp":
        x = np.concatenate([rng.uniform(-100, 100, 200000),
                            [-1e30, -88.0, -87.80000305175781, 0.0, 88.80000305175781, 1e30]])
        x = x.astype(np.float32)
        ref = jax.jit(jnp.exp)(x)
        got = exp32(torch.from_numpy(x))
    elif form == "bilateral_range":
        x = (rng.standard_normal(300000) * rng.choice([0.01, 0.1, 1.0, 5.0], 300000))
        x = x.astype(np.float32)
        ref = jax.jit(lambda d: jnp.exp(-(d ** 2) / (2.0 * 0.1 ** 2)))(x)
        d = torch.from_numpy(x)
        got = exp32((d * -d) * 50.0)
    else:
        o = np.arange(-4, 5, dtype=np.float32)
        ref = jax.jit(lambda o: jnp.exp(-(o[None] ** 2 + o[:, None] ** 2) / (2.0 * 2.0 ** 2)))(o)
        t = torch.from_numpy(o)
        got = exp32(-(t[None] * t[None] + t[:, None] * t[:, None]) * 0.125)
    np.testing.assert_array_equal(_bits(got), _bits(ref))


@pytest.mark.parametrize("s", [0.9, 2.0 * 0.1 ** 2, 2.0 * 2.0 ** 2, 3.6])
def test_recip_const_is_xlas_division_by_a_constant(s):
    """The constants the kernels take as arguments (K12's 1 / step, K9's
    1 / (2 sigma_r^2) and 1 / (2 sigma_d^2)): x times recip_const(s) is XLA's
    jitted x / s to the bit, and div_const is that product."""
    x = np.random.default_rng(3).normal(size=4096).astype(np.float32) * 100
    want = np.asarray(jax.jit(lambda v: v / s)(jnp.asarray(x)))
    got = (torch.from_numpy(x) * recip_const(s)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert torch.equal(div_const(torch.from_numpy(x), s), torch.from_numpy(got))


def test_sqrt32_is_correctly_rounded():
    x = np.random.default_rng(3).uniform(0, 4, 300000).astype(np.float32)
    np.testing.assert_array_equal(_bits(sqrt32(torch.from_numpy(x))), _bits(np.sqrt(x)))


@pytest.mark.parametrize("taps", [81, 121])
def test_block_sum_is_xlas_order(taps):
    """The depth chain's window sums: jitted jnp.sum over a minor axis of 81
    (the bilateral filter's) and 121 elements, to the bit."""
    x = np.random.default_rng(4).standard_normal((2, 40, 48, taps)).astype(np.float32)
    ref = jax.jit(lambda a: jnp.sum(a, axis=-1))(x)
    got = block_sum(list(torch.from_numpy(x).movedim(-1, 0)))
    np.testing.assert_array_equal(_bits(got), _bits(ref))


def _jax_setup(cfg):
    """The JAX package's set-up of find_surface_crossings
    (spsg_tpu/ops/raycast.py:438-448), jitted with its arrays as arguments."""

    def setup(valid, view, intr):
        origin, direction, cam_z = jr._camera_rays(view, intr, cfg.width, cfg.height)
        t_start = cfg.depth_min / cam_z
        t_end = cfg.depth_max / cam_z
        lo, hi = jr._valid_bounds(valid)
        t_enter, t_exit = jr._ray_aabb(origin, direction, lo, hi)
        skip = jnp.maximum(jnp.floor((t_enter - t_start) / cfg.ray_increment), 0.0)
        t0 = t_start + skip * cfg.ray_increment
        t_stop = jnp.minimum(t_end, t_exit + cfg.ray_increment)
        return origin, direction, cam_z, t0, t_stop

    return jax.jit(setup)


@pytest.mark.parametrize("dims,image", [((16, 16, 16), (48, 32)), ((32, 32, 32), (96, 64)),
                                        ((64, 32, 32), (160, 128))])
def test_march_setup_is_the_jax_packages_to_the_bit(dims, image):
    b = jax_synthetic.make_chunk_batch(2, dims, image_dims=image, seed=1, with_frames=True)
    valid = np.abs(b["input"][..., 0]) < 3.0
    kw = dict(width=image[0], height=image[1], depth_min=0.1 / 0.02, depth_max=6.0 / 0.02,
              ray_increment=0.9, thresh_sample_dist=50.5 * 0.9)
    ref = _jax_setup(jr.RaycastConfig(**kw))(valid, b["images_view"], b["images_intrinsic"])
    got = R.march_setup(torch.from_numpy(valid), torch.from_numpy(b["images_view"]),
                        torch.from_numpy(b["images_intrinsic"]), R.RaycastConfig(**kw))
    for name, g, r in zip(R.MarchSetup._fields, got, ref):
        np.testing.assert_array_equal(_bits(g), _bits(r), err_msg=name)
