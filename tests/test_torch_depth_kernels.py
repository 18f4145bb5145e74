"""The depth chain's kernels (K9-K11, spsg_tpu_torch/ops/csrc/depth.cu) and the
ray set-up's (K12, csrc/raycast.cu) on the CPU, where they cannot run: the
dispatch (a CPU tensor takes the plain version and builds nothing), the
kernels' designs written out in numpy / torch against the plain versions to
the bit (K10's selection by counting, the fill's round schedule with its flag
left on the card, K9's block order, K11's neighbours, K12's integer box and
per-ray slab test), the binding of an older raycaster library, and the plain
versions against the JAX package's to the bit. On the card chip_smoke.py holds
each kernel against its plain version."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.data import synthetic as jax_synthetic
from spsg_tpu.ops import depth as JD
from spsg_tpu.ops import raycast as jr
from spsg_tpu_torch.ops import _build, xla_arith
from spsg_tpu_torch.ops import depth as D
from spsg_tpu_torch.ops import raycast as R

import torch_port_helpers as H


def _bits(a):
    return np.asarray(a).view(np.int32)


@pytest.fixture(scope="module")
def frames():
    b = jax_synthetic.make_chunk_batch(2, (16, 16, 16), image_dims=(48, 32), seed=2,
                                       with_frames=True)
    return b["images_depth"], b["images_intrinsic"]


def _holes(depth, seed, frames_with=(0, 1)):
    d = depth.copy()
    rng = np.random.default_rng(seed)
    for b in frames_with:
        y, x = rng.integers(4, 22), rng.integers(4, 36)
        d[b, y:y + 6, x:x + 8] = 0.0
        d[b, rng.integers(0, d.shape[1], 25), rng.integers(0, d.shape[2], 25)] = 0.0
    return d


def _ties(shape, seed):
    """Depths on a 1 mm grid with a few values, so the windows hold many ties
    in millimetres, and holes."""
    rng = np.random.default_rng(seed)
    d = (1.0 + 0.001 * rng.integers(0, 4, shape)).astype(np.float32)
    d[rng.random(shape) < 0.35] = 0.0
    return d


# --- dispatch ---------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions_and_build_nothing(frames, monkeypatch):
    """Every public function of the slice on CPU tensors gives its plain
    version's bits, with the build refused: nothing is compiled or loaded on
    the CPU, and no launch is counted."""
    def refuse(*a, **kw):
        raise AssertionError("a kernel was built on the CPU path")

    monkeypatch.setattr(_build, "load", refuse)
    D.reset_launch_counts()
    R.reset_launch_counts()
    depth = H.t(_holes(frames[0], 1))
    intr = H.t(frames[1])
    pairs = [(D.bilateral_filter(depth), D.bilateral_filter_plain(depth)),
             (D.median_fill(depth), D.median_fill_plain(depth)),
             (D.unproject_normals(depth, intr), D.unproject_normals_plain(depth, intr))]
    pairs += list(zip(D.fill_depth_holes(depth, 6), D.fill_depth_holes_plain(depth, 6)))
    for got, want in pairs:
        assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))
    valid = torch.rand(2, 16, 16, 16, generator=torch.Generator().manual_seed(0)) < 0.1
    view = torch.eye(4).repeat(2, 1, 1)
    cfg = R.RaycastConfig(width=48, height=32)
    for got, want in zip(R.march_setup(valid, view, intr, cfg),
                         R.march_setup_plain(valid, view, intr, cfg)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert not D._libs and "depth" not in _build._LIBS
    assert not any(D.launch_counts.values()) and not any(R.launch_counts.values())
    with pytest.raises(ValueError, match="unsupported device"):
        D.bilateral_filter(torch.zeros(1, 4, 4, device="meta"))


class _Entry:
    restype = None
    argtypes = None


def test_bind_takes_a_library_without_the_setup_entry():
    """An older raycast.cu (no spsg_raycast_setup) still binds, as one without
    K7's hopping entry does (chip_smoke.py --baseline-raycast-source); the
    current one binds K12 with its 20 arguments."""
    core = ("spsg_raycast_march", "spsg_raycast_shade", "spsg_raycast_scatter")
    old = types.SimpleNamespace(**{n: _Entry() for n in core + ("spsg_raycast_occ_hop",)})
    assert R._bind(old) is old and not hasattr(old, "spsg_raycast_setup")
    assert old.spsg_raycast_occ_hop.argtypes is not None
    new = types.SimpleNamespace(**{n: _Entry() for n in core + ("spsg_raycast_setup",)})
    R._bind(new)
    assert len(new.spsg_raycast_setup.argtypes) == 20


# --- K10: the upper median by counting --------------------------------------------

def _median_by_counting(depth, r=5):
    """K10's round written out in numpy: per hole, n valid pixels in its
    window, pick = min((n + 1) // 2, max(n - 1, 0)), and the millimetres m_j of
    the first valid neighbour (in window order) with less_j <= pick <
    less_or_equal_j; the hole takes 0.001f * m_j (0 where there is none)."""
    B, Hh, W = depth.shape
    mm = np.where(depth != 0, np.floor(xla_arith.fma32(torch.from_numpy(depth), 1000.0,
                                                       0.5).numpy()), np.inf)
    mm = np.pad(mm, ((0, 0), (r, r), (r, r)), constant_values=np.inf).astype(np.float32)
    dp = np.pad(depth, ((0, 0), (r, r), (r, r)))
    out = depth.copy()
    for b, y, x in zip(*np.nonzero(depth == 0)):
        mwin = mm[b, y:y + 2 * r + 1, x:x + 2 * r + 1].reshape(-1)
        ok = dp[b, y:y + 2 * r + 1, x:x + 2 * r + 1].reshape(-1) != 0
        n = int(ok.sum())
        pick = min((n + 1) // 2, max(n - 1, 0))
        val = np.float32(np.inf)
        for m in mwin[ok & np.isfinite(mwin)]:
            if (mwin < m).sum() <= pick < (mwin <= m).sum():
                val = m
                break
        out[b, y, x] = np.float32(0.001) * val if n > 0 and np.isfinite(val) else 0.0
    return out


@pytest.mark.parametrize("case", ["ties", "frames"])
def test_selection_by_counting_is_the_sorted_median(frames, case):
    depth = _ties((2, 24, 30), 3) if case == "ties" else _holes(frames[0], 4)
    want = D.median_fill_plain(H.t(depth)).numpy()
    np.testing.assert_array_equal(_bits(_median_by_counting(depth)), _bits(want))
    if case == "ties":  # the windows do hold ties, and some holes take a value
        filled = (depth == 0) & (want != 0)
        assert filled.sum() > 50


# --- the fill's round schedule ----------------------------------------------------

def _fill_on_the_card(depth, max_iters):
    """spsg_depth_fill's schedule in torch: K9 on every frame and the frames'
    hole flags, round 0 from it (a frame without holes from its own depth),
    then rounds 1..max_iters, each run only where the previous round left its
    flag set (written as a select, never read back), ping-ponging between two
    buffers; the finish picks the buffer of the last round that ran. Returns
    (filled, all_valid, rounds that ran after round 0)."""
    had = (depth == 0).reshape(depth.shape[0], -1).any(dim=-1)[:, None, None]
    bufs = [None, D.bilateral_filter_plain(depth)]
    bufs[0] = D.median_fill_plain(torch.where(had, bufs[1], depth))
    left = [bool((bufs[0] == 0).any())]
    for k in range(1, max_iters + 1):
        src = bufs[(k - 1) % 2]
        run = left[k - 1]
        if run:
            bufs[k % 2] = D.median_fill_plain(src)
        left.append(run and bool((bufs[k % 2] == 0).any()))
    rounds = 0
    while rounds < max_iters and left[rounds]:
        rounds += 1
    out = torch.where(had, bufs[rounds % 2], depth)
    return out, ~(out.reshape(out.shape[0], -1) == 0).any(dim=-1), rounds


@pytest.mark.parametrize("case,max_iters", [("holes", 40), ("one_frame", 40),
                                            ("unfillable", 6), ("cap", 2), ("none", 5),
                                            ("all_but_one", 40), ("zero_iters", 0)])
def test_fill_schedule_gives_the_loops_output_and_rounds(frames, case, max_iters,
                                                         monkeypatch):
    depth = frames[0]
    if case in ("holes", "cap"):
        depth = _holes(depth, 5)
    elif case == "one_frame":  # frame 1 without holes beside frame 0 with them
        depth = _holes(np.where(depth == 0, 1.0, depth).astype(np.float32), 6, (0,))
    elif case == "unfillable":  # frame 1 all holes: no neighbour ever in reach
        depth = _holes(depth, 7, (0,))
        depth[1] = 0.0
    elif case == "all_but_one":
        depth = _holes(depth, 8, (0,))
        depth[1] = 0.0
        depth[1, 3, 4] = 2.5
    elif case == "none":
        depth = np.where(depth == 0, 1.0, depth).astype(np.float32)
    else:
        depth = _holes(depth, 9)
    t = H.t(depth)
    calls = []
    real = D.median_fill_plain
    monkeypatch.setattr(D, "median_fill_plain", lambda *a: calls.append(1) or real(*a))
    want, want_ok = D.fill_depth_holes_plain(t, max_iters)
    monkeypatch.setattr(D, "median_fill_plain", real)
    got, ok, rounds = _fill_on_the_card(t, max_iters)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
    np.testing.assert_array_equal(ok.numpy(), want_ok.numpy())
    if case == "none":  # the plain fill returns at once, the card's changes nothing
        assert not calls and torch.equal(got, t)
    else:  # the rounds after round 0 that ran: the plain loop's
        assert rounds == len(calls) - 1
    if case in ("unfillable", "cap"):
        assert rounds == max_iters
    if case == "unfillable":
        assert list(ok.numpy()) == [True, False]
    if case == "one_frame":
        np.testing.assert_array_equal(got.numpy()[1], depth[1])
    if case == "all_but_one":
        assert rounds < max_iters and bool(ok.all())


# --- K9, K11, K12 written out ------------------------------------------------------

def _bilateral_by_taps(depth, sigma_d=2.0, sigma_r=0.1):
    """K9's loop: taps in row-major window order, a new block of the sum where
    t == 0 or (t + front) % 32 == 0, the first block's sum taken as it is and
    each next one added."""
    r = 4
    k, n = 2 * r + 1, (2 * r + 1) ** 2
    front = ((n + 31) // 32 * 32 - n) // 2
    ws = D._spatial_weights(sigma_d, "cpu")
    scale = xla_arith.recip_const(2.0 * sigma_r ** 2)
    Hh, W = depth.shape[1:]
    pad = torch.nn.functional.pad(depth, (r, r, r, r))
    wsum = num = wpart = npart = None
    for t in range(n):
        v = pad[:, t // k:t // k + Hh, t % k:t % k + W]
        d = v - depth
        w = torch.where(v != 0, ws[t] * xla_arith.exp32((d * -d) * scale), 0.0)
        if t == 0 or (t + front) % 32 == 0:
            if t > 0:
                wsum = wpart if wsum is None else wsum + wpart
                num = npart if num is None else num + npart
            wpart, npart = w, w * v
        else:
            wpart, npart = wpart + w, npart + w * v
    wsum, num = wsum + wpart, num + npart
    o = torch.where(wsum > 0, num / torch.where(wsum < 1e-12, 1e-12, wsum), 0.0)
    return torch.where(depth != 0, o, 0.0)


def _normals_by_neighbours(depth, intr):
    """K11: each interior pixel from its own four neighbours (no roll)."""
    B, Hh, W = depth.shape
    out = torch.zeros(B, Hh, W, 3)
    pts = D.depth_to_camera_space(depth, intr)
    c = pts[:, 1:-1, 1:-1]
    pc, mc, cp, cm = pts[:, 2:, 1:-1], pts[:, :-2, 1:-1], pts[:, 1:-1, 2:], pts[:, 1:-1, :-2]
    a, b = pc - mc, cp - cm
    f = xla_arith.fma32
    n = torch.stack([f(a[..., 1], b[..., 2], -(a[..., 2] * b[..., 1])),
                     f(a[..., 2], b[..., 0], -(a[..., 0] * b[..., 2])),
                     f(a[..., 0], b[..., 1], -(a[..., 1] * b[..., 0]))], dim=-1)
    l2 = f(n[..., 2], n[..., 2], f(n[..., 1], n[..., 1], n[..., 0] * n[..., 0]))[..., None]
    nl = -xla_arith.sqrt32(torch.where(l2 < 1e-24, 1e-24, l2))
    some = (c[..., 0] != 0) | (pc[..., 0] != 0) | (cp[..., 0] != 0) | (mc[..., 0] != 0) | (
        cm[..., 0] != 0)
    out[:, 1:-1, 1:-1] = torch.where((l2 > 0) & some[..., None], n / nl, 0.0)
    return out


def test_bilateral_and_normals_written_as_the_kernels_are(frames):
    depth = H.t(_holes(frames[0], 10))
    intr = H.t(frames[1])
    np.testing.assert_array_equal(_bits(_bilateral_by_taps(depth).numpy()),
                                  _bits(D.bilateral_filter_plain(depth).numpy()))
    np.testing.assert_array_equal(_bits(_normals_by_neighbours(depth, intr).numpy()),
                                  _bits(D.unproject_normals_plain(depth, intr).numpy()))


def _setup_per_ray(valid, view, intr, cfg):
    """K12 written out: the box from integer bounds (INT_MAX-like and -1 where
    no voxel is valid), the camera ray with fma(1, 1, .), the slab test axis by
    axis with NaN-propagating min / max."""
    B, Z, Y, X = valid.shape
    f = xla_arith.fma32
    lo = torch.empty(B, 3)
    hi = torch.empty(B, 3)
    for b in range(B):
        idx = torch.nonzero(valid[b])
        for a, n in enumerate((X, Y, Z)):
            col = idx[:, 2 - a]
            lo[b, a] = float(min(int(col.min()) if len(col) else 2 ** 31 - 1, n)) - 1.5
            hi[b, a] = float(int(col.max()) if len(col) else -1) + 1.5
    p = torch.arange(cfg.width * cfg.height)
    fx, fy, mx, my = (intr[:, i][:, None] for i in range(4))
    cx = ((p % cfg.width).float() - mx) / fx
    cy = (torch.div(p, cfg.width, rounding_mode="floor").float() - my) / fy
    cn = xla_arith.sqrt32(f(torch.ones_like(cx), 1.0, f(cy, cy, cx * cx)))
    c = (cx / cn, cy / cn, torch.ones_like(cn) / cn)
    m = view
    w = [f(m[:, i, 2, None], c[2], f(m[:, i, 1, None], c[1], m[:, i, 0, None] * c[0]))
         for i in range(3)]
    wn = xla_arith.sqrt32(f(w[2], w[2], f(w[1], w[1], w[0] * w[0])))
    d = [wi / wn for wi in w]
    enter = exit_ = None
    for a in range(3):
        o = m[:, a, 3, None]
        inv = torch.where(d[a].abs() > 1e-9, torch.ones_like(d[a]) / d[a], 1e12)
        ta, tb = (lo[:, a, None] - o) * inv, (hi[:, a, None] - o) * inv
        mn, mx_ = torch.minimum(ta, tb), torch.maximum(ta, tb)
        enter = mn if enter is None else torch.maximum(enter, mn)
        exit_ = mx_ if exit_ is None else torch.minimum(exit_, mx_)
    t_start = torch.full_like(c[2], cfg.depth_min) / c[2]
    t_end = torch.full_like(c[2], cfg.depth_max) / c[2]
    skip = torch.floor((enter - t_start) * xla_arith.recip_const(cfg.ray_increment))
    skip = torch.where(skip < 0, 0.0, skip)
    return (m[:, :3, 3], torch.stack(d, -1), c[2], f(skip, cfg.ray_increment, t_start),
            torch.minimum(t_end, exit_ + cfg.ray_increment))


@pytest.mark.parametrize("grid", ["input", "empty", "near_axis"])
def test_setup_written_as_the_kernel_is(grid):
    b = jax_synthetic.make_chunk_batch(2, (16, 16, 16), image_dims=(48, 32), seed=3,
                                       with_frames=True)
    valid = torch.from_numpy(np.abs(b["input"][..., 0]) < 3.0)
    view, intr = H.t(b["images_view"]), H.t(b["images_intrinsic"])
    if grid == "empty":
        valid[1] = False
    elif grid == "near_axis":
        # a camera along +z whose pixel column 24 has a direction x within 1e-9 of 0
        view = torch.eye(4).repeat(2, 1, 1)
        view[:, :3, 3] = torch.tensor([8.0, 8.0, -20.0])
        intr = torch.tensor([[40.0, 40.0, 24.0, 16.0]] * 2)
    cfg = R.RaycastConfig(width=48, height=32)
    want = R.march_setup_plain(valid, view, intr, cfg)
    got = _setup_per_ray(valid, view, intr, cfg)
    for name, g, w in zip(R.MarchSetup._fields, got, want):
        np.testing.assert_array_equal(_bits(g.contiguous().numpy()), _bits(w.numpy()),
                                      err_msg=name)
    if grid == "near_axis":
        assert (want.direction[..., 0].abs() <= 1e-9).any()
    if grid == "empty":
        assert torch.isfinite(want.t0).all()


# --- the plain versions against the JAX package's, to the bit ---------------------

@pytest.mark.parametrize("seed", [11, 12])
def test_plain_versions_are_the_jax_packages_to_the_bit(frames, seed):
    depth = _holes(frames[0], seed)
    intr = frames[1]
    t = H.t(depth)
    # jitted, as the JAX package runs them (inside its jitted depth_to_normals):
    # op by op, XLA fuses nothing and its bits are another arithmetic's
    np.testing.assert_array_equal(_bits(D.bilateral_filter_plain(t).numpy()),
                                  _bits(jax.jit(JD.bilateral_filter)(jnp.asarray(depth))))
    np.testing.assert_array_equal(_bits(D.median_fill_plain(t).numpy()),
                                  _bits(jax.jit(JD.median_fill)(jnp.asarray(depth))))
    # both frames have holes: the per-frame and the batch-wide decisions agree
    jn, jf, jok = JD.depth_to_normals(jnp.asarray(depth), jnp.asarray(intr), 8)
    tf, tok = D.fill_depth_holes_plain(t, 8)
    np.testing.assert_array_equal(_bits(tf.numpy()), _bits(jf))
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    tn = D.unproject_normals_plain(tf, H.t(intr)).numpy()
    np.testing.assert_array_equal(_bits(tn), _bits(jn))


def test_march_setup_plain_is_the_jax_packages_to_the_bit():
    b = jax_synthetic.make_chunk_batch(2, (16, 16, 16), image_dims=(48, 32), seed=4,
                                       with_frames=True)
    valid = np.abs(b["input"][..., 0]) < 3.0
    kw = dict(width=48, height=32, depth_min=0.1 / 0.02, depth_max=6.0 / 0.02,
              ray_increment=0.9, thresh_sample_dist=50.5 * 0.9)
    cfg = jr.RaycastConfig(**kw)

    def setup(valid, view, intr):
        origin, direction, cam_z = jr._camera_rays(view, intr, cfg.width, cfg.height)
        t_start = cfg.depth_min / cam_z
        t_end = cfg.depth_max / cam_z
        lo, hi = jr._valid_bounds(valid)
        t_enter, t_exit = jr._ray_aabb(origin, direction, lo, hi)
        skip = jnp.maximum(jnp.floor((t_enter - t_start) / cfg.ray_increment), 0.0)
        return (origin, direction, cam_z, t_start + skip * cfg.ray_increment,
                jnp.minimum(t_end, t_exit + cfg.ray_increment))

    ref = jax.jit(setup)(valid, b["images_view"], b["images_intrinsic"])
    got = R.march_setup_plain(torch.from_numpy(valid), H.t(b["images_view"]),
                              H.t(b["images_intrinsic"]), R.RaycastConfig(**kw))
    for name, g, r in zip(R.MarchSetup._fields, got, ref):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(r), err_msg=name)
