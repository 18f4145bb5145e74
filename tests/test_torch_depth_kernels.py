"""The depth chain's kernels (K9-K11, spsg_tpu_torch/ops/csrc/depth.cu) and the
ray set-up's (K12, csrc/raycast.cu) on the CPU, where they cannot run: the
dispatch (a CPU tensor takes the plain version and builds nothing), the
kernels' designs written out in numpy / torch against the plain versions to
the bit (K10's selection by counting, the fill's round schedule with its flag
left on the card, K9's block order, K11's neighbours and its 32x8 tiles with
their apron and staged rows, the fill followed by K11 as the fill's launch
runs it, K12's integer box and per-ray slab test and its two-launch schedule
of partial boxes and parked rays), the binding of older and newer raycaster
libraries, and the plain versions against the JAX package's to the bit. On the card chip_smoke.py holds
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


def _checkerboard(depth):
    """Holes on every other pixel of a band of rows: each hole's diagonal
    neighbours are holes too, so a round that read a value it wrote itself
    would fill them from each other."""
    d = depth.copy()
    yy, xx = np.mgrid[:d.shape[1], :d.shape[2]]
    d[:, ((yy + xx) % 2 == 0) & (yy >= 4) & (yy < 28)] = 0.0
    return d


def _negative_nan(depth, seed):
    """Holes, negative depths on a band of 16 rows (3 % of them -inf, 60 % of
    a patch, where a window's median is -inf; windows of negative millimetres
    only, whose keys' low bits are ones), NaN pixels of either sign (8 % of
    the frame, 60 % of a band, where a window's median falls among its NaNs):
    the selection's key must order them as torch.sort does."""
    d = _holes(depth, seed)
    rng = np.random.default_rng(seed)
    d[:, 8:24] *= -1.0
    d[:, 8:24][rng.random((d.shape[0], 16, d.shape[2])) < 0.03] = -np.inf
    d[:, 12:18, 30:40][rng.random((d.shape[0], 6, 10)) < 0.6] = -np.inf
    nan = rng.random(d.shape) < 0.08
    nan[:, 20:26, 8:30] = rng.random((d.shape[0], 6, 22)) < 0.6
    d[nan] = np.nan
    d[nan & (rng.random(d.shape) < 0.5)] = -np.float32(np.nan)
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
    filled, ok = D.fill_depth_holes_plain(depth, 6)
    pairs += list(zip(D.depth_to_normals(depth, intr, 6),
                      (D.unproject_normals_plain(filled, intr), filled, ok)))
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


def test_bind_takes_the_two_launch_setup_entry():
    """The two-launch K12 (spsg_raycast_setup_pdl, 21 arguments: the
    partials' scratch and its length beside the older entry's) binds, alone
    or beside an older entry."""
    core = ("spsg_raycast_march", "spsg_raycast_shade", "spsg_raycast_scatter")
    lib = types.SimpleNamespace(**{n: _Entry() for n in core + ("spsg_raycast_setup_pdl",)})
    R._bind(lib)
    assert len(lib.spsg_raycast_setup_pdl.argtypes) == 21
    assert lib.spsg_raycast_setup_pdl.argtypes[4] is R.ctypes.c_int
    both = types.SimpleNamespace(**{n: _Entry() for n in core + ("spsg_raycast_setup",
                                                                  "spsg_raycast_setup_pdl")})
    R._bind(both)
    assert len(both.spsg_raycast_setup.argtypes) == 20
    assert len(both.spsg_raycast_setup_pdl.argtypes) == 21


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


def _order_key(m):
    """K10's key of a float32: its bits with the sign bit set where it is
    positive, all bits flipped where it is negative, 0xffffffff for every NaN;
    the keys' unsigned order is torch.sort's order of the floats."""
    u = m.astype(np.float32).view(np.uint32).astype(np.uint64)
    key = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    return np.where(np.isnan(m), 0xFFFFFFFF, key).astype(np.uint64)


def _key_value(key):
    bits = np.where(key & 0x80000000, key & 0x7FFFFFFF, ~key & 0xFFFFFFFF)
    return bits.astype(np.uint32).view(np.float32)


def _median_by_warp(depth, holes, r=5, slots=4):
    """K10's selection, a warp a hole, written out for the flat indices
    ``holes`` of the frames ``depth`` (B, H, W): lane l holds tap t = l + 32 s
    of the window in slot s (32 slots-many places; past the window's
    (2r+1)^2 taps +inf), the millimetres of the valid pixels, +inf at holes and
    outside the image, as keys. Warp sums: the valid pixels n, the finite keys
    and the -inf keys; pick = min((n + 1) // 2, max(n - 1, 0)). Where pick
    falls among the -inf keys or past the finite ones the hole stays 0; else
    the finite key of rank pick - (-inf keys) by a radix select over the finite
    keys: the bits where they all agree (their AND and OR, warp sums) are the
    result's, the others from the highest to the lowest where they differ:
    count the candidates (the finite keys that agree with the result on the
    decided bits) with a 0 at the bit and go to the half that holds the rank.
    The hole takes 0.001f * the selected value."""
    B, Hh, W = depth.shape
    k = 2 * r + 1
    mm = np.where(depth != 0, np.floor(xla_arith.fma32(torch.from_numpy(depth), 1000.0,
                                                       0.5).numpy()), np.inf)
    mm = np.pad(mm.astype(np.float32), ((0, 0), (r, r), (r, r)), constant_values=np.inf)
    ok = np.pad(depth != 0, ((0, 0), (r, r), (r, r)))
    b, yx = np.divmod(np.asarray(holes, np.int64), Hh * W)
    y, x = np.divmod(yx, W)
    t = np.arange(32)[:, None] + 32 * np.arange(slots)[None, :]  # (lane, slot)
    tap = (t < k * k).reshape(-1)
    ty, tx = (t // k).reshape(-1) % k, (t % k).reshape(-1)
    yy, xx = y[:, None] + ty, x[:, None] + tx
    m = np.where(tap, mm[b[:, None], yy, xx], np.float32(np.inf)).astype(np.float32)
    keys = _order_key(m)
    fin = np.isfinite(m)
    nvalid = (tap & ok[b[:, None], yy, xx]).sum(axis=1)
    nfin, nlow = fin.sum(axis=1), (m == -np.inf).sum(axis=1)
    pick = np.minimum((nvalid + 1) // 2, np.maximum(nvalid - 1, 0))
    found = (pick >= nlow) & (pick < nlow + nfin)
    rank = pick - nlow
    kand = np.bitwise_and.reduce(np.where(fin, keys, 0xFFFFFFFF).astype(np.uint64), axis=1)
    kor = np.bitwise_or.reduce(np.where(fin, keys, 0).astype(np.uint64), axis=1)
    diff = kand ^ kor
    bits = (diff[:, None] >> np.arange(32, dtype=np.uint64)) & 1
    top = np.where(diff != 0, 31 - np.argmax(bits[:, ::-1], axis=1), -1)
    bottom = np.where(diff != 0, np.argmax(bits, axis=1), 0)
    decided = np.where(top >= 0, (0xFFFFFFFF << (top + 1)) & 0xFFFFFFFF, 0xFFFFFFFF)
    decided = decided.astype(np.uint64)
    res = kand & decided
    for bit in range(31, -1, -1):
        on = (bit <= top) & (bit >= bottom)
        bm = np.uint64(1 << bit)
        cand = fin & ((keys & decided[:, None]) == res[:, None])
        zeros = (cand & ((keys & bm) == 0)).sum(axis=1)
        go = on & (rank >= zeros)
        rank = np.where(go, rank - zeros, rank)
        res = np.where(go, res | bm, res)
        decided = np.where(on, decided | bm, decided)
    below = np.where(diff != 0, (np.uint64(1) << bottom.astype(np.uint64)) - np.uint64(1), 0)
    res = res | (kand & below.astype(np.uint64))
    val = _key_value(res)
    return np.where(found, np.float32(0.001) * val, np.float32(0.0)).astype(np.float32)


@pytest.mark.parametrize("case", ["ties", "frames", "checkerboard", "negative_nan"])
def test_selection_by_warp_is_the_sorted_median(frames, case):
    """K10's single round: the frame copied, its holes listed, each hole's
    median selected as the kernel's warp does; the plain version's bits."""
    depth = {"ties": lambda: _ties((2, 24, 30), 3), "frames": lambda: _holes(frames[0], 4),
             "checkerboard": lambda: _checkerboard(frames[0]),
             "negative_nan": lambda: _negative_nan(frames[0], 13)}[case]()
    want = D.median_fill_plain(H.t(depth)).numpy()
    holes = np.flatnonzero(depth == 0)
    got = depth.copy().reshape(-1)
    got[holes] = _median_by_warp(depth, holes)
    np.testing.assert_array_equal(_bits(got.reshape(depth.shape)), _bits(want))
    filled = (depth == 0) & (want != 0)
    assert filled.sum() > 50
    if case == "negative_nan":  # windows with negative millimetres and NaNs both fill holes
        assert (want[filled] < 0).any() and np.isnan(depth).sum() > 200


# --- the fill's round schedule ----------------------------------------------------

def _fill_on_the_card(depth, max_iters, seed=0):
    """spsg_depth_fill's schedule over hole lists: K9 writes the filtered
    frames into both buffers, flags the frames with holes (had) and lists
    round 0's holes (every pixel it leaves at 0). Round k reads buf[(k + 1) %
    2], writes buf[k % 2] and walks its list, skipping the entries of frames
    without holes: a pixel that round k - 1 filled (not 0 in the buffer read)
    is copied, a pixel still a hole goes onto round k + 1's list and takes its
    median (:func:`_median_by_warp`, from the buffer read only); the round's
    flag is set where a median is 0. Round k + 1 runs where that flag is set
    and k < max_iters. The lists come in a seeded random order (on the card
    their order changes from run to run), and after every round both buffers
    are checked to hold every pixel that is not on the next list (the
    invariant). The output: the last round's buffer, a frame without holes
    its own depth. Returns (filled, all_valid, rounds that ran after round
    0)."""
    rng = np.random.default_rng(seed)
    B, Hh, W = depth.shape
    had = (depth == 0).reshape(B, -1).any(dim=-1)
    filtered = D.bilateral_filter_plain(depth).reshape(-1)
    bufs = [filtered.clone(), filtered.clone()]
    todo = rng.permutation(np.flatnonzero(filtered.numpy() == 0))
    k = 0
    while True:
        src, dst = bufs[(k + 1) % 2], bufs[k % 2]
        todo = todo[had.numpy()[todo // (Hh * W)]]
        v = src[todo]
        dst[todo[(v != 0).numpy()]] = v[v != 0]
        holes = todo[(v == 0).numpy()]
        med = torch.from_numpy(_median_by_warp(src.reshape(B, Hh, W).numpy(), holes))
        dst[holes] = med
        todo = rng.permutation(holes)
        off = torch.ones(B * Hh * W, dtype=torch.bool)
        off[torch.from_numpy(todo)] = False
        assert torch.equal(bufs[0][off].view(torch.int32), bufs[1][off].view(torch.int32))
        if k == max_iters or not bool((med == 0).any()):
            break
        k += 1
    out = torch.where(had[:, None, None], bufs[k % 2].reshape(B, Hh, W), depth)
    return out, ~(out.reshape(B, -1) == 0).any(dim=-1), k


@pytest.mark.parametrize("case,max_iters", [("holes", 40), ("one_frame", 40),
                                            ("unfillable", 6), ("cap", 2), ("none", 5),
                                            ("all_but_one", 40), ("zero_iters", 0),
                                            ("checkerboard", 40), ("negative_nan", 40)])
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
    elif case == "checkerboard":
        depth = _checkerboard(depth)
    elif case == "negative_nan":
        depth = _negative_nan(depth, 14)
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


# --- K12 as two launches, K11 as a tile -----------------------------------------

_INT_MAX = 2 ** 31 - 1


def _nonzero_bytes(u):
    """K12's mask of a uint32 word: bit 7 of each byte set where that byte is
    not 0."""
    u = np.asarray(u, np.uint32)
    return (((u & np.uint32(0x7F7F7F7F)) + np.uint32(0x7F7F7F7F)) | u) & np.uint32(0x80808080)


def _first_last_byte(words):
    """The first and last nonzero byte of a 16-byte run from its four words'
    masks, as K12 reads them (or None where the run is all 0)."""
    m = [int(x) for x in _nonzero_bytes(words)]
    lo, hi = m[0] | m[1] << 32, m[2] | m[3] << 32
    if not lo | hi:
        return None
    first = ((lo & -lo).bit_length() - 1) >> 3 if lo else 8 + (((hi & -hi).bit_length() - 1) >> 3)
    last = 8 + ((hi.bit_length() - 1) >> 3) if hi else (lo.bit_length() - 1) >> 3
    return first, last


def _partials(valid, blocks, threads):
    """K12's first kernel: block r of a batch row's ``blocks`` takes the units
    u = r * threads + tid + k * blocks * threads of the row (16-byte runs where
    X % 16 == 0, else rows), its threads' boxes reduced to one partial (least
    x, y, z; largest x, y, z; INT_MAX / -1 where it saw no valid voxel).
    Returns (B, 6, blocks) ints."""
    B, Z, Y, X = valid.shape
    part = np.empty((B, 6, blocks), np.int64)
    part[:, :3], part[:, 3:] = _INT_MAX, -1
    vec = X % 16 == 0
    for b in range(B):
        g = valid[b].numpy().astype(np.uint8)
        if vec:
            units = g.reshape(Z * Y * X // 16, 16).view(np.uint32)  # 4 words a run
        for u in range(Z * Y * X // 16 if vec else Z * Y):
            r = (u // threads) % blocks
            if vec:
                fl = _first_last_byte(units[u])
                if fl is None:
                    continue
                row, x = divmod(u, X // 16)
                x0, x1 = 16 * x + fl[0], 16 * x + fl[1]
            else:
                row = u
                xs = np.flatnonzero(g.reshape(Z * Y, X)[row])
                if not len(xs):
                    continue
                x0, x1 = int(xs[0]), int(xs[-1])
            z, y = divmod(row, Y)
            p = part[b, :, r]
            p[:3] = np.minimum(p[:3], (x0, y, z))
            p[3:] = np.maximum(p[3:], (x1, y, z))
    return part


def _ray_part(view, intr, cfg, rays):
    """K12's phase A for the flat rays ``rays``: what does not depend on the
    box (direction, cam_z, the reciprocals of the direction, t_start, t_end),
    in its arithmetic."""
    f = xla_arith.fma32
    P = cfg.width * cfg.height
    b, p = rays // P, rays % P
    fx, fy, mx, my = (intr[b, i] for i in range(4))
    cx = ((p % cfg.width).float() - mx) / fx
    cy = (torch.div(p, cfg.width, rounding_mode="floor").float() - my) / fy
    cn = xla_arith.sqrt32(f(torch.ones_like(cx), 1.0, f(cy, cy, cx * cx)))
    c = (cx / cn, cy / cn, torch.ones_like(cn) / cn)
    m = view[b]
    w = [f(m[:, i, 2], c[2], f(m[:, i, 1], c[1], m[:, i, 0] * c[0])) for i in range(3)]
    wn = xla_arith.sqrt32(f(w[2], w[2], f(w[1], w[1], w[0] * w[0])))
    d = [wi / wn for wi in w]
    inv = [torch.where(di.abs() > 1e-9, torch.ones_like(di) / di, 1e12) for di in d]
    return dict(dir=torch.stack(d, -1), cam_z=c[2], inv=inv,
                t_start=torch.full_like(c[2], cfg.depth_min) / c[2],
                t_end=torch.full_like(c[2], cfg.depth_max) / c[2])


def _setup_two_launches(valid, view, intr, cfg, box_blocks, box_threads, ray_threads):
    """K12's two kernels: the first's partial boxes (``box_blocks`` blocks a
    batch row of ``box_threads``); the second's blocks of ``ray_threads``
    rays, a thread a ray: what does not depend on the box set up and parked,
    then (after the wait) for each batch row the block's rays touch, the
    row's box from its partials (min(lo, dim) - 1.5, hi + 1.5) and the rays
    of that row finished from what was parked."""
    B, Z, Y, X = valid.shape
    P = cfg.width * cfg.height
    n = B * P
    part = _partials(valid, box_blocks, box_threads)
    out = dict(direction=torch.zeros(n, 3), cam_z=torch.zeros(n), t0=torch.zeros(n),
               t_stop=torch.zeros(n))
    blocks = -(-n // ray_threads)
    parked = [_ray_part(view, intr, cfg, torch.arange(blk * ray_threads,
                                                      min(n, blk * ray_threads + ray_threads)))
              for blk in range(blocks)]
    for blk in range(blocks):  # after the wait
        first, last = blk * ray_threads, min(n, blk * ray_threads + ray_threads)
        rays = torch.arange(first, last)
        for b in range(first // P, (last - 1) // P + 1):
            lo_i, hi_i = part[b, :3].min(axis=1), part[b, 3:].max(axis=1)
            lo = [float(min(lo_i[a], dim)) - 1.5 for a, dim in enumerate((X, Y, Z))]
            hi = [float(hi_i[a]) + 1.5 for a in range(3)]
            sel = rays // P == b
            q = {k: (v[sel] if torch.is_tensor(v) else [x[sel] for x in v])
                 for k, v in parked[blk].items()}
            o = view[b, :3, 3]
            enter = leave = None
            for a in range(3):
                ta, tb = (lo[a] - o[a]) * q["inv"][a], (hi[a] - o[a]) * q["inv"][a]
                mn, mx_ = torch.minimum(ta, tb), torch.maximum(ta, tb)
                enter = mn if enter is None else torch.maximum(enter, mn)
                leave = mx_ if leave is None else torch.minimum(leave, mx_)
            skip = torch.floor((enter - q["t_start"]) * xla_arith.recip_const(cfg.ray_increment))
            skip = torch.where(skip < 0, 0.0, skip)
            rr = rays[sel]
            out["direction"][rr] = q["dir"]
            out["cam_z"][rr] = q["cam_z"]
            out["t0"][rr] = xla_arith.fma32(skip, cfg.ray_increment, q["t_start"])
            out["t_stop"][rr] = torch.minimum(q["t_end"], leave + cfg.ray_increment)
    return R.MarchSetup(view[:, :3, 3].clone(), out["direction"].reshape(B, P, 3),
                        *(out[k].reshape(B, P) for k in ("cam_z", "t0", "t_stop")))


def _setup_grid(grid):
    b = jax_synthetic.make_chunk_batch(2, (16, 16, 16), image_dims=(48, 32), seed=3,
                                       with_frames=True)
    valid = torch.from_numpy(np.abs(b["input"][..., 0]) < 3.0)
    view, intr = H.t(b["images_view"]), H.t(b["images_intrinsic"])
    if grid == "empty":
        valid[1] = False
    elif grid == "near_axis":
        view = torch.eye(4).repeat(2, 1, 1)
        view[:, :3, 3] = torch.tensor([8.0, 8.0, -20.0])
        intr = torch.tensor([[40.0, 40.0, 24.0, 16.0]] * 2)
    elif grid in ("corners", "corners_x20"):
        # valid voxels at index 0 and at the far corner only (frame 1: the far
        # corner alone); X = 20 takes the kernel's row-a-thread path
        shape = (2, 16, 16, 16 if grid == "corners" else 20)
        valid = torch.zeros(shape, dtype=torch.bool)
        valid[:, -1, -1, -1] = True
        valid[0, 0, 0, 0] = True
    return valid, view, intr


@pytest.mark.parametrize("launch", ["one_box_block", "seven_box_blocks",
                                    "more_box_blocks_than_rows", "the_kernels"])
@pytest.mark.parametrize("grid", ["input", "empty", "near_axis", "corners", "corners_x20"])
def test_setup_as_two_launches(grid, launch):
    """K12's schedule (partial boxes a block over a partition of each batch
    row's valid voxels, box blocks that see no valid voxel or no unit at all;
    rays parked across the wait, ray blocks that span two batch rows) gives
    march_setup_plain's bits."""
    valid, view, intr = _setup_grid(grid)
    cfg = R.RaycastConfig(width=48, height=32)
    box_blocks, box_threads, ray_threads = {
        "one_box_block": (1, 256, 256),
        "seven_box_blocks": (7, 32, 100),  # ray block 15 spans the two batch rows
        "more_box_blocks_than_rows": (300, 1, 7),
        "the_kernels": (R.SETUP_BOX_BLOCKS, 256, 256),
    }[launch]
    want = R.march_setup_plain(valid, view, intr, cfg)
    got = _setup_two_launches(valid, view, intr, cfg, box_blocks, box_threads, ray_threads)
    for name, g, w in zip(R.MarchSetup._fields, got, want):
        np.testing.assert_array_equal(_bits(g.contiguous().numpy()), _bits(w.numpy()),
                                      err_msg=name)
    if grid.startswith("corners"):  # frame 0's box spans the grid, frame 1's is one voxel
        part = _partials(valid, box_blocks, box_threads)
        assert list(part[0, :3].min(axis=1)) == [0, 0, 0]
        assert list(part[1, :3].min(axis=1)) == [valid.shape[3] - 1, 15, 15]


def test_nonzero_byte_masks_find_the_first_and_last_valid_voxel():
    """K12's 16-byte runs: every placement of one or two nonzero bytes (and
    bytes other than 1) gives the first and last nonzero byte."""
    rng = np.random.default_rng(0)
    for i in range(16):
        for j in range(i, 16):
            run = np.zeros(16, np.uint8)
            run[i], run[j] = rng.integers(1, 256), rng.integers(1, 256)
            assert _first_last_byte(run.view(np.uint32)) == (i, j)
    assert _first_last_byte(np.zeros(4, np.uint32)) is None


def _normals_by_tiles(depth, intr, tx=32, ty=8):
    """K11's tile: each point of a 32x8 tile and its one-pixel apron (34x10)
    unprojected once (0 outside the image), interior pixels' normals from
    those points, the tile's outputs staged and written row by row, a row's
    valid pixels' 3 floats a run (the kernel's float4 runs or floats)."""
    B, Hh, W = depth.shape
    out = torch.full((B, Hh, W, 3), float("nan"))
    f = xla_arith.fma32
    for b in range(B):
        fx, fy, mx, my = intr[b]
        for y0 in range(0, Hh, ty):
            for x0 in range(0, W, tx):
                ys = torch.arange(y0 - 1, y0 + ty + 1)[:, None].expand(ty + 2, tx + 2)
                xs = torch.arange(x0 - 1, x0 + tx + 1)[None, :].expand(ty + 2, tx + 2)
                inside = (ys >= 0) & (ys < Hh) & (xs >= 0) & (xs < W)
                d = torch.where(inside, depth[b][ys.clamp(0, Hh - 1), xs.clamp(0, W - 1)], 0.0)
                px = torch.where(d != 0, d * (xs.float() - mx) / fx, 0.0)
                py = torch.where(d != 0, d * (ys.float() - my) / fy, 0.0)
                pz = torch.where(d != 0, d, 0.0)
                pts = torch.stack([px, py, pz], -1)  # (ty + 2, tx + 2, 3)
                a = pts[2:, 1:-1] - pts[:-2, 1:-1]
                bb = pts[1:-1, 2:] - pts[1:-1, :-2]
                n = torch.stack([f(a[..., 1], bb[..., 2], -(a[..., 2] * bb[..., 1])),
                                 f(a[..., 2], bb[..., 0], -(a[..., 0] * bb[..., 2])),
                                 f(a[..., 0], bb[..., 1], -(a[..., 1] * bb[..., 0]))], -1)
                l2 = f(n[..., 2], n[..., 2], f(n[..., 1], n[..., 1], n[..., 0] * n[..., 0]))
                nl = -xla_arith.sqrt32(torch.where(l2 < 1e-24, 1e-24, l2))
                some = ((px[1:-1, 1:-1] != 0) | (px[2:, 1:-1] != 0) | (px[1:-1, 2:] != 0)
                        | (px[:-2, 1:-1] != 0) | (px[1:-1, :-2] != 0))
                y, x = ys[1:-1, 1:-1], xs[1:-1, 1:-1]
                interior = (x > 0) & (x < W - 1) & (y > 0) & (y < Hh - 1)
                keep = (interior & (l2 > 0) & some)[..., None]
                staged = torch.where(keep, n / nl[..., None], 0.0).reshape(ty, tx * 3)
                cols = min(tx, W - x0) * 3
                for r in range(min(ty, Hh - y0)):
                    out[b, y0 + r].reshape(-1)[x0 * 3:x0 * 3 + cols] = staged[r, :cols]
    return out


@pytest.mark.parametrize("size", [(48, 32), (37, 13), (3, 3)])
def test_normals_as_tiles_of_the_kernel(frames, size):
    """K11's tile schedule (apron points unprojected once, staged rows,
    ragged tiles in x and y, a frame with one interior pixel) gives
    unproject_normals_plain's bits, on frames with holes."""
    W, Hh = size
    oy, ox = (32 - Hh) // 2, (48 - W) // 2
    depth = H.t(_holes(frames[0], 15))[:, oy:oy + Hh, ox:ox + W].contiguous()
    if size == (3, 3):
        depth[0, 0, 1] = 0.0  # a hole beside the one interior pixel
    intr = H.t(frames[1])
    got = _normals_by_tiles(depth, intr)
    want = D.unproject_normals_plain(depth, intr)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
    assert bool((want != 0).any()) and not bool(torch.isnan(got).any())


@pytest.mark.parametrize("case", ["holes", "none", "unfillable"])
def test_fill_then_normals_is_the_plain_chain(frames, case):
    """The chain as the card runs it with a fill: the fill's schedule
    (_fill_on_the_card), then K11's tiles over its output (the launch's last
    phase), against depth_to_normals on CPU tensors (the plain chain)."""
    depth = frames[0]
    if case == "holes":
        depth = _holes(depth, 16)
    elif case == "none":
        depth = np.where(depth == 0, 1.0, depth).astype(np.float32)
    else:
        depth = _holes(depth, 17, (0,))
        depth[1] = 0.0
    t, intr = H.t(depth), H.t(frames[1])
    filled, ok, _ = _fill_on_the_card(t, 6)
    want = D.depth_to_normals(t, intr, 6)
    for g, w in zip((_normals_by_tiles(filled, intr), filled), want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w.numpy()))
    np.testing.assert_array_equal(ok.numpy(), want[2].numpy())


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
