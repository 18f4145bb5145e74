"""The occupancy raycast (spsg_tpu_torch/ops/raycast.py::raycast_occ, kernel
K7 on a card) on the CPU: its plain version against the JAX package's
raycast_occ (with its coarse skip) on the slab and blob scenes of
tests/test_raycast.py (down and oblique cameras), on the training step's masks
of make_chunk_batch grids, on an all-empty grid and on grids made to catch a
wrong skip (a single occupied voxel at a block corner, an axis-aligned camera
whose pixel rays run along the face between two blocks, a camera inside an
occupied shell): identical on every pixel (no pixel differed, so no tolerance
is agreed). K7 cannot run here, so its skip is modelled twice and held to the
plain version: its loop written out per ray in numpy float32 (each operation
rounded once, as the kernel compiled with -fmad=false does), and in lockstep
in PyTorch (occ_march_work_plain, which chip_smoke.py holds the kernel's
counts to); both give the plain version's image and lattice index at exit
and the same count of loaded samples. The pre-pass's map is held against a
slice-and-any over the grid."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.data import synthetic as jax_synthetic
from spsg_tpu.losses import geo as jax_geo
from spsg_tpu.ops import raycast as jr
from spsg_tpu_torch.ops import raycast as R

import test_raycast as TR  # the JAX package's scenes and cameras
import torch_port_helpers as H


def _configs(image, depth_max, depth_min=2.0):
    jc = dataclasses.replace(TR._cfg(image=image, depth_max=depth_max), depth_min=depth_min)
    rc = R.RaycastConfig(width=image[0], height=image[1], depth_min=jc.depth_min,
                         depth_max=jc.depth_max, ray_increment=jc.ray_increment,
                         thresh_sample_dist=jc.thresh_sample_dist, march_block=jc.march_block)
    return jc, rc


def _slab():
    dims = (48, 32, 32)
    occ = np.zeros(dims, np.uint8)
    occ[10:14, 8:24, 8:24] = 1
    view, intr = TR._down_camera(dims, 40.0, image=(16, 12))
    return occ[None], view[None], intr[None], _configs((16, 12), 60.0)


def _blob(camera):
    dims = (64, 64, 64)
    sdf, _ = TR._blob_scene(dims, seed=3)
    occ = (np.abs(sdf) < 1.5).astype(np.uint8)
    view, intr = (TR._down_camera(dims, 60.0) if camera == "down"
                  else TR._oblique_camera(dims))
    return occ[None], view[None], intr[None], _configs((32, 24), 200.0)


def _chunk_masks(dims, image, which):
    """The step's two masks (training/step.py::_occupancy_masks) of a
    make_chunk_batch with frames, at raycast_occ_depth_max (4 m)."""
    b = jax_synthetic.make_chunk_batch(2, dims, image_dims=image, seed=1, with_frames=True)
    trunc = 3.0
    tgt = np.asarray(jax_geo.compute_targets(jnp.asarray(b["target_sdf"]), trunc))
    if which == "missing":
        inp = b["input"][..., 0]
        occ = np.asarray(jax_geo.missing_geo_mask(jnp.asarray(np.abs(inp) < trunc - 0.01),
                                                  jnp.asarray(tgt), trunc))
    else:
        occ = np.abs(tgt) < 1
    cfgs = _configs(image, 4.0 / 0.02, depth_min=0.1 / 0.02)
    return occ.astype(np.uint8), b["images_view"], b["images_intrinsic"], cfgs


def _look_at(eye, target, fx, image):
    """cam2grid (xyz columns) of a camera at ``eye`` looking at ``target``
    and its intrinsics (principal point at the image centre)."""
    f = np.asarray(target, np.float64) - eye
    f /= np.linalg.norm(f)
    r = np.cross([0.0, 0.0, 1.0], f)
    r = r / np.linalg.norm(r) if np.linalg.norm(r) > 1e-6 else np.array([1.0, 0.0, 0.0])
    cam = np.eye(4, dtype=np.float32)
    cam[:3, 0], cam[:3, 1], cam[:3, 2], cam[:3, 3] = r, np.cross(f, r), f, eye
    return cam, np.array([fx, fx, image[0] / 2.0, image[1] / 2.0], np.float32)


def _corner_voxel():
    """One occupied voxel at a corner of three blocks' faces ((16, 15, 8):
    a low face in z and x, a high face in y), seen by a narrow camera whose
    rays pass within a fifth of a voxel of each other around it."""
    dims = (32, 32, 32)
    occ = np.zeros(dims, np.uint8)
    occ[16, 15, 8] = 1
    view, intr = _look_at(np.array([29.3, 37.1, 41.7]), [8.0, 15.0, 16.0], 160.0, (16, 12))
    return occ[None], view[None], intr[None], _configs((16, 12), 80.0)


def _face_rays():
    """A camera looking straight down from (15.5, 15.5, 40): the pixel
    column and row through the principal point run exactly on x = 15.5 and
    y = 15.5, whose nearest voxel is 16, on the low face of block 2; their
    neighbours graze the faces. Occupied voxels on both sides of the faces."""
    dims = (32, 32, 32)
    occ = np.zeros(dims, np.uint8)
    occ[4:7, 16, 16] = 1
    occ[9, 15, 15] = 1
    occ[12, 15:17, 17] = 1
    occ[14, 16, 14:16] = 1
    view, intr = TR._down_camera(dims, 40.0, image=(32, 24))
    view[0, 3] = view[1, 3] = 15.5
    intr[0] = intr[1] = 64.0
    return occ[None], view[None], intr[None], _configs((32, 24), 60.0)


def _inside_shell():
    """A camera inside a closed shell (|r - 10| < 1 about the grid's centre),
    looking diagonally: its rays start inside the occupied box."""
    dims = (32, 32, 32)
    z, y, x = np.meshgrid(*(np.arange(n) for n in dims), indexing="ij")
    r = np.sqrt((x - 16.0) ** 2 + (y - 15.0) ** 2 + (z - 17.0) ** 2)
    occ = (np.abs(r - 10.0) < 1.0).astype(np.uint8)
    view, intr = _look_at(np.array([16.2, 15.3, 16.9]), [30.0, 3.0, 25.0], 12.0, (16, 12))
    return occ[None], view[None], intr[None], _configs((16, 12), 40.0, depth_min=0.5)


SCENES = {
    "slab_down": _slab,
    "blob_down": lambda: _blob("down"),
    "blob_oblique": lambda: _blob("oblique"),
    "chunk16_target_band": lambda: _chunk_masks((16, 16, 16), (48, 32), "target"),
    "chunk16_missing": lambda: _chunk_masks((16, 16, 16), (48, 32), "missing"),
    "chunk64_target_band": lambda: _chunk_masks((64, 32, 32), (160, 128), "target"),
    "chunk64_missing": lambda: _chunk_masks((64, 32, 32), (160, 128), "missing"),
    "corner_voxel": _corner_voxel,
    "face_rays": _face_rays,
    "inside_shell": _inside_shell,
}
# the scenes that catch a wrong skip: few voxels, each of them hit
ADVERSARIAL = ("corner_voxel", "face_rays", "inside_shell")


@pytest.mark.parametrize("scene", list(SCENES))
def test_raycast_occ_matches_jax(scene):
    occ, view, intr, (jc, rc) = SCENES[scene]()
    want = np.asarray(jr.raycast_occ(jnp.asarray(occ), jnp.asarray(view), jnp.asarray(intr), jc))
    got = R.raycast_occ(H.t(occ), H.t(view), H.t(intr), rc)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    # identical on every pixel (measured: no pixel differs on any scene here)
    np.testing.assert_array_equal(got.numpy(), want)
    if scene in ADVERSARIAL:
        assert want.sum() >= 3
    elif scene != "chunk16_missing":  # 8^3 blocks without input are rare at 16^3
        assert want.sum() > 10
    # the wrapper on a CPU tensor is the plain version; bool and uint8 alike
    plain = R.raycast_occ_plain(H.t(occ.astype(bool)), H.t(view), H.t(intr), rc)
    assert torch.equal(plain, got)


def test_raycast_occ_of_an_empty_grid_is_zero():
    occ, view, intr, (jc, rc) = _blob("oblique")
    empty = np.zeros_like(occ)
    want = np.asarray(jr.raycast_occ(jnp.asarray(empty), jnp.asarray(view), jnp.asarray(intr),
                                     jc))
    occ_b, setup = R.occ_setup(H.t(empty), H.t(view), H.t(intr), rc)
    got, samples = R.occ_march_plain(occ_b, setup, rc, return_samples=True)
    assert not want.any() and not got.any()
    # the box of no voxel is inverted, and the ray-box slab test reads an
    # inverted box as a box: the rays still walk (and find nothing)
    assert int(samples.sum()) > 0


def _skip_map(occ):
    """K7's block map by slicing: per batch row and coarse block c in [-1, nb]
    on each axis, any occupied voxel in [8c - 1, 8c + 8] (clipped to the
    grid)."""
    B, Z, Y, X = occ.shape
    e = R.COARSE_BLOCK
    nb = [-(-n // e) for n in (Z, Y, X)]
    out = np.zeros((B,) + tuple(n + 2 for n in nb), bool)
    for cz in range(-1, nb[0] + 1):
        for cy in range(-1, nb[1] + 1):
            for cx in range(-1, nb[2] + 1):
                sl = tuple(slice(max(e * c - 1, 0), max(e * c + e + 1, 0)) for c in (cz, cy, cx))
                out[:, cz + 1, cy + 1, cx + 1] = occ[(slice(None),) + sl].reshape(B, -1).any(-1)
    return out


def _fma(a, b, c):
    """float32 a * b + c rounded once (numpy scalars): the float64 product is
    exact, the float64 sum is rounded to odd, then to float32."""
    p = np.float64(a) * np.float64(b)
    s = p + np.float64(c)
    pv = s - np.float64(c)
    e = (np.float64(c) - (s - pv)) + (p - pv)
    if e != 0 and np.isfinite(s) and not int(np.array(s).view(np.int64)) & 1:
        s = np.nextafter(s, np.inf if e > 0 else -np.inf)
    return np.float32(s)


def _kernel_loop(occ, setup, step, k_max, flags=None):
    """K7's loop for every ray, in numpy float32 (one rounding an operation,
    the lattice and the positions each a fused multiply-add, as K7 forms them):
    at sample k its block c = floor(v / 8); past a block without an occupied
    voxel within one voxel (or beyond the ring) a hop beyond the block's box
    [8c - 0.5, 8c + 7.5) and the boxes of the unflagged blocks that follow
    along the ray (at most OCC_HOP_BLOCKS), to the first sample past them;
    else a group of OCC_GROUP samples. ``flags`` replaces the map (default :func:`_skip_map`). Returns
    (hit, samples, evaluated)."""
    B, Z, Y, X = occ.shape
    origin, direction, _, t0, t_stop = (a.numpy() for a in setup)
    f32 = np.float32
    step, half, eighth, lim = f32(step), f32(0.5), f32(0.125), f32(R.OCC_HOP_LIMIT)
    flags = _skip_map(occ) if flags is None else flags
    nb = flags.shape[1:]
    hit = np.zeros(t0.shape, np.uint8)
    samples = np.zeros(t0.shape, np.int64)
    evaluated = np.zeros(t0.shape, np.int64)

    def voxel(o, d, t):
        return [np.floor(f32(_fma(t, d[i], o[i]) + half)) for i in range(3)]

    for b in range(B):
        o = origin[b]
        o_ok = all(abs(o[i]) < lim for i in range(3))
        for r in range(t0.shape[1]):
            d = direction[b, r]
            with np.errstate(divide="ignore"):
                inv = [f32(f32(1.0) / d[i]) for i in range(3)]
            ta, ts = t0[b, r], t_stop[b, r]

            def lattice(kk):
                return _fma(f32(kk), step, ta)

            def flagged(c):
                return (all(-1 <= c[i] <= nb[2 - i] - 2 for i in range(3))
                        and flags[b, int(c[2]) + 1, int(c[1]) + 1, int(c[0]) + 1])

            def face_t(c, i):
                if d[i] > 0:
                    face = f32(f32(f32(8) * c[i]) + f32(7.5))
                elif d[i] < 0:
                    face = f32(f32(f32(8) * c[i]) - half)
                else:
                    return f32(np.inf)
                with np.errstate(invalid="ignore"):
                    return f32(f32(face - o[i]) * inv[i])

            k = 0
            while k < k_max:
                t = lattice(k)
                if not t <= ts:
                    break
                c = [np.floor(f32(vi * eighth)) for vi in voxel(o, d, t)]  # x, y, z
                if not flagged(c) and o_ok and t < lim:
                    tf = [face_t(c, i) for i in range(3)]
                    t_exit = np.fmin(np.fmin(tf[0], tf[1]), tf[2])
                    for _ in range(R.OCC_HOP_BLOCKS):
                        if not t_exit <= ts:
                            break
                        i = 0 if tf[0] == t_exit else 1 if tf[1] == t_exit else 2
                        nxt = list(c)
                        nxt[i] = f32(nxt[i] + (f32(1) if d[i] > 0 else f32(-1)))
                        if flagged(nxt):
                            break
                        c = nxt
                        tf[i] = face_t(c, i)
                        t_exit = np.fmin(np.fmin(tf[0], tf[1]), tf[2])
                    kf = f32(np.floor(f32(f32(np.fmin(t_exit, ts) - ta) / step)) + f32(1))
                    kf = max(kf, f32(k + 1))
                    kn = int(kf) if kf < k_max else k_max
                    while kn - 1 > k and not lattice(kn - 1) <= ts:
                        kn -= 1
                    k = kn
                    continue
                got, taken = [], 0
                for j in range(R.OCC_GROUP):
                    tj = lattice(k + j)
                    take = k + j < k_max and tj <= ts
                    fv = voxel(o, d, tj)
                    load = take and min(fv) >= 0 and fv[0] < X and fv[1] < Y and fv[2] < Z
                    got.append(load and bool(occ[b, int(fv[2]), int(fv[1]), int(fv[0])]))
                    taken += take
                    evaluated[b, r] += load
                if any(got):
                    hit[b, r] = 1
                    k += got.index(True) + 1
                    break
                k += taken
                if taken < R.OCC_GROUP:
                    break
            samples[b, r] = k
    return hit, samples, evaluated


def _banded(scene):
    """The scene, with the blob's oblique image cut to a band of rows (the
    loop in Python stays short)."""
    occ, view, intr, (jc, rc) = SCENES[scene]()
    if scene == "blob_oblique":
        rc = dataclasses.replace(rc, height=6)
        intr = intr.copy()
        intr[:, 3] -= 9.0
    return occ, view, intr, rc


@pytest.mark.parametrize("scene", ["slab_down", "blob_oblique"] + list(ADVERSARIAL))
def test_kernel_loop_matches_the_plain_version(scene):
    """K7's loop with its hops and groups: the plain version's image and
    lattice index at exit, and the lockstep model's count of loaded
    samples."""
    occ, view, intr, rc = _banded(scene)
    occ_b, setup = R.occ_setup(H.t(occ), H.t(view), H.t(intr), rc)
    hit, samples, evaluated = _kernel_loop(occ != 0, setup, rc.ray_increment, rc.max_samples)
    got, got_samples = R.occ_march_plain(occ_b, setup, rc, return_samples=True)
    assert hit.sum() > 0
    np.testing.assert_array_equal(got.numpy(), hit)
    np.testing.assert_array_equal(got_samples.numpy(), samples)
    work = R.occ_march_work_plain(occ_b, setup, rc)
    np.testing.assert_array_equal(work["evaluated"].numpy(), evaluated)


def _rounding_rays():
    """Rays laid along the block face x = 15.5 (between voxels 15 and 16),
    one a batch row, made to catch a skip that trusts an exit t: each starts
    at the float just below the face and drifts across it by 2^-30 a voxel,
    so o + t d rounds onto the face (nearest voxel 16) from t = 512 on, where
    the exact crossing is at t = 1024. Along z (two rays up, two down), the
    first sample of one 8^3 block lies before t = 512 (voxel 15, a block
    without an occupied voxel) and the block's later samples on voxel 16,
    which is occupied. A skip past that block's box without the one-voxel
    margin misses every hit."""
    f32 = np.float32
    Z, Y, X = 528, 8, 24
    occ = np.zeros((4, Z, Y, X), bool)
    origin, direction, t0 = [], [], []
    for b, y in enumerate((1, 3, 5, 7)):
        up = b < 2
        origin.append([f32(15.5) - f32(2.0 ** -20), y, 0.0 if up else 527.3])
        direction.append([[2.0 ** -30, 0.0, 1.0 if up else -1.0]])
        # sample 568 is the block's first: t in [511.5, 512) up, (511.8, 512) down
        t0.append([(511.7 + 0.1 * b if up else 511.9) - 0.9 * 568])
        occ[b, slice(512, 520) if up else slice(8, 16), y, 16] = True
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    setup = R.MarchSetup(t(origin), t(direction), torch.ones(4, 1), t(t0), torch.full((4, 1), 540.0))
    rc = R.RaycastConfig(width=1, height=1, depth_min=0.0, depth_max=600.0, ray_increment=0.9)
    return occ, setup, rc


def test_rays_along_a_block_face_are_caught_by_the_margin():
    """On _rounding_rays the plain version hits on every ray; K7's loop (the
    numpy model and the lockstep one) hits where it does and exits at the
    same sample; the same loop with a map of the blocks alone (no one-voxel
    margin) misses every hit."""
    occ, setup, rc = _rounding_rays()
    occ_t = H.t(occ)
    ref, ref_samples = R.occ_march_plain(occ_t, setup, rc, return_samples=True)
    assert ref.all() and rc.max_samples > int(ref_samples.max())
    hit, samples, evaluated = _kernel_loop(occ, setup, rc.ray_increment, rc.max_samples)
    np.testing.assert_array_equal(hit, ref.numpy())
    np.testing.assert_array_equal(samples, ref_samples.numpy())
    work = R.occ_march_work_plain(occ_t, setup, rc)
    assert torch.equal(work["hit"], ref.bool()) and torch.equal(work["samples"], ref_samples)
    np.testing.assert_array_equal(work["evaluated"].numpy(), evaluated)
    # K7 hops up to the block before the face's rounding (most samples skipped)
    assert int(work["evaluated"].sum()) < int(ref_samples.sum()) // 4
    B, Z, Y, X = occ.shape
    bare = np.zeros((B,) + tuple(-(-n // 8) + 2 for n in (Z, Y, X)), bool)
    bare[:, 1:-1, 1:-1, 1:-1] = R.occ_blocks_plain(occ_t).numpy()
    missed = _kernel_loop(occ, setup, rc.ray_increment, rc.max_samples, flags=bare)[0]
    assert not missed.any()


@pytest.mark.parametrize("scene", list(SCENES))
def test_lockstep_model_matches_the_plain_version_and_jax(scene):
    """occ_march_work_plain, K7's loop in lockstep: hit identical to the JAX
    package's raycast_occ and to the plain version, samples to the plain
    version's; in_blocks counts only samples up to the exit."""
    occ, view, intr, (jc, rc) = SCENES[scene]()
    want = np.asarray(jr.raycast_occ(jnp.asarray(occ), jnp.asarray(view), jnp.asarray(intr), jc))
    occ_b, setup = R.occ_setup(H.t(occ), H.t(view), H.t(intr), rc)
    ref, ref_samples = R.occ_march_plain(occ_b, setup, rc, return_samples=True)
    work = R.occ_march_work_plain(occ_b, setup, rc)
    np.testing.assert_array_equal(work["hit"].to(torch.uint8).reshape(want.shape).numpy(), want)
    assert torch.equal(work["hit"].to(torch.uint8), ref)
    assert torch.equal(work["samples"], ref_samples)
    assert (work["in_blocks"] <= work["samples"]).all() and (work["evaluated"] >= 0).all()
    # a ray that hits loaded its occupied sample, and so did its block count
    hits = work["hit"]
    assert (work["evaluated"][hits] > 0).all() and (work["in_blocks"][hits] > 0).all()


@pytest.mark.parametrize("scene", ["chunk64_target_band", "chunk64_missing", "blob_oblique"])
def test_hops_skip_most_samples_on_empty_blocks(scene):
    """On the step's masks at (64, 32, 32) and on the empty grid, K7 loads
    fewer samples than it walks past (the exit index), and on the empty grid
    none."""
    occ, view, intr, (_, rc) = SCENES[scene]()
    for grid in (occ, np.zeros_like(occ)):
        occ_b, setup = R.occ_setup(H.t(grid), H.t(view), H.t(intr), rc)
        work = R.occ_march_work_plain(occ_b, setup, rc)
        assert int(work["evaluated"].sum()) < int(work["samples"].sum())
        if not grid.any():
            assert int(work["evaluated"].sum()) == 0 and int(work["samples"].sum()) > 0


@pytest.mark.parametrize("scene", ["chunk16_target_band", "blob_oblique", "corner_voxel",
                                   "inside_shell"])
def test_skip_map_is_the_dilated_slice_and_any(scene):
    """occ_skip_map_plain (what K7's pre-pass writes) against slicing the
    grid per block, ring included; and occ_blocks_plain against a reshape and
    any."""
    occ = SCENES[scene]()[0] != 0
    got = R.occ_skip_map_plain(H.t(occ))
    assert tuple(got.shape) == R.occ_skip_map_shape(occ.shape)
    np.testing.assert_array_equal(got.numpy(), _skip_map(occ))
    B, Z, Y, X = occ.shape
    nb = [-(-n // 8) for n in (Z, Y, X)]
    pad = np.zeros((B,) + tuple(8 * n for n in nb), bool)
    pad[:, :Z, :Y, :X] = occ
    blocks = pad.reshape(B, nb[0], 8, nb[1], 8, nb[2], 8).any(axis=(2, 4, 6))
    np.testing.assert_array_equal(R.occ_blocks_plain(H.t(occ)).numpy(), blocks)
    # the ring is set only next to an occupied voxel on the grid's faces
    assert got[:, 0].any() == bool(occ[:, 0].any())


def test_raycast_occ_checks_its_input():
    rc = R.RaycastConfig(width=4, height=2)
    with pytest.raises(ValueError, match="B,Z,Y,X"):
        R.raycast_occ(torch.zeros(4, 4, 4, dtype=torch.bool), torch.eye(4)[None],
                      torch.ones(1, 4), rc)
    assert R.launch_counts["raycast_occ"] == 0


@pytest.mark.parametrize("with_k7", [True, False])
def test_bind_declares_k7_where_the_library_has_it(with_k7):
    """_bind types a library's functions; one built from a raycast.cu from
    before K7 (a baseline to time K4-K6 against) binds too."""
    from types import SimpleNamespace

    names = ["spsg_raycast_march", "spsg_raycast_shade", "spsg_raycast_scatter"]
    lib = SimpleNamespace(**{n: SimpleNamespace() for n in
                             names + (["spsg_raycast_occ"] if with_k7 else [])})
    assert R._bind(lib) is lib
    for n in names:
        assert getattr(lib, n).restype is not None and getattr(lib, n).argtypes
    assert hasattr(lib, "spsg_raycast_occ") == with_k7
    if with_k7:
        assert len(lib.spsg_raycast_occ.argtypes) == 16


@pytest.mark.parametrize("old_k7", [True, False])
def test_bind_declares_the_hopping_k7_beside_the_old_one(old_k7):
    """This source's K7 entry (spsg_raycast_occ_hop, 18 arguments) binds, and
    so does a baseline's one-sample walk (spsg_raycast_occ) where a library
    has that instead."""
    from types import SimpleNamespace

    names = ["spsg_raycast_march", "spsg_raycast_shade", "spsg_raycast_scatter",
             "spsg_raycast_occ" if old_k7 else "spsg_raycast_occ_hop"]
    lib = R._bind(SimpleNamespace(**{n: SimpleNamespace() for n in names}))
    if old_k7:
        assert len(lib.spsg_raycast_occ.argtypes) == 16 and not hasattr(lib, "spsg_raycast_occ_hop")
    else:
        assert len(lib.spsg_raycast_occ_hop.argtypes) == 18
        assert not hasattr(lib, "spsg_raycast_occ")
