"""What the raycaster's kernels K4 and K6 (spsg_tpu_torch/ops/csrc/raycast.cu)
rest on, checked on the CPU through their plain versions against the JAX
package: K4's coarse block map equals the JAX package's per-block reduction
of its fully valid cells; a lattice sample in a block without one is NaN, so
skipping its corner loads changes nothing; the plain count of the march's
work follows the kernel's loop; and K6's rule (sums into the row of the pixel
that claimed the voxel first, then one division per voxel by the count)
gives the JAX package's averaged backward."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.ops import raycast as jr
from spsg_tpu_torch.data import synthetic
from spsg_tpu_torch.ops import raycast as R

DIMS, IMAGE = (32, 32, 32), (96, 64)


@pytest.fixture(scope="module")
def scene():
    b = synthetic.make_chunk_batch(2, DIMS, image_dims=IMAGE, seed=1, with_frames=True,
                                   device="cpu")
    tgt = np.clip(b["target_sdf"], -3.0, 3.0)
    noise = np.random.default_rng(0).normal(0, 0.5, tgt.shape).astype(np.float32)
    grids = {"input": b["input"][..., 0], "target": tgt, "prediction": tgt + noise}
    return grids, b["images_view"], b["images_intrinsic"]


def _odd_and_non_finite(grids):
    """Grids whose dims are not multiples of 8 (the prediction cut to
    (2, 30, 21, 27)), the prediction with NaN, inf and -inf SDF entries
    inside its valid voxels, and the target's band |sdf| < 1 alone."""
    cut = np.ascontiguousarray(grids["prediction"][:, 1:31, 5:26, 2:29])
    bad = grids["prediction"].copy()
    rng = np.random.default_rng(3)
    for v in (np.nan, np.inf, -np.inf):
        at = tuple(rng.integers(0, n, 400) for n in bad.shape)
        bad[at] = v
    thin = np.where(np.abs(grids["target"]) < 1.0, grids["target"], 3.0)
    return {"odd_dims": cut, "non_finite": bad, "thin_band": thin}


def _valid(sdf):
    # the training step's rule; NaN compares False, +-inf too, so a
    # non-finite entry is invalid here: make some valid again
    valid = np.abs(sdf) < 3.0
    valid |= ~np.isfinite(sdf) & (np.arange(sdf.size).reshape(sdf.shape) % 2 == 0)
    return valid


def _jax_blocks(sdf, valid):
    cells = jr.build_march_cells(jnp.asarray(sdf), jnp.asarray(valid))
    cell_ok = jnp.all(jnp.isfinite(cells), axis=-1)
    win = np.asarray(jr.build_block_windows(cell_ok, R.COARSE_BLOCK))
    nb = R._coarse_dims(*sdf.shape[1:])
    return np.asarray(cell_ok), win[:, 1:nb[0] + 1, 1:nb[1] + 1, 1:nb[2] + 1, 0] > 0.5


def _all_grids(grids):
    return {**grids, **_odd_and_non_finite(grids)}


@pytest.mark.parametrize("grid", ["input", "target", "prediction", "odd_dims", "non_finite"])
def test_coarse_blocks_match_the_jax_packages(scene, grid):
    """The block map equals, exactly, the per-block any of the JAX package's
    fully valid cells, jnp.all(jnp.isfinite(build_march_cells(sdf, valid)), -1),
    both as reduced here and as build_block_windows packs it."""
    sdf = _all_grids(scene[0])[grid]
    valid = _valid(sdf)
    cell_ok, jax_blocks = _jax_blocks(sdf, valid)
    got = R.coarse_blocks_plain(torch.from_numpy(sdf), torch.from_numpy(valid)).numpy()
    B, Z, Y, X = sdf.shape
    e = R.COARSE_BLOCK
    nb = R._coarse_dims(Z, Y, X)
    padded = np.zeros((B,) + tuple(n * e for n in nb), bool)
    padded[:, :Z, :Y, :X] = cell_ok
    want = padded.reshape(B, nb[0], e, nb[1], e, nb[2], e).any(axis=(2, 4, 6))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_blocks)
    np.testing.assert_array_equal(R._cell_ok(torch.from_numpy(sdf), torch.from_numpy(valid)),
                                  cell_ok[:, :-1, :-1, :-1])
    assert not cell_ok[:, -1].any() and not cell_ok[:, :, -1].any() and not cell_ok[..., -1].any()


def _lattice(sdf, valid, view, intr, cfg, work):
    """Every lattice sample of march_plain up to each ray's exit: positions
    (B, P, K) and a mask of the samples taken."""
    setup = R.march_setup(valid, view, intr, cfg)
    K = int(work["samples"].max())
    ks = torch.arange(K)
    t = setup.t0[..., None] + ks.to(torch.float32) * cfg.ray_increment
    pos = [setup.origin[:, None, i, None] + t * setup.direction[..., i, None] for i in range(3)]
    return pos, ks < work["samples"][..., None]


@pytest.mark.parametrize("grid", ["input", "target", "prediction", "odd_dims", "non_finite",
                                  "thin_band"])
def test_a_sample_in_an_empty_block_is_nan(scene, grid):
    """For every lattice sample the march takes, a cell in a block without a
    fully valid cell interpolates to NaN (and so does a cell outside the
    grid): the kernel may skip its loads. The count of the work agrees."""
    sdf_np = _all_grids(scene[0])[grid]
    sdf, valid = torch.from_numpy(sdf_np), torch.from_numpy(_valid(sdf_np))
    view, intr = torch.from_numpy(scene[1]), torch.from_numpy(scene[2])
    cfg = R.RaycastConfig(width=IMAGE[0], height=IMAGE[1])
    setup = R.march_setup(valid, view, intr, cfg)
    work = R.march_work_plain(sdf, valid, setup, cfg)
    (px, py, pz), taken = _lattice(sdf, valid, view, intr, cfg, work)
    B, Z, Y, X = sdf.shape
    v, ok = R._trilerp(sdf.reshape(B, -1), valid.reshape(B, -1), px, py, pz, (Z, Y, X))
    ix, iy, iz = (torch.floor(q).long() for q in (px, py, pz))
    inb = (ix >= 0) & (iy >= 0) & (iz >= 0) & (ix < X - 1) & (iy < Y - 1) & (iz < Z - 1)
    blocks = R.coarse_blocks_plain(sdf, valid)
    e = R.COARSE_BLOCK
    rows = torch.arange(B)[:, None, None]
    occupied = inb & blocks[rows, (iz * inb) // e, (iy * inb) // e, (ix * inb) // e]
    skipped = taken & ~occupied
    # not vacuous: at 32^3 the target's and the prediction's rays meet few
    # empty blocks, the others many (the thin band: a third of the samples)
    assert grid in ("target", "prediction") or int(skipped.sum()) > 1000
    assert torch.isnan(v[skipped]).all() and not ok[skipped].any()
    # the count of the work: samples, samples in occupied blocks, finite ones
    assert torch.equal(work["in_blocks"], (taken & occupied).sum(-1))
    assert torch.equal(work["fully_valid"], (taken & ok).sum(-1))
    assert int(work["fully_valid"].sum()) > 0


def test_a_cell_reaching_into_the_next_block_belongs_to_its_base_block():
    """Valid voxels only at x = 7 and 8: the cells with base x = 7 are fully
    valid and have their far corners in block 1, yet they flag block 0 only;
    samples in block 1 (base x = 8: corner x = 9 invalid) are NaN."""
    Z = Y = X = 20
    z = np.arange(Z, dtype=np.float32)[:, None, None]
    sdf = np.broadcast_to(z - 10.5, (Z, Y, X)).astype(np.float32)[None].copy()
    valid = np.zeros_like(sdf, dtype=bool)
    valid[..., 7:9] = True
    blocks = R.coarse_blocks_plain(torch.from_numpy(sdf), torch.from_numpy(valid)).numpy()
    assert blocks[0, :, :, 0].any() and not blocks[0, :, :, 1:].any()
    np.testing.assert_array_equal(blocks, _jax_blocks(sdf, valid)[1])
    px = torch.tensor([[7.5, 8.5, 7.0, 8.99]])
    py = torch.full_like(px, 5.5)
    pz = torch.full_like(px, 10.25)
    v, _ = R._trilerp(torch.from_numpy(sdf).reshape(1, -1), torch.from_numpy(valid).reshape(1, -1),
                      px, py, pz, (Z, Y, X))
    assert torch.isfinite(v[0, [0, 2]]).all() and torch.isnan(v[0, [1, 3]]).all()


def _march_loop(sdf, valid, setup, cfg, b, p):
    """One ray through the loop of raycast_march_kernel, sample by sample:
    (samples, samples in occupied blocks, fully valid samples)."""
    B, Z, Y, X = sdf.shape
    blocks = R.coarse_blocks_plain(sdf, valid)[b]
    cell_ok = R._cell_ok(sdf, valid)[b]
    o, d = setup.origin[b], setup.direction[b, p]
    t0, t_stop = setup.t0[b, p], setup.t_stop[b, p]
    step = torch.tensor(cfg.ray_increment)
    e = R.COARSE_BLOCK

    def sample(t):
        pos = [o[i] + t * d[i] for i in range(3)]
        v = R._trilerp(sdf[b:b + 1].reshape(1, -1), valid[b:b + 1].reshape(1, -1),
                       *(q.reshape(1, 1) for q in pos), (Z, Y, X))[0][0, 0]
        ix, iy, iz = (int(torch.floor(q)) for q in pos)
        inb = 0 <= ix < X - 1 and 0 <= iy < Y - 1 and 0 <= iz < Z - 1
        occ = inb and bool(blocks[iz // e, iy // e, ix // e])
        return v, int(occ), int(inb and bool(cell_ok[iz, iy, ix]))

    prev, occ, full = sample(t0)
    k = 1
    while k <= cfg.max_samples:
        t = t0 + torch.tensor(float(k)) * step
        if not bool(t <= t_stop):
            break
        v, o_, f_ = sample(t)
        occ, full = occ + o_, full + f_
        if bool((prev * v < 0) & ((prev - v).abs() < cfg.thresh_sample_dist)
                & (v.abs() < cfg.thresh_sample_dist)):
            k += 1
            break
        prev = v
        k += 1
    return k, occ, full


def test_the_work_count_follows_the_kernels_loop(scene):
    """march_work_plain (lockstep rounds) against the kernel's loop written
    out for single rays: hits, misses, and the shortest and longest rays."""
    sdf_np = scene[0]["input"]
    sdf, valid = torch.from_numpy(sdf_np), torch.from_numpy(_valid(sdf_np))
    cfg = R.RaycastConfig(width=IMAGE[0], height=IMAGE[1])
    setup = R.march_setup(valid, torch.from_numpy(scene[1]), torch.from_numpy(scene[2]), cfg)
    work = R.march_work_plain(sdf, valid, setup, cfg)
    hit = R.march_plain(sdf, valid, setup, cfg)[0]
    rng = np.random.default_rng(4)
    picks = [(b, int(p)) for b in range(2) for p in np.concatenate([
        rng.choice(np.flatnonzero(hit[b].numpy()), 6),
        rng.choice(np.flatnonzero(~hit[b].numpy()), 6),
        [int(work["samples"][b].argmin()), int(work["samples"][b].argmax())]])]
    for b, p in picks:
        got = tuple(int(work[k][b, p]) for k in ("samples", "in_blocks", "fully_valid"))
        assert got == _march_loop(sdf, valid, setup, cfg, b, p), (b, p)


def _owner_divide(g, hit, hit_idx, n):
    """K6's rule in numpy: the first hit pixel of a voxel claims its slot and
    owns it; every hit pixel adds its finite channels and a count of 1 into
    the owner's row; then each voxel's gradients are its owner's sums divided
    by the count where it is above 1, zeros where no pixel hit it."""
    B, P, C = g.shape
    slot = np.zeros((B, n), np.int64)
    rows = np.zeros((B, P, C + 1), np.float32)
    for b in range(B):
        for p in range(P):
            if hit[b, p]:
                v = hit_idx[b, p]
                if slot[b, v] == 0:
                    slot[b, v] = p + 1
                owner = slot[b, v] - 1
                rows[b, owner, :C] += np.where(np.isfinite(g[b, p]), g[b, p], 0.0)
                rows[b, owner, C] += 1.0
    out = np.zeros((B, n, C), np.float32)
    for b in range(B):
        for v in np.flatnonzero(slot[b]):
            row = rows[b, slot[b, v] - 1]
            out[b, v] = row[:C] / row[C] if row[C] > 1 else row[:C]
    return out


def test_the_owner_divide_rule_gives_jaxs_backward():
    """Many pixels on one voxel, some on none, pixels without a hit and
    non-finite cotangents: the plain scatter, the port's autograd Function and
    K6's rule written out agree with jax.vjp of the JAX package's shade_hits
    within 1e-6."""
    B, dims, (W, H) = 2, (4, 4, 4), (8, 4)
    n, P = 64, W * H
    rng = np.random.default_rng(5)
    hit = rng.uniform(size=(B, P)) < 0.8
    hit_idx = rng.integers(0, 6, (B, P)).astype(np.int32)  # voxels 6..63: no pixel
    hit_idx[:, :12] = 5  # twelve pixels on one voxel
    depth = rng.uniform(5, 50, (B, P)).astype(np.float32)
    cts = [rng.normal(0, 1, (B, H, W, c)).astype(np.float32) for c in (3, 3, 14)]
    cts.insert(1, rng.normal(0, 1, (B, H, W)).astype(np.float32))  # (color, depth, normal, sem)
    cts[0][0, 0, 1, 2] = np.nan
    cts[3][1, 0, 3, 5] = np.inf
    cts[1][0, 0, 4] = -np.inf
    attrs = [rng.normal(0, 1, (B,) + dims + (c,)).astype(np.float32) for c in (3, 3, 14)]
    sdf = rng.normal(0, 1, (B,) + dims).astype(np.float32)

    jcfg = jr.RaycastConfig(width=W, height=H)
    hits = dict(hit=jnp.asarray(hit), hit_idx=jnp.asarray(hit_idx), depth=jnp.asarray(depth))
    _, vjp = jax.vjp(lambda s, c, nr, sm: jr.shade_hits(s, c, nr, sm, hits, jcfg),
                     *(jnp.asarray(a) for a in [sdf] + attrs))
    j_sdf, j_c, j_n, j_s = (np.asarray(a).reshape(B, n, -1) for a in vjp(
        jr.RaycastOutput(*(jnp.asarray(c) for c in cts))))

    flat = [torch.from_numpy(c.reshape(B, P, -1)) for c in (cts[0], cts[2], cts[3], cts[1])]
    t_hit, t_idx = torch.from_numpy(hit), torch.from_numpy(hit_idx)
    plain = R.scatter_plain(flat[0], flat[1], flat[2], flat[3][..., 0], t_hit, t_idx, n)
    rule = _owner_divide(np.concatenate([f.numpy() for f in flat], -1), hit, hit_idx, n)
    rule = (rule[..., 20:21], rule[..., 0:3], rule[..., 3:6], rule[..., 6:20])
    leaves = [torch.from_numpy(a).requires_grad_() for a in [sdf] + attrs]
    out = R.shade_hits(*leaves, dict(hit=t_hit, hit_idx=t_idx, depth=torch.from_numpy(depth)),
                       R.RaycastConfig(width=W, height=H))
    torch.autograd.backward(out, [torch.from_numpy(c) for c in cts])
    autograd = [leaf.grad.numpy().reshape(B, n, -1) for leaf in leaves]
    assert int((hit_idx[hit] == 5).sum()) > 12 and (j_c[:, 6:] == 0).all()
    for want, got_plain, got_rule, got_fn in zip((j_sdf, j_c, j_n, j_s), plain, rule, autograd):
        for got in (got_plain.numpy().reshape(B, n, -1), got_rule, got_fn):
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
