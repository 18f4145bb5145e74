"""The raycaster's shade gather K5 (spsg_tpu_torch/ops/csrc/raycast.cu,
raycast_shade_kernel), checked on the CPU: its plain version against the JAX
package's image assembly (_forward_images) to the bit on the edge cases
(zero normals, pixels without a hit, NaN and +-inf attributes, an absent
attribute, ragged pixel counts, a row without a hit and a row of hits), and
a numpy emulation of the kernel's index map: every output element written
once, every load inside its pixel's row, no load for a pixel without a hit
or an absent attribute, and the same outputs as the plain version."""

import math
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spsg_tpu.ops import raycast as jr
from spsg_tpu_torch.ops import _build
from spsg_tpu_torch.ops import raycast as R

NAMES = ("color", "normal", "semantic")
WIDTHS = {"color": 3, "normal": 3, "semantic": R.NUM_CLASSES}
# a NaN with a sign and a payload: copied, its bits stay
ODD_NAN = np.array([0xFFC00001], np.uint32).view(np.float32)[0]


def _case(kind, B=2, P=96, N=50, seed=0):
    """Attributes (B, N, C) (None where absent), hit, hit_idx, depth (B, P)."""
    rng = np.random.default_rng(seed)
    attrs = {k: rng.normal(0, 1, (B, N, c)).astype(np.float32) for k, c in WIDTHS.items()}
    attrs["normal"][:, ::5] = 0.0  # voxels whose normal is exactly zero
    attrs["normal"][:, 1::7, 1] = 0.0  # ... and a zero channel of a normal that is not
    hit = rng.random((B, P)) < 0.6
    hit_idx = rng.integers(0, N, (B, P)).astype(np.int32)
    depth = rng.uniform(1, 50, (B, P)).astype(np.float32)
    if kind == "non_finite":
        for k, v in zip(NAMES, (np.nan, np.inf, -np.inf)):
            attrs[k][:, 2::3, 0] = v
        attrs["semantic"][:, ::4, 5] = ODD_NAN
        attrs["normal"][:, 3::9] = np.nan  # a NaN normal is not zero
        attrs["color"][:, 1::4, 2] = -np.inf
        depth[:, ::6] = np.nan
    elif kind == "rows":
        hit[0] = False
        hit[-1] = True
    elif kind == "no_semantic":
        attrs["semantic"] = None
    elif kind == "all_absent":
        attrs = dict.fromkeys(NAMES)
    return attrs, hit, hit_idx, depth


CASES = {
    "hits": dict(kind="hits"),
    "non_finite": dict(kind="non_finite"),
    "rows": dict(kind="rows"),
    "no_semantic": dict(kind="no_semantic"),
    "all_absent": dict(kind="all_absent"),
    "ragged": dict(kind="hits", P=997, seed=1),
    "ragged_non_finite": dict(kind="non_finite", B=3, P=997, seed=2),
}


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.int32)


def _plain(attrs, hit, hit_idx, depth):
    opt = (lambda a: None if a is None else torch.from_numpy(a))
    out = R.shade_plain(*(opt(attrs[k]) for k in NAMES), torch.from_numpy(hit),
                        torch.from_numpy(hit_idx), torch.from_numpy(depth))
    return [o.numpy() for o in out]


@pytest.mark.parametrize("name", sorted(CASES))
def test_shade_plain_is_jaxs_image_assembly_to_the_bit(name):
    """shade_plain (the kernel's plain version) against the JAX package's
    _forward_images on the same numpy inputs: colour, depth, normal and
    semantic images with identical bits; an attribute the port gets as None
    is zeros on JAX's side (as shade_hits passes it)."""
    attrs, hit, hit_idx, depth = _case(**CASES[name])
    B, P = hit.shape
    N = hit_idx.max() + 1
    full = {k: np.zeros((B, N, WIDTHS[k]), np.float32) if a is None else a
            for k, a in attrs.items()}
    cfg = jr.RaycastConfig(width=P, height=1)
    want = jr._forward_images((jnp.zeros((B, N)),) + tuple(jnp.asarray(full[k]) for k in NAMES),
                              jnp.asarray(hit), jnp.asarray(hit_idx), jnp.asarray(depth), cfg)
    got = _plain(attrs, hit, hit_idx, depth)
    for what, g, w in zip(("color", "depth", "normal", "semantic"), got, want):
        w = np.asarray(w).reshape(g.shape)
        assert np.array_equal(_bits(g), _bits(w)), what
    # the rules hold on their own, too
    c, d, n, s = got
    assert (c[~hit] == -np.inf).all() and (d[~hit] == -np.inf).all()
    assert (s[~hit] == -np.inf).all() and (n[~hit] == -np.inf).all()
    if attrs["normal"] is not None:
        zero = (attrs["normal"][np.arange(B)[:, None], hit_idx] == 0).all(-1)
        assert (n[hit & zero] == -np.inf).all()
        assert np.array_equal(_bits(n[hit & ~zero]),
                              _bits(attrs["normal"][np.arange(B)[:, None], hit_idx][hit & ~zero]))
    for k, o in zip(("color", "semantic"), (c, s)):
        if attrs[k] is None:
            assert (o[hit] == 0).all()


# --- the kernel's index map, emulated ---------------------------------------------

def _kernel_constants():
    text = open(os.path.join(_build.CSRC_DIR, "raycast.cu"), encoding="utf-8").read()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
            for k in ("kShadePixels", "kShadeThreads")}


def _emulate(attrs, hit, hit_idx, depth, pix, threads):
    """raycast_shade_kernel's loops in numpy: per block, phase 1 (a pixel a
    thread a round: its row or -1, the depth image), phase 2 (each span in
    elements e = t + k * threads), phase 3 (the normals). Returns the
    outputs, how often each output element was written, and every load as
    (attribute, flat index, pixel)."""
    B, P = hit.shape
    N = next((a.shape[1] for a in attrs.values() if a is not None), 1)
    pixels = B * P
    flat = {k: None if a is None else a.reshape(-1) for k, a in attrs.items()}
    hit_f, idx_f, depth_f = hit.reshape(-1), hit_idx.reshape(-1), depth.reshape(-1)
    outs = {k: np.zeros(pixels * c, np.float32) for k, c in WIDTHS.items()}
    outs["depth"] = np.zeros(pixels, np.float32)
    writes = {k: np.zeros(o.size, np.int64) for k, o in outs.items()}
    loads = []
    t = np.arange(threads)

    def rounds(count, per_thread):  # the indices a block's threads walk, by round
        ks = np.arange(math.ceil(per_thread / threads))
        q = (t[None, :] + ks[:, None] * threads).reshape(-1)
        return q[q < count]

    def value(name, rows, e, g0):
        c = WIDTHS[name]
        j = e // c
        row = rows[j]
        v = np.full(e.shape, -np.inf, np.float32)
        has = row >= 0
        if flat[name] is None:
            v[has] = 0.0
        else:
            at = row[has] * c + e[has] % c
            v[has] = flat[name][at]
            loads.extend(zip([name] * at.size, at.tolist(), (g0 + j[has]).tolist()))
        return v

    def normal_value(nrm, rows, e):
        j = e // 3
        tri = nrm[3 * j[:, None] + np.arange(3)]
        keep = (rows[j] >= 0) & (tri != 0).any(-1)
        return np.where(keep, nrm[e], np.float32(-np.inf))

    for g0 in range(0, pixels, pix):
        n = min(pix, pixels - g0)
        j = rounds(n, pix)
        g = g0 + j
        rows = np.full(pix, -3, np.int64)  # -3: never staged
        rows[j] = np.where(hit_f[g], g // P * N + idx_f[g], -1)
        outs["depth"][g] = np.where(hit_f[g], depth_f[g], np.float32(-np.inf))
        np.add.at(writes["depth"], g, 1)
        nrm = np.full(3 * pix, np.float32(7.0))
        spans = {k: rounds(n * c, pix * c) for k, c in WIDTHS.items()}
        for k in ("color", "semantic"):
            e = spans[k]
            outs[k][WIDTHS[k] * g0 + e] = value(k, rows, e, g0)
            np.add.at(writes[k], WIDTHS[k] * g0 + e, 1)
        e = spans["normal"]
        nrm[e] = value("normal", rows, e, g0)
        outs["normal"][3 * g0 + e] = normal_value(nrm, rows, e)
        np.add.at(writes["normal"], 3 * g0 + e, 1)
        assert (rows[:n] >= -1).all()  # every pixel of the block was staged
    shaped = (outs["color"].reshape(B, P, 3), outs["depth"].reshape(B, P),
              outs["normal"].reshape(B, P, 3), outs["semantic"].reshape(B, P, R.NUM_CLASSES))
    return shaped, writes, loads


RAGGED = [(1, 1), (1, 63), (1, 64), (1, 65), (1, 255), (2, 997), (3, 256), (2, 1000),
          (4, 17), (3, 333), (5, 129), (1, 3 * 256 + 4), (2, 512), (2, 2047), (1, 4097)]


@pytest.mark.parametrize("B,P", RAGGED)
def test_the_kernels_index_map_writes_each_output_once_and_loads_in_bounds(B, P):
    """For ragged counts of pixels B * P, with the pixels and threads a block
    read from raycast.cu: every output element is written exactly once, with
    the plain version's bits; each load of an attribute of C channels lies
    inside the row of N * C floats of a pixel that has a hit, and each such
    pixel loads each channel of its row once."""
    kind = "non_finite" if (B * P) % 2 else "hits"
    attrs, hit, hit_idx, depth = _case(kind, B=B, P=P, N=40, seed=B * 1000 + P)
    N = 40
    block = _kernel_constants()
    got, writes, loads = _emulate(attrs, hit, hit_idx, depth, block["kShadePixels"],
                                  block["kShadeThreads"])
    for k, w in writes.items():
        assert (w == 1).all(), (k, int((w != 1).sum()))
    for g, p in zip(got, _plain(attrs, hit, hit_idx, depth)):
        assert np.array_equal(_bits(g), _bits(p))
    hit_f, idx_f = hit.reshape(-1), hit_idx.reshape(-1).astype(np.int64)
    for name in NAMES:
        c = WIDTHS[name]
        mine = [(at, px) for k, at, px in loads if k == name]
        if attrs[name] is None:
            assert not mine
            continue
        at = np.array([m[0] for m in mine], np.int64)
        px = np.array([m[1] for m in mine], np.int64)
        assert hit_f[px].all()  # no load for a pixel without a hit
        row = px // P * N + idx_f[px]
        assert ((at >= row * c) & (at < row * c + c) & (at < B * N * c)).all()
        # every channel of every hit pixel's row, once
        assert len(set(zip(px.tolist(), (at - row * c).tolist()))) == at.size == hit.sum() * c

