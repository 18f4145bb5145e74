"""Operations and bytes of the SPSG networks, counted from the configuration's
shapes alone (reference torch/model.py). It does not read the port's modules.

A conv's pass (forward, input gradient ``dx`` or weight gradient ``dW``) does
``2 * k^3 * Cin * Cout`` operations per output voxel and per batch row, and
moves, at the least, each of its operands once: forward reads x and W and
writes y; ``dx`` reads dy and W and writes dx; ``dW`` reads x and dy and writes
dW (4 bytes an element, float32). Its least time is the larger of operations
over the peak rate and bytes over the peak bandwidth (``peaks.json``); a
group's bound is the sum over its passes.

Groups: ``conv3x3`` are the generator's 28 convs that are 3^3, stride 1, pad
1 (the port's hand kernels K1-K3); ``libconv`` the other seven (the two 5^3
entry convs and the five 4^3 stride-2 downsamplers); ``disc`` the patch
discriminator's 4x4 stride-2 2D convs and its 1x1 ``final``.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

F32 = 4


def _half(d: Sequence[int]) -> tuple:
    return tuple(n // 2 for n in d)


def _conv(name, cin, cout, dims, k=3, s=1, p=1):
    out = tuple((n + 2 * p - k) // s + 1 for n in dims)
    return dict(name=name, cin=cin, cout=cout, k=k, s=s, p=p, vin=dims, vout=out,
                group="conv3x3" if (k, s, p) == (3, 1, 1) else "libconv")


def generator_convs(nf: int, dims: Sequence[int], color: bool = True,
                    semantic: bool = True, num_classes: int = 14) -> List[Dict]:
    """The generator's convs in call order, with their input extents, for a
    chunk of ``dims`` (Z, Y, X). Colour / semantic heads as requested; the
    colour branch runs if either is."""
    full = tuple(dims)
    half, quarter = _half(full), _half(_half(full))
    c = [_conv("geo_0a", 1, nf // 2, full, 5, 1, 2), _conv("geo_0b", nf // 2, nf, full, 4, 2, 1),
         _conv("geo_0c", nf, nf, half), _conv("geo_1a", nf, 2 * nf, half, 4, 2, 1),
         _conv("geo_1b", 2 * nf, 2 * nf, quarter), _conv("geo_1c", 2 * nf, 2 * nf, quarter),
         _conv("geo_1d", 2 * nf, 2 * nf, quarter), _conv("geo_2a", 2 * nf, nf, half),
         _conv("geo_2b", nf, nf, half), _conv("geo_occ_a", nf, nf // 2, full),
         _conv("geo_occ_b", nf // 2, 1, full), _conv("geo_3a", nf, nf // 2, full),
         _conv("geo_3b", nf // 2, nf // 2, full), _conv("geo_3c", nf // 2, 1, full)]
    if color or semantic:
        n_half, n_dec = 3 * nf, nf + 5
        c += [_conv("encoder_0a", 4, nf, full, 5, 1, 2),
              _conv("encoder_0b", nf, 2 * nf, full, 4, 2, 1),
              _conv("encoder_0c", 2 * nf, 2 * nf, half),
              _conv("encoder_geo", nf, nf, full, 4, 2, 1),
              _conv("encoder_1a", n_half, 5 * nf, half, 4, 2, 1),
              _conv("encoder_1b", 5 * nf, 5 * nf, quarter),
              _conv("encoder_1c", 5 * nf, 5 * nf, quarter),
              _conv("decoder_2a", 5 * nf, 2 * nf, half), _conv("decoder_2b", 2 * nf, 2 * nf, half),
              _conv("decoder_2c", 2 * nf, 2 * nf, half),
              _conv("decoder_3a", 2 * nf + n_half, 2 * nf, full),
              _conv("decoder_3b", 2 * nf, 2 * nf, full), _conv("decoder_3c", 2 * nf, nf, full),
              _conv("decoder_3d", nf, nf, full), _conv("decoder_3e", nf, nf, full)]
        if color:
            c += [_conv("color_head_a", n_dec, nf, full), _conv("color_head_b", nf, nf // 2, full),
                  _conv("color_head_c", nf // 2, 3, full)]
        if semantic:
            c += [_conv("semantic_head_a", n_dec, nf, full), _conv("semantic_head_b", nf, nf, full),
                  _conv("semantic_head_c", nf, num_classes, full)]
    return c


# the convs whose input is the data, not an activation: no input gradient
ENTRY_CONVS = ("geo_0a", "encoder_0a")


def conv_pass(conv: Dict, batch: int, which: str):
    """(operations, bytes) of one pass ('fwd', 'dx', 'dw') over ``batch`` rows."""
    k3 = conv["k"] ** len(conv["vin"])
    vin, vout = math.prod(conv["vin"]), math.prod(conv["vout"])
    flops = 2.0 * k3 * conv["cin"] * conv["cout"] * vout * batch
    x = vin * conv["cin"] * batch * F32
    y = vout * conv["cout"] * batch * F32
    w = k3 * conv["cin"] * conv["cout"] * F32
    return flops, x + y + w


def peak_rates(peaks: Dict, dtype: str = "float32"):
    """(operations a second, bytes a second) of the card for ``dtype``: float32
    is the dense TF32 rate over the passes of the 3xTF32 split."""
    if dtype == "float32":
        ops = peaks["tf32_dense_flops"] / peaks["float32_tf32_passes"]
    else:
        ops = peaks[f"{dtype}_dense_flops"]
    return ops, peaks["hbm_bytes_per_s"]


def _add(acc: Dict, group: str, flops: float, nbytes: float, rates) -> None:
    g = acc.setdefault(group, dict(flops=0.0, bytes=0.0, bound_s=0.0))
    g["flops"] += flops
    g["bytes"] += nbytes
    g["bound_s"] += max(flops / rates[0], nbytes / rates[1])


def disc_convs(nf_in: int, nf: int, patch_size: int, image_hw: Sequence[int],
               final: bool = True) -> List[Dict]:
    """The patch discriminator's 2D convs (4x4, stride 2, pad 1, LeakyReLU
    between; then a 1x1 ``final``), with the layer count rule of reference
    model.py:44-56."""
    rfs = (4, 10, 22, 46, 94, 190, 382, 766)
    n = len(rfs)
    for k, rf in enumerate(rfs):
        if patch_size < rf:
            n = k
            break
    n = min(int(math.floor(math.log2(min(image_hw)))), n)
    widths = [2 * nf, 4 * nf] + [8 * nf] * max(0, n - 2)
    cins = [nf_in] + widths[:n - 1]
    hw = tuple(image_hw)
    out = []
    for k in range(n):
        o = tuple((d + 2 - 4) // 2 + 1 for d in hw)
        out.append(dict(name=f"disc_{k}", cin=cins[k], cout=widths[k], k=4, s=2, p=1,
                        vin=hw, vout=o, group="disc"))
        hw = o
    if final:
        out.append(dict(name="disc_final", cin=widths[n - 1], cout=1, k=1, s=1, p=0,
                        vin=hw, vout=hw, group="disc"))
    return out


def train_step(cfg: Dict, batch: int, peaks: Dict) -> Dict:
    """Work of one full training step (the configuration's ``train`` dict):
    the generator's forward, ``dx`` of every conv but the entry convs, ``dW``
    of every conv; the discriminator's three calls a step (real and fake
    forward with their ``dW`` and, past the first layer, ``dx``; the
    generator's adversarial call, forward and ``dx`` through every layer).
    Returns {group: {flops, bytes, bound_s}} and ``total_flops``."""
    rates = peak_rates(peaks)
    acc: Dict = {}
    for c in generator_convs(cfg["nf_gen"], cfg["input_dim"]):
        for which in ("fwd", "dx", "dw"):
            if which == "dx" and c["name"] in ENTRY_CONVS:
                continue
            _add(acc, c["group"], *conv_pass(c, batch, which), rates)
    per = 3 * (cfg["weight_depth_loss"] > 0) + 3 * (cfg["weight_color_loss"] > 0)
    dconvs = disc_convs(2 * per, cfg["nf_disc"], cfg["patch_size"],
                        (cfg["style_height"], cfg["style_width"]),
                        final=not (cfg["patch_disc"] and cfg["disc_loss_type"] == "hinge"))
    for call in ("real", "fake", "gen"):
        for i, c in enumerate(dconvs):
            passes = ["fwd"]
            if call != "gen":
                passes.append("dw")
                if i > 0:
                    passes.append("dx")
            else:
                passes.append("dx")
            for which in passes:
                _add(acc, "disc", *conv_pass(c, batch, which), rates)
    acc["total_flops"] = sum(v["flops"] for v in acc.values())
    return acc


def serve_forward(cfg: Dict, n_windows: int, peaks: Dict) -> Dict:
    """Work of the generator's forward over ``n_windows`` real windows (the
    configuration's ``serve`` dict: colour and semantics on)."""
    rates = peak_rates(peaks)
    acc: Dict = {}
    for c in generator_convs(cfg["nf_gen"], cfg["chunk_dims"]):
        _add(acc, c["group"], *conv_pass(c, n_windows, "fwd"), rates)
    acc["total_flops"] = sum(v["flops"] for v in acc.values())
    return acc


def scale(work: Dict, n: float) -> Dict:
    """``work`` times ``n`` (steps or windows)."""
    out = {k: {kk: vv * n for kk, vv in v.items()} for k, v in work.items() if isinstance(v, dict)}
    out["total_flops"] = work["total_flops"] * n
    return out
