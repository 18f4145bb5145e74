"""The operation and byte reckoner (work/spsg.py) against a count taken from
the reference generator's own conv calls, at nf 4 and 16^3, and against
numbers worked out by hand."""

import math

import pytest
import torch
import torch.nn.functional as F

from reference.generator import Generator
from work import spsg

PEAKS = dict(tf32_dense_flops=495e12, float32_tf32_passes=3, bfloat16_dense_flops=989e12,
             hbm_bytes_per_s=3.35e12)


def _counted_convs(nf, dims, batch):
    """(name-free) conv shapes as the reference generator calls F.conv3d."""
    seen = []
    orig = F.conv3d

    def hook(x, w, b=None, stride=1, padding=0, dilation=1, groups=1):
        y = orig(x, w, b, stride, padding, dilation, groups)
        seen.append((tuple(x.shape), tuple(w.shape), tuple(y.shape)))
        return y

    gen = Generator(nf).eval()
    x = torch.zeros((batch,) + tuple(dims) + (4,))
    m = torch.zeros((batch,) + tuple(dims) + (1,))
    F.conv3d = hook
    try:
        with torch.no_grad():
            gen(x, m, pred_color=True, pred_semantic=True)
    finally:
        F.conv3d = orig
    return seen


@pytest.mark.parametrize("nf,dims,batch", [(4, (16, 16, 16), 1), (4, (16, 16, 16), 3),
                                           (20, (32, 16, 16), 2)])
def test_forward_operations_match_the_reference_calls(nf, dims, batch):
    calls = _counted_convs(nf, dims, batch)
    convs = spsg.generator_convs(nf, dims)
    assert len(calls) == len(convs) == 35
    assert sum(c["group"] == "conv3x3" for c in convs) == 28
    hand = 0.0
    for (xs, ws, ys) in calls:
        cout, cin, k = ws[0], ws[1], ws[2]
        hand += 2.0 * k ** 3 * cin * cout * math.prod(ys[2:]) * ys[0]
    ours = sum(spsg.conv_pass(c, batch, "fwd")[0] for c in convs)
    assert ours == hand
    # every reckoned conv has a call of its input / output shape
    shapes = sorted((xs[1], ws[0], xs[2:], ys[2:]) for xs, ws, ys in calls)
    mine = sorted((c["cin"], c["cout"], tuple(c["vin"]), tuple(c["vout"])) for c in convs)
    assert shapes == mine


def test_hand_count_of_one_layer_and_a_step():
    # decoder_3a at nf 4 on 16^3: 3^3 conv, 2*4+3*4 = 20 -> 8 channels, 4096 voxels
    c = [c for c in spsg.generator_convs(4, (16, 16, 16)) if c["name"] == "decoder_3a"][0]
    flops, nbytes = spsg.conv_pass(c, 1, "fwd")
    assert flops == 2 * 27 * 20 * 8 * 4096
    assert nbytes == 4 * (4096 * 20 + 4096 * 8 + 27 * 20 * 8)
    # geo_0b: 4^3 stride 2 from 16^3 to 8^3, 2 -> 4 channels
    g = [c for c in spsg.generator_convs(4, (16, 16, 16)) if c["name"] == "geo_0b"][0]
    assert g["vout"] == (8, 8, 8) and g["group"] == "libconv"
    assert spsg.conv_pass(g, 2, "dw")[0] == 2 * 64 * 2 * 4 * 512 * 2
    cfg = dict(nf_gen=4, input_dim=[16, 16, 16], weight_depth_loss=1.0, weight_color_loss=1.0,
               nf_disc=4, patch_size=96, style_height=32, style_width=48, patch_disc=True,
               disc_loss_type="vanilla")
    w = spsg.train_step(cfg, 2, PEAKS)
    fwd = sum(spsg.conv_pass(c, 2, "fwd")[0] for c in spsg.generator_convs(4, (16, 16, 16)))
    entry = sum(spsg.conv_pass(c, 2, "fwd")[0] for c in spsg.generator_convs(4, (16, 16, 16))
                if c["name"] in spsg.ENTRY_CONVS)
    assert w["conv3x3"]["flops"] + w["libconv"]["flops"] == 3 * fwd - entry
    assert w["total_flops"] == pytest.approx(w["conv3x3"]["flops"] + w["libconv"]["flops"]
                                             + w["disc"]["flops"])
    # the bound is never below either roof
    for g in ("conv3x3", "libconv", "disc"):
        assert w[g]["bound_s"] >= w[g]["flops"] / (495e12 / 3) - 1e-15
        assert w[g]["bound_s"] >= w[g]["bytes"] / 3.35e12 - 1e-15


def test_discriminator_layers_follow_the_receptive_field_rule():
    convs = spsg.disc_convs(12, 8, 96, (256, 320))
    assert [c["cout"] for c in convs] == [16, 32, 64, 64, 64, 1]
    assert convs[4]["vout"] == (8, 10)
