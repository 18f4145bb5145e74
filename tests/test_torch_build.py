"""How the port's CUDA sources are built, checked without nvcc: the binary of a
source is named by the source and the headers beside it (csrc/*.cuh), and the
shared header names neither JAX nor the JAX package."""

import os
import re

from spsg_tpu_torch.ops import _build


def test_a_changed_header_renames_the_binary(tmp_path):
    """Editing csrc/tf32_mma.cuh rebuilds both kernels instead of loading a
    stale library."""
    src, hdr = tmp_path / "k.cu", tmp_path / "h.cuh"
    src.write_text('#include "h.cuh"\n')
    hdr.write_text("// one\n")
    first = _build._out_path(str(src), "k")
    assert _build._out_path(str(src), "k") == first
    hdr.write_text("// two\n")
    assert _build._out_path(str(src), "k") != first


def test_the_shared_header_is_beside_both_sources_and_names_no_jax():
    names = sorted(os.listdir(_build.CSRC_DIR))
    assert {"conv3x3.cu", "conv3x3_dw.cu", "tf32_mma.cuh"} <= set(names)
    for n in ("conv3x3.cu", "conv3x3_dw.cu"):
        text = open(os.path.join(_build.CSRC_DIR, n), encoding="utf-8").read()
        assert '#include "tf32_mma.cuh"' in text, n
    text = open(os.path.join(_build.CSRC_DIR, "tf32_mma.cuh"), encoding="utf-8").read()
    assert not re.search(r"\b(jax|flax|spsg_tpu)\b", text)
