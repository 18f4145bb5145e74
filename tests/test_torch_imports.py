"""The port stands without JAX: every module of spsg_tpu_torch imports in a
process where jax, flax, optax, orbax, triton and spsg_tpu cannot be imported,
and no source file of the port (or chip_smoke.py) names them."""

import os
import pkgutil
import re
import subprocess
import sys

import pytest

import spsg_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "spsg_tpu_torch")
BANNED = ("jax", "jaxlib", "flax", "optax", "orbax", "triton", "spsg_tpu")


def _modules():
    names = ["spsg_tpu_torch"]
    for m in pkgutil.walk_packages(spsg_tpu_torch.__path__, "spsg_tpu_torch."):
        names.append(m.name)
    return sorted(names)


def _sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        files += [os.path.join(root, n) for n in names if n.endswith((".py", ".cu", ".cpp"))]
    return sorted(files)  # one order in every test worker


def test_every_module_imports_without_jax_triton_or_the_jax_package():
    mods = _modules()
    assert len(mods) >= 24 and "spsg_tpu_torch.ops._build" in mods
    assert {"spsg_tpu_torch.losses.geo", "spsg_tpu_torch.losses.semantic",
            "spsg_tpu_torch.training.step", "spsg_tpu_torch.cli.datagen",
            "spsg_tpu_torch.ops.zslab_conv", "spsg_tpu_torch.ops.folded_conv"} <= set(mods)
    assert {f"spsg_tpu_torch.datagen.{m}" for m in (
        "chunks", "fusion", "params", "raster", "scan", "semantics", "sens")} <= set(mods)
    script = f"""
import importlib, importlib.abc, sys
BANNED = {BANNED!r}
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] in BANNED:
            raise ImportError('blocked in this test: ' + name)
sys.meta_path.insert(0, Block())
for m in {mods!r}:
    importlib.import_module(m)
bad = sorted(m for m in sys.modules if m.split('.')[0] in BANNED)
assert not bad, bad
print('imported', len({mods!r}))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                       cwd=REPO, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert f"imported {len(mods)}" in r.stdout


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_source_names_neither_jax_nor_the_jax_package(path):
    assert os.path.isfile(path), path
    text = open(path, encoding="utf-8").read()
    assert not re.search(r"^\s*(import|from)\s+(jax|flax|optax|orbax|triton)\b", text, re.M)
    assert not re.search(r"^\s*(import|from)\s+spsg_tpu(\.|\s)", text, re.M)
    # "spsg_tpu." as a module path in code; prose may name files of the JAX
    # package by their path ("spsg_tpu/ops/pallas_conv.py")
    assert not re.search(r"\bspsg_tpu\.", text)


def test_importing_the_package_builds_nothing():
    """Kernels are built at first CUDA use, never at import (there is no nvcc
    where these tests run)."""
    from spsg_tpu_torch.ops import _build, conv3x3
    assert not conv3x3._libs and not _build._LIBS
    from spsg_tpu_torch.ops import raycast
    assert not raycast._libs
    from spsg_tpu_torch.datagen import fusion
    assert not fusion._libs
    assert set(_build.SOURCES) == {"conv3x3", "conv3x3_dw", "raycast", "tsdf"}
