"""No module the benchmark runs loads JAX, jaxlib, flax or the JAX package
``spsg_tpu`` (compared by whole top-level name: the port ``spsg_tpu_torch``
passes), and the reference loads nothing of the port: by the source of every
file, and by what a process that imports them all holds."""

import ast
import glob
import os
import subprocess
import sys

import pytest
from conftest import BENCH, ROOT

from lib.imports import FORBIDDEN, forbidden, top_level


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _sources(sub=""):
    return [p for p in glob.glob(os.path.join(BENCH, sub, "**", "*.py"), recursive=True)
            if "/tests/" not in p]


def test_top_level_names_are_compared_whole():
    assert top_level("spsg_tpu_torch.ops.raycast") == "spsg_tpu_torch"
    assert forbidden(["spsg_tpu_torch", "spsg_tpu_torch.ops", "numpy"]) == []
    assert forbidden(["spsg_tpu.ops", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax.linen", "jax.numpy", "jaxlib", "spsg_tpu.ops"]


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, BENCH))
def test_no_source_imports_jax_or_the_jax_package(path):
    names = list(_imports(path))
    assert forbidden(names) == []
    if os.sep + "reference" + os.sep in path:
        assert [n for n in names if top_level(n) == "spsg_tpu_torch"] == []


def test_a_process_that_loads_the_harness_holds_no_jax():
    code = f"""
import sys, glob, importlib, importlib.util, os
sys.path[:0] = [{BENCH!r}, {ROOT!r}]
import run, torch
from lib.imports import loaded_forbidden
for p in sorted(glob.glob(os.path.join({BENCH!r}, '**', '*.py'), recursive=True)):
    rel = os.path.relpath(p, {BENCH!r})
    if rel.startswith(('tests', 'run.py')):
        continue
    if rel.split(os.sep)[0] in ('reference', 'gen', 'work', 'lib'):
        importlib.import_module(rel[:-3].replace(os.sep, '.'))
        continue
    name = 'm_' + str(abs(hash(p)))
    spec = importlib.util.spec_from_file_location(name, p)
    mod = sys.modules[name] = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
import spsg_tpu_torch.training.step, spsg_tpu_torch.inference.chunked
print('BAD', loaded_forbidden())
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, USE_FLAX="0"))
    assert p.returncode == 0, p.stderr[-2000:]
    assert "BAD []" in p.stdout


def test_the_reference_holds_nothing_of_the_port():
    code = f"""
import sys, glob, importlib
sys.path[:0] = [{BENCH!r}]
import reference.step, reference.chunked, gen.chunks, gen.scenes
print('PORT', sorted(k for k in sys.modules if k.split('.')[0] in ('spsg_tpu_torch',) + {FORBIDDEN!r}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
                       cwd="/")
    assert p.returncode == 0, p.stderr[-2000:]
    assert "PORT []" in p.stdout
