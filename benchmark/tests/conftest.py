"""Tests of the benchmark's harness, reference and reckoner. They run on the
CPU at small sizes; tests that need a CUDA card carry the ``card`` marker and
skip inside the test when there is none (the ``card`` fixture).

    python -m pytest benchmark/tests -q -p no:cacheprovider
"""

import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here: this test runs on the card")
    return "cuda"


@pytest.fixture(scope="session", autouse=True)
def _drivers():
    """The drivers as importable modules (``drivers_train``, ``drivers_serve``)."""
    import importlib.util

    for name, f in (("drivers_train", "train_step.py"), ("drivers_serve", "serve_chunked.py")):
        if name not in sys.modules:
            spec = importlib.util.spec_from_file_location(name, os.path.join(BENCH, "drivers", f))
            mod = importlib.util.module_from_spec(spec)
            sys.modules[name] = mod
            spec.loader.exec_module(mod)
