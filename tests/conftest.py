"""Shared test configuration.

NOTE: no XLA_FLAGS / device-count forcing here — tests must see the real
single CPU device (the 512-device mesh exists only inside launch/dryrun.py,
and multi-device tests spawn subprocesses).
"""

import sys

import numpy as np
import pytest

try:
    import hypothesis  # noqa: F401
except ImportError:
    # container lacks hypothesis; run property tests on the deterministic stub
    import importlib.util
    import pathlib

    _spec = importlib.util.spec_from_file_location(
        "hypothesis", pathlib.Path(__file__).parent / "_hypothesis_stub.py")
    _stub = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_stub)
    sys.modules["hypothesis"] = _stub


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc; skips without them")


@pytest.fixture
def rng():
    return np.random.default_rng(0)
