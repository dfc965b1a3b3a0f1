"""Test environment: a virtual 8-device host platform for the sharding
tests, the shared compile cache, and the card check for ``gpu`` tests.

``JAX_PLATFORMS`` picks the backend (the CPU suite sets it to ``cpu``; on
a machine with a card, ``-m gpu`` runs the card tests).  The device-count
flag must be set before jax is imported anywhere.
"""
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from kspecanal_tpu.utils import compile_cache  # noqa: E402

compile_cache.enable_compile_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(20260817)


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when this process has none.  Decided here,
    at test time — never at import or collection, so every pytest-xdist
    worker collects the same tests."""
    import jax
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs an NVIDIA GPU (run `pytest -m gpu` on the card)")
    return devs[0]
