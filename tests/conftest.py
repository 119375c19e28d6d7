"""Test harness: 8 virtual devices on the CPU backend.

Run the CPU tests with ``JAX_PLATFORMS=cpu``; sharding tests then get a
real 8-device mesh without hardware. Tests marked ``gpu`` need a card and
skip elsewhere (see ``gpu`` below).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU (decided when
    the test runs, so every worker collects the same tests)."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU")
    return jax.devices()[0]
