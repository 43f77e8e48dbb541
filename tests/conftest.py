"""Test configuration.

Tests run on the CPU with 8 virtual devices so multi-device sharding
paths (SURVEY.md section 5 "Distributed communication backend") are
exercised without a GPU. Must set env vars before JAX initializes.
"""

import os
import sys

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# pin the CPU platform in code, whatever JAX_PLATFORMS says: the tests
# are the CPU engine's (GPU checks live in chip_smoke.py)
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)
