"""Test harness config.

Tests run on the CPU with 8 virtual XLA devices so the multi-device sharding
paths (vq_tpu/dist) execute without an accelerator — the multi-host-
simulation tier SURVEY.md §4.3 calls for.  Env vars must be set before jax
is imported.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

# Force the CPU backend through the config API, whatever JAX_PLATFORMS says.
jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="session")
def gaussian_data(rng):
    """Seeded Gaussian test data, reference tests' substrate
    (e.g. reference tests/test_flat_quantized.py:6-10)."""
    x = rng.standard_normal((2000, 64)).astype(np.float32)
    q = rng.standard_normal((50, 64)).astype(np.float32)
    return x, q
