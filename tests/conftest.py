"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The tests check numerics and the multi-device sharding path on the host
CPU with 8 virtual devices; the on-card checks are `chip_smoke.py`.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

# a pytest plugin may have imported jax before this file ran, after
# which the environment variable alone no longer selects the platform
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402


@pytest.fixture()
def rng():
    import numpy as np
    return np.random.default_rng(0xC0B5)
