"""Test harness config: CPU backend with 8 virtual devices.

Tests run on the CPU (`JAX_PLATFORMS=cpu`, set here unless the caller chose
a platform) with 8 virtual host devices for the sharding tests. Tests that
need a GPU carry the `gpu` marker and take the `gpu_device` fixture, which
skips them when JAX has no GPU; `chip_smoke.py` runs them on the card.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
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
    return np.random.default_rng(1337)


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test when JAX has none."""
    gpus = [d for d in jax.devices() if d.platform == "gpu"]
    if not gpus:
        pytest.skip("needs a GPU (run through chip_smoke.py on the card)")
    return gpus[0]
