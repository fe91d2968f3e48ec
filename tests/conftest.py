"""Test configuration: run JAX on a virtual 8-device CPU mesh.

The tests run on the host CPU; the distributed tests emulate an 8-way time
mesh with host-platform virtual devices (SURVEY.md §4). Parity tests need
float64 (PCG to 1e-8), hence jax_enable_x64. The platform is set through
jax.config before the first backend use, so it holds whatever
JAX_PLATFORMS says.

Tests that need the GPU take the ``gpu`` fixture below (and carry the
``gpu`` marker): it skips them here, deciding inside the fixture, never at
import or collection time. On the card, the same path runs end to end
through ``python chip_smoke.py`` (README, "Running on a GPU").
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first GPU device, or a skip when this process runs on the CPU."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip("needs a GPU; this process runs JAX on the CPU")
    return devs[0]
