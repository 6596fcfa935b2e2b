"""Test configuration: force an 8-device virtual CPU mesh.

The suite runs on the CPU backend (``JAX_PLATFORMS=cpu``); multi-device
sharding is validated the JAX-native way — an
``xla_force_host_platform_device_count=8`` CPU mesh (SURVEY.md §4). The
program's GPU path is exercised by ``python chip_smoke.py`` on the card.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"  # tests always run on the virtual CPU mesh
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

import pytest  # noqa: E402


@pytest.fixture
def key():
    return jax.random.key(0)
