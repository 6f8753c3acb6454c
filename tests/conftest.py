"""Test configuration: run on CPU with 8 virtual devices.

Mirrors the reference's CI strategy (integration-tests.yml:27-28): multi-rank
behavior is tested without hardware via oversubscription — there MPI ranks on
one node with `executor: reference`, here an 8-device virtual CPU mesh
(`--xla_force_host_platform_device_count=8`).
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = _flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

# jax may already be imported (and its platform captured) before this file
# runs — override via config, which wins as long as no backend has been
# initialised yet.
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_registry():
    from ogl_tpu import registry

    registry.global_registry.clear()
    yield
    registry.global_registry.clear()


@pytest.fixture
def rng():
    return np.random.default_rng(42)
