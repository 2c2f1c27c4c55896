"""Test configuration: force an 8-device virtual CPU mesh and f64.

The tests run on the CPU; multi-device sharding tests run against a
virtual CPU mesh.  Kernels run in Pallas interpret mode here; their
compiled form is checked on the GPU by chip_smoke.py.
"""

import os

# Must be set before jax is imported anywhere.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
# Persistent compilation cache DISABLED for the CPU suite: jaxlib has
# been seen to segfault nondeterministically while (de)serializing large
# CPU executables through the cache.  Tests pay recompiles; correctness
# is unaffected.
jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def eight_devices():
    devs = jax.devices()
    assert len(devs) == 8, devs
    return devs
