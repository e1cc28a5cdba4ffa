import os
import sys

# Tests run on a virtual 8-device CPU mesh: exact float64 and complex128,
# plus the sharding tests.  Must be set before jax import.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["XLA_FLAGS"] = flags

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Free compiled executables after each test module.

    Every (p, n, S) combination compiles a fresh while_loop core; dropping
    the in-process caches between modules keeps a worker's footprint
    bounded over the whole suite, while within a module the cache still
    amortizes recompiles.
    """
    yield
    jax.clear_caches()
