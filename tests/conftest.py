import os

# Force CPU with 8 virtual devices for sharding tests, and 64-bit floats so
# the partition/cost path matches the reference's double precision.
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax
import pytest

# Pin the platforms before any backend initializes: the CPU unless
# JAX_PLATFORMS asks for more (``JAX_PLATFORMS=cuda,cpu pytest -m gpu
# tests/`` runs the card-only tests on a GPU machine).
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (skips where JAX sees none)")
    config.addinivalue_line("markers", "slow: long-running test")


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where there is none."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX (run with JAX_PLATFORMS=cuda,cpu "
                    "on a GPU machine)")
