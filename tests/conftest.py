"""Test config: JAX on the CPU with 8 virtual devices, so the sharding
tests need no accelerator (SURVEY §4 implication: CPU-only correctness
CI). ``JAX_PLATFORMS`` set in the environment wins: the tests marked
``gpu`` run on the card with ``JAX_PLATFORMS=cuda python -m pytest -m gpu
tests/``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import pytest

try:  # the plotting tests need it; the engine's tests do not
    import matplotlib

    matplotlib.use("Agg")
except ImportError:
    pass


@pytest.fixture
def gpu():
    """The first GPU; skips the test when JAX finds none. Decided here,
    at run time, so every xdist worker collects the same tests."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip("needs an NVIDIA GPU; run on the card with "
                    "JAX_PLATFORMS=cuda python -m pytest -m gpu tests/")
    return dev
