"""Test harness.

The tests run on the CPU: JAX_PLATFORMS=cpu (the default here when the
variable is unset) with 8 virtual CPU devices, so the multi-device sharding
paths compile and execute on one host. Tests that need an NVIDIA GPU carry
the ``gpu`` marker and take the ``gpu_device`` fixture, which skips them
where JAX has no GPU; on a machine with a card run them with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``. The quickest
whole check on the card is ``python chip_smoke.py``.
"""
import os

os.environ.setdefault("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_num_cpu_devices", 8)

# Persistent compile cache: the pipeline/BA tests compile large XLA programs
# (~5 min of compile on a cold run); cache executables across test runs
# (see slam_eds_tpu/compile_cache.py for where).
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from slam_eds_tpu.compile_cache import setup_cache  # noqa: E402

setup_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(3141592)


@pytest.fixture
def gpu_device():
    """JAX's first GPU; skips the test where there is none."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's default device is {dev.platform}")
    return dev
