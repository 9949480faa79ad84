"""Test configuration.

Tests run on CPU with 8 virtual devices so the multi-device sharding path
(mesh + shard_map halo exchange) is exercised without accelerators, and in
float64 so numerics can be validated at the reference's (Julia Float64)
tolerances. Must run before jax initializes a backend.

Tests that need an NVIDIA GPU carry the ``gpu`` marker, take the ``gpu``
fixture and skip where there is none; they drive the card from a child
process. On a machine with a GPU: ``python -m pytest -m gpu tests/``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

from oceananigans_tpu.config import config  # noqa: E402

config.float_type = "float64"

import pytest  # noqa: E402


@pytest.fixture
def float32_defaults():
    config.float_type = "float32"
    yield
    config.float_type = "float64"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips where there is none")


@pytest.fixture
def gpu():
    """Skips the test where no NVIDIA GPU is present. Asks ``nvidia-smi``,
    so that this process stays off the card for the child that uses it."""
    import shutil
    import subprocess
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run(
            [smi, "-L"], capture_output=True).returncode != 0:
        pytest.skip("needs an NVIDIA GPU (nvidia-smi finds none here)")
