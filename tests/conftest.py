"""Test configuration: 8 virtual CPU devices so multi-device sharding
logic is exercised without accelerator hardware (SURVEY.md §4: the
rebuild's analogue of the reference's GPU-free golden CRC strategy).

The suite runs on the CPU (``JAX_PLATFORMS=cpu``).  Tests marked ``gpu``
need an NVIDIA GPU: they take the ``gpu`` fixture, which skips them
when JAX finds none, and run on the card with
``python -m pytest -m gpu tests/``."""

import os

import pytest

# Must be set before jax is imported anywhere.
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when there is none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU (run on the card: "
                    "python -m pytest -m gpu tests/)")
    return devices[0]
