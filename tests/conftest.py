"""Test configuration: CPU backend with 8 virtual devices and x64.

The reference implementation (hydra-pspec) is float64/complex128 NumPy/SciPy.
Correctness tests run on CPU with x64 enabled so we can compare against
NumPy oracles at tight tolerances; multi-device sharding tests use the
8 virtual CPU devices as a "fake pod".

Tests marked ``gpu`` take the ``gpu`` fixture, which skips them unless JAX
sees a GPU. Run them on a GPU machine with
``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
"""
import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

jax.config.update("jax_enable_x64", True)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX has none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda,cpu python -m pytest "
                    "-m gpu tests/")
    return devices[0]
