"""Test configuration.

Tests run on CPU with 8 virtual XLA devices (to exercise the
multi-device sharding path without accelerators) and with float64
enabled so the math kernels can be validated against scipy at full
precision.  Tests that need a GPU carry the ``gpu`` marker and skip
here (see the ``gpu`` fixture).
"""

import os

# must be set before jax is imported anywhere
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import pytest

jax.config.update("jax_enable_x64", True)


def cpu_devices():
    return jax.devices("cpu")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "realdata: published-catalog acceptance tests; need the .mat "
        "artifacts and SDSS spectra (see tests/test_realdata.py)",
    )
    config.addinivalue_line(
        "markers",
        "slow: survey-scale accuracy gates (minutes on the CPU suite; "
        "scripts/accuracy_gates.py runs the full-scale version)",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a CUDA device (run on the card with "
        "`JAX_PLATFORMS=cuda python -m pytest tests -m gpu -p no:xdist`)",
    )


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when there is none.  Decided
    here, at run time, never while a module is imported."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("no GPU device: card-only test")
    return devices[0]
