"""Test harness: run everything on a virtual 8-device CPU mesh.

Sharding paths are validated on XLA's host platform with 8 virtual
devices. Tests that need the card carry the ``gpu`` marker and skip
unless the default device is a GPU; run them on the card with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from valkey_search_tpu.runtime import jaxinit  # noqa: E402

jaxinit.init()


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


@pytest.fixture()
def gpu():
    """The default device, when it is a GPU; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; the default device is {dev.platform}")
    return dev


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "slow: long-running multi-process integration tests"
    )
    config.addinivalue_line(
        "markers", "gpu: needs the card (skips when no GPU is the default "
        "device)"
    )
