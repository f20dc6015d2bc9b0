"""Test configuration: an 8-device virtual CPU mesh, and the ``gpu`` marker.

Tests run on the CPU (``JAX_PLATFORMS=cpu``): the sharding paths in
``parallel/`` get 8 virtual devices from
``XLA_FLAGS=--xla_force_host_platform_device_count=8``, set before the CPU
client starts. Pallas kernels run in interpret mode only where a test asks
for it (``interpret=True``); nothing switches to the interpreter on its own.

Tests that need the card carry ``@pytest.mark.gpu`` and take the ``gpu``
fixture, which skips them when JAX has no GPU. The decision is made inside
the fixture, never at import or collection, so every worker collects the
same tests. On the card: ``python -m pytest tests/ -m gpu``.
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test when JAX has none."""
    from ternary_spgemm_tpu import platform

    if platform.backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with -m gpu on the card)")
    return jax.devices()[0]
