"""Test environment: the CPU backend with 8 virtual devices, unless
JAX_PLATFORMS names another platform (``JAX_PLATFORMS=cuda pytest -m gpu``
runs the tests marked ``gpu`` on a card).

Multi-device sharding paths are validated on a virtual CPU mesh (SURVEY.md
§4). Both variables must be set before JAX initializes its backends.
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "--xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

from npge_tpu.util.jaxcache import enable_compilation_cache  # noqa: E402

enable_compilation_cache()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "gpu: needs an NVIDIA GPU; skips elsewhere, and chip_smoke.py runs it",
    )


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX_PLATFORMS=cuda)")
