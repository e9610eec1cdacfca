"""Test harness: an 8-virtual-device CPU mesh so sharding paths are
exercised without accelerator hardware (SURVEY.md §4).

JAX_PLATFORMS defaults to cpu; the tests marked `gpu` need the card and skip
elsewhere.  On a GPU machine run them with

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
)

import numpy as np
import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skips on other platforms")


@pytest.fixture
def gpu():
    """Skip unless JAX computes on a GPU (use with @pytest.mark.gpu).
    Decided here, at run time, never at import or collection: every xdist
    worker must collect the same tests."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX platform is "
                    f"{jax.default_backend()!r})")
    return jax.devices()[0]


@pytest.fixture
def rng():
    return np.random.default_rng(1234)
