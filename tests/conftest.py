"""Test configuration: run on a virtual 8-device CPU mesh.

Tests must be runnable anywhere (the reference's tests likewise ran on
"any OpenCL device", `src/tests/test_rng.c:65`), so the suite runs on the
CPU with Pallas kernels interpreted. The card-only tests carry the `gpu`
marker and skip off the GPU (the `gpu_backend` fixture decides, at run
time); `pytest -m gpu` leaves the backend to JAX so they meet the card.
x64 is enabled because the framework supports long/ulong/double element
types like the reference's CloType table
(`src/cl_ops/common/clo_common.c:54-68`).
"""

import os

import pytest


def pytest_configure(config):
    if (config.getoption("markexpr") or "").strip() != "gpu":
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8").strip()
    import jax
    jax.config.update("jax_enable_x64", True)
    # Never write the persistent compile cache from tests.
    jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture
def gpu_backend():
    """Skip unless JAX's default backend is a GPU."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU; on the card run "
                    "`pytest -m gpu -o addopts=\"\"`")
