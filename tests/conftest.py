"""Test configuration: run on the CPU with 8 virtual devices.

Multi-card sharding tests need a device mesh, so XLA's host-platform
device simulation provides one (SURVEY §4 "distributed tests").  Pallas
kernels run in interpret mode there.  `python -m pytest tests -m gpu`
selects the card-only tests instead and leaves the platform to JAX, so on
a machine with a GPU they run on it (each decides in its `gpu` fixture).
"""

import os

import jax
import pytest


def pytest_configure(config):
    if config.getoption("markexpr", "") == "gpu":
        return
    # Must happen before any test touches a backend.
    os.environ["JAX_PLATFORMS"] = "cpu"
    xla_flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in xla_flags:
        os.environ["XLA_FLAGS"] = (
            xla_flags + " --xla_force_host_platform_device_count=8"
        ).strip()
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)
    # CPU test compiles are seconds; determinism beats reuse here.
    jax.config.update("jax_enable_compilation_cache", False)


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop every live compiled executable after each test module.

    With the process-lifetime caches left alone, a single-process run of
    the full suite accumulates a few hundred XLA:CPU executables and then
    SEGFAULTS inside `backend_compile_and_load` (jax 0.9.0); the same
    programs compile fine in isolation, so the crash is cumulative
    in-process compiler state.  Cross-module cache hits are rare, so the
    cost is a few extra compiles per module.
    """
    yield
    jax.clear_caches()
