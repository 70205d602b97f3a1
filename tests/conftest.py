"""Test configuration.

The suite runs on the CPU backend with 8 virtual devices, so the mesh
paths (shard_map over a device mesh) execute without accelerators and
the GPU kernel runs through the Pallas interpreter.  Tests marked
``gpu`` need an NVIDIA GPU: ``python -m pytest -m gpu`` keeps JAX's
default platform for them, and they skip where no GPU is present.
"""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def pytest_configure(config):
    if config.option.markexpr.strip() == "gpu":
        return          # card run: leave JAX on its default platform
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    import jax

    jax.config.update("jax_platforms", "cpu")


def pytest_report_header(config):
    import jax

    return f"jax backend: {jax.default_backend()} ({len(jax.devices())} devices)"


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules():
    """Drop compiled executables at module boundaries.

    The full suite compiles 1000+ distinct XLA CPU programs in one
    process; past a threshold the NEXT compile segfaults inside
    LLVM (jax 0.9.0 CPU backend — deterministic at the same test across
    runs, absent when any subset runs alone).  Freeing executables
    between modules keeps the live-code footprint under that threshold;
    per-module recompiles are cheap (each module re-warms only what it
    uses).
    """
    yield
    import jax

    jax.clear_caches()


@pytest.fixture(scope="session")
def fixtures_dir():
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures")


@pytest.fixture
def gpu():
    """Skip unless JAX's default backend is a GPU (decided at run time)."""
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; JAX backend is {jax.default_backend()}")
    return jax.devices()[0]
