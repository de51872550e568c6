"""Shared pytest configuration for the tier-1 suites."""

import pytest


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: statistically heavy tier-1 tests (bigger corpora / many "
        "sampling draws); run by default, deselect with -m 'not slow'")
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card (the port's CUDA kernels)")


@pytest.fixture(autouse=True, scope="module")
def _drop_compiled_programs_per_module():
    """Every compiled XLA program the suite touches stays pinned in jit
    caches, and each one holds several LLVM JIT code mappings.  Across the
    full suite that exhausts the kernel's per-process ``vm.max_map_count``
    (65530 by default) and the next compile segfaults inside XLA.  Modules
    share almost no (function, shape) cache entries, so dropping the caches
    at module boundaries caps the mapping count at the per-module peak for
    the price of a handful of recompiles."""
    yield
    import jax

    jax.clear_caches()
