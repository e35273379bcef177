"""A fixture for the port's test modules that build JAX package workloads
in-process.

Building a JAX device workload points jax at its on-disk compilation
cache (``utils.jit_cache.enable_persistent_cache``), and the setting
outlives the test.  A later JAX mesh test in the same process then loads
its collective programs from that cache, and ``tests/test_ring.py``
aborts the process on them (ROADMAP Queue 3).  Import the fixture into a
test module to switch the cache back off when the module ends::

    from torch_jax_cache import jax_cache_off  # noqa: F401
"""

import pytest


@pytest.fixture(autouse=True, scope="module")
def jax_cache_off():
    yield
    import jax
    from jax._src import compilation_cache

    jax.config.update("jax_compilation_cache_dir", None)
    compilation_cache.reset_cache()
