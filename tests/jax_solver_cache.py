"""The JAX package's compiled-solver LRU is process-wide, and its own tests
count its entries (``tests/test_fastdiag.py``). A port test file that runs
JAX solves imports this fixture, so that it leaves the LRU empty for
whatever runs next in the worker:

    from jax_solver_cache import leave_the_jax_solver_cache_empty  # noqa: F401
"""
import pytest


@pytest.fixture(autouse=True, scope="module")
def leave_the_jax_solver_cache_empty():
    yield
    from pyapes_tpu.solver import linalg

    linalg.clear_cache()
