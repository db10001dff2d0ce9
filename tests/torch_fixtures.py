"""Fixtures shared by the tests of pyrenderer_tpu_torch (tests/test_torch_*.py)."""

import pytest


@pytest.fixture(scope="module", autouse=True)
def private_jax_native_cache(tmp_path_factory):
    """The JAX package compiles its native builders (g++, at first use in a
    process) into PYRENDERER_TPU_CACHE, by default one directory that every
    test process shares, where a process can load a library another one is
    still writing. A module that imports this fixture builds them in a
    directory of its own."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYRENDERER_TPU_CACHE", str(tmp_path_factory.mktemp("jax_native")))
        yield
