"""Test configuration: force an 8-device virtual CPU mesh.

The tests run on the local CPU backend, also on a host with a GPU:
`jax.config.update` selects it before any device is touched. Tests that
need the card carry the `gpu` marker and skip where JAX sees no GPU (the
`gpu_device` fixture); on the card run them with
`JAX_PLATFORMS=cpu,cuda python -m pytest -m gpu tests/`.

The reference repo's only QA gate is compilation under -Werror plus one Catch2
smoke test (reference test/tests-logic-cfsd18-sensation-slam.cpp:26-30); per
SURVEY.md §4 we do far better: kernel unit tests with NumPy oracles, synthetic
track integration tests, and multi-device sharding tests on this virtual mesh.
"""
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
# CPU is the default backend. A list that starts with cpu (cpu,cuda) keeps
# the card visible beside it for the `gpu`-marked tests.
_platforms = os.environ.get("JAX_PLATFORMS", "")
if not _platforms.startswith("cpu"):
    _platforms = "cpu"
os.environ["JAX_PLATFORMS"] = _platforms

import jax  # noqa: E402

jax.config.update("jax_platforms", _platforms)

import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_between_modules():
    """Drop compiled executables between test modules.

    The suite compiles hundreds of distinct XLA:CPU programs (many of them
    8-device shard_maps); with all of them held live by jit/lru caches the
    runtime eventually segfaults inside a later sharded dispatch
    (deterministically ~157 programs in, jaxlib 0.9.0 CPU). Each module's
    programs are independent, so freeing them between modules keeps the live
    set small at no re-trace cost within a module."""
    yield
    jax.clear_caches()


@pytest.fixture
def gpu_device():
    """The first GPU, for tests marked `gpu`; skips where none is visible.

    Decided here, at run time, and never while a module is imported: the
    suite runs under several workers, which must all collect the same
    tests."""
    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU visible to JAX (card-only test)")
