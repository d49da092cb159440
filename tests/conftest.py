"""Test configuration: force an 8-virtual-device CPU platform BEFORE jax
imports, so multi-device sharding (shard_map over a Mesh) is testable
without accelerators — the strategy from SURVEY.md §4 (parallel-vs-serial equivalence
tested single-machine, as the reference does with mpirun -n N on one box)."""

import os

#: RICHDEM_TEST_ON_DEVICE=1 leaves the real backend in place so the card
#: gates (``pytest -m gpu``, tests/test_gpu.py) run against the device.
_ON_DEVICE = os.environ.get("RICHDEM_TEST_ON_DEVICE") == "1"

if not _ON_DEVICE:
    os.environ["JAX_PLATFORMS"] = "cpu"
    # The CPU suite keeps its own persistent compile cache, a fixed
    # directory inside the checkout: sharing one with device processes
    # has produced corrupt entries that abort the reader mid-suite.
    os.environ.setdefault(
        "JAX_COMPILATION_CACHE_DIR",
        os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".jax_cache", "cpu-tests"))
    _flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in _flags:
        os.environ["XLA_FLAGS"] = (
            _flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not _ON_DEVICE:
    assert jax.devices()[0].platform == "cpu", jax.devices()
    # float64 fidelity when comparing device ops against the float64
    # oracle (ops remain dtype-explicit; the device path uses float32)
    jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _bound_process_state():
    """Clear JAX's in-process caches between test modules.

    The single-process full suite accumulates several GB of
    traced/compiled state across ~300 tests; the XLA:CPU compiler then
    has segfaulted tracing the sharded two-pass consumers.  Bounding the
    live state keeps a one-shot `pytest tests/ -q` run stable;
    re-compiles are cheap via the persistent on-disk cache."""
    yield
    import gc

    import jax as _jax

    _jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(12345)
