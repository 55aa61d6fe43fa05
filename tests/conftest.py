"""Test configuration: JAX on a virtual 8-device CPU platform by default.

Tests validate numerics and multi-device sharding on the CPU backend (the
strategy SURVEY.md §4 prescribes: --xla_force_host_platform_device_count).
Tests that need the card carry the ``gpu`` marker and take the ``gpu``
fixture; they skip without one, and run on a gpu host with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    flags += " --xla_force_host_platform_device_count=8"
if "xla_backend_optimization_level" not in flags:
    # the limb-arithmetic graphs are wide chains of tiny integer ops; XLA:CPU's
    # optimizer is superlinear on them and adds minutes per jit at -O1+
    flags += " --xla_backend_optimization_level=0"
os.environ["XLA_FLAGS"] = flags.strip()

import pytest  # noqa: E402

from vgen_tpu import compile_cache  # noqa: E402

compile_cache.enable()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: heavy numerics-conformance compiles (XLA:CPU takes minutes "
        "per jit at -O0).  Skipped unless RUN_SLOW=1; run them once per "
        "change to ops/ numerics.",
    )
    config.addinivalue_line(
        "markers",
        "gpu: needs a gpu visible to JAX (take the `gpu` fixture, which "
        "skips without one)",
    )


def pytest_collection_modifyitems(config, items):
    if os.environ.get("RUN_SLOW") == "1":
        return
    skip = pytest.mark.skip(
        reason="slow numerics conformance (set RUN_SLOW=1 to run)"
    )
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip)


@pytest.fixture
def gpu():
    """The first JAX device, when it is a gpu; skips the test otherwise."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a gpu; JAX sees {dev.platform} only")
    return dev
