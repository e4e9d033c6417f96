"""Test configuration: run on a virtual 8-device CPU mesh unless told
otherwise.

Multi-device sharding paths are validated without accelerators by forcing
the host platform to expose 8 devices.  JAX_PLATFORMS defaults to cpu here;
tests marked `gpu` need a card and skip without one (the `gpu_device`
fixture decides at run time, never at import).  Run them on a GPU machine
with JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu.
"""
import os
import sys

flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import pytest  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


@pytest.fixture
def gpu_device():
    """The first GPU, or a skip when JAX has none."""
    import jax

    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda,cpu on a card)")
    return gpus[0]
