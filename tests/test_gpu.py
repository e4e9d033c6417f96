"""Tests that need an NVIDIA GPU: the winner kernel compiled for the card.
They skip without one; run them on a GPU machine with

    JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu
"""
import jax
import jax.numpy as jnp
import pytest

from cbtr_tpu.harness.measure import winner_agreement
from cbtr_tpu.models import robot_lens_scene
from cbtr_tpu.ops.intersect import (
    intersect_rays,
    select_candidates,
    sweep_backend,
    sweep_codes_xla,
)
from cbtr_tpu.ops.pallas_sweep import sweep_winner_pallas

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def robot():
    return robot_lens_scene(res=64)


def test_compiled_kernel_matches_xla(gpu_device, robot):
    s = jax.device_put(jnp.asarray(robot.start).reshape(-1, 3), gpu_device)
    d = jax.device_put(jnp.asarray(robot.direction).reshape(-1, 3), gpu_device)
    got = jax.jit(lambda s_, d_: sweep_winner_pallas(robot.patches, s_, d_))(s, d)
    with jax.default_matmul_precision("highest"):
        code, dist = jax.jit(lambda s_, d_: sweep_codes_xla(
            robot.patches, s_, d_))(s, d)
        ref = select_candidates(code, dist, robot.patches.neighbours)
    agree = winner_agreement(ref, got)
    assert agree["hits"] >= 100
    assert agree["hit_set"] >= 0.999 and agree["winner"] >= 0.999, agree


def test_auto_backend_is_the_kernel(gpu_device, robot):
    assert sweep_backend(gpu_device.platform, robot.patches.num_patches) == "pallas"
    s = jnp.asarray(robot.start).reshape(-1, 3)[:4096]
    d = jnp.asarray(robot.direction).reshape(-1, 3)[:4096]
    hlo = jax.jit(lambda s_, d_: intersect_rays(robot.patches, s_, d_)).lower(
        s, d).as_text()
    assert "__gpu$xla.gpu.triton" in hlo
