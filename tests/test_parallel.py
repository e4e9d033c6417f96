"""Multi-device sharding tests on the virtual 8-device CPU mesh
(tests/conftest.py sets xla_force_host_platform_device_count=8)."""
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
import pytest

from cbtr_tpu.bezier import build_from_trimesh
from cbtr_tpu.harness import preprocess
from cbtr_tpu.mesh.core import make_unit_sphere
from cbtr_tpu.models import sphere_lens_scene
from cbtr_tpu.models.lens_model import params_from_scene
from cbtr_tpu.ops import intersect_rays
from cbtr_tpu.parallel import (
    intersect_rays_patch_sharded,
    make_multihost_train_step,
    multihost_mesh,
    render_multihost,
)
from cbtr_tpu.render.render import render_lens_image


@pytest.fixture(scope="module")
def scene():
    return sphere_lens_scene(res=32, sectors=9, belts=4)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_ray_sharded_render_matches_single_device(scene):
    mesh = multihost_mesh()
    img_sharded = render_multihost(
        mesh, scene.patches, scene.refractive_index, scene.start,
        scene.direction, scene.screen_plane, resolution=32,
    )
    img_local = render_lens_image(
        scene.patches, scene.refractive_index, scene.start, scene.direction,
        scene.screen_plane, resolution=32,
    )
    np.testing.assert_allclose(
        np.asarray(img_sharded), np.asarray(img_local), atol=1e-3
    )


def test_patch_sharded_intersection_matches_replicated(scene):
    mesh = Mesh(np.asarray(jax.devices()), ("patches",))
    start = np.asarray(scene.start[:64])
    direction = np.asarray(scene.direction[:64])
    a = intersect_rays(scene.patches, jnp.asarray(start), jnp.asarray(direction))
    b = intersect_rays_patch_sharded(
        scene.patches, jnp.asarray(start), jnp.asarray(direction), mesh
    )
    np.testing.assert_array_equal(np.asarray(a.what), np.asarray(b.what))
    np.testing.assert_array_equal(np.asarray(a.patch), np.asarray(b.patch))
    hitm = np.asarray(a.what) == 4  # dead-lane points carry shard-dependent garbage
    np.testing.assert_allclose(
        np.asarray(a.point)[hitm], np.asarray(b.point)[hitm], atol=1e-3
    )


def test_2d_mesh_rays_and_patches(scene):
    devices = np.asarray(jax.devices()).reshape(4, 2)
    mesh = Mesh(devices, ("rays", "patches"))
    start = np.asarray(scene.start[:64])
    direction = np.asarray(scene.direction[:64])
    a = intersect_rays(scene.patches, jnp.asarray(start), jnp.asarray(direction))
    b = intersect_rays_patch_sharded(
        scene.patches, jnp.asarray(start), jnp.asarray(direction), mesh,
        ray_axis="rays",
    )
    np.testing.assert_array_equal(np.asarray(a.what), np.asarray(b.what))
    # distances differ by f32 reduction-order noise across shard layouts
    np.testing.assert_allclose(
        np.asarray(a.distance), np.asarray(b.distance), rtol=1e-4
    )


def test_sharded_train_step_runs_and_reduces(scene):
    mesh = multihost_mesh()
    target = jnp.zeros((32, 32), jnp.float32)
    step = make_multihost_train_step(
        mesh, scene.patches, scene.screen_plane, target, resolution=32,
        learning_rate=1e-4,
    )
    params = params_from_scene(scene)
    new_params, loss = step(params, scene.start, scene.direction)
    assert np.isfinite(float(loss)) and float(loss) > 0
    delta = np.abs(
        np.asarray(new_params.control_points) - np.asarray(params.control_points)
    )
    assert np.isfinite(delta).all()
    assert (delta > 0).any(), "step did not move the control points"
    # one more step: loss should not explode
    _, loss2 = step(new_params, scene.start, scene.direction)
    assert np.isfinite(float(loss2))
