"""Multi-host distributed layer tests.

Single-process coverage runs on the virtual 8-device CPU mesh (conftest);
true multi-process coverage spawns two jax.distributed processes (Gloo CPU
collectives) through benchmarks/multiprocess_render.py and checks both
converge to the same replicated image.
"""
import glob
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cbtr_tpu.models import sphere_lens_scene
from cbtr_tpu.models.lens_model import params_from_scene
from cbtr_tpu.parallel.multihost import (
    init_distributed,
    make_multihost_train_step,
    multihost_mesh,
    process_ray_shard,
    render_multihost,
)
from cbtr_tpu.render.render import render_lens_image

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def scene():
    return sphere_lens_scene(res=16, sectors=9, belts=4)


def test_init_distributed_noop_single_process():
    # no coordinator configured -> single-process fallback, not an error
    assert init_distributed() is False


def test_render_multihost_matches_single_device(scene):
    mesh = multihost_mesh()
    assert mesh.devices.size == 8
    img = render_multihost(
        mesh, scene.patches, scene.refractive_index, scene.start,
        scene.direction, scene.screen_plane, resolution=32,
    )
    ref = render_lens_image(
        scene.patches, scene.refractive_index, jnp.asarray(scene.start),
        jnp.asarray(scene.direction), scene.screen_plane, resolution=32,
    )
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref), atol=1e-4)


def test_process_ray_shard_pads_to_device_multiple(scene):
    mesh = multihost_mesh()
    start = np.zeros((13, 3), np.float32)  # 13 % 8 != 0
    direction = np.tile(np.array([1.0, 0, 0], np.float32), (13, 1))
    s, d, w = process_ray_shard(start, direction, mesh)
    assert s.shape == (16, 3) and w.shape == (16,)
    # pad rays are valid unit rays with weight 0; real rays weight 1
    np.testing.assert_allclose(
        np.linalg.norm(np.asarray(d), axis=-1), 1.0, atol=1e-6
    )
    np.testing.assert_array_equal(np.asarray(w), [1.0] * 13 + [0.0] * 3)
    # second line of defence: pads head -x, away from every +x scene
    np.testing.assert_array_equal(np.asarray(d)[13:, 0], [-1.0] * 3)


def test_render_multihost_unaligned_ray_count_unpolluted(scene):
    """R % device_count != 0: the padded rays must not splat any weight.

    Regression test for the round-2 advisor finding: pads used to start at
    the origin heading +x — the exact central beam ray of every scene — and
    contaminated the image and the training gradient."""
    mesh = multihost_mesh()
    start = np.asarray(scene.start)
    direction = np.asarray(scene.direction)
    # drop 3 rays so R = 253 % 8 != 0 (ortho grid corner rays: they miss)
    R = start.shape[0] - 3
    img = render_multihost(
        mesh, scene.patches, scene.refractive_index, start[:R],
        direction[:R], scene.screen_plane, resolution=32,
    )
    ref = render_lens_image(
        scene.patches, scene.refractive_index, jnp.asarray(start[:R]),
        jnp.asarray(direction[:R]), scene.screen_plane, resolution=32,
    )
    # atol: a polluting pad ray adds ~1.0 of splat weight; jit-fusion
    # rounding between the sharded and single-device programs moves
    # boundary-ray bilinear weights by <~1e-3 (Newton chaos amplification)
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref), atol=2e-3)
    np.testing.assert_allclose(
        float(jnp.sum(img)), float(jnp.sum(ref)), rtol=1e-4
    )
    # worst-case pads: rays that WOULD hit the lens if traced — zero weight
    # must still keep the image identical (the mask is the guarantee, the
    # -x pad direction only a backstop)
    bad_start = np.concatenate([start[:R], np.zeros((3, 3), np.float32)])
    bad_dir = np.concatenate(
        [direction[:R], np.tile(np.array([1.0, 0, 0], np.float32), (3, 1))]
    )
    w = np.concatenate([np.ones(R, np.float32), np.zeros(3, np.float32)])
    masked = render_lens_image(
        scene.patches, scene.refractive_index, jnp.asarray(bad_start),
        jnp.asarray(bad_dir), scene.screen_plane, resolution=32,
        weights=jnp.asarray(w),
    )
    # same 2e-3 rounding allowance: appending the 3 pad rays changes the
    # batch shape, hence the fused program, hence boundary-ray rounding
    np.testing.assert_allclose(np.asarray(masked), np.asarray(ref), atol=2e-3)
    np.testing.assert_allclose(
        float(jnp.sum(masked)), float(jnp.sum(ref)), rtol=1e-4
    )


def test_multihost_train_step_descends(scene):
    mesh = multihost_mesh()
    params = params_from_scene(scene)
    target = jnp.zeros((32, 32), jnp.float32)
    step = make_multihost_train_step(
        mesh, scene.patches, scene.screen_plane, target, resolution=32,
        learning_rate=1e-4,
    )
    p1, loss1 = step(params, scene.start, scene.direction)
    p2, loss2 = step(p1, scene.start, scene.direction)
    assert np.isfinite(float(loss1)) and np.isfinite(float(loss2))
    assert float(loss2) < float(loss1)
    # params replicated: every shard identical
    assert np.isfinite(np.asarray(p2.control_points)).all()


def test_gradient_allreduce_in_backward(scene):
    """HLO-level verification of the multihost module's collective claim:
    the compiled SPMD train step must contain all-reduce ops spanning all 8
    devices (the gradient psum XLA inserts for replicated params x sharded
    rays).  Overlap with backward compute is a scheduling property this
    virtual-device mesh cannot show, so only insertion + placement is
    checked."""
    from cbtr_tpu.parallel.multihost import process_ray_shard
    from cbtr_tpu.models.lens_model import LensParams, lens_loss

    mesh = multihost_mesh()
    params = params_from_scene(scene)
    target = jnp.zeros((32, 32), jnp.float32)
    rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    patches_r = jax.device_put(scene.patches, rep)
    screen_r = jax.device_put(jnp.asarray(scene.screen_plane), rep)

    def loss_fn(p, s, d, w):
        return lens_loss(p, patches_r, s, d, screen_r, target,
                         resolution=32, ray_weights=w)

    def step(p, s, d, w):
        loss, grads = jax.value_and_grad(loss_fn)(p, s, d, w)
        return grads, loss

    s, d, w = process_ray_shard(
        np.asarray(scene.start), np.asarray(scene.direction), mesh
    )
    params = jax.device_put(params, rep)
    compiled = jax.jit(step).lower(params, s, d, w).compile()
    hlo = compiled.as_text()
    n_allreduce = hlo.count(" all-reduce(")
    assert n_allreduce >= 1, "no gradient all-reduce in the compiled step"
    # the collective spans all 8 devices: iota replica groups [1,8]<=[8]
    # (one group containing every device)
    assert "replica_groups=[1,8]<=[8]" in hlo or (
        "0,1,2,3,4,5,6,7" in hlo.replace(" ", "")
    ), "all-reduce does not span the full device mesh"
    # and it reduces the control-point gradient inside the backward: the
    # [P,10,3] operand produced by the transposed (jvp -> transpose) render
    import re

    # [P,10,3] if the recompute gathers per-leaf; [P,60] since the packed-
    # table single-gather (bezier/patches.py packed_f32) — whose backward
    # scatter-add produces the packed control-table gradient, all-reduced
    # (fused with the refractive-index scalar grads) in one collective
    P = scene.patches.num_patches
    cp_shapes = (f"f32[{P},10,3]", f"f32[{P},60]")
    ar_lines = [l for l in hlo.splitlines() if " all-reduce(" in l]
    assert any(
        any(cs in l for cs in cp_shapes) and "transpose(jvp" in l
        for l in ar_lines
    ), f"no {cp_shapes} gradient all-reduce in the backward:\n" + "\n".join(
        l[:160] for l in ar_lines
    )


@pytest.mark.slow
def test_two_process_distributed_train_step(tmp_path):
    """make_multihost_train_step across 2 real jax.distributed processes —
    the gradient psum crosses the process boundary (the DCN hop on a real
    pod).  Both processes must hold identical post-step params, and those
    must match the single-process step on this test's own 8-device mesh."""
    out = str(tmp_path / "mpt")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks/multiprocess_render.py"),
         "--procs", "2", "--out", out, "--res", "16", "--train"],
        capture_output=True, text=True, timeout=560, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    files = sorted(glob.glob(out + ".proc*.npz"))
    assert len(files) == 2
    runs = []
    for f in files:
        with np.load(f) as data:
            assert int(data["n_processes"]) == 2
            runs.append(
                (data["cp"], data["n_refr"], float(data["loss1"]),
                 float(data["loss2"]))
            )
    # cross-process: bit-identical replicated params and losses
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    assert runs[0][2] == runs[1][2] and runs[0][3] == runs[1][3]
    assert runs[0][3] < runs[0][2], "loss must descend"

    # single-process reference (8-device mesh here vs 2x2 there: psum order
    # differs, so allclose not array_equal)
    scene = sphere_lens_scene(res=16, sectors=9, belts=4)
    params = params_from_scene(scene)
    step = make_multihost_train_step(
        multihost_mesh(), scene.patches, scene.screen_plane,
        jnp.zeros((32, 32), jnp.float32), resolution=32, learning_rate=1e-4,
    )
    p1, loss1 = step(params, scene.start, scene.direction)
    p2, loss2 = step(p1, scene.start, scene.direction)
    assert float(loss1) == pytest.approx(runs[0][2], rel=1e-5)
    assert float(loss2) == pytest.approx(runs[0][3], rel=1e-5)
    np.testing.assert_allclose(
        np.asarray(p2.control_points), runs[0][0], rtol=1e-5, atol=1e-7
    )


@pytest.mark.slow
def test_two_process_distributed_render(tmp_path):
    """Two real jax.distributed processes (4 global devices) agree with the
    single-process render bit-for-float."""
    out = str(tmp_path / "mp")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)  # workers set their own device count
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks/multiprocess_render.py"),
         "--procs", "2", "--out", out, "--res", "16"],
        capture_output=True, text=True, timeout=560, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    files = sorted(glob.glob(out + ".proc*.npz"))
    assert len(files) == 2
    imgs = []
    for f in files:
        with np.load(f) as data:
            assert int(data["n_processes"]) == 2
            assert int(data["n_devices"]) == 4
            imgs.append(data["img"])
    # both processes hold the same replicated image
    np.testing.assert_array_equal(imgs[0], imgs[1])
    # and it matches the single-process render
    scene = sphere_lens_scene(res=16, sectors=9, belts=4)
    ref = render_lens_image(
        scene.patches, scene.refractive_index, jnp.asarray(scene.start),
        jnp.asarray(scene.direction), scene.screen_plane, resolution=32,
    )
    np.testing.assert_allclose(imgs[0], np.asarray(ref), atol=1e-4)


def test_train_step_ortho_matches_uploaded_rays(scene):
    """make_multihost_train_step_ortho (rays synthesized per shard on
    device) must take the same SGD step as make_multihost_train_step fed
    the host-built grid of the same spec."""
    from cbtr_tpu.models.scenes import SPHERE_BEAM_WIDTH, scene_ortho_grid
    from cbtr_tpu.parallel.multihost import make_multihost_train_step_ortho

    mesh = multihost_mesh()
    params = params_from_scene(scene)
    target = jnp.zeros((32, 32), jnp.float32)
    grid = scene_ortho_grid(16, beam_width=SPHERE_BEAM_WIDTH)

    step_o = make_multihost_train_step_ortho(
        mesh, scene.patches, scene.screen_plane, target, grid,
        resolution=32, learning_rate=1e-4,
    )
    p1, loss1, grads1 = step_o(params)
    p2, loss2, _ = step_o(p1)
    assert float(loss2) < float(loss1)
    assert np.isfinite(np.asarray(grads1.control_points)).all()
    assert float(jnp.linalg.norm(grads1.control_points)) > 0

    step_u = make_multihost_train_step(
        mesh, scene.patches, scene.screen_plane, target, resolution=32,
        learning_rate=1e-4,
    )
    q1, uloss1 = step_u(params, scene.start, scene.direction)
    assert float(loss1) == pytest.approx(float(uloss1), rel=1e-5)
    np.testing.assert_allclose(
        np.asarray(p1.control_points), np.asarray(q1.control_points),
        rtol=1e-5, atol=1e-8,
    )


@pytest.mark.slow
def test_two_process_train_step_ortho(tmp_path):
    """The TRAIN4K path across 2 real jax.distributed processes: rays
    synthesized per shard, gradient psum across the process boundary,
    bit-identical post-step params on both processes."""
    out = str(tmp_path / "mpo")
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "benchmarks/multiprocess_render.py"),
         "--procs", "2", "--out", out, "--res", "16", "--train-ortho"],
        capture_output=True, text=True, timeout=560, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    files = sorted(glob.glob(out + ".proc*.npz"))
    assert len(files) == 2
    runs = []
    for f in files:
        with np.load(f) as data:
            assert int(data["n_processes"]) == 2
            runs.append((data["cp"], data["n_refr"], float(data["loss1"]),
                         float(data["loss2"])))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])
    assert runs[0][2] == runs[1][2] and runs[0][3] == runs[1][3]
    assert runs[0][3] < runs[0][2], "loss must descend"


def test_render_multihost_ortho_matches_uploaded_rays():
    """render_multihost_ortho synthesizes each ray shard on device from the
    OrthoGrid closed form; it must match render_multihost fed the host-built
    ortho_ray_grid of the same spec (same grid layout, no upload)."""
    from cbtr_tpu.models import sphere_lens_scene
    from cbtr_tpu.models.scenes import SPHERE_BEAM_WIDTH, scene_ortho_grid
    from cbtr_tpu.parallel.multihost import render_multihost_ortho

    sc = sphere_lens_scene(res=16, sectors=9, belts=4)
    mesh = multihost_mesh()
    grid = scene_ortho_grid(16, beam_width=SPHERE_BEAM_WIDTH)
    img = render_multihost_ortho(
        mesh, sc.patches, sc.refractive_index, grid, sc.screen_plane,
        resolution=32,
    )
    ref = render_multihost(
        mesh, sc.patches, sc.refractive_index, sc.start, sc.direction,
        sc.screen_plane, resolution=32,
    )
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref), atol=2e-3)
    np.testing.assert_allclose(
        float(jnp.sum(img)), float(jnp.sum(ref)), rtol=1e-4
    )
