"""Multi-host distributed execution.

The reference's scale-out story is single-GPU prose (the planned Thrust ray
batching, reference/README.md:159-198).  This module generalises it to
`jax.distributed` process groups + a global device mesh with

* **rays sharded over every device of every host** (the data-parallel axis
  of a raytracer — rays are independent, so forward needs no communication
  until the partial images are summed);
* **the BezierPatches SoA replicated** (tens of KB/mesh);
* **one gradient all-reduce**: each device renders its own rays under
  `shard_map` (the sweep kernel is a custom call XLA cannot partition, and
  the ray-chunk memory bound must see one device's rays), the partial
  images are psummed, and the transpose of the replicated parameters'
  broadcast psums the control-point / refractive-index grads (NCCL on
  GPUs).

Single-process (1 host, N devices) and multi-process (N hosts) run the same
code: the mesh is built from `jax.devices()` (global across processes) and
per-process ray shards are assembled with
`jax.make_array_from_process_local_data`.
"""
from __future__ import annotations

import functools
import os
from typing import Optional, Tuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.lens_model import LensParams
from ..render.render import render_lens_image


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> bool:
    """Join (or skip) the jax.distributed process group.

    Explicit args, or the standard JAX env vars
    (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID).  Returns True
    when a multi-process group was initialized, False for the single-process
    fallback (everything still works on one host's devices).
    """
    coordinator_address = coordinator_address or os.environ.get(
        "JAX_COORDINATOR_ADDRESS"
    )
    if num_processes is None:
        env = os.environ.get("JAX_NUM_PROCESSES")
        num_processes = int(env) if env else None
    if process_id is None:
        env = os.environ.get("JAX_PROCESS_ID")
        process_id = int(env) if env else None

    if coordinator_address is None and num_processes is None:
        return False  # single process; nothing to initialize
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def multihost_mesh(axis: str = "rays",
                   num_devices: Optional[int] = None) -> Mesh:
    """1D mesh over every device of every host (the ray/data axis).

    A flat axis is the right shape for this workload: rays need no
    communication, so there is nothing for a second mesh dimension to
    exploit — hosts x devices collapse into one data axis and the only
    collectives are the image and gradient psums.
    """
    devices = jax.devices()
    n = num_devices or len(devices)
    return Mesh(np.asarray(devices[:n]), (axis,))


def process_ray_shard(start: np.ndarray, direction: np.ndarray,
                      mesh: Mesh, axis: str = "rays"
                      ) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Assemble globally-sharded ray arrays from per-process slices.

    start/direction are the *global* [R,3] ray set (procedurally generated,
    so every process can build it — only its own slice is materialized on
    device).  Returns (start, direction, weight) as global jax.Arrays
    sharded over `axis`; weight is 1.0 for real rays, 0.0 for the rays added
    to pad R up to a multiple of the device count.  Callers MUST thread
    `weight` into the splat/loss (render_lens_image / lens_loss take it
    directly) — the pad direction (-x, away from every scene) is only a
    second line of defence, not the guarantee.
    """
    n = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    R = start.shape[0]
    pad = (-R) % n
    weight = np.ones((R + pad,), np.float32)
    if pad:
        # padded rays head -x from the origin, away from every fixture
        # (scenes sit at +x); their weight is 0 regardless, so even a ray
        # that *did* hit something could not touch the image or the loss.
        weight[R:] = 0.0
        start = np.concatenate(
            [start, np.zeros((pad, 3), start.dtype)], axis=0
        )
        dpad = np.zeros((pad, 3), direction.dtype)
        dpad[:, 0] = -1.0
        direction = np.concatenate([direction, dpad], axis=0)

    sharding = NamedSharding(mesh, P(axis))
    if jax.process_count() == 1:
        return (
            jax.device_put(start, sharding),
            jax.device_put(direction, sharding),
            jax.device_put(weight, sharding),
        )
    # multi-process: each process materializes only its addressable shard
    def to_global(arr):
        per = arr.shape[0] // jax.process_count()
        pid = jax.process_index()
        local = arr[pid * per:(pid + 1) * per]
        return jax.make_array_from_process_local_data(sharding, local)

    return to_global(start), to_global(direction), to_global(weight)


def _sharded_image(mesh: Mesh, axis: str, make_rays, n_ray_args: int,
                   resolution: int, extent: float, chunk_size: int):
    """shard_map'd (patches, refractive_index, screen, *ray_args) -> image.

    ray_args are sharded along `axis`; each device turns its shards into
    (start, direction[, weights]) with make_rays, renders them, and the
    partial images are psummed over `axis`."""

    def body(patches, refractive_index, screen, *ray_args):
        s, d, *w = make_rays(*ray_args)
        w = w[0] if w else None
        img = render_lens_image(
            patches, refractive_index, s, d, screen, extent=extent,
            resolution=resolution, chunk_size=chunk_size, weights=w,
        )
        return jax.lax.psum(img, axis)

    # check_vma=False: the sweep kernel's pallas_call carries no
    # varying-axes types; the psum above makes the output replicated
    return jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P()) + (P(axis),) * n_ray_args, out_specs=P(),
        check_vma=False,
    )


def _replicated(mesh: Mesh, *trees):
    rep = NamedSharding(mesh, P())
    return tuple(jax.device_put(t, rep) for t in trees)


def _device_count(mesh: Mesh, n_rays: int, what: str) -> int:
    n = int(np.prod([mesh.shape[a] for a in mesh.axis_names]))
    if n_rays % n:
        raise ValueError(f"{what} rays {n_rays} not divisible by {n} devices")
    return n


def _given_rays(s, d, w):
    return s, d, w


def _sgd(params: LensParams, grads: LensParams, learning_rate: float):
    return LensParams(
        control_points=params.control_points
        - learning_rate * grads.control_points,
        refractive_index=params.refractive_index
        - learning_rate * grads.refractive_index,
    )


def render_multihost(mesh: Mesh, patches, refractive_index, start, direction,
                     screen_plane, resolution: int = 128, extent: float = 4.0,
                     chunk_size: int = 0, axis: str = "rays"):
    """Globally-sharded forward render.

    start/direction: *global* numpy ray arrays (see process_ray_shard).
    Returns the [res, res] image, replicated on every process (the bilinear
    splat commutes across ray shards, so the per-device partial images are
    summed with one psum).
    """
    patches_r, screen_r = _replicated(mesh, patches, jnp.asarray(screen_plane))
    s, d, w = process_ray_shard(
        np.asarray(start), np.asarray(direction), mesh, axis
    )
    return _uploaded_render_jit(
        patches_r, jnp.float32(refractive_index), screen_r, s, d, w, mesh,
        axis, resolution, extent, chunk_size,
    )


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "axis", "resolution", "extent", "chunk_size"),
)
def _uploaded_render_jit(patches, refractive_index, screen, s, d, w, mesh,
                         axis, resolution, extent, chunk_size):
    image = _sharded_image(mesh, axis, _given_rays, 3, resolution, extent,
                           chunk_size)
    return image(patches, refractive_index, screen, s, d, w)


@functools.partial(
    jax.jit,
    static_argnames=("make_rays", "n_rays", "mesh", "axis", "resolution",
                     "extent", "chunk_size"),
)
def _index_render_jit(patches, refractive_index, screen, make_rays, n_rays,
                      mesh, axis, resolution, extent, chunk_size):
    """Module-level jit so repeated renders hit the jit cache instead of
    retracing a fresh closure per call (make_rays is a bound method of a
    hashable grid or emitter).  Rays are synthesized per device from its
    slice of the flat ray indices."""
    image = _sharded_image(mesh, axis, make_rays, 1, resolution, extent,
                           chunk_size)
    idx = jnp.arange(n_rays, dtype=jnp.int32)
    return image(patches, refractive_index, screen, idx)


def render_multihost_ortho(mesh: Mesh, patches, refractive_index,
                           grid, screen_plane, resolution: int = 128,
                           extent: float = 4.0, chunk_size: int = 0,
                           axis: str = "rays"):
    """Sharded render with rays SYNTHESIZED ON DEVICE from an OrthoGrid.

    render_multihost uploads the global [R,3] ray arrays (402 MB at a
    4096x4096 grid).  Here each device computes its own rays from the
    closed-form grid (render/camera.py OrthoGrid.rays_at) for its slice of
    the flat grid indices, so no process ever materializes — let alone
    transfers — the global ray set.  Requires grid.n_rays % device_count
    == 0 (an image grid over a power-of-two device count in practice).
    """
    _device_count(mesh, grid.n_rays, "grid")
    patches_r, screen_r = _replicated(mesh, patches, jnp.asarray(screen_plane))
    return _index_render_jit(
        patches_r, jnp.float32(refractive_index), screen_r, grid.rays_at,
        grid.n_rays, mesh, axis, resolution, extent, chunk_size,
    )


def render_multihost_emitter(mesh: Mesh, patches, refractive_index,
                             emitter, screen_plane, resolution: int = 128,
                             extent: float = 4.0, chunk_size: int = 0,
                             axis: str = "rays"):
    """Sharded point-source render with rays synthesized ON DEVICE from a
    DeviceEmitter — the emitter analogue of render_multihost_ortho.  Ray
    index space is bin-ordered, so each device's contiguous index slice is a
    contiguous run of hemisphere bins: per-shard tile coherence equals the
    sorted single-device case, with zero host sampling/sorting/upload.
    rays_at(idx) is deterministic in the GLOBAL index, so any device count
    produces identical rays (and, psum aside, identical images).
    Requires emitter.n_rays % device_count == 0."""
    _device_count(mesh, emitter.n_rays, "emitter")
    patches_r, screen_r = _replicated(mesh, patches, jnp.asarray(screen_plane))
    return _index_render_jit(
        patches_r, jnp.float32(refractive_index), screen_r,
        emitter.rays_at, emitter.n_rays, mesh, axis, resolution,
        extent, chunk_size,
    )


def _index_train_step(mesh, patches, screen_plane, target, make_rays,
                      n_rays, resolution, extent, learning_rate, chunk_size,
                      axis):
    patches_r, screen_r, target_r = _replicated(
        mesh, patches, jnp.asarray(screen_plane), jnp.asarray(target)
    )
    image = _sharded_image(mesh, axis, make_rays, 1, resolution, extent,
                           chunk_size)

    def loss_fn(params):
        p = patches_r._replace(control_points=params.control_points)
        idx = jnp.arange(n_rays, dtype=jnp.int32)
        img = image(p, params.refractive_index, screen_r, idx)
        return jnp.mean((img - target_r) ** 2)

    @jax.jit
    def step(params: LensParams):
        loss, grads = jax.value_and_grad(loss_fn)(params)
        return _sgd(params, grads, learning_rate), loss, grads

    rep = NamedSharding(mesh, P())

    def run(params: LensParams):
        return step(jax.device_put(params, rep))

    return run


def make_multihost_train_step_emitter(mesh: Mesh, patches, screen_plane,
                                      target, emitter,
                                      resolution: int = 128,
                                      extent: float = 4.0,
                                      learning_rate: float = 1e-3,
                                      chunk_size: int = 0,
                                      axis: str = "rays"):
    """SPMD emitter-illumination train step: point-source rays synthesized
    per shard on device (DeviceEmitter), full fwd+bwd against an image
    target, grads psum-reduced — the reference's motivating car-lamp use
    case (reference/README.md:159-165, hostUtil.cpp:9-29) at scale.

    Returns run(params) -> (new_params, loss, grads)."""
    _device_count(mesh, emitter.n_rays, "emitter")
    return _index_train_step(
        mesh, patches, screen_plane, target, emitter.rays_at,
        emitter.n_rays, resolution, extent, learning_rate, chunk_size, axis,
    )


def make_multihost_train_step_ortho(mesh: Mesh, patches, screen_plane,
                                    target, grid, resolution: int = 128,
                                    extent: float = 4.0,
                                    learning_rate: float = 1e-3,
                                    chunk_size: int = 0, axis: str = "rays"):
    """SPMD train step with rays SYNTHESIZED ON DEVICE from an OrthoGrid —
    the training analogue of render_multihost_ortho: params replicated,
    each device builds its own ray shard from the closed-form grid (no
    402 MB host upload at 4096^2), backward psums the control-point /
    refractive-index grads.

    Returns run(params) -> (new_params, loss, grads); grads are returned so
    large-scale runs can compare them.  Requires grid.n_rays % device_count
    == 0."""
    _device_count(mesh, grid.n_rays, "grid")
    return _index_train_step(
        mesh, patches, screen_plane, target, grid.rays_at, grid.n_rays,
        resolution, extent, learning_rate, chunk_size, axis,
    )


def make_multihost_train_step(mesh: Mesh, patches, screen_plane, target,
                              resolution: int = 128, extent: float = 4.0,
                              learning_rate: float = 1e-3,
                              chunk_size: int = 0, axis: str = "rays"):
    """SPMD train step over the global mesh: params replicated, rays sharded,
    gradient psum over the ray axis.

    Returns run(params, start_np, direction_np) -> (params, loss); start /
    direction are global numpy arrays, sliced per process internally.
    """
    patches_r, screen_r, target_r = _replicated(
        mesh, patches, jnp.asarray(screen_plane), jnp.asarray(target)
    )
    image = _sharded_image(mesh, axis, _given_rays, 3, resolution, extent,
                           chunk_size)

    def loss_fn(params, start, direction, weight):
        p = patches_r._replace(control_points=params.control_points)
        img = image(p, params.refractive_index, screen_r, start, direction,
                    weight)
        return jnp.mean((img - target_r) ** 2)

    @jax.jit
    def step(params: LensParams, start, direction, weight):
        loss, grads = jax.value_and_grad(loss_fn)(
            params, start, direction, weight
        )
        return _sgd(params, grads, learning_rate), loss

    rep = NamedSharding(mesh, P())

    def run(params: LensParams, start, direction):
        params = jax.device_put(params, rep)
        s, d, w = process_ray_shard(
            np.asarray(start), np.asarray(direction), mesh, axis
        )
        return step(params, s, d, w)

    return run
