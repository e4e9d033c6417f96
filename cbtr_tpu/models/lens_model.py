"""The differentiable lens model: optimize a Bezier lens by gradient descent.

This is the capability the reference only gestures at (a differentiable
CUDA tracer was the unstated endgame of its GPU plan): pixels of the rendered
irradiance image are differentiable w.r.t. the lens control points and the
refractive index, so a target illumination pattern can be *fit*.

Parameters are (control_points, refractive_index); everything else in the
BezierPatches SoA (planes, heights, inverse matrices, dividers) is a function
of the control net the reference computes once — here they stay as the
built values (consistent for small parameter deltas; rebuild via
`bezier.build_patches` when taking large steps).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..render.render import render_lens_image


class LensParams(NamedTuple):
    control_points: jnp.ndarray   # [P,10,3]
    refractive_index: jnp.ndarray # scalar f32


def params_from_scene(scene) -> LensParams:
    return LensParams(
        control_points=scene.patches.control_points,
        refractive_index=jnp.float32(scene.refractive_index),
    )


def lens_forward(params: LensParams, patches, start, direction, screen_plane,
                 resolution: int = 128, extent: float = 4.0,
                 chunk_size: int = 0, ray_weights=None, intersect_fn=None):
    """Irradiance image for the current lens parameters.

    ray_weights: optional per-ray multiplier; 0 removes a ray (shard-padding
    masks, emitter importance).  intersect_fn: optional intersection in
    place of intersect_rays (render_lens_image)."""
    p = patches._replace(control_points=params.control_points)
    return render_lens_image(
        p,
        params.refractive_index,
        start,
        direction,
        screen_plane,
        extent=extent,
        resolution=resolution,
        chunk_size=chunk_size,
        weights=ray_weights,
        intersect_fn=intersect_fn,
    )


def lens_loss(params: LensParams, patches, start, direction, screen_plane,
              target, resolution: int = 128, extent: float = 4.0,
              chunk_size: int = 0, ray_weights=None, intersect_fn=None):
    img = lens_forward(
        params, patches, start, direction, screen_plane,
        resolution=resolution, extent=extent, chunk_size=chunk_size,
        ray_weights=ray_weights, intersect_fn=intersect_fn,
    )
    return jnp.mean((img - target) ** 2)


def make_train_step(patches, screen_plane, target, resolution: int = 128,
                    extent: float = 4.0, learning_rate: float = 1e-3,
                    chunk_size: int = 0, intersect_fn=None):
    """Jitted SGD step: (params, start, direction) -> (params, loss).

    Rays are a *data* argument so the step can be pjit-sharded over a device
    mesh (rays = data axis; params replicated; XLA all-reduces the gradient
    contributions over the ray shards automatically).  intersect_fn: see
    render_lens_image (e.g. intersect_rays with backend="xla" as the
    reference step).
    """

    def loss_fn(params, start, direction):
        return lens_loss(
            params, patches, start, direction, screen_plane, target,
            resolution=resolution, extent=extent, chunk_size=chunk_size,
            intersect_fn=intersect_fn,
        )

    @jax.jit
    def step(params: LensParams, start, direction):
        loss, grads = jax.value_and_grad(loss_fn)(params, start, direction)
        new = LensParams(
            control_points=params.control_points
            - learning_rate * grads.control_points,
            refractive_index=params.refractive_index
            - learning_rate * grads.refractive_index,
        )
        return new, loss

    return step


def make_opt_train_step(patches, screen_plane, target, optimizer,
                        resolution: int = 128, extent: float = 4.0,
                        chunk_size: int = 0):
    """Jitted optax train step for lens DESIGN runs.

    The plain-SGD `make_train_step` converges too slowly for the
    reference's motivating design scenario (car-lamp illumination,
    reference/README.md:159-165): the control-point loss surface is stiff
    (per-pixel splat gradients span orders of magnitude across the net),
    so a multi-hundred-step fit wants per-parameter step adaptation.
    `optimizer` is any optax GradientTransformation (the design artifact
    uses adam).  Returns step: (params, opt_state, start, direction) ->
    (params, opt_state, loss); initialise opt_state = optimizer.init(params).
    Rays stay a data argument, so the step pjit-shards exactly like
    make_train_step's."""

    def loss_fn(params, start, direction):
        return lens_loss(
            params, patches, start, direction, screen_plane, target,
            resolution=resolution, extent=extent, chunk_size=chunk_size,
        )

    import optax  # baked into the image; imported lazily to keep cold paths light

    @jax.jit
    def step(params: LensParams, opt_state, start, direction):
        loss, grads = jax.value_and_grad(loss_fn)(params, start, direction)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step
