"""Patch-sharded intersection: the tensor-parallel axis of the raytracer.

To cut per-chip compute (the brute-force scan is O(rays x patches)), the
*patch* axis is sharded across a mesh axis: every device sweeps the ray
batch against its own patch shard (the expensive stage), then the per-pair candidate codes+distances (8 bytes/pair) are
all-gathered along the patch axis so every device can run the cheap integer
select stage — including follow-side retries that cross shard boundaries
(reference/bezierMesh.cpp:213-217, the neighbour patch may live on another
device) — and finally each device re-evaluates only its rays' winning
patches from the replicated patch table.  Gradients flow through that O(R)
recompute alone, so backward needs no extra communication beyond the
automatic psum of replicated-parameter grads.

The SoA is tiny (~250 B/patch) so replicating the table for the recompute
costs nothing until meshes reach millions of patches.

Composes with ray sharding into a 2D ('rays', 'patches') mesh: rays split
along one axis, patches along the other.
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from ..bezier.patches import BezierPatches
from ..ops.intersect import (
    RayHit,
    recompute_winner,
    select_candidates,
    sweep_codes_xla,
)


def pad_patches(patches: BezierPatches, multiple: int) -> BezierPatches:
    """Pad the patch axis with degenerate never-hit rows (zero control points
    give a zero plane normal -> |cos| < epsilon -> invalid)."""
    Pn = patches.num_patches
    pad = (-Pn) % multiple
    if pad == 0:
        return patches

    def pad_leaf(x):
        widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, widths)

    return BezierPatches(*(pad_leaf(leaf) for leaf in patches))


@functools.lru_cache(maxsize=64)
def _build_shard_fn(mesh: Mesh, patch_axis: str, ray_axis: Optional[str]):
    """Cached jitted shard_map body, keyed on (mesh, axes).

    Caching matters twice over: an un-jitted shard_map dispatches every
    traced op eagerly across the mesh (~100s/call on an 8-device CPU mesh vs
    ~1s compiled), and a fresh jax.jit wrapper per call would retrace on
    every eager invocation.  Under an outer jit the cached inner jit is
    inlined for free.
    """
    ray_spec = P(ray_axis) if ray_axis else P()
    local_specs = BezierPatches(*(P(patch_axis) for _ in BezierPatches._fields))
    full_specs = BezierPatches(*(P() for _ in BezierPatches._fields))

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(local_specs, full_specs, ray_spec, ray_spec),
        out_specs=RayHit(*(ray_spec for _ in RayHit._fields)),
        check_vma=False,
    )
    def shard_fn(local_patches, full_patches, s, d):
        # stage 1: local sweep (stop-gradient; the heavy stage)
        sg = jax.lax.stop_gradient
        code, dist = sweep_codes_xla(sg(local_patches), sg(s), sg(d))

        # stage 2: all-gather per-pair scalars along the patch axis so the
        # select stage sees the whole table (cross-shard retries included)
        code = jax.lax.all_gather(code, patch_axis, axis=1, tiled=True)
        dist = jax.lax.all_gather(dist, patch_axis, axis=1, tiled=True)
        any_hit, win, _ = select_candidates(
            code, dist, sg(full_patches).neighbours
        )

        # stage 3: differentiable winner recompute from the replicated table
        return recompute_winner(full_patches, s, d, any_hit, win)

    return jax.jit(shard_fn)


def intersect_rays_patch_sharded(patches: BezierPatches, start, direction,
                                 mesh: Mesh, patch_axis: str = "patches",
                                 ray_axis: Optional[str] = None) -> RayHit:
    """Mesh-sharded intersection: patches split along `patch_axis`, rays
    optionally split along `ray_axis` (2D mesh).  The local sweep is the
    staged XLA form: its per-pair codes are what the all-gather moves."""
    n_shards = mesh.shape[patch_axis]
    patches = pad_patches(patches, n_shards)

    shard_fn = _build_shard_fn(mesh, patch_axis, ray_axis)
    return shard_fn(
        patches, patches,
        start.astype(jnp.float32), direction.astype(jnp.float32),
    )
