"""Ray-coherence sorting: the analogue of the reference's warp-coherence
emitter binning (reference/README.md:169-192, hostUtil.cpp:9-28).

The reference's GPU plan groups rays so one kernel launch processes rays
that hit similar geometry.  The sweep kernel's cull (ops/pallas_sweep.py)
drops a patch block from a 128-ray tile only when *all 128 rays* miss its
bounds, and evaluates a patch only when some ray of the tile hits its
sphere — so spatially coherent ray *tiles* skip far more work.  This module provides
the sort/unsort pass that manufactures that coherence for arbitrarily
ordered rays (emitter-sampled bundles, shuffled batches):

* `coherence_keys` — per-ray sort key. For emitter rays use the emitter's
  belt/patch index directly (`UniformHemisphere.sample` already returns
  it); for general rays the key is the direction octant + a coarse Morton
  code of the origin, which groups rays by (position, heading) locality.
* `sort_rays` / `unsort` — stable argsort by key and its inverse
  permutation, so callers get results in their original ray order.

Ortho camera grids are already block-coherent; sorting is a no-op win
there.  The win case is hemisphere emitters and ray batches shuffled by a
data loader.
"""
from __future__ import annotations

import jax.numpy as jnp

from ..ops.intersect import RayHit, intersect_rays


def _morton3(q: jnp.ndarray, bits: int = 5) -> jnp.ndarray:
    """Interleave `bits` bits of 3 quantized coordinates, [N,3]i32 -> [N]i32."""
    out = jnp.zeros(q.shape[0], jnp.int32)
    for b in range(bits):
        for axis in range(3):
            out = out | (((q[:, axis] >> b) & 1) << (3 * b + axis))
    return out


def coherence_keys(start, direction, origin_bits: int = 5) -> jnp.ndarray:
    """Per-ray spatial-coherence sort key [N] i32.

    Key = (direction octant << 3*bits) | morton(origin within the batch's
    bounding box).  Rays sharing a key run in the same sweep tile(s).
    """
    start = jnp.asarray(start, jnp.float32)
    direction = jnp.asarray(direction, jnp.float32)
    octant = (
        (direction[:, 0] > 0).astype(jnp.int32)
        | ((direction[:, 1] > 0).astype(jnp.int32) << 1)
        | ((direction[:, 2] > 0).astype(jnp.int32) << 2)
    )
    lo = jnp.min(start, axis=0)
    span = jnp.maximum(jnp.max(start, axis=0) - lo, 1e-6)
    scale = (1 << origin_bits) - 1
    q = jnp.clip(
        ((start - lo) / span * scale).astype(jnp.int32), 0, scale
    )
    return (octant << (3 * origin_bits)) | _morton3(q, origin_bits)


def sort_rays(start, direction, keys=None):
    """-> (start_sorted, direction_sorted, inverse_permutation).

    keys: optional precomputed [N] keys (e.g. the emitter patch index from
    UniformHemisphere.sample — the reference's own binning).
    """
    if keys is None:
        keys = coherence_keys(start, direction)
    perm = jnp.argsort(jnp.asarray(keys), stable=True)
    inv = jnp.argsort(perm, stable=True)
    return (
        jnp.asarray(start)[perm],
        jnp.asarray(direction)[perm],
        inv,
    )


def intersect_rays_sorted(patches, start, direction, keys=None,
                          chunk_size: int = 0, backend: str = "auto") -> RayHit:
    """intersect_rays with the coherence sort/unsort pass around it.

    Identical results to intersect_rays, in the caller's ray order."""
    s, d, inv = sort_rays(start, direction, keys)
    hit = intersect_rays(patches, s, d, chunk_size=chunk_size, backend=backend)
    return RayHit(*(leaf[inv] for leaf in hit))
