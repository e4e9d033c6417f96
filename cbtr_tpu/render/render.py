"""Differentiable image formation.

The reference stops at STL dumps inspected in Blender; this build's
first-class product is an *image*: rays refract through the lens
(reference/test.cpp:330-427 state machine), land on a screen plane, and are
splatted bilinearly into an irradiance image.  The splat keeps the whole
pipeline differentiable: d(image)/d(control points, refractive index, ray
origins) flows through hit positions.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .. import geom
from ..optics.lens import trace_through_lens
from ..ops.intersect import WHAT_INTERSECT, intersect_rays


def screen_hits(start, direction, screen_plane):
    """Intersect rays with the screen plane; returns (hit2d [N,2], valid).

    The screen's 2D frame is (u, v) = the two in-plane axes returned by
    `geom.a_perpendicular` construction."""
    n = geom.plane_normal(screen_plane)
    u = geom.a_perpendicular(n)
    v = jnp.cross(n, u)
    valid, point, _, _ = geom.plane_ray_intersect(screen_plane, start, direction)
    hit2d = jnp.stack([geom.dot(point, u), geom.dot(point, v)], axis=-1)
    return hit2d, valid


# Use the matmul (outer-product) splat while the two [N, res] axis-weight
# matrices fit comfortably in device memory; above that (e.g. the 4K render's
# 16.8M rays x 1024px image) fall back to scatter-adds.
_SPLAT_MATMUL_MAX_BYTES = 1_200_000_000


def _splat_axis_weights(coord, res: int):
    """Bilinear weights of one axis as a dense [N, res] matrix: row r has
    (1-frac) at floor(coord_r) and frac at floor+1 (out-of-range columns
    simply never match — the same drop semantics as the scatter path)."""
    x0 = jnp.floor(coord)
    frac = coord - x0
    x0i = x0.astype(jnp.int32)[:, None]
    iota = jnp.arange(res, dtype=jnp.int32)[None, :]
    return jnp.where(iota == x0i, 1.0 - frac[:, None], 0.0) + jnp.where(
        iota == x0i + 1, frac[:, None], 0.0
    )


def splat_bilinear(points2d, weights, extent, resolution: int):
    """Accumulate points into a [res, res] image with bilinear footprints.

    points2d [N,2] in [-extent, extent]^2; weights [N] (0 kills a point).
    Differentiable w.r.t. points2d and weights.

    Two formulations with identical math (f32-rounding-level agreement):

    * **matmul outer-product** (default): the bilinear footprint is
      separable, img[i,j] = sum_r w_r * wx_r[i] * wy_r[j], i.e. one
      [res,N]@[N,res] matmul of per-axis weight matrices, whose transpose
      is again a matmul (the scatter form costs 4 scatter-adds forward and
      4 gathers backward).  It runs at HIGHEST precision: the weights are
      fractional, and the GPU would otherwise round them to TF32.
    * **scatter-add** fallback when the [N, res] weight matrices would
      exceed ~1.2 GB (huge renders, e.g. 16.8M rays -> 1024^2).
    """
    res = resolution
    xy = (points2d / (2.0 * extent) + 0.5) * res - 0.5
    n = points2d.shape[0]

    if 2 * 4 * n * res <= _SPLAT_MATMUL_MAX_BYTES:
        ax = _splat_axis_weights(xy[:, 0], res) * weights[:, None]
        ay = _splat_axis_weights(xy[:, 1], res)
        return jnp.einsum(
            "ri,rj->ij", ax, ay, preferred_element_type=jnp.float32,
            precision=jax.lax.Precision.HIGHEST,
        )

    x0 = jnp.floor(xy)
    frac = xy - x0
    x0i = x0.astype(jnp.int32)
    img = jnp.zeros((res, res), jnp.float32)
    for dx in (0, 1):
        for dy in (0, 1):
            wx = frac[:, 0] if dx else 1.0 - frac[:, 0]
            wy = frac[:, 1] if dy else 1.0 - frac[:, 1]
            ix = x0i[:, 0] + dx
            iy = x0i[:, 1] + dy
            inside = (ix >= 0) & (ix < res) & (iy >= 0) & (iy < res)
            w = jnp.where(inside, weights * wx * wy, 0.0)
            img = img.at[jnp.clip(ix, 0, res - 1), jnp.clip(iy, 0, res - 1)].add(
                w, mode="drop"
            )
    return img


@functools.partial(
    jax.jit, static_argnames=("resolution", "chunk_size", "intersect_fn")
)
def render_lens_image(patches, refractive_index, start, direction, screen_plane,
                      extent: float = 4.0, resolution: int = 128,
                      chunk_size: int = 0, weights=None, intersect_fn=None):
    """Flagship forward model: collimated/emitted rays -> lens entry/exit
    refraction -> screen splat -> [res, res] irradiance image.

    weights: optional per-ray multiplier [...]; 0 removes a ray from the
    image entirely (used to mask shard-padding rays and to carry emitter
    importance weights).  intersect_fn: optional (patches, start, direction)
    -> RayHit in place of intersect_rays (see trace_through_lens)."""
    out_s, out_d, alive, _, _ = trace_through_lens(
        patches, refractive_index, start, direction, chunk_size=chunk_size,
        intersect_fn=intersect_fn,
    )
    hit2d, on_screen = screen_hits(out_s, out_d, screen_plane)
    w = (alive & on_screen).astype(jnp.float32)
    if weights is not None:
        w = w * weights.astype(jnp.float32)
    # dead rays keep finite positions; weight 0 removes them from the image
    hit2d = jnp.where((alive & on_screen)[..., None], hit2d, 0.0)
    return splat_bilinear(hit2d.reshape(-1, 2), w.reshape(-1), extent, resolution)


def render_emitter_image(patches, refractive_index, emitter, n_rays: int,
                         origin, screen_plane, extent: float = 4.0,
                         resolution: int = 128, chunk_size: int = 0):
    """Point-source render: hemisphere-emitter rays -> lens -> screen image.

    The emitter's belt/patch bin (reference/hostUtil.cpp:9-13 — designed
    there for GPU warp coherence) is re-purposed as the ray SORT key: rays
    are ordered by bin before tracing so each 128-ray sweep tile sees
    spatially coherent directions and the kernel's cull lists stay short.
    The bilinear splat is order-invariant, so no unsort pass is needed.

    emitter: UniformHemisphere (host-side sampling + binning).
    origin: [3] emitter position; rays head into the +x hemisphere.
    """
    import numpy as np

    d, patch = emitter.sample(n_rays)
    order = np.argsort(patch, kind="stable")
    d = jnp.asarray(d[order])
    s = jnp.broadcast_to(
        jnp.asarray(origin, jnp.float32)[None, :], d.shape
    )
    return render_lens_image(
        patches, refractive_index, s, d, screen_plane,
        extent=extent, resolution=resolution, chunk_size=chunk_size,
    )


@functools.partial(
    jax.jit, static_argnames=("emitter", "resolution", "chunk_size")
)
def render_emitter_image_device(patches, refractive_index, emitter,
                                screen_plane, extent: float = 4.0,
                                resolution: int = 128, chunk_size: int = 0):
    """Point-source render with rays synthesized ON DEVICE, pre-sorted by
    the belt/patch bin (emitters.DeviceEmitter) — no host sampling, no host
    argsort, no ray upload.  The per-ray unbiasing weights ride the splat's
    weight input.  emitter is jit-static (a hashable NamedTuple)."""
    idx = jnp.arange(emitter.n_rays, dtype=jnp.int32)
    s, d, w = emitter.rays_at(idx)
    return render_lens_image(
        patches, refractive_index, s, d, screen_plane,
        extent=extent, resolution=resolution, chunk_size=chunk_size,
        weights=w,
    )


@functools.partial(jax.jit, static_argnames=("chunk_size",))
def render_surface_normals(patches, start, direction, light_dir,
                           chunk_size: int = 0):
    """Surface-inspection render: first-hit Lambertian shading + depth.

    Returns (shade [N], depth [N], hit_mask [N]) for a ray batch; the
    replacement for the reference's Blender STL inspection loop.
    """
    hit = intersect_rays(patches, start, direction, chunk_size=chunk_size)
    ok = hit.what == WHAT_INTERSECT
    light = geom.safe_normalize(jnp.asarray(light_dir, jnp.float32))
    shade = jnp.clip(-geom.dot(hit.normal, light), 0.0, 1.0)
    shade = jnp.where(ok, shade, 0.0)
    depth = jnp.where(ok, hit.distance, 0.0)
    return shade, depth, ok
