"""Ray-grid generation.

Three generators:
* `angle_sweep_rays` -- the reference's refraction-test fan
  (reference/test.cpp:352-360): directions (sqrt(1-sinV^2-sinW^2), sinV, sinW).
* `ortho_ray_grid` -- parallel beam, the natural emitter for lens
  illumination simulation (collimated light).
* `pinhole_ray_grid` -- perspective camera for surface inspection renders.

All return (start [N,3], direction [N,3]) float32, row-major over the grid.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np

from ..config import PI


def angle_sweep_rays(degrees_v: float, degrees_w: float, count_v: int, count_w: int):
    """Fan of rays from the origin (reference/test.cpp:352-360)."""
    v = np.arange(count_v, dtype=np.float32)
    w = np.arange(count_w, dtype=np.float32)
    sin_v = np.sin((v * degrees_v + 1.0) * PI / 180.0)
    sin_w = np.sin((w * degrees_w + 1.0) * PI / 180.0)
    sv, sw = np.meshgrid(sin_v, sin_w, indexing="ij")
    x = np.sqrt(np.maximum(1.0 - sv * sv - sw * sw, 0.0))
    d = np.stack([x, sv, sw], axis=-1).reshape(-1, 3).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    start = np.zeros_like(d)
    return start, d


def grid_is_tileable(res_x: int, res_y: int) -> bool:
    """True when the grid admits the 16x8-pixel-block ray layout."""
    return res_x % 16 == 0 and res_y % 8 == 0


def grid_index_map(i, res_x: int, res_y: int, tiled: bool):
    """Flat ray index -> (ix, iy) pixel coordinates.

    tiled=True lays rays out so each 128-ray sweep tile covers a COMPACT
    16x8 pixel block instead of a quarter-row strip: the tile's beam
    cross-section shrinks ~4x, so the kernel's per-tile bounding-sphere
    cull skips far more candidate blocks (host replay on the robot lens:
    executed (tile x 16-patch-block) pairs 0.44 -> 0.23 at 256^2,
    0.32 -> 0.23 at 512^2).  The bilinear splat is order-invariant, so
    scenes can adopt the layout with no unsort anywhere.  Works for np and
    jnp index arrays (pure integer arithmetic, closed-form per index —
    sharded device synthesis stays index-local)."""
    if tiled:
        nby = res_y // 8
        t, w = i // 128, i % 128
        ix = (t // nby) * 16 + (w // 8)
        iy = (t % nby) * 8 + (w % 8)
        return ix, iy
    return i // res_y, i % res_y


def ortho_ray_grid(center, direction, up, width: float, height: float,
                   res_x: int, res_y: int, tiled: bool | None = None):
    """Parallel beam: res_x x res_y rays on a width x height rectangle
    centered at `center`, all travelling along `direction`.

    tiled=None (default) auto-selects the 16x8-block ray layout when the
    resolution admits it (see grid_index_map) — same ray multiset, tile-
    coherent order."""
    if tiled is None:
        tiled = grid_is_tileable(res_x, res_y)
    center = np.asarray(center, np.float32)
    d = np.asarray(direction, np.float32)
    d = d / np.linalg.norm(d)
    up = np.asarray(up, np.float32)
    right = np.cross(d, up)
    right /= np.linalg.norm(right)
    v_up = np.cross(right, d)

    i = np.arange(res_x * res_y)
    ix, iy = grid_index_map(i, res_x, res_y, tiled)
    gx = ((ix.astype(np.float32) + 0.5) / res_x - 0.5) * width
    gy = ((iy.astype(np.float32) + 0.5) / res_y - 0.5) * height
    start = (
        center[None]
        + gx[:, None] * right[None]
        + gy[:, None] * v_up[None]
    )
    dirs = np.broadcast_to(d, start.shape)
    return start.astype(np.float32), np.ascontiguousarray(dirs, np.float32)


class OrthoGrid(NamedTuple):
    """Device-side description of an `ortho_ray_grid` — rays are synthesized
    per-index on the accelerator instead of uploaded.  At a 4096x4096 grid
    the host array is 16.8M x 2 x 3 f32 = 402 MB per render call, an upload
    that can dominate the whole 4K render.  A sharded render can also
    synthesize only its own shard — no process ever holds the global ray
    array."""

    center: tuple      # (3,) floats
    direction: tuple   # (3,) unit beam direction
    up: tuple
    width: float
    height: float
    res_x: int
    res_y: int
    # 16x8-block ray layout.  None (default) resolves via grid_is_tileable —
    # the same auto-selection ortho_ray_grid(tiled=None) applies — so a
    # directly-constructed OrthoGrid and the host grid of the same spec can
    # never desync; pass an explicit bool only to force a layout (it must
    # then match the host grid's).
    tiled: bool | None = None

    @property
    def n_rays(self) -> int:
        return self.res_x * self.res_y

    def _tiled(self) -> bool:
        if self.tiled is None:
            return grid_is_tileable(self.res_x, self.res_y)
        return self.tiled

    def rays_at(self, idx):
        """(start [N,3], direction [N,3]) f32 for flat grid indices idx [N]
        (matching ortho_ray_grid's layout for the same `tiled` setting)."""
        import jax.numpy as jnp

        c = jnp.asarray(self.center, jnp.float32)
        d = jnp.asarray(self.direction, jnp.float32)
        d = d / jnp.linalg.norm(d)
        up = jnp.asarray(self.up, jnp.float32)
        right = jnp.cross(d, up)
        right = right / jnp.linalg.norm(right)
        v_up = jnp.cross(right, d)
        ixi, iyi = grid_index_map(idx, self.res_x, self.res_y, self._tiled())
        ix = ixi.astype(jnp.float32)
        iy = iyi.astype(jnp.float32)
        gx = ((ix + 0.5) / self.res_x - 0.5) * self.width
        gy = ((iy + 0.5) / self.res_y - 0.5) * self.height
        start = c[None, :] + gx[:, None] * right[None, :] + gy[:, None] * v_up[None, :]
        dirs = jnp.broadcast_to(d, start.shape)
        return start, dirs


def pinhole_ray_grid(origin, look_at, up, fov_degrees: float, res_x: int, res_y: int):
    """Perspective camera ray grid."""
    origin = np.asarray(origin, np.float32)
    fwd = np.asarray(look_at, np.float32) - origin
    fwd /= np.linalg.norm(fwd)
    up = np.asarray(up, np.float32)
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    v_up = np.cross(right, fwd)

    half = np.tan(fov_degrees * PI / 360.0)
    xs = ((np.arange(res_x, dtype=np.float32) + 0.5) / res_x * 2.0 - 1.0) * half
    ys = ((np.arange(res_y, dtype=np.float32) + 0.5) / res_y * 2.0 - 1.0) * half
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    d = (
        fwd[None, None]
        + gx[..., None] * right[None, None]
        + gy[..., None] * v_up[None, None]
    ).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    start = np.broadcast_to(origin, d.shape)
    return np.ascontiguousarray(start, np.float32), d.astype(np.float32)
