"""BezierPatches struct-of-arrays + batched evaluation.

The per-patch state mirrors the reference's BezierTriangle members
(reference/bezierTriangle.h:64-80) laid out as flat device arrays so every
operation is a batched array contraction instead of a per-object method:

- ``control_points [P,10,3]`` -- cubic control net, index scheme
  300/030/003/210/120/021/012/102/201/111 (reference/bezierTriangle.h:29-51)
- ``neighbours     [P,3] i32`` -- patch ids after Clough-Tocher split
- ``underlying     [P,4]``     -- plane through control points 0,1,2
- ``dividers       [P,3,4]``   -- neighbour-divider planes, distance >= 0 on
  the patch's own domain (reference/bezierTriangle.h:65-67)
- ``bary_inverse   [P,3,3]``   -- inverse vertex matrix: b = M @ p
- ``heights        [P,2]``     -- sampled (inside<=0, outside>=0) surface
  height over the underlying plane, x safety factor
- ``deriv_b        [P,3]``     -- second directional-derivative direction
  (the first is the constant (1,0,-1)), reference/bezierTriangle.cpp:83-85
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import geom

# control-point index scheme (reference/bezierTriangle.h:42-51)
CP300, CP030, CP003 = 0, 1, 2
CP210, CP120 = 3, 4
CP021, CP012 = 5, 6
CP102, CP201 = 7, 8
CP111 = 9

# first directional-derivative direction: parallel to the side 003->300
# (reference/bezierTriangle.cpp:83)
DERIV_A = (1.0, 0.0, -1.0)


class BezierPatches(NamedTuple):
    control_points: jnp.ndarray  # [P, 10, 3] f32
    neighbours: jnp.ndarray      # [P, 3] i32
    underlying: jnp.ndarray      # [P, 4] f32
    dividers: jnp.ndarray        # [P, 3, 4] f32
    bary_inverse: jnp.ndarray    # [P, 3, 3] f32
    heights: jnp.ndarray         # [P, 2] f32 (inside, outside)
    deriv_b: jnp.ndarray         # [P, 3] f32

    @property
    def num_patches(self) -> int:
        return self.control_points.shape[0]

    def row(self, idx):
        """Gather per-patch rows (idx may be any integer array)."""
        return BezierPatches(*(leaf[idx] for leaf in self))

    def packed_f32(self) -> jnp.ndarray:
        """All float leaves flattened into one row-major [P, 60] table.

        One `jnp.take` on this table replaces six separate per-leaf gathers
        (and, under `jax.grad`, six backward scatter-adds with ONE): at
        recompute sizes the per-gather overhead dominates.  Column layout is
        consumed by `from_packed_f32`.
        """
        P = self.num_patches
        return jnp.concatenate(
            [
                self.control_points.reshape(P, 30),
                self.underlying,
                self.bary_inverse.reshape(P, 9),
                self.heights,
                self.deriv_b,
                self.dividers.reshape(P, 12),
            ],
            axis=-1,
        )

    @staticmethod
    def from_packed_f32(table: jnp.ndarray, neighbours: jnp.ndarray
                        ) -> "BezierPatches":
        """Inverse of `packed_f32` (plus the integer neighbours leaf).

        table [..., 60]; neighbours [..., 3] i32 (pass zeros when the
        consumer does not read them, e.g. the winner recompute)."""
        lead = table.shape[:-1]
        return BezierPatches(
            control_points=table[..., 0:30].reshape(lead + (10, 3)),
            neighbours=neighbours,
            underlying=table[..., 30:34],
            dividers=table[..., 48:60].reshape(lead + (3, 4)),
            bary_inverse=table[..., 34:43].reshape(lead + (3, 3)),
            heights=table[..., 43:45],
            deriv_b=table[..., 45:48],
        )


def bernstein_weights(bary):
    """Cubic Bernstein weights in control-point index order.

    bary [..., 3] -> [..., 10]; the contraction ``w @ control_points``
    reproduces BezierTriangle::interpolate (reference/bezierTriangle.cpp:105-121).
    `interpolate` deliberately contracts with an unrolled elementwise sum
    rather than a matmul — see its docstring for the rationale.
    """
    b0, b1, b2 = bary[..., 0], bary[..., 1], bary[..., 2]
    b0_2, b1_2, b2_2 = b0 * b0, b1 * b1, b2 * b2
    return jnp.stack(
        [
            b0 * b0_2,
            b1 * b1_2,
            b2 * b2_2,
            3.0 * b1 * b0_2,
            3.0 * b0 * b1_2,
            3.0 * b2 * b1_2,
            3.0 * b1 * b2_2,
            3.0 * b0 * b2_2,
            3.0 * b2 * b0_2,
            6.0 * b0 * b1 * b2,
        ],
        axis=-1,
    )


def interpolate(control_points, bary):
    """Evaluate the cubic surface point. cp [...,10,3], bary [...,3] -> [...,3].

    Unrolled multiply-add rather than einsum: the contraction dim is 10, so
    a matmul form pads it onto the matrix units and (at the HIGHEST
    precision full f32 requires) runs multi-pass, while the unrolled form is
    full f32 under any matmul precision *and* fuses into the surrounding
    elementwise DAG.
    """
    w = bernstein_weights(bary)
    return jnp.sum(w[..., None] * control_points, axis=-2)


def interpolate_linear(control_points, bary):
    """Barycentric mix of the 3 corner control points
    (reference/bezierTriangle.cpp:99-103)."""
    corners = control_points[..., :3, :]  # 300, 030, 003
    return jnp.sum(bary[..., None] * corners, axis=-2)


def _quadratic_component_weights(bary):
    """The three quadratic 'component' weight vectors of getNormal
    (reference/bezierTriangle.cpp:198-224), as [..., 3(component), 10]."""
    b0, b1, b2 = bary[..., 0], bary[..., 1], bary[..., 2]
    b0_2, b1_2, b2_2 = b0 * b0, b1 * b1, b2 * b2
    z = jnp.zeros_like(b0)
    # order of columns: CP300,CP030,CP003,CP210,CP120,CP021,CP012,CP102,CP201,CP111
    w0 = jnp.stack(
        [b0_2, z, z, 2.0 * b0 * b1, b1_2, z, z, b2_2, 2.0 * b0 * b2, 2.0 * b1 * b2],
        axis=-1,
    )
    w1 = jnp.stack(
        [z, b1_2, z, b0_2, 2.0 * b0 * b1, 2.0 * b1 * b2, b2_2, z, z, 2.0 * b0 * b2],
        axis=-1,
    )
    w2 = jnp.stack(
        [z, z, b2_2, z, z, b1_2, 2.0 * b1 * b2, 2.0 * b0 * b2, b0_2, 2.0 * b0 * b1],
        axis=-1,
    )
    return jnp.stack([w0, w1, w2], axis=-2)


def patch_normal(control_points, deriv_b, bary):
    """Unit surface normal via two directional derivatives
    (reference/bezierTriangle.cpp:197-233).

    control_points [...,10,3], deriv_b [...,3], bary [...,3] -> [...,3].
    """
    w = _quadratic_component_weights(bary)  # [...,3,10]
    # unrolled full-f32 contraction (see interpolate for why not einsum)
    comps = jnp.sum(
        w[..., None] * control_points[..., None, :, :], axis=-2
    )  # [...,3,3]
    comp_a = comps[..., 0, :] - comps[..., 2, :]  # dot with DERIV_A=(1,0,-1)
    comp_b = jnp.sum(deriv_b[..., None] * comps, axis=-2)
    return geom.safe_normalize(jnp.cross(comp_a, comp_b))
