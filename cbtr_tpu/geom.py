"""Array-native geometry kit (layer L1).

Functional, batched re-design of the reference's header-only geometry library
(reference/3dGeomUtil.h).  Instead of scalar Eigen 3-vectors and classes, every
function here is a pure ``jnp`` function over arrays whose *last* axis holds
the 3 coordinates; arbitrary leading batch axes are supported so everything
vmaps/jits/shards cleanly.

Conventions
-----------
* ``tri``    : [..., 3, 3]  -- (corner, xyz), reference ``Triangle``
* ``plane``  : [..., 4]     -- ``plane[..., :3]`` unit normal, ``plane[..., 3]``
  constant, i.e. points p on the plane satisfy ``dot(p, n) == c``
  (reference ``Plane``, 3dGeomUtil.h:218-334)
* rays are passed as separate ``origin`` / ``direction`` arrays ([..., 3]),
  direction normalized (reference ``Ray``, 3dGeomUtil.h:168-206)

3x3 solves use the closed-form adjugate inverse: the reference benchmarked
inverse-multiply as ~10x faster than LU for this workload (solve3x3.cpp:5-13),
and a closed form keeps everything elementwise.
"""
from __future__ import annotations

import numpy as np
import jax.numpy as jnp

from .config import DEFAULT as CFG

# ---------------------------------------------------------------------------
# small numeric helpers
# ---------------------------------------------------------------------------


def safe_div(num, den, eps: float = 1e-12):
    """num/den with a sign-preserving clamp on |den| to avoid inf/NaN.

    The reference divides freely (e.g. bezierTriangle.cpp:132-133); batched
    we must keep NaNs out of masked lanes, so every division in the hot path goes
    through here. Where the reference's denominator is well-conditioned the
    result is bit-identical in f32.

    eps must stay well above sqrt(f32 denormal): the division VJP computes
    num/den^2, and den^2 underflowing to 0 turns masked-lane cotangents into
    0*inf = NaN that pollutes real gradients through the `where` trap.
    """
    den_safe = jnp.where(jnp.abs(den) < eps, jnp.where(den < 0, -eps, eps), den)
    return num / den_safe


def safe_normalize(v, eps: float = 1e-30):
    """v / |v| that returns 0 for (near-)zero vectors instead of NaN."""
    n2 = jnp.sum(v * v, axis=-1, keepdims=True)
    inv = jnp.where(n2 < eps, 0.0, 1.0 / jnp.sqrt(jnp.maximum(n2, eps)))
    return v * inv


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    return jnp.cross(a, b)


def norm(v):
    return jnp.linalg.norm(v, axis=-1)


# ---------------------------------------------------------------------------
# util:: equivalents (3dGeomUtil.h:31-165)
# ---------------------------------------------------------------------------


def triangle_normal(tri):
    """(v1-v0) x (v2-v0), unnormalized (3dGeomUtil.h:33-40)."""
    return jnp.cross(tri[..., 1, :] - tri[..., 0, :], tri[..., 2, :] - tri[..., 0, :])


def vertex_normal(v0, v1, v2):
    return jnp.cross(v1 - v0, v2 - v0)


def perimeter(tri):
    """Sum of side lengths (3dGeomUtil.h:43-45)."""
    return (
        norm(tri[..., 0, :] - tri[..., 1, :])
        + norm(tri[..., 1, :] - tri[..., 2, :])
        + norm(tri[..., 2, :] - tri[..., 0, :])
    )


def bary_to_cart(v0, v1, v2, b):
    """Barycentric -> cartesian, b=[...,3] (3dGeomUtil.h:49-67)."""
    return (
        v0 * b[..., 0:1] + v1 * b[..., 1:2] + v2 * b[..., 2:3]
    )


def inv3x3(m):
    """Closed-form adjugate inverse of [..., 3, 3] (solve3x3.cpp lesson)."""
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = jnp.stack(
        [
            jnp.stack([co_a, -(b * i - c * h), b * f - c * e], axis=-1),
            jnp.stack([co_b, a * i - c * g, -(a * f - c * d)], axis=-1),
            jnp.stack([co_c, -(a * h - b * g), a * e - b * d], axis=-1),
        ],
        axis=-2,
    )
    return adj * safe_div(1.0, det)[..., None, None]


def barycentric_inverse(v0, v1, v2):
    """Matrix M with b = M @ p for p in the triangle's plane.

    The forward matrix has the vertices as *columns* (3dGeomUtil.h:70-77).
    """
    m = jnp.stack([v0, v1, v2], axis=-1)  # [..., 3(coord), 3(vertex)]
    return inv3x3(m)


def apply_mat3(m, v):
    """[...,3,3] @ [...,3] -> [...,3]."""
    return jnp.sum(m * v[..., None, :], axis=-1)


def a_perpendicular(v):
    """Some unit vector perpendicular to v (3dGeomUtil.h:80-95)."""
    eps = CFG.a_perpendicular_epsilon
    y, z = v[..., 1], v[..., 2]
    degen = (jnp.abs(y) < eps) & (jnp.abs(z) < eps)
    denom = jnp.sqrt(y * y + z * z)
    out_y = jnp.where(degen, 1.0, safe_div(-z, denom))
    out_z = jnp.where(degen, 0.0, safe_div(y, denom))
    return jnp.stack([jnp.zeros_like(out_y), out_y, out_z], axis=-1)


def altitude(common1, common2, independent):
    """Altitude vector of `independent` over side (common1, common2)
    (3dGeomUtil.h:125-130)."""
    common_v = common2 - common1
    indep_v = independent - common1
    foot = safe_div(dot(common_v, indep_v), dot(common_v, common_v))
    return indep_v - common_v * foot[..., None]


def to_which_side(start, end):
    """Which side a barycentric segment start->end (start inside) exits.

    Returns 0/1/2 for sides (300-030), (030-003), (003-300); 3 if none
    (3dGeomUtil.h:137-164).  Branch-free: evaluates all three side tests and
    selects the last passing one, mirroring the reference's sequential
    overwrites of `result`.
    """
    eps = CFG.general_epsilon

    def side_test(s0, s1, e0, e1):
        denom = s0 - e0 + s1 - e1
        ok_d = jnp.abs(denom) > eps
        ratio = safe_div((s0 - 1.0) * e1 - s1 * (e0 - 1.0), denom)
        direction = safe_div(s0 + s1 - 1.0, denom)
        return ok_d & (ratio > -eps) & (ratio < 1.0 + eps) & (direction > 0.0)

    s0, s1, s2 = start[..., 0], start[..., 1], start[..., 2]
    e0, e1, e2 = end[..., 0], end[..., 1], end[..., 2]
    hit0 = side_test(s0, s1, e0, e1)
    hit1 = side_test(s1, s2, e1, e2)
    hit2 = side_test(s2, s0, e2, e0)
    out = jnp.full(jnp.broadcast_shapes(hit0.shape), 3, dtype=jnp.int32)
    out = jnp.where(hit0, 0, out)
    out = jnp.where(hit1, 1, out)
    out = jnp.where(hit2, 2, out)
    return out


# ---------------------------------------------------------------------------
# Plane (3dGeomUtil.h:209-334); packed [..., 4] = (unit normal, constant)
# ---------------------------------------------------------------------------


def make_plane(normal, constant):
    return jnp.concatenate([normal, constant[..., None]], axis=-1)


def plane_normal(plane):
    return plane[..., :3]


def plane_constant(plane):
    return plane[..., 3]


def plane_from_proportion_2points(proportion, p0, p1):
    """Plane perpendicular to p0->p1 at the given proportion
    (3dGeomUtil.h:233-238)."""
    n = safe_normalize(p1 - p0)
    c = dot(n, p1 * proportion + p0 * (1.0 - proportion))
    return make_plane(n, c)


def plane_from_3points(p0, p1, p2):
    """(3dGeomUtil.h:241-246)."""
    n = safe_normalize(jnp.cross(p1 - p0, p2 - p0))
    return make_plane(n, dot(n, p0))


def plane_from_triangle(tri):
    return plane_from_3points(tri[..., 0, :], tri[..., 1, :], tri[..., 2, :])


def plane_from_1vector_2points(direction, p0, p1):
    """(3dGeomUtil.h:252-257)."""
    n = safe_normalize(jnp.cross(direction, p1 - p0))
    return make_plane(n, dot(n, p0))


def plane_from_2vectors_1point(d0, d1, p):
    """(3dGeomUtil.h:260-265)."""
    n = safe_normalize(jnp.cross(d0, d1))
    return make_plane(n, dot(n, p))


def intersect_3planes(plane0, plane1, plane2):
    """Common point of three planes via adjugate inverse
    (3dGeomUtil.h:268-276)."""
    m = jnp.stack(
        [plane_normal(plane0), plane_normal(plane1), plane_normal(plane2)], axis=-2
    )
    v = jnp.stack(
        [plane_constant(plane0), plane_constant(plane1), plane_constant(plane2)],
        axis=-1,
    )
    return apply_mat3(inv3x3(m), v)


def plane_ray_intersect(plane, start, direction):
    """Ray-plane intersection (3dGeomUtil.h:279-299).

    Returns (valid, point, cos_incidence, distance).  Matches the reference:
    valid requires |cos| >= epsilon AND distance > 0; point is computed
    unconditionally (the reference leaves it undefined when invalid).
    """
    n = plane_normal(plane)
    cos_incidence = dot(direction, n)
    distance = safe_div(plane_constant(plane) - dot(n, start), cos_incidence)
    valid = (jnp.abs(cos_incidence) >= CFG.ray_plane_intersection_epsilon) & (
        distance > 0.0
    )
    point = start + distance[..., None] * direction
    return valid, point, cos_incidence, distance


def plane_project(plane, point):
    """Orthogonal projection of point onto plane (3dGeomUtil.h:303)."""
    n = plane_normal(plane)
    return point - n * (dot(point, n) - plane_constant(plane))[..., None]


def plane_distance(plane, point):
    """Signed distance, >0 on the normal side (3dGeomUtil.h:307)."""
    return dot(point, plane_normal(plane)) - plane_constant(plane)


def plane_make_distance_positive(plane, point):
    """Flip the plane so `point` lies on the positive side
    (3dGeomUtil.h:310-317)."""
    flip = plane_distance(plane, point) < 0.0
    return jnp.where(flip[..., None], -plane, plane)


# ---------------------------------------------------------------------------
# Ray helpers (3dGeomUtil.h:168-206)
# ---------------------------------------------------------------------------


def ray_perpendicular_to(start, direction, point):
    """Component of (point-start) perpendicular to the ray
    (3dGeomUtil.h:182-184)."""
    rel = point - start
    return rel - dot(rel, direction)[..., None] * direction


def ray_point_distance(start, direction, point):
    return norm(ray_perpendicular_to(start, direction, point))


def ray_point_distance2(start, direction, point):
    p = ray_perpendicular_to(start, direction, point)
    return dot(p, p)


def ray_average_error_squared(start, direction, points):
    """Mean squared distance of a point set from the ray line
    (3dGeomUtil.h:199-205)."""
    if points.shape[-2] == 0:
        return jnp.zeros(points.shape[:-2], dtype=points.dtype)
    d2 = ray_point_distance2(start[..., None, :], direction[..., None, :], points)
    return jnp.mean(d2, axis=-1)


# ---------------------------------------------------------------------------
# Spherical (3dGeomUtil.h:337-348)
# ---------------------------------------------------------------------------


def spherical_from_cartesian(p):
    """Returns (r, azimuth, inclination)."""
    r = norm(p)
    inclination = jnp.arccos(jnp.clip(safe_div(p[..., 2], r), -1.0, 1.0))
    azimuth = jnp.arctan2(p[..., 1], p[..., 0])
    return r, azimuth, inclination


# ---------------------------------------------------------------------------
# Bounding sphere (Ritter) -- reference declares Sphere::doesIntersect but
# never defines it (3dGeomUtil.h:351-362, README.md:194); we implement the
# cull it planned.
# ---------------------------------------------------------------------------


def ritter_bounding_sphere(points_np: np.ndarray):
    """Host-side Ritter approximate bounding sphere over an [N,3] point set."""
    pts = np.asarray(points_np, dtype=np.float32).reshape(-1, 3)
    x = pts[0]
    y = pts[np.argmax(np.sum((pts - x) ** 2, axis=1))]
    z = pts[np.argmax(np.sum((pts - y) ** 2, axis=1))]
    center = (y + z) / 2.0
    radius = float(np.linalg.norm(y - z) / 2.0)
    for p in pts:
        d = float(np.linalg.norm(p - center))
        if d > radius:
            new_r = (radius + d) / 2.0
            center = center + (p - center) * ((d - new_r) / d)
            radius = new_r
    return center.astype(np.float32), np.float32(radius)


def ray_sphere_hit(start, direction, center, radius):
    """Ray (half-line) vs sphere test for the planned bounding-sphere cull."""
    rel = center - start
    t = dot(rel, direction)
    d2 = dot(rel, rel) - t * t
    r2 = radius * radius
    # hit if closest approach within radius and not entirely behind the origin
    return (d2 <= r2) & ((t >= 0.0) | (dot(rel, rel) <= r2))


# ---------------------------------------------------------------------------
# Uniform triangle subdivision (3dGeomUtil.h:98-122) -- host-side lattice
# ---------------------------------------------------------------------------


def subdivision_barycentrics(divisor: int) -> np.ndarray:
    """All sub-triangle corners of the uniform lattice subdivision.

    Returns [T, 3, 3] barycentric coordinates (T = divisor**2 triangles,
    3 corners, 3 barycentric components) equivalent to util::divide applied
    to the unit barycentric triangle (used at bezierTriangle.cpp:73-80 and
    bezierMesh.cpp:57-64).  Up-triangles {q, q+e01, q+e02} for a+b<=d-1 and
    down-triangles {q+e01, q+e01+e02, q+e02} for a+b<=d-2, matching the
    reference's emission set and per-triangle vertex orientation.
    """
    d = int(divisor)
    b0 = np.array([1.0, 0.0, 0.0], dtype=np.float32)
    e01 = (np.array([0.0, 1.0, 0.0], dtype=np.float32) - b0) / d
    e02 = (np.array([0.0, 0.0, 1.0], dtype=np.float32) - b0) / d
    tris = []
    for a in range(d):
        for b in range(d - a):
            q = b0 + a * e01 + b * e02
            tris.append([q, q + e01, q + e02])
            if a + b <= d - 2:
                tris.append([q + e01, q + e01 + e02, q + e02])
    return np.asarray(tris, dtype=np.float32)


def subdivision_lattice(divisor: int) -> np.ndarray:
    """Unique barycentric lattice points (i+j+k = divisor)/divisor, [(d+1)(d+2)/2, 3]."""
    d = int(divisor)
    pts = []
    for i in range(d + 1):
        for j in range(d + 1 - i):
            k = d - i - j
            pts.append((i / d, j / d, k / d))
    return np.asarray(pts, dtype=np.float32)


def divide_triangle_np(tri: np.ndarray, divisor: int) -> np.ndarray:
    """util::divide for a cartesian triangle, host-side.

    tri: [3,3] -> [divisor**2, 3, 3] sub-triangles, same emission set as the
    reference collector (3dGeomUtil.h:98-122, used by Mesh::splitTriangles).
    """
    tri = np.asarray(tri, dtype=np.float32)
    bary = subdivision_barycentrics(divisor)  # [T,3,3]
    return np.einsum("tcb,bx->tcx", bary, tri).astype(np.float32)
