"""GPU winner sweep: the ray x patch scan as one Pallas kernel on the Triton route.

For every ray the kernel returns the winner of the reference's brute-force
scan with one follow-side retry (reference/bezierMesh.cpp:206-227): the
min-distance cIntersect candidate and its patch id.  It is the same answer
`sweep_codes_xla` + `select_candidates` give (ops/intersect.py), without
their [R, P] code and distance arrays: per-ray state stays in registers and
the kernel writes 8 B per ray.

Layout and control flow:

* **one program per TILE_R-ray tile**, rays on the minor axis: every value
  of the Newton body is a [TILE_R] vector, one lane per ray, and every patch
  feature is a scalar loaded from a feature-major table, so each feature is
  one uniform load that stays in L1/L2 (four [W, P] tables of 4 B entries:
  0.5 MB at P = 450, 17 MB at P = 16,200, under the 50 MB L2);
* **cull lists instead of scalar prefetch**: `tile_block_lists` gives each
  tile the ids of the BLOCK_P-patch blocks whose merged bounding sphere and
  box some ray of the tile hits.  The program reads its own count and its
  own row of the [T, B] lists and loops over those blocks only; inside a
  block each patch is evaluated only when its own sphere is hit by some ray;
* **the retry is resolved at the voter**: when patch p's gate-ON candidate
  says cFollowSide_s, the kernel evaluates the neighbour q = neighbours[p, s]
  with the gate OFF from a neighbour-permuted copy of the table
  (T_s[:, p] = T[:, q]), the same arithmetic on the same f32 values that the
  staged select reads from q's own sweep slot;
* **running argmin in the loop carry**: (best distance, best id), where an
  equal distance goes to the lowest patch id, the rule `select_candidates`
  applies.

Padding patches are all-zero rows: zero plane normal -> |cos| < epsilon ->
cNone, and radius 0 keeps them out of every block sphere.

`interpret=True` runs the same kernel on the CPU; that is how the tests
reach it.  It is never inferred from the platform.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..config import DEFAULT as CFG
from ..bezier.patches import BezierPatches

# feature rows of the feature-major [W, P] patch table
_ROW_CP = 0        # 30 rows: control point k at rows (3k, 3k+1, 3k+2)
_ROW_PLANE = 30    # 4 rows: underlying plane nx, ny, nz, c
_ROW_BINV = 34     # 9 rows: barycentric inverse, row-major
_ROW_H = 43        # 2 rows: heights (inside, outside)
_ROW_DB = 45       # 3 rows: second derivative direction
_ROW_DIV = 48      # 12 rows: 3 divider planes x (nx, ny, nz, c)
_ROW_BSPHERE = 60  # 4 rows: bounding sphere cx, cy, cz, radius (inflated)
_W = 64

_WHAT_NONE = 3
_WHAT_INTERSECT = 4
_BIG_F = 3.4e38    # miss sentinel (matches ops.intersect._BIG)

TILE_R = 128       # rays per program
BLOCK_P = 16       # patches per cull block
NUM_WARPS = 4      # one ray per thread at TILE_R = 128
NUM_STAGES = 1     # the loops carry no tile loads to pipeline


def _safe_div(num, den, eps=1e-12):
    den_safe = jnp.where(jnp.abs(den) < eps, jnp.where(den < 0, -eps, eps), den)
    return num / den_safe


def _sphere_hit(row, sx, sy, sz, dx, dy, dz):
    """Bounding-sphere cull test (the Ritter cull the reference declared but
    never implemented: reference/3dGeomUtil.h:351-362, README.md:194).
    Patch surface ⊂ convex hull of its control net ⊂ the packed (inflated)
    sphere."""
    bcx, bcy, bcz = row(_ROW_BSPHERE), row(_ROW_BSPHERE + 1), row(_ROW_BSPHERE + 2)
    brad = row(_ROW_BSPHERE + 3)
    relx, rely, relz = bcx - sx, bcy - sy, bcz - sz
    t_ca = relx * dx + rely * dy + relz * dz
    rel2 = relx * relx + rely * rely + relz * relz
    r2 = brad * brad
    return ((rel2 - t_ca * t_ca) <= r2) & ((t_ca >= 0.0) | (rel2 <= r2))


def _candidate(row, sx, sy, sz, dx, dy, dz):
    """Gate-OFF candidate of one patch against a ray vector, written out
    elementwise (same math as ops.intersect._candidates_core).  row(j) is
    the patch's feature j.  Returns (what, in_dom, distance)."""
    nx, ny, nz, c = (row(_ROW_PLANE + k) for k in range(4))
    h_in, h_out = row(_ROW_H), row(_ROW_H + 1)

    # ray x underlying plane (reference/bezierTriangle.cpp:124-126)
    cos_inc = dx * nx + dy * ny + dz * nz
    dist0 = _safe_div(c - (sx * nx + sy * ny + sz * nz), cos_inc)
    valid = (jnp.abs(cos_inc) >= CFG.ray_plane_intersection_epsilon) & (dist0 > 0.0)
    valid &= (jnp.abs(dist0) > -h_in) & (jnp.abs(dist0) > h_out)

    m = [row(_ROW_BINV + k) for k in range(9)]

    def bary_of(px, py, pz):
        b0 = m[0] * px + m[1] * py + m[2] * pz
        b1 = m[3] * px + m[4] * py + m[5] * pz
        b2 = m[6] * px + m[7] * py + m[8] * pz
        return b0, b1, b2

    b0, b1, b2 = bary_of(sx + dist0 * dx, sy + dist0 * dy, sz + dist0 * dz)
    in_dom = (
        (b0 >= 0.0) & (b0 <= 1.0)
        & (b1 >= 0.0) & (b1 <= 1.0)
        & (b2 >= 0.0) & (b2 <= 1.0)
    )

    # tame dead lanes (keeps inf/NaN out of the arithmetic below)
    dist0 = jnp.where(valid, dist0, 1.0)
    cos_inc = jnp.where(valid, cos_inc, 1.0)

    # bracket along the ray (reference/bezierTriangle.cpp:132-135)
    d_in = _safe_div(h_in, cos_inc)
    d_out = _safe_div(h_out, cos_inc)
    going = cos_inc > 0.0
    closer = dist0 + jnp.where(going, d_in, d_out)
    further = dist0 + jnp.where(going, d_out, d_in)

    cpx = [row(_ROW_CP + 3 * k) for k in range(10)]
    cpy = [row(_ROW_CP + 3 * k + 1) for k in range(10)]
    cpz = [row(_ROW_CP + 3 * k + 2) for k in range(10)]

    def clip_bary(b):
        return jnp.clip(b, -16.0, 16.0)

    def interpolate(b0, b1, b2):
        b0_2, b1_2, b2_2 = b0 * b0, b1 * b1, b2 * b2
        w = (
            b0 * b0_2, b1 * b1_2, b2 * b2_2,
            3.0 * b1 * b0_2, 3.0 * b0 * b1_2,
            3.0 * b2 * b1_2, 3.0 * b1 * b2_2,
            3.0 * b0 * b2_2, 3.0 * b2 * b0_2,
            6.0 * b0 * b1 * b2,
        )
        fx = w[0] * cpx[0]
        fy = w[0] * cpy[0]
        fz = w[0] * cpz[0]
        for k in range(1, 10):
            fx += w[k] * cpx[k]
            fy += w[k] * cpy[k]
            fz += w[k] * cpz[k]
        return fx, fy, fz

    def surface_diff(t):
        px = sx + t * dx
        py = sy + t * dy
        pz = sz + t * dz
        pd = px * nx + py * ny + pz * nz - c
        b0, b1, b2 = bary_of(px - nx * pd, py - ny * pd, pz - nz * pd)
        fx, fy, fz = interpolate(clip_bary(b0), clip_bary(b1), clip_bary(b2))
        sd = fx * nx + fy * ny + fz * nz - c
        return jnp.abs(pd) - jnp.abs(sd)

    # secant-style estimate with midpoint fallback (cpp:137-152)
    diff_closer = surface_diff(closer)
    diff_further = surface_diff(further)
    denom = diff_closer - diff_further
    secant = _safe_div(diff_closer * further - diff_further * closer, denom)
    middle = jnp.where(
        jnp.abs(denom) < CFG.intersection_estimation_epsilon,
        (closer + further) / 2.0,
        secant,
    )
    if CFG.clamp_secant_estimate:
        # bracket clamp (see config.py): recovers concave-fixture exit hits
        middle = jnp.clip(
            middle, jnp.minimum(closer, further), jnp.maximum(closer, further)
        )
    else:
        middle = jnp.clip(middle, -1e7, 1e7)

    db0, db1, db2 = row(_ROW_DB), row(_ROW_DB + 1), row(_ROW_DB + 2)

    def normal_of(b0, b1, b2):
        """Quadratic directional-derivative normal
        (reference/bezierTriangle.cpp:197-233)."""
        b0_2, b1_2, b2_2 = b0 * b0, b1 * b1, b2 * b2
        ab, bc, ac = 2.0 * b0 * b1, 2.0 * b1 * b2, 2.0 * b0 * b2
        outs = []
        for cp in (cpx, cpy, cpz):
            comp0 = (b0_2 * cp[0] + ab * cp[3] + b1_2 * cp[4]
                     + b2_2 * cp[7] + ac * cp[8] + bc * cp[9])
            comp1 = (b1_2 * cp[1] + b0_2 * cp[3] + ab * cp[4]
                     + bc * cp[5] + b2_2 * cp[6] + ac * cp[9])
            comp2 = (b2_2 * cp[2] + b1_2 * cp[5] + bc * cp[6]
                     + ac * cp[7] + b0_2 * cp[8] + ab * cp[9])
            # first direction is the constant (1, 0, -1)
            outs.append((comp0 - comp2, db0 * comp0 + db1 * comp1 + db2 * comp2))
        (ax, bx), (ay, by), (az, bz) = outs
        nxo = ay * bz - az * by
        nyo = az * bx - ax * bz
        nzo = ax * by - ay * bx
        n2 = nxo * nxo + nyo * nyo + nzo * nzo
        inv = jnp.where(n2 < 1e-30, 0.0, jax.lax.rsqrt(jnp.maximum(n2, 1e-30)))
        return nxo * inv, nyo * inv, nzo * inv

    # fixed-iteration Newton-like refinement, unrolled (cpp:155-164)
    pdx = jnp.zeros_like(cos_inc) + nx
    pdy = jnp.zeros_like(cos_inc) + ny
    pdz = jnp.zeros_like(cos_inc) + nz
    distance = middle
    for _ in range(CFG.root_search_iterations):
        distance = middle
        px = sx + middle * dx
        py = sy + middle * dy
        pz = sz + middle * dz
        t = _safe_div(
            c - (px * nx + py * ny + pz * nz), pdx * nx + pdy * ny + pdz * nz
        )
        plx = px + t * pdx
        ply = py + t * pdy
        plz = pz + t * pdz
        b0, b1, b2 = bary_of(plx, ply, plz)
        b0, b1, b2 = clip_bary(b0), clip_bary(b1), clip_bary(b2)
        nmx, nmy, nmz = normal_of(b0, b1, b2)
        fx, fy, fz = interpolate(b0, b1, b2)
        stx = fx - plx
        sty = fy - ply
        stz = fz - plz
        st2 = stx * stx + sty * sty + stz * stz
        inv = jnp.where(st2 < 1e-30, 0.0, jax.lax.rsqrt(jnp.maximum(st2, 1e-30)))
        moved = st2 > 0.0
        pdx = jnp.where(moved, stx * inv, pdx)
        pdy = jnp.where(moved, sty * inv, pdy)
        pdz = jnp.where(moved, stz * inv, pdz)
        middle = jnp.clip(
            _safe_div(
                (fx - sx) * nmx + (fy - sy) * nmy + (fz - sz) * nmz,
                dx * nmx + dy * nmy + dz * nmz,
            ),
            -1e7,
            1e7,
        )

    # acceptance (cpp:165-167)
    rx = fx - sx
    ry = fy - sy
    rz = fz - sz
    along = rx * dx + ry * dy + rz * dz
    qx = rx - along * dx
    qy = ry - along * dy
    qz = rz - along * dz
    ray_dist2 = qx * qx + qy * qy + qz * qz
    max_d = CFG.max_intersection_distance_from_ray
    accept = (ray_dist2 <= max_d * max_d) & (
        distance >= (further - closer) * CFG.minimal_ray_distance
    )
    valid &= accept

    # domain classification against divider planes (cpp:169-184)
    outside = jnp.zeros_like(cos_inc, dtype=jnp.int32)
    for j in range(3):
        dnx = row(_ROW_DIV + 4 * j)
        dny = row(_ROW_DIV + 4 * j + 1)
        dnz = row(_ROW_DIV + 4 * j + 2)
        dc = row(_ROW_DIV + 4 * j + 3)
        dd = fx * dnx + fy * dny + fz * dnz - dc
        outside += jnp.where(dd < 0.0, 1 << j, 0)
    what = jnp.where(
        outside == 1, 0,
        jnp.where(outside == 2, 1, jnp.where(outside == 4, 2, _WHAT_INTERSECT)),
    )
    what = jnp.where(valid, what, _WHAT_NONE)
    return what, in_dom, distance


def patch_spheres(patches: BezierPatches):
    """Per-patch bounding sphere over the control net (surface ⊂ convex hull
    of the 10 control points), inflated 25%.  Returns (center [P,3],
    radius [P]).

    The 25% is an empirical choice, not a provable bound
    (benchmarks/inflation_probe.py): gate-OFF retry candidates can converge
    far outside the hull (the clip_bary extended-surface region), so no
    finite inflation is provably lossless.  Winners' rays needed up to 1.37x
    at the per-patch level, yet 1.25 stays exact in practice because the cull
    is (tile x block)-granular: a block is evaluated whole when any of its
    pairs passes.  1.10 was measured to drop winners on the refined robot.
    The guards: kernel/XLA agreement at every smoke and bench shape, and
    the CPU fixture suite."""
    center = jnp.mean(patches.control_points, axis=1)  # [P,3]
    radius = jnp.max(
        jnp.linalg.norm(patches.control_points - center[:, None, :], axis=-1),
        axis=-1,
    ) * 1.25 + 1e-5
    return center, radius


def _patch_boxes(cp, center, radius):
    """Per-patch AABB: control-net box expanded per axis by the sphere's
    slack (radius - r_hull, the follow-side/ray-distance inflation
    patch_spheres applied).

    cp [P,10,3] control nets, center/radius the packed (inflated) spheres.
    This leg assumes the accepted-candidate region ⊆ hull ⊕ ball(slack), a
    tighter model than the sphere leg's ball(center, radius); like the
    sphere it is empirical (see patch_spheres) and validated the same way.
    The payoff: the box hugs a surface strip in its two thin directions where
    a merged block sphere covers a ball.  Padding rows (cp = 0, radius = 0)
    yield lo = hi = 0 and are excluded by the radius mask downstream."""
    r_hull = jnp.max(
        jnp.linalg.norm(cp - center[:, None, :], axis=-1), axis=-1
    )
    slack = jnp.maximum(radius - r_hull, 0.0)[:, None]
    return jnp.min(cp, axis=1) - slack, jnp.max(cp, axis=1) + slack


def _ray_aabb_hit(lo, hi, s, d):
    """Slab test: do rays (s, d) [R,3] hit boxes [B,3]?  Returns [R,B] bool.
    Zero direction components are substituted with ±1e-30 so the slab
    arithmetic stays finite: a ray parallel to a slab then produces
    same-sign ±huge (outside -> miss) or straddling ±huge (inside -> pass),
    which is the exact parallel-ray semantics."""
    d_safe = jnp.where(jnp.abs(d) < 1e-30,
                       jnp.where(d < 0.0, -1e-30, 1e-30), d)
    inv = 1.0 / d_safe                                     # [R,3]
    t1 = (lo[None, :, :] - s[:, None, :]) * inv[:, None, :]   # [R,B,3]
    t2 = (hi[None, :, :] - s[:, None, :]) * inv[:, None, :]
    tmin = jnp.max(jnp.minimum(t1, t2), axis=-1)           # [R,B]
    tmax = jnp.min(jnp.maximum(t1, t2), axis=-1)
    return (tmax >= 0.0) & (tmin <= tmax)


def _block_bounds(patches: BezierPatches):
    """Merged per-block bounds of the padded patch table: sphere (center
    [B,3], radius [B], < 0 for all-padding blocks) and box (lo, hi [B,3])."""
    center, radius = patch_spheres(patches)
    lo, hi = _patch_boxes(patches.control_points, center, radius)
    pad = (-patches.num_patches) % BLOCK_P
    center, radius, lo, hi = (
        jnp.pad(x, ((0, pad),) + ((0, 0),) * (x.ndim - 1))
        for x in (center, radius, lo, hi)
    )
    cb = center.reshape(-1, BLOCK_P, 3)
    rb = radius.reshape(-1, BLOCK_P)
    real = rb > 0.0
    denom = jnp.maximum(jnp.sum(real, axis=1), 1).astype(jnp.float32)
    c = jnp.sum(jnp.where(real[..., None], cb, 0.0), axis=1) / denom[:, None]
    reach = jnp.linalg.norm(cb - c[:, None, :], axis=-1) + rb
    r = jnp.max(jnp.where(real, reach, -1.0), axis=1)
    lob = jnp.min(jnp.where(real[..., None], lo.reshape(-1, BLOCK_P, 3),
                            jnp.inf), axis=1)
    hib = jnp.max(jnp.where(real[..., None], hi.reshape(-1, BLOCK_P, 3),
                            -jnp.inf), axis=1)
    return c, r, lob, hib


def tile_block_lists(patches: BezierPatches, rays_t):
    """Per-tile candidate block lists for the winner kernel.

    rays_t [8, R_pad] (the kernel's feature-major ray layout, R_pad a
    multiple of TILE_R).  Returns (counts [T] i32, lists [T, B] i32):
    lists[t, :counts[t]] are the ids, ascending, of the blocks whose merged
    sphere AND merged box are hit by at least one ray of tile t.  Both legs
    are written as elementwise sums, so no f32 matmul (TF32 on the GPU) can
    round a true hit away."""
    c, r, lob, hib = _block_bounds(patches)            # [B,3], [B]
    s = rays_t[0:3, :].T                               # [R_pad, 3]
    d = rays_t[3:6, :].T
    rel = c[None, :, :] - s[:, None, :]                # [R_pad, B, 3]
    t_ca = jnp.sum(rel * d[:, None, :], axis=-1)
    rel2 = jnp.sum(rel * rel, axis=-1)
    r2 = r[None, :] * r[None, :]
    hit = ((rel2 - t_ca * t_ca) <= r2) & ((t_ca >= 0.0) | (rel2 <= r2))
    hit &= (r >= 0.0)[None, :]                         # all-padding blocks
    hit &= _ray_aabb_hit(lob, hib, s, d)
    tile_hit = hit.reshape(-1, TILE_R, hit.shape[-1]).any(axis=1)   # [T,B]
    counts = jnp.sum(tile_hit, axis=-1).astype(jnp.int32)
    lists = jnp.argsort(~tile_hit, axis=-1, stable=True).astype(jnp.int32)
    return counts, lists


def pack_tables(patches: BezierPatches):
    """(tab [4*W, P_pad] f32, nbr [3, P_pad] i32): the feature-major patch
    table followed by its three neighbour-permuted copies
    (tab[(1+s)*W + j, p] = tab[j, neighbours[p, s]]), and the neighbour ids.
    Ids are clamped to [0, P) like select_candidates' gathers; P is padded
    to a block multiple with zero columns."""
    P = patches.num_patches
    center, radius = patch_spheres(patches)
    base = jnp.concatenate(
        [
            patches.control_points.reshape(P, 30).T,   # 0..29
            patches.underlying.T,                      # 30..33
            patches.bary_inverse.reshape(P, 9).T,      # 34..42
            patches.heights.T,                         # 43..44
            patches.deriv_b.T,                         # 45..47
            patches.dividers.reshape(P, 12).T,         # 48..59
            center.T,                                  # 60..62
            radius[None],                              # 63
        ],
        axis=0,
    ).astype(jnp.float32)
    nb = jnp.clip(patches.neighbours.astype(jnp.int32), 0, P - 1)
    tab = jnp.concatenate([base] + [base[:, nb[:, s]] for s in range(3)], axis=0)
    pad = (-P) % BLOCK_P
    return jnp.pad(tab, ((0, 0), (0, pad))), jnp.pad(nb.T, ((0, 0), (0, pad)))


def pack_rays(start, direction):
    """[8, R_pad] feature-major rays (rows sx sy sz dx dy dz 0 0), R padded
    to a TILE_R multiple with rays heading -x from the origin (results for
    them are sliced away)."""
    R = start.shape[0]
    pad = (-R) % TILE_R
    rays = jnp.concatenate(
        [start.astype(jnp.float32), direction.astype(jnp.float32),
         jnp.zeros((R, 2), jnp.float32)],
        axis=-1,
    )
    pad_rows = jnp.zeros((pad, 8), jnp.float32).at[:, 3].set(-1.0)
    return jnp.concatenate([rays, pad_rows], axis=0).T


def _winner_kernel(counts_ref, lists_ref, rays_ref, tab_ref, nbr_ref,
                   dist_ref, idx_ref):
    """One program per ray tile: loop over the tile's listed blocks, fold
    each patch's direct candidate and its voters' retry candidates into the
    running (best distance, best id)."""
    i = pl.program_id(0)
    sx, sy, sz = rays_ref[0, :], rays_ref[1, :], rays_ref[2, :]
    dx, dy, dz = rays_ref[3, :], rays_ref[4, :], rays_ref[5, :]
    ray = (sx, sy, sz, dx, dy, dz)

    def fold(best, cand, cand_id):
        bd, bi = best
        take = (cand < bd) | ((cand == bd) & (cand_id < bi))
        return jnp.where(take, cand, bd), jnp.where(take, cand_id, bi)

    def any_lane(mask):
        return jnp.max(mask.astype(jnp.int32)) > 0

    def patch_body(p, best):
        def row(j):
            return tab_ref[j, p]

        def evaluate(best):
            what, in_dom, dist = _candidate(row, *ray)
            what_on = jnp.where(in_dom, what, _WHAT_NONE)
            best = fold(best, jnp.where(what_on == _WHAT_INTERSECT, dist, _BIG_F), p)

            def side(s, best):
                voted = what_on == s

                def retry(best):
                    def row_n(j):
                        return tab_ref[(s + 1) * _W + j, p]

                    what_n, _, dist_n = _candidate(row_n, *ray)
                    hit_n = voted & (what_n == _WHAT_INTERSECT)
                    return fold(best, jnp.where(hit_n, dist_n, _BIG_F),
                                nbr_ref[s, p])

                return jax.lax.cond(any_lane(voted), retry, lambda b: b, best)

            return jax.lax.fori_loop(0, 3, side, best)

        return jax.lax.cond(any_lane(_sphere_hit(row, *ray)), evaluate,
                            lambda b: b, best)

    def block_body(k, best):
        p0 = lists_ref[i, k] * BLOCK_P
        return jax.lax.fori_loop(p0, p0 + BLOCK_P, patch_body, best)

    init = (jnp.full(sx.shape, _BIG_F, jnp.float32),
            jnp.zeros(sx.shape, jnp.int32))
    best_d, best_i = jax.lax.fori_loop(0, counts_ref[i], block_body, init)
    dist_ref[:] = best_d
    idx_ref[:] = best_i


@functools.partial(jax.jit, static_argnames=("interpret",))
def _winner_call(counts, lists, rays_t, tab, nbr, interpret: bool = False):
    Rp = rays_t.shape[1]
    tile = pl.BlockSpec((TILE_R,), lambda i: (i,))
    return pl.pallas_call(
        _winner_kernel,
        grid=(Rp // TILE_R,),
        in_specs=[
            pl.no_block_spec,                                # counts [T]
            pl.no_block_spec,                                # lists [T, B]
            pl.BlockSpec((8, TILE_R), lambda i: (0, i)),     # rays
            pl.no_block_spec,                                # tab [4W, Pp]
            pl.no_block_spec,                                # nbr [3, Pp]
        ],
        out_specs=[tile, tile],
        out_shape=[
            jax.ShapeDtypeStruct((Rp,), jnp.float32),
            jax.ShapeDtypeStruct((Rp,), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="cbtr_winner_sweep",
    )(counts, lists, rays_t, tab, nbr)


def sweep_winner_pallas(patches: BezierPatches, start, direction,
                        interpret: bool = False):
    """Per-ray winner of the full scan+retry (reference/bezierMesh.cpp:
    206-227) for any patch count: (any_hit [R] bool, win [R] i32,
    win_dist [R] f32).  Memory is O(R * B) for the list build and O(R + P)
    in the kernel; callers bound R (intersect_rays)."""
    R = start.shape[0]
    rays_t = pack_rays(start, direction)
    tab, nbr = pack_tables(patches)
    counts, lists = tile_block_lists(patches, rays_t)
    dist, idx = _winner_call(counts, lists, rays_t, tab, nbr, interpret)
    return dist[:R] < (_BIG_F * 0.5), idx[:R], dist[:R]
