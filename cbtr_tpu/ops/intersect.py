"""Ray x Bezier-patch intersection — THE hot kernel.

Branch-free, batched re-design of BezierTriangle::intersect +
BezierMesh::intersect (reference/bezierTriangle.cpp:123-195,
reference/bezierMesh.cpp:206-227):

* the reference's early-return `if` pyramid becomes validity masks;
* the fixed 4-iteration Newton-style root search is statically unrolled;
* the per-candidate "follow side" retry on a neighbour patch
  (reference/bezierMesh.cpp:213-217) becomes a gather of the neighbour's
  *already computed* gate-off candidate (see below);
* the sequential min-distance scan becomes a masked argmin over the patch
  axis.

Sweep / select / recompute decomposition
----------------------------------------
The O(rays x patches) sweep only has to answer two questions per pair:
"did this patch produce an accepted candidate?" (a 4-bit code) and "at what
along-ray distance?".  Everything else (hit point, normal, barycentric,
cos-incidence — and every *gradient*) is only needed for the one winning
patch per ray.  So the op runs in three stages:

1. **sweep** (stop-gradient): for every (ray, patch) pair evaluate the
   candidate with the barycentric domain gate OFF and emit
   ``code = what | (in_domain << 3)`` plus the distance.  The
   gate-ON result is recoverable from the gate-OFF one because the gate only
   ANDs one more condition into validity — the Newton iteration itself is
   identical (reference/bezierTriangle.cpp:127-131 shows the gate touches
   only the early-out, not the math).
2. **select** (integer ops): reconstruct the reference's two-pass semantics.
   Pass-1 candidate = gate-ON result; if it says cFollowSideX, the retry
   candidate is the gate-OFF result of the indicated neighbour — which the
   sweep has already computed — fetched with a scalar gather instead of
   re-evaluating whole patch rows.  Masked argmin picks the min-distance
   cIntersect (reference/bezierMesh.cpp:220-222).
3. **recompute** (differentiable): re-evaluate the single winning patch per
   ray to produce point/normal/bary/cos.  Gradients w.r.t. control points
   and rays flow only through this O(rays) stage — identical values to
   differentiating the sweep (the winner's fields are the same arithmetic)
   at 1/P of the backward cost.

On the GPU, stages 1+2 run fused in one kernel (ops/pallas_sweep.py) that
keeps the per-pair state in registers and returns only each ray's winner;
`sweep_backend` chooses between it and the staged XLA form above.

Numerical-safety deltas vs the reference (documented, not behavioural in
practice):
* `Plane::intersect(point, direction)` in the Newton loop leaves the result
  point *uninitialized* when the signed distance is negative
  (reference/3dGeomUtil.h:279-296 only writes mPoint when mDistance > 0, yet
  bezierTriangle.cpp:159 reads it unconditionally).  We compute the projected
  point unconditionally — the mathematically intended projection.
* every division/normalization is epsilon-guarded so dead lanes carry finite
  garbage instead of NaN (gradient safety).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .. import geom
from ..config import DEFAULT as CFG
from ..bezier.patches import BezierPatches, interpolate, patch_normal

# BezierIntersection::What (reference/bezierTriangle.h:8-14)
WHAT_FOLLOW_SIDE0 = 0
WHAT_FOLLOW_SIDE1 = 1
WHAT_FOLLOW_SIDE2 = 2
WHAT_NONE = 3
WHAT_INTERSECT = 4

# sentinel distance for missed rays (plain float: no backend init at import)
_BIG = 3.4e38


class RayHit(NamedTuple):
    """Per-ray intersection record (reference BezierIntersection + patch id)."""

    what: jnp.ndarray          # [...] i32
    distance: jnp.ndarray      # [...] f32 (along-ray)
    point: jnp.ndarray         # [..., 3]
    normal: jnp.ndarray        # [..., 3] unit surface normal
    bary: jnp.ndarray          # [..., 3]
    cos_incidence: jnp.ndarray # [...] dot(ray dir, normal)
    patch: jnp.ndarray         # [...] i32 winning patch (or -1)


def _candidates_core(patches: BezierPatches, start, direction):
    """Gate-OFF candidate evaluation of every ray against every patch row.

    patches leaves have leading shape [...]; start/direction broadcast with
    it.  Returns (what, distance, point, normal, bary, cos_out, in_dom)
    where in_dom is the barycentric in-[0,1] gate of
    LimitPlaneIntersection::cThis (reference/bezierTriangle.cpp:127-131);
    the gate-ON result is the same candidate with ``valid &= in_dom``.
    """
    cp = patches.control_points
    n = geom.plane_normal(patches.underlying)
    c = geom.plane_constant(patches.underlying)
    h_in = patches.heights[..., 0]
    h_out = patches.heights[..., 1]

    # ray x underlying plane (reference/bezierTriangle.cpp:124-126)
    cos_inc = geom.dot(direction, n)
    dist0 = geom.safe_div(c - geom.dot(n, start), cos_inc)
    valid = (jnp.abs(cos_inc) >= CFG.ray_plane_intersection_epsilon) & (dist0 > 0.0)
    # self-reintersection slab gate
    valid &= (jnp.abs(dist0) > -h_in) & (jnp.abs(dist0) > h_out)

    point0 = start + dist0[..., None] * direction
    bary0 = geom.apply_mat3(patches.bary_inverse, point0)
    in_dom = jnp.all((bary0 >= 0.0) & (bary0 <= 1.0), axis=-1)

    # Gradient hygiene: lanes already known dead still run the arithmetic
    # below; substitute tame values so no lane can reach inf (an inf forward
    # value turns masked cotangents into 0*inf = NaN that *sums* into real
    # control-point gradients).  Observable outputs are unaffected: dead
    # lanes end as WHAT_NONE either way.
    dist0 = jnp.where(valid, dist0, 1.0)
    cos_inc = jnp.where(valid, cos_inc, 1.0)

    # bracket along the ray (reference/bezierTriangle.cpp:132-135)
    d_in = geom.safe_div(h_in, cos_inc)
    d_out = geom.safe_div(h_out, cos_inc)
    closer = dist0 + jnp.where(cos_inc > 0.0, d_in, d_out)
    further = dist0 + jnp.where(cos_inc > 0.0, d_out, d_in)

    def surface_diff(t):
        p = start + t[..., None] * direction
        b = geom.apply_mat3(
            patches.bary_inverse, geom.plane_project(patches.underlying, p)
        )
        b = jnp.clip(b, -16.0, 16.0)  # bound cubic blow-up on hopeless lanes
        surf = interpolate(cp, b)
        return jnp.abs(geom.plane_distance(patches.underlying, p)) - jnp.abs(
            geom.plane_distance(patches.underlying, surf)
        )

    # secant-style estimate with midpoint fallback (cpp:137-152)
    diff_closer = surface_diff(closer)
    diff_further = surface_diff(further)
    denom = diff_closer - diff_further
    secant = geom.safe_div(diff_closer * further - diff_further * closer, denom)
    middle = jnp.where(
        jnp.abs(denom) < CFG.intersection_estimation_epsilon,
        (closer + further) / 2.0,
        secant,
    )
    if CFG.clamp_secant_estimate:
        # keep the first estimate inside the bracket (see config.py — the
        # unclamped reference secant loses exit hits on concave geometry)
        lo = jnp.minimum(closer, further)
        hi = jnp.maximum(closer, further)
        middle = jnp.clip(middle, lo, hi)
    else:
        middle = jnp.clip(middle, -1e7, 1e7)

    # fixed-iteration Newton-like refinement, statically unrolled (cpp:155-164)
    proj_dir = jnp.broadcast_to(n, middle.shape + (3,))
    distance = middle
    for _ in range(CFG.root_search_iterations):
        distance = middle
        p = start + middle[..., None] * direction
        t = geom.safe_div(c - geom.dot(n, p), geom.dot(proj_dir, n))
        plane_pt = p + t[..., None] * proj_dir
        bary = geom.apply_mat3(patches.bary_inverse, plane_pt)
        bary = jnp.clip(bary, -16.0, 16.0)  # diverged lanes fail acceptance anyway
        normal = patch_normal(cp, patches.deriv_b, bary)
        surf_pt = interpolate(cp, bary)
        step = surf_pt - plane_pt
        new_dir = geom.safe_normalize(step)
        # keep the previous direction when the step vanished (converged lane)
        proj_dir = jnp.where(
            (geom.dot(step, step) > 0.0)[..., None], new_dir, proj_dir
        )
        middle = jnp.clip(
            geom.safe_div(
                geom.dot(surf_pt - start, normal), geom.dot(direction, normal)
            ),
            -1e7,
            1e7,
        )

    # acceptance (cpp:165-167): point close to the ray line AND beyond the slab
    ray_dist = geom.ray_point_distance(start, direction, surf_pt)
    accept = (ray_dist <= CFG.max_intersection_distance_from_ray) & (
        distance >= (further - closer) * CFG.minimal_ray_distance
    )
    valid &= accept

    # domain classification against divider planes (cpp:169-184)
    d_div = geom.plane_distance(patches.dividers, surf_pt[..., None, :])  # [...,3]
    outside = (
        (d_div[..., 0] < 0.0).astype(jnp.int32)
        + (d_div[..., 1] < 0.0).astype(jnp.int32) * 2
        + (d_div[..., 2] < 0.0).astype(jnp.int32) * 4
    )
    what = jnp.where(
        outside == 1,
        WHAT_FOLLOW_SIDE0,
        jnp.where(
            outside == 2,
            WHAT_FOLLOW_SIDE1,
            jnp.where(outside == 4, WHAT_FOLLOW_SIDE2, WHAT_INTERSECT),
        ),
    )
    what = jnp.where(valid, what, WHAT_NONE).astype(jnp.int32)
    cos_out = geom.dot(direction, normal)
    return what, distance, surf_pt, normal, bary, cos_out, in_dom


def patch_candidates(patches: BezierPatches, start, direction, limit_domain):
    """Candidate intersection of every ray against every given patch row.

    limit_domain=True applies the barycentric in-[0,1] gate.
    Returns (what, distance, point, normal, bary, cos_out).
    """
    what, dist, pt, n, b, cos_out, in_dom = _candidates_core(
        patches, start, direction
    )
    if limit_domain:
        what = jnp.where(in_dom, what, WHAT_NONE).astype(jnp.int32)
    return what, dist, pt, n, b, cos_out


def sweep_codes_xla(patches: BezierPatches, start, direction):
    """XLA sweep: per-(ray, patch) gate-OFF code and distance.

    start/direction [R,3]; returns (code [R,P] i32, dist [R,P] f32) with
    ``code = what | (in_dom << 3)``.
    """
    s = start[:, None, :]
    d = direction[:, None, :]
    what, dist, _, _, _, _, in_dom = _candidates_core(patches, s, d)
    code = what | (in_dom.astype(jnp.int32) << 3)
    return code, dist


# above this patch count the [P,P] one-hot vote matmul (memory O(P^2),
# flops O(R*P^2)) gives way to the O(R*P) gather formulation
_SELECT_VOTE_MAX_P = 2048


def select_candidates(code, dist, neighbours):
    """Reconstruct reference two-pass semantics from sweep codes and pick the
    min-distance winner (reference/bezierMesh.cpp:211-225).

    code/dist [R,P]; neighbours [P,3] i32 (global ids).  Returns
    (any_hit [R] bool, win_patch [R] i32, win_dist [R] f32).

    Two formulations with identical winners (tested against each other and
    against a NumPy brute force):

    * P <= 2048 — **one-hot votes**: patch q receives "follow votes" from
      its neighbours via three one-hot [R,P] @ [P,P] bf16 matmuls (exact:
      0/1 values, sums <= 3, under any matmul precision).  A pair (r, q) is
      a retry candidate iff voted and its own gate-OFF result is
      cIntersect; its distance is read *in place* at slot q — no value
      gathers at all, and the matmul runs on the matrix units.
    * P > 2048 — **column gathers**: for side s the static index vector
      ``q_s = neighbours[:, s]`` fetches the neighbour's code/dist columns;
      O(R*P) memory, no [P,P] materialization, scales to the 1e4..1e6
      patches of refined meshes.

    Both place the retry candidate so the winner id and distance are the
    neighbour's own — the same candidate multiset as the reference's
    forward retry.
    """
    P = code.shape[-1]
    what_off = code & 7
    in_dom = (code >> 3) > 0
    what_on = jnp.where(in_dom, what_off, WHAT_NONE)
    hit_off = what_off == WHAT_INTERSECT

    if P <= _SELECT_VOTE_MAX_P:
        votes = None
        for s in range(3):
            a_s = (
                neighbours[:, s, None] == jnp.arange(P, dtype=neighbours.dtype)
            ).astype(jnp.bfloat16)
            f_s = (what_on == s).astype(jnp.bfloat16)
            v = jnp.dot(f_s, a_s, preferred_element_type=jnp.float32)
            votes = v if votes is None else votes + v
        retried = (votes > 0.0) & hit_off
        considered = (what_on == WHAT_INTERSECT) | retried
        key = jnp.where(considered, dist, _BIG)
        best = jnp.argmin(key, axis=-1)
        best_key = jnp.min(key, axis=-1)
        return best_key < _BIG, best.astype(jnp.int32), best_key

    ids = jnp.arange(P, dtype=jnp.int32)
    # pass 1 (gate ON) direct hits, keyed at their own slot
    key = jnp.where(what_on == WHAT_INTERSECT, dist, _BIG)
    win_ids = jnp.broadcast_to(ids, key.shape)

    for s in range(3):
        q_s = neighbours[:, s].astype(jnp.int32)          # [P] static indices
        key_s = jnp.where(
            (what_on == s) & jnp.take(hit_off, q_s, axis=-1),
            jnp.take(dist, q_s, axis=-1),
            _BIG,
        )
        better = key_s < key
        win_ids = jnp.where(better, q_s, win_ids)
        key = jnp.minimum(key, key_s)

    best = jnp.argmin(key, axis=-1)
    best_key = jnp.min(key, axis=-1)
    any_hit = best_key < _BIG
    win = jnp.take_along_axis(win_ids, best[..., None], axis=-1)[..., 0]
    return any_hit, win.astype(jnp.int32), best_key


def recompute_winner(patches: BezierPatches, start, direction, any_hit, win,
                     with_check: bool = False):
    """Differentiable re-evaluation of each ray's winning patch.

    with_check=True additionally returns the number of rays whose winner the
    sweep accepted but the XLA recompute rejects (``what != cIntersect``) —
    the sweep (whose kernel reassociates the f32 arithmetic) is trusted for
    acceptance, so a nonzero count means a backend disagreement that would
    otherwise silently ship a rejected candidate's fields.  bench.py reports
    and bounds it; tests assert it is 0 on CPU where both stages share XLA
    arithmetic.
    """
    # ONE [R, 60] gather from the packed float table instead of six per-leaf
    # gathers (and one backward scatter instead of six; see packed_f32).
    # The recompute never reads neighbours, so the row-struct carries zeros.
    idx = jnp.maximum(win, 0)
    rows = BezierPatches.from_packed_f32(
        jnp.take(patches.packed_f32(), idx, axis=0),
        jnp.zeros(idx.shape + (3,), jnp.int32),
    )
    what_w, dist_w, pt, n, b, cos_w = patch_candidates(rows, start, direction, False)
    hit = RayHit(
        what=jnp.where(any_hit, WHAT_INTERSECT, WHAT_NONE).astype(jnp.int32),
        distance=jnp.where(any_hit, dist_w, _BIG),
        point=pt,
        normal=n,
        bary=b,
        cos_incidence=cos_w,
        patch=jnp.where(any_hit, win, -1).astype(jnp.int32),
    )
    if with_check:
        disagree = jnp.sum(
            (any_hit & (what_w != WHAT_INTERSECT)).astype(jnp.int32)
        )
        return hit, disagree
    return hit


def candidates_with_retry(local_patches: BezierPatches,
                          full_patches: BezierPatches, local_base, start,
                          direction):
    """Per-(ray, local patch) candidates after the follow-side retry.

    Kept for the dense/debug path; the production path is
    sweep -> select_candidates -> recompute_winner.

    local_patches: the patch rows this caller scans (a shard or the whole
    table); full_patches: the complete table the retry gathers neighbour
    rows from (neighbour ids are global); local_base: global id of
    local_patches row 0.  start/direction [R,3].

    Returns (what, distance, point, normal, bary, cos, global_patch_id), each
    [R, P_local(, 3)].
    """
    P = local_patches.num_patches
    R = start.shape[0]
    s = start[:, None, :]  # [R,1,3] broadcast over patches
    d = direction[:, None, :]

    # pass 1: local patches, domain gate ON
    what1, dist1, pt1, n1, b1, cos1 = patch_candidates(local_patches, s, d, True)

    # follow-side retry: evaluate the indicated neighbour, gate OFF
    # (reference/bezierMesh.cpp:213-217)
    follow = what1 < WHAT_NONE
    side = jnp.clip(what1, 0, 2)
    nb = jnp.take_along_axis(
        jnp.broadcast_to(local_patches.neighbours[None], (R, P, 3)),
        side[..., None],
        axis=-1,
    )[..., 0]
    nb = jnp.where(follow, nb, 0)
    rows = full_patches.row(nb)  # [R,P] gathered patch rows
    what2, dist2, pt2, n2, b2, cos2 = patch_candidates(rows, s, d, False)

    def merge(a2, a1):
        cond = follow[..., None] if a1.ndim == 3 else follow
        return jnp.where(cond, a2, a1)

    local_ids = local_base + jnp.arange(P, dtype=jnp.int32)
    hit_patch = jnp.where(follow, nb, jnp.broadcast_to(local_ids, follow.shape))
    return (
        merge(what2, what1),
        merge(dist2, dist1),
        merge(pt2, pt1),
        merge(n2, n1),
        merge(b2, b1),
        merge(cos2, cos1),
        hit_patch.astype(jnp.int32),
    )


def select_best(what, dist, pt, n, b, cos, hit_patch) -> RayHit:
    """Min-distance cIntersect wins (reference/bezierMesh.cpp:220-222);
    reduces the trailing patch axis."""
    considered = what == WHAT_INTERSECT
    key = jnp.where(considered, dist, _BIG)
    best = jnp.argmin(key, axis=-1)  # [R]

    def pick(m):
        return jnp.take_along_axis(
            m, best[:, None, None] if m.ndim == 3 else best[:, None], axis=1
        ).squeeze(1)

    any_hit = jnp.any(considered, axis=-1)
    return RayHit(
        what=jnp.where(any_hit, WHAT_INTERSECT, WHAT_NONE).astype(jnp.int32),
        distance=jnp.where(any_hit, pick(dist), _BIG),
        point=pick(pt),
        normal=pick(n),
        bary=pick(b),
        cos_incidence=pick(cos),
        patch=jnp.where(any_hit, pick(hit_patch), -1).astype(jnp.int32),
    )


def sweep_backend(platform: str, num_patches: int) -> str:
    """The sweep for a device platform: "pallas" (the Triton-route winner
    kernel, ops/pallas_sweep.py) on the GPU, "xla" (`sweep_codes_xla` +
    `select_candidates`) on the CPU.  Any other platform is an error.

    num_patches is part of the choice's key: the kernel was measured against
    the XLA path at P = 450 and P = 7,200 (PERF.md) and won at both, so
    today every patch count maps to the same kernel on the GPU."""
    del num_patches
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        return "xla"
    raise ValueError(f"no sweep for platform {platform!r}")


# Working set per ray of one intersect_rays call, for the ray-chunk bound,
# from the compiled temp sizes on an H100 at 262,144 rays x 450 patches:
# the kernel path's intersect with its gradient took 1,444 B/ray (the
# recompute's residuals plus the [R, B] cull-list build, B = 29 blocks);
# the XLA path's took 221 B per (ray, patch) for the [R, P] sweep
# intermediates, codes, distances and the select's vote operands.  The
# constants carry about 1.2-2x of margin over those.
_RECOMPUTE_BYTES_PER_RAY = 2048
_LIST_BYTES_PER_BLOCK = 16
_XLA_BYTES_PER_PAIR = 256
# share of the device's memory one intersect call may plan to use: a train
# step holds two refraction passes' residuals plus the splat at once
_MEMORY_SHARE = 0.25
_CHUNK_ALIGN = 128  # keeps chunks whole kernel tiles


def ray_chunk_size(num_rays: int, num_patches: int, backend: str,
                   bytes_limit: int | None) -> int:
    """Rays per chunk so that one intersect call stays within
    _MEMORY_SHARE of `bytes_limit` (device.memory_stats()["bytes_limit"]).
    Returns 0 when the whole batch fits or there is no limit (the CPU
    reports none); otherwise the chunk: a multiple of _CHUNK_ALIGN, sized so
    the chunks split num_rays as evenly as that allows."""
    if not bytes_limit:
        return 0
    from .pallas_sweep import BLOCK_P

    per_ray = _RECOMPUTE_BYTES_PER_RAY
    if backend == "xla":
        per_ray += _XLA_BYTES_PER_PAIR * num_patches
    else:
        per_ray += _LIST_BYTES_PER_BLOCK * -(-num_patches // BLOCK_P)
    cap = int(bytes_limit * _MEMORY_SHARE) // per_ray
    cap = max(cap - cap % _CHUNK_ALIGN, _CHUNK_ALIGN)
    if num_rays <= cap:
        return 0
    n_chunks = -(-num_rays // cap)
    chunk = -(-num_rays // n_chunks)
    return chunk + (-chunk) % _CHUNK_ALIGN


def _device_bytes_limit() -> int | None:
    stats = jax.devices()[0].memory_stats()
    return stats.get("bytes_limit") if stats else None


def _winner_chunk(patches: BezierPatches, start, direction, backend: str,
                  interpret: bool = False):
    """Stages 1+2 (sweep + select) for a chunk of rays — the gradient-free
    winner search.  Returns (any_hit [R] bool, win [R] i32)."""
    sg = jax.lax.stop_gradient
    p_sg, s_sg, d_sg = sg(patches), sg(start), sg(direction)
    if backend == "pallas":
        from .pallas_sweep import sweep_winner_pallas

        any_hit, win, _ = sweep_winner_pallas(p_sg, s_sg, d_sg, interpret)
        return any_hit, win
    code, dist = sweep_codes_xla(p_sg, s_sg, d_sg)
    any_hit, win, _ = select_candidates(code, dist, p_sg.neighbours)
    return any_hit, win


def _intersect_chunk(patches: BezierPatches, start, direction,
                     backend: str, interpret: bool = False):
    """Full mesh intersection for a chunk of rays. start/direction [R,3]."""
    any_hit, win = _winner_chunk(patches, start, direction, backend, interpret)
    # stage 3: differentiable winner recompute
    return recompute_winner(patches, start, direction, any_hit, win)


@functools.partial(jax.jit,
                   static_argnames=("chunk_size", "backend", "interpret"))
def intersect_rays(patches: BezierPatches, start, direction,
                   chunk_size: int = 0, backend: str = "auto",
                   interpret: bool = False):
    """Intersect a batch of rays with the whole Bezier surface.

    start/direction: [..., 3].  chunk_size > 0 scans the ray axis in chunks
    of that size; chunk_size = 0 derives the chunk from the device's memory
    (ray_chunk_size; no chunking where the device reports no limit).
    backend: "auto" (sweep_backend for the default device), "pallas" (the
    winner kernel) or "xla" (the reference sweep + select).  interpret=True
    runs the kernel in Pallas interpret mode (tests on the CPU).
    Returns a RayHit with leading shape [...].
    """
    batch_shape = start.shape[:-1]
    s = start.reshape(-1, 3).astype(jnp.float32)
    d = direction.reshape(-1, 3).astype(jnp.float32)
    R = s.shape[0]

    if backend == "auto":
        backend = sweep_backend(jax.devices()[0].platform,
                                patches.num_patches)
    if not chunk_size:
        chunk_size = ray_chunk_size(R, patches.num_patches, backend,
                                    _device_bytes_limit())

    if chunk_size and R > chunk_size:
        pad = (-R) % chunk_size
        s = jnp.pad(s, ((0, pad), (0, 0)))
        d = jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0)
        s = s.reshape(-1, chunk_size, 3)
        d = d.reshape(-1, chunk_size, 3)
        # Rematerialize each chunk's RECOMPUTE stage only: without remat,
        # differentiating through the scan stacks every chunk's
        # recompute/Newton residuals (~6 KB/ray).  The checkpoint boundary
        # sits BELOW the winner search: the sweep is gradient-free and its
        # per-chunk outputs are 5 B/ray, so saving (any_hit, win) and
        # re-running only the O(rays) recompute in backward is cheap, where
        # wrapping the whole chunk would re-run the O(rays x patches) sweep
        # in backward.  The unchunked path keeps full residuals.
        recompute_ckpt = jax.checkpoint(recompute_winner)

        def map_body(sd):
            ah, w = _winner_chunk(patches, sd[0], sd[1], backend, interpret)
            return recompute_ckpt(patches, sd[0], sd[1], ah, w)

        hits = jax.lax.map(map_body, (s, d))
        hit = jax.tree.map(
            lambda x: x.reshape((-1,) + x.shape[2:])[:R], hits
        )
    else:
        hit = _intersect_chunk(patches, s, d, backend, interpret)
    return jax.tree.map(
        lambda x: x.reshape(batch_shape + x.shape[1:]), hit
    )
