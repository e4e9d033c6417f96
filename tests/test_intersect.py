"""Ray-surface intersection tests.

Anchors: analytic sphere geometry (the Bezier surface over a fine sphere
mesh approximates it to ~1e-3) and the reference's collinearity check
(reference/test.cpp:237-319: successive entry/exit points of a straight ray
must stay on its line).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cbtr_tpu import geom
from cbtr_tpu.bezier import build_from_trimesh
from cbtr_tpu.harness import preprocess
from cbtr_tpu.mesh.core import make_unit_sphere, make_ellipsoid
from cbtr_tpu.ops import intersect_rays, WHAT_INTERSECT, WHAT_NONE


CENTER = np.array([5.0, 0.0, 0.0], np.float32)


@pytest.fixture(scope="module")
def sphere_scene():
    mesh = preprocess(make_unit_sphere(15, 7))
    mesh.translate(CENTER)
    mesh = preprocess(mesh)
    return build_from_trimesh(mesh)


def _rays(n, seed=0):
    """Random rays from origin roughly toward the displaced sphere."""
    rng = np.random.default_rng(seed)
    d = np.concatenate(
        [np.ones((n, 1)), rng.uniform(-0.12, 0.12, (n, 2))], axis=1
    ).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return np.zeros((n, 3), np.float32), d


def test_entry_hits_match_analytic_sphere(sphere_scene):
    start, d = _rays(64)
    hit = intersect_rays(sphere_scene, jnp.asarray(start), jnp.asarray(d))
    what = np.asarray(hit.what)
    assert (what == WHAT_INTERSECT).mean() > 0.95  # rare seam rays may miss

    sel = what == WHAT_INTERSECT
    pts = np.asarray(hit.point)[sel]
    # points on the unit sphere around CENTER
    r = np.linalg.norm(pts - CENTER, axis=-1)
    np.testing.assert_allclose(r, 1.0, atol=5e-3)
    # analytic first-hit distance
    oc = -CENTER
    b = (oc @ d[sel].T)
    t_analytic = -b - np.sqrt(b**2 - (oc @ oc - 1.0))
    np.testing.assert_allclose(np.asarray(hit.distance)[sel], t_analytic, atol=5e-3)
    # entering: normal opposes ray
    assert (np.asarray(hit.cos_incidence)[sel] < -0.5).all()
    # normal matches sphere normal
    n_analytic = (pts - CENTER) / r[:, None]
    align = np.sum(np.asarray(hit.normal)[sel] * n_analytic, axis=-1)
    assert align.min() > 0.999


def test_miss_returns_none(sphere_scene):
    start = jnp.zeros((4, 3), jnp.float32)
    d = jnp.asarray(
        [[0, 1, 0], [0, 0, 1], [-1, 0, 0], [1, 0.5, 0.5]], jnp.float32
    )
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    hit = intersect_rays(sphere_scene, start, d)
    assert (np.asarray(hit.what) == WHAT_NONE).all()
    assert (np.asarray(hit.patch) == -1).all()


def test_exit_hit_from_inside(sphere_scene):
    """Restarting at the entry point yields the exit point (slab gate must
    not re-report the same surface)."""
    start, d = _rays(16, seed=3)
    h1 = intersect_rays(sphere_scene, jnp.asarray(start), jnp.asarray(d))
    sel = np.asarray(h1.what) == WHAT_INTERSECT
    s2 = np.asarray(h1.point)[sel]
    d2 = d[sel]
    h2 = intersect_rays(sphere_scene, jnp.asarray(s2), jnp.asarray(d2))
    what2 = np.asarray(h2.what)
    assert (what2 == WHAT_INTERSECT).mean() > 0.9
    pts2 = np.asarray(h2.point)[what2 == WHAT_INTERSECT]
    r2 = np.linalg.norm(pts2 - CENTER, axis=-1)
    np.testing.assert_allclose(r2, 1.0, atol=5e-3)
    # exiting: normal along ray
    assert (np.asarray(h2.cos_incidence)[what2 == WHAT_INTERSECT] > 0.5).all()


def test_ray_collinearity_like_reference():
    """reference/test.cpp:237-319: walk a ray through a solid, collecting
    entry/exit points; all must lie on the original line."""
    mesh = preprocess(make_ellipsoid(15, 7, (1.0, 1.0, 2.0)))
    mesh.translate((5.0, 0.0, 0.0))
    mesh = preprocess(mesh)
    patches = build_from_trimesh(mesh)

    d = np.array([1.0, 0.08, 0.05], np.float32)
    d /= np.linalg.norm(d)
    start = np.zeros(3, np.float32)
    points = []
    s = start.copy()
    for _ in range(2):
        hit = intersect_rays(patches, jnp.asarray(s[None]), jnp.asarray(d[None]))
        if int(hit.what[0]) != WHAT_INTERSECT:
            break
        p = np.asarray(hit.point[0])
        points.append(p)
        s = p
    assert len(points) == 2, "expected entry+exit hits"
    err = geom.ray_average_error_squared(
        jnp.asarray(start), jnp.asarray(d), jnp.asarray(np.stack(points))
    )
    assert float(err) < 1e-8


def test_chunked_equals_unchunked(sphere_scene):
    start, d = _rays(50, seed=7)
    a = intersect_rays(sphere_scene, jnp.asarray(start), jnp.asarray(d))
    b = intersect_rays(
        sphere_scene, jnp.asarray(start), jnp.asarray(d), chunk_size=16
    )
    np.testing.assert_array_equal(np.asarray(a.what), np.asarray(b.what))
    np.testing.assert_allclose(
        np.asarray(a.point), np.asarray(b.point), atol=1e-6
    )


def test_chunked_gradients_equal_unchunked(sphere_scene):
    """The chunked path rematerializes each chunk (jax.checkpoint) so huge
    train steps don't stack per-chunk residuals; remat must not change the
    gradient values, only when they are computed."""
    start, d = _rays(48, seed=11)
    s, dj = jnp.asarray(start), jnp.asarray(d)

    def loss(cp, chunk):
        p = sphere_scene._replace(control_points=cp)
        hit = intersect_rays(p, s, dj, chunk_size=chunk)
        ok = (hit.what == WHAT_INTERSECT).astype(jnp.float32)
        return jnp.sum(ok * hit.distance)

    g_full = jax.grad(lambda cp: loss(cp, 0))(sphere_scene.control_points)
    g_chunk = jax.grad(lambda cp: loss(cp, 16))(sphere_scene.control_points)
    # forward values are bit-identical (test above); gradients differ only
    # by XLA reassociation in the rematerialized backward (~5e-6 absolute
    # on O(1) gradients, measured)
    np.testing.assert_allclose(
        np.asarray(g_full), np.asarray(g_chunk), rtol=1e-3, atol=2e-5
    )


def test_batch_shape_preserved(sphere_scene):
    start, d = _rays(12)
    hit = intersect_rays(
        sphere_scene,
        jnp.asarray(start).reshape(3, 4, 3),
        jnp.asarray(d).reshape(3, 4, 3),
    )
    assert hit.what.shape == (3, 4)
    assert hit.point.shape == (3, 4, 3)


def test_select_candidates_matches_bruteforce_large_P():
    """The O(R*P) select stage (no [P,P] one-hots) vs a NumPy brute-force
    replay of the reference's two-pass retry semantics
    (reference/bezierMesh.cpp:211-225), at a patch count (16384) the old
    one-hot formulation could not materialize."""
    from cbtr_tpu.ops.intersect import select_candidates, WHAT_INTERSECT

    rng = np.random.default_rng(42)
    R, P = 64, 16384
    what_off = rng.integers(0, 5, (R, P)).astype(np.int32)
    in_dom = rng.random((R, P)) < 0.3
    code = what_off | (in_dom.astype(np.int32) << 3)
    dist = rng.uniform(0.1, 100.0, (R, P)).astype(np.float32)
    neighbours = rng.integers(0, P, (P, 3)).astype(np.int32)

    any_hit, win, win_dist = select_candidates(
        jnp.asarray(code), jnp.asarray(dist), jnp.asarray(neighbours)
    )
    any_hit, win, win_dist = map(np.asarray, (any_hit, win, win_dist))

    what_on = np.where(in_dom, what_off, 3)
    for r in range(R):
        best_d, best_p = np.inf, -1
        for p in range(P):
            if what_on[r, p] == WHAT_INTERSECT:
                cand_p, cand_d = p, dist[r, p]
            elif what_on[r, p] < 3:
                q = neighbours[p, what_on[r, p]]
                if what_off[r, q] != WHAT_INTERSECT:
                    continue
                cand_p, cand_d = q, dist[r, q]
            else:
                continue
            if cand_d < best_d:
                best_d, best_p = cand_d, cand_p
        assert bool(any_hit[r]) == (best_p >= 0), f"ray {r} hit mismatch"
        if best_p >= 0:
            assert win_dist[r] == np.float32(best_d), f"ray {r} distance"
            # winner id must be *a* patch at the minimal distance
            assert dist[r, win[r]] == np.float32(best_d), f"ray {r} winner"


def test_dimpled_fixture_exit_hit_found():
    """The reference's unclamped secant estimate (bezierTriangle.cpp:137-152)
    extrapolates outside the bracket on the dimpled fixture's concave waist
    and loses the exit hit; the bracket-clamped estimate
    (config.clamp_secant_estimate, an improvement over the reference)
    recovers it — entry AND exit must both land, collinearly."""
    from cbtr_tpu.mesh.core import make_dimpled_solid

    mesh = preprocess(make_dimpled_solid(21, 15, (1.0, 4.0, 2.0)))
    mesh.translate((5.0, 0.0, 0.0))
    mesh = preprocess(mesh)
    patches = build_from_trimesh(mesh)

    d = np.array([1.0, 0.02, 0.01], np.float32)
    d /= np.linalg.norm(d)
    start = np.zeros(3, np.float32)
    points = []
    s = start.copy()
    for _ in range(2):
        hit = intersect_rays(patches, jnp.asarray(s[None]), jnp.asarray(d[None]))
        if int(hit.what[0]) != WHAT_INTERSECT:
            break
        p = np.asarray(hit.point[0])
        points.append(p)
        s = p
    assert len(points) == 2, "clamped secant must find entry AND exit"
    err = geom.ray_average_error_squared(
        jnp.asarray(start), jnp.asarray(d), jnp.asarray(np.stack(points))
    )
    assert float(err) < 1e-6


def test_dense_retry_path_matches_production_pipeline(sphere_scene):
    """`candidates_with_retry` + `select_best` (the dense/debug formulation
    of the follow-side retry, reference/bezierMesh.cpp:213-217) must produce
    the SAME RayHit as the production sweep->select->recompute pipeline —
    they are two implementations of the trickiest semantics in the op."""
    from cbtr_tpu.ops.intersect import (
        _intersect_chunk,
        candidates_with_retry,
        select_best,
    )

    # rays engineered to include seam/edge hits (off-axis, varied origins)
    rng = np.random.default_rng(21)
    n = 96
    start = rng.normal(size=(n, 3)).astype(np.float32) * 0.2
    target = CENTER + rng.uniform(-1.0, 1.0, (n, 3)).astype(np.float32)
    d = target - start
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    s, d = jnp.asarray(start), jnp.asarray(d.astype(np.float32))

    prod = _intersect_chunk(sphere_scene, s, d, backend="xla")
    dense = select_best(
        *candidates_with_retry(sphere_scene, sphere_scene, 0, s, d)
    )

    np.testing.assert_array_equal(np.asarray(prod.what), np.asarray(dense.what))
    hit = np.asarray(prod.what) == WHAT_INTERSECT
    assert hit.sum() >= 48, "fixture too weak"
    np.testing.assert_array_equal(
        np.asarray(prod.patch)[hit], np.asarray(dense.patch)[hit]
    )
    np.testing.assert_allclose(
        np.asarray(prod.distance)[hit], np.asarray(dense.distance)[hit],
        rtol=1e-6, atol=1e-6,
    )
    for a, b in ((prod.point, dense.point), (prod.normal, dense.normal),
                 (prod.bary, dense.bary)):
        np.testing.assert_allclose(
            np.asarray(a)[hit], np.asarray(b)[hit], rtol=1e-5, atol=1e-5
        )


def test_recompute_acceptance_check_zero(sphere_scene):
    """recompute_winner(with_check=True): on CPU the sweep and the recompute
    share XLA arithmetic, so no sweep-accepted winner may be rejected by the
    recompute (weak spot flagged in round 2: the recomputed `what` used to
    be silently discarded)."""
    from cbtr_tpu.ops.intersect import (
        recompute_winner,
        select_candidates,
        sweep_codes_xla,
    )

    start, d = _rays(128, seed=11)
    s, d = jnp.asarray(start), jnp.asarray(d)
    code, dist = sweep_codes_xla(sphere_scene, s, d)
    any_hit, win, _ = select_candidates(code, dist, sphere_scene.neighbours)
    hit, disagree = recompute_winner(
        sphere_scene, s, d, any_hit, win, with_check=True
    )
    assert int(disagree) == 0
    assert (np.asarray(hit.what) == WHAT_INTERSECT).sum() >= 100


def test_select_formulations_agree(monkeypatch):
    """The one-hot-vote (small P) and column-gather (large P) select
    formulations produce identical winners on random data."""
    import cbtr_tpu.ops.intersect as I

    rng = np.random.default_rng(8)
    R, P = 128, 512
    what_off = rng.integers(0, 5, (R, P)).astype(np.int32)
    in_dom = rng.random((R, P)) < 0.4
    code = jnp.asarray(what_off | (in_dom.astype(np.int32) << 3))
    dist = jnp.asarray(rng.uniform(0.1, 100.0, (R, P)).astype(np.float32))
    neighbours = jnp.asarray(rng.integers(0, P, (P, 3)).astype(np.int32))

    a = I.select_candidates(code, dist, neighbours)  # vote path (P<=2048)
    monkeypatch.setattr(I, "_SELECT_VOTE_MAX_P", 0)   # force gather path
    b = I.select_candidates(code, dist, neighbours)
    np.testing.assert_array_equal(np.asarray(a[0]), np.asarray(b[0]))
    np.testing.assert_array_equal(np.asarray(a[2]), np.asarray(b[2]))
    # winner ids may differ only on exact distance ties; none in this data
    np.testing.assert_array_equal(np.asarray(a[1]), np.asarray(b[1]))
