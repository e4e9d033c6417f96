"""The GPU winner kernel (ops/pallas_sweep.py) in Pallas interpret mode
against the XLA reference sweep + select (`sweep_codes_xla` +
`select_candidates`).

Both compute the same scan+retry winner in f32 with different operation
orders.  The reference algorithm is sensitive at f32 where a candidate sits
on an acceptance or divider threshold (grazing rays, seams of small refined
patches): on the split fixture below, the jitted and the eager run of the
SAME XLA reference agree on 99.7% of hit sets and 99.3% of winners
(harness.measure.winner_agreement: same patch, distance within 1e-4), and
the f64 ReferenceTracer sides with either.  The kernel measured 99.2% and
99.0% there.  So the bar is that floor with a margin: hit sets agree on
>= 99% of rays and winners on >= 98%.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cbtr_tpu.bezier.patches import BezierPatches
from cbtr_tpu.harness.measure import winner_agreement
from cbtr_tpu.models import (
    dimpled_lens_scene,
    ellipsoid_lens_scene,
    robot_lens_scene,
    sphere_lens_scene,
)
from cbtr_tpu.ops import pallas_sweep as PS
from cbtr_tpu.ops.intersect import (
    WHAT_INTERSECT,
    intersect_rays,
    select_candidates,
    sweep_codes_xla,
)

SCENES = {
    "sphere": lambda: sphere_lens_scene(res=32, sectors=9, belts=4),
    "robot": lambda: robot_lens_scene(res=32),
    "ellipsoid": lambda: ellipsoid_lens_scene(res=32, sectors=15, belts=5),
    "dimpled": lambda: dimpled_lens_scene(res=32),
    "refined": lambda: robot_lens_scene(res=32, refine=True),
    "split": lambda: robot_lens_scene(res=32, split=3),
}


def _reference(patches, s, d):
    with jax.default_matmul_precision("highest"):
        code, dist = sweep_codes_xla(patches, s, d)
        return select_candidates(code, dist, patches.neighbours)


def _assert_agree(ref, got, min_hits=16):
    agree = winner_agreement(ref, got)
    assert agree["hits"] >= min_hits, "fixture too weak"
    assert agree["hit_set"] >= 0.99, agree
    assert agree["winner"] >= 0.98, agree


@pytest.mark.parametrize("name", sorted(SCENES))
def test_kernel_matches_xla_select(name):
    scene = SCENES[name]()
    if name == "refined":
        assert scene.patches.num_patches > 450
    if name == "split":
        assert scene.patches.num_patches > 2048
    s = jnp.asarray(scene.start).reshape(-1, 3)
    d = jnp.asarray(scene.direction).reshape(-1, 3)
    got = PS.sweep_winner_pallas(scene.patches, s, d, interpret=True)
    _assert_agree(_reference(scene.patches, s, d), got)


@pytest.fixture(scope="module")
def sphere():
    return sphere_lens_scene(res=16, sectors=9, belts=4)


def _aimed_rays(n, seed):
    rng = np.random.default_rng(seed)
    start = rng.normal(size=(n, 3)).astype(np.float32) * 0.1
    target = rng.normal(size=(n, 3)).astype(np.float32) * 0.4
    target[:, 0] += 5.0   # every scene's lens sits at (5, 0, 0)
    d = target - start
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return jnp.asarray(start), jnp.asarray(d)


def test_unaligned_ray_count_and_misses(sphere):
    """200 rays (not a TILE_R multiple): 128 aimed at the lens, 72 heading
    -x that miss everything and must come back as misses."""
    s_hit, d_hit = _aimed_rays(128, seed=5)
    s = jnp.concatenate([s_hit, jnp.zeros((72, 3), jnp.float32)])
    d = jnp.concatenate(
        [d_hit, jnp.tile(jnp.array([[-1.0, 0.0, 0.0]]), (72, 1))])
    got = PS.sweep_winner_pallas(sphere.patches, s, d, interpret=True)
    assert got[0].shape == (200,) and got[1].shape == (200,)
    assert not np.asarray(got[0])[128:].any()
    _assert_agree(_reference(sphere.patches, s, d), got, min_hits=100)


def _doubled(patches: BezierPatches) -> BezierPatches:
    """The patch table followed by an exact copy of itself (copy q + P has
    the copied neighbour ids + P): every hit is an exact distance tie
    between patch p and p + P."""
    P = patches.num_patches
    return BezierPatches(*(
        jnp.concatenate([x, x + P if name == "neighbours" else x])
        for name, x in zip(BezierPatches._fields, patches)
    ))


def test_equal_distance_goes_to_lowest_id(sphere):
    """Blocks visited in DESCENDING order (the copy first): the winner must
    still be the lower id of each tied pair, as in select_candidates."""
    doubled = _doubled(sphere.patches)
    P = sphere.patches.num_patches
    s, d = _aimed_rays(128, seed=9)
    rays_t = PS.pack_rays(s, d)
    tab, nbr = PS.pack_tables(doubled)
    B = tab.shape[1] // PS.BLOCK_P
    counts = jnp.full((1,), B, jnp.int32)
    lists = jnp.arange(B - 1, -1, -1, dtype=jnp.int32)[None, :]
    dist, win = PS._winner_call(counts, lists, rays_t, tab, nbr,
                                interpret=True)
    hit = np.asarray(dist) < 1e30
    assert hit.sum() >= 100
    assert (np.asarray(win)[hit] < P).all()
    _, win_ref, _ = _reference(doubled, s, d)
    np.testing.assert_array_equal(np.asarray(win)[hit],
                                  np.asarray(win_ref)[hit])


def test_culled_lists_match_all_blocks():
    """The block cull may only skip work: every tile listing every block
    gives bit-identical winners and distances."""
    robot = robot_lens_scene(res=16)
    s = jnp.asarray(robot.start).reshape(-1, 3)
    d = jnp.asarray(robot.direction).reshape(-1, 3)
    rays_t = PS.pack_rays(s, d)
    tab, nbr = PS.pack_tables(robot.patches)
    counts, lists = PS.tile_block_lists(robot.patches, rays_t)
    T, B = lists.shape
    assert int(jnp.sum(counts)) < T * B, "cull skipped nothing"
    culled = PS._winner_call(counts, lists, rays_t, tab, nbr, interpret=True)
    full = PS._winner_call(
        jnp.full((T,), B, jnp.int32),
        jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32), (T, B)),
        rays_t, tab, nbr, interpret=True,
    )
    assert int(jnp.sum(culled[0] < 1e30)) >= 32, "fixture too weak"
    np.testing.assert_array_equal(np.asarray(culled[0]), np.asarray(full[0]))
    np.testing.assert_array_equal(np.asarray(culled[1]), np.asarray(full[1]))


def test_intersect_rays_kernel_forward_matches_xla(sphere):
    s, d = _aimed_rays(192, seed=13)
    a = intersect_rays(sphere.patches, s, d, backend="xla")
    b = intersect_rays(sphere.patches, s, d, backend="pallas", interpret=True)
    hit_a = np.asarray(a.what) == WHAT_INTERSECT
    hit_b = np.asarray(b.what) == WHAT_INTERSECT
    assert hit_a.sum() >= 150
    np.testing.assert_array_equal(hit_a, hit_b)
    np.testing.assert_array_equal(np.asarray(a.patch), np.asarray(b.patch))
    for x, y in ((a.distance, b.distance), (a.point, b.point),
                 (a.normal, b.normal)):
        np.testing.assert_allclose(np.asarray(x)[hit_a], np.asarray(y)[hit_a],
                                   rtol=1e-5, atol=1e-5)


def test_intersect_rays_kernel_gradients_match_xla(sphere):
    """Gradients flow only through the winner recompute, so the same
    winners give the same control-point and ray gradients (the loss counts
    the rays whose winners the two paths agree on)."""
    s, d = _aimed_rays(192, seed=17)
    a = intersect_rays(sphere.patches, s, d, backend="xla")
    b = intersect_rays(sphere.patches, s, d, backend="pallas", interpret=True)
    ok = (np.asarray(a.what) == WHAT_INTERSECT) & (
        np.asarray(a.patch) == np.asarray(b.patch))
    assert ok.sum() >= 150
    ok = jnp.asarray(ok)

    def loss(cp, start, backend, interpret):
        p = sphere.patches._replace(control_points=cp)
        hit = intersect_rays(p, start, d, backend=backend,
                             interpret=interpret)
        return jnp.sum(jnp.where(ok[:, None], hit.point * hit.normal, 0.0))

    grad = jax.grad(loss, argnums=(0, 1))
    ga = grad(sphere.patches.control_points, s, "xla", False)
    gb = grad(sphere.patches.control_points, s, "pallas", True)
    for x, y in zip(ga, gb):
        assert float(jnp.abs(x).max()) > 0
        np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                   rtol=1e-4, atol=1e-5)


def test_kernel_lowers_for_the_gpu(sphere):
    """The kernel lowers to the Triton dialect for CUDA (the route named by
    its compiler params); compiling the PTX needs the card."""
    s, d = _aimed_rays(256, seed=1)
    lowered = jax.jit(
        lambda s_, d_: PS.sweep_winner_pallas(sphere.patches, s_, d_)
    ).trace(s, d).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert "num_warps = %d" % PS.NUM_WARPS in text
