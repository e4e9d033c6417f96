#!/usr/bin/env python
"""Measure the per-patch sphere inflation the cull ACTUALLY needs.

patch_spheres (ops/pallas_sweep.py) inflates every control-net sphere by a
blanket 25% so gate-OFF follow-side candidates — which converge slightly
outside the patch domain — stay inside the cull bound.  This script
replaces that guess with a measurement (round-5 verdict ask #1): for every
(ray, patch) candidate the select stage can consume, i.e.

  * retry targets / direct hits:   what_off == cIntersect
  * voters:                        in_dom and what_off == cFollowSide_s

it computes the candidate point's distance from the control-net center and
reports  max over candidates of (|f - c| + max_ray_dist) / r_hull  — the
smallest per-mesh multiplicative inflation that provably keeps every such
candidate's RAY inside the sphere (acceptance requires the ray to pass
within max_intersection_distance_from_ray = 0.01 of f, so a sphere
containing ball(f, 0.01) is hit by every accepting ray).

Runs the no-cull XLA sweep (patch_candidates, limit_domain=False) on every
fixture family at several ray sets, CPU-friendly via ray chunking.
"""
from __future__ import annotations

import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def measure(scene, start, direction, chunk=2048):
    import jax
    import jax.numpy as jnp

    from cbtr_tpu.config import DEFAULT as CFG
    from cbtr_tpu.ops.intersect import (
        WHAT_INTERSECT,
        WHAT_NONE,
        patch_candidates,
    )

    patches = scene.patches
    cp = np.asarray(patches.control_points)          # [P,10,3]
    center_np = cp.mean(axis=1)
    r_hull_np = np.linalg.norm(cp - center_np[:, None], axis=-1).max(axis=-1)
    center = jnp.asarray(center_np)
    r_hull = jnp.asarray(np.maximum(r_hull_np, 1e-12))
    s_all = np.asarray(start, np.float32).reshape(-1, 3)
    d_all = np.asarray(direction, np.float32).reshape(-1, 3)

    from cbtr_tpu.ops.intersect import select_candidates

    @jax.jit
    def chunk_stats(s, d):
        what, dist, pt, n, b, cos = patch_candidates(
            patches, s[:, None, :], d[:, None, :], False
        )
        in_dom = jnp.all((b >= 0.0) & (b <= 1.0), axis=-1)
        hit_off = what == WHAT_INTERSECT
        voter = in_dom & (what < WHAT_NONE)
        keep = hit_off | voter
        off = jnp.linalg.norm(pt - center[None], axis=-1)  # [R,P]
        need = (off + CFG.max_intersection_distance_from_ray) / r_hull[None]
        w = jnp.max(jnp.where(keep, need, 0.0))
        wv = jnp.max(jnp.where(voter, need, 0.0))
        # the empirically decisive bound: inflation needed to keep every
        # ACTUAL winner (min-distance survivor of the full select)
        code = what | (in_dom.astype(jnp.int32) << 3)
        any_hit, win, _ = select_candidates(code, dist, patches.neighbours)
        win_need = jnp.take_along_axis(need, win[:, None].astype(jnp.int32),
                                       axis=1)[:, 0]
        ww = jnp.max(jnp.where(any_hit, win_need, 0.0))
        # ...and the TRUE per-patch-sphere requirement: the cull passes iff
        # the RAY hits the sphere, so the needed radius is the ray line's
        # distance from the winner's center (not the hit point's)
        cw = jnp.take(center, win, axis=0)                 # [R,3]
        rel = cw - s
        t_ca = jnp.sum(rel * d, axis=-1)
        rel2 = jnp.sum(rel * rel, axis=-1)
        d_perp2 = jnp.where(t_ca >= 0.0,
                            jnp.maximum(rel2 - t_ca * t_ca, 0.0), rel2)
        ray_need = jnp.sqrt(d_perp2) / jnp.take(r_hull, win, axis=0)
        wr = jnp.max(jnp.where(any_hit, ray_need, 0.0))
        return w, wv, ww, wr, jnp.sum(keep)

    worst = worst_votes = worst_win = worst_ray = 0.0
    n_cand = 0
    pad = (-s_all.shape[0]) % chunk
    if pad:
        s_all = np.concatenate([s_all, np.zeros((pad, 3), np.float32)])
        filler = np.tile(np.array([-1.0, 0, 0], np.float32), (pad, 1))
        d_all = np.concatenate([d_all, filler])  # -x rays: miss everything
    for c0 in range(0, s_all.shape[0], chunk):
        w, wv, ww, wr, n = chunk_stats(jnp.asarray(s_all[c0:c0 + chunk]),
                                       jnp.asarray(d_all[c0:c0 + chunk]))
        worst = max(worst, float(w))
        worst_votes = max(worst_votes, float(wv))
        worst_win = max(worst_win, float(ww))
        worst_ray = max(worst_ray, float(wr))
        n_cand += int(n)
    return worst, worst_votes, worst_win, worst_ray, n_cand


def main() -> None:
    from cbtr_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax.numpy as jnp

    from cbtr_tpu.models import (
        dimpled_lens_scene,
        ellipsoid_lens_scene,
        robot_lens_scene,
        sphere_lens_scene,
    )
    from cbtr_tpu.models.fit import emitter_rays

    out = {}
    fixtures = [
        ("sphere", sphere_lens_scene(res=64)),
        ("ellipsoid", ellipsoid_lens_scene(res=64)),
        ("dimpled", dimpled_lens_scene(res=64)),
        ("robot", robot_lens_scene(res=64)),
        ("robot_refined", robot_lens_scene(res=48, refine=True)),
        ("robot_split4", robot_lens_scene(res=32, split=4)),
    ]
    for name, scn in fixtures:
        rows = {}
        w, wv, ww, wr, n = measure(scn, scn.start, scn.direction)
        rows["ortho"] = {"need": round(w, 4), "votes": round(wv, 4),
                         "winners": round(ww, 4),
                         "winners_ray": round(wr, 4), "candidates": n}
        es, ed = emitter_rays(4096, belts=16, seed=1)
        w, wv, ww, wr, n = measure(scn, es, ed)
        rows["emitter"] = {"need": round(w, 4), "votes": round(wv, 4),
                           "winners": round(ww, 4),
                           "winners_ray": round(wr, 4), "candidates": n}
        out[name] = rows
        print(name, json.dumps(rows), flush=True)
    overall = max(r["need"] for rows in out.values() for r in rows.values())
    decisive = max(r["winners_ray"]
                   for rows in out.values() for r in rows.values())
    print("RESULT", json.dumps({
        "max_inflation_needed_all_candidates": round(overall, 4),
        "max_winner_ray_sphere_requirement": round(decisive, 4),
    }))


if __name__ == "__main__":
    main()
