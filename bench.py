#!/usr/bin/env python
"""Headline benchmark: rays/s of the robot.stl lens train step on one GPU.

Prints ONE JSON line whose required keys are {"metric", "value", "unit",
"vs_baseline"}; the other keys carry:

* device — platform, device_kind, count, and nvidia-smi's name and power
  limit (a card below its maximum power runs slower under load);
* kernel_xla_agreement — the Triton-route winner kernel against the XLA
  reference sweep + select (highest matmul precision) at every intersect
  shape below: hit-set and winner agreement (harness.measure.
  winner_agreement), and recompute_reject_count;
* sweep_ab — the same step and intersect with the sweep on the XLA path
  (`sweep_codes_xla` + `select_candidates`), the alternative
  ops.intersect.sweep_backend decides against;
* breakdown_ms — list build + kernel, XLA sweep, XLA select and the full
  intersect at 65,536 rays;
* sweep_roofline — the kernel's f32 operations per second (the per-pair
  model times the pairs of the blocks the cull listed; pairs the per-patch
  sphere gate then skips count as done, retry evaluations are not
  counted), as a share of the card's published f32 peak (PEAKS);
* robot_1024 / ellipsoid_512 / large-P intersect rows / emitter fit
  (full preset).

vs_baseline compares against the reference-semantics tracer: a faithful
pure-NumPy single-ray implementation of the C++ reference's brute-force
loop, timed forward-only on a small ray sample and extrapolated; the GPU
number additionally includes the full backward pass.

A run that finds no GPU fails; it never falls back to the CPU.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np

# Published dense peaks per device_kind, at the card's full power limit:
# NVIDIA H100 data sheet, SXM part (f32 outside the tensor cores; TF32 and
# bf16 on the tensor cores; HBM3 bandwidth).
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "f32_tflops": 67.0,
        "tf32_tflops": 495.0,
        "bf16_tflops": 989.0,
        "hbm_tb_per_s": 3.35,
    },
}

# the sweep's per-(ray, patch) f32 operation model: ~1300 for the 4-iteration
# Newton body, ~400 for the bracket, secant and acceptance
FLOPS_PER_PAIR = 1700


def device_peaks(device_kind: str) -> dict:
    """Published peaks of `device_kind`; a device not in PEAKS is an error."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}") from None


def _check(ok: bool, what) -> None:
    if not ok:
        raise SystemExit(f"bench.py: check failed: {what}")


def _timeit(fn, inner, *args, reps: int = 5):
    """Median of `reps` timing windows of `inner` calls each, after one
    warm-up call.  Returns (median_seconds, {median_ms, min_ms, max_ms, n})."""
    import jax

    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            out = fn(*args)
        jax.block_until_ready(out)
        ts.append((time.perf_counter() - t0) / inner)
    med = float(np.median(ts))
    return med, {"median_ms": med * 1e3, "min_ms": min(ts) * 1e3,
                 "max_ms": max(ts) * 1e3, "n": reps}


def _nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def xla_intersect(patches, start, direction):
    """intersect_rays on the XLA reference sweep (module level, so jitted
    entry points that take it as a static argument cache it)."""
    from cbtr_tpu.ops.intersect import intersect_rays

    return intersect_rays(patches, start, direction, backend="xla")


def _agreement(patches, start, direction, chunk: int) -> dict:
    """Kernel winners against the XLA reference (chunked over rays, highest
    matmul precision), plus the recompute's rejections of kernel winners."""
    import jax

    from cbtr_tpu.harness.measure import winner_agreement
    from cbtr_tpu.ops.intersect import (
        recompute_winner,
        select_candidates,
        sweep_codes_xla,
    )
    from cbtr_tpu.ops.pallas_sweep import sweep_winner_pallas

    R = start.shape[0] - start.shape[0] % chunk
    s, d = start[:R], direction[:R]

    def ref_body(sd):
        code, dist = sweep_codes_xla(patches, sd[0], sd[1])
        return select_candidates(code, dist, patches.neighbours)

    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda s_, d_: jax.lax.map(
            ref_body, (s_.reshape(-1, chunk, 3), d_.reshape(-1, chunk, 3))
        ))(s, d)
        ref = tuple(np.asarray(x).reshape(R) for x in ref)
        got = jax.jit(lambda s_, d_: sweep_winner_pallas(patches, s_, d_))(s, d)
        _, n_reject = jax.jit(lambda s_, d_, a, w: recompute_winner(
            patches, s_, d_, a, w, with_check=True))(s, d, got[0], got[1])
    row = winner_agreement(ref, got)
    row["recompute_reject_count"] = int(n_reject)
    return row


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--preset", choices=["smoke", "full"], default="full")
    parser.add_argument("--res", type=int, default=0, help="ray grid resolution")
    parser.add_argument("--baseline-rays", type=int, default=0)
    parser.add_argument("--trace", default="", help="save a profiler trace here")
    parser.add_argument("--big-res", type=int, default=1024,
                        help="robot config-3 resolution (full preset)")
    parser.add_argument("--ell-res", type=int, default=512,
                        help="ellipsoid config-2 resolution (full preset)")
    args = parser.parse_args()

    smoke = args.preset == "smoke"
    res = args.res or (64 if smoke else 512)
    baseline_rays = args.baseline_rays or (8 if smoke else 64)
    reps = 2 if smoke else 5

    from cbtr_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py: no GPU (platform {dev.platform!r})")
    peaks = device_peaks(dev.device_kind)

    from cbtr_tpu.models import robot_lens_scene
    from cbtr_tpu.models.lens_model import lens_loss, params_from_scene
    from cbtr_tpu.ops.intersect import (
        intersect_rays,
        select_candidates,
        sweep_codes_xla,
    )
    from cbtr_tpu.ops.pallas_sweep import (
        BLOCK_P,
        TILE_R,
        pack_rays,
        sweep_winner_pallas,
        tile_block_lists,
    )

    extras = {"device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()), "nvidia_smi": _nvidia_smi(),
    }}

    def train_step(scene, intersect_fn=None):
        def loss_fn(p, s, d):
            return lens_loss(
                p, scene.patches, s, d, scene.screen_plane,
                jnp.zeros((128, 128), jnp.float32), resolution=128,
                intersect_fn=intersect_fn,
            )
        return jax.jit(jax.value_and_grad(loss_fn))

    scene = robot_lens_scene(res=res)
    params = params_from_scene(scene)
    start = jnp.asarray(scene.start)
    direction = jnp.asarray(scene.direction)
    n_rays = int(start.shape[0])
    P = scene.patches.num_patches

    step = train_step(scene)
    loss, grads = step(params, start, direction)
    _check(np.isfinite(float(loss)), float(loss))
    if args.trace:
        with jax.profiler.trace(args.trace):
            jax.block_until_ready(step(params, start, direction))
    t_step, st_step = _timeit(step, 2 if smoke else 4, params, start,
                              direction, reps=reps)
    rays_per_s = n_rays / t_step
    extras["value_stats"] = {
        "median": rays_per_s, "min": n_rays / (st_step["max_ms"] * 1e-3),
        "max": n_rays / (st_step["min_ms"] * 1e-3), "n": st_step["n"],
    }
    _, st_xla = _timeit(train_step(scene, xla_intersect), 2 if smoke else 4,
                        params, start, direction, reps=reps)
    extras["sweep_ab"] = {f"train_{res}": {"kernel_ms": st_step,
                                           "xla_ms": st_xla}}

    # ---- agreement + stage breakdown at up to 65,536 rays ------------------
    R = min(n_rays, 65536)
    sb, db = start.reshape(-1, 3)[:R], direction.reshape(-1, 3)[:R]
    extras["kernel_xla_agreement"] = {
        f"robot_{res}": _agreement(scene.patches, start, direction,
                                   min(n_rays, 16384))}

    kernel = jax.jit(lambda s, d: sweep_winner_pallas(scene.patches, s, d))
    lists = jax.jit(lambda s, d: tile_block_lists(scene.patches,
                                                   pack_rays(s, d)))
    sweep_x = jax.jit(lambda s, d: sweep_codes_xla(scene.patches, s, d))
    select_x = jax.jit(lambda c, di: select_candidates(
        c, di, scene.patches.neighbours))
    full = jax.jit(lambda s, d: intersect_rays(scene.patches, s, d))
    t_kernel, st_kernel = _timeit(kernel, 8, sb, db, reps=reps)
    _, st_lists = _timeit(lists, 8, sb, db, reps=reps)
    _, st_sweep_x = _timeit(sweep_x, 8, sb, db, reps=reps)
    _, st_select_x = _timeit(select_x, 8, *sweep_x(sb, db), reps=reps)
    _, st_full = _timeit(full, 8, sb, db, reps=reps)
    counts, _ = lists(sb, db)
    n_blocks = -(-P // BLOCK_P)
    extras["breakdown_ms"] = {
        "rays": R, "patches": P,
        "cull_lists": st_lists["median_ms"],
        "kernel_incl_lists": st_kernel["median_ms"],
        "xla_sweep": st_sweep_x["median_ms"],
        "xla_select": st_select_x["median_ms"],
        "full_intersect": st_full["median_ms"],
        "listed_block_fraction": float(jnp.sum(counts))
        / ((R // TILE_R) * n_blocks),
    }
    extras["breakdown_stats"] = {
        "cull_lists": st_lists, "kernel_incl_lists": st_kernel,
        "xla_sweep": st_sweep_x, "xla_select": st_select_x,
        "full_intersect": st_full,
    }
    listed_pairs = int(jnp.sum(counts)) * BLOCK_P * TILE_R
    sweep_flops = FLOPS_PER_PAIR * listed_pairs / t_kernel
    extras["sweep_roofline"] = {
        "listed_pairs": listed_pairs,
        "model_gflops_per_s": sweep_flops / 1e9,
        "f32_peak_tflops": peaks["f32_tflops"],
        "share_of_f32_peak": sweep_flops / (peaks["f32_tflops"] * 1e12),
    }

    # ---- BASELINE configs 2 and 3, large-P intersect, emitter fit ---------
    if not smoke:
        from cbtr_tpu.models import ellipsoid_lens_scene

        for tag, scn, inner in (
            (f"robot_{args.big_res}", robot_lens_scene(res=args.big_res), 2),
            (f"ellipsoid_{args.ell_res}",
             ellipsoid_lens_scene(res=args.ell_res, sectors=15, belts=5), 4),
        ):
            sc_s, sc_d = jnp.asarray(scn.start), jnp.asarray(scn.direction)
            t, st = _timeit(train_step(scn), inner, params_from_scene(scn),
                            sc_s, sc_d, reps=reps)
            extras[tag] = {"rays": int(sc_s.shape[0]),
                           "patches": int(scn.patches.num_patches),
                           "rays_per_s": sc_s.shape[0] / t, "stats_ms": st}
            if tag.startswith("robot"):
                _, st_x = _timeit(train_step(scn, xla_intersect), inner,
                                  params_from_scene(scn), sc_s, sc_d,
                                  reps=reps)
                extras["sweep_ab"][f"train_{args.big_res}"] = {
                    "kernel_ms": st, "xla_ms": st_x}

        from cbtr_tpu import native as _native

        for label, kw in (("robot_refined", {"refine": True}),
                          ("robot_split4", {"split": 4}),
                          ("robot_split6", {"split": 6})):
            t0 = time.perf_counter()
            scn = robot_lens_scene(res=256, **kw)
            build_s = time.perf_counter() - t0
            sl = jnp.asarray(scn.start).reshape(-1, 3)
            dl = jnp.asarray(scn.direction).reshape(-1, 3)
            big = jax.jit(lambda s, d, p=scn.patches: intersect_rays(p, s, d))
            t, st = _timeit(big, 4, sl, dl, reps=reps)
            row = {"rays": int(sl.shape[0]),
                   "patches": int(scn.patches.num_patches),
                   "scene_build_s": build_s,
                   "native_runtime": _native.available(),
                   "intersect_rays_per_s": sl.shape[0] / t, "stats_ms": st}
            if label == "robot_split4":
                xl = jax.jit(lambda s, d, p=scn.patches: xla_intersect(p, s, d))
                _, row["xla_stats_ms"] = _timeit(xl, 4, sl, dl, reps=reps)
                extras["sweep_ab"]["intersect_split4"] = {
                    "kernel_ms": st, "xla_ms": row["xla_stats_ms"]}
            extras["kernel_xla_agreement"][label] = _agreement(
                scn.patches, sl, dl, 2048 if label == "robot_split6" else 4096)
            extras[label] = row

        # emitter-illumination fit: one train step on point-source rays,
        # bin-sorted (the reference's car-lamp use case,
        # reference/README.md:159-165)
        from cbtr_tpu.models.fit import emitter_rays

        s_ef, d_ef = emitter_rays(R, belts=16, seed=1)
        loss_ef, grads_ef = step(params, s_ef, d_ef)
        t_ef, st_ef = _timeit(step, 4, params, s_ef, d_ef, reps=reps)
        gn = float(jnp.linalg.norm(grads_ef.control_points))
        _check(np.isfinite(float(loss_ef)) and np.isfinite(gn) and gn > 0,
               (float(loss_ef), gn))
        extras["emitter_fit"] = {
            "rays": R, "rays_per_s_fwd_bwd": R / t_ef, "stats_ms": st_ef,
            "loss": float(loss_ef), "grad_cp_norm": gn,
        }

    for label, row in extras["kernel_xla_agreement"].items():
        _check(row["hit_set"] >= 0.999 and row["winner"] >= 0.999
               and row["recompute_reject_count"] <= max(1, row["rays"] // 1000),
               (label, row))

    # ---- reference-semantics NumPy baseline (forward only, extrapolated) ----
    from cbtr_tpu.harness.reference_tracer import ReferenceTracer

    tracer = ReferenceTracer(scene.patches)
    s_np = np.asarray(scene.start)[:baseline_rays].astype(np.float64)
    d_np = np.asarray(scene.direction)[:baseline_rays].astype(np.float64)
    t0 = time.perf_counter()
    for i in range(baseline_rays):
        tracer.refract(s_np[i], d_np[i], scene.refractive_index, 1)
    base_dt = time.perf_counter() - t0
    base_rays_per_s = baseline_rays / base_dt if base_dt > 0 else 1.0

    print(json.dumps({
        "metric": "rays/s fwd+bwd, robot.stl lens "
        f"({res}x{res} rays, {P} patches), one {dev.device_kind}",
        "value": rays_per_s,
        "unit": "rays/s",
        "vs_baseline": rays_per_s / base_rays_per_s,
        **extras,
    }))


if __name__ == "__main__":
    main()
