#!/usr/bin/env python
"""Smoke check of the raytracer's main path on one NVIDIA GPU.

    python chip_smoke.py          # phases (a)-(d) on one card
    python chip_smoke.py --four   # phase (e) only, on four cards

Phases, each of which stops the run with a non-zero exit on failure:

(a) device: JAX must find a GPU (no CPU fallback); the card's name and
    power limit are printed as nvidia-smi reports them.
(b) kernel agreement: the Triton-route winner kernel (ops/pallas_sweep.py),
    compiled for the card, against the XLA reference sweep + select under
    highest matmul precision, at the robot lens 512^2 (262,144 rays x 450
    patches) and split=4 (65,536 rays x 7,200 patches); a 64-ray sample
    against the f64 NumPy ReferenceTracer.
(c) main path: three make_train_step steps at robot 512^2 with the default
    ray chunking; finite losses and gradients; the first step's loss
    against the same step on the XLA reference sweep, also unchunked; and
    that step's loss and control-point gradient against the XLA-backend
    step when both run in one chunk size (see the bars below).
(d) deployment size: a 4096^2 (16.8M-ray) render through
    render_multihost_ortho on a one-card mesh; peak device memory.
(e) four cards (--four): the 4096^2 render and the 4096^2 train step
    sharded over rays on four cards against the same computations on card
    0, the step read FOUR_READINGS times, and a planted fault (one card's
    rays missing) that the gradient bar must catch.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from typing import Any, NamedTuple

import numpy as np

# agreement bars of the kernel against the XLA reference (phase b)
HIT_SET_MIN = 0.999
WINNER_MIN = 0.999
DIST_TOL = 1e-4
# step-level bars (phase c).  The step's loss and gradient follow the f32
# rounding of a few marginal rays (hits accepted a few 1e-3 off the ray
# line), and that rounding changes with how XLA compiles the step around
# the sweep.  On an H100 one such ray, which the f64 tracer says misses the
# lens, carried 77% of the kernel step's gradient at 512^2, and two
# compilations of the XLA step alone gave losses 2.8e-4 apart (PERF.md).
# So the main path's own step (default chunking: one batch at 512^2) is
# held to the unchunked XLA step at MAIN_LOSS_RTOL, its gradient printed;
# and the same step with both sweeps under one chunk size, programs that
# differ only in the winner search, is held to LOSS_RTOL and GRAD_REL_L2.
MAIN_LOSS_RTOL = 2e-3
COMPARE_CHUNK = 65536
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-3
STEP_LR = 1e-4
# four cards against one (phase e): both sides intersect in chunks of
# FOUR_CHUNK rays, so every ray runs the same program and only the order of
# the image and gradient sums differs.  Each gradient coordinate is an f32
# sum of up to 16.8M per-ray terms that largely cancel (|grad| ~1e9 at a
# loss of ~1e5), so reordered sums move it by up to a few 1e-3 relative.
# FOUR_READINGS sound pairs are read, and a planted fault (one card's
# quarter of the rays missing from the sums) must read above the gradient
# bar.  On four H100s the largest of three sound readings was 3.2e-3 and
# the fault read 7.6e-2; the bar sits near their geometric mean (PERF.md).
FOUR_CHUNK = 1 << 20
FOUR_READINGS = 3
IMAGE_REL_L2 = 1e-5
FOUR_LOSS_RTOL = 1e-5
FOUR_GRAD_REL_L2 = 1.5e-2


def log(*args) -> None:
    print(*args, flush=True)


def check(ok: bool, what) -> None:
    """Stop the run with a non-zero exit when a phase's check fails."""
    if not ok:
        raise SystemExit(f"chip_smoke: check failed: {what}")


def phase_device(count: int):
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        sys.exit(f"chip_smoke: no GPU (platform {devices[0].platform!r})")
    if len(devices) < count:
        sys.exit(f"chip_smoke: {count} GPUs needed, {len(devices)} found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    log(smi[0])
    log(f"(a) device: {devices[0].device_kind} x{len(devices)}")
    return devices


def _rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _xla_winners(patches, start, direction, chunk: int):
    """The reference sweep + select, chunked over rays to bound the [R, P]
    working set, under highest matmul precision."""
    import jax

    from cbtr_tpu.ops.intersect import select_candidates, sweep_codes_xla

    def body(sd):
        code, dist = sweep_codes_xla(patches, sd[0], sd[1])
        return select_candidates(code, dist, patches.neighbours)

    R = start.shape[0]
    with jax.default_matmul_precision("highest"):
        out = jax.jit(lambda s, d: jax.lax.map(
            body, (s.reshape(-1, chunk, 3), d.reshape(-1, chunk, 3))
        ))(start, direction)
    return tuple(np.asarray(x).reshape(R) for x in out)


def _tracer_agreement(patches, start, direction, winners, idx) -> int:
    """Rays of the sample idx on which `winners` (any_hit, win, dist) agree
    with the f64 ReferenceTracer."""
    from cbtr_tpu.harness.reference_tracer import ReferenceTracer

    tracer = ReferenceTracer(patches)
    ah, win, dist = winners
    n = 0
    for r in idx:
        ref = tracer.intersect(np.asarray(start[r], np.float64),
                               np.asarray(direction[r], np.float64))
        if ref is None or ref["what"] != 4:
            n += int(not ah[r])
        else:
            n += int(bool(ah[r]) and int(win[r]) == int(ref["patch"])
                     and abs(float(dist[r]) - ref["distance"])
                     <= DIST_TOL * (1 + abs(ref["distance"])))
    return n


def phase_kernel_agreement() -> None:
    import jax
    import jax.numpy as jnp

    from cbtr_tpu.harness.measure import winner_agreement
    from cbtr_tpu.models import robot_lens_scene
    from cbtr_tpu.ops.pallas_sweep import sweep_winner_pallas

    for tag, kw, chunk in (("robot 512^2", {"res": 512}, 16384),
                           ("split=4", {"res": 256, "split": 4}, 4096)):
        scene = robot_lens_scene(**kw)
        s = jnp.asarray(scene.start).reshape(-1, 3)
        d = jnp.asarray(scene.direction).reshape(-1, 3)
        kernel = jax.jit(lambda s_, d_, p=scene.patches:
                         sweep_winner_pallas(p, s_, d_))
        t0 = time.perf_counter()
        compiled = kernel.lower(s, d).compile()
        log(f"(b) {tag}: {s.shape[0]} rays x {scene.patches.num_patches} "
            f"patches, compiled in {time.perf_counter() - t0:.1f} s; "
            f"memory_analysis: {compiled.memory_analysis()}")
        got = tuple(np.asarray(x) for x in compiled(s, d))
        ref = _xla_winners(scene.patches, s, d, chunk)
        agree = winner_agreement(ref, got, DIST_TOL)
        hit = np.nonzero(ref[0] | got[0])[0]
        sample = hit[np.linspace(0, hit.size - 1, 64).astype(int)]
        s_np, d_np = np.asarray(s), np.asarray(d)
        agree["tracer_sample_kernel"] = _tracer_agreement(
            scene.patches, s_np, d_np, got, sample)
        agree["tracer_sample_xla"] = _tracer_agreement(
            scene.patches, s_np, d_np, ref, sample)
        log(f"(b) {tag}: kernel vs XLA {json.dumps(agree)}")
        check(agree["hit_set"] >= HIT_SET_MIN, agree)
        check(agree["winner"] >= WINNER_MIN, agree)
        check(agree["tracer_sample_kernel"] >= agree["tracer_sample_xla"] - 1,
              agree)


def xla_intersect(patches, start, direction):
    """intersect_rays on the XLA reference sweep with no ray chunking (a
    hashable module-level function, so the jitted entry points cache it)."""
    from cbtr_tpu.ops.intersect import intersect_rays

    n = int(np.prod(start.shape[:-1]))
    return intersect_rays(patches, start, direction, chunk_size=n,
                          backend="xla")


def xla_intersect_chunked(patches, start, direction):
    """intersect_rays on the XLA reference sweep in COMPARE_CHUNK-ray
    chunks."""
    from cbtr_tpu.ops.intersect import intersect_rays

    return intersect_rays(patches, start, direction,
                          chunk_size=COMPARE_CHUNK, backend="xla")


def _step_grad(step, params, s, d):
    """(loss, control-point gradient in f64) of one SGD step at STEP_LR."""
    new, loss = step(params, s, d)
    moved = (np.asarray(params.control_points, np.float64)
             - np.asarray(new.control_points, np.float64))
    return float(loss), moved / STEP_LR


def phase_train_steps() -> None:
    import jax
    import jax.numpy as jnp

    from cbtr_tpu.models import robot_lens_scene
    from cbtr_tpu.models.lens_model import make_train_step, params_from_scene

    scene = robot_lens_scene(res=512)
    params = params_from_scene(scene)
    s, d = jnp.asarray(scene.start), jnp.asarray(scene.direction)
    target = jnp.zeros((128, 128), jnp.float32)

    def make(intersect_fn=None, chunk_size=0):
        return make_train_step(scene.patches, scene.screen_plane, target,
                               learning_rate=STEP_LR, chunk_size=chunk_size,
                               intersect_fn=intersect_fn)

    step = make()
    p = params
    for i in range(3):
        t0 = time.perf_counter()
        new, loss = step(p, s, d)
        loss = float(loss)
        dt = time.perf_counter() - t0
        moved = np.asarray(new.control_points) - np.asarray(p.control_points)
        check(np.isfinite(loss) and np.isfinite(moved).all(), (i, loss))
        log(f"(c) step {i}: loss {loss:.9g}  |update_cp| "
            f"{np.linalg.norm(moved):.6g}  {dt:.3f} s")
        p = new

    def compare(tag, kernel_step, xla_step, loss_bar, grad_bar=None):
        loss_k, grad_k = _step_grad(kernel_step, params, s, d)
        with jax.default_matmul_precision("highest"):
            loss_x, grad_x = _step_grad(xla_step, params, s, d)
        loss_rel = abs(loss_k - loss_x) / abs(loss_x)
        grad_rel = _rel_l2(grad_k, grad_x)
        log(f"(c) {tag}: loss {loss_k:.9g} vs {loss_x:.9g} (rel "
            f"{loss_rel:.3g}), grad_cp rel L2 {grad_rel:.3g} (|grad_cp| "
            f"{np.linalg.norm(grad_k):.6g} vs {np.linalg.norm(grad_x):.6g})")
        check(np.isfinite(grad_k).all() and loss_rel <= loss_bar,
              (tag, loss_rel))
        if grad_bar is not None:
            check(grad_rel <= grad_bar, (tag, grad_rel))

    compare("step 0 vs the unchunked XLA-backend step", step,
            make(xla_intersect), MAIN_LOSS_RTOL)
    compare(f"step 0 vs the XLA-backend step, both in {COMPARE_CHUNK}-ray "
            "chunks", make(chunk_size=COMPARE_CHUNK),
            make(xla_intersect_chunked), LOSS_RTOL, GRAD_REL_L2)


def _ortho_4k():
    from cbtr_tpu.models import robot_lens_scene
    from cbtr_tpu.models.scenes import scene_ortho_grid

    return robot_lens_scene(res=1), scene_ortho_grid(4096)


def phase_deployment() -> None:
    import jax

    from cbtr_tpu.parallel.multihost import multihost_mesh, render_multihost_ortho

    scene, grid = _ortho_4k()
    mesh = multihost_mesh(num_devices=1)
    t0 = time.perf_counter()
    img = np.asarray(render_multihost_ortho(
        mesh, scene.patches, scene.refractive_index, grid,
        scene.screen_plane, resolution=1024))
    dt = time.perf_counter() - t0
    peak = jax.devices()[0].memory_stats()["peak_bytes_in_use"]
    log(f"(d) {grid.n_rays} rays -> 1024^2 image: sum {img.sum():.6g}, "
        f"{dt:.1f} s incl. compile, peak_bytes_in_use {peak}")
    check(np.isfinite(img).all() and img.sum() > 0, img.sum())


class _MissingShard(NamedTuple):
    """Planted fault for phase (e): an OrthoGrid whose last of `shards`
    equal index slices is turned away from the lens, as if one card's rays
    were missing from the image and gradient sums."""

    grid: Any
    shards: int

    @property
    def n_rays(self) -> int:
        return self.grid.n_rays

    def rays_at(self, idx):
        import jax.numpy as jnp

        s, d = self.grid.rays_at(idx)
        cut = self.grid.n_rays - self.grid.n_rays // self.shards
        return s, jnp.where((idx >= cut)[:, None], -d, d)


def phase_four_cards() -> None:
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from cbtr_tpu.models.lens_model import params_from_scene
    from cbtr_tpu.parallel.multihost import (
        make_multihost_train_step_ortho,
        render_multihost_ortho,
    )

    scene, grid = _ortho_4k()
    devices = jax.devices()
    one = Mesh(np.asarray(devices[:1]), ("rays",))
    four = Mesh(np.asarray(devices[:4]), ("rays",))

    imgs = {}
    for tag, mesh in (("1 card", one), ("4 cards", four)):
        def render():
            return render_multihost_ortho(
                mesh, scene.patches, scene.refractive_index, grid,
                scene.screen_plane, resolution=1024, chunk_size=FOUR_CHUNK)

        render()
        t0 = time.perf_counter()
        imgs[tag] = np.asarray(render())
        log(f"(e) render {tag}: sum {imgs[tag].sum():.9g}, "
            f"{time.perf_counter() - t0:.3f} s")
    img_rel = _rel_l2(imgs["4 cards"], imgs["1 card"])
    log(f"(e) render 4 cards vs 1: image rel L2 {img_rel:.3g}")
    check(np.isfinite(imgs["4 cards"]).all() and img_rel <= IMAGE_REL_L2,
          img_rel)

    params = params_from_scene(scene)
    target = jnp.zeros((128, 128), jnp.float32)

    def train_step(mesh, rays):
        step = make_multihost_train_step_ortho(
            mesh, scene.patches, scene.screen_plane, target, rays,
            resolution=128, learning_rate=1e-4, chunk_size=FOUR_CHUNK)
        jax.block_until_ready(step(params))

        def run(tag):
            t0 = time.perf_counter()
            _, loss, grads = step(params)
            out = (float(loss), np.asarray(grads.control_points),
                   float(grads.refractive_index))
            log(f"(e) train step {tag}: loss {out[0]:.9g}, |grad_cp| "
                f"{np.linalg.norm(out[1]):.6g}, grad_n {out[2]:.9g}, "
                f"{time.perf_counter() - t0:.3f} s")
            return out

        return run

    def compare(a, b):
        (l1, g1, n1), (l4, g4, n4) = a, b
        return (abs(l4 - l1) / abs(l1), _rel_l2(g4, g1),
                abs(n4 - n1) / max(abs(n1), 1e-30))

    step_one, step_four = train_step(one, grid), train_step(four, grid)
    readings = []
    for k in range(FOUR_READINGS):
        base = step_one(f"1 card #{k}")
        readings.append(compare(base, step_four(f"4 cards #{k}")))
        log(f"(e) reading {k}, 4 cards vs 1: loss rel {readings[-1][0]:.3g}, "
            f"grad_cp rel L2 {readings[-1][1]:.3g}, grad_n rel "
            f"{readings[-1][2]:.3g}")
    worst = np.max(np.asarray(readings), axis=0)
    fault = compare(base, train_step(four, _MissingShard(grid, 4))(
        "4 cards, one card's rays missing"))
    log(f"(e) largest of {FOUR_READINGS} sound readings: loss rel "
        f"{worst[0]:.3g}, grad_cp rel L2 {worst[1]:.3g}, grad_n rel "
        f"{worst[2]:.3g}; planted fault: loss rel {fault[0]:.3g}, grad_cp "
        f"rel L2 {fault[1]:.3g}, grad_n rel {fault[2]:.3g}")
    check(worst[0] <= FOUR_LOSS_RTOL and worst[1] <= FOUR_GRAD_REL_L2
          and worst[2] <= FOUR_GRAD_REL_L2, worst)
    check(fault[1] > FOUR_GRAD_REL_L2, fault)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase (e)")
    args = ap.parse_args()

    from cbtr_tpu.utils import enable_compile_cache

    enable_compile_cache()
    devices = phase_device(4 if args.four else 1)
    if args.four:
        phase_four_cards()
    else:
        phase_kernel_agreement()
        phase_train_steps()
        phase_deployment()
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}))


if __name__ == "__main__":
    main()
