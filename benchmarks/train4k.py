#!/usr/bin/env python
"""Config-5's TRAINING half at scale: a 4K sharded train step.

render4k.py is forward-only; this runs ONE full fwd+bwd SGD step at
4096x4096 rays (16.8M) through `make_multihost_train_step_ortho` on every
GPU of this host — rays synthesized on device, intersect chunked to the
device memory, gradients psum-reduced — and records wall time, rays/s, and
a deterministic checksum of (loss, control-point grads, refractive-index
grad).

Two halves, like render4k.py:
* --gpu: the 4K step on the GPUs, run twice for determinism (with --out,
  also written to that file).
* --procs 2: the identical ortho train-step code across 2 real
  jax.distributed CPU processes (JAX_PLATFORMS=cpu) at reduced resolution,
  asserting bit-identical post-step params (via multiprocess_render.py
  --train-ortho).

Usage:
  python benchmarks/train4k.py --gpu [--out train4k.json]
  python benchmarks/train4k.py --procs 2 --res 64
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_gpu(out: str, res: int, image_res: int) -> None:
    sys.path.insert(0, REPO)
    from cbtr_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax
    import numpy as np

    if jax.devices()[0].platform != "gpu":
        sys.exit("train4k --gpu: no GPU found")
    import jax.numpy as jnp

    from cbtr_tpu.models import robot_lens_scene
    from cbtr_tpu.models.lens_model import params_from_scene
    from cbtr_tpu.models.scenes import scene_ortho_grid
    from cbtr_tpu.parallel.multihost import (
        make_multihost_train_step_ortho,
        multihost_mesh,
    )

    scene = robot_lens_scene(res=1)  # geometry only; rays synthesized on device
    grid = scene_ortho_grid(res)
    mesh = multihost_mesh()
    params = params_from_scene(scene)
    target = jnp.zeros((image_res, image_res), jnp.float32)

    step = make_multihost_train_step_ortho(
        mesh, scene.patches, scene.screen_plane, target, grid,
        resolution=image_res, learning_rate=1e-4,
    )

    def checksum(loss, grads):
        h = hashlib.sha256()
        h.update(np.float32(loss).tobytes())
        h.update(np.asarray(grads.control_points).tobytes())
        h.update(np.asarray(grads.refractive_index).tobytes())
        return h.hexdigest()[:16]

    new, loss, grads = step(params)       # compile + warm
    jax.block_until_ready((new, loss, grads))
    c1 = checksum(loss, grads)

    t0 = time.perf_counter()
    new2, loss2, grads2 = step(params)
    jax.block_until_ready((new2, loss2, grads2))
    dt = time.perf_counter() - t0
    c2 = checksum(loss2, grads2)

    gnorm = float(np.linalg.norm(np.asarray(grads.control_points)))
    record = {
        "metric": f"sharded {res}x{res} robot TRAIN step (fwd+bwd) -> "
        f"{image_res}^2 target",
        "rays": grid.n_rays,
        "wall_s": round(dt, 3),
        "rays_per_s_fwd_bwd": round(grid.n_rays / dt, 1),
        "loss": float(loss),
        "grad_cp_norm": gnorm,
        "grad_n_refr": float(np.asarray(grads.refractive_index)),
        "loss_grads_checksum": c1,
        "deterministic": c1 == c2,
        "device": jax.devices()[0].device_kind,
        "n_devices": len(jax.devices()),
    }
    assert np.isfinite(float(loss)) and np.isfinite(gnorm) and gnorm > 0
    if out:
        with open(out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record))


def run_procs(nproc: int, res: int) -> None:
    out = "/tmp/cbtr_train4k_mp"
    for i in range(nproc):
        f = f"{out}.proc{i}.npz"
        if os.path.exists(f):
            os.remove(f)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    rc = subprocess.call(
        [sys.executable,
         os.path.join(REPO, "benchmarks/multiprocess_render.py"),
         "--procs", str(nproc), "--out", out, "--res", str(res),
         "--train-ortho"],
        cwd=REPO, env=env,
    )
    if rc:
        sys.exit(rc)
    import numpy as np

    runs = []
    for i in range(nproc):
        with np.load(f"{out}.proc{i}.npz") as d:
            runs.append((d["cp"], d["n_refr"], float(d["loss1"]),
                         float(d["loss2"])))
    for i in range(1, nproc):
        np.testing.assert_array_equal(runs[0][0], runs[i][0])
        np.testing.assert_array_equal(runs[0][1], runs[i][1])
        assert runs[0][2] == runs[i][2] and runs[0][3] == runs[i][3]
    print(f"{nproc}-process {res}x{res} ortho train step: bit-identical "
          f"post-step params, loss {runs[0][2]:.8f} -> {runs[0][3]:.8f}")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--gpu", action="store_true")
    ap.add_argument("--procs", type=int, default=0)
    ap.add_argument("--res", type=int, default=4096)
    ap.add_argument("--image-res", type=int, default=128)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if args.gpu:
        run_gpu(args.out, args.res, args.image_res)
    if args.procs:
        run_procs(args.procs, min(args.res, 64))


if __name__ == "__main__":
    main()
