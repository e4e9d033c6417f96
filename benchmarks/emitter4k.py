#!/usr/bin/env python
"""Point-source render at scale: 16.8M emitter rays through the robot lens.

The emitter analogue of render4k.py, and the measurement behind the
DeviceEmitter design (render/emitters.py): at multi-million-ray emitter
renders the host stage of render_emitter_image — NumPy hemisphere sampling,
np.argsort by the belt/patch bin, and a ~200 MB sorted-ray upload — can
become the bottleneck the OrthoGrid work removed from the ortho 4K render.
DeviceEmitter synthesizes the rays pre-sorted on device (index space
partitioned over the bins), so the host stage disappears entirely.

Prints (and with --out writes) both paths timed at the same ray count, plus
one sharded emitter-fit train step (fwd+bwd) and deterministic checksums.
Needs a GPU.

Usage: python benchmarks/emitter4k.py [--out emitter4k.json]
"""
from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4096 * 4096)
    ap.add_argument("--belts", type=int, default=64)
    ap.add_argument("--image-res", type=int, default=256)
    ap.add_argument("--host-path-n", type=int, default=0,
                    help="ray count for the host-path comparison "
                    "(default: same as --n)")
    ap.add_argument("--out", default="")
    args = ap.parse_args()

    sys.path.insert(0, REPO)
    from cbtr_tpu.utils import enable_compile_cache

    enable_compile_cache()
    import jax
    import numpy as np

    if jax.devices()[0].platform != "gpu":
        sys.exit("emitter4k: no GPU found")
    import jax.numpy as jnp

    from cbtr_tpu.models import robot_lens_scene, scenes
    from cbtr_tpu.models.lens_model import params_from_scene
    from cbtr_tpu.parallel.multihost import (
        make_multihost_train_step_emitter,
        multihost_mesh,
        render_multihost_emitter,
    )
    from cbtr_tpu.render.emitters import DeviceEmitter, UniformHemisphere
    from cbtr_tpu.render.render import render_emitter_image

    scene = robot_lens_scene(res=1)  # geometry only
    origin = tuple((np.asarray(scenes.LENS_CENTER)
                    - np.array([3.0, 0, 0], np.float32)).tolist())
    mesh = multihost_mesh()
    em = DeviceEmitter(origin=origin, belts=args.belts, n_rays=args.n, seed=7)

    def checksum(img):
        return hashlib.sha256(np.asarray(img).tobytes()).hexdigest()[:16]

    # ---- device path: synthesis + sort-free, zero host traffic ------------
    # (timed through np.asarray: the checksum needs the bytes anyway)
    def dev_render():
        img = render_multihost_emitter(
            mesh, scene.patches, scene.refractive_index, em,
            scene.screen_plane, resolution=args.image_res,
        )
        return np.asarray(img)

    dev_render()                        # compile + warm
    t0 = time.perf_counter()
    img = dev_render()
    dt_dev = time.perf_counter() - t0
    c1 = checksum(img)
    c2 = checksum(dev_render())

    # ---- host path: sample + argsort + upload per call --------------------
    n_host = args.host_path_n or args.n
    hemi = UniformHemisphere(belts=args.belts, seed=7)

    def host_render():
        img = render_emitter_image(
            scene.patches, scene.refractive_index, hemi, n_host,
            np.asarray(origin, np.float32), scene.screen_plane,
            resolution=args.image_res,
        )
        return np.asarray(img)

    host_render()                       # compile + warm (fresh rays anyway)
    t0 = time.perf_counter()
    img_h = host_render()
    dt_host = time.perf_counter() - t0

    # ---- one sharded emitter-fit train step at scale ----------------------
    params = params_from_scene(scene)
    target = img / jnp.maximum(jnp.max(img), 1.0)
    step = make_multihost_train_step_emitter(
        mesh, scene.patches, scene.screen_plane, target, em,
        resolution=args.image_res, learning_rate=1e-4,
    )
    jax.block_until_ready(step(params))  # compile + warm
    t0 = time.perf_counter()
    _, loss, grads = step(params)
    gn = float(np.linalg.norm(np.asarray(grads.control_points)))
    dt_train = time.perf_counter() - t0
    assert np.isfinite(float(loss)) and np.isfinite(gn) and gn > 0

    flux_dev = float(jnp.sum(img)) / args.n
    flux_host = float(jnp.sum(img_h)) / n_host
    record = {
        "metric": f"{args.n} point-source rays -> {args.image_res}^2 image, "
        "robot lens",
        "rays": args.n,
        "device_path": {
            "wall_s": round(dt_dev, 3),
            "rays_per_s": round(args.n / dt_dev, 1),
            "checksum": c1,
            "deterministic": c1 == c2,
        },
        "host_path": {
            "rays": n_host,
            "wall_s": round(dt_host, 3),
            "rays_per_s": round(n_host / dt_host, 1),
        },
        "device_vs_host_speedup": round(
            (n_host / dt_host and (args.n / dt_dev) / (n_host / dt_host)), 2
        ),
        "flux_per_ray_agreement": round(
            abs(flux_dev - flux_host) / max(flux_dev, flux_host), 4
        ),
        "train_step": {
            "wall_s": round(dt_train, 3),
            "rays_per_s_fwd_bwd": round(args.n / dt_train, 1),
            "loss": float(loss),
            "grad_cp_norm": round(gn, 6),
        },
        "device": jax.devices()[0].device_kind,
        "n_devices": len(jax.devices()),
    }
    # the two paths estimate the same irradiance integral
    assert record["flux_per_ray_agreement"] < 0.02, record
    if args.out:
        with open(args.out, "w") as f:
            json.dump(record, f, indent=1)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
