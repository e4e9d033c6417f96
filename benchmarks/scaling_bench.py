#!/usr/bin/env python
"""Ray-sharded scaling benchmark: rays/s (fwd+bwd train step) at 1..N devices.

Measures the data-parallel scaling the north star demands (>=90% efficiency
from 1 device to N) by jitting the full train step over meshes of growing
device count and timing steady-state steps.  The devices are the GPUs of
this host, or virtual CPU devices
(XLA_FLAGS=--xla_force_host_platform_device_count) for a dry run; the same
harness runs unchanged where `jax.devices()` spans hosts.

Prints (and with --out writes) a JSON artifact: per-device-count rays/s and
efficiency vs 1 device.

Usage: python benchmarks/scaling_bench.py [--res 256] [--iters 5]
       [--out scaling.json] [--devices 1,2,4,8]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=256)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--devices", default="1,2,4,8")
    ap.add_argument("--out", default="")
    ap.add_argument("--cpu", action="store_true",
                    help="force 8 virtual CPU devices")
    args = ap.parse_args()
    counts = [int(c) for c in args.devices.split(",")]

    if args.cpu or os.environ.get("JAX_PLATFORMS") == "cpu":
        flags = os.environ.get("XLA_FLAGS", "")
        if "xla_force_host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + f" --xla_force_host_platform_device_count={max(counts)}"
            ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
    else:
        import jax

    sys.path.insert(0, REPO)
    import numpy as np
    import jax.numpy as jnp

    from cbtr_tpu.models import sphere_lens_scene
    from cbtr_tpu.models.lens_model import params_from_scene
    from cbtr_tpu.parallel.multihost import (
        make_multihost_train_step,
        multihost_mesh,
    )

    avail = len(jax.devices())
    counts = [c for c in counts if c <= avail]
    scene = sphere_lens_scene(res=args.res, sectors=9, belts=4)
    params = params_from_scene(scene)
    start = np.asarray(scene.start)
    direction = np.asarray(scene.direction)
    target = jnp.zeros((64, 64), jnp.float32)
    n_rays = start.shape[0]

    results = []
    for n in counts:
        mesh = multihost_mesh(num_devices=n)
        step = make_multihost_train_step(
            mesh, scene.patches, scene.screen_plane, target, resolution=64
        )
        p, loss = step(params, start, direction)  # compile + warm-up
        jax.block_until_ready((p, loss))
        t0 = time.perf_counter()
        for _ in range(args.iters):
            p, loss = step(params, start, direction)
        jax.block_until_ready((p, loss))
        dt = time.perf_counter() - t0
        rays_s = n_rays * args.iters / dt
        results.append({"devices": n, "rays_per_s": round(rays_s, 1)})
        print(f"devices={n}: {rays_s:,.0f} rays/s", flush=True)

    base = results[0]["rays_per_s"] / results[0]["devices"]
    base_total = results[0]["rays_per_s"]
    cores = os.cpu_count() or 1
    on_cpu = jax.devices()[0].platform == "cpu"
    for r in results:
        r["efficiency_vs_1dev"] = round(
            r["rays_per_s"] / (base * r["devices"]), 4
        )
        if on_cpu:
            # Virtual CPU devices all share the same physical cores, and the
            # 1-device baseline already saturates them through XLA's intra-op
            # thread pool — so ideal aggregate throughput is *flat* in n, and
            # any drop below 1.0 here is pure partitioning/collective
            # overhead.  (On real multi-chip hardware each device brings its
            # own compute and efficiency_vs_1dev is the number to watch.)
            r["aggregate_vs_1dev"] = round(r["rays_per_s"] / base_total, 4)
    artifact = {
        "bench": "ray-sharded train-step scaling",
        "rays": n_rays,
        "platform": jax.devices()[0].platform,
        "physical_cores": cores,
        "note": (
            f"{cores} physical cores shared by all virtual devices; the "
            "1-device baseline already saturates them, so ideal scaling is "
            "flat aggregate throughput — aggregate_vs_1dev >= 1.0 shows the "
            "sharded step adds no partitioning/collective overhead, the "
            "transferable claim for real multi-chip meshes"
        ) if on_cpu else "",
        "results": results,
    }
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(artifact, fh, indent=1)
    print(json.dumps(artifact))


if __name__ == "__main__":
    main()
