#!/usr/bin/env python
"""Multi-process (multi-"host") sharded render demo + correctness artifact.

Launches N jax.distributed processes on this machine (each exposing 2
virtual CPU devices, standing in for one host's chips), renders the sphere
lens with rays sharded across ALL processes' devices via
`parallel.multihost`, and verifies every process converged to the same
replicated image.  The same code launches across real hosts: one process
per host, `init_distributed()` picking up the cluster env.

Usage:
  python benchmarks/multiprocess_render.py --procs 2 --out /tmp/mp_img.npz

As a worker (spawned internally):
  python benchmarks/multiprocess_render.py --worker <pid> --procs N --port P
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(pid: int, nproc: int, port: int, out: str, res: int,
           train: bool, train_ortho: bool = False) -> None:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax

    jax.config.update("jax_platforms", "cpu")
    sys.path.insert(0, REPO)

    from cbtr_tpu.parallel.multihost import (
        init_distributed,
        make_multihost_train_step,
        make_multihost_train_step_ortho,
        multihost_mesh,
        render_multihost,
    )

    assert init_distributed(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nproc,
        process_id=pid,
    )
    import numpy as np
    import jax.numpy as jnp

    from cbtr_tpu.models import sphere_lens_scene
    from cbtr_tpu.models.lens_model import params_from_scene

    # identical procedural scene on every process (deterministic preprocessing)
    scene = sphere_lens_scene(res=res, sectors=9, belts=4)
    mesh = multihost_mesh()

    if train_ortho:
        # the TRAIN4K path: rays synthesized on device per shard, gradient
        # psum across the process boundary (benchmarks/train4k.py --procs)
        from cbtr_tpu.models.scenes import SPHERE_BEAM_WIDTH, scene_ortho_grid

        params = params_from_scene(scene)
        target = jnp.zeros((32, 32), jnp.float32)
        grid = scene_ortho_grid(res, beam_width=SPHERE_BEAM_WIDTH)
        step = make_multihost_train_step_ortho(
            mesh, scene.patches, scene.screen_plane, target, grid,
            resolution=32, learning_rate=1e-4,
        )
        p1, loss1, _ = step(params)
        p2, loss2, _ = step(p1)
        np.savez(
            f"{out}.proc{pid}",
            cp=np.asarray(p2.control_points),
            n_refr=np.asarray(p2.refractive_index),
            loss1=float(loss1), loss2=float(loss2),
            n_processes=jax.process_count(), n_devices=len(jax.devices()),
        )
        print(f"proc {pid}/{nproc} train-ortho: loss {float(loss1):.8f} -> "
              f"{float(loss2):.8f}", flush=True)
        return

    if train:
        # two SGD steps whose gradient psum crosses the process boundary —
        # the thing that rides DCN on a real pod (parallel/multihost.py)
        params = params_from_scene(scene)
        target = jnp.zeros((32, 32), jnp.float32)
        step = make_multihost_train_step(
            mesh, scene.patches, scene.screen_plane, target, resolution=32,
            learning_rate=1e-4,
        )
        p1, loss1 = step(params, scene.start, scene.direction)
        p2, loss2 = step(p1, scene.start, scene.direction)
        np.savez(
            f"{out}.proc{pid}",
            cp=np.asarray(p2.control_points),
            n_refr=np.asarray(p2.refractive_index),
            loss1=float(loss1), loss2=float(loss2),
            n_processes=jax.process_count(), n_devices=len(jax.devices()),
        )
        print(f"proc {pid}/{nproc} train: loss {float(loss1):.8f} -> "
              f"{float(loss2):.8f}", flush=True)
        return

    img = render_multihost(
        mesh, scene.patches, scene.refractive_index, scene.start,
        scene.direction, scene.screen_plane, resolution=32,
    )
    img = np.asarray(img)
    assert np.isfinite(img).all()
    np.savez(f"{out}.proc{pid}", img=img, n_processes=jax.process_count(),
             n_devices=len(jax.devices()))
    print(f"proc {pid}/{nproc}: {len(jax.devices())} global devices, "
          f"image sum {img.sum():.6f}", flush=True)


def launch(nproc: int, out: str, res: int, train: bool,
           train_ortho: bool = False) -> int:
    import socket

    with socket.socket() as s:  # grab a free port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    extra = ["--train"] if train else (["--train-ortho"] if train_ortho else [])
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker", str(pid),
             "--procs", str(nproc), "--port", str(port), "--out", out,
             "--res", str(res)] + extra,
            cwd=REPO,
        )
        for pid in range(nproc)
    ]
    rc = 0
    for p in procs:
        rc |= p.wait()
    return rc


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--worker", type=int, default=-1)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--out", default="/tmp/cbtr_mp_render")
    ap.add_argument("--res", type=int, default=16)
    ap.add_argument("--train", action="store_true",
                    help="run 2 multihost SGD steps instead of a render")
    ap.add_argument("--train-ortho", action="store_true",
                    help="run 2 device-synthesized-ray SGD steps (TRAIN4K path)")
    args = ap.parse_args()
    if args.worker >= 0:
        worker(args.worker, args.procs, args.port, args.out, args.res,
               args.train, args.train_ortho)
    else:
        rc = launch(args.procs, args.out, args.res, args.train,
                    args.train_ortho)
        if rc:
            sys.exit(rc)
        mode = ("train" if args.train
                else "train-ortho" if args.train_ortho else "render")
        print("multiprocess", mode, "OK")


if __name__ == "__main__":
    main()
