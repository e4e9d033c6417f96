#!/usr/bin/env python
"""3x3-solve strategy microbenchmark — the JAX analogue of
reference/solve3x3.cpp (which justified inverse-then-multiply over LU:
0.0202 s vs 0.2030 s per 1M solves on CPU, solve3x3.cpp:5-13).

Compares, for 1M batched 3x3 systems on the current default device:
  * adjugate inverse-then-multiply (geom.inv3x3 — the design chosen for the
    intersection kernel's barycentric transforms),
  * jnp.linalg.solve (LAPACK-style batched solve),
  * precomputed-inverse mat-vec only (the steady-state cost inside the
    Newton loop, where the inverse is built once per patch).

Run: python benchmarks/solve3x3_bench.py
"""
from __future__ import annotations

import time

import jax
import jax.numpy as jnp
import numpy as np

from cbtr_tpu import geom

N = 1_000_000


def timed(fn, *args, iters=10):
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def main() -> None:
    rng = np.random.default_rng(0)
    m = jnp.asarray(
        rng.normal(size=(N, 3, 3)).astype(np.float32)
        + 3.0 * np.eye(3, dtype=np.float32)
    )
    v = jnp.asarray(rng.normal(size=(N, 3)).astype(np.float32))

    inv_mul = jax.jit(lambda m, v: geom.apply_mat3(geom.inv3x3(m), v))
    solve = jax.jit(lambda m, v: jnp.linalg.solve(m, v[..., None])[..., 0])
    inv = jax.jit(geom.inv3x3)
    pre = inv(m)
    jax.block_until_ready(pre)
    mat_vec = jax.jit(geom.apply_mat3)

    results = {
        "adjugate inverse + multiply": timed(inv_mul, m, v),
        "jnp.linalg.solve": timed(solve, m, v),
        "precomputed-inverse mat-vec": timed(mat_vec, pre, v),
    }
    print(f"device: {jax.devices()[0]}  ({N:,} solves per run)")
    for name, dt in results.items():
        print(f"  {name:30s} {dt * 1e3:8.2f} ms  ({N / dt / 1e6:8.1f} M/s)")


if __name__ == "__main__":
    main()
