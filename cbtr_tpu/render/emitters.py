"""Uniform hemisphere emitter sampling (reference hostUtil.{h,cpp}).

Three implementations:

* `UniformHemisphere` — host-side NumPy, mirroring the reference class:
  incidence = acos(U(0,1)) (uniform over the hemisphere *area* without
  rejection, reference/hostUtil.cpp:19), turn = U(0, 2pi), plus the
  belt/patch binning the reference designed for GPU warp coherence
  (reference/hostUtil.cpp:9-13, README.md:169-192).  Here the binning's
  job is ray-tile locality for the sweep kernel's cull lists; the patch
  index is kept for parity and for tile-sorting experiments.

* `DeviceEmitter` — the scale path: rays synthesized on the accelerator
  PRE-SORTED by that same belt/patch bin (the emitter analogue of
  camera.OrthoGrid).  No host sampling, no host argsort, no upload.

* `sample_hemisphere` — jax.random version for in-graph ray generation.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..config import PI


def belt_patch_counts(belts: int) -> np.ndarray:
    """Patches per belt: ceil(4b * sin((2i+1)/(4b) * pi))
    (reference/hostUtil.cpp:11)."""
    i = np.arange(belts, dtype=np.float64)
    return np.ceil(4.0 * belts * np.sin((2.0 * i + 1.0) / (4.0 * belts) * PI)).astype(
        np.int64
    )


class UniformHemisphere:
    """Host-side emitter with patch binning (reference/hostUtil.{h,cpp})."""

    def __init__(self, belts: int, seed: int = 0):
        self.belts = int(belts)
        self.belt_width = PI / 2.0 / belts
        counts = belt_patch_counts(belts)
        self.patch_starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        self.patch_widths = 2.0 * PI / counts
        self.patch_count = int(counts.sum())
        self._rng = np.random.default_rng(seed)

    def sample(self, n: int):
        """-> (directions [n,3] around +x, patch indices [n])."""
        incidence = np.arccos(self._rng.uniform(0.0, 1.0, n))
        turn = self._rng.uniform(0.0, 2.0 * PI, n)
        belt_radius = np.sin(incidence)
        d = np.stack(
            [np.cos(incidence), belt_radius * np.cos(turn), belt_radius * np.sin(turn)],
            axis=-1,
        )
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        belt = np.minimum((incidence / self.belt_width).astype(np.int64), self.belts - 1)
        patch = self.patch_starts[belt] + (turn / self.patch_widths[belt]).astype(
            np.int64
        )
        return d.astype(np.float32), patch.astype(np.int32)


class DeviceEmitter(NamedTuple):
    """Point-source hemisphere emitter with rays synthesized ON DEVICE,
    already ordered by the reference's belt/patch bin.

    `render_emitter_image` sorts host-sampled rays by their bin before
    tracing (the reference's warp-coherence binning re-purposed as the sweep
    kernel's coherence key, reference/hostUtil.cpp:9-13).  But at
    multi-million-ray renders the host sample + np.argsort + upload can
    become the bottleneck the OrthoGrid work removed from the 4K ortho
    render.

    This emitter deletes that whole host stage.  Ray index space is
    partitioned over the bins in bin order, each bin getting a contiguous
    index range of round(n * bin_area_fraction) rays, so synthesized rays
    are sorted-by-construction (zero sort cost) and a sharded render's
    contiguous per-device index slices get maximal tile coherence.  Within a
    bin, incidence is stratified along the cos axis ((j + u)/count over the
    bin's cos range — uniform over the sphere area, like the reference's
    acos(U) draw restricted to the belt) and the turn is uniform over the
    bin's angular width; the per-index threefry jitter makes rays
    deterministic functions of (seed, global index), so any sharding
    synthesizes identical rays.  Bin rounding is unbiased via per-ray
    weights w = n * bin_fraction / bin_count (sum(w) = n exactly; the splat
    already takes per-ray weights).

    All fields are hashable -> instances are jit-static, like OrthoGrid.
    """

    origin: tuple      # (3,) emitter position
    belts: int
    n_rays: int
    seed: int = 0

    def _tables(self):
        """Static per-patch tables (numpy; embedded as jaxpr constants)."""
        B = self.belts
        counts = belt_patch_counts(B)                       # [B]
        w = PI / 2.0 / B
        cos_a = np.cos(np.arange(B) * w)                    # belt near edge
        cos_b = np.cos((np.arange(B) + 1) * w)              # belt far edge
        belt_of = np.repeat(np.arange(B), counts)           # [Np]
        pin = np.concatenate([np.arange(c) for c in counts])  # patch-in-belt
        frac = (cos_a - cos_b)[belt_of] / counts[belt_of]   # area fractions
        bounds = np.round(np.cumsum(frac) * self.n_rays).astype(np.int64)
        bounds[-1] = self.n_rays                            # fp-exact total
        starts = np.concatenate([[0], bounds[:-1]])
        nb = bounds - starts                                # rays per patch
        return {
            "bounds": bounds.astype(np.int32),
            "starts": starts.astype(np.int32),
            "nb": nb.astype(np.int32),
            "cos_a": cos_a[belt_of].astype(np.float32),
            "cos_b": cos_b[belt_of].astype(np.float32),
            "turn0": (pin * (2.0 * PI / counts[belt_of])).astype(np.float32),
            "turn_w": (2.0 * PI / counts[belt_of]).astype(np.float32),
            "frac": frac.astype(np.float32),
        }

    def rays_at(self, idx):
        """(start [N,3], direction [N,3], weight [N]) f32 for global ray
        indices idx [N] i32 — deterministic in (seed, idx), so sharded
        callers synthesizing disjoint slices reproduce the single-device
        rays bit-for-bit."""
        t = {k: jnp.asarray(v) for k, v in self._tables().items()}
        key = jax.random.PRNGKey(self.seed)
        u = jax.vmap(
            lambda i: jax.random.uniform(jax.random.fold_in(key, i), (2,))
        )(idx)                                              # [N,2]
        patch = jnp.searchsorted(t["bounds"], idx, side="right").astype(
            jnp.int32
        )
        patch = jnp.minimum(patch, t["bounds"].shape[0] - 1)
        cnt = jnp.maximum(t["nb"][patch], 1).astype(jnp.float32)
        j = (idx - t["starts"][patch]).astype(jnp.float32)
        # stratified cos(incidence) over the belt's [cos_b, cos_a] range
        u1 = (j + u[:, 0]) / cnt
        cosv = t["cos_a"][patch] - u1 * (t["cos_a"][patch] - t["cos_b"][patch])
        sinv = jnp.sqrt(jnp.maximum(1.0 - cosv * cosv, 0.0))
        turn = t["turn0"][patch] + u[:, 1] * t["turn_w"][patch]
        d = jnp.stack(
            [cosv, sinv * jnp.cos(turn), sinv * jnp.sin(turn)], axis=-1
        )
        d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
        start = jnp.broadcast_to(
            jnp.asarray(self.origin, jnp.float32)[None, :], d.shape
        )
        weight = t["frac"][patch] * jnp.float32(self.n_rays) / cnt
        return start, d, weight


def sample_hemisphere(key, n: int):
    """jax.random version: uniform hemisphere directions around +x, [n,3]."""
    k1, k2 = jax.random.split(key)
    incidence = jnp.arccos(jax.random.uniform(k1, (n,)))
    turn = jax.random.uniform(k2, (n,), minval=0.0, maxval=2.0 * PI)
    r = jnp.sin(incidence)
    d = jnp.stack(
        [jnp.cos(incidence), r * jnp.cos(turn), r * jnp.sin(turn)], axis=-1
    )
    return d / jnp.linalg.norm(d, axis=-1, keepdims=True)
