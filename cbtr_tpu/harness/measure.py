"""Accuracy harness: the reference's approximation-error benchmark.

`measure_approximation` re-creates measureApproximation
(reference/test.cpp:429-460): tessellate the Bezier surface built over an
ellipsoid mesh and report the mean squared relative error of the tessellated
vertices against the exact ellipsoid surface point at the same spherical
(azimuth, inclination).  The reference's published error table
(reference/test.cpp:515-521) is the parity target asserted in
tests/test_accuracy.py.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ..mesh.core import TriMesh, make_ellipsoid
from ..bezier import build_from_trimesh, split_thick_patches, tessellate_to_numpy


def preprocess(mesh: TriMesh, use_native: Optional[bool] = None) -> TriMesh:
    """The canonical init sequence every reference driver repeats
    (e.g. reference/test.cpp:261-264): weld + orient + topology + averages.

    Defaults onto the native (C++) runtime when it is available — the
    reference keeps this stage native too (reference/mesh.cpp), and the
    NumPy path's per-interval weld / flood-fill loops become the wall-clock
    bottleneck at refined-mesh scales (split=6 robot: ~10^4 faces).  The
    NumPy implementation stays the behavioural oracle and the fallback
    (tests/test_native.py asserts equivalence); set CBTR_NATIVE=0 or
    use_native=False to force it.
    """
    if use_native is None:
        from .. import native

        use_native = (
            os.environ.get("CBTR_NATIVE", "") != "0" and native.available()
        )
    if use_native:
        from .. import native

        tris, fellow, starts, corner_avg = native.preprocess(mesh.tris)
        mesh.tris = tris
        mesh.fellow_triangles = fellow
        mesh.fellow_common_side_starts = starts
        mesh.corner_average_normals = corner_avg
        # derive the per-vertex view (visualizers consume it): welded corner
        # instances are bit-identical, so exact row dedup reproduces the
        # vertex table and each vertex's normal is any instance's normal
        flat = tris.reshape(-1, 3)
        uniq, first, inverse = np.unique(
            flat, axis=0, return_index=True, return_inverse=True
        )
        mesh.vertices = uniq.astype(np.float32)
        mesh.face2vertex = inverse.reshape(-1, 3).astype(np.int32)
        mesh.vertex_average_normals = corner_avg.reshape(-1, 3)[first]
        return mesh
    mesh.standardize_vertices()
    mesh.standardize_normals()
    return mesh


def measure_approximation(
    split_steps: int, sectors: int, belts: int, size, divisor: int
) -> float:
    size = np.asarray(size, np.float32)
    mesh = preprocess(make_ellipsoid(sectors, belts, size))

    for _ in range(split_steps):
        patches = build_from_trimesh(mesh)
        new_tris, _ = split_thick_patches(
            patches, mesh.fellow_triangles, mesh.fellow_common_side_starts
        )
        mesh = preprocess(TriMesh(new_tris))

    patches = build_from_trimesh(mesh)
    planified = TriMesh(tessellate_to_numpy(patches, divisor))
    planified.standardize_vertices()
    vertices = planified.unique_vertices()

    scaled = vertices / size
    r = np.linalg.norm(scaled, axis=-1)
    inclination = np.arccos(np.clip(scaled[:, 2] / np.maximum(r, 1e-30), -1, 1))
    azimuth = np.arctan2(scaled[:, 1], scaled[:, 0])
    ethalon = np.stack(
        [
            size[0] * np.sin(inclination) * np.cos(azimuth),
            size[1] * np.sin(inclination) * np.sin(azimuth),
            size[2] * np.cos(inclination),
        ],
        axis=-1,
    )
    num = np.sum((vertices - ethalon) ** 2, axis=-1)
    den = np.sum(ethalon**2, axis=-1)
    return float(np.mean(num / den))


def winner_agreement(ref, got, tol: float = 1e-4) -> dict:
    """Agreement of two per-ray winner results (any_hit, win, distance), as
    returned by select_candidates or the sweep kernel.

    hit_set: share of rays whose hit/miss agrees.  winner: share of rays
    that agree fully: both miss, or both hit the same patch at distances
    within tol (relative and absolute)."""
    ah_r, win_r, d_r = (np.asarray(x) for x in ref)
    ah_g, win_g, d_g = (np.asarray(x) for x in got)
    close = np.abs(d_r - d_g) <= tol * (1.0 + np.abs(d_r))
    agree = np.where(ah_r, ah_g & (win_r == win_g) & close, ~ah_g)
    return {"rays": int(ah_r.size), "hits": int(ah_r.sum()),
            "hit_set": float(np.mean(ah_r == ah_g)),
            "winner": float(np.mean(agree))}
