"""Batched analogues of the reference's remaining manual-test drivers
(reference/test.cpp:100-235, 464-494).

Each driver returns structured data so tests can *assert* what the
reference only inspected visually in Blender; pass `out_dir` to also get the
reference-style STL dumps.
"""
from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np

from ..bezier import BezierPatches, build_from_trimesh, split_thick_patches
from ..bezier.tessellate import tessellate_to_numpy
from ..mesh.core import TriMesh, make_ellipsoid, make_unit_sphere
from .measure import preprocess
from .visual import visualize_normals, visualize_vertex_normals


def dump_control_points(patches: BezierPatches) -> np.ndarray:
    """All control points in patch-major index order, [P*10, 3]
    (BezierMesh::dumpControlPoints, reference/bezierMesh.cpp:68-78)."""
    return np.asarray(patches.control_points, np.float32).reshape(-1, 3)


def control_point_markers(patches: BezierPatches, size: float) -> TriMesh:
    """The reference marks each *boundary* control point with a small sphere
    (testBezier2plane, reference/test.cpp:184-196; its index filter keeps
    every index since i<12 always holds — faithfully, all 10 are marked)."""
    pts = dump_control_points(patches)
    ball = make_unit_sphere(3, 1)
    ball.scale(size)
    out = [ball.tris + p[None, None, :] for p in pts]
    return TriMesh(np.concatenate(out).astype(np.float32))


class SplitRoundtrip(NamedTuple):
    original: TriMesh
    roundtripped: TriMesh     # write -> read -> split -> re-preprocess
    normals_vis: TriMesh
    vertex_normals_vis: TriMesh


def _split_roundtrip(sectors, belts, radius, split_fn, out_dir, name,
                     binary) -> SplitRoundtrip:
    sphere = make_unit_sphere(sectors, belts)
    sphere.scale(radius)
    path = os.path.join(out_dir or "/tmp", f"test_{name}.stl")
    sphere.write(path, binary=binary)

    back = TriMesh().read(path)
    split_fn(back)
    back = preprocess(back)
    nv = visualize_normals(back)
    vnv = visualize_vertex_normals(back)
    if out_dir:
        back.write(os.path.join(out_dir, f"back_test_{name}.stl"))
        nv.write(os.path.join(out_dir, f"norm_test_{name}.stl"))
        vnv.write(os.path.join(out_dir, f"vertexNorm_test_{name}.stl"))
    return SplitRoundtrip(sphere, back, nv, vnv)


def split_divisor_driver(name: str, sectors: int, belts: int, radius: float,
                         divisor: int, out_dir: Optional[str] = None,
                         binary: bool = True) -> SplitRoundtrip:
    """testDequeDivisor (reference/test.cpp:100-129): STL round-trip a scaled
    sphere, uniform-split every triangle by `divisor`, re-standardize, and
    emit the two normals visualizations."""
    return _split_roundtrip(
        sectors, belts, radius, lambda m: m.split_triangles(divisor), out_dir,
        name, binary,
    )


def split_maxside_driver(name: str, sectors: int, belts: int, radius: float,
                         max_side: float, out_dir: Optional[str] = None,
                         binary: bool = True) -> SplitRoundtrip:
    """testVectorMax (reference/test.cpp:131-157): like split_divisor_driver
    but with the per-triangle max-side split rule."""
    return _split_roundtrip(
        sectors, belts, radius, lambda m: m.split_triangles_max_side(max_side),
        out_dir, name, binary,
    )


class Bezier2Plane(NamedTuple):
    original: TriMesh
    planified: TriMesh        # tessellated Bezier surface
    control_points: np.ndarray  # [P*10, 3]


def bezier2plane_driver(sectors: int, belts: int, radius: float, divisor: int,
                        out_dir: Optional[str] = None,
                        name: str = "b2p") -> Bezier2Plane:
    """testBezier2plane (reference/test.cpp:159-199): build the Bezier
    surface over a sphere, tessellate it back to flat triangles, and dump
    every control point."""
    sphere = make_unit_sphere(sectors, belts)
    sphere.scale(radius)
    sphere = preprocess(sphere)
    patches = build_from_trimesh(sphere)
    planified = TriMesh(tessellate_to_numpy(patches, divisor))
    cps = dump_control_points(patches)
    if out_dir:
        sphere.write(os.path.join(out_dir, f"baryOrig_{name}.stl"))
        planified.write(os.path.join(out_dir, f"bary2plane_{name}.stl"))
        size = float(np.pi) * radius / (belts + 1) / 20.0
        control_point_markers(patches, size).write(
            os.path.join(out_dir, f"baryControl_{name}.stl")
        )
    return Bezier2Plane(sphere, planified, cps)


class SplitTall(NamedTuple):
    original: TriMesh
    split1: TriMesh
    split2: TriMesh
    num_thick1: int
    num_thick2: int


def split_tall_driver(sectors: int, belts: int, size,
                      out_dir: Optional[str] = None,
                      name: str = "tall") -> SplitTall:
    """testBezierSplitTall (reference/test.cpp:202-235): two successive
    rounds of thick-patch refinement over an ellipsoid."""
    ellipsoid = preprocess(make_ellipsoid(sectors, belts, size))
    patches0 = build_from_trimesh(ellipsoid)
    tris1, n1 = split_thick_patches(
        patches0, ellipsoid.fellow_triangles,
        ellipsoid.fellow_common_side_starts,
    )
    split1 = preprocess(TriMesh(tris1))
    patches1 = build_from_trimesh(split1)
    tris2, n2 = split_thick_patches(
        patches1, split1.fellow_triangles, split1.fellow_common_side_starts
    )
    split2 = TriMesh(tris2)
    if out_dir:
        ellipsoid.write(os.path.join(out_dir, f"barySplitOrig_{name}.stl"))
        visualize_vertex_normals(ellipsoid).write(
            os.path.join(out_dir, f"barySplitVertexNorm_{name}.stl")
        )
        split1.write(os.path.join(out_dir, f"barySplit1_{name}.stl"))
        split2.write(os.path.join(out_dir, f"barySplit2_{name}.stl"))
    return SplitTall(ellipsoid, split1, split2, n1, n2)


class CustomStl(NamedTuple):
    mesh: TriMesh
    patches: BezierPatches
    planified: TriMesh
    refined_mesh: Optional[TriMesh]
    refined_patches: Optional[BezierPatches]
    num_thick: int


def custom_stl_driver(path: str, divisor: int, refine: bool = False,
                      out_dir: Optional[str] = None) -> CustomStl:
    """testCustomStl (reference/test.cpp:473-494): the free-form STL
    pipeline — preprocess, Bezier build, tessellation dump — plus the
    adaptive-refinement pass the reference never wired up for robot.stl."""
    mesh = preprocess(TriMesh().read(path))
    patches = build_from_trimesh(mesh)
    planified = TriMesh(tessellate_to_numpy(patches, divisor))
    refined_mesh = refined_patches = None
    num_thick = 0
    if refine:
        tris, num_thick = split_thick_patches(
            patches, mesh.fellow_triangles, mesh.fellow_common_side_starts
        )
        refined_mesh = preprocess(TriMesh(tris))
        refined_patches = build_from_trimesh(refined_mesh)
    if out_dir:
        base = os.path.basename(path)
        mesh.write(os.path.join(out_dir, f"back_{base}"))
        visualize_normals(mesh).write(os.path.join(out_dir, f"norm_{base}"))
        planified.write(os.path.join(out_dir, f"bary2plane_{base}"))
        if refined_mesh is not None:
            refined_mesh.write(os.path.join(out_dir, f"refined_{base}"))
    return CustomStl(mesh, patches, planified, refined_mesh, refined_patches,
                     num_thick)


def followers_report(patches: BezierPatches, start, direction):
    """visualizeFollowers analogue (reference/test.cpp:464-471 — a stub that
    printed per-ray 'what' outcomes of the gFollowers log): for each ray,
    report which patches answered cFollowSideX with the retry target, from
    the sweep codes.

    Returns dict with per-ray lists of (patch, side, neighbour) and the
    totals — the observability the reference's debug deque provided.
    """
    import jax.numpy as jnp

    from ..ops.intersect import WHAT_NONE, sweep_codes_xla

    code, _ = sweep_codes_xla(
        patches, jnp.asarray(start, jnp.float32),
        jnp.asarray(direction, jnp.float32),
    )
    code = np.asarray(code)
    what_on = np.where((code >> 3) > 0, code & 7, WHAT_NONE)
    neighbours = np.asarray(patches.neighbours)
    rays, patches_idx = np.nonzero(what_on < 3)
    out = [[] for _ in range(len(start))]
    for r, p in zip(rays, patches_idx):
        side = int(what_on[r, p])
        out[int(r)].append((int(p), side, int(neighbours[p, side])))
    return {
        "followers": out,
        "total_follow_candidates": int(len(rays)),
        "rays_with_followers": int(len(set(rays.tolist()))),
    }
