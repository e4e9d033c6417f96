"""Cubic Bezier-triangle surface layer (L3).

Array-native redesign of the reference's BezierTriangle/BezierMesh classes
(reference/bezierTriangle.{h,cpp}, reference/bezierMesh.{h,cpp}): instead of
an object per patch, the whole surface is one struct-of-arrays pytree
(`BezierPatches`) built by four bulk-synchronous vectorized passes and
evaluated by batched Bernstein contractions.
"""
from .patches import (  # noqa: F401
    BezierPatches,
    interpolate,
    interpolate_linear,
    patch_normal,
    bernstein_weights,
)
from .build import build_patches, build_from_trimesh  # noqa: F401
from .tessellate import tessellate, tessellate_to_numpy  # noqa: F401
from .refine import split_thick_patches  # noqa: F401
