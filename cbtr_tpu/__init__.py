"""cbtr_tpu — a differentiable Bézier-triangle raytracer in JAX.

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
`balazs-bamer/cuda-bezier-triangle-raytracer`: closed-triangle-mesh
preprocessing, C1-continuous cubic Bézier-triangle surfaces
(Clough-Tocher), Newton-style ray/surface intersection, and Snell
refraction through lens surfaces — as batched, differentiable,
multi-chip-shardable array programs.
"""

from . import config, geom  # noqa: F401

__version__ = "0.1.0"
