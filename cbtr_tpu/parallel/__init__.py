"""Multi-chip parallelism: the ray-sharded mesh paths (multihost) and the
patch-sharded intersection."""
from .multihost import (  # noqa: F401
    multihost_mesh,
    render_multihost,
    make_multihost_train_step,
)
from .patch_parallel import intersect_rays_patch_sharded  # noqa: F401
