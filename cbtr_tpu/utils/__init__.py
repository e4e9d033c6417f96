"""Runtime utilities: checkpoint/resume, profiling, throughput metering."""
from .checkpoint import (  # noqa: F401
    load_params,
    load_patches,
    save_params,
    save_patches,
)
from .profiling import (  # noqa: F401
    RateMeter,
    compile_cache_dir,
    enable_compile_cache,
    trace,
)
