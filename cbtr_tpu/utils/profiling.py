"""Profiling + throughput observability.

The reference's only instrumentation is ad-hoc std::chrono timing
(reference/test.cpp:17-27, reference/solve3x3.cpp:49-64).  This package
exposes:

* `trace(logdir)` — context manager around `jax.profiler` emitting an XPlane
  trace viewable in TensorBoard/Perfetto (kernel times, memory traffic);
* `RateMeter` — a rays/s (or any unit/s) counter with EMA smoothing for
  long-running render/optimization loops;
* `enable_compile_cache()` — the one place that points JAX's persistent
  compilation cache at a directory.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def compile_cache_dir() -> str:
    """JAX_COMPILATION_CACHE_DIR when set, else <repo>/.jax_cache (a fixed
    path: the path is part of the cache key)."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at compile_cache_dir() and
    return the directory.  Call before the first compilation."""
    import jax

    path = compile_cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return path


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[None]:
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class RateMeter:
    """Exponential-moving-average throughput meter."""

    def __init__(self, unit: str = "rays", alpha: float = 0.2):
        self.unit = unit
        self.alpha = alpha
        self.rate: Optional[float] = None
        self.total = 0
        self._t_last: Optional[float] = None

    def tick(self, count: int) -> float:
        """Record `count` units processed since the previous tick."""
        now = time.perf_counter()
        if self._t_last is not None:
            dt = max(now - self._t_last, 1e-9)
            inst = count / dt
            self.rate = (
                inst
                if self.rate is None
                else self.alpha * inst + (1.0 - self.alpha) * self.rate
            )
        self._t_last = now
        self.total += count
        return self.rate or 0.0

    def __str__(self) -> str:
        r = self.rate or 0.0
        return f"{r:,.0f} {self.unit}/s (total {self.total:,})"
