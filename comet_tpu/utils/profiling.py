"""Tracing and timing.

The reference has no tracing/profiling at all (SURVEY.md §5.1 — its only
observability is `go test -bench`). Here:

- `profile_trace(dir)` wraps a block in the JAX profiler; the resulting
  trace (viewable in Perfetto/TensorBoard) shows per-kernel device timings
  for the scan/beam/ADC kernels.
- `Timer`/`timed` give cheap wall-clock spans with device-sync semantics
  (a `jax.block_until_ready` on exit when arrays are registered).
"""

from __future__ import annotations

import contextlib
import logging
import time

log = logging.getLogger("comet_tpu.profiling")


@contextlib.contextmanager
def profile_trace(log_dir: str):
    """JAX profiler trace around a block: per-kernel device timings."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class Timer:
    """Wall-clock span that optionally syncs device work before stopping."""

    def __init__(self, name: str = "span"):
        self.name = name
        self.elapsed = 0.0
        self._sync_targets = []

    def sync(self, *arrays):
        """Register device arrays to block on before the span closes."""
        self._sync_targets.extend(arrays)
        return arrays[0] if len(arrays) == 1 else arrays

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._sync_targets:
            import jax

            jax.block_until_ready(self._sync_targets)
        self.elapsed = time.perf_counter() - self._t0
        log.debug("%s: %.3f ms", self.name, self.elapsed * 1e3)
        return False


@contextlib.contextmanager
def timed(name: str = "span"):
    t = Timer(name)
    with t:
        yield t
