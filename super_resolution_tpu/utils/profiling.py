"""Profiling utilities (the tracing subsystem the reference lacks —
SURVEY.md §5 lists only a wall-clock printout, ``super_resolution.cpp:191-196``).

- :func:`trace` — context manager around ``jax.profiler`` writing a
  TensorBoard-compatible device trace.
- :class:`WallClock` — simple scoped wall-clock timing (the reference's
  behavior), with ``block_until_ready`` so device work is included.
- :func:`device_time` — median device execution time of a jitted callable.
"""

from __future__ import annotations

import contextlib
import time

import jax

__all__ = ["trace", "WallClock", "device_time"]


@contextlib.contextmanager
def trace(log_dir: str = "jax_trace"):
    """Capture a jax.profiler device trace (view with TensorBoard/XProf)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()


class WallClock:
    """Scoped wall-clock timer: ``with WallClock("solve") as t: ...``."""

    def __init__(self, label: str = "", verbose: bool = True):
        self.label = label
        self.verbose = verbose
        self.elapsed = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._t0
        if self.verbose:
            print(f"{self.label or 'elapsed'}: {self.elapsed:.3f} s")
        return False


def device_time(fn, *args, iterations: int = 20, warmup: int = 2) -> float:
    """Median seconds per call of ``fn(*args)`` including device completion."""
    times = []
    for i in range(warmup + iterations):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        if i >= warmup:
            times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
