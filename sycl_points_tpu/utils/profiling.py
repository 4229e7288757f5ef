"""Profiler integration (aux subsystem; SURVEY.md section 5.1).

The reference only has manual stopwatch timing; the equivalent here
adds `jax.profiler` trace capture around any pipeline section, viewable in
TensorBoard/Perfetto, plus the same per-stage wall-clock tables
(:mod:`sycl_points_tpu.utils.timing`).
"""

from __future__ import annotations

import contextlib

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace for the enclosed block:

        with profiling.trace("/tmp/jax-trace"):
            pipeline.process(scan, t)
    """
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named sub-span inside a trace (shows up in the profiler timeline)."""
    return jax.profiler.TraceAnnotation(name)
