"""Profiling helpers (SURVEY.md §5: tracing/profiling is absent in the
reference — only the demo's tic/toc. Here: ``jax.profiler`` traces plus a
warm-call timer)."""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Callable

import jax


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a jax.profiler trace into ``logdir`` (view with
    TensorBoard/XProf, or read with ``jax.profiler.ProfileData``)."""
    jax.profiler.start_trace(logdir)
    try:
        yield logdir
    finally:
        jax.profiler.stop_trace()


def kernel_timer(fn: Callable, *args, warmup: int = 2, reps: int = 10) -> float:
    """Median wall seconds of one warm call ``fn(*args)``.

    ``fn`` is jitted; the first ``warmup`` calls compile and warm up and are
    not timed. Each timed call ends in ``block_until_ready`` on the whole
    output, so the time covers the device work and not just the enqueue.
    """
    run = jax.jit(fn)
    for _ in range(warmup):
        jax.block_until_ready(run(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run(*args))
        times.append(time.perf_counter() - t0)
    return statistics.median(times)
