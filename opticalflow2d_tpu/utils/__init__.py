"""Auxiliary subsystems (SURVEY.md §5): checkpoint/resume, profiling,
numerical-health checks, the compile cache, and the measured card."""

from opticalflow2d_tpu.utils.checkpoint import save_checkpoint, load_checkpoint
from opticalflow2d_tpu.utils.profiling import trace, kernel_timer
from opticalflow2d_tpu.utils.health import debug_nans, assert_finite
from opticalflow2d_tpu.utils.compile_cache import enable_compile_cache

__all__ = [
    "save_checkpoint", "load_checkpoint", "trace", "kernel_timer",
    "debug_nans", "assert_finite", "enable_compile_cache",
]
