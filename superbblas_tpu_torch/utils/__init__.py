"""Utilities (counterpart of ``superbblas_tpu/utils``): the numpy oracles and
consistency checks of ``testing``, the tracker and the cache controls."""

from .testing import (
    check_collective_consistency,
    check_consistency,
    numpy_contraction_reference,
    numpy_copy_reference,
    verify_copy,
)

__all__ = [
    "check_collective_consistency",
    "check_consistency",
    "numpy_contraction_reference",
    "numpy_copy_reference",
    "verify_copy",
]

from . import tracker
from .tracker import (
    check_for_memory_leaks,
    get_timings,
    memory_snapshot,
    report_memory_usage,
    report_timings,
    reset_timings,
    track,
)

__all__ += ["tracker", "track", "get_timings", "reset_timings",
            "report_timings", "report_memory_usage", "memory_snapshot",
            "check_for_memory_leaks"]

from .caches import clear_caches, report_cache_usage

__all__ += ["clear_caches", "report_cache_usage"]
