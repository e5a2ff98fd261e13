"""Runtime configuration via environment variables (counterpart of
``superbblas_tpu/flags.py``).

The ``SBT_*`` variables this package reads, read lazily once
(``clear_cache`` re-reads them), with the JAX package's defaults and
errors:

  * ``SBT_LOG``   (int, default 0): >0 prints operation-level logging.
  * ``SBT_TRACK_TIME`` (0/1): enable the tracker (utils/tracker.py).
  * ``SBT_CACHEGB`` (float, default 1.0): byte budget in GiB of the
    library's caches, reported against the allocator's reserved bytes by
    ``utils.caches.report_cache_usage``.
  * ``SBT_MATMUL_PRECISION`` ("highest"|"high"|"default", default
    "highest"): how ``cplx.cdot_general`` (and so every contraction)
    multiplies f32 operands.  "highest" is full f32 with TF32 off (the
    reference library's true-fp32 semantics); "high" lets cuBLAS use
    TF32 on the card (on the CPU, which has no TF32, full f32); "default"
    rounds f32 operands to bf16 and sums their exact products in f32,
    the products the TPU's MXU forms at its default precision.  f64 and
    bf16 operands are unaffected.  The stencil kernels are unaffected.
"""

from __future__ import annotations

import functools
import os


@functools.lru_cache(maxsize=None)
def _env_int(name: str, default: int) -> int:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return int(v)
    except ValueError:
        raise ValueError(f"environment variable {name} must be an int, got {v!r}")


def get_log_level() -> int:
    return _env_int("SBT_LOG", 0)


def get_track_time() -> bool:
    return bool(_env_int("SBT_TRACK_TIME", 0))


@functools.lru_cache(maxsize=None)
def _env_str(name: str, default: str) -> str:
    v = os.environ.get(name)
    return default if v is None or v == "" else v


@functools.lru_cache(maxsize=None)
def _env_float(name: str, default: float) -> float:
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    try:
        return float(v)
    except ValueError:
        raise ValueError(
            f"environment variable {name} must be a float, got {v!r}")


def get_cache_gb() -> float:
    """Cache byte budget in GiB (SB_CACHEGB analog, cache.h:238-265)."""
    return _env_float("SBT_CACHEGB", 1.0)


def get_matmul_precision() -> str:
    v = _env_str("SBT_MATMUL_PRECISION", "highest").lower()
    if v not in ("default", "high", "highest"):
        raise ValueError(
            f"SBT_MATMUL_PRECISION must be default|high|highest, got {v!r}")
    return v


@functools.lru_cache(maxsize=None)
def wrapper_state() -> tuple:
    """(log an op, track its time): the one cached read a tracked op makes
    when both are off."""
    return get_log_level() >= 1, get_track_time()


def clear_cache() -> None:
    """Re-read environment variables (for tests)."""
    _env_int.cache_clear()
    _env_str.cache_clear()
    _env_float.cache_clear()
    wrapper_state.cache_clear()


def log(level: int, msg: str) -> None:
    if get_log_level() >= level:
        print(f"[sbt] {msg}", flush=True)
