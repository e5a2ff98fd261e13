"""Runtime configuration via environment variables (counterpart of
``superbblas_tpu/flags.py``).

The ``SBT_*`` variables this package reads, read lazily once
(``clear_cache`` re-reads them), with the JAX package's defaults and
errors:

  * ``SBT_LOG``   (int, default 0): >0 prints operation-level logging.
  * ``SBT_DEBUG`` (int, default 0): 0 none; >=1 cross-process consistency
    checks of the collective storage protocol; >=2 mock-index
    verification of every distributed copy and redistribution
    (utils/testing.py, ``parallel.redistribute._debug_replay``).
  * ``SBT_TRACK_TIME`` (0/1): enable the tracker (utils/tracker.py).
  * ``SBT_REDIST_METHOD`` ("auto"|"ragged"|"dense", default "auto"): the
    explicit redistribution's exchange: "ragged" = ``all_to_all_single``
    with the plan's true per-peer counts, "dense" = every pair padded to
    the plan's largest pair count, equal splits; "auto" = ragged.
  * ``SBT_REDIST_PACK`` ("auto"|"boxes"|"runs", default "auto"): the
    explicit redistribution's packing: "boxes" = seam-split box slices,
    "runs" = blocked-run gather/scatter index plans; "auto" picks by
    piece count.
  * ``SBT_CACHEGB`` (float, default 1.0): byte budget in GiB of the
    library's caches (the redistribution plans are evicted past it),
    reported against the allocator's reserved bytes by
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


def get_debug_level() -> int:
    return _env_int("SBT_DEBUG", 0)


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


def get_redist_method() -> str:
    """Explicit-redistribution exchange (SB_USE_ALLTOALL analog,
    runtime_features.h:101-125)."""
    v = _env_str("SBT_REDIST_METHOD", "auto").lower()
    if v not in ("auto", "ragged", "dense"):
        raise ValueError(
            f"SBT_REDIST_METHOD must be auto|ragged|dense, got {v!r}")
    return v


def get_redist_pack() -> str:
    """Explicit-redistribution packing (the pack/copy_n_blocking layer
    choice of the reference, dist.h:798-1010)."""
    v = _env_str("SBT_REDIST_PACK", "auto").lower()
    if v not in ("auto", "boxes", "runs"):
        raise ValueError(
            f"SBT_REDIST_PACK must be auto|boxes|runs, got {v!r}")
    return v


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
