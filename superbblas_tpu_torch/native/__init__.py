"""Native (C++) host-side plan engine, loaded via ctypes (counterpart of
``superbblas_tpu/native/__init__.py``).

``plan_engine.cpp`` is the package's own copy of the JAX package's
source: the all-pairs toroidal box sweep behind every redistribution plan
and storage intersection (the reference's get_indices_to_send/receive,
dist.h:1789-1852).  It is compiled with g++ at first use into
``superbblas_tpu_torch/_build/<hash of the source and flags>/``, never
next to its source; where no toolchain is available every entry returns
None and the caller takes its Python sweep.  This is host code: it hides
no device work.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_HERE = Path(__file__).resolve().parent
_SRC = _HERE / "plan_engine.cpp"
BUILD = _HERE.parent / "_build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> Path:
    """Where the built library lives: ``_build/<hash>/libsbtplan.so``."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode() + _SRC.read_bytes())
    return BUILD / h.hexdigest()[:16] / "libsbtplan.so"


def _build(out: Path) -> bool:
    try:
        out.parent.mkdir(parents=True, exist_ok=True)
        # build in a private directory, then rename: a concurrent process
        # never loads a half-written library
        with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
            so = os.path.join(tmp, out.name)
            subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", so],
                           check=True, capture_output=True, timeout=120)
            os.replace(so, out)
        return True
    except Exception:
        return False


def get_lib() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library, or None."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        so = library_path()
        if not so.exists() and not _build(so):
            return None
        try:
            lib = ctypes.CDLL(str(so))
        except OSError:
            return None
        i64p = ctypes.POINTER(ctypes.c_longlong)
        lib.sbt_fragment_plan.restype = ctypes.c_longlong
        lib.sbt_fragment_plan.argtypes = [
            i64p, i64p, ctypes.c_longlong, i64p, ctypes.c_longlong,
            ctypes.c_longlong, i64p, ctypes.c_longlong,
        ]
        lib.sbt_intersect_all.restype = ctypes.c_longlong
        lib.sbt_intersect_all.argtypes = [
            i64p, ctypes.c_longlong, i64p, ctypes.c_longlong, i64p,
            ctypes.c_longlong, i64p, ctypes.c_longlong,
        ]
        _lib = lib
        return _lib


def _as_i64(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.int64))


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong))


def fragment_plan(src_boxes, dst_boxes, dim, copy_add: str = "copy"):
    """All (src_rank, dst_rank) fragments between two partitions.

    Returns an int64 array [count, 2 + 2*nd] of rows
    (i, j, from..., size...), or None when the native library is
    unavailable (callers fall back to Python).
    """
    lib = get_lib()
    if lib is None:
        return None
    src = _as_i64(src_boxes)
    dst = _as_i64(dst_boxes)
    d = _as_i64(dim)
    n, _, nd = src.shape
    mode = 0 if copy_add == "copy" else 1
    count = lib.sbt_fragment_plan(_ptr(src), _ptr(dst), n, _ptr(d), nd,
                                  mode, None, 0)
    if count < 0:
        return None
    out = np.zeros((int(count), 2 + 2 * nd), dtype=np.int64)
    got = lib.sbt_fragment_plan(_ptr(src), _ptr(dst), n, _ptr(d), nd,
                                mode, _ptr(out), count)
    if got != count:
        return None
    return out


def intersect_all(boxes_a, boxes_b, dim):
    """Batch toroidal intersection of two box lists; rows
    (ia, ib, from..., size...) or None without the native library."""
    lib = get_lib()
    if lib is None:
        return None
    a = _as_i64(boxes_a)
    b = _as_i64(boxes_b)
    d = _as_i64(dim)
    na, _, nd = a.shape
    nb = b.shape[0]
    count = lib.sbt_intersect_all(_ptr(a), na, _ptr(b), nb, _ptr(d), nd,
                                  None, 0)
    if count < 0:
        return None
    out = np.zeros((int(count), 2 + 2 * nd), dtype=np.int64)
    got = lib.sbt_intersect_all(_ptr(a), na, _ptr(b), nb, _ptr(d), nd,
                                _ptr(out), count)
    if got != count:
        return None
    return out
