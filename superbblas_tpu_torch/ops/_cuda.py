"""Build and load the package's CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source, all started together, and linked into one
shared library with a plain C interface, at first use, into
``_build/<hash of the sources>/``, and loaded with ``ctypes``.  Nothing is
built or loaded at import, so the package imports on machines without
CUDA; on a machine with a card but no ``nvcc`` the build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
SOURCES = ("stencil_soa.cu", "stencil_schedules.cu", "permute.cu", "batched_gemm.cu",
           "roll_add.cu")
#: headers the sources include (part of the build's hash)
HEADERS = ("stencil_soa.cuh",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")

#: seconds nvcc took in this process (None: the library was already built)
build_seconds = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels of superbblas_tpu_torch cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/`` if needed."""
    global build_seconds
    out = BUILD / _digest() / "libsbt_kernels.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        # build in a private directory, then rename: concurrent processes
        # never load a half-written library
        with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
            nvcc = _nvcc()
            objs = [os.path.join(tmp, f"{Path(s).stem}.o") for s in SOURCES]
            procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / src)],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True)
                     for src, obj in zip(SOURCES, objs)]
            done = []
            for proc in procs:
                stdout, stderr = proc.communicate()
                done.append((proc.args, proc.returncode, stdout, stderr))
            so = os.path.join(tmp, out.name)
            if all(rc == 0 for _, rc, _, _ in done):
                link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs],
                                      capture_output=True, text=True)
                done.append((link.args, link.returncode, link.stdout, link.stderr))
            for args, rc, stdout, stderr in done:
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}):\n{' '.join(args)}\n"
                                       f"{stdout}\n{stderr}")
            os.replace(so, out)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # (ki, kd, bi, bd, type pair, b, kron, x, y re/im pointers, n, X, Y, Z, T,
    #  ndir, offsets) + each kernel's own trailing ints + stream
    head = [i] * 5 + [p] * 8 + [i] * 6 + [p]
    for name, extra in (("sbt_stencil_soa", [i]), ("sbt_stencil_soa_rt", [i]),
                        ("sbt_stencil_soa_xin", [i, i, i]), ("sbt_stencil_soa_stream", [])):
        getattr(lib, name).argtypes = head + extra + [p]
        getattr(lib, name).restype = i
    lib.sbt_permute_4d.argtypes = [i, i64, i64, i64, i64, i64, i64, i64, i64, p, p, p]
    lib.sbt_permute_4d.restype = i
    # (edge, rows, planes, mid_swap, X, Y, Z, T, strides, grid) + in, out, stream
    lib.sbt_permute_4d_tiled.argtypes = [i] * 4 + [i64] * 11 + [p, p, p]
    lib.sbt_permute_4d_tiled.restype = i
    lib.sbt_roll_add.argtypes = [i, i64, i64, p, p, p]
    lib.sbt_roll_add.restype = i
    # (f64, V, I, J, N, tile, sites) as ops/batched_gemm.py picks them + b,
    # x, y, stream
    for name in ("sbt_batched_gemm_small", "sbt_batched_gemm_rowpack"):
        getattr(lib, name).argtypes = [i, i64, i, i, i, i, i] + [p] * 4
        getattr(lib, name).restype = i
    return lib
