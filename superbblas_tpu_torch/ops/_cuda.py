"""Build and load the package's CUDA kernels.

The sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a``, one
``nvcc`` process per source, all started together, and linked into one
shared library with a plain C interface, at first use, into
``_build/<hash of the sources>/``, and loaded with ``ctypes``; each build
counts in the tracker's ``kernels.builds``.  Nothing is
built or loaded at import, so the package imports on machines without
CUDA; on a machine with a card but no ``nvcc`` the build raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from ..utils import tracker

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD = _PKG / "_build"
SOURCES = ("stencil_soa.cu", "stencil_rt.cu", "stencil_tiled.cu", "stencil_site.cu",
           "stencil_schedules.cu", "permute.cu", "batched_gemm.cu", "roll_add.cu")
#: headers the sources include (part of the build's hash)
HEADERS = ("stencil_soa.cuh", "stencil_plan.cuh", "kernel_common.cuh")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")


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


def on_device(dev):
    """A context that makes ``dev`` current for a launch: a no-op where it
    is current already (entering ``torch.cuda.device`` costs microseconds
    of host time a launch)."""
    import torch

    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built from ``csrc/`` if needed."""
    out = BUILD / _digest() / "libsbt_kernels.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
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
        tracker.count("kernels.builds")
    lib = ctypes.CDLL(str(out))
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # (ki, kd, bi, bd, type pair, b, kron, x, y re/im pointers, n, X, Y, Z, T,
    #  ndir, offsets) + each kernel's own trailing ints + stream
    head = [i] * 5 + [p] * 8 + [i] * 6 + [p]
    # (the runtime-shape route's trailing ints: parity and the tile S, C, R,
    # D, stages)
    for name, extra in (("sbt_stencil_soa", [i]), ("sbt_stencil_soa_rt", [i] * 6),
                        ("sbt_stencil_site", [i, i])):
        getattr(lib, name).argtypes = head + extra + [p]
        getattr(lib, name).restype = i
    # the schedules: the plan's pointer before the kron's two; sparse form,
    # the tile (S, C, rs or S, R, C, rs) and the copy form
    sched = [i] * 5 + [p] * 9 + [i] * 6 + [p]
    lib.sbt_stencil_soa_xin.argtypes = sched + [i] * 5 + [p]
    lib.sbt_stencil_soa_stream.argtypes = sched + [i] * 6 + [p]
    lib.sbt_stencil_soa_xin.restype = lib.sbt_stencil_soa_stream.restype = i
    # (stream, ki, kd, bi, bd, pair, sparse, n, X, S, R, C, rs, out[4])
    lib.sbt_stencil_schedule_attrs.argtypes = [i] * 13 + [p]
    lib.sbt_stencil_schedule_attrs.restype = i
    # the tiled route: one plan pointer for the kron's two; parity, sparse
    # form, yc
    lib.sbt_stencil_tiled.argtypes = [i] * 5 + [p] * 7 + [i] * 6 + [p, i, i, i, p]
    lib.sbt_stencil_tiled.restype = i
    # (ki, kd, bi, bd, pair, sparse, n, X, Y, Z, T, yc, out[4])
    lib.sbt_stencil_tiled_attrs.argtypes = [i] * 12 + [p]
    lib.sbt_stencil_tiled_attrs.restype = i
    # (ki, kd, bi, bd, pair, ndir, S, C, R, D, stages, out[4])
    lib.sbt_stencil_soa_rt_attrs.argtypes = [i] * 11 + [p]
    lib.sbt_stencil_soa_rt_attrs.restype = i
    # (pair, wide, n, out[4])
    lib.sbt_stencil_site_attrs.argtypes = [i, i, i, p]
    lib.sbt_stencil_site_attrs.restype = i
    for name in ("sbt_permute_4d", "sbt_permute_4d_vec"):
        getattr(lib, name).argtypes = [i, i64, i64, i64, i64, i64, i64, i64, i64, p, p, p]
        getattr(lib, name).restype = i
    lib.sbt_permute_4d_vec_attrs.argtypes = [p]
    lib.sbt_permute_4d_vec_attrs.restype = i
    # (form, EX, ET, stages, threads, mid_swap, X, Y, Z, T, strides) + in, out,
    # stream
    lib.sbt_permute_4d_tiled.argtypes = [i] * 6 + [i64] * 8 + [p, p, p]
    lib.sbt_permute_4d_tiled.restype = i
    lib.sbt_roll_add.argtypes = [i, i, i64, i64, p, p, i, p]
    lib.sbt_roll_add.restype = i
    # (f64, V, I, J, N, tile, sites) as ops/batched_gemm.py picks them + b,
    # x, y, stream
    for name in ("sbt_batched_gemm_small", "sbt_batched_gemm_rowpack"):
        getattr(lib, name).argtypes = [i, i64, i, i, i, i, i] + [p] * 4
        getattr(lib, name).restype = i
    return lib
