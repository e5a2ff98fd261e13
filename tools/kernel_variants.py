#!/usr/bin/env python
"""Design variants of K2's 16-byte route (``csrc/permute.cu``), of K1's
block-streaming kernel (``csrc/stencil_site.cu``) and runtime-shape route
(``csrc/stencil_rt.cu``) and of the stencil's X-inside and X-streaming
schedules (``csrc/stencil_schedules.cu``), on one NVIDIA GPU.

    python tools/kernel_variants.py [--variants NAME ...] [--reps 15]

Builds each variant of ``VARIANTS`` (its source with design macros set by
-D) into ``_build/kernel_variants/``, all nvcc processes started together;
holds each bit for bit against the package's build (K2: against
``x.permute(perm).contiguous()`` on ragged, strided and the timed shapes;
K1: against the runtime-shape route on ragged lattices, full and packed;
the schedules: against K1's tiled route on ragged lattices); then times
the package's build and the variants of a kernel in turns with CUDA events
(medians of ``--reps``), each through its C entry with the same arguments:

- K2 at 128x64x64x128 f32, perm (3,2,1,0) and (3,1,2,0);
- K1 at (1,1,12,12), one centre direction, f32, 8 columns, on 24^3x48 and
  16^3x32;
- K1's runtime-shape route at (2,2,3,3), (1,1,2,2), (2,1,4,2), (2,2,8,8)
  and (1,1,16,16) on 16^3x32 x 8 f32, 9 directions, each build at the tile
  of ``rt_tile`` and the package's build also at the tiles of ``RT_TILES``;
- the schedules at 32^3x64 x 8 f32, Wilson (4,4,3,3) with the Wilson spin
  factors (sparse plan) and staggered (1,1,3,3), beside K1's tiled route
  at its C entry, each build with its picker's tile and with the tiles
  of ``SCHED_TILES``.

Prints each build's registers, local bytes, threads and resident blocks an
SM, the card's name and power limit, and as its last line one JSON object
of the medians and attributes.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from superbblas_tpu_torch.cplx import CArray  # noqa: E402
from superbblas_tpu_torch.ops import _cuda  # noqa: E402
from superbblas_tpu_torch.ops import stencil as S  # noqa: E402
from superbblas_tpu_torch.ops.permute import SUPPORTED, permute_4d_reference  # noqa: E402

#: name -> (source, -D macros); the package's own design is the default of
#: each macro (K2: 64 X rows x 128 T words a tile, 3 stages, 256 threads;
#: K1: 2 stages, 4 column groups, 3 blocks an SM; the schedules: a tile's
#: sites on adjacent lanes, K4a in blocks of 512 threads walking two column
#: groups, K4b's links prefetched, no unroll)
VARIANTS = {
    "k2_64x64_s3": ("permute.cu", {"SBT_K2_ET": 64}),
    "k2_64x64_s4": ("permute.cu", {"SBT_K2_ET": 64, "SBT_K2_STAGES": 4}),
    "k2_128x64_s3": ("permute.cu", {"SBT_K2_EX": 128, "SBT_K2_ET": 64}),
    "k2_128x128_s2_t512": ("permute.cu", {"SBT_K2_EX": 128, "SBT_K2_STAGES": 2,
                                          "SBT_K2_THREADS": 512}),
    "k2_32x128_s4": ("permute.cu", {"SBT_K2_EX": 32, "SBT_K2_STAGES": 4}),
    "k2_64x64_s3_t128": ("permute.cu", {"SBT_K2_ET": 64, "SBT_K2_THREADS": 128}),
    "site_s3": ("stencil_site.cu", {"SBT_SITE_STAGES": 3, "SBT_SITE_MIN_BLOCKS": 2}),
    "site_s4_g2": ("stencil_site.cu", {"SBT_SITE_STAGES": 4, "SBT_SITE_GROUPS": 2,
                                       "SBT_SITE_MIN_BLOCKS": 2}),
    "rt_minb1": ("stencil_rt.cu", {"SBT_RT_MIN_BLOCKS": 1}),
    "rt_minb4": ("stencil_rt.cu", {"SBT_RT_MIN_BLOCKS": 4}),
    "rt_minb3": ("stencil_rt.cu", {"SBT_RT_MIN_BLOCKS": 3}),
    "rt_t512": ("stencil_rt.cu", {"SBT_RT_THREADS": 512, "SBT_RT_MIN_BLOCKS": 1}),
    # ablations (wrong results; timed, not checked): no sums, no copies, no
    # copies of x, no copies of the blocks; no sums and the blocks' copies
    # alone, x's alone, none
    "rt_nomath": ("stencil_rt.cu", {"SBT_RT_ABLATE": 1}),
    "rt_nocopy": ("stencil_rt.cu", {"SBT_RT_ABLATE": 2}),
    "rt_nox": ("stencil_rt.cu", {"SBT_RT_ABLATE": 3}),
    "rt_noblocks": ("stencil_rt.cu", {"SBT_RT_ABLATE": 4}),
    "rt_blocks_only": ("stencil_rt.cu", {"SBT_RT_ABLATE": 5}),
    "rt_x_only": ("stencil_rt.cu", {"SBT_RT_ABLATE": 6}),
    "rt_skeleton": ("stencil_rt.cu", {"SBT_RT_ABLATE": 7}),
    "sched_unroll2": ("stencil_schedules.cu", {"SBT_SCHED_UNROLL": 2}),
    "sched_cols_fastest": ("stencil_schedules.cu", {"SBT_SCHED_COLS_FASTEST": 1}),
    "sched_stream_pf0": ("stencil_schedules.cu", {"SBT_STREAM_PREFETCH": 0}),
    "sched_xin_t256": ("stencil_schedules.cu", {"SBT_XIN_THREADS": 256}),
    "sched_xin_groups_all": ("stencil_schedules.cu", {"SBT_XIN_GROUPS": 0}),
    "sched_xin_groups4": ("stencil_schedules.cu", {"SBT_XIN_GROUPS": 4}),
    "sched_stream_t256": ("stencil_schedules.cu", {"SBT_STREAM_THREADS": 256}),
}
#: tiles of the schedules timed on the package's build beside its
#: pickers': (schedule, label) -> (S, C) of X-inside, (S, R, C) of
#: X-streaming
SCHED_TILES = {("xin", "S16_C1"): (16, 1), ("xin", "S16_C2"): (16, 2), ("xin", "S8_C4"): (8, 4),
               ("stream", "S32_R2_C2"): (32, 2, 2), ("stream", "S32_R1_C8"): (32, 1, 8),
               ("stream", "S32_R2_C4"): (32, 2, 4)}
#: tiles of the runtime-shape route timed on the package's build beside
#: its picker's: each overrides some of the picker's (S, C, R, D, stages),
#: and is timed where it launches (``rt_fits``); the rt_t512 build is timed
#: also at 32 sites x 8 columns (512 threads at G = 2)
RT_TILES = {"D1_s2": {"D": 1, "stages": 2}, "D1_s3": {"D": 1, "stages": 3},
            "D2_s2": {"D": 2, "stages": 2}, "D2_s3": {"D": 2, "stages": 3},
            "D1_s4": {"D": 1, "stages": 4},
            "D3_s4": {"D": 3, "stages": 4}, "D9_s2": {"D": 9, "stages": 2},
            "S16_C8": {"S": 16, "C": 8}, "S32_C4": {"S": 32, "C": 4},
            "S8_C8": {"S": 8, "C": 8}, "R4": {"R": 4}, "R8": {"R": 8}, "R16": {"R": 16},
            "S16": {"S": 16}, "S32": {"S": 32}, "s3": {"stages": 3}, "s4": {"stages": 4},
            "D9_s3": {"D": 9, "stages": 3}}
RT_SHAPES = ((2, 2, 3, 3), (1, 1, 2, 2), (2, 1, 4, 2), (2, 2, 8, 8), (1, 1, 16, 16))
RT_LAT = (16, 16, 16, 32)
SCHED_LAT = (32, 32, 32, 64)
K2_SHAPE = (128, 64, 64, 128)
CLOVER_LATS = ((24, 24, 24, 48), (16, 16, 16, 32))
OUT = ROOT / "superbblas_tpu_torch" / "_build" / "kernel_variants"


def build(names) -> dict:
    """{name: CDLL} of the variants, built in parallel."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        src, defs = VARIANTS[name]
        cmd = [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *(f"-D{k}={v}" for k, v in defs.items()),
               "-I", str(_cuda.CSRC), "-shared", "-o", str(OUT / f"{name}.so"),
               str(_cuda.CSRC / src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"build of {name} failed:\n{out}\n{err}")
        lib = ctypes.CDLL(str(OUT / f"{name}.so"))
        declare(lib)
        libs[name] = lib
    return libs


def declare(lib) -> None:
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    if hasattr(lib, "sbt_permute_4d_vec"):
        lib.sbt_permute_4d_vec.argtypes = [i] + [i64] * 8 + [p, p, p]
        lib.sbt_permute_4d_vec_attrs.argtypes = [p]
    if hasattr(lib, "sbt_stencil_site"):
        lib.sbt_stencil_site.argtypes = [i] * 5 + [p] * 8 + [i] * 6 + [p, i, i, p]
        lib.sbt_stencil_site_attrs.argtypes = [i, i, i, p]
    if hasattr(lib, "sbt_stencil_soa_rt"):
        lib.sbt_stencil_soa_rt.argtypes = [i] * 5 + [p] * 8 + [i] * 6 + [p] + [i] * 6 + [p]
        lib.sbt_stencil_soa_rt_attrs.argtypes = [i] * 11 + [p]
    if hasattr(lib, "sbt_stencil_soa_xin"):
        lib.sbt_stencil_soa_xin.argtypes = [i] * 5 + [p] * 9 + [i] * 6 + [p] + [i] * 5 + [p]
        lib.sbt_stencil_soa_stream.argtypes = [i] * 5 + [p] * 9 + [i] * 6 + [p] + [i] * 6 + [p]
        lib.sbt_stencil_schedule_attrs.argtypes = [i] * 13 + [p]


def k2_call(lib, x, perm):
    out = torch.empty(tuple(x.shape[p] for p in perm), dtype=x.dtype, device=x.device)

    def run():
        err = lib.sbt_permute_4d_vec(int(SUPPORTED[perm]), *x.shape, *x.stride(),
                                     x.data_ptr(), out.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"sbt_permute_4d_vec: cudaError {err}")
        return out
    return run


def site_call(lib, blocks, x, offsets, parity=-1):
    n, lat = x.re.shape[0], tuple(x.re.shape[2:])
    y = CArray(torch.empty((n, 12) + lat, device=x.re.device),
               torch.empty((n, 12) + lat, device=x.re.device))
    flat = [v for off in offsets for v in off]
    offs = (ctypes.c_int * len(flat))(*flat)
    wide = int(S.k1_route(S.SITE_SHAPE, blocks.dtype, x.dtype, x.re[0, 0].numel(),
                          (blocks.re.data_ptr(), blocks.im.data_ptr())) == "site16")

    def run():
        err = lib.sbt_stencil_site(1, 1, 12, 12, 0, blocks.re.data_ptr(), blocks.im.data_ptr(),
                                   None, None, x.re.data_ptr(), x.im.data_ptr(),
                                   y.re.data_ptr(), y.im.data_ptr(), n, *lat, len(offsets),
                                   offs, parity, wide, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"sbt_stencil_site: cudaError {err}")
        return y
    return run


def rt_call(lib, blocks, kron, x, offsets, tile=None, parity=-1):
    """A call of the runtime-shape route's C entry of ``lib`` (f32) at the
    picker's tile or ``tile`` (S, C, R)."""
    n, F, lat = x.re.shape[0], x.re.shape[1], tuple(x.re.shape[2:])
    ki, kd = (1, 1) if kron is None else tuple(kron.re.shape[1:])
    bd = F // kd
    bi = blocks.re.shape[1] // bd
    y = CArray(torch.empty((n, ki * bi) + lat, device=x.re.device),
               torch.empty((n, ki * bi) + lat, device=x.re.device))
    flat = [v for off in offsets for v in off]
    offs = (ctypes.c_int * len(flat))(*flat)
    S_, C, R, D, stages = rt_args(ki, kd, bi, bd, n, len(offsets), tile)
    kp = (None, None) if kron is None else (kron.re.data_ptr(), kron.im.data_ptr())

    def run():
        err = lib.sbt_stencil_soa_rt(ki, kd, bi, bd, 0, blocks.re.data_ptr(),
                                     blocks.im.data_ptr(), *kp, x.re.data_ptr(), x.im.data_ptr(),
                                     y.re.data_ptr(), y.im.data_ptr(), n, *lat, len(offsets),
                                     offs, parity, S_, C, R, D, stages,
                                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"sbt_stencil_soa_rt at {(S_, C, R, D, stages)}: "
                               f"cudaError {err}")
        return y
    return run




def rt_args(ki, kd, bi, bd, n, ndir, tile=None):
    """(S, C, R, D, stages) of a call at f32: the picker's, with the
    overrides of ``tile`` (a dict), D clipped to ndir."""
    S_, C, R, _, D, stages = S.rt_tile(ki, kd, bi, bd, n, ndir, 4, 4)
    args = dict(S=S_, C=C, R=R, D=D, stages=stages) | (tile or {})
    args["D"] = min(args["D"], ndir)
    return tuple(args[k] for k in ("S", "C", "R", "D", "stages"))


def rt_fits(shape, tile, threads):
    """Whether the tile (overrides of the picker's) launches at f32, 9
    directions, 8 columns: its threads within ``threads``, its ring within
    a block's shared memory."""
    ki, kd, bi, bd = shape
    S_, C, R, D, stages = rt_args(ki, kd, bi, bd, 8, 9, tile)
    G = ki * -(-bi // R)   # the kernel's rowwise split, else R across rows
    G = G if G <= S.RT_ROW_THREADS else -(-ki * bi // R)
    return S.rt_threads(S_, C, G) <= threads and \
        S.rt_smem(ki, kd, bi, bd, 9, S_, C, D, stages, 4, 4) <= S.SMEM_BYTES


def rt_operands(shape, lat, n, gen, ndir=9):
    ki, kd, bi, bd = shape
    kron = randn_c((ndir, ki, kd), gen) if (ki, kd) != (1, 1) else None
    return randn_c((ndir, bi * bd) + lat, gen), kron, randn_c((n, kd * bd) + lat, gen)


def sched_tile(schedule, x, tile=None):
    """The tile arguments and the copy form of a schedule's launch on x:
    its picker's tile, or ``tile`` with its rows padded as the picker pads
    them."""
    n, F, X, Y, Z, T = x.re.shape
    elem = x.re.element_size()
    vec = 16 // elem
    if schedule == "xin":
        S_, C = tile or S.xin_tile(n, X, F, elem)[:2]
        args = (S_, C, S._row_stride(S_, elem))
        wide = S_ * elem % 16 == 0 and Y * Z * T * elem % 16 == 0
    else:
        S_, R, C = tile or S.stream_tile(n, Y * Z, T, F, elem)[:3]
        args = (S_, R, C, S._row_stride(S_ + vec, elem))
        wide = T % vec == 0 and S_ % vec == 0
    return args, int(wide)


def sched_call(lib, schedule, blocks, kron, x, offsets, tile=None):
    """A call of the schedule's C entry of ``lib`` on the operands (f32, the
    spin plan of ``kron`` at (4,4,3,3), no kron at (1,1,3,3))."""
    n, lat = x.re.shape[0], tuple(x.re.shape[2:])
    ki = 1 if kron is None else 4
    y = CArray(torch.empty((n, 3 * ki) + lat, device=x.re.device),
               torch.empty((n, 3 * ki) + lat, device=x.re.device))
    flat = [v for off in offsets for v in off]
    offs = (ctypes.c_int * len(flat))(*flat)
    plan = None if kron is None else S.spin_plan(kron, torch.float32)
    targs, wide = sched_tile(schedule, x, tile)
    fn = getattr(lib, f"sbt_stencil_soa_{schedule}")

    def run():
        err = fn(ki, ki, 3, 3, 0, blocks.re.data_ptr(), blocks.im.data_ptr(),
                 None if plan is None else plan.table.data_ptr(), None, None,
                 x.re.data_ptr(), x.im.data_ptr(), y.re.data_ptr(), y.im.data_ptr(), n, *lat,
                 len(offsets), offs, int(plan is not None and plan.sparse), *targs, wide,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"sbt_stencil_soa_{schedule}: cudaError {err}")
        return y
    return run


def tiled_call(blocks, kron, x, offsets):
    """A call of K1's tiled route at its C entry (the package's build)."""
    n, lat = x.re.shape[0], tuple(x.re.shape[2:])
    ki = 1 if kron is None else 4
    y = CArray(torch.empty((n, 3 * ki) + lat, device=x.re.device),
               torch.empty((n, 3 * ki) + lat, device=x.re.device))
    flat = [v for off in offsets for v in off]
    offs = (ctypes.c_int * len(flat))(*flat)
    plan = None if kron is None else S.spin_plan(kron, torch.float32)
    yc = S.x_chunk(*lat[1:], S.tiled_site_bytes(blocks, x, ki, 3))
    lib = _cuda.library()

    def run():
        err = lib.sbt_stencil_tiled(ki, ki, 3, 3, 0, blocks.re.data_ptr(), blocks.im.data_ptr(),
                                    None if plan is None else plan.table.data_ptr(),
                                    x.re.data_ptr(), x.im.data_ptr(), y.re.data_ptr(),
                                    y.im.data_ptr(), n, *lat, len(offsets), offs, -1,
                                    int(plan is not None and plan.sparse), yc,
                                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"sbt_stencil_tiled: cudaError {err}")
        return y
    return run


def wilson_kron():
    from superbblas_tpu_torch.models.wilson import wilson_operator

    return wilson_operator((2, 2, 2, 2), layout="soa", device="cuda").kron


def randn_c(shape, gen):
    return CArray(*(torch.randn(shape, generator=gen, device="cuda") for _ in range(2)))


def check(name, lib, gen) -> None:
    """Raise unless the variant gives the reference's bits."""
    if VARIANTS[name][0] == "permute.cu":
        big = torch.randn((72, 6, 7, 80), generator=gen, device="cuda")
        for v in (big, big[4:68, 1:5, 2:7, 8:72],
                  torch.randn((60, 3, 5, 68), generator=gen, device="cuda"),
                  torch.randn(K2_SHAPE, generator=gen, device="cuda")):
            for perm in SUPPORTED:
                got = k2_call(lib, v, perm)()
                torch.cuda.synchronize()
                if not torch.equal(got, permute_4d_reference(v, perm)):
                    raise AssertionError(f"{name}: {tuple(v.shape)} {perm} differs")
        return
    wilson = [(0, 0, 0, 0)] + [tuple(s if a == ax else 0 for a in range(4))
                               for ax in range(4) for s in (1, -1)]
    if "SBT_RT_ABLATE" in VARIANTS[name][1]:
        return
    if VARIANTS[name][0] == "stencil_rt.cu":
        tiles = [None] + ([{"S": 32, "C": 8, "R": 8}] if name == "rt_t512" else [])
        for shape in RT_SHAPES:
            for lat, n, offs, parity in (((3, 5, 6, 10), 9, wilson, -1),
                                         ((2, 4, 8, 32), 8, wilson, -1),
                                         ((3, 5, 4, 7), 3, wilson[1:], 1)):
                blocks, kron, x = rt_operands(shape, lat, n, gen, len(offs))
                want = S.stencil_matvec_soa_rt(blocks, kron, x, offs, shape[2], shape[3],
                                               packed_parity=None if parity < 0 else parity)
                for tile in tiles:
                    got = rt_call(lib, blocks, kron, x, offs, tile, parity)()
                    torch.cuda.synchronize()
                    if not all(torch.equal(g, w) for g, w in zip(got, want)):
                        raise AssertionError(f"{name}: {shape} {lat} n={n} tile {tile} differs "
                                             "from the package's runtime-shape route")
        return
    if VARIANTS[name][0] == "stencil_schedules.cu":
        for lat, n in (((3, 5, 6, 8), 8), ((2, 4, 3, 16), 3), ((32, 2, 2, 8), 8)):
            blocks = randn_c((9, 9) + lat, gen)
            for kron, F in ((wilson_kron(), 12), (None, 3)):
                x = randn_c((n, F) + lat, gen)
                want = S.stencil_matvec_soa(blocks, kron, x, wilson, 3, 3)
                for schedule in ("xin", "stream"):
                    got = sched_call(lib, schedule, blocks, kron, x, wilson)()
                    torch.cuda.synchronize()
                    if not all(torch.equal(g, w) for g, w in zip(got, want)):
                        raise AssertionError(f"{name} {schedule}: {lat} n={n} F={F} differs "
                                             "from K1's tiled route")
        return
    for lat, n, offs, parity in (((3, 5, 6, 10), 8, wilson, -1),
                                 ((3, 3, 3, 5), 9, wilson[:1], -1),
                                 ((2, 4, 4, 8), 8, wilson[:1], -1),
                                 ((3, 5, 4, 7), 3, wilson[1:], 1)):
        blocks, x = randn_c((len(offs), 144) + lat, gen), randn_c((n, 12) + lat, gen)
        got = site_call(lib, blocks, x, offs, parity)()
        want = S.stencil_matvec_soa_rt(blocks, None, x, offs, 12, 12,
                                       packed_parity=None if parity < 0 else parity)
        torch.cuda.synchronize()
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name}: {lat} n={n} differs from the runtime-shape route")


def wilson_offsets():
    return [(0, 0, 0, 0)] + [tuple(s if a == ax else 0 for a in range(4))
                             for ax in range(4) for s in (1, -1)]


def time_turns(fns, reps):
    for fn in fns.values():
        for _ in range(3):
            fn()
    names, times = list(fns), {k: [] for k in fns}
    for r in range(reps):
        for k in (names if r % 2 == 0 else names[::-1]):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fns[k]()
            e.record()
            e.synchronize()
            times[k].append(s.elapsed_time(e))
    return {k: statistics.median(v) for k, v in times.items()}


def attrs(lib, family) -> list:
    out = (ctypes.c_int * 4)()
    if family in ("xin", "stream"):
        x = CArray(*(torch.empty((8, 12) + SCHED_LAT, device="meta") for _ in range(2)))
        targs, _ = sched_tile(family, x)
        S_, C, rs = (targs[0], targs[1], targs[2]) if family == "xin" else (
            targs[0], targs[2], targs[3])
        R = 1 if family == "xin" else targs[1]
        err = lib.sbt_stencil_schedule_attrs(int(family == "stream"), 4, 4, 3, 3, 0, 1, 8,
                                             SCHED_LAT[0], S_, R, C, rs, out)
    else:
        err = (lib.sbt_permute_4d_vec_attrs(out) if family == "k2"
               else lib.sbt_stencil_site_attrs(0, 1, 8, out))
    if err:
        raise RuntimeError(f"attributes: cudaError {err}")
    return list(out)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", nargs="*", default=list(VARIANTS))
    parser.add_argument("--reps", type=int, default=15)
    parser.add_argument("--rt-tiles-on", nargs="*", default=[],
                        help="runtime-route variants also timed at every tile of RT_TILES")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("kernel_variants.py needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    libs = {"package": _cuda.library()} | build(args.variants)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    for name in args.variants:
        check(name, libs[name], gen)
    print(f"{len(args.variants)} variants equal to the reference bit for bit", flush=True)
    result = {"card": smi, "attrs": {}, "ms": {}}
    rt = ["package"] + [n for n in args.variants if VARIANTS[n][0] == "stencil_rt.cu"]
    if len(rt) > 1 or not args.variants:
        for shape in RT_SHAPES:
            blocks, kron, x = rt_operands(shape, RT_LAT, 8, gen)
            fns = {n: rt_call(libs[n], blocks, kron, x, wilson_offsets()) for n in rt}
            for tl, tile in RT_TILES.items():
                if rt_fits(shape, tile, S.RT_THREADS):
                    for n in rt:
                        if n == "package" or n in args.rt_tiles_on:
                            fns[f"{n} {tl}"] = rt_call(libs[n], blocks, kron, x,
                                                       wilson_offsets(), tile)
            t512 = {"S": 32, "C": 8, "R": 8}
            if "rt_t512" in rt and rt_fits(shape, t512, 512):
                fns["rt_t512 S32_C8_R8"] = rt_call(libs["rt_t512"], blocks, kron, x,
                                                   wilson_offsets(), t512)
            key = f"rt {shape} {RT_LAT} n=8"
            result["ms"][key] = time_turns(fns, args.reps)
            print(key, json.dumps(result["ms"][key]), flush=True)
            for n in rt:
                out = (ctypes.c_int * 4)()
                ki, kd, bi, bd = shape
                tile = rt_args(ki, kd, bi, bd, 8, 9)
                if libs[n].sbt_stencil_soa_rt_attrs(ki, kd, bi, bd, 0, 9, *tile, out):
                    raise RuntimeError(f"rt attributes of {n}")
                result["attrs"][f"rt {n} {shape}"] = list(out)
                print(f"rt {n} {shape} tile {tile}: registers, local bytes, threads, blocks "
                      f"an SM {list(out)}", flush=True)
            del blocks, kron, x
    sched = ["package"] + [n for n in args.variants
                           if VARIANTS[n][0] == "stencil_schedules.cu"]
    if len(sched) == 1 and args.variants and len(rt) > 1:
        sched = []   # only runtime-route variants named
    for n in sched:
        for family in ("xin", "stream"):
            result["attrs"][f"{family} {n}"] = attrs(libs[n], family)
            print(f"{family} {n}: registers, local bytes, threads, blocks an SM "
                  f"{result['attrs'][f'{family} {n}']}", flush=True)
    blocks = randn_c((9, 9) + SCHED_LAT, gen)
    for label, kron, F in (("wilson", wilson_kron(), 12), ("staggered", None, 3)) if sched else ():
        x = randn_c((8, F) + SCHED_LAT, gen)
        fns = {"k1 tiled": tiled_call(blocks, kron, x, wilson_offsets())}
        for n in sched:
            for schedule in ("xin", "stream"):
                fns[f"{schedule} {n}"] = sched_call(libs[n], schedule, blocks, kron, x,
                                                    wilson_offsets())
            for (schedule, tl), tile in SCHED_TILES.items():
                fns[f"{schedule} {n} {tl}"] = sched_call(libs[n], schedule, blocks, kron, x,
                                                         wilson_offsets(), tile)
        key = f"schedules {label} {SCHED_LAT} n=8"
        result["ms"][key] = time_turns(fns, args.reps)
        print(key, json.dumps(result["ms"][key]), flush=True)
        del x
    del blocks
    for family, src in (("k2", "permute.cu"), ("site", "stencil_site.cu")):
        names = ["package"] + [n for n in args.variants if VARIANTS[n][0] == src]
        if len(names) == 1 and len(args.variants) and set(args.variants) <= set(sched) | set(rt):
            continue
        for n in names:
            result["attrs"][f"{family} {n}"] = attrs(libs[n], family)
            print(f"{family} {n}: registers, local bytes, threads, blocks an SM "
                  f"{result['attrs'][f'{family} {n}']}", flush=True)
        if family == "k2":
            x = torch.randn(K2_SHAPE, generator=gen, device="cuda")
            for perm in SUPPORTED:
                key = f"k2 {K2_SHAPE} {perm}"
                result["ms"][key] = time_turns({n: k2_call(libs[n], x, perm) for n in names},
                                               args.reps)
                print(key, json.dumps(result["ms"][key]), flush=True)
            del x
        else:
            for lat in CLOVER_LATS:
                blocks, x = randn_c((1, 144) + lat, gen), randn_c((8, 12) + lat, gen)
                key = f"site {lat} n=8"
                result["ms"][key] = time_turns(
                    {n: site_call(libs[n], blocks, x, [(0, 0, 0, 0)]) for n in names},
                    args.reps)
                print(key, json.dumps(result["ms"][key]), flush=True)
                del blocks, x
    print(smi)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
