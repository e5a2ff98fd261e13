#!/usr/bin/env python
"""Design variants of K2's 16-byte route (``csrc/permute.cu``) and of K1's
block-streaming kernel (``csrc/stencil_site.cu``), on one NVIDIA GPU.

    python tools/kernel_variants.py [--variants NAME ...] [--reps 15]

Builds each variant of ``VARIANTS`` (its source with design macros set by
-D) into ``_build/kernel_variants/``, all nvcc processes started together;
holds each bit for bit against the package's build (K2: against
``x.permute(perm).contiguous()`` on ragged, strided and the timed shapes;
K1: against the runtime-shape route on ragged lattices, full and packed);
then times the package's build and the variants of a kernel in turns with
CUDA events (medians of ``--reps``), each through its C entry with the same
arguments:

- K2 at 128x64x64x128 f32, perm (3,2,1,0) and (3,1,2,0);
- K1 at (1,1,12,12), one centre direction, f32, 8 columns, on 24^3x48 and
  16^3x32.

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
#: K1: 2 stages, 4 column groups, 3 blocks an SM)
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
}
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
    err = (lib.sbt_permute_4d_vec_attrs(out) if family == "k2"
           else lib.sbt_stencil_site_attrs(0, 1, 8, out))
    if err:
        raise RuntimeError(f"attributes: cudaError {err}")
    return list(out)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", nargs="*", default=list(VARIANTS))
    parser.add_argument("--reps", type=int, default=15)
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
    for family, src in (("k2", "permute.cu"), ("site", "stencil_site.cu")):
        names = ["package"] + [n for n in args.variants if VARIANTS[n][0] == src]
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
