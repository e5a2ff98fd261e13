#!/usr/bin/env python
"""Ablation of the stencil kernel K1's design at the Wilson and staggered
shapes, on one NVIDIA GPU.

    python tools/k1_ablation.py [--lat 32 32 32 64] [--cols 8] [--reps 15]

Times, in turns with CUDA events (medians), one matvec at the given
lattice and column count (f32 blocks and fields) of:

- ``pr1``: the PR 1 design (stencil_soa.cu's templated kernel, built from
  ``tools/k1_ablation.cu``): a thread a (site, column), 64-bit
  coordinates, the spin factors as runtime values on all four slots;
- the tiled kernel (``csrc/stencil_tiled.cu``) with a plan that runs every
  direction direct (``direct``, no projection), with the factored plan in
  the dense form (``dense``) and in the sparse form (``sparse``, what
  ``stencil_matvec_soa`` launches), each with the blocks in flat X-major
  order (``natural``: yc = Y) and in the order ``x_chunk`` picks
  (``chunked``); and the sparse form at every divisor yc of Y;
- at the staggered shape (no kron): ``pr1`` and the tiled kernel,
  natural and chunked;
- with ``--sass``, the opcode counts of the tiled kernel's f32 forms
  (``cuobjdump -sass`` of the package's library);
- with ``--variants [NAME ...]``, builds with design macros set by -D
  (``VARIANTS``) of ``tools/k1_variants.cu`` (the kernel that stages x
  and the links in shared memory and walks X, the links staged in shared
  memory, direction d + 1's loads before d's sums) or of
  ``csrc/stencil_tiled.cu`` (blocks an SM, column groups a block, columns
  a thread, the links' prefetch, the direction loop's unroll, streaming
  link loads), into ``_build/k1_ablation/``; each is first held bit for bit against the
  package's build on small ragged lattices (every type pair, plan form
  and packed parity), then timed at both shapes in turns with it.

Each variant is first held against the plain version (relative 1e-5).
Prints the registers, local bytes and resident blocks an SM of each
kernel (``cudaFuncGetAttributes``, ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``)
and nvcc's ``-Xptxas -v`` lines for the tiled kernel, the card's name and
power limit, and writes the results to ``chiprun_out/k1_ablation.json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from superbblas_tpu_torch.cplx import CArray  # noqa: E402
from superbblas_tpu_torch.models import wilson as W  # noqa: E402
from superbblas_tpu_torch.ops import _cuda  # noqa: E402
from superbblas_tpu_torch.ops import stencil as S  # noqa: E402

OFFSETS = tuple(tuple(o) for o in W.wilson_offsets(4))
#: variants of K1's tiled route: the macros each build sets with -D; those
#: with SBT_K1_VARIANT build tools/k1_variants.cu (1: the X-walk kernel
#: staging x and the links, 2: links staged, 3: pipelined loads, 4: 2 and
#: 3; diag_*: diagnostics of another function, timed only), the others
#: csrc/stencil_tiled.cu itself (the package builds its defaults)
VARIANTS = {
    "stage": {"SBT_K1_VARIANT": 1},
    "stage_cg4": {"SBT_K1_VARIANT": 1, "SBT_K1_COL_GROUPS": 4},
    "lsmem": {"SBT_K1_VARIANT": 2},
    "pipe": {"SBT_K1_VARIANT": 3},
    "lsmem_pipe": {"SBT_K1_VARIANT": 4},
    "diag_xlocal": {"SBT_K1_VARIANT": 5},
    "diag_links1": {"SBT_K1_VARIANT": 6},
    "diag_both": {"SBT_K1_VARIANT": 7},
    "min3": {"SBT_K1_MINB_W": 3},
    "s_min2": {"SBT_K1_MINB_W": 2, "SBT_K1_MINB_S": 2},
    "cg4": {"SBT_K1_COL_GROUPS": 4},
    "cg2": {"SBT_K1_COL_GROUPS": 2},
    "cg1": {"SBT_K1_COL_GROUPS": 1},
    "s_cols1": {"SBT_K1_STAG_COLS": 1},
    "s_cols4": {"SBT_K1_STAG_COLS": 4},
    "w_prefetch": {"SBT_K1_PREFETCH": 1},
    "no_prefetch": {"SBT_K1_PREFETCH": 0},
    "unroll1": {"SBT_K1_UNROLL_W": 1},
    "s_unroll2": {"SBT_K1_UNROLL_S": 2},
    "first_round": {"SBT_K1_UNROLL_W": 1, "SBT_K1_PREFETCH": 1},
    "ldcs": {"SBT_K1_LDCS": 1},
}
#: the data sheet's HBM rate of the H100 SXM (the bytes bound)
HBM_BYTES_PER_S = 3.35e12


def build_pr1() -> ctypes.CDLL:
    """tools/k1_ablation.cu as its own library."""
    out = _cuda.BUILD / "k1_ablation" / "libk1_pr1.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-shared", "-o", str(out),
                    str(ROOT / "tools" / "k1_ablation.cu")], check=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.sbt_k1_pr1.argtypes = [i] * 5 + [p] * 8 + [i] * 6 + [p, i, p]
    lib.sbt_k1_pr1_attrs.argtypes = [i, p]
    return lib


def variant_source(name) -> Path:
    """The source a VARIANTS entry builds."""
    return ROOT / "tools" / "k1_variants.cu" if "SBT_K1_VARIANT" in VARIANTS[name] \
        else _cuda.CSRC / "stencil_tiled.cu"


def build_variants(names) -> dict:
    """One library a VARIANTS entry in ``names``, built from its source
    with its -D macros into _build/k1_ablation/, in parallel; {name:
    CDLL}."""
    out = _cuda.BUILD / "k1_ablation"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        defs = [f"-D{k}={v}" for k, v in VARIANTS[name].items()]
        procs[name] = subprocess.Popen(
            [_cuda._nvcc(), *_cuda.NVCC_FLAGS, *defs, "-shared", "-o", str(out / f"{name}.so"),
             str(variant_source(name))])
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        assert proc.wait() == 0, name
        lib = ctypes.CDLL(str(out / f"{name}.so"))
        lib.sbt_stencil_tiled.argtypes = [i] * 5 + [p] * 7 + [i] * 6 + [p, i, i, i, p]
        lib.sbt_stencil_tiled_attrs.argtypes = [i] * 12 + [p]
        libs[name] = lib
    return libs


def check_bits(libs) -> dict:
    """Whether every variant gives the package kernel's bits (the same sums
    in the same order) on small ragged lattices, at every type pair, plan
    form and packed parity: {variant: its first failing case}."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    failed = {}
    tm = W.twisted_mass_operator((2, 2, 2, 2), layout="soa", device="cuda")
    tm_offsets = [tuple(o) for o in tm.offsets]
    cases = [((3, 5, 6, 10), 3, OFFSETS, None), ((2, 4, 3, 8), 2, OFFSETS[1:], 0),
             ((3, 5, 4, 7), 1, OFFSETS[1:], 1), ((1, 3, 2, 5), 9, OFFSETS, None),
             ((2, 2, 4, 33), 5, OFFSETS, None), ((2, 4, 2, 48), 2, OFFSETS[1:], 1),
             ((4, 2, 2, 32), 17, OFFSETS, None), ((2, 3, 1, 64), 8, OFFSETS[1:], 0)]
    for lat, n, offs, parity in cases:
        keep = [tm_offsets.index(o) for o in offs]
        for st, ft in S.KERNEL_DTYPES:
            kdt = torch.float64 if ft == torch.float64 else torch.float32
            for kind in ("wilson", "random", "none", "dense"):
                def rnd(shape, dt):
                    return CArray(*(torch.randn(shape, generator=gen, device="cuda").to(dt)
                                    for _ in range(2)))
                ki = 1 if kind == "none" else 4
                blocks, x = rnd((len(offs), 9) + lat, st), rnd((n, 3 * ki) + lat, ft)
                if kind == "none":
                    table, sparse = None, 0
                else:
                    kron = rnd((len(offs), 4, 4), kdt) if kind == "random" else CArray(
                        tm.kron.re[keep].to(kdt).contiguous(),
                        tm.kron.im[keep].to(kdt).contiguous())
                    plan = S.spin_plan(kron, kdt)
                    table, sparse = plan.table.data_ptr(), int(plan.sparse and kind != "dense")
                yc = S.x_chunk(lat[1], lat[2], lat[3], 1 << 20)
                pp = -1 if parity is None else parity
                want = tiled_with(_cuda.library(), blocks, table, sparse, x, yc, ki, offs, pp)
                for name, lib in libs.items():
                    try:
                        got = tiled_with(lib, blocks, table, sparse, x, yc, ki, offs, pp)
                        same = all(torch.equal(g, w) for g, w in zip(got, want))
                    except AssertionError as e:
                        same = f"launch error {e}"
                    if same is not True:
                        failed.setdefault(name, (lat, n, parity, str(st), str(ft), kind, same))
    print(f"check bits: {len(libs)} variants, {len(cases)} lattices x 5 pairs x 4 forms; "
          f"failed: {failed}", flush=True)
    return failed


def tiled_with(lib, blocks, table, sparse, x, yc, ki, offsets=OFFSETS, parity=-1):
    """The tiled entry of a variant library ``lib``."""
    n, lat = x.shape[0], tuple(x.shape[2:])
    y = CArray(x.re.new_empty((n, 3 * ki) + lat), x.re.new_empty((n, 3 * ki) + lat))
    key = S._offsets_key(offsets)
    err = lib.sbt_stencil_tiled(ki, ki, 3, 3, S.KERNEL_DTYPES.index((blocks.dtype, x.dtype)),
                                blocks.re.data_ptr(), blocks.im.data_ptr(), table,
                                x.re.data_ptr(), x.im.data_ptr(), y.re.data_ptr(),
                                y.im.data_ptr(), n, *lat, len(key), S._offsets_array(key),
                                parity, sparse, yc, torch.cuda.current_stream().cuda_stream)
    assert err == 0, f"cudaError {err}"
    return y


def sass_counts() -> dict:
    """{kernel: {opcode: count}} of the f32/f32 tiled kernels in the
    package's library (cuobjdump -sass)."""
    tool = Path(_cuda._nvcc()).parent / "cuobjdump"
    lib = next(_cuda.BUILD.glob("*/libsbt_kernels.so"))
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    out, name, keep = {}, None, []
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1) if "stencil_tiled_kernel" in m.group(1) and "EffE" in m.group(1) \
                else None
            if name:
                out[name] = {}
            continue
        if name:
            keep.append(line)
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and m:
            op = m.group(1).split(".")[0]
            out[name][op] = out[name].get(op, 0) + 1
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "tiled_f32.sass").write_text("\n".join(keep))
    return out


def ptxas_report(name=None) -> list:
    """nvcc -Xptxas -v lines (registers, spills) of the tiled route's
    kernels: the package's, or VARIANTS entry ``name``'s."""
    defs = [] if name is None else [f"-D{k}={v}" for k, v in VARIANTS[name].items()]
    src = _cuda.CSRC / "stencil_tiled.cu" if name is None else variant_source(name)
    run = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, *defs, "-Xptxas", "-v", "-c", "-o",
                          os.devnull, str(src)],
                         capture_output=True, text=True, check=True)
    lines, name = [], None
    for line in run.stderr.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
        elif name and ("registers" in line or "spill" in line):
            lines.append(f"{name}: {line.strip()}")
    return lines


def direct_plan(kron: CArray) -> torch.Tensor:
    """The kernel's plan of ``kron`` with every direction direct."""
    K = kron.re.cpu().double().numpy() + 1j * kron.im.cpu().double().numpy()
    specs = tuple(("direct", tuple(tuple((s, float(K[d, a, s].real), float(K[d, a, s].imag))
                                         for s in range(K.shape[2]) if abs(K[d, a, s]) > 1e-12)
                                   for a in range(K.shape[1]))) for d in range(K.shape[0]))
    rec, sparse = S.kernel_plan(specs, K, torch.float32)
    assert not sparse
    return torch.from_numpy(rec.view(np.uint8).copy()).cuda()


def tiled(blocks, table, sparse, x, yc, ki):
    return S._launch("sbt_stencil_tiled", blocks, (table,), x, OFFSETS, 3, 3, ki, ki, -1,
                     sparse, yc)


def pr1(lib, blocks, kron, x, ki):
    n, lat = x.shape[0], tuple(x.shape[2:])
    y = CArray(x.re.new_empty((n, 3 * ki) + lat), x.re.new_empty((n, 3 * ki) + lat))
    key = S._offsets_key(OFFSETS)
    kp = (None, None) if kron is None else (kron.re.data_ptr(), kron.im.data_ptr())
    err = lib.sbt_k1_pr1(ki, ki, 3, 3, 0, blocks.re.data_ptr(), blocks.im.data_ptr(), *kp,
                         x.re.data_ptr(), x.im.data_ptr(), y.re.data_ptr(), y.im.data_ptr(),
                         n, *lat, len(key), S._offsets_array(key), -1,
                         torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return y


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


def attrs(ki, sparse, x, yc, lib=None):
    out = (ctypes.c_int * 4)()
    err = (lib or _cuda.library()).sbt_stencil_tiled_attrs(ki, ki, 3, 3, 0, sparse,
                                                           x.shape[0], *x.shape[2:], yc, out)
    assert err == 0, err
    return {"registers": out[0], "local_bytes": out[1], "threads": out[2],
            "blocks_per_sm": out[3]}


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lat", type=int, nargs=4, default=(32, 32, 32, 64))
    ap.add_argument("--cols", type=int, default=8)
    ap.add_argument("--reps", type=int, default=15)
    ap.add_argument("--variants", nargs="*", default=None,
                    help="also build, check and time these VARIANTS (none named: all)")
    ap.add_argument("--sass", action="store_true",
                    help="also print the opcode counts of the f32 tiled kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("k1_ablation.py needs an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    lat, n = tuple(args.lat), args.cols
    lib = build_pr1()
    names = [] if args.variants is None else (args.variants or list(VARIANTS))
    variants = build_variants(names)
    _cuda.library()
    diags = {k: variants.pop(k) for k in list(variants) if k.startswith("diag_")}
    if variants:
        for name in check_bits(variants):
            print(f"variant {name} dropped: not the package's bits", flush=True)
            del variants[name]
    if args.sass:
        for name, ops in sass_counts().items():
            top = sorted(ops.items(), key=lambda kv: -kv[1])
            print(f"sass {name}: {sum(ops.values())} instructions: "
                  + ", ".join(f"{k} {v}" for k, v in top), flush=True)
    report = ptxas_report()
    if "stage" in variants:
        report += ["stage " + line for line in ptxas_report("stage")]
    for line in report:
        print("ptxas", line, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(shape):
        return CArray(*(torch.randn(shape, generator=gen, device="cuda") for _ in range(2)))

    kron = W.wilson_operator((2, 2, 2, 2), layout="soa", device="cuda").kron
    plan = S.spin_plan(kron, torch.float32)
    assert plan.sparse
    dplan = direct_plan(kron)
    ychunk = S.x_chunk(lat[1], lat[2], lat[3],
                       2 * (9 * 9 * 4 + n * 24 * 4))
    out = {"device": smi, "lat": lat, "cols": n, "yc": ychunk, "ptxas": report}

    blocks, x = rnd((9, 9) + lat), rnd((n, 12) + lat)
    V = int(np.prod(lat))
    nbytes = 2 * 4 * V * (81 + n * 24)
    wilson = {
        "pr1": lambda: pr1(lib, blocks, kron, x, 4),
        "direct_natural": lambda: tiled(blocks, dplan.data_ptr(), 0, x, lat[1], 4),
        "direct_chunked": lambda: tiled(blocks, dplan.data_ptr(), 0, x, ychunk, 4),
        "dense_natural": lambda: tiled(blocks, plan.table.data_ptr(), 0, x, lat[1], 4),
        "dense_chunked": lambda: tiled(blocks, plan.table.data_ptr(), 0, x, ychunk, 4),
        "sparse_natural": lambda: tiled(blocks, plan.table.data_ptr(), 1, x, lat[1], 4),
        "sparse_chunked": lambda: tiled(blocks, plan.table.data_ptr(), 1, x, ychunk, 4),
    }
    for yc in range(1, lat[1] + 1):
        if lat[1] % yc == 0 and yc != ychunk and yc != lat[1]:
            wilson[f"sparse_yc{yc}"] = (lambda yc=yc: tiled(blocks, plan.table.data_ptr(), 1,
                                                            x, yc, 4))
    for name, vlib in variants.items():
        wilson[f"variant_{name}"] = (lambda vlib=vlib: tiled_with(
            vlib, blocks, plan.table.data_ptr(), 1, x, ychunk, 4))
    want = S.stencil_matvec_soa_reference(blocks, kron, x, OFFSETS, 3, 3)
    scale = max(float(w.abs().max()) for w in want)
    for name, fn in wilson.items():
        got = fn()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        print(f"check wilson {name}: rel {err / scale:.3e}", flush=True)
        assert err <= 1e-5 * scale, name
    del want
    for name, vlib in diags.items():
        wilson[name] = (lambda vlib=vlib: tiled_with(vlib, blocks, plan.table.data_ptr(), 1, x,
                                                     ychunk, 4))
    ms = time_turns(wilson, args.reps)
    pr1_attrs = (ctypes.c_int * 3)()
    lib.sbt_k1_pr1_attrs(4, pr1_attrs)
    out["wilson"] = {"ms": ms, "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                     "attrs": {"pr1": list(pr1_attrs),
                               "sparse": attrs(4, 1, x, ychunk),
                               "dense": attrs(4, 0, x, ychunk),
                               **{f"variant_{k}": attrs(4, 1, x, ychunk, v)
                                  for k, v in variants.items()}}}
    for k, v in ms.items():
        print(f"wilson {lat} n={n} {k}: {v:.4f} ms ({nbytes / v / 1e6:.1f} GB/s)", flush=True)
    print(f"wilson attrs {out['wilson']['attrs']}", flush=True)
    del blocks, x

    blocks, x = rnd((9, 9) + lat), rnd((n, 3) + lat)
    nbytes = 2 * 4 * V * (81 + n * 6)
    syc = S.x_chunk(lat[1], lat[2], lat[3], 2 * (81 * 4 + n * 6 * 4))
    stag = {"pr1": lambda: pr1(lib, blocks, None, x, 1),
            "natural": lambda: tiled(blocks, None, 0, x, lat[1], 1),
            "chunked": lambda: tiled(blocks, None, 0, x, syc, 1)}
    for name, vlib in variants.items():
        stag[f"variant_{name}"] = (lambda vlib=vlib: tiled_with(vlib, blocks, None, 0, x,
                                                                syc, 1))
    want = S.stencil_matvec_soa_reference(blocks, None, x, OFFSETS, 3, 3)
    scale = max(float(w.abs().max()) for w in want)
    for name, fn in stag.items():
        got = fn()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        print(f"check staggered {name}: rel {err / scale:.3e}", flush=True)
        assert err <= 1e-5 * scale, name
    for name, vlib in diags.items():
        stag[name] = (lambda vlib=vlib: tiled_with(vlib, blocks, None, 0, x, syc, 1))
    ms = time_turns(stag, args.reps)
    lib.sbt_k1_pr1_attrs(1, pr1_attrs)
    out["staggered"] = {"ms": ms, "bytes_bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                        "attrs": {"pr1": list(pr1_attrs), "tiled": attrs(1, 0, x, lat[1]),
                                  **{f"variant_{k}": attrs(1, 0, x, syc, v)
                                     for k, v in variants.items()}}}
    for k, v in ms.items():
        print(f"staggered {lat} n={n} {k}: {v:.4f} ms ({nbytes / v / 1e6:.1f} GB/s)",
              flush=True)
    print(f"staggered attrs {out['staggered']['attrs']}", flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "k1_ablation.json").write_text(json.dumps(out, indent=1))
    print(json.dumps({k: out[k] for k in ("wilson", "staggered")}))


if __name__ == "__main__":
    main()
