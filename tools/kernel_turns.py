"""Time the clover term's K1, the permute kernel K2, the stencil's
X-inside and X-streaming schedules beside K1, K1's runtime-shape route,
the transpose tile sweep E3, the bf16 roll-plus-add E2 and the gather
applies (with K3 at the kron gather's colour stage), CG's fused updates
and the domain-wall s5 pass of two or more checkouts of the port in
turns, on one card.

    python tools/kernel_turns.py [--trees DIR ...] [--rounds N] [--reps R] [--no-solve]
                                 [--only clover permute schedules runtime sweep e2 gather
                                         host cg_update dw_s5]

Each tree (a directory holding ``superbblas_tpu_torch/``; default: this
checkout) is run in a process of its own, which builds that tree's kernels
into its own ``_build/`` and imports nothing of the others.  The trees run
in turns, A B ... B A, ``--rounds`` times over, and each process prints one
JSON line of CUDA-event medians (``--reps`` calls after three warm-up
calls), ms:

- ``clover_24`` and ``clover_16``: ``stencil_matvec_soa`` at (1, 1, 12, 12),
  one centre direction, no kron, f32 blocks and fields from a seeded card
  generator, 8 columns on 24x24x24x48 (the clover solve's term) and
  16x16x16x32;
- ``permute_tzyx``, ``permute_tyzx``: ``permute_4d`` of a 128x64x64x128
  f32 tensor;
- ``k1_wilson``, ``xin_wilson``, ``stream_wilson``: ``stencil_matvec_soa``
  (its tiled route), ``stencil_matvec_soa_xin`` and
  ``stencil_matvec_soa_stream`` at (4, 4, 3, 3) on 32x32x32x64 x 8 f32,
  the 9 Wilson directions, blocks from a seeded card generator and the
  Wilson operator's spin factors (the sparse spin plan); ``k1_staggered``,
  ``xin_staggered``, ``stream_staggered``: the same at (1, 1, 3, 3) without
  a kron;
- ``rt_KIKDBIBD``: ``stencil_matvec_soa_rt`` at (2,2,3,3), (1,1,2,2),
  (2,1,4,2), (2,2,8,8) and (1,1,16,16) on 16x16x16x32 x 8 f32, the 9
  Wilson directions, random blocks and spin factors (none at KI = KD = 1)
  from a seeded card generator;
- ``sweep`` (a dict): ``permute_4d_tiled`` of a 64^4 f32 tensor, perm
  (3,2,1,0), at each design point of the tree's own ``TILES``, beside
  ``permute_4d`` (K2) and ``permute().contiguous()``, timed in turns with
  each other (A B ... B A) inside the tree's process;
- ``e2_VARIANT_R`` and ``e2_VARIANT_R_device``: ``roll_add`` of a bf16
  [R, 32, 256] tensor from a seeded card generator (R = 256, the probe's
  shape, and 4096), each variant on CUDA events and device-only (20 calls
  captured in one CUDA graph, the median of 7 replays over 20), with
  ``roll_add_reference`` beside them (``e2_plain_R``; the device-only
  timer is ``tools/device_timing.py``'s);
- ``gather_apply`` and ``gather_kron_apply``: ``bsr_krylov`` of a
  ``create_bsr`` operator of 12x12 blocks and of a ``create_kron_bsr``
  operator of 3x3 colour blocks and 4x4 spin factors, both truly
  irregular (each row its own site and 4 to 8 random ones, numpy seed 7;
  mode "gather") on 16x16x16x32 x 8 columns, complex values split in f32
  from a seeded card generator; ``k3_colour`` (events) and
  ``k3_colour_device``: ``batched_small_gemm`` at the kron gather's colour
  stage [1179648, 3, 3] @ [1179648, 3, 32] f32, and ``bmm_colour_device``
  ``torch.bmm`` on the same operands (device-only times by
  ``tools/device_timing.py``);
- ``k1_host_us`` (``--only host``): host microseconds a call of
  ``bsr.apply_stencil_soa`` (the public wrapper of K1, tracking off) takes
  to issue at the Wilson bench shape, 8x8x16x128 x 8 f32, while the card
  is busy: 200 calls timed without a wait (``tools/device_timing.py``'s
  ``launch_us``), the median of ``--reps`` such blocks;
  ``k1_entry_host_us`` the same of ``ops.stencil.stencil_matvec_soa``
  with the operator's plan warm (no decorator);
  ``is_compiling_ns``, ``wrapper_state_ns`` (null in a tree without
  ``flags.wrapper_state``) and ``empty_call_ns``: host nanoseconds a call
  of ``torch.compiler.is_compiling``, of ``flags.wrapper_state`` and of a
  lambda that does nothing, over a million calls;
- ``cg_update`` (a dict, ``--only cg_update``): CG's fused kernels
  (``ops/cg_update.py``) alone at the Moebius cell's plane (18,874,368
  floats: 16^3x32 x Ls 12 x 12, 75.5 MB) and the 12-rhs clover cell's
  (301,989,888: 32^3x64 x 12 x 12 rhs, 1.21 GB),
  on fresh outputs: ``<plane>_dot``, ``_xr``, ``_p`` (ms) and their GB/s
  (4, 12 and 6 planes moved), ``<plane>_fused`` the three in a row against
  ``<plane>_ops``, the same iteration as the PyTorch ops of
  ``solvers.cg`` (78 planes), and ``<plane>_bound`` the 22 planes at
  ``copy_rate_gbs``, this process's device-to-device copy rate of a GiB
  (read and write counted);
- ``dw_s5`` (a dict, ``--only dw_s5``): the s5 pass (``ops/dw_s5.py``)
  alone at the Moebius cell's field (1 x Ls 12 x 12 x 16^3x32, 75.5 MB a
  plane), the chiral weights and the cell's b5, c5 and m_f, on fresh
  outputs: ``right_pre``, ``right_post``, ``left``, ``shamir`` (ms) and
  their GB/s (4, 6, 6 and 6 planes moved), ``iteration`` the three passes
  of a Moebius CGNE iteration (right_pre, right_post, left) in a row
  against ``plain``, the same three as the plain version's PyTorch ops,
  and ``bound`` the 16 planes at ``copy_rate_gbs``, this process's
  device-to-device copy rate of a GiB;
- ``clover_cgne_s`` (unless ``--no-solve``): the wall of the clover CGNE of
  ``chip_smoke.py`` (24x24x24x48, 8 right-hand sides, mass 0.1, c_sw 1.0,
  key 0, to 1e-5), one warm solve after one untimed one.

The last line is a JSON object of each tree's medians over its runs, with
the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


#: the runtime-shape route's timed shapes (chip_smoke.py's K1-shape path)
RT_SHAPES = ((2, 2, 3, 3), (1, 1, 2, 2), (2, 1, 4, 2), (2, 2, 8, 8), (1, 1, 16, 16))
#: the gather set's lattice (chip_smoke.py's gather path): 131,072 rows
GATHER_LAT = (16, 16, 16, 32)


def worker(reps: int, solve: bool, only) -> dict:
    import time

    import torch
    from superbblas_tpu_torch import solvers
    from superbblas_tpu_torch.cplx import CArray
    from superbblas_tpu_torch.models import apply_clover, wilson_clover_operator
    from superbblas_tpu_torch.ops.permute import permute_4d
    from superbblas_tpu_torch.ops.stencil import stencil_matvec_soa

    def median_ms(fn):
        for _ in range(3):
            fn()
        times = []
        for _ in range(reps):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e))
        return statistics.median(times)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    def randn_c(shape):
        return CArray(*(torch.randn(shape, generator=gen, device="cuda") for _ in range(2)))

    out = {}
    if "host" in only:
        from device_timing import launch_us
        from superbblas_tpu_torch import bsr
        from superbblas_tpu_torch.models import wilson_operator
        from superbblas_tpu_torch.ops import stencil

        lat = (8, 8, 16, 128)
        op = wilson_operator(lat, mass=0.1, key=0, layout="soa", device="cuda")
        x = randn_c((8, 12) + lat)

        public = lambda: bsr.apply_stencil_soa(op, x)
        entry = lambda: stencil.stencil_matvec_soa(op.blocks, op.kron, x, op.offsets, 3, 3)
        out["k1_host_us"] = statistics.median(launch_us(public) for _ in range(reps))
        out["k1_entry_host_us"] = statistics.median(launch_us(entry) for _ in range(reps))

        def per_call_ns(fn, calls=1_000_000):
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            return (time.perf_counter() - t0) / calls * 1e9

        out["is_compiling_ns"] = per_call_ns(torch.compiler.is_compiling)
        try:
            from superbblas_tpu_torch.flags import wrapper_state
        except ImportError:             # a tree without the tracker
            wrapper_state = None
        out["wrapper_state_ns"] = wrapper_state and per_call_ns(wrapper_state)
        out["empty_call_ns"] = per_call_ns(lambda: None)
    if "clover" in only:
        for key, lat in (("clover_24", (24, 24, 24, 48)), ("clover_16", (16, 16, 16, 32))):
            blocks, x = randn_c((1, 144) + lat), randn_c((8, 12) + lat)
            out[key] = median_ms(lambda: stencil_matvec_soa(blocks, None, x,
                                                            ((0, 0, 0, 0),), 12, 12))
            del blocks, x
    if "permute" in only:
        x = torch.randn((128, 64, 64, 128), generator=gen, device="cuda")
        for key, perm in (("permute_tzyx", (3, 2, 1, 0)), ("permute_tyzx", (3, 1, 2, 0))):
            out[key] = median_ms(lambda: permute_4d(x, perm))
        del x
    if "schedules" in only:
        from superbblas_tpu_torch.models.wilson import wilson_offsets, wilson_operator
        from superbblas_tpu_torch.ops.stencil import (stencil_matvec_soa_stream,
                                                      stencil_matvec_soa_xin)

        lat, offsets = (32, 32, 32, 64), wilson_offsets(4)
        kron = wilson_operator((2, 2, 2, 2), layout="soa", device="cuda").kron
        blocks = randn_c((9, 9) + lat)
        for label, k, F in (("wilson", kron, 12), ("staggered", None, 3)):
            x = randn_c((8, F) + lat)
            for name, fn in (("k1", stencil_matvec_soa), ("xin", stencil_matvec_soa_xin),
                             ("stream", stencil_matvec_soa_stream)):
                out[f"{name}_{label}"] = median_ms(
                    lambda: fn(blocks, k, x, offsets, 3, 3))
            del x
        del blocks
    if "runtime" in only:
        from superbblas_tpu_torch.models.wilson import wilson_offsets
        from superbblas_tpu_torch.ops.stencil import stencil_matvec_soa_rt

        lat, offsets = (16, 16, 16, 32), wilson_offsets(4)
        for ki, kd, bi, bd in RT_SHAPES:
            blocks = randn_c((9, bi * bd) + lat)
            kron = randn_c((9, ki, kd)) if (ki, kd) != (1, 1) else None
            x = randn_c((8, kd * bd) + lat)
            out[f"rt_{ki}{kd}{bi}{bd}"] = median_ms(
                lambda: stencil_matvec_soa_rt(blocks, kron, x, offsets, bi, bd))
            del blocks, kron, x
    if "sweep" in only:
        from superbblas_tpu_torch.ops.permute import TILES, permute_4d_tiled

        x = torch.randn((64, 64, 64, 64), generator=gen, device="cuda")
        perm = (3, 2, 1, 0)
        fns = {str(tile): (lambda tile=tile: permute_4d_tiled(x, perm, tile)) for tile in TILES}
        fns.update(k2=lambda: permute_4d(x, perm), call=lambda: x.permute(perm).contiguous())
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
        out["sweep"] = {k: statistics.median(v) for k, v in times.items()}
        del x
    if "e2" in only:
        from device_timing import graph_ms
        from superbblas_tpu_torch.ops.roll_add import VARIANTS, roll_add, roll_add_reference

        for rows in (256, 4096):
            x = torch.randn((rows, 32, 256), generator=gen, device="cuda").bfloat16()
            fns = {f"e2_{v}_{rows}": (lambda v=v: roll_add(x, v)) for v in VARIANTS}
            fns[f"e2_plain_{rows}"] = lambda: roll_add_reference(x)
            for key, fn in fns.items():
                out[key] = median_ms(fn)
                out[f"{key}_device"] = graph_ms(fn)
            del x
    if "gather" in only:
        import numpy as np

        from device_timing import graph_ms
        from superbblas_tpu_torch.bsr import bsr_krylov, create_bsr, create_kron_bsr
        from superbblas_tpu_torch.ops.batched_gemm import batched_small_gemm

        lat, n, nl = GATHER_LAT, 8, len(GATHER_LAT)
        rng = np.random.default_rng(7)
        ii = rng.integers(5, 10, size=lat)
        jj = np.stack([rng.integers(0, d, size=lat + (9,)) for d in lat], axis=-1)
        jj[..., 0, :] = np.stack(np.meshgrid(*[np.arange(d) for d in lat], indexing="ij"),
                                 axis=-1)
        for key, blk in (("gather", 12), ("gather_kron", 3)):
            colour = randn_c(lat + (9, blk, blk))
            if blk == 3:
                op = create_kron_bsr("xyztSc", lat + (4, 3), "xyztSc", lat + (4, 3),
                                     (1,) * nl + (1, 3), (1,) * nl + (1, 3),
                                     (1,) * nl + (4, 1), (1,) * nl + (4, 1), ii, jj, colour,
                                     randn_c((9, 4, 4)), device="cuda")
                x, ox = randn_c(lat + (4, 3, n)), "xyztScn"
            else:
                op = create_bsr("xyzts", lat + (blk,), "xyztc", lat + (blk,),
                                (1,) * nl + (blk,), (1,) * nl + (blk,), ii, jj, colour,
                                device="cuda")
                x, ox = randn_c(lat + (blk, n)), "xyztcn"
            out[f"{key}_apply"] = median_ms(lambda: bsr_krylov(1.0, op, x, ox))
            del op, colour, x
        V = int(np.prod(lat)) * 9
        b = torch.randn((V, 3, 3), generator=gen, device="cuda")
        xb = torch.randn((V, 3, 4 * n), generator=gen, device="cuda")
        out["k3_colour"] = median_ms(lambda: batched_small_gemm(b, xb))
        out["k3_colour_device"] = graph_ms(lambda: batched_small_gemm(b, xb))
        out["bmm_colour_device"] = graph_ms(lambda: torch.bmm(b, xb))
        del b, xb
    if "cg_update" in only:
        from superbblas_tpu_torch.ops import cg_update as U

        a = torch.empty(2 ** 28, device="cuda")
        c = torch.empty_like(a)
        rate = 2 * 2 ** 30 / (median_ms(lambda: c.copy_(a)) * 1e-3)
        del a, c
        res = {"copy_rate_gbs": rate / 1e9}
        for label, n in (("moebius", 18874368), ("prop12", 301989888)):
            x, p, r, e = (randn_c((n,)) for _ in range(4))
            q = CArray(1.5 * p.re + 0.1 * e.re, 1.5 * p.im + 0.1 * e.im)
            del e
            ws = U.workspace(x.re)
            rs, pap, bs = U.cg_dot(r, r, ws), U.cg_dot(p, q, ws), U.cg_dot(x, x, ws)
            xo, ro, po = (CArray(torch.empty_like(f.re), torch.empty_like(f.im))
                          for f in (x, r, p))
            fns = {"dot": (4, lambda: U.cg_dot(p, q, ws)),
                   "xr": (12, lambda: U.cg_xr(x, p, r, q, rs, pap, xo, ro, ws)),
                   "p": (6, lambda: U.cg_p(r, p, rs, rs, bs, po)),
                   "fused": (22, lambda: (fns["dot"][1](), fns["xr"][1](), fns["p"][1]()))}
            for key, (planes, fn) in fns.items():
                ms = median_ms(fn)
                res[f"{label}_{key}"] = ms
                res[f"{label}_{key}_gbs"] = planes * 4 * n / (ms * 1e-3) / 1e9
            del xo, ro, po

            def ops():
                alpha = rs / torch.clamp_min(solvers._inner_r(p, q), 1e-30)
                x2 = solvers._axpy_c((alpha, 0.0 * alpha), p, x)
                r2 = solvers._axpy_c((-alpha, 0.0 * alpha), q, r)
                rs2 = solvers._inner_r(r2, r2)
                beta = rs2 / torch.clamp_min(rs, 1e-30)
                return x2, solvers._axpy_c((beta, 0.0 * beta), p, r2), rs2 / bs

            res[f"{label}_ops"] = median_ms(ops)
            res[f"{label}_bound"] = 22 * 4 * n / rate * 1e3
            del x, p, r, q
        out["cg_update"] = res
    if "dw_s5" in only:
        from superbblas_tpu_torch.ops import dw_s5 as D5

        a = torch.empty(2 ** 28, device="cuda")
        c = torch.empty_like(a)
        rate = 2 * 2 ** 30 / (median_ms(lambda: c.copy_(a)) * 1e-3)
        del a, c
        res = {"copy_rate_gbs": rate / 1e9}
        shape = (1, 12, 12, 16, 16, 16, 32)
        n = math.prod(shape)
        x, y = randn_c(shape), randn_c(shape)
        wp = torch.tensor((0.0,) * 6 + (1.0,) * 6, device="cuda")
        wm = 1.0 - wp
        planes = {"right_pre": 4, "right_post": 6, "left": 6, "shamir": 6}

        def args(kind):
            bulk, wall = (-1.0, 0.000678) if kind == "shamir" else (1.0, -0.000678)
            return (kind, x, None if kind == "right_pre" else y, wp, wm, bulk, wall, 1.5, 0.5)

        for kind in D5.PASSES:
            ms = median_ms(lambda: D5.dw_s5(*args(kind)))
            res[kind] = ms
            res[f"{kind}_gbs"] = planes[kind] * 4 * n / (ms * 1e-3) / 1e9
        iteration = ("right_pre", "right_post", "left")
        res["iteration"] = median_ms(lambda: [D5.dw_s5(*args(k)) for k in iteration])
        res["plain"] = median_ms(lambda: [D5.dw_s5_reference(*args(k)) for k in iteration])
        res["bound"] = 16 * 4 * n / rate * 1e3
        del x, y
        out["dw_s5"] = res
    if solve:
        lat = (24, 24, 24, 48)
        op = wilson_clover_operator(lat, mass=0.1, c_sw=1.0, key=0, layout="soa",
                                    device="cuda")
        b = randn_c((8, 12) + lat)
        signs = torch.tensor((1.0,) * 6 + (-1.0,) * 6, device="cuda").reshape(1, 12, 1, 1,
                                                                               1, 1)

        def A(v):
            return apply_clover(op, v)

        def Ah(v):
            w = A(CArray(signs * v.re, signs * v.im))
            return CArray(signs * w.re, signs * w.im)

        solvers.cgne(A, Ah, b, tol=1e-5, maxiter=200)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, it = solvers.cgne(A, Ah, b, tol=1e-5, maxiter=200)
        torch.cuda.synchronize()
        out["clover_cgne_s"] = time.perf_counter() - t0
        out["clover_cgne_iterations"] = it
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--trees", nargs="+", default=[str(ROOT)])
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--reps", type=int, default=15)
    parser.add_argument("--no-solve", action="store_true")
    parser.add_argument("--only", nargs="+", default=["clover", "permute", "schedules"],
                        choices=["clover", "permute", "schedules", "runtime", "sweep", "e2",
                                 "gather", "host", "cg_update", "dw_s5"])
    parser.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.worker:
        print(json.dumps(worker(args.reps, not args.no_solve, args.only)), flush=True)
        return
    trees = [str(Path(t).resolve()) for t in args.trees]
    order = []
    for r in range(args.rounds):
        order += trees + trees[::-1] if len(trees) > 1 else trees
    runs = {t: [] for t in trees}
    for tree in order:
        cmd = [sys.executable, str(Path(__file__).resolve()), "--worker", "--reps",
               str(args.reps), "--only", *args.only] + (["--no-solve"] if args.no_solve
                                                          else [])
        env = dict(os.environ, PYTHONPATH=tree)
        res = subprocess.run(cmd, cwd=tree, env=env, capture_output=True, text=True)
        if res.returncode != 0:
            sys.exit(f"kernel_turns: the run of {tree} failed:\n{res.stdout}\n{res.stderr}")
        got = json.loads(res.stdout.strip().splitlines()[-1])
        runs[tree].append(got)
        print(json.dumps({"tree": tree, **got}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi)
    def median(vals):
        vals = [v for v in vals if v is not None]
        return statistics.median(vals) if vals else None

    def medians(rs):
        return {k: ({p: median(r[k][p] for r in rs) for p in rs[0][k]}
                    if isinstance(rs[0][k], dict) else median(r[k] for r in rs))
                for k in rs[0]}

    print(json.dumps({"card": smi, "medians": {t: medians(rs) for t, rs in runs.items()}}))


if __name__ == "__main__":
    main()
