"""Smoke run of superbblas_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Builds the CUDA kernels from ``superbblas_tpu_torch/csrc`` (one nvcc per
source, in parallel) and drives the port's paths on the card.

Stencil checks: the stencil kernel K1 against its plain PyTorch version at
small shapes, and with ``packed_parity`` (both parities) on ragged half
lattices; its X-inside (K4a) and X-streaming (K4b) schedules against the
plain version and against K1, bit for bit, at small shapes; all three at
the Wilson bench shape (lattice 8x8x16x128, 8 columns, f32 and bf16),
timed in turns with the plain version there.

Wilson path: one Wilson operator on a 32x32x32x64 lattice (links from
numpy seed 0, f32) with 8 right-hand sides, built once and shared by the
paths below.  Before the solve the script holds K1 against the plain
version on that operator, its adjoint and the right-hand sides; then it
drives a normal-equation CG solve through ``wilson_operator`` and
``cg_solve`` and checks the true residual, the adjoint identity and that
every matvec of the solve launched K1.  Schedule path: one call of each
of K4a and K4b on the same operator and right-hand sides, held against K1
and the plain version, then all four timed in turns.

Even-odd path: the packed hopping of the operator and of its adjoint
(``hopping_packed_soa``), K1 with ``packed_parity`` held against the plain
version and timed in turns with it; then ``eo_solve_packed_soa`` to a
true residual |D psi - b| / |b| <= 1e-5 (unpacked K1, norms in f64), with
every matvec a packed launch (4 N + 4), beside the unpreconditioned
``cg_solve`` taken to about the same residual; then ``solvers.bicgstab``
on the packed Schur operator built from ``hopping_packed_soa``,
``apply_hopping_packed_soa`` and ``cplx``, to a true Schur residual
<= 2e-5.

Dense path: checks the permute kernel against its plain version at small,
ragged and strided shapes and a small box copy against a numpy oracle.
Then it drives the dense engine once at full width through
``local_permute``, ``local_copy`` and ``local_contraction``: 128x64x64x128
f32 permutes of a tensor and of a split-complex pair, a wrapped box copy,
a masked checkerboard compaction of a 32x32x32x64 field, a bf16 batched
contraction (T=8, 1024^3) and the Gram matrix and rotation of a 64-vector
split-complex Krylov basis of 12x16x16x16x32 sites; each result is held
against a plain version, a numpy oracle or a float64 product on the card,
and the kernel launches of the run are counted.  Then it times the permute
kernel against the plain version (``x.permute(perm).contiguous()``, which
is also the one PyTorch call computing the same function).

Batched-GEMM checks: the kernels K3 (``batched_small_gemm``) and E1
(``batched_gemm_rowpack``) against their plain version and a float64
product at the JAX package's test shapes, E1's probe shape, ragged shapes
and the V-cycle's shapes; then each timed in turns with the plain version
and ``torch.bmm`` (TF32 off): K3 at (8192, 32, 32, 128), E1 at (4096, 32,
288, 32) and at the coarse path's (8192, 32, 288, 32), both at the
V-cycle's two coarse levels, and E1 beside K3 at K3's shapes; each also
device-only (20 calls captured in one CUDA graph).  The kernels line
gives CUDA-event times as for every kernel (``ms``, ``plain_ms``,
``library_ms``) and, for K3 and E1 only, the device-only ones
(``device_ms``, ``plain_device_ms``, ``library_device_ms``).  At the
V-cycle's shapes it prints the wrappers' host cost a call beside
torch.bmm's, and its parts.

Coarse path: ``coarse_operator`` on 8x8x8x16 (a 32^3x64 lattice blocked
by 4^4) with 32x32 blocks, f32, numpy seed 0, Hermitian positive definite
at mass 9 (Lanczos extremes printed and checked); ``apply_coarse`` on 32
right-hand sides held against a plain PyTorch apply, then
``solvers.cg(cols=True)`` to 1e-6 with its true residual and 3 E1
launches an apply.

MG-FGCR path (``experiments/mg_wallclock.py``'s case): the 8^4 Wilson
operator at mass -1.9 (SoA, f32, links from seed 3), the chiral
prolongator (K = 4), the Galerkin coarse matrix and its LU
(``mg_preconditioner_d``, 4 GCR smoothing steps) inside
``solvers.fgcr(restart=8, cols=True)`` on 8 right-hand sides from numpy
seed 11, to 1e-5, beside CGNE (``solvers.cg`` on D^H D) to 1e-5: set-up by
stage, iterations, D-applies, wall, true residuals, agreement, and a K1
launch for every fine apply.

V-cycle path: the same lattice at mass 0.2, ``build_hierarchy(levels=3,
K=4)`` (fine Wilson level on K1, a 4^4 coarse level with 81 offsets on E1,
a 2^4 one with 16 offsets on K3) and ``vcycle_preconditioner(
cheby_degree=4)``: one cycle's contraction factor on a random error, then
FGCR on D^H D with the cycle beside CG, with the launches of the three
kernels.  The operands of one apply of each coarse level, taken from the
apply itself, go through K3 and E1 again, held against the plain version
and a float64 product.

K1-shape path: K1 at the clover term's templated (1,1,12,12) and on its
runtime-shape route at (2,2,3,3), (1,1,2,2) and (2,1,4,2), each against
the plain version on full and packed parity (three dtype pairs), the
runtime route against the templated one bit for bit at (4,4,3,3) and
(1,1,3,3); then each shape driven once at 16^3x32 x 8 and timed beside
its bound.  Families' AoS check: every family's AoS apply (twisted mass,
staggered and the clover term on K3, Shamir and Moebius on E1) against
its SoA apply at 4x4x8x8, Ls 4.  Default-call check (fault P3): the
default ``mobius_operator(DEFAULT_LAT)``, AoS at complex128 on the card,
applied through E1 at f64 against its SoA twin.

Family paths (f32, SoA, CGNE to 1e-5 on the normal residual, each solve
checked by its true normal and unsquared residuals and by one K1 launch
of each of its shapes an apply): clover at 24x24x24x48 x 8 rhs (mass 0.1,
c_sw 1.0, key 0; A^H = gamma5 A gamma5; its (1,1,12,12) term checked and
timed); Moebius at 16x16x16x32 x Ls 16 x 4 rhs (M5 1.4, m_f 0.3, b5 1.5,
c5 0.5; A^H = (Gamma5 R5) D_left (Gamma5 R5), the adjoint identity
first; K1 at the 64 kernel columns checked and timed); and, on the
Wilson path's lattice and links, twisted mass (mu 0.05, cg_solve, 25
iterations) and staggered (adjoint_operator; K1 (1,1,3,3) checked and
timed).

P2 path (fault P2): a default-dtype (complex128) SoA ``mobius_operator``
at 8^3x16, Ls 8, and a complex128 SoA ``wilson_operator`` on the main
lattice and links, applied through K1's f64 route, and the Wilson blocks
cast to f32 applied to bf16 fields (K1's f32-block/bf16-field pair), each
against the plain version on the card; K1 timed at both pairs.

E2 and E3: the bf16 roll-plus-add in both variants (f32 bit-exact, bf16x2
within one bf16 ulp, elements that differ counted) at [256, 32, 256] and
[4096, 32, 256], timed beside the plain version, torch.roll + add and
the bytes bound; the transpose tile sweep at each tile, exact against
``x.permute(3,2,1,0).contiguous()`` at 64^4 f32 and timed beside it and
K2.

``--profile`` adds one warm solve, one warm even-odd solve, one warm
dense path, one warm coarse CG, one warm MG-FGCR solve and one warm
clover and Moebius CGNE under ``torch.profiler`` and prints the device's
busy share and the ops that take its time.

Prints the card's name and power limit, a JSON line with each kernel's
launches on its path and its error, times and bound, and as its last line
``{"ok": true, "device": {...}}``.  Any failed check raises; without CUDA
the script exits non-zero at once.
"""

from __future__ import annotations

import argparse
import contextlib
import itertools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
from torch.profiler import record_function

from superbblas_tpu_torch import (ContractionPlan, bsr, cplx, local_contraction, local_copy,
                                  local_permute, solvers)
from superbblas_tpu_torch.cplx import CArray
from superbblas_tpu_torch.models import (adjoint_operator, apply_clover, apply_coarse,
                                         apply_domain_wall, apply_hopping_packed_soa,
                                         apply_staggered, apply_wilson, cb_pack_soa,
                                         cg_solve, coarse_operator, domain_wall_operator,
                                         eo_solve_packed_soa, hopping_packed_soa,
                                         mobius_operator, multigrid, random_su3_links,
                                         staggered_operator, twisted_mass_operator,
                                         wilson_clover_operator, wilson_offsets,
                                         wilson_operator)
from superbblas_tpu_torch.bsr import BSROperator, bsr_cast_storage
from superbblas_tpu_torch.ops import _cuda
from superbblas_tpu_torch.ops import batched_gemm as gemm_ops
from superbblas_tpu_torch.ops.batched_gemm import (batched_gemm_route, batched_gemm_rowpack,
                                                   batched_small_gemm,
                                                   batched_small_gemm_reference)
from superbblas_tpu_torch.ops.permute import (TILES, maybe_permute, permute_4d,
                                              permute_4d_reference, permute_4d_tiled)
from superbblas_tpu_torch.ops.roll_add import VARIANTS, roll_add, roll_add_reference
from superbblas_tpu_torch.ops.stencil import (soa_to_aos, stencil_matvec_soa,
                                              stencil_matvec_soa_reference,
                                              stencil_matvec_soa_rt,
                                              stencil_matvec_soa_stream,
                                              stencil_matvec_soa_xin)

WILSON_OFFSETS = wilson_offsets(4)
HOPPING = WILSON_OFFSETS[1:]
DTYPE_PAIRS = ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
               (torch.bfloat16, torch.bfloat16))
SCHEDULES = {"xin": stencil_matvec_soa_xin, "stream": stencil_matvec_soa_stream}
#: max |kernel - plain| allowed, relative to max |plain|: f32 rounding for
#: f32 fields, one bf16 ulp (2^-7) for bf16 fields, f64 rounding of sums of
#: a few hundred products for f64 fields
TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3, torch.float64: 1e-12}
MAIN_LAT, MAIN_COLS, MASS = (32, 32, 32, 64), 8, 0.1
CG_ITERS = 25
#: Schur CG iterations of the even-odd solve, and the unpreconditioned CG
#: iterations that reach about the same true residual (f32, 8x8x8x16,
#: mass 0.1, links from seed 0, on the CPU: eo 12 -> 2.8e-6, 14 -> 4.0e-7;
#: cg 25 -> 3.5e-6, 30 -> 4.3e-7)
EO_ITERS = 14
CG_SAME_ITERS = 30
BICG_TOL, BICG_MAXITER = 1e-5, 50
#: the card's published peaks (H100 SXM data sheet): HBM bytes/s and f32
#: FLOP/s outside the tensor cores; a card set below 700 W runs below them
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
#: f64 FLOP/s outside the tensor cores (the same data sheet)
F64_FLOPS = 34e12
#: the dense path's tensor: bench.py's bench_copy shape, f32
DENSE_SHAPE = (128, 64, 64, 128)
PERMS = {"tzyx": (3, 2, 1, 0), "tyzx": (3, 1, 2, 0)}
#: max |bf16 result - f32 product| allowed, relative to max |f32 product|:
#: one bf16 ulp (2^-7); rounding once costs at most half of it
BF16_TOL = 8e-3
#: Gram matrix of the f32 basis against float64, relative to max |G|: each
#: entry sums K = 12*16*16*16*32 = 1,572,864 products; f32 sums of K terms
#: err by about sqrt(K) * 2^-24 = 7.5e-5 of the sum of |terms|; for a
#: random basis the diagonal is that sum, and the Gauss intermediates are
#: of its size (a margin of 2)
GRAM_TOL = 2e-4
#: rotation V C against float64, relative to max |out|: sums of 64 terms,
#: at most 64 * 2^-24 = 3.8e-6 of the sum of |terms| (under 2x max |out|)
ROTATION_TOL = 1e-5
#: the V-cycle path's products: its 2^4 level (16 offsets x K = 4, so J =
#: 64: K3) and its 4^4 level (81 offsets, J = 324: E1), 8 columns in the
#: solve, 4 and 1 in the set-up
VC_K3_SHAPE, VC_E1_SHAPE = (16, 4, 64, 8), (256, 4, 324, 8)
#: batched-GEMM checks (V, I, J, N): the JAX package's test shapes, E1's
#: probe shape, a ragged shape, the V-cycle's; K3 takes those with I, J <= 64
GEMM_CHECK_SHAPES = ((40, 12, 12, 32), (7, 24, 24, 16), (16, 12, 8, 5), (8, 32, 32, 128),
                     (4096, 32, 288, 32), (7, 4, 324, 3), VC_K3_SHAPE, (16, 4, 64, 4),
                     (16, 4, 64, 1), VC_E1_SHAPE, (256, 4, 324, 4), (256, 4, 324, 1))
K3_TIME_SHAPE, E1_TIME_SHAPE = (8192, 32, 32, 128), (4096, 32, 288, 32)
#: the coarse path's own E1 shape (8x8x8x16 sites, J = 9 x 32)
E1_COARSE_SHAPE = (8192, 32, 288, 32)
#: timed shapes: each kernel's own (its entry of the kernels line), the
#: coarse path's and the V-cycle's; where K3 can run, E1 is timed beside it
GEMM_TIME_SHAPES = (("k3", K3_TIME_SHAPE), ("e1", E1_TIME_SHAPE), ("e1", E1_COARSE_SHAPE),
                    ("k3", VC_K3_SHAPE), ("e1", VC_E1_SHAPE))
#: launches captured in one CUDA graph for a device-only time
GRAPH_CALLS = 20
#: calls issued back to back for a host time a call
HOST_CALLS = 200
#: coarse path: 8x8x8x16 sites (32^3x64 blocked by 4^4), 32x32 blocks, 9
#: directions.  At mass 0 the spectrum spans about [-8.25, 8.23] (Lanczos,
#: 4^4 and 4^3x8 lattices, f64, on the CPU), so mass 9 keeps it in about
#: [0.7, 17.3]: positive definite, condition about 25, and CG reaches 1e-6
#: in about sqrt(25)/2 * ln(2e6) = 36 iterations
COARSE_LAT, COARSE_NC, COARSE_COLS, COARSE_MASS = (8, 8, 8, 16), 32, 32, 9.0
COARSE_TOL, COARSE_MAXITER = 1e-6, 200
#: MG-FGCR and V-cycle paths (experiments/mg_wallclock.py's case)
MG_LAT, MG_MASS, MG_COLS, MG_TOL, VC_MASS = (8, 8, 8, 8), -1.9, 8, 1e-5, 0.2
#: true relative residuals checked after a solve to 1e-5: an f32 recurrence
#: residual and the true one drift apart by a few 1e-6 (CGNE's true normal
#: residual 8.4e-6 and 8.6e-6 at 1e-5 on 4^4 and 4^3x8, f32, on the CPU)
SOLVE_RES_TOL = 2e-5
#: relative difference allowed between two solves' answers: MG-FGCR and
#: CGNE differed by 5.0e-4 and 7.2e-4 at mass -1.9 on 4^4 and 4^3x8 (f32,
#: the CPU), CGNE's own error (its D-residual, 5e-5, is 15-40x MG-FGCR's);
#: a margin of 10.  The V-cycle (mass 0.2, better conditioned) against CG:
#: 1.4e-5 on 8x8x4x4
MG_AGREE, VC_AGREE = 1e-2, 1e-3


def randn_c(shape, gen, dtype=torch.float32) -> CArray:
    def part():
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    return CArray(part(), part())


def compare(blocks, kron, x, offsets, label, fn=None, packed_parity=None, bi=3,
            bd=3) -> float:
    """A stencil kernel (K1, with ``packed_parity`` if given, or the
    schedule ``fn``) against the plain version on the same operands, with
    ``bi`` x ``bd`` blocks; returns the max abs error."""
    args = (blocks, kron, x, offsets, bi, bd)
    got = (stencil_matvec_soa(*args, packed_parity=packed_parity) if fn is None
           else fn(*args))
    want = stencil_matvec_soa_reference(*args, packed_parity=packed_parity)
    torch.cuda.synchronize()
    if got.re.dtype != x.re.dtype or got.re.shape != want.re.shape:
        raise AssertionError(f"{label}: output {got.re.dtype} {tuple(got.re.shape)}")
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.float().abs().max()) for w in want)
    ok = err <= TOL[x.re.dtype] * scale
    print(f"check {label}: max|d|={err:.3e} max|y|={scale:.3e} "
          f"rel={err / scale:.3e} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: kernel disagrees with the plain version")
    return err


def time_turns(fns, reps):
    """Median CUDA-event ms of each of ``fns`` (name -> callable), taken in
    turns whose order alternates (a, b, b, a, ...), after warm-up."""
    for fn in fns.values():
        for _ in range(3):
            fn()
    names = list(fns)
    times = {k: [] for k in names}
    for r in range(reps):
        for k in (names if r % 2 == 0 else names[::-1]):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            fns[k]()
            e.record()
            e.synchronize()
            times[k].append(s.elapsed_time(e))
    return {k: statistics.median(v) for k, v in times.items()}


def time_stencils(op, x, reps):
    """Median ms of K1, K4a, K4b and the plain version on one matvec of
    ``op`` on ``x``, in turns."""
    args = (op.blocks, op.kron, x, op.offsets, 3, 3)
    return time_turns({"k1": lambda: stencil_matvec_soa(*args),
                       "xin": lambda: stencil_matvec_soa_xin(*args),
                       "stream": lambda: stencil_matvec_soa_stream(*args),
                       "plain": lambda: stencil_matvec_soa_reference(*args)}, reps)


def same_as_k1(blocks, kron, x, offsets, label):
    """K4a and K4b against the plain version and against K1, bit for bit
    (they share K1's per-site math and its order of sums); returns the max
    abs error against the plain version."""
    k1 = stencil_matvec_soa(blocks, kron, x, offsets, 3, 3)
    err = 0.0
    for name, fn in SCHEDULES.items():
        err = max(err, compare(blocks, kron, x, offsets, f"{name} {label}", fn=fn))
        got = fn(blocks, kron, x, offsets, 3, 3)
        if not all(torch.equal(g, w) for g, w in zip(got, k1)):
            raise AssertionError(f"{name} {label}: differs from K1")
    return err


COUNTED = (stencil_matvec_soa, stencil_matvec_soa_rt, stencil_matvec_soa_xin,
           stencil_matvec_soa_stream, permute_4d, permute_4d_tiled, batched_small_gemm,
           batched_gemm_rowpack, roll_add)


def reset_counts():
    for fn in COUNTED:
        fn.launches = 0
    for fn in (stencil_matvec_soa, stencil_matvec_soa_rt):
        fn.by_shape.clear()


def read_counts():
    return {fn.__name__: fn.launches for fn in COUNTED}


def norm(a) -> float:
    """|a| over both parts, in f64."""
    return float(sum((p.double() ** 2).sum() for p in a)) ** 0.5


def cinner(a, c) -> complex:
    """<a, c> = sum conj(a) c over split-complex CArrays, in f64."""
    re = sum(float((p.double() * q.double()).sum()) for p, q in zip(a, c))
    im = float((a.re.double() * c.im.double()).sum()
               - (a.im.double() * c.re.double()).sum())
    return complex(re, im)


def true_residual(op, x, b) -> float:
    """|D x - b| / |b| with the unpacked K1 apply of ``op``."""
    r = apply_wilson(op, x)
    return norm(CArray(r.re - b.re, r.im - b.im)) / norm(b)


def small_checks(gen):
    for lat, n in (((4, 4, 8, 32), 2), ((3, 5, 6, 10), 3)):
        for st, ft in ((torch.float32, torch.float32),
                       (torch.bfloat16, torch.float32),
                       (torch.bfloat16, torch.bfloat16)):
            blocks = randn_c((9, 9) + lat, gen, st)
            kron = randn_c((9, 4, 4), gen)
            x = randn_c((n, 12) + lat, gen, ft)
            compare(blocks, kron, x, WILSON_OFFSETS, f"wilson-shape {lat} n={n} {st}/{ft}")
            x = randn_c((n, 3) + lat, gen, ft)
            compare(blocks, None, x, WILSON_OFFSETS, f"no-kron {lat} n={n} {st}/{ft}")
    # all-ones blocks and field: every entry is exactly ndir*KD*BD
    lat = (4, 4, 8, 32)
    ones = CArray(torch.ones((9, 9) + lat, device="cuda"),
                  torch.zeros((9, 9) + lat, device="cuda"))
    for kron, kd in ((None, 1), (CArray(torch.ones((9, 4, 4), device="cuda"),
                                        torch.zeros((9, 4, 4), device="cuda")), 4)):
        x = CArray(torch.ones((2, kd * 3) + lat, device="cuda"),
                   torch.zeros((2, kd * 3) + lat, device="cuda"))
        y = stencil_matvec_soa(ones, kron, x, WILSON_OFFSETS, 3, 3)
        if not (bool((y.re == 9 * kd * 3).all()) and bool((y.im == 0).all())):
            raise AssertionError(f"all-ones check (KD={kd}) is not exactly {9 * kd * 3}")
        print(f"check all-ones KD={kd}: every entry == {9 * kd * 3} ok", flush=True)


def packed_checks(gen):
    """K1 with packed parity against the plain version: both parities,
    ragged half lattices (X/2 of 1, 2 and 3; odd Y, Z and T), 1-3 columns,
    the three dtype pairs, the 8 hopping directions."""
    for half, n in (((1, 3, 2, 5), 1), ((2, 4, 3, 8), 2), ((3, 5, 4, 7), 3)):
        for st, ft in DTYPE_PAIRS:
            for parity in (0, 1):
                blocks = randn_c((8, 9) + half, gen, st)
                kron = randn_c((8, 4, 4), gen)
                x = randn_c((n, 12) + half, gen, ft)
                compare(blocks, kron, x, HOPPING, f"packed p={parity} {half} n={n} "
                        f"{st}/{ft}", packed_parity=parity)


def schedule_checks(gen):
    """K4a and K4b against the plain version and K1 at small shapes (X of
    1, 2 and 3 among them), the three dtype pairs, with and without spin
    factors."""
    for lat, n in (((1, 3, 2, 5), 1), ((2, 4, 3, 8), 2), ((3, 2, 5, 7), 3),
                   ((4, 4, 8, 32), 8)):
        for st, ft in DTYPE_PAIRS:
            blocks = randn_c((9, 9) + lat, gen, st)
            kron = randn_c((9, 4, 4), gen)
            same_as_k1(blocks, kron, randn_c((n, 12) + lat, gen, ft), WILSON_OFFSETS,
                       f"{lat} n={n} {st}/{ft}")
            same_as_k1(blocks, None, randn_c((n, 3) + lat, gen, ft), WILSON_OFFSETS,
                       f"no-kron {lat} n={n} {st}/{ft}")


def bench_shape(gen):
    """K1, K4a, K4b and the plain version at the Wilson bench shape:
    checked, then timed in turns."""
    lat, n = (8, 8, 16, 128), 8
    op32 = wilson_operator(lat, mass=0.1, key=0, layout="soa", device="cuda")
    for label, op, ft in (("f32", op32, torch.float32),
                          ("bf16/bf16", bsr_cast_storage(op32, torch.bfloat16),
                           torch.bfloat16)):
        x = randn_c((n, 12) + lat, gen, ft)
        compare(op.blocks, op.kron, x, op.offsets, f"bench {lat} n={n} {label}")
        same_as_k1(op.blocks, op.kron, x, op.offsets, f"bench {lat} n={n} {label}")
        ms = time_stencils(op, x, reps=25)
        flops = op.flops_per_matvec(n)
        nbytes = op.memops_per_matvec(n, itemsize=2 * x.re.element_size())
        bound_ms, bound_by = bound(nbytes, flops)
        print(f"bench {label} bound {bound_ms:.4f} ms ({bound_by})", flush=True)
        for k, v in ms.items():
            print(f"bench {label} {k}: median {v:.4f} ms over 25, "
                  f"{flops / v / 1e6:.1f} GFLOP/s, {nbytes / v / 1e6:.1f} GB/s",
                  flush=True)


def profile_run(label, fn):
    """One warm run of ``fn`` under torch.profiler: the device's busy share
    of its wall time, the ops that take the most device time, and the
    host time and device span of each range named "step: ..."."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    # a step's range also appears on the device side, spanning its kernels
    busy = sum(e.time_range.elapsed_us() for e in events
               if e.device_type == DeviceType.CUDA and not e.name.startswith("step: ")) / 1e6
    print(f"profile: {label} wall {wall:.4f} s, device busy {busy:.4f} s "
          f"({100 * busy / wall:.1f}% busy)", flush=True)
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=12),
          flush=True)
    for e in events:
        if e.name.startswith("step: "):
            side = "host" if e.device_type == DeviceType.CPU else "device span"
            print(f"profile: {label} {e.name[6:]}: {side} "
                  f"{e.time_range.elapsed_us() / 1e3:.3f} ms", flush=True)
    if busy <= 0:
        raise AssertionError("the profiler saw no device time")


def bound(nbytes, flops, peak=F32_FLOPS):
    """(ms, "bytes" or "operations"): the least time the card could take
    to move ``nbytes`` and do ``flops`` operations at ``peak`` (f32 unless
    named), at its published peaks."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def main_operator(gen):
    """The Wilson operator of the main paths, 32x32x32x64, f32, links from
    numpy seed 0 (kept: the staggered and twisted-mass paths are built on
    them), and 8 right-hand sides."""
    t0 = time.perf_counter()
    links = random_su3_links(np.random.default_rng(0), MAIN_LAT)
    t1 = time.perf_counter()
    op = wilson_operator(MAIN_LAT, mass=MASS, links=links, layout="soa", device="cuda")
    b = randn_c((MAIN_COLS, 12) + MAIN_LAT, gen)
    torch.cuda.synchronize()
    print(f"main operator set-up {time.perf_counter() - t0:.2f} s (host links "
          f"{t1 - t0:.2f} s, blocks + upload {time.perf_counter() - t1:.2f} s)", flush=True)
    return op, b, links


def wilson_path(op, b, profile: bool):
    """The Wilson path end to end: kernel against plain on the operator's
    operands, CG solve, checks.  Returns (launches in the solve, max
    error)."""
    lat, n = MAIN_LAT, MAIN_COLS
    # the kernel against the plain version on the solve's own operands:
    # D b and D^H b, independently of the solve's self-consistency
    op_h = adjoint_operator(op)
    err = max(compare(o.blocks, o.kron, b, o.offsets, f"main path {lat} n={n} {name}")
              for name, o in (("D", op), ("D^H", op_h)))
    del op_h

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    x, rs = cg_solve(op, b, n_iters=CG_ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()["stencil_matvec_soa"]
    expected = 1 + 2 * CG_ITERS
    peak = torch.cuda.max_memory_allocated()

    # checks: true residual of the normal equations, adjoint identity
    op_h = adjoint_operator(op)
    dx = apply_wilson(op, x)
    dhdx = apply_wilson(op_h, dx)
    dhb = apply_wilson(op_h, b)
    torch.cuda.synchronize()

    finite = all(bool(torch.isfinite(p).all()) for p in (*x, *dhdx))
    res = norm(CArray(dhdx.re - dhb.re, dhdx.im - dhb.im)) / norm(dhb)
    adj = abs(cinner(b, dx) - cinner(dhb, x))
    adj_bound = 1e-5 * norm(b) * norm(dx)
    print(f"main path {lat} x {n} rhs: cg_solve {CG_ITERS} iters {wall:.3f} s, "
          f"peak memory {peak / 2 ** 30:.2f} GiB, |r|^2={float(rs):.4e}", flush=True)
    print(f"main path checks: true rel residual {res:.3e} (<= 1e-5), "
          f"adjoint |<y,Dx>-<D^H y,x>| {adj:.3e} (<= {adj_bound:.3e}), "
          f"launches in the solve {launches} (expected {expected}), finite {finite}",
          flush=True)
    if tuple(x.re.shape) != (n, 12) + lat or not finite:
        raise AssertionError("solution has the wrong shape or is not finite")
    if not res <= 1e-5:
        raise AssertionError(f"true relative residual {res:.3e} > 1e-5")
    if not adj <= adj_bound:
        raise AssertionError("adjoint identity fails")
    if launches != expected:
        raise AssertionError(f"{launches} kernel launches, expected {expected}")
    if profile:
        del x, dx, dhdx, dhb, op_h
        profile_run("solve", lambda: cg_solve(op, b, n_iters=CG_ITERS))
    return launches, err


def schedule_path(op, b):
    """K4a and K4b through their entry points once each on the main
    operator and right-hand sides (the counts set to 0 just before and
    read just after), held against K1 bit for bit and against the plain
    version; then K1, K4a, K4b and the plain version timed in turns.
    Returns ({name: launches}, {name: max error}, {name: median ms})."""
    args = (op.blocks, op.kron, b, op.offsets, 3, 3)
    reset_counts()
    got = {name: fn(*args) for name, fn in SCHEDULES.items()}
    torch.cuda.synchronize()
    counts = read_counts()
    launches = {name: counts[fn.__name__] for name, fn in SCHEDULES.items()}
    print(f"schedule path {MAIN_LAT} n={MAIN_COLS}: launches {counts}", flush=True)
    if launches != {"xin": 1, "stream": 1} or counts["stencil_matvec_soa"] != 0:
        raise AssertionError(f"schedule path launches {counts}, expected one of each "
                             "schedule")
    k1 = stencil_matvec_soa(*args)
    want = stencil_matvec_soa_reference(*args)
    torch.cuda.synchronize()
    scale = max(float(w.abs().max()) for w in want)
    err = {}
    for name, y in got.items():
        err[name] = max(float((g - w).abs().max()) for g, w in zip(y, want))
        same = all(torch.equal(g, w) for g, w in zip(y, k1))
        print(f"check {name} main path: max|d| vs plain {err[name]:.3e} "
              f"(rel {err[name] / scale:.3e}), equal to K1 bit for bit: {same}", flush=True)
        if not (err[name] <= TOL[torch.float32] * scale and same):
            raise AssertionError(f"{name} on the main operator disagrees")
    del got, k1, want
    ms = time_stencils(op, b, reps=11)
    print(f"main shape {MAIN_LAT} n={MAIN_COLS} matvec medians over 11 in turns: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()), flush=True)
    return launches, err, ms


def eo_path(op, b, profile: bool):
    """The even-odd path end to end: packed hoppings checked and timed,
    the packed eo solve with its checks, the unpreconditioned CG beside
    it, BiCGStab on the packed Schur operator.  Returns (packed launches
    in the solve, max error, {hopping: (kernel ms, plain ms)}, (bound ms,
    bound by) of one packed hopping)."""
    n, a = MAIN_COLS, MASS + 4.0
    t0 = time.perf_counter()
    op_h = adjoint_operator(op)
    hops = {"H_eo": (hopping_packed_soa(op, 0), 0, cb_pack_soa(b, 1)),
            "(H^H)_oe": (hopping_packed_soa(op_h, 1), 1, cb_pack_soa(b, 0))}
    del op_h
    torch.cuda.synchronize()
    half = tuple(hops["H_eo"][0].dim_d)
    print(f"eo path: packed hoppings on {half} built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    err, ms = 0.0, {}
    for name, (hop, p, src) in hops.items():
        err = max(err, compare(hop.blocks, hop.kron, src, hop.offsets,
                               f"eo {name} {half} n={n}", packed_parity=p))
        args = (hop.blocks, hop.kron, src, hop.offsets, 3, 3)
        t = time_turns({"kernel": lambda: stencil_matvec_soa(*args, packed_parity=p),
                        "plain": lambda: stencil_matvec_soa_reference(
                            *args, packed_parity=p)}, reps=7)
        ms[name] = t["kernel"], t["plain"]
        print(f"eo {name} packed hopping: kernel median {t['kernel']:.4f} ms, plain "
              f"median {t['plain']:.4f} ms over 7", flush=True)
    hop = hops["H_eo"][0]
    hop_bound = bound(hop.memops_per_matvec(n, itemsize=8), hop.flops_per_matvec(n))
    print(f"eo packed hopping bound {hop_bound[0]:.4f} ms ({hop_bound[1]}): "
          f"{hop.flops_per_matvec(n) / 1e9:.2f} GFLOP, "
          f"{hop.memops_per_matvec(n, itemsize=8) / 1e9:.3f} GB", flush=True)
    del hops, hop

    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    psi, rs = eo_solve_packed_soa(op, b, a=a, n_iters=EO_ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()["stencil_matvec_soa"]
    expected = 4 * EO_ITERS + 4
    peak = torch.cuda.max_memory_allocated()
    finite = all(bool(torch.isfinite(q).all()) for q in psi)
    res = true_residual(op, psi, b)
    print(f"eo path {MAIN_LAT} x {n} rhs: eo_solve_packed_soa {EO_ITERS} iters "
          f"{wall:.3f} s, peak memory {peak / 2 ** 30:.2f} GiB, |r_e|^2={float(rs):.4e}",
          flush=True)
    print(f"eo path checks: true rel residual |D psi - b|/|b| {res:.3e} (<= 1e-5), "
          f"packed launches in the solve {launches} (expected {expected}), "
          f"finite {finite}", flush=True)
    if tuple(psi.re.shape) != tuple(b.re.shape) or not finite:
        raise AssertionError("eo solution has the wrong shape or is not finite")
    if not res <= 1e-5:
        raise AssertionError(f"eo true relative residual {res:.3e} > 1e-5")
    if launches != expected:
        raise AssertionError(f"{launches} kernel launches in the eo solve, "
                             f"expected {expected}")
    del psi

    t0 = time.perf_counter()
    x, _ = cg_solve(op, b, n_iters=CG_SAME_ITERS)
    torch.cuda.synchronize()
    print(f"eo path finding: unpreconditioned cg_solve {CG_SAME_ITERS} iters "
          f"{time.perf_counter() - t0:.3f} s, true rel residual "
          f"{true_residual(op, x, b):.3e}", flush=True)
    del x

    # BiCGStab on the packed Schur operator, assembled as a user would
    he, ho = hopping_packed_soa(op, 0), hopping_packed_soa(op, 1)

    def dhat(v):
        t = apply_hopping_packed_soa(he, apply_hopping_packed_soa(ho, v, 1), 0)
        return cplx.add(cplx.scale(a, v), cplx.scale(-1.0 / a, t))

    rhs = cplx.add(cb_pack_soa(b, 0), cplx.scale(
        -1.0 / a, apply_hopping_packed_soa(he, cb_pack_soa(b, 1), 0)))
    reset_counts()
    t0 = time.perf_counter()
    x_e, _, k = solvers.bicgstab(dhat, rhs, tol=BICG_TOL, maxiter=BICG_MAXITER)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    b_launches = read_counts()["stencil_matvec_soa"]
    r = dhat(x_e)
    schur = norm(CArray(r.re - rhs.re, r.im - rhs.im)) / norm(rhs)
    print(f"eo path bicgstab on Dhat: {k} iters {wall:.3f} s, true Schur residual "
          f"{schur:.3e} (<= 2e-5), packed launches {b_launches} (expected {4 * k})",
          flush=True)
    if not (k < BICG_MAXITER and schur <= 2e-5 and b_launches == 4 * k):
        raise AssertionError("bicgstab on the packed Schur operator did not converge "
                             "through the kernel")
    del he, ho, rhs, x_e, r
    if profile:
        profile_run("eo solve", lambda: eo_solve_packed_soa(op, b, a=a, n_iters=EO_ITERS))
    return launches, err, ms, hop_bound


def exact(got, want, label):
    """Raise unless ``got`` equals ``want`` bit for bit (same shape and
    dtype); returns the max abs difference (0.0)."""
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{label}: differs from its plain version or oracle")
    return float((got.double() - want.double()).abs().max()) if got.numel() else 0.0


def numpy_copy_oracle(alpha, x, o0, y, o1, from0, size0, from1, copy_add):
    """Element-by-element toroidal reference copy, in f32 (as
    tests/test_copy.py's oracle)."""
    out = np.array(y, copy=True)
    for rel in itertools.product(*[range(s) for s in size0]):
        c0 = tuple((f + r) % d for f, r, d in zip(from0, rel, x.shape))
        c1 = tuple((from1[j] + (rel[o0.index(c)] if c in o0 else 0)) % out.shape[j]
                   for j, c in enumerate(o1))
        v = np.float32(alpha) * x[c0]
        if copy_add == "copy":
            out[c1] = v
        else:
            out[c1] += v
    return out


def permute_checks(gen):
    """The permute kernel against its plain version off the dense path:
    ragged tiles, a strided view, int32 words; a small wrapped box copy
    against the numpy oracle.  Returns the max abs error."""
    err = 0.0
    x = torch.randn((45, 6, 7, 70), generator=gen, device="cuda")
    for perm in PERMS.values():
        for label, v in (("ragged", x), ("strided view", x[3:40, 1:5, 2:7, 5:66]),
                         ("int32", x.view(torch.int32))):
            before = permute_4d.launches
            got = maybe_permute(v, perm)
            torch.cuda.synchronize()
            if permute_4d.launches != before + 1:
                raise AssertionError(f"permute {label}: the kernel was not launched")
            err = max(err, exact(got, permute_4d_reference(v, perm),
                                 f"permute {tuple(v.shape)} {label} {perm}"))
    print("check permute kernel: ragged, strided and int32 cases bit-exact", flush=True)
    rng = np.random.default_rng(0)
    xs = rng.standard_normal((12, 4, 4, 12)).astype(np.float32)
    ys = rng.standard_normal((12, 4, 4, 12)).astype(np.float32)
    box = dict(from0=(9, 0, 0, 10), size0=(8, 4, 4, 8), from1=(10, 0, 0, 9), copy_add="add")
    got = local_copy(-2.5, torch.from_numpy(xs).cuda(), "xyzt",
                     torch.from_numpy(ys).cuda(), "tzyx", **box)
    want = numpy_copy_oracle(-2.5, xs, "xyzt", ys, "tzyx", **box)
    err = max(err, exact(got.cpu(), torch.from_numpy(want), "small box copy vs numpy"))
    print("check box copy 12x4x4x12, wrapped in x and t: equals the numpy oracle",
          flush=True)
    return err


def box_copy_plain(alpha, x, y):
    """The dense path's box copy with rolls and the plain permute: the box
    (96, 0, 0, 100) + 64^4 of x ("xyzt") added, scaled, at (100, 0, 0, 96)
    of y ("tzyx")."""
    src = torch.roll(x, shifts=(-96, -100), dims=(0, 3))[:64, :, :, :64]
    src = permute_4d_reference(src, PERMS["tzyx"]) * alpha
    out = torch.roll(y, shifts=(-100, -96), dims=(0, 3))
    out[:64, :, :, :64] += src
    return torch.roll(out, shifts=(100, 96), dims=(0, 3))


def event_ms(fn, reps):
    """Median CUDA-event ms of ``fn`` over ``reps`` calls after one warm-up;
    returns (ms, last result)."""
    out = fn()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        out = fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times), out


def rel_err(got: CArray, want: torch.Tensor) -> float:
    """max |got - want| over both parts, relative to max |want| (complex
    float64 ``want``)."""
    err = max(float((got.re.double() - want.real).abs().max()),
              float((got.im.double() - want.imag).abs().max()))
    return err / float(want.abs().max())


def dense_data(gen):
    """The dense path's operands, made on the card from ``gen``."""
    def randn(shape, dtype=torch.float32):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)

    field = randn((32, 32, 32, 64))
    d = dict(x=randn(DENSE_SHAPE), xc=CArray(randn(DENSE_SHAPE), randn(DENSE_SHAPE)),
             y=randn(DENSE_SHAPE), field=field,
             a=randn((8, 1024, 1024), torch.bfloat16),
             b=randn((8, 1024, 1024), torch.bfloat16),
             V=CArray(randn((64, 12, 16, 16, 16, 32)), randn((64, 12, 16, 16, 16, 32))),
             C=CArray(randn((64, 16)), randn((64, 16))),
             even=np.add.reduce(np.indices(tuple(field.shape))) % 2 == 0,
             low_half=np.indices(tuple(field.shape))[0] < 16)
    torch.cuda.synchronize()
    return d


def dense_calls(d):
    """The dense path: each public entry point at full width, once, each
    step in a profiler range named "step: ...".  Returns the results and
    the permute launch count after the permutes and after the box copy."""
    r, steps = {}, []
    with record_function("step: permutes"):
        for o1 in PERMS:
            r["permute", o1] = local_permute(d["x"], "xyzt", o1)
            r["permute CArray", o1] = local_permute(d["xc"], "xyzt", o1)
    steps.append(permute_4d.launches)
    with record_function("step: box copy"):
        r["box"] = local_copy(-2.5, d["x"], "xyzt", d["y"], "tzyx", from0=(96, 0, 0, 100),
                              size0=(64, 64, 64, 64), from1=(100, 0, 0, 96),
                              copy_add="add")
    steps.append(permute_4d.launches)
    with record_function("step: masked copy"):
        r["masked"] = local_copy(1.0, d["field"], "xyzt", torch.zeros_like(d["field"]),
                                 "xyzt", mask0=d["even"], mask1=d["low_half"])
    with record_function("step: bf16 contraction"):
        r["bf16"] = local_contraction(1.0, d["a"], "tab", False, d["b"], "tac", False,
                                      0.0, None, "tbc")
    with record_function("step: Gram"):
        r["gram"] = local_contraction(1.0, d["V"], "kSxyzt", True, d["V"], "lSxyzt",
                                      False, 0.0, None, "kl")
    with record_function("step: rotation"):
        r["rotation"] = local_contraction(1.0, d["V"], "kSxyzt", False, d["C"], "km",
                                          False, 0.0, None, "mSxyzt")
    return r, steps


def dense_path(gen, profile: bool):
    """The dense engine at full width through the public entry points,
    with the kernel counts set to 0 just before and read just after; then
    every result is checked and each contraction timed.  Returns
    (permute_4d launches, max abs error of its calls)."""
    d = dense_data(gen)
    reset_counts()
    t0 = time.perf_counter()
    r, steps = dense_calls(d)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    print(f"dense path {wall:.3f} s, kernel launches {counts} (after the permutes "
          f"{steps[0]}, after the box copy {steps[1]})", flush=True)
    if counts != {k: 7 if k == "permute_4d" else 0 for k in counts} or steps != [2 + 4, 7]:
        raise AssertionError(f"dense path launches {counts} {steps}, expected 2 + 4 "
                             "for the permutes and 1 for the box copy")

    x, xc, V, C = d["x"], d["xc"], d["V"], d["C"]
    err = 0.0
    for o1, perm in PERMS.items():
        err = max(err, exact(r["permute", o1], permute_4d_reference(x, perm),
                             f"local_permute xyzt->{o1}"))
        for got, part in zip(r["permute CArray", o1], xc):
            err = max(err, exact(got, permute_4d_reference(part, perm),
                                 f"local_permute CArray xyzt->{o1}"))
    print(f"dense permute {DENSE_SHAPE} f32 xyzt->tzyx, xyzt->tyzx, tensor and CArray: "
          "bit-exact against the plain version", flush=True)
    err = max(err, exact(r["box"], box_copy_plain(-2.5, x, d["y"]), "box copy"))
    print("dense box copy 64^4 from (96,0,0,100) to (100,0,0,96), add, alpha -2.5: "
          "bit-exact against rolls + plain permute", flush=True)
    packed = r["masked"]
    exact(packed[:16].reshape(-1).cpu(), torch.from_numpy(d["field"].cpu().numpy()[d["even"]]),
          "masked compaction")
    exact(packed[16:], torch.zeros_like(packed[16:]), "masked compaction, rest")
    print(f"dense masked copy: even sites of {tuple(packed.shape)} packed into the x < 16 "
          "half, equal to the numpy oracle", flush=True)

    out = r["bf16"]
    ref = torch.einsum("tab,tac->tbc", d["a"].float(), d["b"].float())
    e = float((out.float() - ref).abs().max()) / float(ref.abs().max())
    print(f"dense contraction tab,tac->tbc T=8 1024^3 bf16: rel err vs f32 product "
          f"{e:.3e} (<= {BF16_TOL})", flush=True)
    if out.dtype != torch.bfloat16 or tuple(out.shape) != (8, 1024, 1024) \
            or not e <= BF16_TOL:
        raise AssertionError("bf16 contraction disagrees with the f32 product")
    del ref
    Vd = torch.complex(V.re.double(), V.im.double()).reshape(64, -1)
    e = rel_err(r["gram"], Vd.conj() @ Vd.T)
    print(f"dense Gram V^H V, V {tuple(V.shape)} split complex f32: rel err vs f64 "
          f"{e:.3e} (<= {GRAM_TOL})", flush=True)
    if tuple(r["gram"].shape) != (64, 64) or not e <= GRAM_TOL:
        raise AssertionError("Gram matrix disagrees with the float64 product")
    rot = r["rotation"]
    e = rel_err(rot, (torch.complex(C.re.double(), C.im.double()).T @ Vd).reshape(rot.shape))
    print(f"dense rotation V C -> mSxyzt, m=16: rel err vs f64 {e:.3e} "
          f"(<= {ROTATION_TOL})", flush=True)
    if tuple(rot.shape) != (16,) + tuple(V.shape[1:]) or not e <= ROTATION_TOL:
        raise AssertionError("rotation disagrees with the float64 product")
    del Vd, r, packed, out, rot

    for label, o_r, args, cplx_flops in (
            ("contraction tab,tac->tbc bf16", "tbc",
             (d["a"], "tab", False, d["b"], "tac"), False),
            ("Gram V^H V", "kl", (V, "kSxyzt", True, V, "lSxyzt"), True),
            ("rotation V C -> mSxyzt", "mSxyzt", (V, "kSxyzt", False, C, "km"), True)):
        ms, out = event_ms(lambda: local_contraction(1.0, *args, False, 0.0, None, o_r), 5)
        flops = ContractionPlan(args[1], args[0].shape, args[4], args[3].shape, o_r,
                                out.shape).flops(cplx_flops)
        print(f"dense {label}: median {ms:.4f} ms over 5, {flops / ms / 1e9:.1f} TFLOP/s"
              f"{' complex-equivalent' if cplx_flops else ''}", flush=True)
    if profile:
        profile_run("dense path", lambda: dense_calls(d))
    return counts["permute_4d"], err


def time_permute(gen):
    """The permute kernel against the plain version at the dense path's
    shape, in turns.  The plain version, ``x.permute(perm).contiguous()``,
    is also the one PyTorch call computing the same function, so its time
    serves as the library time too.  Returns {perm name: (kernel ms, plain
    ms)}."""
    x = torch.randn(DENSE_SHAPE, generator=gen, device="cuda")
    nbytes = 2 * x.numel() * x.element_size()
    out = {}
    for o1, perm in PERMS.items():
        ms = time_turns({"kernel": lambda: permute_4d(x, perm),
                         "plain": lambda: permute_4d_reference(x, perm)}, reps=15)
        out[o1] = ms["kernel"], ms["plain"]
        print(f"permute {DENSE_SHAPE} f32 xyzt->{o1}: kernel median {ms['kernel']:.4f} ms "
              f"({nbytes / ms['kernel'] / 1e6:.1f} GB/s), plain = library call "
              f"median {ms['plain']:.4f} ms ({nbytes / ms['plain'] / 1e6:.1f} GB/s) over 15",
              flush=True)
    return out, bound(nbytes, 0)


def summed_bound(b, x, factor=1.0):
    """An f32 error bound of a batched product, max over its outputs:
    ``factor`` * J * 2^-24 * sum_j |b_ij| |x_jn| (recursive summation of J
    rounded products, one rounding per multiply-add), from the magnitudes
    in f64."""
    mags = torch.einsum("vij,vjn->vin", b.abs().double(), x.abs().double())
    return factor * b.shape[-1] * 2.0 ** -24 * float(mags.max())


#: the wrapper that counts each kernel's launches
GEMM_KERNELS = {"k3": batched_small_gemm, "e1": batched_gemm_rowpack}


def check_gemm(key, fn, b, x, label) -> float:
    """``fn(b, x)``, which must launch kernel ``key`` once, against the
    plain version and a float64 product: within the summation bound of
    the f64 product, and within twice it of the plain version.  Returns
    the max abs error against the plain version."""
    V, I, J = b.shape
    N = x.shape[2]
    exact = torch.einsum("vij,vjn->vin", b.double(), x.double())
    tol = summed_bound(b, x)
    plain = batched_small_gemm_reference(b, x)
    before = GEMM_KERNELS[key].launches
    y = fn(b, x)
    torch.cuda.synchronize()
    e64 = float((y.double() - exact).abs().max())
    ep = float((y - plain).abs().max())
    ok = (y.dtype == b.dtype and tuple(y.shape) == (V, I, N)
          and GEMM_KERNELS[key].launches == before + 1 and e64 <= tol and ep <= 2 * tol)
    print(f"check {key} {label} {(V, I, J, N)}: max|d| vs f64 {e64:.3e}, vs plain {ep:.3e} "
          f"(bound {tol:.3e}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{key} {label} {(V, I, J, N)} disagrees or did not launch")
    return ep


def gemm_checks(gen):
    """K3 and E1 against their plain version and a float64 product at the
    check shapes (K3 at those with I, J <= 64).  Returns {kernel: max abs
    error against the plain version}."""
    errs = {"k3": 0.0, "e1": 0.0}
    for V, I, J, N in GEMM_CHECK_SHAPES:
        b = torch.randn((V, I, J), generator=gen, device="cuda") / J ** 0.5
        x = torch.randn((V, J, N), generator=gen, device="cuda")
        for key, fn in GEMM_KERNELS.items():
            if key == "k3" and max(I, J) > 64:
                continue
            errs[key] = max(errs[key], check_gemm(key, fn, b, x, "random"))
    return errs


@contextlib.contextmanager
def captured_gemms():
    """Records the operands (b, x) of every batched product the AoS
    stencil apply (``bsr._apply_stencil``, no-kron) makes while active,
    and runs each as it would have."""
    calls, inner = [], bsr.batched_small_gemm

    def recording(b, x):
        calls.append((b, x))
        return inner(b, x)

    bsr.batched_small_gemm = recording
    try:
        yield calls
    finally:
        bsr.batched_small_gemm = inner


def graph_ms(fn, reps=7) -> float:
    """Device ms of one call of ``fn``: GRAPH_CALLS calls captured in one
    CUDA graph (after a warm-up on a side stream), the median of ``reps``
    replays over GRAPH_CALLS: no host cost of the calls is inside."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GRAPH_CALLS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e) / GRAPH_CALLS)
    return statistics.median(times)


def host_us(fn) -> float:
    """Host microseconds a call of ``fn``: HOST_CALLS calls issued back to
    back from an idle card, waited on at the end.  Where the card runs a
    call in a few microseconds (the V-cycle's shapes) the host sets the
    pace, so this is the host's cost of issuing one."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(HOST_CALLS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / HOST_CALLS * 1e6


def host_breakdown(key, b, x):
    """The wrapper's host cost a call beside torch.bmm's, and its parts:
    the argument checks, the tile lookup, the allocation of y, the stream
    lookup and the C entry alone (ctypes and cudaLaunchKernel, on
    operands and a tile fixed beforehand).  Returns {part: us}."""
    V, I, J = b.shape
    N = x.shape[2]
    entry, tile_fn = (("sbt_batched_gemm_small", gemm_ops.small_tile) if key == "k3"
                      else ("sbt_batched_gemm_rowpack", gemm_ops.rowpack_tile))
    cfg, sites = tile_fn(V, I, J, N)
    y = torch.empty((V, I, N), device="cuda")
    c_entry = getattr(_cuda.library(), entry)
    stream = torch.cuda.current_stream().cuda_stream
    args = (0, V, I, J, N, cfg, sites, b.data_ptr(), x.data_ptr(), y.data_ptr(), stream)
    return {"wrapper": host_us(lambda: GEMM_KERNELS[key](b, x)),
            "torch.bmm": host_us(lambda: torch.bmm(b, x)),
            "checks": host_us(lambda: gemm_ops._check(b, x, key)),
            "tile": host_us(lambda: tile_fn(V, I, J, N)),
            "new_empty": host_us(lambda: b.new_empty((V, I, N))),
            "stream": host_us(lambda: torch.cuda.current_stream(0).cuda_stream),
            "C entry": host_us(lambda: c_entry(*args))}


def time_gemms(gen):
    """K3 and E1 at the timed shapes, in turns with the plain version and
    torch.bmm (TF32 off), and E1 beside K3 where K3 runs; then the kernel's,
    the plain version's and torch.bmm's device-only times (``graph_ms``;
    the events' times less them are the host's: at these sizes the host
    issues a call in about as long as the card runs it), and at the
    V-cycle's shapes the host's cost a call and its parts
    (``host_breakdown``).  Returns {(kernel, shape): ({name: median ms,
    name + "_device": device ms}, (bound ms, bound by))}."""
    out = {}
    for key, (V, I, J, N) in GEMM_TIME_SHAPES:
        b = torch.randn((V, I, J), generator=gen, device="cuda") / J ** 0.5
        x = torch.randn((V, J, N), generator=gen, device="cuda")
        fns = {"kernel": lambda: GEMM_KERNELS[key](b, x)}
        if key == "k3":
            fns["e1"] = lambda: batched_gemm_rowpack(b, x)
        fns.update(plain=lambda: batched_small_gemm_reference(b, x),
                   bmm=lambda: torch.bmm(b, x))
        ms = time_turns(fns, reps=25)
        for name in ("kernel", "plain", "bmm"):
            ms[name + "_device"] = graph_ms(fns[name])
        print(f"{key} {(V, I, J, N)} f32 device-only (CUDA graph of {GRAPH_CALLS}): kernel "
              f"{ms['kernel_device']:.4f} ms, plain {ms['plain_device']:.4f} ms, torch.bmm "
              f"{ms['bmm_device']:.4f} ms; host (events less device): kernel "
              f"{ms['kernel'] - ms['kernel_device']:.4f} ms, torch.bmm "
              f"{ms['bmm'] - ms['bmm_device']:.4f} ms", flush=True)
        if (V, I, J, N) in (VC_K3_SHAPE, VC_E1_SHAPE):
            us = host_breakdown(key, b, x)
            print(f"{key} {(V, I, J, N)} f32 host us a call ({HOST_CALLS} issued back to "
                  f"back): " + ", ".join(f"{k} {v:.2f}" for k, v in us.items()), flush=True)
        nbytes, flops = 4 * V * (I * J + J * N + I * N), 2 * V * I * J * N
        bd = bound(nbytes, flops)
        out[key, (V, I, J, N)] = ms, bd
        e1 = f"E1 {ms['e1']:.4f} ms, " if "e1" in ms else ""
        print(f"{key} {(V, I, J, N)} f32: kernel {ms['kernel']:.4f} ms, {e1}plain "
              f"{ms['plain']:.4f} ms, torch.bmm {ms['bmm']:.4f} ms (medians of 25 in turns); "
              f"bound {bd[0]:.4f} ms ({bd[1]}: {nbytes / 1e6:.3f} MB, "
              f"{flops / 1e9:.4f} GFLOP); kernel {flops / ms['kernel'] / 1e9:.2f} TFLOP/s, "
              f"{nbytes / ms['kernel'] / 1e9:.3f} TB/s", flush=True)
    return out


def coarse_apply_plain(op, x, cdt):
    """The coarse apply in plain PyTorch, complex ``cdt``: sum over the
    directions k of blocks[s, k] @ x[s + offset_k] by one einsum over the
    stacked shifted operands."""
    xc = torch.complex(x.re, x.im).to(cdt)
    xs = torch.stack([torch.roll(xc, shifts=tuple(-o for o in off), dims=(0, 1, 2, 3))
                      for off in op.offsets], dim=4)
    bc = torch.complex(op.blocks_re, op.blocks_im).to(cdt)
    return torch.einsum("...kij,...kjn->...in", bc, xs)


def rel_res_cols(apply, x, b) -> float:
    """max over the columns of |A x - b| / |b|, in f64."""
    r = apply(x)
    num = sum(((p.double() - q.double()) ** 2).sum(dim=tuple(range(p.ndim - 1)))
              for p, q in zip(r, b))
    den = sum((q.double() ** 2).sum(dim=tuple(range(q.ndim - 1))) for q in b)
    return float((num / den).sqrt().max())


def coarse_path(gen, profile: bool):
    """The coarse operator at a realistic coarse lattice: built, checked to
    be positive definite, its apply held against the plain version on the
    card, then CG to 1e-6 on 32 right-hand sides.  Returns (E1 launches in
    the solve, max error of the apply, {name: median ms of one apply})."""
    t0 = time.perf_counter()
    op = coarse_operator(COARSE_LAT, block_size=COARSE_NC, mass=COARSE_MASS, key=0,
                         device="cuda")
    x = randn_c(COARSE_LAT + (COARSE_NC, COARSE_COLS), gen)
    torch.cuda.synchronize()
    print(f"coarse path: operator {COARSE_LAT} nc={COARSE_NC} ndir={op.ndir} mass "
          f"{COARSE_MASS} built in {time.perf_counter() - t0:.2f} s (host numpy + upload)",
          flush=True)

    def A(v):
        return apply_coarse(op, v)

    lo, hi = solvers.ritz_extremes(*solvers.lanczos(
        A, CArray(x.re[..., :1], x.im[..., :1]), m=60))
    print(f"coarse path: Lanczos extremes [{lo:.4f}, {hi:.4f}] (60 steps), condition "
          f"{hi / lo:.2f}", flush=True)
    if not lo > 0:
        raise AssertionError("the coarse operator is not positive definite")

    y = A(x)
    y32 = coarse_apply_plain(op, x, torch.complex64)
    y64 = coarse_apply_plain(op, x, torch.complex128)
    torch.cuda.synchronize()
    # 288 products an output; the Gauss form sums parts before multiplying
    # and subtracts two products for the real part: a factor 4 on the bound
    mags = torch.einsum("...kij,...kjn->...in", torch.complex(op.blocks_re, op.blocks_im).abs()
                        .double(), torch.stack(
                            [torch.roll(torch.complex(x.re, x.im).abs().double(),
                                        shifts=tuple(-o for o in off), dims=(0, 1, 2, 3))
                             for off in op.offsets], dim=4))
    tol = 4 * op.ndir * COARSE_NC * 2.0 ** -24 * float(mags.max())
    err = max(float((y.re - y32.real).abs().max()), float((y.im - y32.imag).abs().max()))
    e64 = max(float((y.re.double() - y64.real).abs().max()),
              float((y.im.double() - y64.imag).abs().max()))
    print(f"check coarse apply {COARSE_LAT} x {COARSE_COLS}: max|d| vs plain {err:.3e}, vs "
          f"f64 {e64:.3e} (bound {tol:.3e})", flush=True)
    if not (e64 <= tol and err <= 2 * tol):
        raise AssertionError("the coarse apply disagrees with the plain version")
    ms = time_turns({"apply": lambda: A(x),
                     "plain": lambda: coarse_apply_plain(op, x, torch.complex64)}, reps=11)
    print(f"coarse apply x {COARSE_COLS}: median {ms['apply']:.4f} ms (3 E1 launches), plain "
          f"{ms['plain']:.4f} ms, over 11 in turns", flush=True)
    del y, y32, y64, mags

    reset_counts()
    t0 = time.perf_counter()
    xs, _, k = solvers.cg(A, x, tol=COARSE_TOL, maxiter=COARSE_MAXITER, cols=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    res = rel_res_cols(A, xs, x)
    finite = all(bool(torch.isfinite(p).all()) for p in xs)
    launches = counts["batched_gemm_rowpack"]
    print(f"coarse path: cg {k} iterations to {COARSE_TOL} on {COARSE_COLS} rhs, {wall:.3f} s, "
          f"true rel residual (worst column) {res:.3e}, launches {counts} "
          f"(E1 expected {3 * k})", flush=True)
    if not (k < COARSE_MAXITER and finite and res <= 10 * COARSE_TOL and launches == 3 * k):
        raise AssertionError("coarse CG did not converge through E1")
    if profile:
        profile_run("coarse cg", lambda: solvers.cg(A, x, tol=COARSE_TOL,
                                                    maxiter=COARSE_MAXITER, cols=True))
    return launches, err, ms


def mg_rhs(lat, ncols):
    """Right-hand sides of experiments/mg_wallclock.py: numpy seed 11, real
    parts then imaginary parts, f32, on the card."""
    rng = np.random.default_rng(11)
    shape = lat + (4, 3, ncols)
    return CArray(*(torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).cuda()
                    for _ in range(2)))


def rel_diff(a, b) -> float:
    return norm(CArray(a.re - b.re, a.im - b.im)) / norm(b)


def mg_path(profile: bool):
    """MG-FGCR on the unsquared 8^4 Wilson operator at mass -1.9 beside
    CGNE, as experiments/mg_wallclock.py runs it."""
    op = wilson_operator(MG_LAT, mass=MG_MASS, key=3, layout="soa", device="cuda")
    b = mg_rhs(MG_LAT, MG_COLS)
    stages = {}
    t0 = time.perf_counter()
    P = multigrid.build_prolongator_chiral(op, K=4, setup_iters=8)
    torch.cuda.synchronize()
    stages["prolongator"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    A_c = multigrid.coarse_matrix(op, P, normal=False)
    torch.cuda.synchronize()
    stages["Galerkin"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    M = multigrid.mg_preconditioner_d(op, P, A_c=A_c, smooth_steps=4)
    torch.cuda.synchronize()
    stages["LU"] = time.perf_counter() - t0
    print(f"mg path {MG_LAT} mass {MG_MASS}: set-up {sum(stages.values()):.3f} s (chiral "
          f"prolongator 2K=8 {stages['prolongator']:.3f} s, Galerkin M={A_c.shape[0]} "
          f"{stages['Galerkin']:.3f} s, LU {stages['LU']:.3f} s)", flush=True)

    def D(u):
        return multigrid._level_apply(op, u, normal=False)

    op_h = adjoint_operator(op)

    def A(u):
        return multigrid._level_apply(op, u, True, op_h)

    reset_counts()
    t0 = time.perf_counter()
    xm, _, itm = solvers.fgcr(D, b, M=M, tol=MG_TOL, maxiter=800, restart=8, cols=True)
    torch.cuda.synchronize()
    t_mg = time.perf_counter() - t0
    mg_counts = read_counts()
    reset_counts()
    t0 = time.perf_counter()
    rhs = multigrid._level_apply(op_h, b, normal=False)
    xc, _, itc = solvers.cg(A, rhs, tol=MG_TOL, maxiter=5000, cols=True)
    torch.cuda.synchronize()
    t_cg = time.perf_counter() - t0
    cg_counts = read_counts()
    res_mg = rel_res_cols(D, xm, b)
    res_cg = rel_res_cols(A, xc, rhs)
    diff = rel_diff(xm, xc)
    print(f"mg path MG-FGCR: {itm} iterations, {11 * itm} D-applies, {t_mg:.3f} s, true "
          f"|D x - b|/|b| {res_mg:.3e}, K1 launches {mg_counts['stencil_matvec_soa']} "
          f"(expected {11 * itm})", flush=True)
    print(f"mg path CGNE: {itc} iterations, {2 * itc + 1} D-applies, {t_cg:.3f} s, true "
          f"normal residual {res_cg:.3e}, K1 launches {cg_counts['stencil_matvec_soa']} "
          f"(expected {2 * itc + 1}); D-apply ratio {(2 * itc + 1) / (11 * itm):.2f}, wall "
          f"ratio {t_cg / t_mg:.2f}, answers differ by {diff:.3e} (<= {MG_AGREE})", flush=True)
    if not (res_mg <= SOLVE_RES_TOL and res_cg <= SOLVE_RES_TOL and diff <= MG_AGREE):
        raise AssertionError("MG-FGCR and CGNE did not both converge to one answer")
    if mg_counts["stencil_matvec_soa"] != 11 * itm \
            or cg_counts["stencil_matvec_soa"] != 2 * itc + 1:
        raise AssertionError("a fine apply of the MG path did not launch K1")
    if profile:
        profile_run("mg-fgcr solve", lambda: solvers.fgcr(D, b, M=M, tol=MG_TOL, maxiter=800,
                                                          restart=8, cols=True))
    return mg_counts["stencil_matvec_soa"] + cg_counts["stencil_matvec_soa"]


def vcycle_path(gen):
    """The three-level V-cycle on the 8^4 Wilson operator at mass 0.2: one
    cycle's contraction factor, then FGCR on D^H D with the cycle beside
    CG; the operands of one apply of each coarse level held through K3 and
    E1 against the plain version.  Returns (the launches of the path's
    set-up and solve by kernel, {kernel: max abs error on those
    operands})."""
    op = wilson_operator(MG_LAT, mass=VC_MASS, key=3, layout="soa", device="cuda")
    reset_counts()
    t0 = time.perf_counter()
    h = multigrid.build_hierarchy(op, levels=3, K=4, setup_iters=8)
    V = multigrid.vcycle_preconditioner(h, cheby_degree=4)
    torch.cuda.synchronize()
    setup_counts = read_counts()
    print(f"vcycle path {MG_LAT} mass {VC_MASS}: set-up {time.perf_counter() - t0:.3f} s, "
          "levels " + ", ".join(f"{lv[0].mode} {lv[0].dim_d} ndir {lv[0].ndir} J "
                                f"{lv[0].ndir * int(np.prod(lv[0].bd))}" for lv in h)
          + f"; launches {setup_counts}", flush=True)
    # level 1 (4^4, J = 324) runs E1 and level 2 (2^4, J = 64) K3: each
    # apply makes the three Gauss products
    path_err = {}
    for level, key in ((1, "e1"), (2, "k3")):
        op_l = h[level][0]
        u = randn_c(tuple(op_l.dim_d) + multigrid._blk_shape(op_l) + (MG_COLS,), gen)
        with captured_gemms() as calls:
            multigrid._level_apply(op_l, u, normal=False)
        routes = [batched_gemm_route(b.shape[1], b.shape[2], b.dtype) for b, _ in calls]
        if routes != [{"e1": "rowpack", "k3": "small"}[key]] * 3:
            raise AssertionError(f"level {level}'s apply took routes {routes}")
        path_err[key] = max(check_gemm(key, batched_small_gemm, b, x, f"vcycle level {level}")
                            for b, x in calls)
    op_h = adjoint_operator(op)

    def A(u):
        return multigrid._level_apply(op, u, True, op_h)

    e = randn_c(MG_LAT + (4, 3), gen)
    corr = V(A(e))
    rho = norm(CArray(e.re - corr.re, e.im - corr.im)) / norm(e)
    b = mg_rhs(MG_LAT, MG_COLS)
    rhs = multigrid._level_apply(op_h, b, normal=False)
    reset_counts()
    t0 = time.perf_counter()
    xv, _, itv = solvers.fgcr(A, rhs, M=V, tol=MG_TOL, maxiter=400, restart=8, cols=True)
    torch.cuda.synchronize()
    t_v = time.perf_counter() - t0
    counts = read_counts()
    t0 = time.perf_counter()
    xc, _, itc = solvers.cg(A, rhs, tol=MG_TOL, maxiter=5000, cols=True)
    torch.cuda.synchronize()
    t_cg = time.perf_counter() - t0
    res_v, res_cg, diff = rel_res_cols(A, xv, rhs), rel_res_cols(A, xc, rhs), rel_diff(xv, xc)
    print(f"vcycle path: contraction factor of one V-cycle on a random error {rho:.4f}; "
          f"FGCR with the cycle {itv} iterations {t_v:.3f} s, true residual {res_v:.3e}; CG "
          f"{itc} iterations {t_cg:.3f} s, true residual {res_cg:.3e}; answers differ by "
          f"{diff:.3e} (<= {VC_AGREE}); launches in the FGCR solve {counts}", flush=True)
    if not (rho < 1 and res_v <= SOLVE_RES_TOL and res_cg <= SOLVE_RES_TOL
            and diff <= VC_AGREE):
        raise AssertionError("the V-cycle path did not converge to CG's answer")
    if min(counts["stencil_matvec_soa"], counts["batched_gemm_rowpack"],
           counts["batched_small_gemm"]) == 0:
        raise AssertionError(f"a level's kernel was not launched: {counts}")
    return {k: setup_counts[k] + counts[k] for k in counts}, path_err


#: the operator families' paths, at users' per-card volumes (PERF.md
#: section 1), f32, SoA: clover 24^3x48 x 8 rhs, Moebius 16^3x32 x Ls 16 x
#: 4 rhs (64 kernel columns), staggered and twisted mass on the main
#: lattice and links
CLOVER_LAT, CLOVER_MASS, CLOVER_CSW = (24, 24, 24, 48), 0.1, 1.0
MOEBIUS_LAT, MOEBIUS_LS, MOEBIUS_COLS = (16, 16, 16, 32), 16, 4
MOEBIUS = dict(M5=1.4, m_f=0.3, b5=1.5, c5=0.5)
STAGGERED_MASS, TM_MU = 0.1, 0.05
#: CGNE tolerance on the normal residual, and iteration caps above the CPU
#: rehearsals (f32, links from seed 0, 8 or 4 rhs, tol 1e-5): clover 8^4
#: 28 iterations, Moebius 4^4 x Ls 8 67, staggered 8^3x16 134
FAMILY_TOL = 1e-5
CLOVER_MAXITER, MOEBIUS_MAXITER, STAGGERED_MAXITER = 500, 1500, 2000
#: the unsquared true residual |A x - b| / |b| after CGNE to 1e-5: |A^H r|
#: >= s_min |r|, so it may exceed the normal residual by the condition
#: number; the rehearsals gave 9.8e-6 (clover), 2.0e-5 (Moebius), 2.7e-5
#: (staggered)
UNSQUARED_TOL = 1e-3
#: gamma5 = diag(1, 1, -1, -1) in the chiral basis, over the 12 SoA
#: features (spin-major, colour repeated)
G5_SIGNS = (1.0,) * 6 + (-1.0,) * 6
#: K1's runtime-shape route at the JAX package's test shapes and an
#: asymmetric one; the clover term's templated shape; the lattice and
#: columns they are timed at
K1_RT_SHAPES = ((2, 2, 3, 3), (1, 1, 2, 2), (2, 1, 4, 2))
CLOVER_SHAPE = (1, 1, 12, 12)
#: K1's key for its checks at the Moebius column count
MOEBIUS_SHAPE = "moebius columns"
K1_TIME_LAT, K1_TIME_COLS = (16, 16, 16, 32), 8
#: the families' AoS check: lattice, Ls, columns; max |AoS - SoA| allowed,
#: relative to max |SoA|: f32 sums of up to 324 terms in other orders
AOS_LAT, AOS_LS, AOS_COLS, AOS_TOL = (4, 4, 8, 8), 4, 2, 1e-5
#: fault P2's path: the Moebius operator at its default dtype (complex128)
#: in the SoA layout, 8^3x16 x Ls 8 x 2 rhs (small, so the phase stays
#: short), then a complex128 SoA Wilson operator on the main lattice and
#: links; fault P3's default call: mobius_operator(DEFAULT_LAT), AoS at
#: complex128 (J = 324: E1 at f64), against its SoA twin
P2_LAT, P2_LS, P2_COLS, DEFAULT_LAT = (8, 8, 8, 16), 8, 2, (4, 4, 4, 8)
#: E2 shapes: the probe's and one that resolves on the card; E3's: the
#: probe's 64^4 f32
E2_SHAPES = ((256, 32, 256), (4096, 32, 256))
E3_SHAPE = (64, 64, 64, 64)


def g5(v: CArray, feature_axis: int) -> CArray:
    """gamma5 on the 12 spin-colour features of a SoA field."""
    signs = torch.tensor(G5_SIGNS, device=v.re.device, dtype=v.re.dtype)
    shape = [1] * v.re.ndim
    shape[feature_axis] = 12
    signs = signs.reshape(shape)
    return CArray(signs * v.re, signs * v.im)


def stencil_bound(blocks, kron, x, offsets, bi, bd):
    """(ms, by) of one SoA matvec: the bytes of the blocks once (in their
    type), of x read and y written (in the field's), and the operations of
    the BSROperator model, at the f64 peak for f64 fields."""
    ki, kd = (1, 1) if kron is None else tuple(kron.re.shape[1:])
    op = BSROperator(blocks, kron, offsets, tuple(x.re.shape[2:]), (bi,), (bd,),
                     (ki,) if kron is not None else (), (kd,) if kron is not None else ())
    n = x.re.shape[0]
    nbytes = 2 * (blocks.re.numel() * blocks.re.element_size()
                  + (x.re.numel() // (kd * bd) * (ki * bi) + x.re.numel()) * x.re.element_size())
    return bound(nbytes, op.flops_per_matvec(n),
                 F64_FLOPS if x.re.dtype == torch.float64 else F32_FLOPS)


def time_stencil(blocks, kron, x, offsets, bi, bd, reps, label):
    """K1 (the route of its shape) and the plain version on one matvec, in
    turns, beside the bound.  Returns ({"kernel", "plain"}: median ms,
    (bound ms, by))."""
    args = (blocks, kron, x, offsets, bi, bd)
    ms = time_turns({"kernel": lambda: stencil_matvec_soa(*args),
                     "plain": lambda: stencil_matvec_soa_reference(*args)}, reps)
    bd_ = stencil_bound(*args)
    print(f"time {label}: kernel median {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms "
          f"over {reps} in turns; bound {bd_[0]:.4f} ms ({bd_[1]})", flush=True)
    return ms, bd_


def shape_operands(shape, lat, n, ndir, gen, st=torch.float32, ft=torch.float32):
    ki, kd, bi, bd = shape
    blocks = randn_c((ndir, bi * bd) + lat, gen, st)
    kron = randn_c((ndir, ki, kd), gen) if (ki, kd) != (1, 1) else None
    return blocks, kron, randn_c((n, kd * bd) + lat, gen, ft)


def k1_shape_path(gen):
    """K1 at the clover term's shape and on its runtime-shape route: each
    against the plain version at small shapes on full and packed parity
    (three dtype pairs), and at the Moebius column count (f32); the
    runtime-shape route against the templated
    one, bit for bit, at the templated Wilson and staggered shapes; then
    each shape driven once through ``stencil_matvec_soa`` at K1_TIME_LAT x
    K1_TIME_COLS (the counts set to 0 just before and read just after),
    checked there and timed in turns with the plain version.  Returns
    {shape: (launches, max error, ms, bound)} and the max error at the
    Moebius column count."""
    err = {}
    for shape in (CLOVER_SHAPE,) + K1_RT_SHAPES:
        err[shape] = 0.0
        for lat, n, offsets, parity in (((3, 5, 6, 10), 3, WILSON_OFFSETS, None),
                                        ((2, 4, 8, 32), 9, WILSON_OFFSETS[:1], None),
                                        ((2, 4, 3, 8), 2, HOPPING, 0),
                                        ((3, 5, 4, 7), 1, HOPPING, 1)):
            for st, ft in DTYPE_PAIRS:
                blocks, kron, x = shape_operands(shape, lat, n, len(offsets), gen, st, ft)
                err[shape] = max(err[shape], compare(
                    blocks, kron, x, offsets, f"K1 {shape} {lat} n={n} p={parity} {st}/{ft}",
                    packed_parity=parity, bi=shape[2], bd=shape[3]))
    for lat, parity in (((3, 5, 6, 10), None), ((2, 4, 3, 8), 0), ((3, 5, 4, 7), 1)):
        offsets = WILSON_OFFSETS if parity is None else HOPPING
        blocks, kron, x = shape_operands((4, 4, 3, 3), lat, MOEBIUS_COLS * MOEBIUS_LS,
                                         len(offsets), gen)
        err[MOEBIUS_SHAPE] = max(err.get(MOEBIUS_SHAPE, 0.0), compare(
            blocks, kron, x, offsets, f"K1 (4,4,3,3) {lat} n={MOEBIUS_COLS * MOEBIUS_LS} "
            f"p={parity}", packed_parity=parity))
    for shape in ((4, 4, 3, 3), (1, 1, 3, 3)):
        for parity in (None, 1):
            offsets = WILSON_OFFSETS if parity is None else HOPPING
            blocks, kron, x = shape_operands(shape, (3, 5, 6, 10), 3, len(offsets), gen)
            args = (blocks, kron, x, offsets, 3, 3)
            k1 = stencil_matvec_soa(*args, packed_parity=parity)
            rt = stencil_matvec_soa_rt(*args, packed_parity=parity)
            if not all(torch.equal(g, w) for g, w in zip(k1, rt)):
                raise AssertionError(f"runtime-shape route {shape} p={parity} differs from "
                                     "the templated route")
    print("check K1 runtime-shape route at (4,4,3,3) and (1,1,3,3), full and packed: equal "
          "to the templated route bit for bit", flush=True)

    path = {shape: shape_operands(shape, K1_TIME_LAT, K1_TIME_COLS,
                                  1 if shape == CLOVER_SHAPE else 9, gen)
            for shape in (CLOVER_SHAPE,) + K1_RT_SHAPES}
    offsets = {shape: WILSON_OFFSETS[:1] if shape == CLOVER_SHAPE else WILSON_OFFSETS
               for shape in path}
    reset_counts()
    for shape, (blocks, kron, x) in path.items():
        stencil_matvec_soa(blocks, kron, x, offsets[shape], shape[2], shape[3])
    torch.cuda.synchronize()
    routes = (dict(stencil_matvec_soa.by_shape), dict(stencil_matvec_soa_rt.by_shape))
    print(f"K1 shape path {K1_TIME_LAT} n={K1_TIME_COLS}: launches by shape, templated "
          f"{routes[0]}, runtime {routes[1]}", flush=True)
    if routes != ({CLOVER_SHAPE: 1}, {shape: 1 for shape in K1_RT_SHAPES}):
        raise AssertionError("a K1 shape did not launch its route once")
    out = {}
    for shape, (blocks, kron, x) in path.items():
        e = compare(blocks, kron, x, offsets[shape], f"K1 {shape} {K1_TIME_LAT} "
                    f"n={K1_TIME_COLS}", bi=shape[2], bd=shape[3])
        ms, bd_ = time_stencil(blocks, kron, x, offsets[shape], shape[2], shape[3], 7,
                               f"K1 {shape} {K1_TIME_LAT} n={K1_TIME_COLS}")
        out[shape] = 1, max(err[shape], e), ms, bd_
    return out, err[MOEBIUS_SHAPE]


def family_solve(label, A, Ah, b, maxiter):
    """CGNE (``solvers.cgne``) to FAMILY_TOL, the counts set to 0 just
    before and read just after; then its true residuals in f64: the normal
    one against SOLVE_RES_TOL, the unsquared one against UNSQUARED_TOL.
    Returns (iterations, {route: launches by shape})."""
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    x, _, it = solvers.cgne(A, Ah, b, tol=FAMILY_TOL, maxiter=maxiter)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    shapes = {"templated": dict(stencil_matvec_soa.by_shape),
              "runtime": dict(stencil_matvec_soa_rt.by_shape)}
    peak = torch.cuda.max_memory_allocated()
    ax = A(x)
    r = CArray(ax.re - b.re, ax.im - b.im)
    res = norm(r) / norm(b)
    normal = norm(Ah(r)) / norm(Ah(b))
    finite = all(bool(torch.isfinite(p).all()) for p in x)
    print(f"{label}: cgne {it} iterations to {FAMILY_TOL}, {wall:.3f} s, peak memory "
          f"{peak / 2 ** 30:.2f} GiB; true normal residual {normal:.3e} (<= {SOLVE_RES_TOL}), "
          f"true |A x - b|/|b| {res:.3e} (<= {UNSQUARED_TOL}); launches {counts}, by shape "
          f"{shapes}", flush=True)
    if tuple(x.re.shape) != tuple(b.re.shape) or not finite:
        raise AssertionError(f"{label}: the solution has the wrong shape or is not finite")
    if not (it < maxiter and normal <= SOLVE_RES_TOL and res <= UNSQUARED_TOL):
        raise AssertionError(f"{label}: the solve did not converge")
    if counts["stencil_matvec_soa_rt"] or counts["batched_small_gemm"] \
            or counts["batched_gemm_rowpack"]:
        raise AssertionError(f"{label}: a kernel off the SoA path was launched")
    return it, shapes


def clover_path(gen, profile: bool):
    """The Wilson-clover solve: the operator at CLOVER_LAT (links from
    numpy seed 0, field strength and blocks formed on the card), the
    clover term's K1 (1, 1, 12, 12) held against the plain version on its
    operands and timed, then CGNE with A^H = gamma5 A gamma5 to 1e-5 on 8
    rhs, every apply one K1 launch of each shape.  Returns (the clover
    term's launches in the solve, its max error, ms, bound)."""
    t0 = time.perf_counter()
    op = wilson_clover_operator(CLOVER_LAT, mass=CLOVER_MASS, c_sw=CLOVER_CSW, key=0,
                                layout="soa", device="cuda")
    b = randn_c((MAIN_COLS, 12) + CLOVER_LAT, gen)
    torch.cuda.synchronize()
    print(f"clover path {CLOVER_LAT} mass {CLOVER_MASS} c_sw {CLOVER_CSW}: set-up "
          f"{time.perf_counter() - t0:.2f} s (host links and Wilson blocks, field strength "
          f"and clover blocks on the card)", flush=True)
    cl = op.clover
    err = compare(cl.blocks, None, b, cl.offsets, f"K1 {CLOVER_SHAPE} clover term "
                  f"{CLOVER_LAT} n={MAIN_COLS}", bi=12, bd=12)
    ms, bd_ = time_stencil(cl.blocks, None, b, cl.offsets, 12, 12, 5,
                           f"K1 {CLOVER_SHAPE} clover term {CLOVER_LAT} n={MAIN_COLS}")

    def A(v):
        return apply_clover(op, v)

    def Ah(v):
        return g5(A(g5(v, 1)), 1)

    it, shapes = family_solve(f"clover path {CLOVER_LAT} x {MAIN_COLS} rhs", A, Ah, b,
                              CLOVER_MAXITER)
    applies = 1 + 2 * it
    if shapes["templated"] != {(4, 4, 3, 3): applies, CLOVER_SHAPE: applies}:
        raise AssertionError(f"clover path launches {shapes}, expected {applies} of each "
                             "shape")
    if profile:
        profile_run("clover cgne", lambda: solvers.cgne(A, Ah, b, tol=FAMILY_TOL,
                                                        maxiter=CLOVER_MAXITER))
    return applies, err, ms, bd_


def moebius_path(gen, profile: bool):
    """The Moebius solve at MOEBIUS_LAT x Ls MOEBIUS_LS x 4 rhs: both
    projector sides (links from numpy seed 0), the adjoint identity <u, A
    v> = <A^H u, v> with A^H = (Gamma5 R5) D_left (Gamma5 R5), K1 at the
    64 kernel columns held against the plain version and timed, then CGNE
    to 1e-5, every apply one K1 launch.  Returns (launches in the solve,
    max error, ms, bound)."""
    t0 = time.perf_counter()
    links = random_su3_links(np.random.default_rng(0), MOEBIUS_LAT)
    kw = dict(Ls=MOEBIUS_LS, links=links, dtype=torch.complex64, layout="soa",
              device="cuda", **MOEBIUS)
    Dr = mobius_operator(MOEBIUS_LAT, **kw)
    Dl = mobius_operator(MOEBIUS_LAT, projector_side="left", **kw)
    del links
    shape = (MOEBIUS_COLS, MOEBIUS_LS, 12) + MOEBIUS_LAT
    b, u = randn_c(shape, gen), randn_c(shape, gen)
    torch.cuda.synchronize()
    print(f"moebius path {MOEBIUS_LAT} Ls {MOEBIUS_LS} {MOEBIUS}: set-up "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    def A(v):
        return apply_domain_wall(Dr, v)

    def R5g5(v):
        return g5(CArray(v.re.flip(1), v.im.flip(1)), 2)

    def Ah(v):
        return R5g5(apply_domain_wall(Dl, R5g5(v)))

    ab = A(b)
    lhs, rhs = cinner(u, ab), cinner(Ah(u), b)
    adj_bound = 1e-5 * norm(u) * norm(ab)
    print(f"moebius path adjoint identity: <u, A b> = {lhs:.6e}, <A^H u, b> = {rhs:.6e}, "
          f"|difference| {abs(lhs - rhs):.3e} (<= {adj_bound:.3e})", flush=True)
    if not abs(lhs - rhs) <= adj_bound:
        raise AssertionError("the Moebius adjoint pair fails the adjoint identity")
    del ab
    w, ncols = Dr.wilson, MOEBIUS_COLS * MOEBIUS_LS
    xf = CArray(b.re.reshape((ncols, 12) + MOEBIUS_LAT), b.im.reshape((ncols, 12) + MOEBIUS_LAT))
    err = compare(w.blocks, w.kron, xf, w.offsets, f"K1 (4,4,3,3) {MOEBIUS_LAT} {ncols} "
                  "columns (Moebius)")
    ms, bd_ = time_stencil(w.blocks, w.kron, xf, w.offsets, 3, 3, 5,
                           f"K1 (4,4,3,3) {MOEBIUS_LAT} {ncols} columns (Moebius)")
    del xf, u
    it, shapes = family_solve(f"moebius path {MOEBIUS_LAT} Ls {MOEBIUS_LS} x {MOEBIUS_COLS} "
                              "rhs", A, Ah, b, MOEBIUS_MAXITER)
    applies = 1 + 2 * it
    if shapes["templated"] != {(4, 4, 3, 3): applies}:
        raise AssertionError(f"moebius path launches {shapes}, expected {applies}")
    if profile:
        profile_run("moebius cgne", lambda: solvers.cgne(A, Ah, b, tol=FAMILY_TOL,
                                                         maxiter=MOEBIUS_MAXITER))
    return applies, err, ms, bd_


def staggered_path(links, gen):
    """The staggered solve on the main lattice and links, 8 rhs: K1 (1, 1,
    3, 3) held against the plain version on D and D^H and timed, then CGNE
    with ``adjoint_operator`` to 1e-5, every apply one K1 launch.  Returns
    (launches in the solve, max error, ms, bound)."""
    t0 = time.perf_counter()
    op = staggered_operator(MAIN_LAT, mass=STAGGERED_MASS, links=links, layout="soa",
                            device="cuda")
    op_h = adjoint_operator(op)
    b = randn_c((MAIN_COLS, 3) + MAIN_LAT, gen)
    torch.cuda.synchronize()
    print(f"staggered path {MAIN_LAT} mass {STAGGERED_MASS}: set-up "
          f"{time.perf_counter() - t0:.2f} s (host blocks from the main links)", flush=True)
    err = max(compare(o.blocks, None, b, o.offsets, f"K1 (1,1,3,3) staggered {name} "
                      f"{MAIN_LAT} n={MAIN_COLS}") for name, o in (("D", op), ("D^H", op_h)))
    ms, bd_ = time_stencil(op.blocks, None, b, op.offsets, 3, 3, 5,
                           f"K1 (1,1,3,3) staggered {MAIN_LAT} n={MAIN_COLS}")
    it, shapes = family_solve(f"staggered path {MAIN_LAT} x {MAIN_COLS} rhs",
                              lambda v: apply_staggered(op, v),
                              lambda v: apply_staggered(op_h, v), b, STAGGERED_MAXITER)
    applies = 1 + 2 * it
    if shapes["templated"] != {(1, 1, 3, 3): applies}:
        raise AssertionError(f"staggered path launches {shapes}, expected {applies}")
    return applies, err, ms, bd_


def twisted_mass_path(links, b):
    """The twisted-mass solve on the main lattice, links and right-hand
    sides: ``cg_solve`` for CG_ITERS iterations through K1 with the complex
    centre factor, to a true normal residual <= 1e-5.  Returns the K1
    launches of the solve."""
    t0 = time.perf_counter()
    op = twisted_mass_operator(MAIN_LAT, mass=MASS, mu=TM_MU, links=links, layout="soa",
                               device="cuda")
    torch.cuda.synchronize()
    print(f"twisted-mass path {MAIN_LAT} mass {MASS} mu {TM_MU}: set-up "
          f"{time.perf_counter() - t0:.2f} s; centre spin factor imaginary part max "
          f"{float(op.kron.im[0].abs().max()):.3f}", flush=True)
    reset_counts()
    t0 = time.perf_counter()
    x, rs = cg_solve(op, b, n_iters=CG_ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()["stencil_matvec_soa"]
    op_h = adjoint_operator(op)
    dhb = apply_wilson(op_h, b)
    dx = apply_wilson(op, x)
    r = apply_wilson(op_h, CArray(dx.re - b.re, dx.im - b.im))
    res = norm(r) / norm(dhb)
    print(f"twisted-mass path {MAIN_LAT} x {MAIN_COLS} rhs: cg_solve {CG_ITERS} iters "
          f"{wall:.3f} s, true normal residual {res:.3e} (<= 1e-5), true |D x - b|/|b| "
          f"{norm(CArray(dx.re - b.re, dx.im - b.im)) / norm(b):.3e}, launches {launches} "
          f"(expected {1 + 2 * CG_ITERS})", flush=True)
    if not (res <= 1e-5 and launches == 1 + 2 * CG_ITERS
            and all(bool(torch.isfinite(p).all()) for p in x)):
        raise AssertionError("the twisted-mass solve did not converge through K1")
    return launches


@contextlib.contextmanager
def plain_stencil():
    """Runs the SoA stencil applies of ``bsr.apply_stencil_soa`` through
    the plain version while active."""
    inner = bsr.stencil_matvec_soa
    bsr.stencil_matvec_soa = stencil_matvec_soa_reference
    try:
        yield
    finally:
        bsr.stencil_matvec_soa = inner


def max_rel(got: CArray, want: CArray, tol: float, label: str) -> float:
    """max |got - want| over both parts, in f64; raises above ``tol`` of
    max |want|; returns the max abs error."""
    err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.double().abs().max()) for w in want)
    ok = got.re.shape == want.re.shape and err <= tol * scale
    print(f"check {label}: max|d| {err:.3e} max|y| {scale:.3e} rel {err / scale:.3e} "
          f"(<= {tol}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise AssertionError(f"{label}: disagrees")
    return err


def p2_path(links, b, gen):
    """Fault P2, the f64 SoA operators on the card, and K1's f32-block/
    bf16-field pair: a default-dtype (complex128) SoA ``mobius_operator``
    at P2_LAT x Ls P2_LS and a complex128 SoA ``wilson_operator`` on the
    main lattice and links, each applied through K1's f64 route, and the
    Wilson operator's blocks cast to f32 applied to bf16 fields, the counts
    set to 0 just before and read after each apply; each against the plain
    version on the card, then K1 timed at both pairs on the Wilson shape.
    Returns {pair: (launches, max error, {"kernel", "plain"}: ms, bound)}."""
    t0 = time.perf_counter()
    dw = mobius_operator(P2_LAT, Ls=P2_LS, layout="soa", device="cuda")
    op = wilson_operator(MAIN_LAT, mass=MASS, links=links, dtype=torch.complex128,
                         layout="soa", device="cuda")
    op_b = bsr_cast_storage(op, torch.float32)
    xd = randn_c((P2_COLS, P2_LS, 12) + P2_LAT, gen, torch.float64)
    b64, b16 = b.to(torch.float64), b.to(torch.bfloat16)
    torch.cuda.synchronize()
    print(f"p2 path: Moebius {P2_LAT} Ls {P2_LS} {dw.wilson.blocks_re.dtype}, Wilson "
          f"{MAIN_LAT} {op.blocks_re.dtype} blocks built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    launches = []
    ys = []
    for apply, o, v in ((apply_domain_wall, dw, xd), (apply_wilson, op, b64),
                        (apply_wilson, op_b, b16)):
        reset_counts()
        ys.append(apply(o, v))
        torch.cuda.synchronize()
        launches.append(read_counts()["stencil_matvec_soa"])
    print(f"p2 path: K1 launches of the Moebius f64, Wilson f64 and f32/bf16 applies "
          f"{launches}", flush=True)
    if launches != [1, 1, 1] or ys[0].re.dtype != torch.float64 or ys[2].re.dtype != b16.re.dtype:
        raise AssertionError("an f64 or f32/bf16 apply did not launch K1 once")
    with plain_stencil():
        want = apply_domain_wall(dw, xd)
    e_m = max_rel(ys[0], want, TOL[torch.float64],
                  f"Moebius {P2_LAT} Ls {P2_LS} complex128 SoA apply vs plain")
    del ys, want, dw, xd
    e_w = compare(op.blocks, op.kron, b64, op.offsets, f"K1 f64 {MAIN_LAT} n={MAIN_COLS}")
    ms64, bd64 = time_stencil(op.blocks, op.kron, b64, op.offsets, 3, 3, 3,
                              f"K1 f64 {MAIN_LAT} n={MAIN_COLS}")
    del op, b64
    e_b = compare(op_b.blocks, op_b.kron, b16, op_b.offsets,
                  f"K1 f32 blocks/bf16 fields {MAIN_LAT} n={MAIN_COLS}")
    ms16, bd16 = time_stencil(op_b.blocks, op_b.kron, b16, op_b.offsets, 3, 3, 3,
                              f"K1 f32 blocks/bf16 fields {MAIN_LAT} n={MAIN_COLS}")
    return {"f64": (2, max(e_m, e_w), ms64, bd64), "f32/bf16": (1, e_b, ms16, bd16)}


def default_call_path(gen):
    """Fault P3: ``mobius_operator(DEFAULT_LAT)``, the default call (AoS,
    complex128, on the card), applied through E1 at f64 (three Gauss
    products of J = 324, the counts set to 0 just before and read just
    after), against the SoA operator built alike (K1's f64 route).
    Returns (E1 launches, max abs error)."""
    d_aos = mobius_operator(DEFAULT_LAT)
    d_soa = mobius_operator(DEFAULT_LAT, layout="soa", device="cuda")
    x = randn_c((2, 8, 12) + DEFAULT_LAT, gen, torch.float64)
    want = dwf_to_aos(apply_domain_wall(d_soa, x))
    xa = dwf_to_aos(x)
    reset_counts()
    with captured_gemms() as calls:
        got = apply_domain_wall(d_aos, xa)
    torch.cuda.synchronize()
    counts = read_counts()
    types = sorted({str(bb.dtype) for bb, _ in calls})
    print(f"default call mobius_operator({DEFAULT_LAT}): {type(d_aos).__name__} mode "
          f"{d_aos.mode}, products {[tuple(bb.shape) for bb, _ in calls]} {types}, launches "
          f"{counts}", flush=True)
    if not (isinstance(d_aos, BSROperator) and d_aos.mode == "stencil" and types == ["torch.float64"]
            and counts["batched_gemm_rowpack"] == 3 and counts["batched_small_gemm"] == 0):
        raise AssertionError("the default Moebius call did not apply through E1 at f64")
    err = max_rel(got, want, TOL[torch.float64],
                  f"default-call Moebius {DEFAULT_LAT} AoS f64 vs SoA f64")
    return counts["batched_gemm_rowpack"], err


def dwf_to_aos(v: CArray) -> CArray:
    """[n, Ls, 12, *lat] -> [Ls, *lat, 4, 3, n]."""
    n, ls = v.re.shape[:2]
    lat = tuple(v.re.shape[3:])
    return CArray(*(p.reshape((n, ls, 4, 3) + lat).permute(1, 4, 5, 6, 7, 2, 3, 0)
                    .contiguous() for p in v))


def families_aos_check(gen):
    """Every family's AoS apply against its SoA apply on the card, at
    AOS_LAT (Ls AOS_LS), from the same links (numpy seed 0): the AoS
    applies launch K3 (staggered J = 27, the clover term J = 12) and E1
    (Shamir J = 132, Moebius J = 324), three Gauss products an apply; the
    twisted-mass AoS apply is a spin-factor einsum.  Returns ({kernel:
    launches}, max abs error)."""
    links = random_su3_links(np.random.default_rng(0), AOS_LAT)
    lat, n, ls = AOS_LAT, AOS_COLS, AOS_LS
    kw = dict(links=links, dtype=torch.complex64, device="cuda")
    dwf = dict(Ls=ls, M5=1.8, m_f=0.1)
    cases = (
        ("twisted mass", twisted_mass_operator, dict(mass=0.1, mu=0.05), apply_wilson, 4, 0),
        ("staggered", staggered_operator, dict(mass=0.1), apply_staggered, 1, "k3"),
        ("clover", wilson_clover_operator, dict(mass=0.1, c_sw=1.0), apply_clover, 4, "k3"),
        ("shamir", domain_wall_operator, dwf, apply_domain_wall, None, "e1"),
        ("moebius right", mobius_operator, dict(b5=1.5, c5=0.5, **dwf), apply_domain_wall,
         None, "e1"),
        ("moebius left", mobius_operator, dict(b5=1.5, c5=0.5, projector_side="left", **dwf),
         apply_domain_wall, None, "e1"))
    launches, err = {"k3": 0, "e1": 0}, 0.0
    for name, build, params, apply, spin, kernel in cases:
        op_s = build(lat, layout="soa", **kw, **params)
        op_a = build(lat, layout="aos", **kw, **params)
        if spin is None:
            x = randn_c((n, ls, 12) + lat, gen)
            to_aos = dwf_to_aos
        else:
            x = randn_c((n, 3 * spin) + lat, gen)

            def to_aos(v, spin=spin):
                a = soa_to_aos(v, 4, spin, 3)
                return CArray(*(p.reshape(lat + ((3,) if spin == 1 else (spin, 3)) + (n,))
                                .contiguous() for p in a))
        want = to_aos(apply(op_s, x))
        reset_counts()
        got = apply(op_a, to_aos(x))
        torch.cuda.synchronize()
        counts = read_counts()
        e = max(float((g - w).abs().max()) for g, w in zip(got, want))
        scale = max(float(w.abs().max()) for w in want)
        expect = {"k3": 0, "e1": 0}
        if kernel:
            expect[kernel] = 3
        seen = {"k3": counts["batched_small_gemm"], "e1": counts["batched_gemm_rowpack"]}
        ndir = op_a.ndir if isinstance(op_a, BSROperator) else \
            f"{op_a.hop.ndir} + {op_a.clover.ndir}"
        print(f"check {name} AoS apply {lat} n={n} against SoA: max|d| {e:.3e} rel "
              f"{e / scale:.3e} (<= {AOS_TOL}), ndir {ndir}, launches {seen}", flush=True)
        if not (e <= AOS_TOL * scale and seen == expect):
            raise AssertionError(f"{name}: the AoS apply disagrees with the SoA apply or "
                                 f"launched {seen}, expected {expect}")
        for k in launches:
            launches[k] += seen[k]
        err = max(err, e)
    return launches, err


def e2_path(gen):
    """E2, the bf16 roll-plus-add, in both variants through ``roll_add``:
    each once at the probe's shape with the counts set to 0 just before and
    read just after; f32 bit-exact against the plain version, bf16x2
    within one bf16 ulp (elements that differ counted); then each timed at
    E2_SHAPES in turns with the plain version and torch.roll + add in
    bf16, beside the bytes bound.  Returns {variant: (launches, max abs
    error, {shape: {name: ms}}, {shape: bound})}."""
    xs = {shape: torch.randn(shape, generator=gen, device="cuda").bfloat16()
          for shape in E2_SHAPES}
    x = xs[E2_SHAPES[0]]
    reset_counts()
    got = {v: roll_add(x, v) for v in VARIANTS}
    torch.cuda.synchronize()
    launches = read_counts()["roll_add"]
    if launches != len(VARIANTS):
        raise AssertionError(f"E2 path launches {launches}, expected {len(VARIANTS)}")
    out = {}
    for v in VARIANTS:
        errs = 0.0
        for shape, xx in xs.items():
            y = roll_add(xx, v)
            want = roll_add_reference(xx)
            d = (y.float() - want.float()).abs()
            ulp = 2.0 ** -7 * torch.clamp_min(want.float().abs(), 2.0 ** -126)
            ndiff = int((y != want).sum())
            ok = bool((d <= ulp).all()) and (v != "f32" or ndiff == 0)
            print(f"check E2 {v} {shape}: {ndiff} of {xx.numel()} elements differ from the "
                  f"plain version, max|d| {float(d.max()):.3e} "
                  f"{'(bit-exact required)' if v == 'f32' else '(<= 1 bf16 ulp)'} "
                  f"{'ok' if ok else 'FAIL'}", flush=True)
            if not ok:
                raise AssertionError(f"E2 {v} disagrees with the plain version")
            errs = max(errs, float(d.max()))
        out[v] = [launches // len(VARIANTS), errs, {}, {}]
    del got
    for shape, xx in xs.items():
        fns = {v: (lambda v=v: roll_add(xx, v)) for v in VARIANTS}
        fns.update(plain=lambda: roll_add_reference(xx),
                   roll_bf16=lambda: torch.roll(xx, 1, dims=-1) + xx)
        ms = time_turns(fns, reps=25)
        bd_ = bound(2 * xx.numel() * xx.element_size(), xx.numel())
        print(f"time E2 {shape} bf16: " + ", ".join(f"{k} {t:.4f} ms" for k, t in ms.items())
              + f" (medians of 25 in turns); bound {bd_[0]:.4f} ms ({bd_[1]})", flush=True)
        for v in VARIANTS:
            out[v][2][shape] = {"kernel": ms[v], "plain": ms["plain"],
                                "roll_bf16": ms["roll_bf16"]}
            out[v][3][shape] = bd_
    return out


def e3_path(gen):
    """E3, the transpose tile sweep, at E3_SHAPE f32 perm (3,2,1,0): each
    tile once with the counts set to 0 just before and read just after,
    each exact against ``x.permute(3,2,1,0).contiguous()``; then each
    timed in turns with that call and K2, beside the bytes bound.
    Returns {tile: (launches, max abs error, ms)}, the call's ms and the
    bound."""
    x = torch.randn(E3_SHAPE, generator=gen, device="cuda")
    perm = PERMS["tzyx"]
    want = permute_4d_reference(x, perm)
    reset_counts()
    got = {tile: permute_4d_tiled(x, perm, tile) for tile in TILES}
    torch.cuda.synchronize()
    launches = read_counts()["permute_4d_tiled"]
    if launches != len(TILES):
        raise AssertionError(f"E3 path launches {launches}, expected {len(TILES)}")
    err = {tile: exact(y, want, f"E3 tile {tile}") for tile, y in got.items()}
    print(f"check E3 {E3_SHAPE} f32 tzyx: every tile {TILES} bit-exact", flush=True)
    del got, want
    fns = {tile: (lambda tile=tile: permute_4d_tiled(x, perm, tile)) for tile in TILES}
    fns.update(k2=lambda: permute_4d(x, perm), call=lambda: permute_4d_reference(x, perm))
    ms = time_turns(fns, reps=15)
    nbytes = 2 * x.numel() * x.element_size()
    bd_ = bound(nbytes, 0)
    print(f"time E3 {E3_SHAPE} f32 tzyx (medians of 15 in turns): "
          + ", ".join(f"{k} {t:.4f} ms ({nbytes / t / 1e6:.1f} GB/s)" for k, t in ms.items())
          + f"; bound {bd_[0]:.4f} ms ({bd_[1]})", flush=True)
    return {tile: (1, err[tile], ms[tile]) for tile in TILES}, ms["call"], bd_


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile one warm solve, one warm even-odd solve, one "
                             "warm dense path, one warm coarse CG, one warm MG-FGCR solve "
                             "and one warm clover and Moebius CGNE with torch.profiler")
    args = parser.parse_args()
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: torch.cuda.is_available() is false; this smoke run "
                 "needs an NVIDIA GPU and has no CPU fallback")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _cuda.library()
    nvcc = ("already built" if _cuda.build_seconds is None
            else f"nvcc {_cuda.build_seconds:.2f} s")
    print(f"kernel library {_cuda.BUILD}: {nvcc}, build and load "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    small_checks(gen)
    packed_checks(gen)
    schedule_checks(gen)
    gemm_err = gemm_checks(gen)
    gemm_ms = time_gemms(gen)
    c_launches, c_err, _ = coarse_path(gen, args.profile)
    mg_launches = mg_path(args.profile)
    vc_launches, vc_err = vcycle_path(gen)
    if min(c_launches, mg_launches) == 0:
        raise AssertionError("the coarse or MG path launched none of its kernels")
    bench_shape(gen)
    k1_shapes, moebius_cols_err = k1_shape_path(gen)
    aos_launches, aos_err = families_aos_check(gen)
    dc_launches, dc_err = default_call_path(gen)
    clover = clover_path(gen, args.profile)
    moebius = moebius_path(gen, args.profile)
    moebius = (moebius[0], max(moebius[1], moebius_cols_err)) + moebius[2:]
    op, b, links = main_operator(gen)
    launches, err = wilson_path(op, b, args.profile)
    if launches == 0:
        raise AssertionError("the Wilson path launched no stencil kernel")
    s_launches, s_err, ms = schedule_path(op, b)
    eo_launches, eo_err, eo_ms, eo_bound = eo_path(op, b, args.profile)
    if eo_launches == 0:
        raise AssertionError("the even-odd path launched no packed stencil kernel")
    k1_bound = bound(op.memops_per_matvec(MAIN_COLS, itemsize=8),
                     op.flops_per_matvec(MAIN_COLS))
    del op
    p2 = p2_path(links, b, gen)
    tm_launches = twisted_mass_path(links, b)
    del b
    staggered = staggered_path(links, gen)
    del links
    if min(clover[0], moebius[0], staggered[0], tm_launches) == 0:
        raise AssertionError("a family's path launched no stencil kernel")
    p_err = permute_checks(gen)
    p_launches, d_err = dense_path(gen, args.profile)
    if p_launches == 0:
        raise AssertionError("the dense path launched no permute kernel")
    p_ms, (p_bound_ms, p_bound_by) = time_permute(gen)
    e2 = e2_path(gen)
    e3, e3_call_ms, e3_bound = e3_path(gen)

    print(f"chip_smoke.py wall {time.perf_counter() - t_start:.1f} s, the build included",
          flush=True)
    stencil = {"route": "cuda", "library_ms": None}
    print(json.dumps({"kernels": [{
        "name": "stencil_matvec_soa", **stencil,
        "source": "superbblas_tpu_torch/csrc/stencil_soa.cu",
        "replaces": "superbblas_tpu/ops/stencil_pallas.py:368",
        "launches": launches, "max_abs_err": err, "ms": ms["k1"], "plain_ms": ms["plain"],
        "bound_ms": k1_bound[0], "bound_by": k1_bound[1]}] + [{
        "name": f"stencil_matvec_soa[{pair}]", **stencil,
        "source": "superbblas_tpu_torch/csrc/stencil_soa.cu",
        "replaces": "superbblas_tpu/ops/stencil_pallas.py:368",
        "launches": n_launch, "max_abs_err": e, "ms": t["kernel"], "plain_ms": t["plain"],
        "bound_ms": bd_[0], "bound_by": bd_[1]}
        for pair, (n_launch, e, t, bd_) in p2.items()] + [{
        "name": "stencil_matvec_soa[packed_parity]", **stencil,
        "source": "superbblas_tpu_torch/csrc/stencil_soa.cu",
        "replaces": "superbblas_tpu/ops/stencil_pallas.py:368",
        "launches": eo_launches, "max_abs_err": eo_err, "ms": eo_ms["H_eo"][0],
        "plain_ms": eo_ms["H_eo"][1], "bound_ms": eo_bound[0], "bound_by": eo_bound[1]}] + [{
        "name": name, **stencil, "source": "superbblas_tpu_torch/csrc/stencil_soa.cu",
        "replaces": "superbblas_tpu/ops/stencil_pallas.py:368",
        "launches": n_launch, "max_abs_err": e, "ms": t["kernel"], "plain_ms": t["plain"],
        "bound_ms": bd_[0], "bound_by": bd_[1]}
        for name, (n_launch, e, t, bd_) in (
            ("stencil_matvec_soa[1,1,12,12 clover term]", clover),
            ("stencil_matvec_soa[4,4,3,3 Moebius, 64 columns]", moebius),
            ("stencil_matvec_soa[1,1,3,3 staggered]", staggered),
            *((f"stencil_matvec_soa_rt[{','.join(map(str, shape))}]", k1_shapes[shape])
              for shape in K1_RT_SHAPES))] + [{
        "name": fn.__name__, **stencil,
        "source": "superbblas_tpu_torch/csrc/stencil_schedules.cu",
        "replaces": f"superbblas_tpu/ops/stencil_pallas.py:{line}",
        "launches": s_launches[name], "max_abs_err": s_err[name], "ms": ms[name],
        "plain_ms": ms["plain"], "bound_ms": k1_bound[0], "bound_by": k1_bound[1]}
        for (name, fn), line in zip(SCHEDULES.items(), (649, 795))] + [{
        "name": "permute_4d", "route": "cuda",
        "source": "superbblas_tpu_torch/csrc/permute.cu",
        "replaces": "superbblas_tpu/ops/permute_pallas.py:66",
        "launches": p_launches, "max_abs_err": max(p_err, d_err),
        "ms": p_ms["tzyx"][0], "plain_ms": p_ms["tzyx"][1],
        "bound_ms": p_bound_ms, "bound_by": p_bound_by,
        "library_ms": p_ms["tzyx"][1]}] + [{
        "name": fn.__name__, "route": "cuda",
        "source": "superbblas_tpu_torch/csrc/batched_gemm.cu", "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": times["kernel"],
        "plain_ms": times["plain"], "bound_ms": bd[0], "bound_by": bd[1],
        "library_ms": times["bmm"], "device_ms": times["kernel_device"],
        "plain_device_ms": times["plain_device"], "library_device_ms": times["bmm_device"]}
        for fn, replaces, launches, err, (times, bd) in (
            (batched_small_gemm, "superbblas_tpu/ops/batched_gemm_pallas.py:99",
             vc_launches["batched_small_gemm"] + aos_launches["k3"],
             max(gemm_err["k3"], vc_err["k3"], aos_err), gemm_ms["k3", K3_TIME_SHAPE]),
            (batched_gemm_rowpack, "experiments/bgemm_rowpack_probe.py:32",
             c_launches + vc_launches["batched_gemm_rowpack"] + aos_launches["e1"]
             + dc_launches, max(gemm_err["e1"], c_err, vc_err["e1"], aos_err, dc_err),
             gemm_ms["e1", E1_TIME_SHAPE]))] + [{
        "name": f"roll_add[{v}]", "route": "cuda",
        "source": "superbblas_tpu_torch/csrc/roll_add.cu",
        "replaces": "experiments/stencil_bf16_roll_probe.py:88",
        "launches": e2[v][0], "max_abs_err": e2[v][1],
        "ms": e2[v][2][E2_SHAPES[1]]["kernel"], "plain_ms": e2[v][2][E2_SHAPES[1]]["plain"],
        "bound_ms": e2[v][3][E2_SHAPES[1]][0], "bound_by": e2[v][3][E2_SHAPES[1]][1],
        "library_ms": None} for v in VARIANTS] + [{
        "name": f"permute_4d_tiled[{','.join(map(str, tile))}]", "route": "cuda",
        "source": "superbblas_tpu_torch/csrc/permute.cu",
        "replaces": "experiments/permute_pallas.py:45",
        "launches": e3[tile][0], "max_abs_err": e3[tile][1], "ms": e3[tile][2],
        "plain_ms": e3_call_ms, "bound_ms": e3_bound[0], "bound_by": e3_bound[1],
        "library_ms": e3_call_ms} for tile in TILES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
