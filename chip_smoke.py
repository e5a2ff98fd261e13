"""Smoke run of superbblas_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Builds the CUDA kernels from ``superbblas_tpu_torch/csrc`` (one nvcc per
source, in parallel) and drives the port's paths on the card.  Prints the
measured device-to-device copy rate beside the data sheet's (the bounds
keep the data sheet's) and the tiled K1 kernel's registers, spills and
resident blocks at every type pair.

Stencil checks: the stencil kernel K1 against its plain PyTorch version at
small shapes, and with ``packed_parity`` (both parities) on ragged half
lattices; its X-inside (K4a) and X-streaming (K4b) schedules against the
plain version and against K1 bit for bit (its tiled route at the Wilson
and staggered shapes, its runtime-shape route at the clover term's and
the runtime shapes) at small shapes and every type pair; all three at
the Wilson bench shape (lattice 8x8x16x128, 8
columns, f32 and bf16), K1 driven once there through ``apply_wilson``
(one launch, one spin plan), then timed in turns with the plain version.

K1's rows of the kernels line give ``bound_ms`` against the operations
its spin plan does (a factored Wilson hop projects onto two slots; the
``_factor_kron`` plan of the TPU kernel) and, as ``bound_ref_ms``, the
bound with the reference's FLOP model; ``plan_builds`` is the plans built
in the row's solve: plans are kept by kron value, so one to N for N
operators with spin factors, none in an iteration (asserted on the CG,
even-odd, BiCGStab, twisted-mass, clover, Moebius and staggered solves;
the staggered operators have no spin factors, so none); the MG-FGCR,
CGNE and V-cycle solves build no plan and read no kron to the host.

Wilson path: one Wilson operator on a 32x32x32x64 lattice (links from
numpy seed 0, f32) with 8 right-hand sides, built once and shared by the
paths below.  Before the solve the script holds K1 against the plain
version on that operator, its adjoint and the right-hand sides; then it
drives a normal-equation CG solve through ``wilson_operator`` and
``cg_solve`` and checks the true residual, the adjoint identity and that
every matvec of the solve launched K1.  Schedule path: one call of each
of K4a and K4b on the same operator and right-hand sides, held against K1
and the plain version, then all four timed in turns; K1, K4a and K4b
again on the staggered operator of the same links (staggered path).

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
ragged and strided shapes on both its routes (16-byte and 4-byte words)
and a small box copy against a numpy oracle.
Then it drives the dense engine once at full width through
``local_permute``, ``local_copy`` and ``local_contraction``: 128x64x64x128
f32 permutes of a tensor and of a split-complex pair, a wrapped box copy,
a masked checkerboard compaction of a 32x32x32x64 field, a bf16 batched
contraction (T=8, 1024^3) and the Gram matrix and rotation of a 64-vector
split-complex Krylov basis of 12x16x16x16x32 sites; each result is held
against a plain version, a numpy oracle or a float64 product on the card,
and the kernel launches of the run are counted (all seven on the 16-byte
route).  Then it times the permute
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

K1-shape path: K1 at the clover term's (1,1,12,12) (the block-streaming
kernel, both forms) and on its runtime-shape route at (2,2,3,3),
(1,1,2,2), (2,1,4,2), (2,2,8,8) and (1,1,16,16), each against the plain
version on full and packed parity (three dtype pairs), the runtime route
against the tiled one bit for bit at (4,4,3,3) and (1,1,3,3) and against
the block-streaming one at (1,1,12,12) (odd and 16-byte volumes, 1 and 9
columns) and at 65536 columns once; then each shape driven once at
16^3x32 x 8 and timed beside its bound, the clover term also beside
``torch.einsum`` on complex64.  The kernels line gives each runtime
shape's registers, blocks an SM and tile.
Families' AoS check: every family's AoS apply (twisted mass, staggered
and the clover term on K3, Shamir and Moebius on E1) against its SoA
apply at 4x4x8x8, Ls 4.  Default-call check (fault P3): the
default ``mobius_operator(DEFAULT_LAT)``, AoS at complex128 on the card,
applied through E1 at f64 against its SoA twin.

Family paths (f32, SoA, CGNE to 1e-5 on the normal residual, each solve
checked by its true normal and unsquared residuals and by one K1 launch
of each of its shapes an apply): clover at 24x24x24x48 x 8 rhs (mass 0.1,
c_sw 1.0, key 0; A^H = gamma5 A gamma5; its (1,1,12,12) term checked and
timed beside ``torch.einsum("ijs,njs->nis")`` on complex64, every launch
of it in the solve on the block-streaming kernel's 16-byte form); Moebius at 16x16x16x32 x Ls 16 x 4 rhs (M5 1.4, m_f 0.3, b5 1.5,
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

AoS even-odd paths: ``eo_solve_packed`` on the main lattice's Wilson
operator in the "aos" layout (main links and right-hand sides, EO_ITERS
iterations) to a true residual <= 1e-5, its psi held against the SoA
packed solve's; the masked ``eo_solve`` at 16^3x32 x 8 likewise; and
``eo_solve_packed`` on the AoS staggered operator of the main links
(mass 1.0, 40 iterations), every packed hopping one batched product on K3
(3 (4 N + 4) launches asserted), to a true residual <= 2e-4: walls, peak
memory, residuals.

Gather path (16^3x32 = 131,072 rows, 8 columns, complex64 from the seed):
``create_bsr`` on a Wilson-shaped 12x12-block operator open in T (merged
into mode "stencil": E1), on a truly irregular one of 5-9 nonzeros a row
(mode "gather": E1), and ``create_kron_bsr`` on the irregular lists with
the Wilson spin factors of 9 slots and 3x3 colour blocks (K3); each apply
through ``bsr_krylov`` against the plain version in f64, its launches
asserted, timed in turns with the plain version in complex64 beside the
bytes bound.

E2 and E3: the bf16 roll-plus-add in both variants (f32 bit-exact, bf16x2
within one bf16 ulp, elements that differ counted) in each form: vec16
(16-byte words) at [256, 32, 256] and [4096, 32, 256], pair at [4096, 32,
262], elem (f32) at [4096, 32, 263], each also checked at T = 6, 7, 8 and
264; timed beside the plain version and torch.roll + add on CUDA events
and device-only (CUDA graphs), beside the bytes bound and the bytes over
the measured copy rate; the transpose tile sweep at each design point (the
16-byte ring family with K2's own point, and the TMA point), exact
against ``x.permute(3,2,1,0).contiguous()`` at 64^4 f32 and timed in turns
beside it and K2.

Checkpoint path: the even-odd solve's psi (32^3x64 x 8, complex64) saved
through ``storage`` in the S3T format, file order "xyztscn", four blocks,
block CRCs (checksum level 2), closed, reopened, its checksums verified and
loaded back onto the card in the order "nscxyzt": bit for bit, its true
residual the solve's; then ``save_async`` of the same tensor (the same
CRCs) and a ``load_stream`` pass held against psi window by window; save
and load walls and GB/s, and the intersections the native plan engine
served (the engine must be built and serve them all).  The file lives in
a temporary directory, deleted after the phase.

Dense path: the clover path's site blocks at 24^3x48 (663,552 12x12
complex64 matrices of (4 + mass) I + the clover term, Hermitian, positive
definite by the smallest eigenvalue): ``dense.inversion`` (max |A A^-1 -
I|), ``gesm`` on 8 right-hand sides against A^-1 x, ``cholesky`` (U^H U
against A) and ``trsm`` of U against ``gesm`` of U; walls beside the bytes
at the measured copy rate.

Tracker and AOT path: five Wilson applies at 32^3x64 x 8 with
SBT_TRACK_TIME=1, their GFLOP/s in ``tracker.report_timings`` against the
same applies on CUDA events (within 15%); K1's wrapper host time with
tracking off against the undecorated call, in turns, at the bench shape;
``aot.aot_compile`` of one Wilson CG iteration at 8x8x16x128 x 8 (a CUDA
graph), its replay against the eager call bit for bit, eager and replay
times; ``aot.export_compiled``/``load_exported`` of the Wilson apply at 8^4
x 8, the loaded program launching K1 (its route's count) and equal to the
eager apply, and of a 4-D relabel at 64^4 f32, the loaded program
launching K2 once and equal to the eager call.

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
import collections
import contextlib
import itertools
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import record_function

from superbblas_tpu_torch import (ContractionPlan, aot, bsr, context, cplx, dense, flags,
                                  local_contraction, local_copy, local_permute, native, solvers,
                                  storage)
from superbblas_tpu_torch.cplx import CArray
from superbblas_tpu_torch.models import (adjoint_operator, apply_clover, apply_coarse,
                                         apply_domain_wall, apply_hopping_packed_soa,
                                         apply_staggered, apply_wilson, cb_pack_soa,
                                         cg_solve, cg_step, coarse_operator, domain_wall_operator,
                                         eo_solve, eo_solve_packed, eo_solve_packed_soa,
                                         gamma_matrices, hopping_packed_soa,
                                         mobius_operator, multigrid, random_su3_links,
                                         staggered_operator, twisted_mass_operator,
                                         wilson_clover_operator, wilson_offsets,
                                         wilson_operator)
from superbblas_tpu_torch.bsr import (BSROperator, bsr_cast_storage, bsr_krylov, create_bsr,
                                      create_kron_bsr)
from superbblas_tpu_torch.ops import _cuda
from superbblas_tpu_torch.ops import batched_gemm as gemm_ops
from superbblas_tpu_torch.ops.batched_gemm import (batched_gemm_route, batched_gemm_rowpack,
                                                   batched_small_gemm,
                                                   batched_small_gemm_reference)
from superbblas_tpu_torch.ops.permute import (TILES, maybe_permute, permute_4d,
                                              permute_4d_reference, permute_4d_tiled)
from superbblas_tpu_torch.ops.roll_add import (VARIANTS, roll_add, roll_add_form,
                                               roll_add_reference)
from superbblas_tpu_torch.ops import stencil as stencil_ops
from superbblas_tpu_torch.utils import tracker
from superbblas_tpu_torch.ops.stencil import (aos_to_soa, clear_plans, soa_to_aos, spin_plan,
                                              stencil_matvec_soa,
                                              stencil_matvec_soa_reference,
                                              stencil_matvec_soa_rt,
                                              stencil_matvec_soa_stream,
                                              stencil_matvec_soa_xin)
from tools.device_timing import GRAPH_CALLS, LAUNCH_CALLS, graph_ms, launch_us

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
    # in f64: an f32 cast would round two f64 results that differ in their
    # last bits a whole f32 step apart
    err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.double().abs().max()) for w in want)
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


def same_as_rt(blocks, kron, x, offsets, label, bi=3, bd=3):
    """K4a and K4b against the plain version and against K1 bit for bit:
    its tiled route at TILED_SHAPES (they run the same spin-plan code in
    its order), its runtime-shape route at the other shapes (the same
    per-output sum); returns the max abs error against the plain
    version."""
    args = (blocks, kron, x, offsets, bi, bd)
    ki, kd = (1, 1) if kron is None else tuple(kron.re.shape[1:])
    tiled = (ki, kd, bi, bd) in stencil_ops.TILED_SHAPES
    k1 = stencil_matvec_soa(*args) if tiled else stencil_matvec_soa_rt(*args)
    err = 0.0
    for name, fn in SCHEDULES.items():
        err = max(err, compare(*args[:4], f"{name} {label}", fn=fn, bi=bi, bd=bd))
        got = fn(*args)
        if not all(torch.equal(g, w) for g, w in zip(got, k1)):
            raise AssertionError(f"{name} {label}: differs from K1's "
                                 f"{'tiled' if tiled else 'runtime-shape'} route")
    return err


COUNTED = (stencil_matvec_soa, stencil_matvec_soa_rt, stencil_matvec_soa_xin,
           stencil_matvec_soa_stream, permute_4d, permute_4d_tiled, batched_small_gemm,
           batched_gemm_rowpack, roll_add)


def reset_counts():
    for fn in COUNTED:
        fn.launches = 0
    for fn in (stencil_matvec_soa, stencil_matvec_soa_rt):
        fn.by_shape.clear()
    stencil_matvec_soa.by_route.clear()
    permute_4d.by_route.clear()
    roll_add.by_form.clear()
    roll_add.by_variant_form.clear()
    stencil_matvec_soa.plan_builds = 0
    stencil_matvec_soa.kron_reads = 0


def read_counts():
    return {fn.__name__: fn.launches for fn in COUNTED} | {
        "plan_builds": stencil_matvec_soa.plan_builds,
        "kron_reads": stencil_matvec_soa.kron_reads}


#: spin plans built by each path's solve, by path (the kernels line)
PLANS_BUILT = {}


def expect_plans(label, operators):
    """Raise unless the run since reset_counts() and clear_plans() built
    between one and ``operators`` spin plans (plans are kept by kron value:
    one per operator with spin factors at most, none in the iterations) and
    read at most ``operators`` kron tensors to the host; kept in
    PLANS_BUILT under the label's first word."""
    got, reads = stencil_matvec_soa.plan_builds, stencil_matvec_soa.kron_reads
    PLANS_BUILT[label.split()[0]] = got
    print(f"{label}: spin plans built {got}, krons read to the host {reads} (at most "
          f"{operators}, one per operator with a kron)", flush=True)
    if not (min(1, operators) <= got <= operators and reads <= operators):
        raise AssertionError(f"{label}: {got} spin plans built and {reads} krons read, "
                             f"expected 1 to {operators}")


def expect_no_plans(label, counts):
    """Raise unless a solve whose operators' plans already exist built no
    spin plan and read no kron to the host in its iterations."""
    print(f"{label}: spin plans built {counts['plan_builds']}, krons read to the host "
          f"{counts['kron_reads']} (expected 0 and 0)", flush=True)
    if counts["plan_builds"] or counts["kron_reads"]:
        raise AssertionError(f"{label}: a plan was built or a kron read in the solve")


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
    1, 2 and 3 among them), every pair of KERNEL_DTYPES: the Wilson shape
    with random and Wilson spin factors, the staggered shape without a
    kron, the clover term's shape and the runtime-shape route's."""
    wilson_kron = {kdt: cplx.cmap(lambda a: a.to(kdt), wilson_operator(
        (2, 2, 2, 2), layout="soa", device="cuda", dtype=torch.complex128).kron)
        for kdt in (torch.float32, torch.float64)}
    for lat, n in (((1, 3, 2, 5), 1), ((2, 4, 3, 8), 2), ((3, 2, 5, 7), 3),
                   ((4, 4, 8, 32), 8)):
        for st, ft in stencil_ops.KERNEL_DTYPES:
            kdt = torch.float64 if ft == torch.float64 else torch.float32
            blocks = randn_c((9, 9) + lat, gen, st)
            for kron in (randn_c((9, 4, 4), gen, kdt), wilson_kron[kdt]):
                same_as_rt(blocks, kron, randn_c((n, 12) + lat, gen, ft), WILSON_OFFSETS,
                           f"{lat} n={n} {st}/{ft}")
            same_as_rt(blocks, None, randn_c((n, 3) + lat, gen, ft), WILSON_OFFSETS,
                       f"no-kron {lat} n={n} {st}/{ft}")
            if n == 8:
                continue
            for shape in (CLOVER_SHAPE,) + K1_RT_SHAPES:
                b, k, x = shape_operands(shape, lat, n, 9, gen, st, ft)
                if k is not None:
                    k = cplx.cmap(lambda a: a.to(kdt), k)
                same_as_rt(b, k, x, WILSON_OFFSETS, f"{shape} {lat} n={n} {st}/{ft}",
                           bi=shape[2], bd=shape[3])


def bench_shape(gen):
    """K1, K4a, K4b and the plain version at the Wilson bench shape: K1
    driven once (the counts and the kept plans reset just before, read
    just after), checked, the schedules held against K1's tiled route bit
    for bit, then all timed in turns.  Returns {label: (launches, max error,
    {name: median ms}, (bound ms, by, reference-model ms), plans built)}."""
    lat, n = (8, 8, 16, 128), 8
    op32 = wilson_operator(lat, mass=0.1, key=0, layout="soa", device="cuda")
    out = {}
    for label, op, ft in (("f32", op32, torch.float32),
                          ("bf16/bf16", bsr_cast_storage(op32, torch.bfloat16),
                           torch.bfloat16)):
        x = randn_c((n, 12) + lat, gen, ft)
        clear_plans()
        reset_counts()
        apply_wilson(op, x)
        torch.cuda.synchronize()
        counts = read_counts()
        if counts["stencil_matvec_soa"] != 1 or counts["plan_builds"] != 1:
            raise AssertionError(f"bench {label}: counts {counts}, expected one launch and "
                                 "one plan")
        err = compare(op.blocks, op.kron, x, op.offsets, f"bench {lat} n={n} {label}")
        same_as_rt(op.blocks, op.kron, x, op.offsets, f"bench {lat} n={n} {label}")
        ms = time_stencils(op, x, reps=25)
        flops = op.flops_per_matvec(n)
        nbytes = op.memops_per_matvec(n, itemsize=2 * x.re.element_size())
        bd_ = stencil_bound(op.blocks, op.kron, x, op.offsets, 3, 3)
        print(f"bench {label} bound {bd_[0]:.4f} ms ({bd_[1]}), reference-model bound "
              f"{bd_[2]:.4f} ms", flush=True)
        for k, v in ms.items():
            print(f"bench {label} {k}: median {v:.4f} ms over 25, "
                  f"{flops / v / 1e6:.1f} GFLOP/s (reference model), "
                  f"{nbytes / v / 1e6:.1f} GB/s", flush=True)
        out[label] = 1, err, ms, bd_, counts["plan_builds"]
    return out


def copy_rate() -> float:
    """Device-to-device copy rate, bytes/s (read and write counted), of a
    1 GiB f32 tensor: the median of 5 copies on CUDA events."""
    a = torch.empty(2 ** 28, device="cuda")
    b = torch.empty_like(a)
    ms = time_turns({"copy": lambda: b.copy_(a)}, 5)["copy"]
    del a, b
    return 2 * 2 ** 30 / (ms * 1e-3)


def tiled_attrs() -> dict:
    """{"shape form pair": [registers, local bytes, threads, blocks an
    SM]} of the tiled kernel at 32^3x64 x 8 (cudaFuncGetAttributes)."""
    import ctypes

    out = {}
    for ki, form in ((4, "sparse"), (4, "dense"), (1, "dense")):
        for pair, (st, ft) in enumerate(stencil_ops.KERNEL_DTYPES):
            got = (ctypes.c_int * 4)()
            err = _cuda.library().sbt_stencil_tiled_attrs(ki, ki, 3, 3, pair,
                                                          int(form == "sparse"),
                                                          MAIN_COLS, *MAIN_LAT, 4, got)
            if err != 0:
                raise AssertionError(f"tiled kernel attributes: cudaError {err}")
            out[f"{ki},{ki},3,3 {form} {str(st)[6:]}/{str(ft)[6:]}"] = list(got)
    return out


def kernel_attrs() -> dict:
    """{"kernel form pair": [registers, local bytes, threads, blocks an
    SM]} of K1's block-streaming kernel at 8 columns (both forms, every
    f32-summed pair) and of K2's 16-byte route (cudaFuncGetAttributes)."""
    import ctypes

    lib, out = _cuda.library(), {}
    for wide, form in ((1, "site16"), (0, "site")):
        for pair, (st, ft) in enumerate(stencil_ops.KERNEL_DTYPES[:4]):
            got = (ctypes.c_int * 4)()
            if lib.sbt_stencil_site_attrs(pair, wide, MAIN_COLS, got) != 0:
                raise AssertionError("block-streaming kernel attributes failed")
            out[f"K1 1,1,12,12 {form} {str(st)[6:]}/{str(ft)[6:]}"] = list(got)
    got = (ctypes.c_int * 4)()
    if lib.sbt_permute_4d_vec_attrs(got) != 0:
        raise AssertionError("permute kernel attributes failed")
    out["K2 vec16"] = list(got)
    for shape in K1_RT_SHAPES:
        for st, ft in stencil_ops.KERNEL_DTYPES:
            out[f"K1 runtime {','.join(map(str, shape))} {str(st)[6:]}/{str(ft)[6:]}"] = \
                stencil_ops.rt_attrs(shape, st, ft, K1_TIME_COLS, 9)
    return out


def schedule_attr_table() -> dict:
    """{"schedule shape form pair": [registers, local bytes, threads, blocks
    an SM]} of K4a and K4b at 32^3x64 x 8 (cudaFuncGetAttributes, the
    occupancy at their tiles' shared memory)."""
    out = {}
    for schedule in SCHEDULES:
        for shape, form in (((4, 4, 3, 3), "sparse"), ((4, 4, 3, 3), "dense"),
                            ((1, 1, 3, 3), "dense"), ((2, 2, 3, 3), "runtime")):
            for st, ft in stencil_ops.KERNEL_DTYPES:
                out[f"{schedule} {','.join(map(str, shape))} {form} {str(st)[6:]}/"
                    f"{str(ft)[6:]}"] = stencil_ops.schedule_attrs(
                        schedule, shape, st, ft, MAIN_COLS, MAIN_LAT, form == "sparse")
    return out


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
    operands, CG solve (one spin plan built for D and one for D^H), checks.
    Returns (launches in the solve, max error)."""
    lat, n = MAIN_LAT, MAIN_COLS
    # the kernel against the plain version on the solve's own operands:
    # D b and D^H b, independently of the solve's self-consistency
    op_h = adjoint_operator(op)
    err = max(compare(o.blocks, o.kron, b, o.offsets, f"main path {lat} n={n} {name}")
              for name, o in (("D", op), ("D^H", op_h)))
    del op_h

    torch.cuda.reset_peak_memory_stats()
    clear_plans()
    reset_counts()
    t0 = time.perf_counter()
    x, rs = cg_solve(op, b, n_iters=CG_ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()["stencil_matvec_soa"]
    expected = 1 + 2 * CG_ITERS
    peak = torch.cuda.max_memory_allocated()
    expect_plans("main path cg_solve (D and D^H)", 2)

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
    read just after), held against K1's tiled route bit for bit (the
    same spin plan code) and against the plain version; then K1, K4a,
    K4b and the plain version timed in turns.
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
              f"(rel {err[name] / scale:.3e}), equal to K1's tiled route bit for "
              f"bit: {same}", flush=True)
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
    hop, _, src = hops["H_eo"]
    hop_bound = stencil_bound(hop.blocks, hop.kron, src, hop.offsets, 3, 3)
    print(f"eo packed hopping bound {hop_bound[0]:.4f} ms ({hop_bound[1]}), reference-model "
          f"bound {hop_bound[2]:.4f} ms: {hop.flops_per_matvec(n) / 1e9:.2f} GFLOP in the "
          f"model, {hop.memops_per_matvec(n, itemsize=8) / 1e9:.3f} GB", flush=True)
    del hops, hop, src

    torch.cuda.reset_peak_memory_stats()
    clear_plans()
    reset_counts()
    t0 = time.perf_counter()
    psi, rs = eo_solve_packed_soa(op, b, a=a, n_iters=EO_ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()["stencil_matvec_soa"]
    expected = 4 * EO_ITERS + 4
    peak = torch.cuda.max_memory_allocated()
    expect_plans("eo path eo_solve_packed_soa (four packed hoppings)", 4)
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
    clear_plans()
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
    expect_plans("bicgstab on the packed Schur operator (two packed hoppings)", 2)
    del he, ho, rhs, x_e, r
    if profile:
        profile_run("eo solve", lambda: eo_solve_packed_soa(op, b, a=a, n_iters=EO_ITERS))
    return launches, err, ms, hop_bound, psi


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
    """The permute kernel against its plain version off the dense path, on
    both routes: ragged tiles, strided views, int32 words; a small wrapped
    box copy against the numpy oracle.  Returns the max abs error."""
    err = 0.0
    x = torch.randn((45, 6, 7, 70), generator=gen, device="cuda")
    w = torch.randn((72, 6, 7, 80), generator=gen, device="cuda")
    for perm in PERMS.values():
        for label, v, route in (("ragged", x, "word"),
                                ("strided view", x[3:40, 1:5, 2:7, 5:66], "word"),
                                ("int32", x.view(torch.int32), "word"),
                                ("ragged 16-byte", w, "vec16"),
                                ("strided view 16-byte", w[4:68, 1:5, 2:7, 8:72], "vec16"),
                                ("view one word off 16 bytes", w[4:68, 1:5, 2:7, 1:65], "word"),
                                ("int32 16-byte", w.view(torch.int32), "vec16")):
            before = permute_4d.launches, permute_4d.by_route[route]
            got = maybe_permute(v, perm)
            torch.cuda.synchronize()
            if (permute_4d.launches, permute_4d.by_route[route]) != (before[0] + 1,
                                                                     before[1] + 1):
                raise AssertionError(f"permute {label}: the kernel's {route} route was not "
                                     "launched")
            err = max(err, exact(got, permute_4d_reference(v, perm),
                                 f"permute {tuple(v.shape)} {label} {perm}"))
    print("check permute kernel: ragged, strided and int32 cases bit-exact on the 4-byte "
          "and 16-byte routes", flush=True)
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
    routes = dict(permute_4d.by_route)
    print(f"dense path permute launches by route {routes}", flush=True)
    if counts != {k: 7 if k == "permute_4d" else 0 for k in counts} or steps != [2 + 4, 7] \
            or routes != {"vec16": 7}:
        raise AssertionError(f"dense path launches {counts} {steps} {routes}, expected 2 + "
                             "4 for the permutes and 1 for the box copy, all on the 16-byte "
                             "route")

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
    ms)}, the bound and the route the kernel took (raises unless every
    timed launch took the 16-byte route)."""
    x = torch.randn(DENSE_SHAPE, generator=gen, device="cuda")
    nbytes = 2 * x.numel() * x.element_size()
    out = {}
    before = dict(permute_4d.by_route)
    for o1, perm in PERMS.items():
        ms = time_turns({"kernel": lambda: permute_4d(x, perm),
                         "plain": lambda: permute_4d_reference(x, perm)}, reps=15)
        out[o1] = ms["kernel"], ms["plain"]
        print(f"permute {DENSE_SHAPE} f32 xyzt->{o1}: kernel median {ms['kernel']:.4f} ms "
              f"({nbytes / ms['kernel'] / 1e6:.1f} GB/s), plain = library call "
              f"median {ms['plain']:.4f} ms ({nbytes / ms['plain'] / 1e6:.1f} GB/s) over 15",
              flush=True)
    routes = {k: v - before.get(k, 0) for k, v in permute_4d.by_route.items()
              if v != before.get(k, 0)}
    if set(routes) != {"vec16"}:
        raise AssertionError(f"timed permute launches by route {routes}")
    return out, bound(nbytes, 0), "vec16"


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

    A(b)   # the plans of D and D^H, as the set-up built D's
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
    expect_no_plans("mg path MG-FGCR", mg_counts)
    expect_no_plans("mg path CGNE", cg_counts)
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
    V(A(rhs))   # every level's plans, before the counts
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
    expect_no_plans("vcycle path FGCR", counts)
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
#: K1's runtime-shape route's shapes: the JAX package's test shapes, an
#: asymmetric one, a chirally split (2,2,8,8) and a 16-vector (1,1,16,16)
#: coarse stencil; the clover term's shape; the lattice and columns they
#: are timed at
K1_RT_SHAPES = ((2, 2, 3, 3), (1, 1, 2, 2), (2, 1, 4, 2), (2, 2, 8, 8), (1, 1, 16, 16))
#: the runtime-shape route's column case: past the 65535 of a grid's z axis
RT_COLS_CASE = ((2, 2, 2, 2), (1, 1, 2, 2), 65536)
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
#: E2's other forms, timed at the large shape's size: an even T not a
#: multiple of 8 (pair) and an odd one (elem, the f32 variant); and the
#: small T at which every form is checked
E2_FORM_SHAPES = {"pair": (4096, 32, 262), "elem": (4096, 32, 263)}
E2_CHECK_T = (6, 7, 8, 264)
E3_SHAPE = (64, 64, 64, 64)
#: the AoS staggered packed solve: its mass and Schur CG iterations (f32,
#: 8^3x16, links from seed 0, 8 rhs, on the CPU: mass 1.0, 40 iterations
#: -> |D psi - b| / |b| 5.3e-5; at the SoA path's mass 0.1 the Schur
#: complement's condition, about 1600 and squared by the normal equations,
#: leaves 0.42 after 80), and the true residual it is held to (a margin of
#: 4); the masked eo_solve's lattice (it runs twice the packed solve's work
#: on full-lattice arrays)
AOS_STAG_MASS, AOS_STAG_ITERS, AOS_STAG_RES = 1.0, 40, 2e-4
MASKED_EO_LAT = (16, 16, 16, 32)
#: the AoS packed psi against the SoA packed psi of the same b, |d| / |psi|:
#: both f32 solves run the same Schur CG iterations and differ only in the
#: order of their sums (1.4e-7 at 8^3x16 x 8, 14 iterations, on the CPU);
#: inner products over the 64x larger lattice round about 8x more (the
#: square root of their terms), so 1e-5 leaves a margin of 9
AOS_SOA_PSI_TOL = 1e-5
#: gather path: 16^3x32 rows, 8 columns, complex64, 12x12 blocks (3x3
#: colour blocks with 4x4 spin factors for the kron operator); each row of
#: the irregular operator holds its own site and 4-8 random domain sites
GATHER_LAT, GATHER_COLS, GATHER_BLOCK, GATHER_NNZ = (16, 16, 16, 32), 8, 12, (5, 9)
#: a gather apply against the plain version in f64, relative to max |y|: f32
#: sums of up to 108 complex products a part
GATHER_TOL = 1e-5


def g5(v: CArray, feature_axis: int) -> CArray:
    """gamma5 on the 12 spin-colour features of a SoA field."""
    signs = torch.tensor(G5_SIGNS, device=v.re.device, dtype=v.re.dtype)
    shape = [1] * v.re.ndim
    shape[feature_axis] = 12
    signs = signs.reshape(shape)
    return CArray(signs * v.re, signs * v.im)


def planned_flops(kron, n, V, bi, bd, ndir) -> int:
    """The operations one matvec does with the spin plan of ``kron``
    (``spin_plan``; None: K_d = 1), 8 a complex multiply-add: a direct
    direction's nonzero spin entries x BD and its KI x BI x BD colour
    products, a factored one's nonzero P entries x BD, its r x BI x BD
    colour products and its nonzero R entries x BI."""
    if kron is None:
        return 8 * V * n * ndir * bi * bd
    per_site = 0
    for spec in spin_plan(kron, torch.float32).specs:
        nnz = sum(len(row) for row in spec[1])
        if spec[0] == "direct":
            per_site += nnz * bd + len(spec[1]) * bi * bd
        else:
            per_site += nnz * bd + len(spec[1]) * bi * bd + sum(len(r) for r in spec[2]) * bi
    return 8 * V * n * per_site


def stencil_bound(blocks, kron, x, offsets, bi, bd):
    """(ms, by, reference-model ms) of one SoA matvec: the bytes of the
    blocks once (in their type), of x read and y written (in the
    field's), against the operations the spin plan does (planned_flops),
    at the f64 peak for f64 fields; beside it the bound with the
    operations of the BSROperator model (the reference's, PR 1-6's
    bound)."""
    ki, kd = (1, 1) if kron is None else tuple(kron.re.shape[1:])
    op = BSROperator(blocks, kron, offsets, tuple(x.re.shape[2:]), (bi,), (bd,),
                     (ki,) if kron is not None else (), (kd,) if kron is not None else ())
    n = x.re.shape[0]
    V = x.re.numel() // (n * kd * bd)
    nbytes = 2 * (blocks.re.numel() * blocks.re.element_size()
                  + (x.re.numel() // (kd * bd) * (ki * bi) + x.re.numel()) * x.re.element_size())
    peak = F64_FLOPS if x.re.dtype == torch.float64 else F32_FLOPS
    ms, by = bound(nbytes, planned_flops(kron, n, V, bi, bd, len(offsets)), peak)
    return ms, by, bound(nbytes, op.flops_per_matvec(n), peak)[0]


def time_stencil(blocks, kron, x, offsets, bi, bd, reps, label, library=None):
    """K1 (the route of its shape), the plain version and, where given, the
    one PyTorch call ``library`` computing the same function, on one
    matvec, in turns, beside the bound.  Returns ({"kernel", "plain"[,
    "library"]}: median ms, (bound ms, by, reference-model bound ms))."""
    args = (blocks, kron, x, offsets, bi, bd)
    fns = {"kernel": lambda: stencil_matvec_soa(*args),
           "plain": lambda: stencil_matvec_soa_reference(*args)}
    if library is not None:
        fns["library"] = library
    ms = time_turns(fns, reps)
    bd_ = stencil_bound(*args)
    lib = f", library call {ms['library']:.4f} ms" if library is not None else ""
    print(f"time {label}: kernel median {ms['kernel']:.4f} ms, plain {ms['plain']:.4f} ms"
          f"{lib} over {reps} in turns; bound {bd_[0]:.4f} ms ({bd_[1]}), reference-model "
          f"bound {bd_[2]:.4f} ms", flush=True)
    return ms, bd_


def clover_einsum(blocks, x):
    """The one PyTorch call computing the site-local term (one centre
    direction, no kron): ``torch.einsum("ijs,njs->nis", Bc, xc)`` on
    complex64 copies of the blocks [12, 12, V] and of x [n, 12, V], made
    here, outside the timing; the call is checked against K1 first.
    Returns the call."""
    n, V = x.re.shape[0], x.re[0, 0].numel()
    bc = torch.complex(blocks.re.float(), blocks.im.float()).reshape(12, 12, V)
    xc = torch.complex(x.re.float(), x.im.float()).reshape(n, 12, V)
    got = torch.einsum("ijs,njs->nis", bc, xc)
    want = stencil_matvec_soa(blocks, None, x, ((0, 0, 0, 0),), 12, 12)
    err = max(float((got.real - want.re.reshape(n, 12, V).float()).abs().max()),
              float((got.imag - want.im.reshape(n, 12, V).float()).abs().max()))
    scale = float(want.re.abs().max())
    if not err <= TOL[x.re.dtype] * scale:
        raise AssertionError(f"torch.einsum clover term disagrees with K1: {err} of {scale}")
    del got, want
    return lambda: torch.einsum("ijs,njs->nis", bc, xc)


def shape_operands(shape, lat, n, ndir, gen, st=torch.float32, ft=torch.float32):
    ki, kd, bi, bd = shape
    blocks = randn_c((ndir, bi * bd) + lat, gen, st)
    kron = randn_c((ndir, ki, kd), gen) if (ki, kd) != (1, 1) else None
    return blocks, kron, randn_c((n, kd * bd) + lat, gen, ft)


def k1_shape_path(gen):
    """K1 at the clover term's shape and on its runtime-shape route: each
    against the plain version at small shapes on full and packed parity
    (three dtype pairs), and at the Moebius column count (f32); the
    runtime-shape route against the tiled one, bit for bit, at the Wilson
    and staggered shapes, and against the block-streaming one at the clover
    term's (both forms); then each shape driven once through
    ``stencil_matvec_soa`` at K1_TIME_LAT x K1_TIME_COLS (the counts set to
    0 just before and read just after), checked there and timed in turns
    with the plain version (the clover term also with ``torch.einsum``).
    The runtime-shape route also runs RT_COLS_CASE's 65536 columns once.
    Returns {shape: (launches, max error, ms, bound)} and the max error at
    the Moebius column count."""
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
                                     "the tiled route")
    forms = collections.Counter()
    for lat, n, offsets, parity in (((3, 3, 3, 5), 1, WILSON_OFFSETS[:1], None),
                                    ((3, 3, 3, 5), 9, WILSON_OFFSETS, None),
                                    ((2, 4, 4, 8), 8, WILSON_OFFSETS[:1], None),
                                    ((3, 5, 4, 7), 9, HOPPING, 1)):
        blocks, kron, x = shape_operands(CLOVER_SHAPE, lat, n, len(offsets), gen)
        args = (blocks, kron, x, offsets, 12, 12)
        before = dict(stencil_matvec_soa.by_route)
        k1 = stencil_matvec_soa(*args, packed_parity=parity)
        forms.update({k: v - before.get(k, 0) for k, v in stencil_matvec_soa.by_route.items()})
        rt = stencil_matvec_soa_rt(*args, packed_parity=parity)
        if not all(torch.equal(g, w) for g, w in zip(k1, rt)):
            raise AssertionError(f"block-streaming kernel {lat} n={n} p={parity} differs "
                                 "from the runtime-shape route")
    forms = +forms
    if forms != collections.Counter({"site16": 2, "site": 2}):
        raise AssertionError(f"block-streaming kernel forms {dict(forms)}")
    lat, shape, ncols = RT_COLS_CASE
    blocks, kron, x = shape_operands(shape, lat, ncols, 9, gen)
    err["columns"] = compare(blocks, kron, x, WILSON_OFFSETS, f"K1 runtime {shape} {lat} "
                             f"n={ncols}", fn=stencil_matvec_soa_rt, bi=shape[2], bd=shape[3])
    del blocks, kron, x
    print("check K1 runtime-shape route at (4,4,3,3) and (1,1,3,3), full and packed: equal "
          "to the tiled route bit for bit; at (1,1,12,12) equal to the block-streaming "
          f"kernel bit for bit, forms {dict(forms)}", flush=True)

    path = {shape: shape_operands(shape, K1_TIME_LAT, K1_TIME_COLS,
                                  1 if shape == CLOVER_SHAPE else 9, gen)
            for shape in (CLOVER_SHAPE,) + K1_RT_SHAPES}
    offsets = {shape: WILSON_OFFSETS[:1] if shape == CLOVER_SHAPE else WILSON_OFFSETS
               for shape in path}
    reset_counts()
    for shape, (blocks, kron, x) in path.items():
        stencil_matvec_soa(blocks, kron, x, offsets[shape], shape[2], shape[3])
    torch.cuda.synchronize()
    routes = (dict(stencil_matvec_soa.by_shape), dict(stencil_matvec_soa_rt.by_shape),
              dict(stencil_matvec_soa.by_route))
    print(f"K1 shape path {K1_TIME_LAT} n={K1_TIME_COLS}: launches by shape, K1 "
          f"{routes[0]}, runtime {routes[1]}; K1 by route {routes[2]}", flush=True)
    if routes != ({CLOVER_SHAPE: 1}, {shape: 1 for shape in K1_RT_SHAPES}, {"site16": 1}):
        raise AssertionError("a K1 shape did not launch its route once")
    out = {}
    for shape, (blocks, kron, x) in path.items():
        e = compare(blocks, kron, x, offsets[shape], f"K1 {shape} {K1_TIME_LAT} "
                    f"n={K1_TIME_COLS}", bi=shape[2], bd=shape[3])
        ms, bd_ = time_stencil(blocks, kron, x, offsets[shape], shape[2], shape[3], 7,
                               f"K1 {shape} {K1_TIME_LAT} n={K1_TIME_COLS}",
                               clover_einsum(blocks, x) if shape == CLOVER_SHAPE else None)
        out[shape] = 1, max(err[shape], e if shape == CLOVER_SHAPE else max(e, err["columns"])), \
            ms, bd_
    return out, err[MOEBIUS_SHAPE]


def family_solve(label, A, Ah, b, maxiter, plans):
    """CGNE (``solvers.cgne``) to FAMILY_TOL, the counts set to 0 and the
    kept spin plans dropped just before, read just after; then its true
    residuals in f64: the normal one against SOLVE_RES_TOL, the unsquared
    one against UNSQUARED_TOL, and ``plans`` plans built (one per operator
    with spin factors).  Returns (iterations, {route: launches by
    shape})."""
    torch.cuda.reset_peak_memory_stats()
    clear_plans()
    reset_counts()
    t0 = time.perf_counter()
    x, _, it = solvers.cgne(A, Ah, b, tol=FAMILY_TOL, maxiter=maxiter)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    shapes = {"k1": dict(stencil_matvec_soa.by_shape),
              "routes": dict(stencil_matvec_soa.by_route),
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
    expect_plans(label, plans)
    return it, shapes


def clover_path(gen, profile: bool):
    """The Wilson-clover solve: the operator at CLOVER_LAT (links from
    numpy seed 0, field strength and blocks formed on the card), the
    clover term's K1 (1, 1, 12, 12) held against the plain version on its
    operands and timed, then CGNE with A^H = gamma5 A gamma5 to 1e-5 on 8
    rhs, every apply one K1 launch of each shape, the clover term's on the
    block-streaming kernel with 16-byte copies.  Returns (the clover
    term's launches in the solve, its max error, ms (kernel, plain and
    ``torch.einsum``), bound)."""
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
                           f"K1 {CLOVER_SHAPE} clover term {CLOVER_LAT} n={MAIN_COLS}",
                           clover_einsum(cl.blocks, b))

    def A(v):
        return apply_clover(op, v)

    def Ah(v):
        return g5(A(g5(v, 1)), 1)

    # one plan: the hopping term's; the clover term has no spin factors
    it, shapes = family_solve(f"clover path {CLOVER_LAT} x {MAIN_COLS} rhs", A, Ah, b,
                              CLOVER_MAXITER, plans=1)
    applies = 1 + 2 * it
    if shapes["k1"] != {(4, 4, 3, 3): applies, CLOVER_SHAPE: applies} \
            or shapes["routes"] != {"tiled": applies, "site16": applies}:
        raise AssertionError(f"clover path launches {shapes}, expected {applies} of each "
                             "shape, the clover term's on the block-streaming kernel "
                             "with 16-byte copies")
    if profile:
        profile_run("clover cgne", lambda: solvers.cgne(A, Ah, b, tol=FAMILY_TOL,
                                                        maxiter=CLOVER_MAXITER))
    return applies, err, ms, bd_, cl.blocks


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
    # two plans: the Wilson operators of both projector sides
    it, shapes = family_solve(f"moebius path {MOEBIUS_LAT} Ls {MOEBIUS_LS} x {MOEBIUS_COLS} "
                              "rhs", A, Ah, b, MOEBIUS_MAXITER, plans=2)
    applies = 1 + 2 * it
    if shapes["k1"] != {(4, 4, 3, 3): applies}:
        raise AssertionError(f"moebius path launches {shapes}, expected {applies}")
    if profile:
        profile_run("moebius cgne", lambda: solvers.cgne(A, Ah, b, tol=FAMILY_TOL,
                                                         maxiter=MOEBIUS_MAXITER))
    return applies, err, ms, bd_


def staggered_path(links, gen):
    """The staggered solve on the main lattice and links, 8 rhs: K1 (1, 1,
    3, 3) held against the plain version on D and D^H and timed, K4a and
    K4b held against it bit for bit and the three timed in turns, then
    CGNE with ``adjoint_operator`` to 1e-5, every apply one K1 launch.
    Returns (launches in the solve, max error, ms, bound, {k1, xin,
    stream: median ms})."""
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
    # K4a and K4b on the staggered operator: K1's bits, then the three in
    # turns
    s_err = same_as_rt(op.blocks, None, b, op.offsets, f"staggered {MAIN_LAT} n={MAIN_COLS}")
    args = (op.blocks, None, b, op.offsets, 3, 3)
    s_ms = time_turns({"k1": lambda: stencil_matvec_soa(*args),
                       **{k: (lambda fn=fn: fn(*args)) for k, fn in SCHEDULES.items()}}, 11)
    print(f"staggered {MAIN_LAT} n={MAIN_COLS} matvec medians over 11 in turns: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in s_ms.items()), flush=True)
    # no plan: the staggered operators have no spin factors (K_d = 1 in the
    # tiled kernel without a table)
    it, shapes = family_solve(f"staggered path {MAIN_LAT} x {MAIN_COLS} rhs",
                              lambda v: apply_staggered(op, v),
                              lambda v: apply_staggered(op_h, v), b, STAGGERED_MAXITER,
                              plans=0)
    applies = 1 + 2 * it
    if shapes["k1"] != {(1, 1, 3, 3): applies}:
        raise AssertionError(f"staggered path launches {shapes}, expected {applies}")
    return applies, max(err, s_err), ms, bd_, s_ms


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
    clear_plans()
    reset_counts()
    t0 = time.perf_counter()
    x, rs = cg_solve(op, b, n_iters=CG_ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()["stencil_matvec_soa"]
    expect_plans("twisted-mass path cg_solve (D and D^H)", 2)
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


def aos_eo_path(op, b, psi_soa, links, gen):
    """The AoS even-odd functions on the card.  ``eo_solve_packed`` on the
    main lattice's Wilson operator in the "aos" layout (the main links, f32)
    from the main right-hand sides, EO_ITERS Schur CG iterations, as the
    SoA eo path: wall, peak memory, true residual |D psi - b| / |b| (K1 on
    the SoA operator) <= 1e-5, and psi against the SoA packed solve's
    ``psi_soa`` within AOS_SOA_PSI_TOL; then the masked ``eo_solve`` at
    MASKED_EO_LAT x 8 (links from seed 0), likewise.  Their colour and spin
    contractions are torch.einsum (the spin factors keep the AoS kron
    mode off the batched product).  Returns {"packed": (wall s, peak GiB,
    residual, |d|/|psi|), "masked": (wall s, peak GiB, residual)}."""
    n, a = MAIN_COLS, MASS + 4.0
    t0 = time.perf_counter()
    op_a = wilson_operator(MAIN_LAT, mass=MASS, links=links, layout="aos", device="cuda")
    b_a = soa_to_aos(b, 4, 4, 3)
    torch.cuda.synchronize()
    print(f"aos_eo path: AoS Wilson operator {MAIN_LAT} built in "
          f"{time.perf_counter() - t0:.2f} s (mode {op_a.mode}, blocks "
          f"{tuple(op_a.blocks_re.shape)})", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    psi, rs = eo_solve_packed(op_a, b_a, a=a, n_iters=EO_ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del op_a, b_a
    psi_s = aos_to_soa(psi, 4)
    del psi
    finite = all(bool(torch.isfinite(q).all()) for q in psi_s)
    res = true_residual(op, psi_s, b)
    d = norm(CArray(psi_s.re - psi_soa.re, psi_s.im - psi_soa.im)) / norm(psi_soa)
    print(f"aos_eo path {MAIN_LAT} x {n} rhs: eo_solve_packed (AoS) {EO_ITERS} iters "
          f"{wall:.3f} s, peak memory {peak:.2f} GiB, |r_e|^2={float(rs):.4e}, true rel "
          f"residual {res:.3e} (<= 1e-5), |psi_aos - psi_soa| / |psi_soa| {d:.3e} "
          f"(<= {AOS_SOA_PSI_TOL}), finite {finite}", flush=True)
    if not (finite and tuple(psi_s.re.shape) == tuple(b.re.shape) and res <= 1e-5
            and d <= AOS_SOA_PSI_TOL):
        raise AssertionError("the AoS packed eo solve disagrees with the SoA one")
    del psi_s

    lm = MASKED_EO_LAT
    t0 = time.perf_counter()
    links_m = random_su3_links(np.random.default_rng(0), lm)
    op_m = wilson_operator(lm, mass=MASS, links=links_m, layout="aos", device="cuda")
    op_ms = wilson_operator(lm, mass=MASS, links=links_m, layout="soa", device="cuda")
    bm = randn_c((n, 12) + lm, gen)
    torch.cuda.synchronize()
    print(f"aos_eo path: masked-solve operators {lm} built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    psi_m, rs_m = eo_solve(op_m, soa_to_aos(bm, 4, 4, 3), a=a, n_iters=EO_ITERS)
    torch.cuda.synchronize()
    wall_m = time.perf_counter() - t0
    peak_m = torch.cuda.max_memory_allocated() / 2 ** 30
    psi_ms = aos_to_soa(psi_m, 4)
    res_m = true_residual(op_ms, psi_ms, bm)
    finite = all(bool(torch.isfinite(q).all()) for q in psi_ms)
    print(f"aos_eo path {lm} x {n} rhs: eo_solve (masked, AoS) {EO_ITERS} iters "
          f"{wall_m:.3f} s, peak memory {peak_m:.2f} GiB, |r_e|^2={float(rs_m):.4e}, true "
          f"rel residual {res_m:.3e} (<= 1e-5), finite {finite}", flush=True)
    if not (finite and res_m <= 1e-5):
        raise AssertionError("the masked AoS eo solve did not reach its residual")
    return {"packed": (wall, peak, res, d), "masked": (wall_m, peak_m, res_m)}


def aos_staggered_eo_path(links, gen):
    """``eo_solve_packed`` on the AoS staggered operator of the main
    lattice and links (f32, mass AOS_STAG_MASS, AOS_STAG_ITERS iterations),
    8 right-hand sides: every packed hopping apply one batched product of
    J = 8 x 3 = 24 a Gauss part on K3 (the counts set to 0 just before the
    solve and read just after: 3 (4 N + 4) K3 launches, none of E1), and
    the true residual |D psi - b| / |b| <= AOS_STAG_RES.  Returns (K3
    launches, wall s, peak GiB, residual)."""
    t0 = time.perf_counter()
    op = staggered_operator(MAIN_LAT, mass=AOS_STAG_MASS, links=links, layout="aos",
                            device="cuda")
    b = randn_c(MAIN_LAT + (3, MAIN_COLS), gen)
    torch.cuda.synchronize()
    print(f"aos_staggered_eo path {MAIN_LAT} mass {AOS_STAG_MASS}: AoS operator built in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    psi, rs = eo_solve_packed(op, b, a=AOS_STAG_MASS, n_iters=AOS_STAG_ITERS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    r = apply_staggered(op, psi)
    res = norm(CArray(r.re - b.re, r.im - b.im)) / norm(b)
    finite = all(bool(torch.isfinite(q).all()) for q in psi)
    expected = 3 * (4 * AOS_STAG_ITERS + 4)
    print(f"aos_staggered_eo path {MAIN_LAT} x {MAIN_COLS} rhs: eo_solve_packed {AOS_STAG_ITERS} "
          f"iters {wall:.3f} s, peak memory {peak:.2f} GiB, |r_e|^2={float(rs):.4e}, true rel "
          f"residual {res:.3e} (<= {AOS_STAG_RES}), K3 launches "
          f"{counts['batched_small_gemm']} (expected {expected}), E1 "
          f"{counts['batched_gemm_rowpack']}, finite {finite}", flush=True)
    if not (counts["batched_small_gemm"] == expected and counts["batched_gemm_rowpack"] == 0
            and res <= AOS_STAG_RES and finite):
        raise AssertionError("the AoS staggered packed solve did not run on K3 to its residual")
    return counts["batched_small_gemm"], wall, peak, res


def _lattice_coords(lat):
    return np.stack(np.meshgrid(*[np.arange(d) for d in lat], indexing="ij"), axis=-1)


def open_t_lists(lat):
    """(ii, jj) of a Wilson-shaped operator open in T: each row's valid
    offsets of WILSON_OFFSETS first (the T faces lack one), the padded
    slots pointing at the row's own site."""
    coords = _lattice_coords(lat)
    tgt = coords[..., None, :] + np.asarray(WILSON_OFFSETS)          # [*lat, 9, 4]
    valid = (tgt[..., 3] >= 0) & (tgt[..., 3] < lat[3])
    tgt = np.where(valid[..., None], tgt % np.asarray(lat), coords[..., None, :])
    order = np.argsort(~valid, axis=-1, kind="stable")
    return valid.sum(-1), np.take_along_axis(tgt, order[..., None], axis=-2)


def irregular_lists(lat, seed):
    """(ii, jj) of a truly irregular operator: row s holds its own site,
    then GATHER_NNZ[0] - 1 to GATHER_NNZ[1] - 1 random domain sites."""
    rng = np.random.default_rng(seed)
    lo, hi = GATHER_NNZ
    ii = rng.integers(lo, hi + 1, size=lat)
    jj = np.stack([rng.integers(0, d, size=lat + (hi,)) for d in lat], axis=-1)
    jj[..., 0, :] = _lattice_coords(lat)
    return ii, jj


def gather_index(ii, jj, lat):
    """(flat domain sites [V * nnz], valid slots [V, nnz]) of neighbour
    lists, on the card."""
    nnz = jj.shape[-2]
    flat = torch.as_tensor((jj * bsr._c_strides(lat)).sum(-1).reshape(-1), device="cuda")
    mask = torch.as_tensor(np.arange(nnz)[None, :] < ii.reshape(-1, 1), device="cuda")
    return flat, mask


def gather_plain(index, lat, colour, x, dtype, spin=None):
    """The plain version of a create_bsr (or, with ``spin``, create_kron_bsr)
    apply in ``dtype``: y[s] = sum over the valid slots k of block[s, k]
    x[jj[s, k]], by index_select and torch.einsum.  ``index``:
    gather_index's; colour: CArray [*lat, nnz, BI, BD]; x: complex [*lat,
    (KD,) BD, N]."""
    flat, mask = index
    V, nnz = mask.shape
    c = torch.complex(colour.re, colour.im).to(dtype).reshape((V, nnz) + colour.re.shape[-2:])
    c = c * mask[..., None, None]
    xg = x.to(dtype).reshape((V,) + x.shape[len(lat):]).index_select(0, flat)
    xg = xg.reshape((V, nnz) + xg.shape[1:])
    with cplx._full_f32():
        if spin is None:
            y = torch.einsum("vkij,vkjn->vin", c, xg)
        else:
            t = torch.einsum("vkcd,vkbdn->vkbcn", c, xg)
            y = torch.einsum("kab,vkbcn->vacn", spin.to(dtype), t)
    return y.reshape(tuple(lat) + y.shape[1:])


def wilson_spin_factors():
    """The Wilson operator's 9 spin factors at MASS (the centre, then
    -(1 -+ gamma_mu)/2 for +-mu), complex64 on the card."""
    g = gamma_matrices()
    eye = np.eye(4)
    k = [(MASS + 4.0) * eye] + [-0.5 * (eye + s * g[mu]) for mu in range(4) for s in (-1, 1)]
    return torch.as_tensor(np.stack(k), dtype=torch.complex64, device="cuda")


def gather_path(gen):
    """The gather modes of ``create_bsr``/``create_kron_bsr`` at GATHER_LAT
    (131,072 rows) x GATHER_COLS columns, complex64 values from the seed:
    (a) a Wilson-shaped 12x12-block operator open in T, merged into
    mode "stencil" (one batched product of J = 9 x 12 = 108 a Gauss part:
    E1); (b) a truly irregular one of 5-9 nonzeros a row, mode "gather"
    (J = 108: E1); (c) ``create_kron_bsr`` on (b)'s lists with the Wilson
    spin factors of 9 slots and 3x3 colour blocks (its colour stage
    [voli*9, 3, 3] @ [voli*9, 3, 32]: K3).  Each apply through
    ``bsr_krylov`` with the counts set to 0 just before and read just
    after, held against the plain version in f64 within GATHER_TOL of max
    |y|, then timed in turns with the plain version in complex64, beside
    its bytes bound.  Returns {case: (launches {"k3", "e1"}, max abs error,
    {"kernel", "plain"}: ms, (bound ms, by), mode)}."""
    lat, n, bw = GATHER_LAT, GATHER_COLS, GATHER_BLOCK
    V = int(np.prod(lat))
    nl = len(lat)
    labels = "xyzt"
    t0 = time.perf_counter()
    lists = {"a": open_t_lists(lat), "b": irregular_lists(lat, 7)}
    print(f"gather path {lat}: neighbour lists built in {time.perf_counter() - t0:.2f} s",
          flush=True)
    out = {}
    for case in ("a", "b", "c"):
        ii, jj = lists["a" if case == "a" else "b"]
        nnz = jj.shape[-2]
        kron = case == "c"
        blk = 3 if kron else bw
        colour = randn_c(lat + (nnz, blk, blk), gen)
        t0 = time.perf_counter()
        if kron:
            spin = wilson_spin_factors()
            op = create_kron_bsr(labels + "Sc", lat + (4, 3), labels + "Sc", lat + (4, 3),
                                 (1,) * nl + (1, 3), (1,) * nl + (1, 3), (1,) * nl + (4, 1),
                                 (1,) * nl + (4, 1), ii, jj, colour, spin, device="cuda")
            xshape, ox = lat + (4, 3, n), labels + "Scn"
        else:
            spin = None
            op = create_bsr(labels + "s", lat + (bw,), labels + "c", lat + (bw,),
                            (1,) * nl + (bw,), (1,) * nl + (bw,), ii, jj, colour,
                            device="cuda")
            xshape, ox = lat + (bw, n), labels + "cn"
        torch.cuda.synchronize()
        build = time.perf_counter() - t0
        x = torch.complex(torch.randn(xshape, generator=gen, device="cuda"),
                          torch.randn(xshape, generator=gen, device="cuda"))
        reset_counts()
        with captured_gemms() as calls:
            y = bsr_krylov(1.0, op, x, ox)
        torch.cuda.synchronize()
        counts = read_counts()
        launches = {"k3": counts["batched_small_gemm"], "e1": counts["batched_gemm_rowpack"]}
        want_mode = "stencil" if case == "a" else "gather"
        want_launch = {"k3": 3 if kron else 0, "e1": 0 if kron else 3}
        index = gather_index(ii, jj, lat)
        want = gather_plain(index, lat, colour, x, torch.complex128, spin)
        err = float((y.to(torch.complex128) - want).abs().max())
        scale = float(want.abs().max())
        print(f"check gather ({case}) {lat} x {n}: create_{'kron_' if kron else ''}bsr mode "
              f"{op.mode} (expected {want_mode}), {len(op.offsets) or op.ndir} "
              f"{'offsets' if op.offsets else 'slots'}, built in {build:.2f} s; launches "
              f"{launches} (expected {want_launch}); max|d| vs the plain version in f64 "
              f"{err:.3e} max|y| {scale:.3e} rel {err / scale:.3e} (<= {GATHER_TOL})",
              flush=True)
        if not (op.mode == want_mode and launches == want_launch
                and err <= GATHER_TOL * scale and y.shape == want.shape):
            raise AssertionError(f"gather case ({case}) disagrees or missed its kernel")
        del y, want
        ms = time_turns({"kernel": lambda: bsr_krylov(1.0, op, x, ox),
                         "plain": lambda: gather_plain(index, lat, colour, x,
                                                       torch.complex64, spin)}, reps=5)
        slots = int(ii.sum())
        nbytes = (2 * op.blocks_re.numel() * op.blocks_re.element_size()
                  + x.numel() * x.element_size()
                  + V * (4 if kron else 1) * blk * n * x.element_size())
        flops = 8 * slots * n * (blk * blk * 4 + 16 * blk if kron else blk * blk)
        bd_ = bound(nbytes, flops)
        print(f"time gather ({case}) {lat} x {n}: apply {ms['kernel']:.4f} ms, plain "
              f"{ms['plain']:.4f} ms (medians of 5 in turns); bound {bd_[0]:.4f} ms "
              f"({bd_[1]}: {nbytes / 1e9:.3f} GB, {flops / 1e9:.2f} GFLOP for the {slots} "
              f"valid slots)", flush=True)
        # one of the apply's three products alone, on its kernel and on
        # torch.bmm (the share of the apply the kernel takes)
        pb, px = calls[0]
        kernel = batched_small_gemm if batched_gemm_route(
            pb.shape[1], pb.shape[2], pb.dtype) == "small" else batched_gemm_rowpack
        prod = {"kernel": graph_ms(lambda: kernel(pb, px)),
                "plain": graph_ms(lambda: batched_small_gemm_reference(pb, px)),
                "bmm": graph_ms(lambda: torch.bmm(pb, px))}
        pbytes = (pb.numel() + px.numel() + pb.shape[0] * pb.shape[1] * px.shape[2]) \
            * pb.element_size()
        print(f"time gather ({case}) product {tuple(pb.shape)} @ {tuple(px.shape)} "
              f"{pb.dtype} device-only ({GRAPH_CALLS} calls a CUDA graph): "
              f"{kernel.__name__} {prod['kernel']:.4f} ms, plain {prod['plain']:.4f} ms, "
              f"torch.bmm {prod['bmm']:.4f} ms, bytes bound "
              f"{pbytes / HBM_BYTES_PER_S * 1e3:.4f} ms (three such products an apply)",
              flush=True)
        out[case] = (launches, err, ms, bd_, op.mode, prod)
        del op, colour, x, calls, pb, px
    return out


def e2_path(gen, rate):
    """E2, the bf16 roll-plus-add, through ``roll_add``: each form driven
    once (the counts set to 0 just before and read just after): vec16 in
    both variants at E2_SHAPES, pair in both at E2_FORM_SHAPES["pair"],
    elem (the f32 variant) at E2_FORM_SHAPES["elem"]; f32 bit-exact
    against the plain version, bf16x2 within one bf16 ulp (elements that
    differ counted), every form also checked at T of E2_CHECK_T; then each
    timed in turns with the plain version and torch.roll + add in bf16 on
    CUDA events and device-only (GRAPH_CALLS calls a CUDA graph), beside
    the bytes bound and the bytes over the measured copy ``rate``.  Returns
    {(variant, form): (launches, max abs error, {shape: {name: ms}},
    {shape: bound})}."""
    shapes = {"vec16": E2_SHAPES, "pair": (E2_FORM_SHAPES["pair"],),
              "elem": (E2_FORM_SHAPES["elem"],)}
    rows = [(v, f) for f in ("vec16", "pair") for v in VARIANTS] + [("f32", "elem")]
    xs = {shape: torch.randn(shape, generator=gen, device="cuda").bfloat16()
          for f in shapes for shape in shapes[f]}
    reset_counts()
    for v, f in rows:
        for shape in shapes[f]:
            roll_add(xs[shape], v)
    torch.cuda.synchronize()
    launches = read_counts()["roll_add"]
    by_row = dict(roll_add.by_variant_form)
    expect = {(v, f): len(shapes[f]) for v, f in rows}
    print(f"E2 path launches {launches}, by variant and form {by_row} (expected {expect})",
          flush=True)
    if by_row != expect or launches != sum(expect.values()):
        raise AssertionError(f"E2 launched {by_row} by variant and form, expected {expect}")

    def check(x, v, label):
        y = roll_add(x, v)
        want = roll_add_reference(x)
        d = (y.float() - want.float()).abs()
        ulp = 2.0 ** -7 * torch.clamp_min(want.float().abs(), 2.0 ** -126)
        ndiff = int((y != want).sum())
        ok = bool((d <= ulp).all()) and (v != "f32" or ndiff == 0)
        print(f"check E2 {v} {label}: {ndiff} of {x.numel()} elements differ from the plain "
              f"version, max|d| {float(d.max()):.3e} "
              f"{'(bit-exact required)' if v == 'f32' else '(<= 1 bf16 ulp)'} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise AssertionError(f"E2 {v} {label} disagrees with the plain version")
        return float(d.max())

    out = {}
    for v, f in rows:
        err = max(check(xs[shape], v, f"{f} {shape}") for shape in shapes[f])
        out[v, f] = [by_row[v, f], err, {}, {}]
    for T in E2_CHECK_T:
        x = torch.randn((33, 17, T), generator=gen, device="cuda").bfloat16()
        form = roll_add_form(T, x.data_ptr(), x.data_ptr())
        for v in VARIANTS if T % 2 == 0 else ("f32",):
            check(x, v, f"{form} (33, 17, {T})")
    for f, fshapes in shapes.items():
        for shape in fshapes:
            xx = xs[shape]
            fns = {v: (lambda v=v: roll_add(xx, v)) for v, ff in rows if ff == f}
            fns.update(plain=lambda: roll_add_reference(xx),
                       roll_bf16=lambda: torch.roll(xx, 1, dims=-1) + xx)
            ms = time_turns(fns, reps=25)
            dev = {k: graph_ms(fn) for k, fn in fns.items()}
            nbytes = 2 * xx.numel() * xx.element_size()
            bd_ = bound(nbytes, xx.numel())
            print(f"time E2 {f} {shape} bf16: " + ", ".join(
                f"{k} {t:.4f} ms (device-only {dev[k]:.4f})" for k, t in ms.items())
                + f" (medians of 25 in turns; {GRAPH_CALLS} calls a CUDA graph); bound "
                f"{bd_[0]:.4f} ms ({bd_[1]}), at the measured copy rate "
                f"{nbytes / rate * 1e3:.4f} ms", flush=True)
            for v, ff in rows:
                if ff == f:
                    out[v, f][2][shape] = {"kernel": ms[v], "plain": ms["plain"],
                                           "roll_bf16": ms["roll_bf16"],
                                           "kernel_device": dev[v], "plain_device": dev["plain"]}
                    out[v, f][3][shape] = bd_
    return out


def e3_path(gen):
    """E3, the transpose tile sweep, at E3_SHAPE f32 perm (3,2,1,0): each
    design point of TILES (the 16-byte ring family, K2's own point among
    them, and the TMA point) once with the counts set to 0 just before and
    read just after, each exact against ``x.permute(3,2,1,0).contiguous()``;
    then each timed in turns with that call and K2, beside the bytes bound.
    Returns {point: (launches, max abs error, ms)}, K2's and the call's ms
    and the bound."""
    x = torch.randn(E3_SHAPE, generator=gen, device="cuda")
    perm = PERMS["tzyx"]
    want = permute_4d_reference(x, perm)
    reset_counts()
    got = {tile: permute_4d_tiled(x, perm, tile) for tile in TILES}
    torch.cuda.synchronize()
    launches = read_counts()["permute_4d_tiled"]
    if launches != len(TILES):
        raise AssertionError(f"E3 path launches {launches}, expected {len(TILES)}")
    err = {tile: exact(y, want, f"E3 point {tile}") for tile, y in got.items()}
    print(f"check E3 {E3_SHAPE} f32 tzyx: every design point {TILES} bit-exact (TMA: "
          f"{[t for t in TILES if t[0] == 'tma']})", flush=True)
    del got, want
    fns = {tile: (lambda tile=tile: permute_4d_tiled(x, perm, tile)) for tile in TILES}
    fns.update(k2=lambda: permute_4d(x, perm), call=lambda: permute_4d_reference(x, perm))
    ms = time_turns(fns, reps=15)
    nbytes = 2 * x.numel() * x.element_size()
    bd_ = bound(nbytes, 0)
    print(f"time E3 {E3_SHAPE} f32 tzyx (medians of 15 in turns): "
          + ", ".join(f"{k} {t:.4f} ms ({nbytes / t / 1e6:.1f} GB/s)" for k, t in ms.items())
          + f"; bound {bd_[0]:.4f} ms ({bd_[1]})", flush=True)
    dev = {k: graph_ms(fn) for k, fn in fns.items()}
    print(f"time E3 {E3_SHAPE} f32 tzyx device-only ({GRAPH_CALLS} calls a CUDA graph): "
          + ", ".join(f"{k} {t:.4f} ms" for k, t in dev.items()), flush=True)
    return ({tile: (1, err[tile], ms[tile], dev[tile]) for tile in TILES},
            (ms["k2"], dev["k2"]), ms["call"], bd_)


#: the checkpoint phase's file order (spin, colour and column labels after
#: the lattice, as the JAX package's worked example) and the order it is
#: reloaded in: the solve's SoA field [n, spin, colour, *lat]
CKPT_ORDER, CKPT_LOAD_ORDER = "xyztscn", "nscxyzt"
#: blocks of the checkpoint, cut along x
CKPT_BLOCKS = 4


def checkpoint_path(op, b, psi):
    """The solve's psi (32^3x64 x 8, complex64) checkpointed in S3T with
    block CRCs (checksum level 2) in the file order CKPT_ORDER, the file
    reopened, its checksums verified and psi loaded back on the card in
    the order CKPT_LOAD_ORDER: bit for bit, so its true residual is the
    solve's; then save_async of the same tensor (resolved by
    close_storage; the same CRCs) and one load_stream pass, window by
    window against psi.  Times save and load apart; the file lives in a
    temporary directory, deleted after the phase.  Returns its walls."""
    n, lat = MAIN_COLS, MAIN_LAT
    psi7 = cplx.cmap(lambda v: v.reshape((n, 4, 3) + lat), psi)
    dim = lat + (4, 3, n)
    nbytes = int(np.prod(dim)) * 8
    step = lat[0] // CKPT_BLOCKS
    boxes = [((i * step,) + (0,) * 6, (step,) + dim[1:]) for i in range(CKPT_BLOCKS)]
    served = collections.Counter()
    intersect_all = native.intersect_all

    def counted(*args, **kw):
        rows = intersect_all(*args, **kw)
        served["native" if rows is not None else "python"] += 1
        return rows

    native.intersect_all = counted
    tmp = tempfile.mkdtemp(prefix="sbt_ckpt_")
    walls = {}
    try:
        res = true_residual(op, psi, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = os.path.join(tmp, "psi.s3t")
        sto = storage.create_storage(path, CKPT_ORDER, dim, dtype=np.complex64, checksum=2,
                                     metadata="wilson eo solution")
        storage.append_blocks(sto, boxes)
        walls["declare"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        storage.save(1.0, psi7, CKPT_LOAD_ORDER, sto, CKPT_ORDER)
        storage.close_storage(sto)
        walls["save"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        back_sto = storage.open_storage(path, mode="r")
        storage.check_or_write_checksums(back_sto)
        walls["verify"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = storage.load(1.0, back_sto, cplx.cmap(torch.empty_like, psi7), CKPT_LOAD_ORDER,
                            CKPT_ORDER)
        torch.cuda.synchronize()
        walls["load"] = time.perf_counter() - t0
        exact = (back.re.device == psi.re.device and torch.equal(back.re, psi7.re)
                 and torch.equal(back.im, psi7.im))
        res_back = true_residual(op, cplx.cmap(lambda v: v.reshape(psi.re.shape), back), b)
        del back
        print(f"checkpoint {dim} {CKPT_ORDER} complex64, {CKPT_BLOCKS} blocks, "
              f"{nbytes / 1e9:.3f} GB, checksum 2: declare {walls['declare']:.3f} s, save "
              f"(with the block CRCs and close) {walls['save']:.3f} s "
              f"({nbytes / walls['save'] / 1e9:.3f} GB/s), open and verify "
              f"{walls['verify']:.3f} s, load in {CKPT_LOAD_ORDER} onto the card "
              f"{walls['load']:.3f} s ({nbytes / walls['load'] / 1e9:.3f} GB/s); bit for bit "
              f"{exact}, true residual {res_back:.6e} (the solve's {res:.6e})", flush=True)
        if not exact or res_back != res:
            raise AssertionError("the checkpoint did not reload bit for bit")
        path2 = os.path.join(tmp, "psi_async.s3t")
        sto2 = storage.create_storage(path2, CKPT_ORDER, dim, dtype=np.complex64, checksum=2,
                                      metadata="wilson eo solution")
        storage.append_blocks(sto2, boxes)
        t0 = time.perf_counter()
        fut = storage.save_async(1.0, psi7, CKPT_LOAD_ORDER, sto2, CKPT_ORDER)
        walls["async_return"] = time.perf_counter() - t0
        storage.close_storage(sto2)
        walls["async"] = time.perf_counter() - t0
        tails = []
        for p_ in (path, path2):
            with open(p_, "rb") as f:
                f.seek(-8 * (CKPT_BLOCKS + 1), os.SEEK_END)
                tails.append(f.read())
        if not (fut.done() and tails[0] == tails[1]
                and os.path.getsize(path) == os.path.getsize(path2)):
            raise AssertionError("save_async wrote another file than save")
        os.remove(path2)
        want = torch.complex(*psi7).permute(3, 4, 5, 6, 1, 2, 0)   # file order, a view
        t0 = time.perf_counter()
        rows, nwin = 0, 0
        for wfrom, win in storage.load_stream(back_sto):
            got = torch.from_numpy(win).to("cuda")
            if not torch.equal(got, want[wfrom[0]:wfrom[0] + win.shape[0]]):
                raise AssertionError(f"load_stream window at {wfrom} differs from psi")
            rows += win.shape[0]
            nwin += 1
        walls["stream"] = time.perf_counter() - t0
        storage.close_storage(back_sto)
        del want
        if rows != lat[0]:
            raise AssertionError(f"load_stream gave {rows} rows of {lat[0]}")
        print(f"checkpoint save_async (declared first): returned in "
              f"{walls['async_return']:.3f} s, resolved by close_storage at "
              f"{walls['async']:.3f} s, the same block and header CRCs; "
              f"load_stream {nwin} windows {walls['stream']:.3f} s "
              f"({nbytes / walls['stream'] / 1e9:.3f} GB/s) equal to psi; intersections "
              f"served by the native plan engine {served['native']}, by the Python sweep "
              f"{served['python']} (library {native.library_path()})", flush=True)
        if native.get_lib() is None or served["python"] or not served["native"]:
            raise AssertionError("the native plan engine did not serve the intersections")
    finally:
        native.intersect_all = intersect_all
        shutil.rmtree(tmp, ignore_errors=True)
    return walls


def dense_solve_path(clover_blocks, rate):
    """The dense factorisations on the clover path's site blocks (24^3x48,
    663,552 12x12 matrices, complex64): A = (4 + mass) I + the clover
    term, Hermitian; positive definite by its smallest eigenvalue (else
    A^H A is factorised, and the phase says so).  ``inversion`` (max |A
    A^-1 - I|), ``gesm`` on 8 right-hand sides against A^-1 x,
    ``cholesky`` (U^H U against A) and ``trsm`` of U against ``gesm`` of
    U.  Walls, and the bound of each op's bytes (each input read once,
    each output written once) at the measured copy rate ``rate``."""
    lat, n = CLOVER_LAT, MAIN_COLS
    A = cplx.cmap(lambda v: v.reshape((12, 12) + lat).clone(), clover_blocks)
    diag = torch.arange(12, device="cuda")
    A.re[diag, diag] += 4.0 + CLOVER_MASS
    Ac = torch.complex(*A).permute(2, 3, 4, 5, 0, 1).reshape(-1, 12, 12)
    herm = float((Ac - Ac.mH).abs().max() / Ac.abs().max())
    # cuSOLVER's batched eigensolver (torch 2.11, CUDA 12.8) refuses batches
    # of 32768 matrices and more (CUSOLVER_STATUS_INVALID_VALUE); 4096 pass
    lam = min(float(torch.linalg.eigvalsh(c).min()) for c in Ac.split(4096))
    pd = lam > 0 and herm <= 1e-6
    if not pd:
        Ac = Ac.mH @ Ac
        A = cplx.from_complex(Ac.reshape(lat + (12, 12)).permute(4, 5, 0, 1, 2, 3).contiguous())
    print(f"dense path {lat}: {Ac.shape[0]} site blocks 12x12 complex64 of (4 + {CLOVER_MASS}) "
          f"I + the clover term: max |A - A^H| / max |A| {herm:.3e}, smallest eigenvalue "
          f"{lam:.6f}: "
          + ("positive definite, factorised as they are" if pd else
             "not positive definite, A^H A factorised instead"), flush=True)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    X = randn_c((12, n) + lat, gen)
    o, ox, oy = "rcxyzt", "rnxyzt", "cnxyzt"
    walls, out = {}, {}

    def run(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[name] = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0

    run("inversion", lambda: dense.inversion(A, o, "r", "c"))
    run("gesm", lambda: dense.gesm(1.0, A, o, "r", "c", X, ox, oy))
    run("cholesky", lambda: dense.cholesky(A, o, "r", "c"))
    U = out["cholesky"]
    run("trsm", lambda: dense.trsm(1.0, U, o, "r", "c", X, ox, oy))
    run("gesm_u", lambda: dense.gesm(1.0, U, o, "r", "c", X, ox, oy))

    def mats(c, rows, cols):       # [V, rows, cols] complex from "..xyzt"
        return torch.complex(*c).reshape(rows, cols, -1).permute(2, 0, 1)

    inv = mats(out["inversion"], 12, 12)
    errs = {"inversion": float((Ac @ inv - torch.eye(12, device="cuda")).abs().max())}
    xm = mats(X, 12, n)
    ref = inv @ xm
    errs["gesm"] = float((mats(out["gesm"], 12, n) - ref).abs().max() / ref.abs().max())
    um = mats(U, 12, 12)
    errs["cholesky"] = float((um.mH @ um - Ac).abs().max() / Ac.abs().max())
    errs["upper"] = float(torch.tril(um, -1).abs().max())
    yg = mats(out["gesm_u"], 12, n)
    errs["trsm"] = float((mats(out["trsm"], 12, n) - yg).abs().max() / yg.abs().max())
    mat_b, rhs_b = Ac.shape[0] * 144 * 8, Ac.shape[0] * 12 * n * 8
    bytes_ = {"inversion": 2 * mat_b, "gesm": mat_b + 2 * rhs_b, "cholesky": 2 * mat_b,
              "trsm": mat_b + 2 * rhs_b, "gesm_u": mat_b + 2 * rhs_b}
    print("dense path walls (s) beside the bytes at the measured copy rate: " + ", ".join(
        f"{k} {walls[k]:.4f} (bound {bytes_[k] / rate * 1e3:.4f} ms)" for k in walls),
        flush=True)
    print(f"dense path checks: max |A A^-1 - I| {errs['inversion']:.3e} (<= 1e-4); gesm "
          f"against A^-1 x {errs['gesm']:.3e}; |U^H U - A| {errs['cholesky']:.3e}, below "
          f"U's diagonal {errs['upper']:.1e}; trsm of U against gesm of U {errs['trsm']:.3e} "
          f"(each <= 1e-4 relative)", flush=True)
    if not (errs["inversion"] <= 1e-4 and errs["upper"] == 0
            and max(errs["gesm"], errs["cholesky"], errs["trsm"]) <= 1e-4):
        raise AssertionError(f"dense path: {errs}")
    return walls


#: turns of the tracked and the undecorated call for a launch's host time
LAUNCH_TURNS = 8
#: tracked GFLOP/s against CUDA events: each tracked apply adds its
#: launch and a wait (tens of us) to about 3.7 ms of kernel
TRACK_AGREE = 0.15


def tracker_aot_path(op, b, gen):
    """The tracker, the context and the AOT capture around K1: five
    Wilson applies at the main shape with SBT_TRACK_TIME=1 (their GFLOP/s
    in ``report_timings`` against the same applies on CUDA events); the
    host time of ``apply_stencil_soa`` and of K1's wrapper
    (``stencil_matvec_soa``, its ``k1`` span site) with tracking off
    against their undecorated bodies, in turns, at the bench shape; ``aot_compile`` of one Wilson CG iteration
    at the bench shape, its replay against the eager call bit for bit;
    ``export_compiled``/``load_exported`` of the Wilson apply at 8^4 x 8,
    the loaded program launching K1, and of a 4-D relabel at 64^4 f32, the
    loaded program launching K2.  Returns the numbers it printed."""
    ctx = context.create_context()
    out = {}
    n = MAIN_COLS
    apply_wilson(op, b)
    os.environ["SBT_TRACK_TIME"] = "1"
    flags.clear_cache()
    try:
        tracker.reset_timings()
        torch.cuda.synchronize()
        for _ in range(5):
            apply_wilson(op, b)
        t = tracker.get_timings()["apply_stencil_soa"]
        print(tracker.report_timings(), flush=True)
    finally:
        os.environ["SBT_TRACK_TIME"] = "0"
        flags.clear_cache()
    tracker.reset_timings()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(5):
        apply_wilson(op, b)
    e.record()
    e.synchronize()
    flops = 5 * op.flops_per_matvec(n)
    out["tracked_gflops"] = t["flops"] / t["seconds"] / 1e9
    out["events_gflops"] = flops / (s.elapsed_time(e) * 1e-3) / 1e9
    ratio = out["tracked_gflops"] / out["events_gflops"]
    print(f"tracker: {t['calls']} tracked applies {MAIN_LAT} x {n}, {t['seconds']:.6f} s, "
          f"{out['tracked_gflops']:.1f} GFLOP/s (reference model); the same five on CUDA "
          f"events {s.elapsed_time(e):.4f} ms, {out['events_gflops']:.1f} GFLOP/s; ratio "
          f"{ratio:.4f} (within {TRACK_AGREE:.0%}); memory {tracker.report_memory_usage()}",
          flush=True)
    if t["calls"] != 5 or t["flops"] != flops or abs(ratio - 1) > TRACK_AGREE:
        raise AssertionError(f"tracked applies {t} disagree with CUDA events")

    lat8 = (8, 8, 16, 128)
    op8 = wilson_operator(lat8, mass=0.1, key=0, layout="soa", device=ctx.device)
    x8 = context.make_sure(cplx.cmap(lambda v: v.cpu(), randn_c((n, 12) + lat8, gen)), ctx)
    tracked, untracked = bsr.apply_stencil_soa, bsr.apply_stencil_soa.__wrapped__
    k1_args = (op8.blocks, op8.kron, x8, op8.offsets, 3, 3)
    calls = {"tracked": lambda: tracked(op8, x8), "untracked": lambda: untracked(op8, x8),
             "k1": lambda: stencil_matvec_soa(*k1_args),
             "k1 body": lambda: stencil_matvec_soa.__wrapped__(*k1_args)}
    turns = {k: [] for k in calls}
    for r in range(LAUNCH_TURNS):
        for k in (list(calls) if r % 2 == 0 else list(calls)[::-1]):
            turns[k].append(launch_us(calls[k]))
    out["host_us"] = {k: statistics.median(v) for k, v in turns.items()}
    print(f"K1 wrapper host time at {lat8} x {n}, tracking off, {LAUNCH_TURNS} turns of "
          f"{LAUNCH_CALLS} calls: apply_stencil_soa {out['host_us']['tracked']:.2f} us, "
          f"undecorated {out['host_us']['untracked']:.2f} us (turns "
          f"{[round(v, 2) for v in turns['tracked']]} / "
          f"{[round(v, 2) for v in turns['untracked']]}); stencil_matvec_soa with its "
          f"``k1`` span site {out['host_us']['k1']:.2f} us, its body alone "
          f"{out['host_us']['k1 body']:.2f} us (turns {[round(v, 2) for v in turns['k1']]} / "
          f"{[round(v, 2) for v in turns['k1 body']]})", flush=True)

    op8_h = adjoint_operator(op8)
    state = (cplx.cmap(torch.zeros_like, x8), x8, x8, cplx.inner_real(x8, x8))
    t0 = time.perf_counter()
    step = aot.aot_compile(lambda *st: cg_step(op8, st, op8_h), state)
    out["capture_s"] = time.perf_counter() - t0
    nxt = cg_step(op8, state, op8_h)
    for st in (state, nxt):
        got, want = step(*st), cg_step(op8, st, op8_h)
        same = all(torch.equal(g, w) for g, w in zip(torch.utils._pytree.tree_leaves(got),
                                                      torch.utils._pytree.tree_leaves(want)))
        if not same:
            raise AssertionError("the CUDA-graph replay of a CG iteration differs from the "
                                 "eager call")
    ms = time_turns({"eager": lambda: cg_step(op8, state, op8_h),
                     "replay": lambda: step(*state),
                     "graph": step.graph.replay}, reps=15)
    out["cg_step_ms"] = ms
    context.wait(nxt)
    print(f"aot_compile of a CG iteration {lat8} x {n} (2 K1 applies, axpys, inner "
          f"products): captured in {out['capture_s']:.3f} s; replay equals eager bit for "
          f"bit (two states); eager {ms['eager']:.4f} ms, replay with argument copies "
          f"{ms['replay']:.4f} ms, graph alone {ms['graph']:.4f} ms (medians of 15, turns)",
          flush=True)

    lat4 = (8, 8, 8, 8)
    op4 = wilson_operator(lat4, mass=0.1, key=0, layout="soa", device="cuda")
    x4 = randn_c((n, 12) + lat4, gen)
    fn = lambda v: apply_wilson(op4, v)
    want = fn(x4)
    tmp = tempfile.mkdtemp(prefix="sbt_export_")
    try:
        t0 = time.perf_counter()
        path = aot.export_compiled(fn, (x4,), os.path.join(tmp, "wilson.pt2"))
        loaded = aot.load_exported(path)
        out["export_s"] = time.perf_counter() - t0
        before = dict(stencil_matvec_soa.by_route)
        got = loaded(x4)
        after = dict(stencil_matvec_soa.by_route)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    moved = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    exact = torch.equal(got.re, want.re) and torch.equal(got.im, want.im)
    print(f"export_compiled/load_exported of the Wilson apply {lat4} x {n}: "
          f"{out['export_s']:.2f} s; the loaded program's K1 launches by route {moved}; "
          f"equal to the eager apply {exact}", flush=True)
    if moved != {"tiled": 1} or not exact:
        raise AssertionError("the exported Wilson apply did not launch K1 or differs")

    # a 4-D relabel of f32 data exported: the loaded program launches K2
    xp = torch.randn((64, 64, 64, 64), generator=gen, device="cuda")
    fn = lambda v: local_permute(v, "xyzt", "tyzx")
    want = fn(xp)
    tmp = tempfile.mkdtemp(prefix="sbt_export_")
    try:
        path = aot.export_compiled(fn, (xp,), os.path.join(tmp, "permute.pt2"))
        loaded = aot.load_exported(path)
        before = dict(permute_4d.by_route)
        got = loaded(xp)
        after = dict(permute_4d.by_route)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    moved = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}
    exact = torch.equal(got, want)
    print(f"export_compiled/load_exported of local_permute xyzt->tyzx at 64^4 f32: the "
          f"loaded program's K2 launches by route {moved}; equal to the eager call {exact}",
          flush=True)
    if sum(moved.values()) != 1 or not exact:
        raise AssertionError("the exported relabel did not launch K2 once or differs")
    return out



def probe_export_path(gen):
    """The entries no package path calls, exported (fault P7): K1's
    runtime-shape route, the schedules K4a/K4b (Wilson operator 8^4 x 8),
    E3 (64^4 f32 at its first design point) and E2 (both variants at
    [4096, 32, 256] bf16), each traced at CUDA tensors into its custom op
    with ``export_compiled``, reloaded with ``load_exported``, and run once
    with the counts set to 0 just before and read just after: its kernel
    launches once and gives the eager call's bits.  Returns {entry:
    launches of the loaded program}."""
    lat4 = (8, 8, 8, 8)
    op4 = wilson_operator(lat4, mass=0.1, key=0, layout="soa", device="cuda")
    x4 = randn_c((8, 12) + lat4, gen)
    xp = torch.randn(E3_SHAPE, generator=gen, device="cuda")
    xr = torch.randn(E2_SHAPES[1], generator=gen, device="cuda").to(torch.bfloat16)

    def soa(entry):
        def fn(br, bi, kr, ki, xre, xim):
            y = entry(CArray(br, bi), CArray(kr, ki), CArray(xre, xim), op4.offsets, 3, 3)
            return y.re, y.im
        return fn, (op4.blocks.re, op4.blocks.im, op4.kron.re, op4.kron.im, x4.re, x4.im)

    cases = {
        "stencil_matvec_soa_rt": (stencil_matvec_soa_rt, *soa(stencil_matvec_soa_rt)),
        "stencil_matvec_soa_xin": (stencil_matvec_soa_xin, *soa(stencil_matvec_soa_xin)),
        "stencil_matvec_soa_stream": (stencil_matvec_soa_stream,
                                      *soa(stencil_matvec_soa_stream)),
        "permute_4d_tiled": (permute_4d_tiled,
                             lambda v: (permute_4d_tiled(v, PERMS["tzyx"], TILES[0]),),
                             (xp,)),
        "roll_add[f32]": (roll_add, lambda v: (roll_add(v, "f32"),), (xr,)),
        "roll_add[bf16x2]": (roll_add, lambda v: (roll_add(v, "bf16x2"),), (xr,)),
    }
    out = {}
    for name, (counter, fn, args) in cases.items():
        want = fn(*args)
        tmp = tempfile.mkdtemp(prefix="sbt_export_")
        try:
            path = aot.export_compiled(fn, args, os.path.join(tmp, "probe.pt2"))
            loaded = aot.load_exported(path)
            torch.cuda.synchronize()
            reset_counts()
            got = loaded(*args)
            torch.cuda.synchronize()
            launches = counter.launches
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        same = all(torch.equal(g, w) for g, w in zip(got, want))
        print(f"export_compiled/load_exported of {name}: the loaded program launches "
              f"{launches} (expected 1), equal to the eager call {same}", flush=True)
        if launches != 1 or not same:
            raise AssertionError(f"the exported {name} did not launch its kernel once or "
                                 "differs from the eager call")
        out[name] = launches
    return out


# ---------------------------------------------------------------------------
# the dist phase: the distributed layer (superbblas_tpu_torch.parallel)

#: part (a): one rank on NCCL at the main path's size, CG iterations
DIST_ITERS_A = CG_ITERS
#: part (b): four ranks on gloo, CUDA tensors on cuda:0, each rank
#: 16x32x32x64 (reduced from the main path's 32 per rank so that four
#: ranks' CG state, halos and CUDA contexts fit one card), 8 columns
DIST_RANKS, DIST_X_LOCAL, DIST_REST, DIST_COLS, DIST_ITERS_B = 4, 16, (32, 32, 64), 8, 10
#: the small lattices of part (b)'s overlap (K3) and sharded gather (E1)
#: checks, and of its redistribution variants
DIST_AOS_LAT, DIST_GATHER_LAT, DIST_REDIST_DIM = (16, 8, 8, 16), (16, 8, 8, 16), (
    2, 12, 22, 8, 8, 16)
DIST_ORDER = "nfxyzt"


def _randn_c(shape, gen, dtype=torch.float32) -> CArray:
    def part():
        return torch.randn(shape, generator=gen, device=gen.device).to(dtype)
    return CArray(part(), part())


def dist_spec(name="X"):
    from superbblas_tpu_torch import parallel as par

    return par.PartitionSpec(None, None, name, None, None, None)


def dist_part_a(op, b, device="cuda", iters=DIST_ITERS_A):
    """Part (a): world size 1 on NCCL (gloo where ``device`` is the CPU,
    for a rehearsal), a 1-rank mesh on X over the main operator: the
    normal-equation CG through ``solvers.cg`` on DTensors whose operator
    is ``apply_stencil_soa_sharded`` (K1), against the same CG on plain
    tensors (to 1e-5 relative: the DTensor inner products sum in their
    own order); the solution saved with ``save_sharded`` and
    reloaded with ``load_sharded`` bit for bit; ``redistribute_auto`` to a
    toroidally shifted (non-grid) partition and back, bit for bit.
    Returns (K1 launches in the sharded solve, walls)."""
    import torch.distributed as dist

    from superbblas_tpu_torch import parallel as par, solvers

    t_all = time.perf_counter()
    par.initialize_distributed(device=device)
    backend = dist.get_backend()
    mesh = par.make_mesh({"X": 1}, device)
    sh = par.NamedSharding(mesh, dist_spec())
    op_h = adjoint_operator(op)
    op_s = op.replace(blocks=par.reshard(op.blocks, sh))
    oph_s = op_h.replace(blocks=par.reshard(op_h.blocks, sh))
    b_s = par.reshard(b, sh)
    axes = {"x": "X"}

    def A(v):
        return par.apply_stencil_soa_sharded(
            oph_s, par.apply_stencil_soa_sharded(op_s, v, mesh, axes), mesh, axes)

    walls, hist = {}, []
    sync(device)
    reset_counts()
    t0 = time.perf_counter()
    rhs = par.apply_stencil_soa_sharded(oph_s, b_s, mesh, axes)
    x, rs, it = solvers.cg(A, rhs, tol=0.0, maxiter=iters, callback=hist.append)
    sync(device)
    walls["solve"] = time.perf_counter() - t0
    launches = read_counts()["stencil_matvec_soa"]
    hist = [float(v) for v in hist]
    # the same CG on plain tensors
    hist_p = []
    rhs_p = bsr.apply_stencil_soa(op_h, b)
    xp, rsp, _ = solvers.cg(lambda v: bsr.apply_stencil_soa(op_h, bsr.apply_stencil_soa(op, v)),
                            rhs_p, tol=0.0, maxiter=iters, callback=hist_p.append)
    hist_p = [float(v) for v in hist_p]
    xl = cplx.cmap(lambda a: a.to_local(), x)
    same = torch.equal(xl.re, xp.re) and torch.equal(xl.im, xp.im)
    rel = max(float((a - c).abs().max()) for a, c in zip(xl, xp)) / float(xp.re.abs().max())
    hist_rel = max(abs(a - c) / abs(c) for a, c in zip(hist, hist_p))
    print(f"dist (a) {backend} world {dist.get_world_size()}, mesh X=1, {MAIN_LAT} x "
          f"{b.re.shape[0]}: sharded CG {iters} iterations {walls['solve']:.3f} s, K1 launches "
          f"{launches} (expected {2 * iters + 1}); against the CG on plain tensors: bit for "
          f"bit {same}, max rel diff {rel:.3e}, residual history max rel diff {hist_rel:.3e}; "
          f"|r|^2 {hist[0]:.4e} -> {hist[-1]:.4e}", flush=True)
    # a DTensor's reductions sum in their own order: equal to 1e-5, not bit for bit
    if launches != 2 * iters + 1 or rel > 1e-5 or hist_rel > 1e-5:
        raise AssertionError("dist (a): the sharded solve differs from the plain one")
    del xp, rhs_p, rhs
    x_solvers = x
    x, walls_e, launches_e = dist_part_a_entry(op, b, op_s, oph_s, b_s, mesh, axes, iters,
                                               device)
    walls.update(walls_e)
    rel_s = max(float((a.to_local() - c.to_local()).abs().max()) for a, c in zip(x, x_solvers))
    rel_s /= float(x_solvers.re.to_local().abs().max())
    print(f"dist (a) cg_solve on DTensors against the solvers.cg solve above: max rel diff "
          f"{rel_s:.3e} (the two CGs order their updates apart)", flush=True)
    if rel_s > 1e-5:
        raise AssertionError("dist (a): cg_solve on DTensors differs from solvers.cg")
    del op_s, oph_s, x_solvers
    # checkpoint: one block, reloaded bit for bit
    tmp = tempfile.mkdtemp(prefix="sbt_dist_")
    try:
        path = os.path.join(tmp, "psi.s3t")
        nbytes = x.re.numel() * 8
        sync(device)
        t0 = time.perf_counter()
        sto = storage.create_storage_sharded(path, DIST_ORDER, tuple(x.re.shape),
                                             dtype=np.complex64, checksum=2)
        storage.save_sharded(sto, x, DIST_ORDER)
        storage.close_storage_sharded(sto)
        walls["save"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sto = storage.open_storage(path, mode="r")
        back = storage.load_sharded(sto, sh)
        sync(device)
        walls["load"] = time.perf_counter() - t0
        storage.close_storage(sto)
        exact = all(torch.equal(a.to_local(), c.to_local()) for a, c in zip(back, x))
        print(f"dist (a) checkpoint {tuple(x.re.shape)} complex64 {nbytes / 1e9:.3f} GB, one "
              f"block: save_sharded {walls['save']:.3f} s ({nbytes / walls['save'] / 1e9:.3f} "
              f"GB/s), load_sharded {walls['load']:.3f} s ({nbytes / walls['load'] / 1e9:.3f} "
              f"GB/s), bit for bit {exact}", flush=True)
        if not exact:
            raise AssertionError("dist (a): the checkpoint did not reload bit for bit")
        del back
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # redistribute_auto: to a shifted (non-grid) partition on the plan path, and back
    dim = tuple(x.re.shape)
    src = par.sharding_partition(x.re, dim)
    shifted = par.Partition(dim=dim, boxes=(((0, 0, 5, 0, 0, 0), dim),))
    sync(device)
    t0 = time.perf_counter()
    y = par.redistribute_auto(x, src, shifted, order=DIST_ORDER)
    sync(device)
    walls["redist_to"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    z = par.redistribute_auto(y, shifted, src, order=DIST_ORDER)
    sync(device)
    walls["redist_back"] = time.perf_counter() - t0
    loc = lambda a: a.to_local() if hasattr(a, "to_local") else a  # noqa: E731
    exact = all(torch.equal(loc(a), loc(c)) for a, c in zip(z, x)) and all(
        torch.equal(loc(a), loc(c)) for a, c in zip(y, x))
    nbytes = 2 * x.re.numel() * x.re.element_size()
    print(f"dist (a) redistribute_auto to the X-shifted partition (the plan: pack, exchange, "
          f"unpack) {walls['redist_to']:.3f} s ({nbytes / walls['redist_to'] / 1e9:.3f} GB/s "
          f"of field), back (the plan; one rank's whole box is 'on master') "
          f"{walls['redist_back']:.3f} s; bit for bit {exact}", flush=True)
    if not exact:
        raise AssertionError("dist (a): the redistribution is not exact")
    walls["all"] = time.perf_counter() - t_all
    del x, y, z
    par.mesh._DEVICE_MESHES.clear()
    dist.destroy_process_group()
    return {"solvers_cg": launches, **launches_e}, walls


def _cg_explicit(op_s, oph_s, b_s, mesh, axes, iters):
    """``models.cg_solve``'s iteration, each apply an explicit
    ``parallel.apply_stencil_soa_sharded`` call (the reference the
    ordinary entry point is held to bit for bit)."""
    from superbblas_tpu_torch import parallel as par
    from superbblas_tpu_torch.models.wilson import _axpy

    def A(v):
        return par.apply_stencil_soa_sharded(op_s, v, mesh, axes)

    def Ah(v):
        return par.apply_stencil_soa_sharded(oph_s, v, mesh, axes)

    rhs = Ah(b_s)
    x, rr, p, rs = cplx.cmap(torch.zeros_like, b_s), rhs, rhs, cplx.inner_real(rhs, rhs)
    for _ in range(iters):
        ap = Ah(A(p))
        alpha = rs / torch.clamp_min(cplx.inner_real(p, ap), 1e-30)
        x = _axpy(alpha, p, x)
        rr = _axpy(-alpha, ap, rr)
        rs_new = cplx.inner_real(rr, rr)
        beta = rs_new / torch.clamp_min(rs, 1e-30)
        p = _axpy(beta, p, rr)
        rs = rs_new
    return x, rs


def dist_part_a_entry(op, b, op_s, oph_s, b_s, mesh, axes, iters, device):
    """Part (a)'s ordinary entry points on DTensors: ``models.cg_solve`` on
    the sharded operator and field (its adjoint built from the sharded
    blocks), bit for bit against the same CG through explicit
    ``apply_stencil_soa_sharded`` calls, with 2 iters + 1 K1 launches;
    ``eo_solve_packed_soa`` on them against the plain call (4 iters + 4
    packed K1 launches each); the walls beside ``cg_solve`` and
    ``eo_solve_packed_soa`` on plain tensors.  Returns (the DTensor
    cg_solve's x, walls, K1 launches)."""
    walls, launches = {}, {}
    sync(device)
    reset_counts()
    t0 = time.perf_counter()
    x, rs = cg_solve(op_s, b_s, n_iters=iters)
    sync(device)
    walls["cg_solve_dtensor"] = time.perf_counter() - t0
    launches["cg_solve_dtensor"] = read_counts()["stencil_matvec_soa"]
    xe, rse = _cg_explicit(op_s, oph_s, b_s, mesh, axes, iters)
    bits = all(torch.equal(a.to_local(), c.to_local()) for a, c in zip(x, xe)) and \
        float(rs) == float(rse)
    del xe
    sync(device)
    t0 = time.perf_counter()
    xp, rsp = cg_solve(op, b, n_iters=iters)
    sync(device)
    walls["cg_solve_plain"] = time.perf_counter() - t0
    rel = max(float((a.to_local() - c).abs().max()) for a, c in zip(x, xp)) / float(
        xp.re.abs().max())
    del xp
    print(f"dist (a) models.cg_solve on DTensors (mesh X=1) {iters} iterations "
          f"{walls['cg_solve_dtensor']:.3f} s, K1 launches {launches['cg_solve_dtensor']} "
          f"(expected {2 * iters + 1}); against the same CG through explicit "
          f"apply_stencil_soa_sharded calls: bit for bit {bits}; against cg_solve on plain "
          f"tensors ({walls['cg_solve_plain']:.3f} s): max rel diff {rel:.3e}", flush=True)
    if launches["cg_solve_dtensor"] != 2 * iters + 1 or not bits or rel > 1e-5:
        raise AssertionError("dist (a): cg_solve on DTensors")
    eo_it = EO_ITERS
    a = MASS + 4.0
    sync(device)
    reset_counts()
    t0 = time.perf_counter()
    psi, rs_eo = eo_solve_packed_soa(op_s, b_s, a, n_iters=eo_it)
    sync(device)
    walls["eo_dtensor"] = time.perf_counter() - t0
    launches["eo_dtensor"] = read_counts()["stencil_matvec_soa"]
    t0 = time.perf_counter()
    psi_p, rs_p = eo_solve_packed_soa(op, b, a, n_iters=eo_it)
    sync(device)
    walls["eo_plain"] = time.perf_counter() - t0
    rel_eo = max(float((u.to_local() - c).abs().max()) for u, c in zip(psi, psi_p)) / float(
        psi_p.re.abs().max())
    print(f"dist (a) eo_solve_packed_soa on DTensors {eo_it} iterations "
          f"{walls['eo_dtensor']:.3f} s, K1 launches {launches['eo_dtensor']} (expected "
          f"{4 * eo_it + 4}); against the plain call ({walls['eo_plain']:.3f} s): max rel "
          f"diff {rel_eo:.3e}, |r|^2 {float(rs_eo):.4e} vs {float(rs_p):.4e}", flush=True)
    if launches["eo_dtensor"] != 4 * eo_it + 4 or rel_eo > 1e-5:
        raise AssertionError("dist (a): eo_solve_packed_soa on DTensors")
    del psi, psi_p
    return x, walls, launches


def sync(device):
    if device == "cuda":
        torch.cuda.synchronize()


def free(device):
    """Return this rank's cached blocks: part (b)'s four processes share
    one card."""
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def progress(rank, msg):
    if rank == 0:
        print(f"dist (b) rank 0: {msg}", flush=True)


def dist_planes(seed, planes, rest, device, make):
    """Per-X-plane values from per-plane seeds (so every rank builds the
    planes it holds and rank 0 the whole lattice, identically):
    ``make(gen, rest)`` gives one plane."""
    out = []
    for g in planes:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed * 1_000_003 + int(g))
        out.append(make(gen, rest))
    return torch.stack(out, dim=0)


def dist_links(planes, device):
    """Unitary links U[mu, X, *rest, 3, 3] (Gram-Schmidt of Gaussian
    columns, on the card), complex128, from per-plane seeds."""
    def make(gen, rest):
        shape = (4,) + tuple(rest) + (3, 3)
        a = torch.complex(torch.randn(shape, generator=gen, device=device, dtype=torch.float64),
                          torch.randn(shape, generator=gen, device=device, dtype=torch.float64))
        c0 = a[..., 0]
        c0 = c0 / torch.linalg.vector_norm(c0, dim=-1, keepdim=True)
        c1 = a[..., 1] - (c0.conj() * a[..., 1]).sum(-1, keepdim=True) * c0
        c1 = c1 / torch.linalg.vector_norm(c1, dim=-1, keepdim=True)
        c2 = torch.linalg.cross(c0.conj(), c1.conj())
        return torch.stack([c0, c1, c2], dim=-1)
    return dist_planes(11, planes, DIST_REST, device, make).movedim(0, 1)


def dist_field(planes, cols, device, seed=13):
    """A field [cols, 12, X, *rest] (f32 split complex) from per-plane seeds."""
    def make(gen, rest):
        shape = (2, cols, 12) + tuple(rest)
        return torch.randn(shape, generator=gen, device=device)
    v = dist_planes(seed, planes, DIST_REST, device, make)      # [X, 2, cols, 12, *rest]
    v = v.movedim(0, 3)
    return CArray(v[0].contiguous(), v[1].contiguous())


def dist_scatter(full, rank, world, xl, like, device):
    """Rank 0's ``full`` [*lead, X, *rest] cut into X slabs and sent, one to
    each rank, with one ``all_to_all_single``; returns this rank's slab."""
    import torch.distributed as dist

    shape = list(like.shape)
    n = like.numel()
    send = (torch.cat([full.narrow(2, r * xl, xl).contiguous().reshape(-1)
                       for r in range(world)]) if rank == 0
            else torch.zeros(0, dtype=like.dtype, device=device))
    recv = torch.empty(n, dtype=like.dtype, device=device)
    dist.all_to_all_single(recv, send, [n if i == 0 else 0 for i in range(world)],
                           [n if rank == 0 else 0 for _ in range(world)])
    return recv.reshape(shape)


def dist_child(rank, world, port, out_path, device="cuda", xl=DIST_X_LOCAL,
               cols=DIST_COLS, iters=DIST_ITERS_B, backend="gloo"):
    """One rank of part (b): this rank's X slab of the Wilson lattice
    (links and fields from per-plane seeds), CUDA tensors; gloo with every
    rank on cuda:0, or (``backend="nccl"``, tools/dist_nccl.py) NCCL with
    rank r on cuda:r.  Writes its results as JSON to ``out_path``."""
    import torch.distributed as dist

    from superbblas_tpu_torch import parallel as par, solvers
    from superbblas_tpu_torch.parallel import halo as par_halo

    nccl = backend == "nccl"
    if device == "cuda":
        torch.cuda.set_device(rank if nccl else 0)
    par.initialize_distributed(f"localhost:{port}", world, rank,
                               device="cuda" if nccl else "cpu")     # NCCL or gloo
    mesh = par.make_mesh({"X": world}, device)
    res, t_all = {"rank": rank}, time.perf_counter()
    X = xl * world
    lat = (X,) + DIST_REST
    shape = (cols, 12) + lat
    x0 = rank * xl
    axes = {"x": "X"}

    from torch.distributed.tensor import DTensor, Shard

    from superbblas_tpu_torch.parallel._local import c_strides

    def wrap(c, shp):
        """this rank's X slab of an array sharded on X (axis 2)"""
        return cplx.cmap(lambda a: DTensor.from_local(
            a.contiguous(), mesh, [Shard(2)], run_check=False, shape=shp,
            stride=c_strides(shp)), c)

    # this rank's operator: built on its slab and one plane a side, cropped
    t0 = time.perf_counter()
    planes = [(x0 + i) % X for i in range(-1, xl + 1)]
    op_e = wilson_operator((xl + 2,) + DIST_REST, mass=MASS, links=dist_links(planes, device),
                           layout="soa", device=device)
    oph_e = adjoint_operator(op_e)
    crop = lambda c: cplx.cmap(lambda a: a[:, :, 1:xl + 1].contiguous(), c)  # noqa: E731
    bshape = (9, 9) + lat
    op_s = op_e.replace(blocks=wrap(crop(op_e.blocks), bshape), dim=lat)
    oph_s = oph_e.replace(blocks=wrap(crop(oph_e.blocks), bshape), dim=lat)
    del op_e, oph_e
    b_l = dist_field(range(x0, x0 + xl), cols, device)
    b_s = wrap(b_l, shape)
    sync(device)
    res["setup_s"] = time.perf_counter() - t0

    # 1. the sharded apply against the unsharded apply on the whole lattice
    reset_counts()
    y = par.apply_stencil_soa_sharded(op_s, b_s, mesh, axes)
    sync(device)
    res["k1_apply"] = read_counts()["stencil_matvec_soa"]
    if rank == 0:
        op_g = wilson_operator(lat, mass=MASS, links=dist_links(range(X), device),
                               layout="soa", device=device)
        yg = bsr.apply_stencil_soa(op_g, dist_field(range(X), cols, device))
        del op_g
        free(device)
    else:
        yg = CArray(None, None)
    want = CArray(*(dist_scatter(g, rank, world, xl, y.re.to_local(), device) for g in yg))
    del yg
    yl = cplx.cmap(lambda a: a.to_local(), y)
    res["apply_bits"] = all(torch.equal(a, c) for a, c in zip(yl, want))
    res["apply_rel"] = max(float((a - c).abs().max()) for a, c in zip(yl, want)) / max(
        float(want.re.abs().max()), 1e-30)
    del want, yl
    free(device)
    # the halo exchange alone against the whole apply (one apply = one
    # exchange of the blocks' and the field's edge planes on X)
    ax = {2: "X"}
    w = {2: 1}
    exch, app = [], []
    for _ in range(3):
        sync(device)
        t0 = time.perf_counter()
        par_halo.extend_local([op_s.blocks.re.to_local(), b_l], ax, w, mesh)
        sync(device)
        exch.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        par.apply_stencil_soa_sharded(op_s, b_s, mesh, axes)
        sync(device)
        app.append(time.perf_counter() - t0)
    plane = (op_s.blocks.re.to_local()[:, :, :1].numel() * 2 + b_l.re[:, :, :1].numel() * 2) * 4
    res["halo_bytes_per_apply"] = 2 * plane
    res["exchange_ms"] = 1e3 * statistics.median(exch)
    res["apply_ms"] = 1e3 * statistics.median(app)

    # 2. CA powers: power=2 after one exchange against two applies
    y2 = par.apply_stencil_soa_sharded(op_s, b_s, mesh, axes, power=2)
    yy = par.apply_stencil_soa_sharded(op_s, y, mesh, axes)
    res["power2_rel"] = max(float((a.to_local() - c.to_local()).abs().max())
                            for a, c in zip(y2, yy)) / float(yy.re.to_local().abs().max())
    del y, y2, yy
    free(device)

    # 3. the sharded CG on the normal equations
    def A(v):
        return par.apply_stencil_soa_sharded(
            oph_s, par.apply_stencil_soa_sharded(op_s, v, mesh, axes), mesh, axes)

    hist = []
    sync(device)
    reset_counts()
    t0 = time.perf_counter()
    rhs = par.apply_stencil_soa_sharded(oph_s, b_s, mesh, axes)
    psi, rs, it = solvers.cg(A, rhs, tol=0.0, maxiter=iters, callback=hist.append)
    sync(device)
    res["cg_s"] = time.perf_counter() - t0
    res["k1_cg"] = read_counts()["stencil_matvec_soa"]
    res["cg_hist"] = [float(v) for v in hist]
    del rhs, op_s, oph_s, b_s, b_l
    free(device)
    progress(rank, f"sharded CG {res['cg_s']:.2f} s, K1 {res['k1_cg']}")

    # 4. the checkpoint: 4 blocks, reloaded onto a mesh on Y and whole on rank 0
    path = os.path.join(os.path.dirname(out_path), "dist_psi.s3t")   # the ranks' shared dir
    sync(device)
    t0 = time.perf_counter()
    sto = storage.create_storage_sharded(path, DIST_ORDER, shape, dtype=np.complex64,
                                         checksum=2)
    storage.save_sharded(sto, psi, DIST_ORDER)
    storage.close_storage_sharded(sto)
    res["save_s"] = time.perf_counter() - t0
    res["file_blocks"] = len(storage.open_storage(path, mode="r").blocks)
    mesh_y = par.make_mesh({"Y": world}, device)
    sh_y = par.NamedSharding(mesh_y, dist_spec("Y"))
    t0 = time.perf_counter()
    sto = storage.open_storage(path, mode="r")
    back_y = storage.load_sharded(sto, sh_y)
    back_x = storage.load_sharded(sto, par.NamedSharding(mesh, dist_spec()))
    sync(device)
    res["load_s"] = time.perf_counter() - t0
    res["reload_x_bits"] = all(torch.equal(a.to_local(), c.to_local())
                               for a, c in zip(back_x, psi))
    # psi moved to Y by the plan, against the file's Y shard
    src = par.sharding_partition(psi.re, shape)
    dst_y = par.sharding_partition(back_y.re, shape)
    moved = par.redistribute_auto(psi, src, dst_y, order=DIST_ORDER)
    res["reload_y_bits"] = all(torch.equal(a.to_local(), c.to_local())
                               for a, c in zip(moved, back_y))
    del moved, back_y, back_x
    if rank == 0:
        whole = storage.load(1.0, sto, CArray(torch.empty(shape, device=device),
                                              torch.empty(shape, device=device)),
                             DIST_ORDER)
    else:
        whole = CArray(None, None)
    storage.close_storage(sto)
    mine = CArray(*(dist_scatter(g, rank, world, xl, psi.re.to_local(), device)
                    for g in whole))
    del whole
    res["load_whole_bits"] = all(torch.equal(a, c.to_local()) for a, c in zip(mine, psi))
    del mine
    free(device)
    dist.barrier()
    if rank == 0:
        os.remove(path)
    progress(rank, f"checkpoint save {res['save_s']:.2f} s load {res['load_s']:.2f} s")

    # 5. redistribution of psi to an uneven partition and back, each
    # method and packing, timed; then masked and dtype-converting
    # redistributions of a small field against the host oracle
    from superbblas_tpu_torch.parallel import redistribute as R

    uneven = par.basic_partitioning(DIST_ORDER, shape, (1, 1, 3, 1, 1, 1), nprocs=world)
    st = R.pack_global_device(psi, src)
    nbytes = 2 * psi.re.numel() * 4
    res["redist"] = {}
    for method in ("ragged", "dense"):
        for pack in ("boxes", "runs"):
            os.environ["SBT_REDIST_PACK"] = pack
            flags.clear_cache()
            sync(device)
            t0 = time.perf_counter()
            un = R.redistribute_explicit(st, src, uneven, None, method=method)
            sync(device)
            t_to = time.perf_counter() - t0
            again = R.redistribute_explicit(un, uneven, src, None, method=method)
            ok = all(torch.equal(a.to_local(), c.to_local()) for a, c in zip(again, st))
            res["redist"][f"{method}/{pack}"] = {"s": t_to, "GBps": nbytes / t_to / 1e9,
                                                  "exact": ok}
            del un, again
            free(device)
    os.environ.pop("SBT_REDIST_PACK", None)
    flags.clear_cache()
    del st
    rng = np.random.default_rng(5)
    dim = DIST_REDIST_DIM
    g = rng.standard_normal(dim).astype(np.float32)
    p_src = par.basic_partitioning(DIST_ORDER, dim, (1, 1, world, 1, 1, 1))
    p_dst = par.basic_partitioning(DIST_ORDER, dim, (1, 1, 1, 3, 1, 1), nprocs=world)
    stk = torch.from_numpy(R.pack_global(g, p_src)).to(device)
    mask = rng.random(dim) < 0.6
    variants = {"masked": dict(mask_src=mask, mask_dst=mask),
                "f64": dict(out_dtype=torch.float64, alpha=2.0)}
    res["redist_small"] = {}
    for name, kw in variants.items():
        out = R.redistribute_explicit(stk, p_src, p_dst, None, **kw)
        want = R.pack_global(np.where(mask, g, 0) if name == "masked" else
                             2.0 * g.astype(np.float64), p_dst)[rank]
        got = out.to_local()[0].cpu().numpy()
        res["redist_small"][name] = bool(np.array_equal(got, want)) and got.dtype == want.dtype
    del stk, psi
    free(device)
    progress(rank, "redistributions " + ", ".join(
        f"{k} {v['GBps']:.2f} GB/s" for k, v in res["redist"].items()))

    # 6. the overlap on an AoS stencil without spin factors (K3) against CA powers
    # at power 1 and the unsharded apply; the sharded gather (E1)
    res.update(dist_child_aos(rank, world, mesh, device))
    res.update(dist_child_entry(rank, world, mesh, device))
    res["wall_s"] = time.perf_counter() - t_all
    free(device)
    # 7. rank 0 runs the unsharded CG on the whole lattice for the history
    dist.barrier()
    if rank == 0:
        op_g = wilson_operator(lat, mass=MASS, links=dist_links(range(X), device),
                               layout="soa", device=device)
        oph_g = adjoint_operator(op_g)
        bg = dist_field(range(X), cols, device)
        hist_g = []
        rhs = bsr.apply_stencil_soa(oph_g, bg)
        solvers.cg(lambda v: bsr.apply_stencil_soa(oph_g, bsr.apply_stencil_soa(op_g, v)), rhs,
                   tol=0.0, maxiter=iters, callback=hist_g.append)
        res["cg_hist_unsharded"] = [float(v) for v in hist_g]
        del op_g, oph_g, bg, rhs
        free(device)
    dist.barrier()
    with open(out_path, "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def dist_child_aos(rank, world, mesh, device):
    """Part (b)'s K3 and E1 checks on small lattices: the core/halo
    overlap of an AoS stencil without spin factors (3x3 blocks: its
    batched product J = 27 runs on K3) against ``bsr_krylov_ca`` at power
    1 and the unsharded ``bsr_krylov``; ``apply_gather_sharded`` on an
    open-T Wilson-shaped operator with one more random coupling a row
    within one X plane (mode "gather", 12x12 blocks, J = 120: E1) against
    the unsharded apply.  Every rank builds the (small, replicated)
    operators from the same seeds."""
    from superbblas_tpu_torch import parallel as par

    out = {}
    lat = DIST_AOS_LAT
    gen = torch.Generator(device=device)
    gen.manual_seed(21)
    offs = WILSON_OFFSETS
    vals = _randn_c(lat + (len(offs), 3, 3), gen, dtype=torch.float64)
    op = bsr.bsr_from_stencil("xyzts", "xyzts", lat, {"s": 3}, {"s": 3}, offs, vals,
                              device=device)
    xg = _randn_c(lat + (3, 4), gen, dtype=torch.float64)
    xs = cplx.cmap(lambda a: par.reshard(a, par.NamedSharding(
        mesh, par.PartitionSpec("X", None, None, None, None, None))), xg)
    want = bsr_krylov(1.0, op, xg, "xyztsn")
    reset_counts()
    ov = par.bsr_krylov_overlap(1.0, op, xs, "xyztsn", mesh, {"x": "X"})
    ca = par.bsr_krylov_ca(1.0, op, xs, "xyztsn", mesh, {"x": "X"}, 1)
    sync(device)
    out["k3_overlap"] = read_counts()["batched_small_gemm"]
    sl = slice(rank * lat[0] // world, (rank + 1) * lat[0] // world)
    w = cplx.cmap(lambda a: a[sl], want)
    out["overlap_rel"] = max(float((a.to_local() - c).abs().max()) for a, c in zip(ov, w)) / \
        float(w.re.abs().max())
    out["overlap_vs_ca_rel"] = max(
        float((a.to_local() - c.to_local()[..., 0]).abs().max()) for a, c in zip(ov, ca)) / \
        float(w.re.abs().max())
    # the sharded gather
    glat = DIST_GATHER_LAT
    ii, jj = open_t_lists(glat)
    rng = np.random.default_rng(3)
    coords = _lattice_coords(glat)
    extra = coords.copy()
    extra[..., 0] = (coords[..., 0] + rng.integers(-1, 2, size=glat)) % glat[0]
    for k in range(1, 4):
        extra[..., k] = rng.integers(0, glat[k], size=glat)
    nnz = jj.shape[-2] + 1
    jj2 = np.concatenate([jj, coords[..., None, :]], axis=-2)    # a padded slot more
    np.put_along_axis(jj2, ii[..., None, None], extra[..., None, :], axis=-2)
    ii2 = ii + 1                          # the extra coupling follows the valid slots
    colour = _randn_c(glat + (nnz, 12, 12), gen)
    gop = create_bsr("xyzts", glat + (12,), "xyztc", glat + (12,), (1, 1, 1, 1, 12),
                     (1, 1, 1, 1, 12), ii2, jj2, colour, device=device)
    xg = _randn_c(glat + (12, 4), gen)
    xs = cplx.cmap(lambda a: par.reshard(a, par.NamedSharding(
        mesh, par.PartitionSpec("X", None, None, None, None, None))), xg)
    want = bsr._apply_gather(gop, xg)
    reset_counts()
    gy = par.apply_gather_sharded(gop, xs, mesh, {"x": "X"})
    sync(device)
    out["e1_gather"] = read_counts()["batched_gemm_rowpack"]
    out["gather_mode"] = gop.mode
    sl = slice(rank * glat[0] // world, (rank + 1) * glat[0] // world)
    w = cplx.cmap(lambda a: a[sl], want)
    out["gather_rel"] = max(float((a.to_local() - c).abs().max()) for a, c in zip(gy, w)) / \
        float(w.re.abs().max())
    return out


def dist_child_entry(rank, world, mesh, device):
    """Part (b)'s ordinary entry points on DTensors: ``models.apply_wilson``
    of the SoA Wilson operator (DIST_AOS_LAT x DIST_COLS f32, the operator
    every rank holds whole, cut to the rank's slab) on a field sharded on X
    and on one sharded on its columns, each against the whole-lattice
    apply on the rank (one K1 launch each); ``parallel.copy`` between
    orders of different label sets (a spin component sliced out of a
    field, written into one, and a masked copy) against ``local_copy`` of
    the whole tensors, exactly."""
    from superbblas_tpu_torch import parallel as par
    from superbblas_tpu_torch.ops.copy import local_copy

    out = {}
    lat = DIST_AOS_LAT
    op = wilson_operator(lat, mass=MASS, key=5, layout="soa", device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(31)
    xg = _randn_c((DIST_COLS, 12) + lat, gen)
    want = apply_wilson(op, xg)
    mesh_n = par.make_mesh({"N": world}, device)
    for label, m, spec in (("x", mesh, ("X",)), ("cols", mesh_n, ("N",))):
        pspec = par.PartitionSpec(None, None, "X", None, None, None) if label == "x" else \
            par.PartitionSpec("N", None, None, None, None, None)
        xs = cplx.cmap(lambda a: par.reshard(a, par.NamedSharding(m, pspec)), xg)
        sync(device)
        reset_counts()
        y = apply_wilson(op, xs)
        sync(device)
        out[f"entry_{label}_k1"] = read_counts()["stencil_matvec_soa"]
        if label == "x":
            sl = (slice(None), slice(None), slice(rank * lat[0] // world,
                                                  (rank + 1) * lat[0] // world))
        else:
            sl = (slice(rank * DIST_COLS // world, (rank + 1) * DIST_COLS // world),)
        w = cplx.cmap(lambda a: a[sl], want)
        yl = cplx.cmap(lambda a: a.to_local(), y)
        out[f"entry_{label}_bits"] = all(torch.equal(a, c) for a, c in zip(yl, w))
        out[f"entry_{label}_rel"] = max(float((a - c).abs().max()) for a, c in zip(yl, w)) / \
            float(w.re.abs().max())
        del y, yl, xs
    del want, xg, op
    # parallel.copy across label sets: f "xysn" (a spin axis), g "xyn" (none)
    X = 4 * world
    f = torch.randn((X, 8, 4, 6), generator=gen, device=device)
    g = torch.randn((X, 8, 6), generator=gen, device=device)
    fs = par.reshard(f, par.NamedSharding(mesh, par.PartitionSpec("X", None, None, None)))
    gs = par.reshard(g, par.NamedSharding(mesh, par.PartitionSpec("X", None, None)))
    rng = np.random.default_rng(7)
    m0 = rng.random((X, 8, 4, 6)) < 0.5
    m1 = np.zeros((X, 8, 6), bool)
    m1.reshape(-1)[rng.permutation(m1.size)[:int(m0[:, :, 1:2].sum())]] = True
    cases = {
        "slice": (1.0, fs, "xysn", gs, "xyn", dict(from0=(0, 0, 2, 0), size0=(X, 8, 1, 6))),
        "insert": (-1.0, gs, "xyn", fs, "xysn", dict(from1=(0, 0, 1, 0))),
        "masked": (1.0, fs, "xysn", gs, "xyn", dict(from0=(0, 0, 1, 0), size0=(X, 8, 1, 6),
                                                   mask0=m0, mask1=m1)),
    }
    plain = {"xysn": f, "xyn": g}
    sl = slice(rank * X // world, (rank + 1) * X // world)
    for name, (alpha, xa, o0, ya, o1, kw) in cases.items():
        got = par.copy(alpha, xa, o0, ya, o1, **kw)
        w = local_copy(alpha, plain[o0], o0, plain[o1], o1, **kw)
        out[f"copy_{name}_bits"] = torch.equal(got.to_local(), w[sl])
    return out


def dist_part_b(device="cuda"):
    """Part (b): DIST_RANKS processes of this script on one card, gloo
    with CUDA tensors on cuda:0 (NCCL refuses two ranks on one GPU:
    "Duplicate GPU detected").  Returns the ranks' results and the wall."""
    import socket

    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    tmp = tempfile.mkdtemp(prefix="sbt_dist_b_")
    t0 = time.perf_counter()
    env = {k: v for k, v in os.environ.items()
           if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
    procs = []
    try:
        for r in range(DIST_RANKS):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dist-rank", str(r),
                 "--dist-port", str(port), "--dist-out", os.path.join(tmp, f"rank{r}.json"),
                 "--dist-device", device],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = []
        for p in procs:
            out, _ = p.communicate(timeout=DIST_TIMEOUT)
            logs.append(out)
        failed = [(r, p.returncode, out) for r, (p, out) in enumerate(zip(procs, logs))
                  if p.returncode != 0]
        if failed:
            raise AssertionError("dist (b): ranks failed: " + "\n".join(
                f"rank {r} exit {rc}:\n{out[-2500:]}" for r, rc, out in failed))
        res = [json.load(open(os.path.join(tmp, f"rank{r}.json")))
               for r in range(DIST_RANKS)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    return res, time.perf_counter() - t0


#: part (b)'s time limit (its ranks are killed past it)
DIST_TIMEOUT = 600


def dist_report_b(res, wall, backend="gloo"):
    """Print part (b)'s checks and fail on any."""
    r0 = res[0]
    hist, hist_g = r0["cg_hist"], r0["cg_hist_unsharded"]
    hist_rel = max(abs(a - c) / abs(c) for a, c in zip(hist, hist_g))
    lat = (DIST_X_LOCAL * DIST_RANKS,) + DIST_REST
    where = (f"NCCL, {DIST_RANKS} ranks on {DIST_RANKS} cards" if backend == "nccl" else
             f"gloo, {DIST_RANKS} ranks on one card (CUDA tensors on cuda:0; times are gloo "
             "on one card, not NCCL and not multi-GPU)")
    print(f"dist (b) {where}, mesh X={DIST_RANKS}, "
          f"lattice {lat} x {DIST_COLS} f32 (each rank 16x32x32x64 + one halo plane a side; "
          f"reduced from 32 a rank), wall {wall:.1f} s", flush=True)
    for r in res:
        print(f"dist (b) rank {r['rank']}: sharded apply vs the unsharded port apply on the "
              f"whole lattice: bit for bit {r['apply_bits']} (max rel {r['apply_rel']:.3e}); "
              f"K1 launches: apply {r['k1_apply']}, CG {r['k1_cg']} (expected "
              f"{2 * DIST_ITERS_B + 1}); halo {r['halo_bytes_per_apply'] / 1e6:.1f} MB an apply,"
              f" exchange {r['exchange_ms']:.2f} ms against the apply {r['apply_ms']:.2f} ms; "
              f"power 2 vs two applies max rel {r['power2_rel']:.3e}; CG {DIST_ITERS_B} its "
              f"{r['cg_s']:.3f} s; checkpoint {r['file_blocks']} blocks save "
              f"{r['save_s']:.3f} s load {r['load_s']:.3f} s, reload on X {r['reload_x_bits']}"
              f", on Y {r['reload_y_bits']}, whole on rank 0 {r['load_whole_bits']}; "
              f"overlap (K3 {r['k3_overlap']}) rel {r['overlap_rel']:.3e} vs CA power 1 "
              f"{r['overlap_vs_ca_rel']:.3e}; gather (mode {r['gather_mode']}, E1 "
              f"{r['e1_gather']}) rel {r['gather_rel']:.3e}; redistribution "
              + ", ".join(f"{k} {v['GBps']:.3f} GB/s exact {v['exact']}"
                          for k, v in r["redist"].items())
              + f"; masked {r['redist_small']['masked']}, f32->f64 {r['redist_small']['f64']};"
              f" rank wall {r['wall_s']:.1f} s", flush=True)
    print(f"dist (b) CG residual history: sharded {hist[0]:.6e} .. {hist[-1]:.6e}, "
          f"unsharded {hist_g[0]:.6e} .. {hist_g[-1]:.6e}, max rel diff {hist_rel:.3e} "
          f"(<= 1e-5)", flush=True)
    for r in res:
        print(f"dist (b) rank {r['rank']}: apply_wilson (the ordinary entry point) on "
              f"DTensors {DIST_AOS_LAT} x {DIST_COLS} against the whole-lattice apply: "
              f"sharded on X bit for bit {r['entry_x_bits']} (max rel {r['entry_x_rel']:.3e}, "
              f"K1 {r['entry_x_k1']}), on its columns bit for bit {r['entry_cols_bits']} "
              f"(max rel {r['entry_cols_rel']:.3e}, K1 {r['entry_cols_k1']}); parallel.copy "
              f"across label sets exact: slice {r['copy_slice_bits']}, insert "
              f"{r['copy_insert_bits']}, masked {r['copy_masked_bits']}", flush=True)
    bad = [r["rank"] for r in res if not (
        (r["entry_x_bits"] or r["entry_x_rel"] <= 1e-6) and r["entry_x_k1"] == 1
        and (r["entry_cols_bits"] or r["entry_cols_rel"] <= 1e-6) and r["entry_cols_k1"] == 1
        and r["copy_slice_bits"] and r["copy_insert_bits"] and r["copy_masked_bits"]
        and (r["apply_bits"] or r["apply_rel"] <= 1e-6) and r["k1_apply"] == 1
        and r["k1_cg"] == 2 * DIST_ITERS_B + 1 and r["power2_rel"] <= 1e-6
        and r["file_blocks"] == DIST_RANKS and r["reload_x_bits"] and r["reload_y_bits"]
        and r["load_whole_bits"] and r["k3_overlap"] > 0 and r["overlap_rel"] <= 1e-12
        and r["overlap_vs_ca_rel"] <= 1e-12 and r["gather_mode"] == "gather"
        and r["e1_gather"] > 0 and r["gather_rel"] <= 1e-5
        and all(v["exact"] for v in r["redist"].values())
        and all(r["redist_small"].values()))]
    if bad or hist_rel > 1e-5:
        raise AssertionError(f"dist (b): checks failed on ranks {bad} (history {hist_rel:.3e})")


def kernel_library() -> None:
    """Build (where ``csrc/`` changed) and load the kernels' library, and
    say which it did."""
    t0 = time.perf_counter()
    builds = tracker.counters().get("kernels.builds", 0)
    _cuda.library()
    nvcc = ("already built" if tracker.counters().get("kernels.builds", 0) == builds
            else "built with nvcc")
    print(f"kernel library {_cuda.BUILD}: {nvcc}, build and load "
          f"{time.perf_counter() - t0:.2f} s", flush=True)


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", action="store_true",
                        help="also profile one warm solve, one warm even-odd solve, one "
                             "warm dense path, one warm coarse CG, one warm MG-FGCR solve "
                             "and one warm clover and Moebius CGNE with torch.profiler")
    parser.add_argument("--dist-rank", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--dist-port", type=int, help=argparse.SUPPRESS)
    parser.add_argument("--dist-out", help=argparse.SUPPRESS)
    parser.add_argument("--dist-device", default="cuda", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.dist_rank is not None:      # one rank of the dist phase's part (b)
        dist_child(args.dist_rank, DIST_RANKS, args.dist_port, args.dist_out,
                   device=args.dist_device)
        return
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

    kernel_library()
    rate = copy_rate()
    print(f"device-to-device copy {rate / 1e12:.3f} TB/s measured (1 GiB, read and write "
          f"counted); the bounds take the data sheet's {HBM_BYTES_PER_S / 1e12:.2f} TB/s",
          flush=True)
    sched_attrs = schedule_attr_table()
    attrs = {f"tiled K1 {k}": v for k, v in tiled_attrs().items()} | kernel_attrs() | {
        f"schedule {k}": v for k, v in sched_attrs.items()}
    for key, (regs, local, threads, blocks) in attrs.items():
        print(f"{key}: {regs} registers, {local} B local (spills), {threads} "
              f"threads a block, {blocks} blocks an SM", flush=True)

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
    bench = bench_shape(gen)
    k1_shapes, moebius_cols_err = k1_shape_path(gen)
    aos_launches, aos_err = families_aos_check(gen)
    dc_launches, dc_err = default_call_path(gen)
    clover = clover_path(gen, args.profile)
    dense_walls = dense_solve_path(clover[4], rate)
    clover = clover[:4]
    moebius = moebius_path(gen, args.profile)
    moebius = (moebius[0], max(moebius[1], moebius_cols_err)) + moebius[2:]
    op, b, links = main_operator(gen)
    launches, err = wilson_path(op, b, args.profile)
    if launches == 0:
        raise AssertionError("the Wilson path launched no stencil kernel")
    utilities = tracker_aot_path(op, b, gen)
    probe_exports = probe_export_path(gen)
    dist_a_launches, dist_a_walls = dist_part_a(op, b)
    s_launches, s_err, ms = schedule_path(op, b)
    eo_launches, eo_err, eo_ms, eo_bound, eo_psi = eo_path(op, b, args.profile)
    if eo_launches == 0:
        raise AssertionError("the even-odd path launched no packed stencil kernel")
    ckpt_walls = checkpoint_path(op, b, eo_psi)
    aos_eo = aos_eo_path(op, b, eo_psi, links, gen)
    del eo_psi
    k1_bound = stencil_bound(op.blocks, op.kron, b, op.offsets, 3, 3)
    del op
    p2 = p2_path(links, b, gen)
    tm_launches = twisted_mass_path(links, b)
    del b
    staggered = staggered_path(links, gen)
    stag_eo = aos_staggered_eo_path(links, gen)
    del links
    if min(clover[0], moebius[0], staggered[0], tm_launches) == 0:
        raise AssertionError("a family's path launched no stencil kernel")
    p_err = permute_checks(gen)
    p_launches, d_err = dense_path(gen, args.profile)
    if p_launches == 0:
        raise AssertionError("the dense path launched no permute kernel")
    p_ms, (p_bound_ms, p_bound_by), p_route = time_permute(gen)
    gather = gather_path(gen)
    e2 = e2_path(gen, rate)
    e3, e3_k2_ms, e3_call_ms, e3_bound = e3_path(gen)
    torch.cuda.empty_cache()
    dist_b, dist_b_wall = dist_part_b()
    dist_report_b(dist_b, dist_b_wall)
    print(f"dist walls: (a) {dist_a_walls['all']:.1f} s, (b) {dist_b_wall:.1f} s", flush=True)

    print(f"walls: AoS packed eo solve {aos_eo['packed'][0]:.3f} s ({aos_eo['packed'][1]:.2f} "
          f"GiB), masked eo solve {MASKED_EO_LAT} {aos_eo['masked'][0]:.3f} s "
          f"({aos_eo['masked'][1]:.2f} GiB), AoS staggered packed eo solve {stag_eo[1]:.3f} s "
          f"({stag_eo[2]:.2f} GiB); gather applies " + ", ".join(
              f"({c}) {g[2]['kernel']:.4f} ms" for c, g in gather.items()), flush=True)
    print(f"chip_smoke.py wall {time.perf_counter() - t_start:.1f} s, the build included",
          flush=True)
    # K1's rows: bound_ms against the operations of the spin plan,
    # bound_ref_ms against the reference's FLOP model (PR 1-6's bound)
    stencil = {"route": "cuda", "library_ms": None,
               "replaces": "superbblas_tpu/ops/stencil_pallas.py:368"}
    tiled_src = {"source": "superbblas_tpu_torch/csrc/stencil_tiled.cu"}
    def rt_src(shape):
        """the runtime-shape route's source, its registers and blocks an SM
        at f32 and its tile (S, C, R, G, D, stages) at the timed shape"""
        regs, _, _, per_sm = attrs[f"K1 runtime {','.join(map(str, shape))} float32/float32"]
        return {"source": "superbblas_tpu_torch/csrc/stencil_rt.cu", "registers": regs,
                "blocks_per_sm": per_sm,
                "launches_export": probe_exports["stencil_matvec_soa_rt"],
                "tile": stencil_ops.rt_tile(*shape, K1_TIME_COLS, 9, 4, 4)}
    # the clover term: the block-streaming kernel, its launches in the solve
    # by form, and torch.einsum beside it
    site_src = {"source": "superbblas_tpu_torch/csrc/stencil_site.cu",
                "launches_by_form": {"site16": clover[0]}, "library_ms": clover[2]["library"],
                "ms_16x16x16x32": k1_shapes[CLOVER_SHAPE][2]["kernel"],
                "library_ms_16x16x16x32": k1_shapes[CLOVER_SHAPE][2]["library"],
                "bound_ms_16x16x16x32": k1_shapes[CLOVER_SHAPE][3][0]}
    print(json.dumps({"kernels": [{
        "name": "stencil_matvec_soa", **stencil, **tiled_src,
        "launches": launches, "max_abs_err": err, "ms": ms["k1"], "plain_ms": ms["plain"],
        "bound_ms": k1_bound[0], "bound_by": k1_bound[1], "bound_ref_ms": k1_bound[2],
        "plan_builds": PLANS_BUILT["main"],
        "launches_dist": {"a_nccl_1_rank": dist_a_launches["solvers_cg"],
                          "a_cg_solve_dtensor": dist_a_launches["cg_solve_dtensor"],
                          "a_eo_solve_packed_soa_dtensor": dist_a_launches["eo_dtensor"],
                          "b_gloo_per_rank": [r["k1_cg"] for r in dist_b],
                          "b_apply_wilson_dtensor_per_rank": [
                              r["entry_x_k1"] + r["entry_cols_k1"] for r in dist_b]},
        "walls_dist_a_s": {k: v for k, v in dist_a_walls.items()}}] + [{
        "name": f"stencil_matvec_soa[{pair}]", **stencil, **tiled_src,
        "launches": n_launch, "max_abs_err": e, "ms": t["kernel"], "plain_ms": t["plain"],
        "bound_ms": bd_[0], "bound_by": bd_[1], "bound_ref_ms": bd_[2]}
        for pair, (n_launch, e, t, bd_) in p2.items()] + [{
        "name": "stencil_matvec_soa[packed_parity]", **stencil, **tiled_src,
        "launches": eo_launches, "max_abs_err": eo_err, "ms": eo_ms["H_eo"][0],
        "plain_ms": eo_ms["H_eo"][1], "bound_ms": eo_bound[0], "bound_by": eo_bound[1],
        "bound_ref_ms": eo_bound[2], "plan_builds": PLANS_BUILT["eo"]}] + [{
        "name": f"stencil_matvec_soa[bench 8x8x16x128 {label}]", **stencil, **tiled_src,
        "launches": n_launch, "max_abs_err": e, "ms": t["k1"], "plain_ms": t["plain"],
        "bound_ms": bd_[0], "bound_by": bd_[1], "bound_ref_ms": bd_[2], "plan_builds": pb}
        for label, (n_launch, e, t, bd_, pb) in bench.items()] + [{
        "name": name, **stencil, **src,
        "launches": n_launch, "max_abs_err": e, "ms": t["kernel"], "plain_ms": t["plain"],
        "bound_ms": bd_[0], "bound_by": bd_[1], "bound_ref_ms": bd_[2],
        **({"plan_builds": PLANS_BUILT[path]} if path else {})}
        for name, src, path, (n_launch, e, t, bd_) in (
            ("stencil_matvec_soa[1,1,12,12 clover term]", site_src, None, clover),
            ("stencil_matvec_soa[4,4,3,3 Moebius, 64 columns]", tiled_src, "moebius",
             moebius),
            ("stencil_matvec_soa[1,1,3,3 staggered]", tiled_src, "staggered", staggered[:4]),
            *((f"stencil_matvec_soa_rt[{','.join(map(str, shape))}]", rt_src(shape), None,
               k1_shapes[shape]) for shape in K1_RT_SHAPES))] + [{
        "name": fn.__name__, **stencil,
        "source": "superbblas_tpu_torch/csrc/stencil_schedules.cu",
        "replaces": f"superbblas_tpu/ops/stencil_pallas.py:{line}",
        "launches": s_launches[name], "max_abs_err": s_err[name], "ms": ms[name],
        "plain_ms": ms["plain"], "bound_ms": k1_bound[0], "bound_by": k1_bound[1],
        "bound_ref_ms": k1_bound[2],
        "registers": sched_attrs[f"{name} 4,4,3,3 sparse float32/float32"][0],
        "blocks_per_sm": sched_attrs[f"{name} 4,4,3,3 sparse float32/float32"][3],
        "ms_staggered": staggered[4][name], "k1_ms_staggered": staggered[4]["k1"],
        "bound_ms_staggered": staggered[3][0],
        "launches_export": probe_exports[fn.__name__]}
        for (name, fn), line in zip(SCHEDULES.items(), (649, 795))] + [{
        "name": "permute_4d", "route": "cuda",
        "source": "superbblas_tpu_torch/csrc/permute.cu",
        "replaces": "superbblas_tpu/ops/permute_pallas.py:66",
        "launches": p_launches, "max_abs_err": max(p_err, d_err),
        "ms": p_ms["tzyx"][0], "plain_ms": p_ms["tzyx"][1],
        "bound_ms": p_bound_ms, "bound_by": p_bound_by,
        "library_ms": p_ms["tzyx"][1], "form": p_route, "ms_tyzx": p_ms["tyzx"][0]}] + [{
        "name": fn.__name__, "route": "cuda",
        "source": "superbblas_tpu_torch/csrc/batched_gemm.cu", "replaces": replaces,
        "launches": launches, "max_abs_err": err, "ms": times["kernel"],
        "plain_ms": times["plain"], "bound_ms": bd[0], "bound_by": bd[1],
        "library_ms": times["bmm"], "device_ms": times["kernel_device"],
        "plain_device_ms": times["plain_device"], "library_device_ms": times["bmm_device"],
        "launches_dist_b_gloo_per_rank": dist_l}
        for fn, replaces, dist_l, launches, err, (times, bd) in (
            (batched_small_gemm, "superbblas_tpu/ops/batched_gemm_pallas.py:99",
             [r["k3_overlap"] for r in dist_b],
             vc_launches["batched_small_gemm"] + aos_launches["k3"] + stag_eo[0]
             + gather["c"][0]["k3"],
             max(gemm_err["k3"], vc_err["k3"], aos_err), gemm_ms["k3", K3_TIME_SHAPE]),
            (batched_gemm_rowpack, "experiments/bgemm_rowpack_probe.py:32",
             [r["e1_gather"] for r in dist_b],
             c_launches + vc_launches["batched_gemm_rowpack"] + aos_launches["e1"]
             + dc_launches + gather["a"][0]["e1"] + gather["b"][0]["e1"],
             max(gemm_err["e1"], c_err, vc_err["e1"], aos_err, dc_err),
             gemm_ms["e1", E1_TIME_SHAPE]))] + [{
        "name": f"roll_add[{v} {f}]", "route": "cuda", "form": f,
        "source": "superbblas_tpu_torch/csrc/roll_add.cu",
        "replaces": "experiments/stencil_bf16_roll_probe.py:88",
        "launches": launches, "max_abs_err": err, "shape": list(shape),
        "ms": t[shape]["kernel"], "plain_ms": t[shape]["plain"],
        "device_ms": t[shape]["kernel_device"], "plain_device_ms": t[shape]["plain_device"],
        "bound_ms": bd_[shape][0], "bound_by": bd_[shape][1], "library_ms": None,
        "launches_export": probe_exports[f"roll_add[{v}]"]}
        for (v, f), (launches, err, t, bd_) in e2.items()
        for shape in (E2_SHAPES[1] if f == "vec16" else E2_FORM_SHAPES[f],)] + [{
        "name": f"permute_4d_tiled[{','.join(map(str, tile))}]", "route": "cuda",
        "source": "superbblas_tpu_torch/csrc/permute.cu",
        "replaces": "experiments/permute_pallas.py:45", "form": tile[0],
        "launches": e3[tile][0], "max_abs_err": e3[tile][1], "ms": e3[tile][2],
        "plain_ms": e3_call_ms, "bound_ms": e3_bound[0], "bound_by": e3_bound[1],
        "library_ms": e3_call_ms, "device_ms": e3[tile][3], "k2_ms": e3_k2_ms[0],
        "k2_device_ms": e3_k2_ms[1],
        "launches_export": probe_exports["permute_4d_tiled"] if tile == TILES[0] else 0}
        for tile in TILES]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
