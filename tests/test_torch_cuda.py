"""The CUDA kernels on the card: the cases each refuses; the stencil
kernel with packed parity, its tiled route at the Wilson and staggered
shapes with factored (Wilson projector) and direct (random) spin factors
at every type pair, its registers and spills, its plan built once per
operator, on both its other routes at every new block shape, and its
X-inside and X-streaming schedules at every pair and shape against the
plain version and K1 bit for bit (the tiled route at its shapes, the
runtime-shape route elsewhere), with their registers and blocks an SM
(and the tiled route where no direction factors against the
runtime-shape route, bit for bit); the runtime-shape route at 65536
columns, with its registers and blocks an SM; the bf16 roll-plus-add (E2)
in both variants and the transpose tile sweep (E3) at each design point,
with its refusals; every operator family's apply on
the card, in both layouts, against the same apply on the CPU; the CG and even-odd solves through the stencil kernel against the
same solves on the CPU; K1's block-streaming kernel at the clover term's
shape (both forms, every f32-summed pair) against the plain version and
the runtime-shape route; the permute kernel against its plain version,
alone and inside ``local_copy``, on both its routes; the batched-GEMM kernels K3 and E1
against their plain version and a float64 product, and ``apply_coarse``
on the card against the CPU port; K1 past 524,280 columns and K3/E1 past
65535 tiles on grid.y and grid.z (fault P6); E2's forms (vec16, pair,
elem); the gather applies of ``create_bsr``/``create_kron_bsr`` on E1 and
K3, and the AoS staggered packed solve on K3; a CUDA-graph replay of a
Wilson CG iteration (``aot.aot_compile``) against the eager call, the
exported Wilson apply launching K1, exported programs reaching K2, K3 and
E1 launching them, the dense ops and a storage round
trip of a CUDA CArray; the distributed layer on a world-size-1 NCCL group
(the sharded apply, the redistribution in both methods, the sharded
checkpoint) and on two gloo ranks sharing the card (the halo exchange and
one sharded apply against the unsharded K1 apply); CG's fused updates
(``ops/cg_update.py``) against their plain version at the benchmark's
plane sizes, with a tail and on a 4-byte offset view, their reductions
bit for bit twice, and a clover CGNE at 16^3x32 on them; the domain-wall
s5 pass (``ops/dw_s5.py``) against its plain version bit for bit, every
pass in both forms in f32 and f64 and on strided fields, and a Moebius
CGNE on it in both.  The kernels at
the main path's shapes are checked by ``chip_smoke.py``.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import ctypes

import numpy as np
import pytest
import torch

from superbblas_tpu_torch import local_copy, solvers
from superbblas_tpu_torch.cplx import CArray
from superbblas_tpu_torch import models as M
from superbblas_tpu_torch.models import coarse as C
from superbblas_tpu_torch.models import eo_packed as E
from superbblas_tpu_torch.models import wilson as W
from superbblas_tpu_torch.ops import batched_gemm as G
from superbblas_tpu_torch.ops import cg_update as U
from superbblas_tpu_torch.ops import dw_s5 as D5
from superbblas_tpu_torch.ops import permute as P
from superbblas_tpu_torch.ops import roll_add as R
from superbblas_tpu_torch.ops import stencil as S

OFFSETS = W.wilson_offsets(4)
WRAPPERS = {"k1": S.stencil_matvec_soa, "xin": S.stencil_matvec_soa_xin,
            "stream": S.stencil_matvec_soa_stream}
DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
          (torch.bfloat16, torch.bfloat16)]
#: max |kernel - plain| allowed, relative to max |plain|: f32 rounding for
#: f32 fields, one bf16 ulp (2^-7) for bf16 fields
TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def crand(shape, seed, device, dtype):
    rng = np.random.default_rng(seed)
    return CArray(*(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                    .to(device=device, dtype=dtype) for _ in range(2)))


@pytest.mark.cuda
def test_kernel_raises_on_what_it_does_not_take(cuda_device):
    """K1 and the X-inside and X-streaming schedules launch f64 operands
    and a (2, 2, 3, 3) one (the runtime-shape form), K1 every shape up to
    KI*KD*BI*BD = 256 (4x4 blocks on its runtime-shape route here); all
    raise above it; a parity other than 0 and 1 is refused."""
    lat = (2, 2, 4, 8)
    blocks = crand((9, 9) + lat, 0, cuda_device, torch.float32)
    x = crand((1, 3) + lat, 1, cuda_device, torch.float32)
    b16 = crand((9, 16) + lat, 2, cuda_device, torch.float32)
    x16 = crand((1, 4) + lat, 3, cuda_device, torch.float32)
    k22 = crand((9, 2, 2), 6, cuda_device, torch.float32)
    x6 = crand((1, 6) + lat, 7, cuda_device, torch.float32)
    b64, x64 = blocks.to(torch.float64), x.to(torch.float64)
    for fn in (S.stencil_matvec_soa, S.stencil_matvec_soa_rt):
        before = fn.launches
        assert fn(b64, None, x64, OFFSETS, 3, 3).re.dtype == torch.float64
        assert fn.launches == before + 1
    for fn in (S.stencil_matvec_soa_xin, S.stencil_matvec_soa_stream):
        before = fn.launches
        assert fn(b64, None, x64, OFFSETS, 3, 3).re.dtype == torch.float64
        assert tuple(fn(blocks, k22, x6, OFFSETS, 3, 3).re.shape) == (1, 6) + lat
        assert fn.launches == before + 2
    before = S.stencil_matvec_soa_rt.launches
    S.stencil_matvec_soa(b16, None, x16, OFFSETS, 4, 4)
    assert S.stencil_matvec_soa_rt.launches == before + 1
    b289 = crand((9, 289) + lat, 4, cuda_device, torch.float32)
    x17 = crand((1, 17) + lat, 5, cuda_device, torch.float32)
    for fn in (S.stencil_matvec_soa, S.stencil_matvec_soa_rt, S.stencil_matvec_soa_xin,
               S.stencil_matvec_soa_stream):
        with pytest.raises(ValueError, match="256"):
            fn(b289, None, x17, OFFSETS, 17, 17)
    with pytest.raises(ValueError, match="parity"):
        S.stencil_matvec_soa(blocks, None, x, OFFSETS, 3, 3, packed_parity=2)


def _close(got, want, label):
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.float().abs().max()) for w in want)
    assert got.re.dtype == want.re.dtype and got.re.shape == want.re.shape, label
    assert err <= TOL[got.re.dtype] * scale, (label, err, scale)


def _operands(lat, n, kron, st, ft, seed, ndir=9):
    blocks = crand((ndir, 9) + lat, seed, "cuda", st)
    k = crand((ndir, 4, 4), seed + 1, "cuda", torch.float32) if kron else None
    x = crand((n, 12 if kron else 3) + lat, seed + 2, "cuda", ft)
    return blocks, k, x


@pytest.mark.cuda
@pytest.mark.parametrize("st,ft", DTYPES)
@pytest.mark.parametrize("parity", [0, 1])
def test_packed_kernel_matches_plain_version(cuda_device, parity, st, ft):
    """The packed X shift on ragged half lattices (X/2 of 1, 2 and 3; odd
    Y, Z and T), 1-3 columns, the 8 hopping directions, with and without
    spin factors."""
    before = S.stencil_matvec_soa.launches
    cases = [((1, 3, 2, 5), 1), ((2, 4, 3, 8), 2), ((3, 5, 4, 7), 3)]
    for i, (half, n) in enumerate(cases):
        for kron in (True, False):
            blocks, k, x = _operands(half, n, kron, st, ft, 10 * i, ndir=8)
            args = (blocks, k, x, OFFSETS[1:], 3, 3)
            _close(S.stencil_matvec_soa(*args, packed_parity=parity),
                   S.stencil_matvec_soa_reference(*args, packed_parity=parity),
                   f"packed {half} n={n} kron={kron}")
    assert S.stencil_matvec_soa.launches == before + 2 * len(cases)


#: the schedules' cases: (KI, KD, BI, BD), kind of kron ("wilson": the
#: Wilson projectors, the sparse plan; "random": direct, the dense plan or
#: the runtime-shape form; None: no kron); lattices with odd volumes and X
#: of 1-4, columns 1 to 9
SCHEDULE_SHAPES = [((4, 4, 3, 3), "wilson"), ((4, 4, 3, 3), "random"), ((1, 1, 3, 3), None),
                   ((1, 1, 12, 12), None), ((2, 2, 3, 3), "random"), ((1, 1, 2, 2), None),
                   ((2, 1, 4, 2), "random"), ((2, 2, 8, 8), "random"), ((1, 1, 16, 16), None)]
SCHEDULE_LATS = [((1, 3, 2, 5), 1), ((3, 5, 6, 10), 9), ((2, 4, 3, 8), 2), ((4, 4, 8, 32), 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("st,ft", S.KERNEL_DTYPES)
@pytest.mark.parametrize("schedule", ["xin", "stream"])
def test_schedules_match_plain_version_and_kernel(cuda_device, schedule, st, ft):
    """K4a and K4b at every pair, at the shapes of TILED_SHAPES (Wilson and
    random spin factors, no kron), SITE_SHAPE and the runtime-shape route's,
    against the plain version (f64 within 1e-12 of max |y|) and against K1
    bit for bit: its tiled route at TILED_SHAPES (the same spin plan code),
    its runtime-shape route elsewhere (the same per-output sum); X-streaming
    also with a given ``nc``."""
    wrapper = WRAPPERS[schedule]
    before = wrapper.launches
    kdt = torch.float64 if ft == torch.float64 else torch.float32
    calls = 0
    for i, ((ki, kd, bi, bd), kind) in enumerate(SCHEDULE_SHAPES):
        for j, (lat, n) in enumerate(SCHEDULE_LATS):
            blocks = crand((9, bi * bd) + lat, 100 * i + j, "cuda", st)
            kron = None if kind is None else (
                _spin_factors("wilson", 9, kdt) if kind == "wilson"
                else crand((9, ki, kd), 7, "cuda", kdt))
            x = crand((n, kd * bd) + lat, 100 * i + j + 50, "cuda", ft)
            args = (blocks, kron, x, OFFSETS, bi, bd)
            label = f"{schedule} {(ki, kd, bi, bd)} {kind} {lat} n={n}"
            got = wrapper(*args)
            calls += 1
            want = S.stencil_matvec_soa_reference(*args)
            assert got.re.dtype == ft and got.re.shape == want.re.shape, label
            err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
            scale = max(float(w.double().abs().max()) for w in want)
            assert err <= PLAN_TOL[ft] * scale, (label, err, scale)
            k1 = S.stencil_matvec_soa(*args) if (ki, kd, bi, bd) in S.TILED_SHAPES \
                else S.stencil_matvec_soa_rt(*args)
            assert all(torch.equal(g, w) for g, w in zip(got, k1)), label
            if schedule == "stream" and n > 1:
                got = wrapper(*args, nc=1)
                calls += 1
                assert all(torch.equal(g, w) for g, w in zip(got, k1)), (label, "nc=1")
    assert wrapper.launches == before + calls


@pytest.mark.cuda
@pytest.mark.parametrize("st,ft", [(torch.float32, torch.float32),
                                   (torch.bfloat16, torch.bfloat16),
                                   (torch.float64, torch.float64)])
def test_schedules_registers_and_blocks(cuda_device, st, ft):
    """The schedules' kernels at 32^3x64 x 8 (cudaFuncGetAttributes and the
    occupancy at their tiles' shared memory): at the f32-summed pairs no
    spill, the X-inside kernel at 16 warps an SM or more (one block of 512
    threads) and the X-streaming one at two blocks or more (four of 128
    threads at 120 registers, three for the dense plan's 164); at f64 at
    least one block an SM."""
    lat = (32, 32, 32, 64)
    for shape, sparse in (((4, 4, 3, 3), True), ((4, 4, 3, 3), False), ((1, 1, 3, 3), False),
                          ((2, 2, 3, 3), False)):
        for schedule in ("xin", "stream"):
            regs, local, threads, blocks = S.schedule_attrs(schedule, shape, st, ft, 8, lat,
                                                           sparse)
            label = (schedule, shape, sparse, regs, local, threads, blocks)
            if ft == torch.float64:
                assert regs <= 255 and blocks >= 1, label
            elif schedule == "xin":
                assert local == 0 and threads * blocks >= 512, label
            else:
                assert local == 0 and blocks >= 2, label


#: every (storage, field) pair of K1, and the relative tolerance against
#: the plain version: f32 rounding, one bf16 ulp (2^-7) for bf16 fields,
#: f64 rounding of sums of a few hundred products
ALL_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
             (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16),
             (torch.float64, torch.float64)]
PLAN_TOL = {torch.float32: 1e-5, torch.bfloat16: 8e-3, torch.float64: 1e-12}
#: ragged lattices (X of 1-3, T of 5-10), columns and parities of the
#: tiled route's tests
TILED_CASES = (((3, 5, 6, 10), 3, None), ((1, 3, 2, 5), 9, None), ((2, 4, 3, 8), 2, 0),
               ((3, 5, 4, 7), 1, 1), ((2, 2, 3, 9), 5, 1))


def _spin_factors(kind, ndir, dtype):
    """Wilson's (r = 1: every hop factored) or random (every direction
    direct) spin factors, the centre dropped for 8 directions."""
    if kind == "random":
        return crand((ndir, 4, 4), 7, "cuda", dtype)
    kron = W.wilson_operator((2, 2, 2, 2), layout="soa", device="cpu",
                             dtype=torch.complex128).kron
    keep = slice(9 - ndir, 9)
    return CArray(kron.re[keep].to("cuda", dtype), kron.im[keep].to("cuda", dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("st,ft", ALL_PAIRS)
@pytest.mark.parametrize("kind", ["wilson", "random"])
def test_tiled_k1_matches_plain_version(cuda_device, kind, st, ft):
    """K1's tiled route at (4, 4, 3, 3) with Wilson projector factors (the
    sparse form of the plan, rank-2 projection) and random ones (direct,
    dense form), and at (1, 1, 3, 3) with no kron, on ragged lattices and
    both packed parities, against the plain version; where no direction
    factors, bit for bit against the runtime-shape route."""
    before = S.stencil_matvec_soa.by_shape.copy()
    kdt = torch.float64 if ft == torch.float64 else torch.float32
    for i, (lat, n, parity) in enumerate(TILED_CASES):
        offsets = OFFSETS if parity is None else OFFSETS[1:]
        kron = _spin_factors(kind, len(offsets), kdt)
        plan = S.spin_plan(kron, kdt)
        assert plan.sparse == (kind == "wilson")
        assert all(spec[0] == ("direct" if kind == "random" or not any(offsets[d])
                               else "factored") for d, spec in enumerate(plan.specs))
        for k, bd_kd in ((kron, 12), (None, 3)):
            blocks = crand((len(offsets), 9) + lat, 10 * i, "cuda", st)
            x = crand((n, bd_kd) + lat, 10 * i + 2, "cuda", ft)
            args = (blocks, k, x, offsets, 3, 3)
            got = S.stencil_matvec_soa(*args, packed_parity=parity)
            want = S.stencil_matvec_soa_reference(*args, packed_parity=parity)
            assert got.re.dtype == ft and got.re.shape == want.re.shape
            err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
            scale = max(float(w.double().abs().max()) for w in want)
            assert err <= PLAN_TOL[ft] * scale, (kind, lat, parity, k is None, err, scale)
            if kind == "random" or k is None:
                rt = S.stencil_matvec_soa_rt(*args, packed_parity=parity)
                assert all(torch.equal(g, w) for g, w in zip(got, rt)), (lat, parity)
    after = S.stencil_matvec_soa.by_shape
    assert after[4, 4, 3, 3] - before[4, 4, 3, 3] == len(TILED_CASES)
    assert after[1, 1, 3, 3] - before[1, 1, 3, 3] == len(TILED_CASES)


@pytest.mark.cuda
@pytest.mark.parametrize("st,ft", ALL_PAIRS)
def test_tiled_k1_registers_and_spills(cuda_device, st, ft):
    """The tiled kernel's forms at both shapes, from cudaFuncGetAttributes:
    no local memory (spills) at the f32-summed pairs, within 128 registers
    there so that two blocks of 256 threads share an SM; at f64 at most
    255 registers."""
    import ctypes
    from superbblas_tpu_torch.ops import _cuda

    pair = S.KERNEL_DTYPES.index((st, ft))
    for ki, sparse in ((4, 1), (4, 0), (1, 0)):
        out = (ctypes.c_int * 4)()
        assert _cuda.library().sbt_stencil_tiled_attrs(ki, ki, 3, 3, pair, sparse, 8, 32, 32,
                                                       32, 64, 4, out) == 0
        regs, local, threads, blocks = list(out)
        if ft == torch.float64:
            assert regs <= 255 and blocks >= 1, (ki, sparse, regs, blocks)
        else:
            assert local == 0 and regs <= 128 and threads * blocks >= 512, \
                (ki, sparse, regs, local, threads, blocks)


@pytest.mark.cuda
def test_plan_built_once_per_operator(cuda_device):
    """A CG solve builds the spin plans of its operator and its adjoint
    once each and reads the operator's kron to the host once, the
    adjoint's derived from it: no
    device-to-host read in its iterations, nor in a loop that builds the
    adjoint on every call (``apply_wilson_dagger``).  The twisted-mass
    operator and the packed hoppings, made with ``op.replace``, get plans
    of their own."""
    op = W.wilson_operator((4, 4, 4, 8), mass=0.2, layout="soa", device="cuda")
    b = crand((2, 12, 4, 4, 4, 8), 3, "cuda", torch.float32)
    S.clear_plans()
    builds, reads = S.stencil_matvec_soa.plan_builds, S.stencil_matvec_soa.kron_reads
    W.cg_solve(op, b, n_iters=5)
    assert S.stencil_matvec_soa.plan_builds == builds + 2
    assert S.stencil_matvec_soa.kron_reads == reads + 1
    W.cg_solve(op, b, n_iters=5)
    for _ in range(5):
        W.apply_wilson_dagger(op, b)
    assert S.stencil_matvec_soa.plan_builds == builds + 2
    assert S.stencil_matvec_soa.kron_reads == reads + 1
    tm = W.twisted_mass_operator((4, 4, 4, 8), mass=0.2, layout="soa", device="cuda")
    hop = E.hopping_packed_soa(op, 0)
    for o in (tm, hop):
        p = S.spin_plan(o.kron, torch.float32)
        assert p is not S.spin_plan(op.kron, torch.float32)
    assert S.stencil_matvec_soa.plan_builds == builds + 4
    # the twisted operator's own Wilson kron is read once; the hops derive
    assert S.stencil_matvec_soa.kron_reads == reads + 2
    assert S.spin_plan(tm.kron, torch.float32).specs[0] != \
        S.spin_plan(op.kron, torch.float32).specs[0]


@pytest.mark.cuda
def test_tiled_k1_lattice_limit(cuda_device):
    """The tiled route indexes one column's field and one direction's
    blocks in 32 bits from 64-bit bases: a lattice whose nine directions'
    blocks pass 2^31 values (where a 32-bit block index would wrap) gives
    the runtime-shape route's bits at random (direct) spin factors; one
    whose column passes 2^31 values raises a ValueError naming the
    limit."""
    lat = (48, 48, 48, 256)   # 28.3M sites: 9 x 81 values a site > 2^31
    gen = torch.Generator(device="cuda").manual_seed(5)

    def rnd(shape, dt=torch.bfloat16):
        return CArray(*(torch.randn(shape, generator=gen, device="cuda").to(dt)
                        for _ in range(2)))

    blocks, x = rnd((9, 9) + lat), rnd((1, 12) + lat, torch.float32)
    kron = rnd((9, 4, 4), torch.float32)
    got = S.stencil_matvec_soa(blocks, kron, x, OFFSETS, 3, 3)
    want = S.stencil_matvec_soa_rt(blocks, kron, x, OFFSETS, 3, 3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    del got, want, x
    big = (64, 64, 64, 2 ** 31 // (12 * 64 ** 3) + 1)
    b1 = CArray(*(torch.empty((9, 9, 1, 1, 1, 1), device="cuda").expand((9, 9) + big)
                  for _ in range(2)))
    x1 = CArray(*(torch.empty((1, 12, 1, 1, 1, 1), device="cuda").expand((1, 12) + big)
                  for _ in range(2)))
    with pytest.raises(ValueError, match="32 bits"):
        S.stencil_matvec_soa(b1, kron, x1, OFFSETS, 3, 3)


#: (KI, KD, BI, BD) of K1 beyond the Wilson and staggered shapes: the
#: clover term (templated route), the JAX package's test shapes, an
#: asymmetric one, a chirally split and a 16-vector coarse stencil
#: (runtime-shape route)
NEW_SHAPES = [(1, 1, 12, 12), (2, 2, 3, 3), (1, 1, 2, 2), (2, 1, 4, 2), (2, 2, 8, 8),
              (1, 1, 16, 16)]
#: the runtime-shape route's shapes of chip_smoke.py's K1-shape path
RT_SHAPES = NEW_SHAPES[1:]


def _shape_operands(shape, lat, n, ndir, st, ft, seed):
    ki, kd, bi, bd = shape
    blocks = crand((ndir, bi * bd) + lat, seed, "cuda", st)
    kron = crand((ndir, ki, kd), seed + 1, "cuda", torch.float32) \
        if (ki, kd) != (1, 1) else None
    x = crand((n, kd * bd) + lat, seed + 2, "cuda", ft)
    return blocks, kron, x


@pytest.mark.cuda
@pytest.mark.parametrize("st,ft", DTYPES)
@pytest.mark.parametrize("shape", NEW_SHAPES)
def test_k1_new_shapes_match_plain_version(cuda_device, shape, st, ft):
    """K1 at each new shape against the plain version, on full lattices
    (9 Wilson directions; the centre alone) and with packed parity on a
    ragged half lattice; each call launches the route of its shape once.
    The runtime-shape route at the same operands gives the templated
    route's bits where both take the shape."""
    templated = shape in S.KERNEL_SHAPES
    counter = S.stencil_matvec_soa if templated else S.stencil_matvec_soa_rt
    before = counter.launches
    calls = 0
    for i, (lat, n, offsets, parity) in enumerate((
            ((3, 5, 6, 10), 3, OFFSETS, None), ((2, 4, 8, 32), 9, OFFSETS[:1], None),
            ((2, 4, 3, 8), 2, OFFSETS[1:], 0), ((3, 5, 4, 7), 1, OFFSETS[1:], 1))):
        blocks, k, x = _shape_operands(shape, lat, n, len(offsets), st, ft, 10 * i)
        args = (blocks, k, x, offsets, shape[2], shape[3])
        got = S.stencil_matvec_soa(*args, packed_parity=parity)
        calls += 1
        _close(got, S.stencil_matvec_soa_reference(*args, packed_parity=parity),
               f"{shape} {lat} n={n} parity={parity}")
        if templated:
            rt = S.stencil_matvec_soa_rt(*args, packed_parity=parity)
            assert all(torch.equal(g, w) for g, w in zip(got, rt)), (shape, lat)
    assert counter.launches == before + calls


#: max |kernel - plain| relative to max |plain| of K1's added pairs: f64
#: rounding for f64 (sums of at most 9 * 12 * 4 products), one bf16 ulp for
#: bf16 fields
PAIR_TOL = {torch.float64: 1e-12, torch.bfloat16: 8e-3}


@pytest.mark.cuda
@pytest.mark.parametrize("st,ft", [(torch.float64, torch.float64),
                                   (torch.float32, torch.bfloat16)])
@pytest.mark.parametrize("shape", [(4, 4, 3, 3), (1, 1, 3, 3)] + NEW_SHAPES)
def test_k1_f64_and_f32_bf16_pairs_match_plain_version(cuda_device, shape, st, ft):
    """K1 at f64 blocks with f64 fields (summed in f64, f64 kron factors)
    and at f32 blocks with bf16 fields (summed in f32, rounded on store)
    against the plain version on full lattices and with packed parity,
    on the templated shapes and the runtime shapes; the runtime route
    gives the templated route's bits where both take the shape."""
    templated = shape in S.KERNEL_SHAPES
    counter = S.stencil_matvec_soa if templated else S.stencil_matvec_soa_rt
    before = counter.launches
    ki, kd, bi, bd = shape
    cases = (((3, 5, 6, 10), 3, OFFSETS, None), ((2, 4, 3, 8), 2, OFFSETS[1:], 0),
             ((3, 5, 4, 7), 1, OFFSETS[1:], 1))
    kdt = torch.float64 if ft == torch.float64 else torch.float32
    for i, (lat, n, offsets, parity) in enumerate(cases):
        blocks = crand((len(offsets), bi * bd) + lat, 10 * i, "cuda", st)
        kron = crand((len(offsets), ki, kd), 10 * i + 1, "cuda", kdt) \
            if (ki, kd) != (1, 1) else None
        x = crand((n, kd * bd) + lat, 10 * i + 2, "cuda", ft)
        args = (blocks, kron, x, offsets, bi, bd)
        got = S.stencil_matvec_soa(*args, packed_parity=parity)
        want = S.stencil_matvec_soa_reference(*args, packed_parity=parity)
        assert got.re.dtype == ft and got.re.shape == want.re.shape
        err = max(float((g.double() - w.double()).abs().max()) for g, w in zip(got, want))
        scale = max(float(w.double().abs().max()) for w in want)
        assert err <= PAIR_TOL[ft] * scale, (shape, lat, parity, err, scale)
        if templated:
            rt = S.stencil_matvec_soa_rt(*args, packed_parity=parity)
            assert all(torch.equal(g, w) for g, w in zip(got, rt)), (shape, lat)
    assert counter.launches == before + len(cases)


@pytest.mark.cuda
def test_rt_route_takes_65536_columns(cuda_device):
    """The runtime-shape route has no cap of 65535 columns (its grid walks
    (tile, column group) items): 65536 columns of a (2, 2, 2, 2) lattice at
    (1, 1, 2, 2) through K1 and the route itself, against the plain
    version."""
    lat = (2, 2, 2, 2)
    blocks = crand((9, 4) + lat, 0, cuda_device, torch.float32)
    x = crand((65536, 2) + lat, 1, cuda_device, torch.float32)
    args = (blocks, None, x, OFFSETS, 2, 2)
    want = S.stencil_matvec_soa_reference(*args)
    before = S.stencil_matvec_soa_rt.launches
    for fn in (S.stencil_matvec_soa, S.stencil_matvec_soa_rt):
        _close(fn(*args), want, f"{fn.__name__} 65536 columns")
    assert S.stencil_matvec_soa_rt.launches == before + 2


@pytest.mark.cuda
@pytest.mark.parametrize("st,ft", S.KERNEL_DTYPES)
def test_rt_route_registers_and_blocks(cuda_device, st, ft):
    """The runtime-shape route's kernel at the tiles of the K1-shape path
    (16^3x32 x 8, 9 directions), from cudaFuncGetAttributes and the
    occupancy at the tile's shared memory: at the f32-summed pairs no
    spill and 512 (site, column) sums an SM or more (two columns a thread:
    8 warps); at f64 at least one block an SM."""
    for shape in RT_SHAPES:
        regs, local, threads, blocks = S.rt_attrs(shape, st, ft, 8, 9)
        label = (shape, regs, local, threads, blocks)
        Sites, C, R, G, _, _ = S.rt_tile(*shape, 8, 9, st.itemsize, ft.itemsize)
        assert threads == S.rt_threads(Sites, C, G), label
        if ft == torch.float64:
            assert regs <= 255 and blocks >= 1, label
        else:
            assert local == 0 and regs <= 128 and threads * blocks * S.RT_COLS >= 512, label


@pytest.mark.cuda
def test_roll_add_variants_match_plain_version(cuda_device):
    """E2: the f32 variant bit for bit against the plain version (even and
    odd T), the bf16x2 variant within one bf16 ulp of it (2^-7 of the
    magnitude); bf16x2 refuses an odd T."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    before = R.roll_add.launches
    for shape in ((256, 32, 256), (3, 5, 70), (2, 3, 9)):
        x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
        want = R.roll_add_reference(x)
        assert torch.equal(R.roll_add(x, "f32"), want), shape
        if shape[-1] % 2 == 0:
            got = R.roll_add(x, "bf16x2").float()
            scale = torch.maximum(want.float().abs(), torch.full_like(got, 2.0 ** -126))
            assert bool(((got - want.float()).abs() <= 2.0 ** -7 * scale).all()), shape
        else:
            with pytest.raises(ValueError, match="even"):
                R.roll_add(x, "bf16x2")
    assert R.roll_add.launches == before + 5


@pytest.mark.cuda
@pytest.mark.parametrize("perm", [(3, 2, 1, 0), (3, 1, 2, 0)])
def test_permute_tile_sweep_matches_plain_version(cuda_device, perm):
    """E3: every design point bit-exact on ragged tiles (X and T not
    multiples of the tiles), a strided view of aligned strides, int32
    words and extents of 1; one launch a call."""
    x = torch.randn((72, 6, 7, 80), device=cuda_device)
    cases = (x, x[4:68, 1:5, 2:7, 8:72], x.view(torch.int32),
             torch.randn((60, 3, 5, 68), device=cuda_device),
             torch.randn((8, 1, 1, 260), device=cuda_device))
    before = P.permute_4d_tiled.launches
    for tile in P.TILES:
        for v in cases:
            got = P.permute_4d_tiled(v, perm, tile)
            torch.cuda.synchronize()
            assert got.is_contiguous() and torch.equal(got, P.permute_4d_reference(v, perm)), \
                (tile, tuple(v.shape))
    assert P.permute_4d_tiled.launches == before + len(P.TILES) * len(cases)


@pytest.mark.cuda
def test_permute_tile_sweep_refusals(cuda_device):
    """The views the 16-byte forms do not take raise ValueError at every
    design point, before a launch: X or T not a multiple of 4 words, T's
    stride other than 1, a pointer off 16 bytes."""
    x = torch.randn((72, 6, 7, 80), device=cuda_device)
    views = (torch.randn((45, 6, 7, 68), device=cuda_device),
             torch.randn((44, 6, 7, 70), device=cuda_device),
             x.transpose(0, 3), x[:, :, :, 1:77])
    before = P.permute_4d_tiled.launches
    for tile in P.TILES:
        for v in views:
            perm = (3, 2, 1, 0)
            with pytest.raises(ValueError, match="16-byte"):
                P.permute_4d_tiled(v, perm, tile)
    assert P.permute_4d_tiled.launches == before


@pytest.mark.cuda
def test_eo_solve_on_card_matches_cpu(cuda_device):
    """The even-odd packed solve through the kernel against the same solve
    on the CPU (plain version): 4 N + 4 packed launches; rtol 1e-4, as
    CG amplifies summation-order differences."""
    lat, mass, iters = (4, 2, 4, 8), 0.1, 10
    op = W.wilson_operator(lat, mass=mass, key=0, layout="soa", device="cpu")
    b = crand((2, 12) + lat, 3, "cpu", torch.float32)
    x_cpu, rs_cpu = E.eo_solve_packed_soa(op, b, a=mass + 4.0, n_iters=iters)
    before = S.stencil_matvec_soa.launches
    x_gpu, rs_gpu = E.eo_solve_packed_soa(op.to(cuda_device), b.to(cuda_device),
                                          a=mass + 4.0, n_iters=iters)
    assert S.stencil_matvec_soa.launches == before + 4 * iters + 4
    scale = float(x_cpu.re.abs().max())
    for g, c in zip(x_gpu, x_cpu):
        assert float((g.cpu() - c).abs().max()) <= 1e-4 * scale
    assert abs(float(rs_gpu) - float(rs_cpu)) <= 1e-4 * float(rs_cpu)


@pytest.mark.cuda
def test_cg_solve_on_card_matches_cpu(cuda_device):
    """The solve through the kernel against the same solve on the CPU
    (plain version); CG amplifies summation-order differences: rtol 1e-4."""
    lat = (2, 4, 8, 16)
    op = W.wilson_operator(lat, mass=0.1, key=0, layout="soa", device="cpu")
    b = crand((2, 12) + lat, 3, "cpu", torch.float32)
    x_cpu, rs_cpu = W.cg_solve(op, b, n_iters=10)
    before = S.stencil_matvec_soa.launches
    x_gpu, rs_gpu = W.cg_solve(op.to(cuda_device), b.to(cuda_device), n_iters=10)
    assert S.stencil_matvec_soa.launches == before + 21
    scale = float(x_cpu.re.abs().max())
    for g, c in zip(x_gpu, x_cpu):
        assert float((g.cpu() - c).abs().max()) <= 1e-4 * scale
    assert abs(float(rs_gpu) - float(rs_cpu)) <= 1e-4 * float(rs_cpu)


@pytest.mark.cuda
def test_permute_kernel_raises_on_what_it_does_not_take(cuda_device):
    x = torch.zeros((16, 8, 8, 32), device=cuda_device)
    for bad, perm in ((x.double(), (3, 2, 1, 0)), (x, (0, 1, 2, 3)),
                      (x[:1], (3, 2, 1, 0)), (x[0], (2, 1, 0))):
        with pytest.raises(ValueError, match="the kernel takes"):
            P.permute_4d(bad, perm)


@pytest.mark.cuda
@pytest.mark.parametrize("perm", [(3, 2, 1, 0), (3, 1, 2, 0)])
def test_permute_kernel_matches_plain_version(cuda_device, perm):
    """Bit-exact on ragged tiles (X, T not multiples of 32), on a strided
    view and on int32 data; each eligible call launches the kernel once."""
    x = torch.randn((45, 6, 7, 70), device=cuda_device)
    cases = (x, x[3:40, 1:5, 2:7, 5:66], x.view(torch.int32))
    before = P.permute_4d.launches
    for v in cases:
        got = P.maybe_permute(v, perm)
        torch.cuda.synchronize()
        assert got.is_contiguous() and torch.equal(got, P.permute_4d_reference(v, perm))
    assert P.permute_4d.launches == before + len(cases)


@pytest.mark.cuda
def test_local_copy_on_card_matches_cpu(cuda_device):
    """A wrapped box copy with an eligible transpose: one kernel launch,
    bit-exact against the same copy on the CPU."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((12, 4, 5, 12)).astype(np.float32))
    y = torch.from_numpy(rng.standard_normal((12, 5, 4, 12)).astype(np.float32))
    kw = dict(from0=(9, 0, 0, 10), size0=(8, 4, 5, 8), from1=(10, 0, 0, 9),
              copy_add="add")
    want = local_copy(-2.5, x, "xyzt", y, "tzyx", **kw)
    before = P.permute_4d.launches
    got = local_copy(-2.5, x.to(cuda_device), "xyzt", y.to(cuda_device), "tzyx", **kw)
    assert P.permute_4d.launches == before + 1
    assert torch.equal(got.cpu(), want)


#: batched-GEMM shapes (V, I, J, N): the JAX package's test shapes, ragged
#: ones, E1's probe shape and the V-cycle's coarse levels (8 columns in
#: the solve, 4 and 1 in its set-up: the narrow tile, J split 8 ways); the
#: families' AoS shapes (tall tile, split 4 ways); 4-byte copies (N = 1,
#: 3, 5; J = 27, 33); K3 walking two sites a block (ragged V at the
#: end); the square tile split 4 ways at few blocks (V = 3, 7, 40); the
#: short tile (I <= 4, J <= 8, N > 8: the kron gather's colour stage),
#: walking two sites (ragged V), J in two steps, ragged N and J
GEMM_SHAPES = [(4096, 3, 3, 32), (20001, 3, 4, 40), (1001, 4, 8, 48), (777, 2, 5, 33),
               (40, 12, 12, 32), (7, 24, 24, 16), (16, 12, 8, 5), (8, 32, 32, 128),
               (7, 4, 324, 3), (5, 70, 33, 40), (4096, 32, 288, 32), (256, 4, 324, 8),
               (256, 4, 324, 4), (256, 4, 324, 1), (16, 4, 64, 8), (16, 4, 64, 4),
               (16, 4, 64, 1), (8192, 32, 32, 128), (4096, 12, 324, 2), (1024, 3, 27, 2),
               (300, 8, 33, 1), (20001, 12, 12, 5), (25001, 32, 32, 40), (3, 200, 500, 70),
               (40, 64, 64, 300)]


def _gemm_operands(V, I, J, N, dtype, device):
    rng = np.random.default_rng(V + I + J + N)
    b = torch.from_numpy(rng.standard_normal((V, I, J)) / np.sqrt(J)).to(device, dtype)
    x = torch.from_numpy(rng.standard_normal((V, J, N))).to(device, dtype)
    return b, x


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kernel", ["small", "rowpack"])
def test_batched_gemm_kernels_match_plain_version(cuda_device, kernel, dtype):
    """K3 (shapes with I, J <= 64) and E1 (every shape) against the plain
    version and a float64 product: each output sums J products of unit
    size, so f32 errs by at most about J * 2^-24 of the sum of |terms|;
    the bound 1e-5 * sqrt(J) relative to max |y| holds with margin for
    these normal operands (f64: 1e-12)."""
    wrapper = G.batched_small_gemm if kernel == "small" else G.batched_gemm_rowpack
    shapes = [s for s in GEMM_SHAPES if kernel == "rowpack" or max(s[1], s[2]) <= 64]
    before = wrapper.launches
    for V, I, J, N in shapes:
        b, x = _gemm_operands(V, I, J, N, dtype, cuda_device)
        got = wrapper(b, x)
        torch.cuda.synchronize()
        want64 = torch.einsum("vij,vjn->vin", b.double(), x.double())
        tol = (1e-5 if dtype == torch.float32 else 1e-12) * np.sqrt(J) \
            * float(want64.abs().max())
        assert got.dtype == dtype and got.shape == (V, I, N)
        assert float((got.double() - want64).abs().max()) <= tol, (V, I, J, N)
        plain = G.batched_small_gemm_reference(b, x)
        assert float((got.double() - plain.double()).abs().max()) <= tol, (V, I, J, N)
    assert wrapper.launches == before + len(shapes)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_gemm_kernels_give_the_same_bits_twice(cuda_device, dtype):
    """Two launches on the same operands give equal bits (the split-J
    partial sums are added in a fixed order), at each tile and on
    misaligned operands (a contiguous view one element into its storage:
    the 4-byte copies)."""
    for V, I, J, N in ((256, 4, 324, 8), (16, 4, 64, 8), (4096, 12, 324, 2),
                       (7, 24, 24, 16), (8192, 32, 32, 128), (4096, 32, 288, 32),
                       (4096, 3, 3, 32)):
        b, x = _gemm_operands(V, I, J, N, dtype, cuda_device)
        for wrapper in (G.batched_small_gemm, G.batched_gemm_rowpack):
            assert torch.equal(wrapper(b, x), wrapper(b, x)), (V, I, J, N)
    b, x = _gemm_operands(40, 12, 36, 8, dtype, cuda_device)
    xs = torch.empty(x.numel() + 1, dtype=dtype, device=cuda_device)
    xs[1:] = x.reshape(-1)
    xm = xs[1:].view(x.shape)
    assert xm.is_contiguous() and xm.data_ptr() % 16 != 0
    want64 = torch.einsum("vij,vjn->vin", b.double(), x.double())
    tol = (1e-5 if dtype == torch.float32 else 1e-12) * 6 * float(want64.abs().max())
    for wrapper in (G.batched_small_gemm, G.batched_gemm_rowpack):
        got = wrapper(b, xm)
        assert torch.equal(got, wrapper(b, xm))
        assert float((got.double() - want64).abs().max()) <= tol


@pytest.mark.cuda
def test_batched_gemm_routes_and_refusals(cuda_device):
    """batched_small_gemm launches K3 for I, J <= 64 and E1 otherwise; an
    empty V or N launches (and counts) nothing; bf16, mixed dtypes and
    non-contiguous operands are refused."""
    small, rowpack = G.batched_small_gemm.launches, G.batched_gemm_rowpack.launches
    G.batched_small_gemm(*_gemm_operands(16, 4, 64, 8, torch.float32, cuda_device))
    G.batched_small_gemm(*_gemm_operands(16, 4, 65, 8, torch.float32, cuda_device))
    for V, J, N in ((0, 64, 8), (16, 64, 0), (0, 65, 8), (16, 65, 0)):
        y = G.batched_small_gemm(*_gemm_operands(V, 4, J, N, torch.float32, cuda_device))
        assert y.shape == (V, 4, N) and y.device.type == "cuda"
    assert G.batched_small_gemm.launches == small + 1
    assert G.batched_gemm_rowpack.launches == rowpack + 1
    b, x = _gemm_operands(6, 8, 8, 4, torch.float32, cuda_device)
    with pytest.raises(ValueError, match="float32 and float64"):
        G.batched_small_gemm(b.bfloat16(), x.bfloat16())
    with pytest.raises(ValueError, match="one dtype"):
        G.batched_small_gemm(b, x.double())
    with pytest.raises(ValueError, match="contiguous"):
        G.batched_small_gemm(b.transpose(1, 2), x)


@pytest.mark.cuda
def test_apply_coarse_on_card_matches_cpu(cuda_device):
    """apply_coarse through E1 (J = 9 * 16 = 144) on the card against the
    same apply on the CPU (plain version): 3 launches (the Gauss
    products); rtol 1e-5 of max |y| at f32."""
    lat, nc = (4, 4, 2, 4), 16
    op = C.coarse_operator(lat, block_size=nc, mass=0.5, key=1, device="cpu")
    x = crand(lat + (nc, 5), 2, "cpu", torch.float32)
    want = C.apply_coarse(op, x)
    before = G.batched_gemm_rowpack.launches
    got = C.apply_coarse(op.to(cuda_device), x.to(cuda_device))
    assert G.batched_gemm_rowpack.launches == before + 3
    scale = max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["soa", "aos"])
def test_family_applies_on_card_match_cpu(cuda_device, layout):
    """Twisted mass, staggered, clover, Shamir and Moebius (both sides)
    built from the same numpy links on the card and on the CPU: the card's
    apply (K1 at (4,4,3,3), (1,1,3,3) and (1,1,12,12) in SoA; K3 and E1 in
    AoS) against the CPU's plain version, rtol 1e-5 of max |y| at f32."""
    lat, ls, n = (2, 4, 4, 8), 4, 2
    links = W.random_su3_links(np.random.default_rng(0), lat)
    dwf = dict(Ls=ls, M5=1.8, m_f=0.1, dtype=torch.complex64)
    cases = [(M.twisted_mass_operator, dict(mass=0.1, mu=0.05), M.apply_wilson, 12),
             (M.staggered_operator, dict(mass=0.1), M.apply_staggered, 3),
             (M.wilson_clover_operator, dict(mass=0.1, c_sw=1.0), M.apply_clover, 12),
             (M.domain_wall_operator, dwf, M.apply_domain_wall, None),
             (M.mobius_operator, dict(projector_side="left", **dwf), M.apply_domain_wall, None)]
    for build, kw, apply, feat in cases:
        ops = [build(lat, links=links, layout=layout, device=d, **kw)
               for d in ("cpu", cuda_device)]
        if layout == "soa":
            shape = (n, ls, 12) + lat if feat is None else (n, feat) + lat
        else:
            shape = ((ls,) + lat + (4, 3, n) if feat is None else
                     lat + ((3,) if feat == 3 else (4, 3)) + (n,))
        x = crand(shape, 7, "cpu", torch.float32)
        want = apply(ops[0], x)
        got = apply(ops[1], x.to(cuda_device))
        scale = max(float(w.abs().max()) for w in want)
        for g, w in zip(got, want):
            assert float((g.cpu() - w).abs().max()) <= 1e-5 * scale, build.__name__


#: the block-streaming kernel's pairs (every f32-summed pair of K1)
SITE_PAIRS = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
              (torch.bfloat16, torch.bfloat16), (torch.float32, torch.bfloat16)]
#: its cases (lattice, n, offsets, parity, with a kron): V a multiple of
#: the 32-site tile (256), ragged (900: 16-byte copies at 4-byte blocks,
#: element copies at bf16), V x elem not a multiple of 16 bytes (135: odd),
#: packed parity at both parities (192, 420); ndir 9, 1 and 8; n 1, 2, 8, 9
SITE_CASES = [((2, 4, 4, 8), 8, OFFSETS, None, False),
              ((3, 5, 6, 10), 9, OFFSETS, None, True),
              ((3, 3, 3, 5), 1, OFFSETS[:1], None, False),
              ((3, 3, 3, 5), 9, OFFSETS[:1], None, True),
              ((2, 4, 3, 8), 2, OFFSETS[1:], 0, False),
              ((3, 5, 4, 7), 1, OFFSETS[1:], 1, True),
              ((2, 4, 4, 8), 2, OFFSETS[:1], None, False)]


def _misaligned(c: CArray) -> CArray:
    """The same values at a data pointer one element past a 16-byte
    boundary (contiguous)."""
    def part(a):
        buf = torch.empty(a.numel() + 1, dtype=a.dtype, device=a.device)
        v = buf[1:].view(a.shape)
        v.copy_(a)
        return v
    return CArray(part(c.re), part(c.im))


@pytest.mark.cuda
@pytest.mark.parametrize("st,ft", SITE_PAIRS)
def test_site_kernel_matches_plain_version_and_runtime_route(cuda_device, st, ft):
    """K1's block-streaming kernel at (1, 1, 12, 12) against the plain
    version, and bit for bit against the runtime-shape route (it keeps
    site_matvec's order of sums), on each of SITE_CASES and once with
    misaligned blocks (element copies); each call launches the form
    ``k1_route`` names once, as ``stencil_matvec_soa.by_route`` counts."""
    forms = set()
    for i, (lat, n, offsets, parity, kron) in enumerate(SITE_CASES + [SITE_CASES[0]]):
        blocks = crand((len(offsets), 144) + lat, 10 * i, cuda_device, st)
        if i == len(SITE_CASES):
            blocks = _misaligned(blocks)
        k = crand((len(offsets), 1, 1), 10 * i + 1, cuda_device, torch.float32) \
            if kron else None
        x = crand((n, 12) + lat, 10 * i + 2, cuda_device, ft)
        args = (blocks, k, x, offsets, 12, 12)
        route = S.k1_route(S.SITE_SHAPE, st, ft, int(np.prod(lat)),
                           (blocks.re.data_ptr(), blocks.im.data_ptr()))
        forms.add(route)
        before = S.stencil_matvec_soa.by_route[route]
        got = S.stencil_matvec_soa(*args, packed_parity=parity)
        torch.cuda.synchronize()
        assert S.stencil_matvec_soa.by_route[route] == before + 1, (lat, route)
        label = f"{lat} n={n} ndir={len(offsets)} parity={parity} {route}"
        _close(got, S.stencil_matvec_soa_reference(*args, packed_parity=parity), label)
        rt = S.stencil_matvec_soa_rt(*args, packed_parity=parity)
        assert all(torch.equal(g, w) for g, w in zip(got, rt)), label
    assert forms == {"site16", "site"}


@pytest.mark.cuda
def test_site_kernel_attrs(cuda_device):
    """Registers within the launch bound (3 blocks of 128 threads an SM),
    no spill, and at least three resident blocks an SM at 8 columns (the
    f32 ring takes 72 KB), at every pair and form."""
    lib = _cuda_lib()
    out = (ctypes.c_int * 4)()
    for pair in range(4):
        for wide in (1, 0):
            assert lib.sbt_stencil_site_attrs(pair, wide, 8, out) == 0
            regs, local, threads, blocks = out
            assert regs <= 168 and local == 0 and threads == 128 and blocks >= 3, \
                (pair, wide, tuple(out))


def _cuda_lib():
    from superbblas_tpu_torch.ops import _cuda
    return _cuda.library()


#: the 16-byte route's shapes [X, Y, Z, T]: X below, at and above the
#: tile's 64 rows, T below, at and above its 128 words (multiples of 4);
#: Y*Z above 65535
VEC_SHAPES = [(60, 3, 5, 124), (64, 2, 3, 128), (68, 3, 2, 132), (4, 5, 3, 4),
              (8, 256, 257, 8), (128, 3, 2, 60)]


@pytest.mark.cuda
@pytest.mark.parametrize("perm", [(3, 2, 1, 0), (3, 1, 2, 0)])
def test_permute_vec_route_matches_plain_version(cuda_device, perm):
    """K2's 16-byte route bit for bit against ``x.permute(perm)
    .contiguous()`` on VEC_SHAPES and on an aligned strided view; a view
    whose base is one word off 16 bytes, and one with T's stride 2, take
    the 4-byte route; ``permute_4d.by_route`` counts each."""
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    big = torch.randn((72, 6, 7, 80), generator=gen, device=cuda_device)
    cases = [(torch.randn(s, generator=gen, device=cuda_device), "vec16") for s in VEC_SHAPES]
    cases += [(big[4:68, 1:5, 2:7, 8:72], "vec16"), (big[4:68, 1:5, 2:7, 1:65], "word"),
              (big[4:68, 1:5, 2:7, 0:80:2], "word"), (big.view(torch.int32), "vec16")]
    for v, route in cases:
        assert P.permute_route(tuple(v.shape), v.stride(), v.data_ptr(), 0) == route
        before = dict(P.permute_4d.by_route)
        got = P.permute_4d(v, perm)
        torch.cuda.synchronize()
        assert P.permute_4d.by_route[route] == before.get(route, 0) + 1, (v.shape, route)
        assert got.is_contiguous() and torch.equal(got, P.permute_4d_reference(v, perm)), \
            (tuple(v.shape), v.stride(), route)


@pytest.mark.cuda
def test_permute_vec_route_attrs(cuda_device):
    """The 16-byte route: no spill, 256 threads, at least 2 resident blocks
    an SM (3 stages of 32 KB each)."""
    out = (ctypes.c_int * 4)()
    assert _cuda_lib().sbt_permute_4d_vec_attrs(out) == 0
    regs, local, threads, blocks = out
    assert local == 0 and threads == 256 and blocks >= 2, tuple(out)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["runtime", "templated"])
def test_k1_takes_more_than_524280_columns(cuda_device, route):
    """No cap of 8 x 65535 columns on K1 (fault P6): 524,281 columns of a
    2^4 lattice at (1, 1, 2, 2) f32 (the runtime-shape route) and at the
    clover term's (1, 1, 12, 12) in f64 (the templated route, whose
    columns walk grid.y), against the plain version."""
    lat, n = (2, 2, 2, 2), 8 * 65535 + 1
    if route == "runtime":
        dt, bi, offsets = torch.float32, 2, OFFSETS
    else:
        dt, bi, offsets = torch.float64, 12, [(0, 0, 0, 0)]
    blocks = crand((len(offsets), bi * bi) + lat, 0, cuda_device, dt)
    x = crand((n, bi) + lat, 1, cuda_device, dt)
    args = (blocks, None, x, offsets, bi, bi)
    assert S.k1_route((1, 1, bi, bi), dt, dt, 16) == route
    got = S.stencil_matvec_soa(*args)
    want = S.stencil_matvec_soa_reference(*args)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    scale = max(float(w.abs().max()) for w in want)
    assert got.re.shape == want.re.shape
    assert err <= (1e-5 if dt == torch.float32 else 1e-12) * scale, (route, err, scale)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["k3_columns", "e1_columns", "e1_rows"])
def test_batched_gemm_walks_past_65535_tiles(cuda_device, case):
    """K3 and E1 past 65535 tiles on grid.z (N / NT) and grid.y (I / IT)
    (fault P6): each against the plain version and a float64 product."""
    V, I, J, N, fn = {"k3_columns": (1, 2, 3, 65536 * 128 + 3, G.batched_small_gemm),
                      "e1_columns": (1, 2, 3, 65536 * 128 + 3, G.batched_gemm_rowpack),
                      "e1_rows": (1, 65536 * 32 + 5, 3, 1, G.batched_gemm_rowpack)}[case]
    tile = (G.small_tile if fn is G.batched_small_gemm else G.rowpack_tile)(V, I, J, N)
    IT, NT = G.CONFIGS[tile[0]][:2]
    assert max(-(-I // IT), -(-N // NT)) > 65535, (case, tile)
    b, x = _gemm_operands(V, I, J, N, torch.float32, cuda_device)
    before = fn.launches
    got = fn(b, x)
    assert fn.launches == before + 1
    want = G.batched_small_gemm_reference(b, x)
    want64 = torch.einsum("vij,vjn->vin", b.double(), x.double())
    scale = float(want64.abs().max())
    assert float((got - want).abs().max()) <= 1e-5 * scale
    assert float((got.double() - want64).abs().max()) <= 1e-5 * scale


@pytest.mark.cuda
@pytest.mark.parametrize("T", [8, 256, 264, 6, 7])
def test_roll_add_forms(cuda_device, T):
    """E2's forms: vec16 at T = 8 (rows of one word: whole rows in a warp),
    256 (a row a warp) and 264 (rows across warps: the rolled element
    loaded), pair at T = 6, elem at T = 7 (f32 only); a view one element
    off 16 bytes takes pair (or elem).  The f32 variant bit for bit against
    the plain version, bf16x2 within one bf16 ulp; ``roll_add.by_form``
    counts each launch by form and ``roll_add.by_variant_form`` by
    (variant, form)."""
    gen = torch.Generator(device="cuda").manual_seed(T)
    base = torch.randn((97 * 33 * T + 2,), generator=gen, device="cuda").bfloat16()
    x = base[:97 * 33 * T].view(97, 33, T)
    views = [(x, R.roll_add_form(T, 0, 0))]
    if T % 2 == 0:
        views.append((base[2:2 + 97 * 33 * T].view(97, 33, T), "pair"))
    assert views[0][1] == ("vec16" if T % 8 == 0 else "pair" if T % 2 == 0 else "elem")
    for v, form in views:
        want = R.roll_add_reference(v)
        for variant in R.VARIANTS:
            if variant == "bf16x2" and form == "elem":
                with pytest.raises(ValueError, match="even"):
                    R.roll_add(v, variant)
                continue
            before = R.roll_add.by_form[form]
            before_row = R.roll_add.by_variant_form[variant, form]
            got = R.roll_add(v, variant)
            torch.cuda.synchronize()
            assert R.roll_add.by_form[form] == before + 1, (T, form, variant)
            assert R.roll_add.by_variant_form[variant, form] == before_row + 1
            if variant == "f32":
                assert torch.equal(got, want), (T, form)
            else:
                scale = torch.clamp_min(want.float().abs(), 2.0 ** -126)
                assert bool(((got.float() - want.float()).abs() <= 2.0 ** -7 * scale).all())


def _gather_case(nnz_max, seed, device, complex_values=True):
    """An irregular 1-D operator of 64 rows, 3x3 blocks: each row its own
    site and up to nnz_max - 1 random others."""
    rng = np.random.default_rng(seed)
    n = 64
    ii = rng.integers(1, nnz_max + 1, size=n)
    ii[0] = nnz_max
    jj = rng.integers(0, n, size=(n, nnz_max, 1))
    jj[:, 0, 0] = np.arange(n)
    vals = rng.standard_normal((n, nnz_max, 3, 3))
    if complex_values:
        vals = vals + 1j * rng.standard_normal(vals.shape)
    return ii, jj, vals


@pytest.mark.cuda
@pytest.mark.parametrize("nnz,kernel", [(9, "e1"), (5, "k3"), ("kron", "k3")])
def test_gather_applies_launch_their_kernel(cuda_device, nnz, kernel):
    """create_bsr's gather plan on the card: one batched product a Gauss
    part, on E1 where nnz*BD > 64 (9 slots of 12x12 blocks: J = 108) and on
    K3 below (5 slots of 3x3: J = 15); the kron gather's colour stage
    ([voli*nnz, 3, 3]) on K3; each against the same apply on the CPU."""
    from superbblas_tpu_torch import bsr as B

    rng = np.random.default_rng(3)
    if nnz == "kron":
        ii, jj, vals = _gather_case(5, 4, cuda_device)
        spin = rng.standard_normal((5, 2, 2)) + 1j * rng.standard_normal((5, 2, 2))
        args = ("XSc", (64, 2, 3), "XSc", (64, 2, 3), (1, 1, 3), (1, 1, 3), (1, 2, 1),
                (1, 2, 1), ii, jj)
        ops = [B.create_kron_bsr(*args, vals, spin, device=d) for d in ("cpu", cuda_device)]
        x = rng.standard_normal((64, 2, 3, 4)) + 1j * rng.standard_normal((64, 2, 3, 4))
        ox = "XScn"
    else:
        ii, jj, vals = _gather_case(nnz, 5, cuda_device)
        if nnz == 9:
            vals = np.tile(vals, (1, 1, 4, 4))          # 12x12 blocks: J = 108
        bw = vals.shape[-1]
        args = ("Xs", (64, bw), "Xc", (64, bw), (1, bw), (1, bw), ii, jj)
        ops = [B.create_bsr(*args, vals, device=d) for d in ("cpu", cuda_device)]
        x = rng.standard_normal((64, bw, 4)) + 1j * rng.standard_normal((64, bw, 4))
        ox = "Xcn"
    assert ops[0].mode == ops[1].mode == "gather"
    fn = G.batched_small_gemm if kernel == "k3" else G.batched_gemm_rowpack
    before = (G.batched_small_gemm.launches, G.batched_gemm_rowpack.launches)
    got = B.bsr_krylov(1.0, ops[1], torch.from_numpy(x).to(cuda_device), ox)
    torch.cuda.synchronize()
    after = (G.batched_small_gemm.launches, G.batched_gemm_rowpack.launches)
    want = B.bsr_krylov(1.0, ops[0], torch.from_numpy(x), ox)
    assert fn.launches - before[fn is G.batched_gemm_rowpack] == 3
    assert sum(after) - sum(before) == 3
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-10,
                               atol=1e-10 * float(want.abs().max()))


@pytest.mark.cuda
def test_aos_staggered_eo_solve_packed_launches_k3(cuda_device):
    """The AoS packed solve of the staggered operator on the card (J = 8 x 3
    = 24: K3, three launches a hopping apply) against the same solve on the
    CPU."""
    lat = (4, 4, 4, 8)
    links = W.random_su3_links(np.random.default_rng(2), lat)
    rng = np.random.default_rng(3)
    b = CArray(*(torch.from_numpy(rng.standard_normal(lat + (3, 2))) for _ in range(2)))
    out = []
    for dev in ("cpu", cuda_device):
        op = M.staggered_operator(lat, mass=0.5, links=links, dtype=torch.complex128,
                                  device=dev)
        before = G.batched_small_gemm.launches
        psi, rs = E.eo_solve_packed(op, b.to(dev), a=0.5, n_iters=6)
        out.append((psi, float(rs), G.batched_small_gemm.launches - before))
    (p0, r0, n0), (p1, r1, n1) = out
    assert n0 == 0 and n1 == 3 * (4 * 6 + 4), n1
    for g, w in zip(p1, p0):
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-10, atol=1e-10)
    assert abs(r1 - r0) <= 1e-10 * max(1.0, r0)


def _wilson_soa(device, lat=(4, 4, 8, 16), n=4):
    op = W.wilson_operator(lat, mass=0.1, key=0, layout="soa", device="cpu").to(device)
    return op, crand((n, 12) + lat, 5, device, torch.float32)


@pytest.mark.cuda
def test_cuda_graph_replay_of_k1_equals_eager(cuda_device):
    """aot_compile of a Wilson CG iteration (apply, adjoint apply, axpys)
    on the card: the replay equals the eager call bit for bit, on the
    example arguments and on new ones; the counters do not move on
    replay."""
    from superbblas_tpu_torch import aot, cplx

    op, b = _wilson_soa(cuda_device)
    op_h = W.adjoint_operator(op)
    state = (cplx.cmap(torch.zeros_like, b), b, b, cplx.inner_real(b, b))
    step = aot.aot_compile(lambda *s: W.cg_step(op, s, op_h), state)
    for st in (state, (b, b, crand(tuple(b.shape), 6, cuda_device, torch.float32),
                       cplx.inner_real(b, b) * 2)):
        before = dict(S.stencil_matvec_soa.by_route)
        got = step(*st)
        assert dict(S.stencil_matvec_soa.by_route) == before
        want = W.cg_step(op, st, op_h)
        for g, w in zip(torch.utils._pytree.tree_leaves(got),
                        torch.utils._pytree.tree_leaves(want)):
            assert g.device.type == "cuda" and torch.equal(g, w)
    with pytest.raises(TypeError, match="signature"):
        step(*(state[:3] + (state[3].double(),)))


@pytest.mark.cuda
def test_export_of_k1_path_launches_k1(cuda_device, tmp_path):
    """The SoA Wilson apply exported on the card holds K1's custom op;
    the loaded program launches K1 (its route's count moves by one a
    call) and matches the eager apply bit for bit."""
    from superbblas_tpu_torch import aot

    op, x = _wilson_soa(cuda_device)
    fn = lambda v: W.apply_wilson(op, v)
    want = fn(x)
    path = str(tmp_path / "k1.pt2")
    aot.export_compiled(fn, (x,), path)
    loaded = aot.load_exported(path)
    route = S.k1_route((4, 4, 3, 3), torch.float32, torch.float32, x.shape[2:].numel(),
                       (op.blocks.re.data_ptr(), op.blocks.im.data_ptr()))
    before = S.stencil_matvec_soa.by_route[route]
    got = loaded(x)
    assert S.stencil_matvec_soa.by_route[route] == before + 1
    assert torch.equal(got.re, want.re) and torch.equal(got.im, want.im)


def _kernel_counts():
    return (dict(P.permute_4d.by_route), G.batched_small_gemm.launches,
            G.batched_gemm_rowpack.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["stencil_matvec_soa_rt", "stencil_matvec_soa_xin",
                                  "stencil_matvec_soa_stream", "permute_4d_tiled", "roll_add"])
def test_exported_probe_entry_launches_its_kernel_once(cuda_device, tmp_path, name):
    """Fault P7 repaired: an entry no package path calls (K1's
    runtime-shape route, K4a, K4b, E3, E2), exported on the card, traces
    into its custom op; the loaded program launches its kernel once and
    gives the eager call's bits."""
    from superbblas_tpu_torch import aot

    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(3)
    lat = (8, 4, 4, 8)
    op = W.wilson_operator(lat, mass=0.1, key=0, layout="soa", device=cuda_device)
    if name.startswith("stencil"):
        entry = getattr(S, name)

        def fn(br, bi, kr, ki, xr, xi):
            y = entry(CArray(br, bi), CArray(kr, ki), CArray(xr, xi), op.offsets, 3, 3)
            return y.re, y.im

        x = [torch.randn((4, 12) + lat, generator=gen, device=cuda_device) for _ in range(2)]
        args = (op.blocks.re, op.blocks.im, op.kron.re, op.kron.im, *x)
    elif name == "permute_4d_tiled":
        entry = P.permute_4d_tiled
        fn = lambda v: (P.permute_4d_tiled(v, (3, 2, 1, 0), P.TILES[0]),)  # noqa: E731
        args = (torch.randn((16, 8, 8, 64), generator=gen, device=cuda_device),)
    else:
        entry = R.roll_add
        fn = lambda v: (R.roll_add(v, "bf16x2"),)  # noqa: E731
        args = (torch.randn((64, 4, 256), generator=gen, device=cuda_device)
                .to(torch.bfloat16),)
    want = fn(*args)
    loaded = aot.load_exported(aot.export_compiled(fn, args, str(tmp_path / "p.pt2")))
    torch.cuda.synchronize()
    before = entry.launches
    got = loaded(*args)
    torch.cuda.synchronize()
    assert entry.launches - before == 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["local_permute", "local_contraction", "aos_staggered",
                                  "coarse"])
def test_export_reaching_k2_k3_e1_launches_them(cuda_device, tmp_path, case):
    """Exported on the card: a 4-D relabel of f32 data (K2), a contraction
    whose output relabel K2 takes, the AoS staggered apply (K3) and the
    coarse apply (E1).  The loaded program launches the same kernels as
    the eager call, as many times, and matches it bit for bit."""
    from superbblas_tpu_torch import aot, cplx
    from superbblas_tpu_torch.ops.contract import local_contraction
    from superbblas_tpu_torch.ops.copy import local_permute

    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(0)
    r = lambda *s: torch.randn(s, generator=gen, device=cuda_device)
    if case == "local_permute":
        fn, args = (lambda v: local_permute(v, "xyzt", "tyzx")), (r(64, 8, 8, 64),)
    elif case == "local_contraction":
        fn = lambda a, b: local_contraction(1.0, a, "xyzt", False, b, "tk", False, 0.0, None,
                                            "kzyx")
        args = (r(16, 3, 5, 6), r(6, 8))
    elif case == "aos_staggered":
        lat = (2, 4, 4, 8)
        links = W.random_su3_links(np.random.default_rng(0), lat)
        op = M.staggered_operator(lat, mass=0.1, links=links, layout="aos", device=cuda_device)
        fn, args = (lambda v: M.apply_staggered(op, v)), (crand(lat + (3, 2), 7, cuda_device,
                                                                 torch.float32),)
    else:
        lat, nc = (4, 4, 2, 4), 16
        op = C.coarse_operator(lat, block_size=nc, mass=0.5, key=1, device="cpu").to(cuda_device)
        fn, args = (lambda v: C.apply_coarse(op, v)), (crand(lat + (nc, 5), 2, cuda_device,
                                                             torch.float32),)
    c0 = _kernel_counts()
    want = fn(*args)
    c1 = _kernel_counts()
    path = aot.export_compiled(fn, args, str(tmp_path / f"{case}.pt2"))
    loaded = aot.load_exported(path)
    c2 = _kernel_counts()
    got = loaded(*args)
    c3 = _kernel_counts()

    def moved(a, b):
        return ({k: b[0][k] - a[0].get(k, 0) for k in b[0] if b[0][k] != a[0].get(k, 0)},
                b[1] - a[1], b[2] - a[2])
    eager, replay = moved(c0, c1), moved(c2, c3)
    assert eager == replay and (eager[0] or eager[1] or eager[2]), (eager, replay)
    gp = tuple(got) if cplx.is_carray(got) else (got,)
    wp = tuple(want) if cplx.is_carray(want) else (want,)
    for g, w in zip(gp, wp):
        assert g.device.type == "cuda" and torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("split", [True, False])
def test_dense_ops_on_card_match_cpu(cuda_device, split):
    """cholesky, trsm of its factor, gesm and inversion on CUDA tensors
    (cuSOLVER) against the same calls on the CPU (LAPACK) at f64, 1e-10
    relative; the results stay on the card."""
    from superbblas_tpu_torch import cplx, dense

    rng = np.random.default_rng(1)
    a = rng.standard_normal((6, 12, 12)) + 1j * rng.standard_normal((6, 12, 12))
    a = a @ np.conj(np.swapaxes(a, -1, -2)) + 12 * np.eye(12)
    x = rng.standard_normal((6, 12, 3)) + 1j * rng.standard_normal((6, 12, 3))
    conv = cplx.from_complex if split else torch.from_numpy
    results = []
    for dev in ("cpu", cuda_device):
        A = conv(a).to(dev) if not split else cplx.cmap(lambda v: v.to(dev), conv(a))
        X = conv(x).to(dev) if not split else cplx.cmap(lambda v: v.to(dev), conv(x))
        u = dense.cholesky(A, "krc", "r", "c")
        outs = (u, dense.trsm(1.0, u, "krc", "r", "c", X, "krn", "kcn"),
                dense.gesm(2.0, A, "krc", "r", "c", X, "krn", "kcn"),
                dense.inversion(A, "krc", "r", "c"))
        results.append([torch.complex(o.re, o.im) if split else o for o in outs])
    for c, g in zip(*results):
        assert g.device.type == "cuda"
        assert float((g.cpu() - c).abs().max()) <= 1e-10 * float(c.abs().max())


@pytest.mark.cuda
def test_storage_roundtrip_of_cuda_carray(cuda_device, tmp_path):
    """A CUDA CArray saved in file order "xyztscn" and loaded back in
    another order comes back on the card, bit for bit, and the file
    equals the one saved from the same values on the CPU."""
    from superbblas_tpu_torch import cplx, storage

    lat, n = (4, 2, 2, 4), 3
    psi = crand((n, 4, 3) + lat, 8, cuda_device, torch.float32)
    files = []
    for name, x in (("gpu", psi), ("cpu", cplx.cmap(lambda v: v.cpu(), psi))):
        p = str(tmp_path / f"{name}.s3t")
        sto = storage.create_storage(p, "xyztscn", lat + (4, 3, n), dtype=np.complex64,
                                     checksum=2)
        storage.append_blocks(sto, [((0,) * 7, lat + (4, 3, n))])
        storage.save(1.0, x, "nscxyzt", sto, "xyztscn")
        storage.close_storage(sto)
        files.append(open(p, "rb").read())
    assert files[0] == files[1]
    sto = storage.open_storage(str(tmp_path / "gpu.s3t"), mode="r")
    storage.check_or_write_checksums(sto)
    back = storage.load(1.0, sto, cplx.cmap(torch.zeros_like, psi), "nscxyzt", "xyztscn")
    storage.close_storage(sto)
    assert back.re.device.type == "cuda"
    assert torch.equal(back.re, psi.re) and torch.equal(back.im, psi.im)


@pytest.mark.cuda
def test_dist_nccl_world1_apply_redistribute_storage(cuda_device, tmp_path):
    """A world-size-1 NCCL group: the sharded SoA apply (K1 on the rank's
    block) equals the unsharded K1 apply bit for bit; redistribute_explicit
    in both methods (a 1-rank axis resolves to the dense exchange) moves a
    field to a shifted partition and back exactly; save_sharded /
    load_sharded round-trip a CUDA CArray bit for bit."""
    import torch.distributed as dist

    from superbblas_tpu_torch import parallel as par, storage
    from superbblas_tpu_torch.parallel import redistribute as RD

    assert not dist.is_initialized()
    par.initialize_distributed(device="cuda")
    try:
        assert dist.get_backend() == "nccl"
        mesh = par.make_mesh({"X": 1})
        sh = par.NamedSharding(mesh, par.PartitionSpec(None, None, "X", None, None, None))
        lat = (8, 8, 8, 16)
        op = W.wilson_operator(lat, mass=0.2, key=3, layout="soa", device="cuda")
        x = crand((2, 12) + lat, 9, cuda_device, torch.float32)
        ops = op.replace(blocks=par.reshard(op.blocks, sh))
        xs = par.reshard(x, sh)
        before = S.stencil_matvec_soa.launches
        y = par.apply_stencil_soa_sharded(ops, xs, mesh, {"x": "X"})
        assert S.stencil_matvec_soa.launches == before + 1
        want = S.stencil_matvec_soa(op.blocks, op.kron, x, op.offsets, 3, 3)
        assert torch.equal(y.re.to_local(), want.re) and torch.equal(y.im.to_local(), want.im)
        dim = tuple(x.re.shape)
        src = par.sharding_partition(xs.re, dim)
        shifted = par.Partition(dim=dim, boxes=(((0, 0, 3, 0, 0, 0), dim),))
        st = RD.pack_global_device(xs, src)
        for method in ("ragged", "dense"):
            there = RD.redistribute_explicit(st, src, shifted, None, method=method)
            back = RD.redistribute_explicit(there, shifted, src, None, method=method)
            assert torch.equal(back.re.to_local(), st.re.to_local())
            assert torch.equal(there.re.to_local()[0], torch.roll(x.re, -3, dims=2))
        path = str(tmp_path / "psi.s3t")
        sto = storage.create_storage_sharded(path, "nfxyzt", dim, dtype=np.complex64,
                                             checksum=2)
        storage.save_sharded(sto, xs, "nfxyzt")
        storage.close_storage_sharded(sto)
        sto = storage.open_storage(path, mode="r")
        storage.check_or_write_checksums(sto)
        got = storage.load_sharded(sto, sh)
        storage.close_storage(sto)
        assert got.re.to_local().device.type == "cuda"
        assert torch.equal(got.re.to_local(), x.re) and torch.equal(got.im.to_local(), x.im)
    finally:
        par.mesh._DEVICE_MESHES.clear()
        dist.destroy_process_group()


_GLOO_RANK = r'''
import sys, torch
from superbblas_tpu_torch import parallel as par, cplx, bsr
from superbblas_tpu_torch.models import wilson as W
from superbblas_tpu_torch.ops import stencil as S
from superbblas_tpu_torch.utils import tracker
rank, port = int(sys.argv[1]), sys.argv[2]
torch.cuda.set_device(0)
par.initialize_distributed(f"localhost:{port}", 2, rank, device="cpu")
mesh = par.make_mesh({"X": 2}, "cuda")
spec = par.PartitionSpec(None, None, "X", None, None, None)
sh = par.NamedSharding(mesh, spec)
lat = (8, 4, 8, 16)
op = W.wilson_operator(lat, mass=0.2, key=4, layout="soa", device="cuda")
g = torch.Generator(device="cuda"); g.manual_seed(7)
x = cplx.CArray(torch.randn((2, 12) + lat, generator=g, device="cuda"),
                torch.randn((2, 12) + lat, generator=g, device="cuda"))
xs = par.reshard(x, sh)
ext = par.exchange_halos(xs, mesh, spec, {2: 1})
rows = [(rank * 4 + i) % 8 for i in range(-1, 5)]
assert torch.equal(ext.re.to_local(), x.re[:, :, rows]), "halo"
ops = op.replace(blocks=par.reshard(op.blocks, sh))
before = S.stencil_matvec_soa.launches
y = par.apply_stencil_soa_sharded(ops, xs, mesh, {"x": "X"})
assert S.stencil_matvec_soa.launches == before + 1, "one K1 launch"
want = S.stencil_matvec_soa(op.blocks, op.kron, x, op.offsets, 3, 3)
sl = slice(rank * 4, rank * 4 + 4)
assert torch.equal(y.re.to_local(), want.re[:, :, sl]), "apply re"
assert torch.equal(y.im.to_local(), want.im[:, :, sl]), "apply im"
y2 = par.apply_stencil_soa_sharded(ops, xs, mesh, {"x": "X"})
assert torch.equal(y2.re.to_local(), y.re.to_local()), "held apply re"
assert torch.equal(y2.im.to_local(), y.im.to_local()), "held apply im"
c = tracker.counters()
assert c.get("halo.block_builds") == 1 and c.get("halo.block_reuses") == 1, c
print("GLOO_RANK_OK", rank, flush=True)
'''


@pytest.mark.cuda
def test_dist_gloo_two_ranks_on_one_card_halo_and_apply(cuda_device, tmp_path):
    """Two gloo ranks on cuda:0 (NCCL refuses two ranks on one GPU): the
    halo exchange gives each rank its neighbours' edge planes, one
    sharded apply equals the unsharded K1 apply on that rank's slab, bit
    for bit, and a second apply, from the held halo-extended blocks,
    equals the first bit for bit after one build of them."""
    import os
    import socket
    import subprocess
    import sys
    from pathlib import Path

    s = socket.socket()
    s.bind(("localhost", 0))
    port = str(s.getsockname()[1])
    s.close()
    script = tmp_path / "rank.py"
    script.write_text(_GLOO_RANK)
    root = str(Path(__file__).resolve().parent.parent)
    env = {**os.environ, "PYTHONPATH": root}
    procs = [subprocess.Popen([sys.executable, str(script), str(r), port], cwd=root, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0 and f"GLOO_RANK_OK {r}" in out, out[-3000:]


#: floats a plane: the Moebius cell's field (16^3x32 x Ls 12 x 12:
#: 75.5 MB), one with a tail of n % 4, and the 12-rhs clover cell's
#: (32^3x64 x 12 x 12 rhs: 1.21 GB)
CG_PLANES = [18874368, 1000003, 301989888]


def _cg_operands(n, device, offset=0):
    """x, p, r and q = 1.5 p + noise (a positive pAp) of n floats a plane,
    each plane starting ``offset`` floats into its buffer."""
    gen = torch.Generator(device=device)
    gen.manual_seed(n)

    def field():
        return CArray(*(torch.randn(n + offset, generator=gen, device=device)[offset:]
                        for _ in range(2)))

    x, p, r, e = field(), field(), field(), field()
    q = CArray(*((1.5 * a + 0.1 * b) for a, b in zip(p, e)))
    if offset:
        q = CArray(*(torch.cat([a[:offset], a])[offset:] for a in q))
    return x, p, r, q


def _sum_close(got, want, terms):
    """A reduction in another order: within 1e-5 of the sum of |terms|.
    Each of the kernel's accumulators adds up to ~560 terms in turn
    (sqrt(560) 2^-24 = 1.4e-6 typical, relative), PyTorch's in a tree."""
    scale = float(sum(torch.sum(torch.abs(t.double())) for t in terms))
    assert abs(float(got) - float(want)) <= 1e-5 * scale, (float(got), float(want))


@pytest.mark.cuda
@pytest.mark.parametrize("n,offset", [(n, 0) for n in CG_PLANES] + [(CG_PLANES[1], 1)])
def test_cg_update_kernels_match_plain_version(cuda_device, n, offset):
    """Each kernel against its plain version: the fields bit for bit (the
    same roundings, given the same scalars), the sums within f32 rounding;
    a view 4 bytes into its buffer takes the element form."""
    x, p, r, q = _cg_operands(n, cuda_device, offset)
    assert U.form(*x, *p, *r, *q) == ("elem" if offset else "vec16")
    ws = U.workspace(x.re)
    forms = U.cg_xr.by_form.copy()
    rs, pap, bs = U.cg_dot(r, r, ws), U.cg_dot(p, q, ws), torch.tensor(7.0, device=cuda_device)
    _sum_close(pap, U.cg_dot_reference(p, q), [p.re * q.re, p.im * q.im])
    _sum_close(rs, U.cg_dot_reference(r, r), [r.re * r.re, r.im * r.im])
    xo, ro = CArray(*map(torch.empty_like, x)), CArray(*map(torch.empty_like, r))
    xw, rw = CArray(*map(torch.empty_like, x)), CArray(*map(torch.empty_like, r))
    rs_new = U.cg_xr(x, p, r, q, rs, pap, xo, ro, ws)
    want = U.cg_xr_reference(x, p, r, q, rs, pap, xw, rw)
    for a, b in zip((*xo, *ro), (*xw, *rw)):
        assert torch.equal(a, b)
    _sum_close(rs_new, want, [ro.re * ro.re, ro.im * ro.im])
    del xw, rw
    po, pw = CArray(*map(torch.empty_like, p)), CArray(*map(torch.empty_like, p))
    ratio = U.cg_p(ro, p, rs_new, rs, bs, po)
    want_ratio = U.cg_p_reference(ro, p, rs_new, rs, bs, pw)
    for a, b in zip(po, pw):
        assert torch.equal(a, b)
    assert torch.equal(ratio, want_ratio)
    # in place, as solvers.cg updates its own fields
    U.cg_xr(x, p, r, q, rs, pap, x, r, ws)
    U.cg_p(r, p, rs_new, rs, bs, p)
    for a, b in zip((*x, *r, *p), (*xo, *ro, *po)):
        assert torch.equal(a, b)
    torch.cuda.synchronize()
    assert U.cg_xr.by_form - forms == {("elem" if offset else "vec16"): 2}


@pytest.mark.cuda
def test_cg_update_reductions_repeat_bit_for_bit(cuda_device):
    """No float atomics: the same launch twice gives the same bits (the
    last block sums the blocks' partials in block order)."""
    x, p, r, q = _cg_operands(CG_PLANES[0], cuda_device)
    ws = U.workspace(x.re)
    rs = U.cg_dot(r, r, ws)
    dots = [U.cg_dot(p, q, ws) for _ in range(3)]
    outs = [U.cg_xr(x, p, r, q, rs, dots[0], CArray(*map(torch.empty_like, x)),
                    CArray(*map(torch.empty_like, r)), ws) for _ in range(3)]
    assert all(torch.equal(d, dots[0]) for d in dots) and all(torch.equal(o, outs[0])
                                                             for o in outs)
    assert int(ws[-1]) == 0                      # the ticket, reset by each last block


@pytest.mark.cuda
def test_clover_cgne_on_the_fused_kernels(cuda_device, monkeypatch):
    """A clover CGNE at 16^3x32 runs every iteration on the fused kernels
    (three launches an iteration) and takes the iterations of the PyTorch
    loop, to the same solution within f32 rounding."""
    from superbblas_tpu_torch.models import clover as Cl
    from superbblas_tpu_torch.utils import tracker

    lat = (16, 16, 16, 32)
    op = Cl.wilson_clover_operator(lat, mass=0.1, c_sw=1.0, key=0, dtype=torch.complex64,
                                   layout="soa", device=cuda_device)
    b = crand((1, 12) + lat, 5, cuda_device, torch.float32)
    signs = torch.tensor((1.0,) * 6 + (-1.0,) * 6, device=cuda_device).reshape(1, 12, 1, 1, 1,
                                                                                  1)

    def g5(v):
        return CArray(v.re * signs, v.im * signs)

    def solve():
        return solvers.cgne(lambda v: Cl.apply_clover(op, v),
                            lambda v: g5(Cl.apply_clover(op, g5(v))), b, tol=1e-5, maxiter=300)

    keep = (b.re.clone(), b.im.clone())
    before, launches = tracker.counters(), [f.launches for f in (U.cg_dot, U.cg_xr, U.cg_p)]
    x, rs, k = solve()
    after = tracker.counters()
    assert after["solver.fused_iterations"] - before.get("solver.fused_iterations", 0) == k
    assert after["solver.iterations"] - before.get("solver.iterations", 0) == k
    # cg_dot once more for |b|^2 before the loop
    assert [f.launches - n for f, n in zip((U.cg_dot, U.cg_xr, U.cg_p), launches)] == \
        [k + 1, k, k]
    assert torch.equal(b.re, keep[0]) and torch.equal(b.im, keep[1])
    monkeypatch.setattr(solvers, "_fusable", lambda *args: False)
    x_ops, rs_ops, k_ops = solve()
    assert k == k_ops > 10
    scale = float(x_ops.re.abs().max())
    for a, w in zip(x, x_ops):
        assert float((a - w).abs().max()) <= 1e-4 * scale
    assert abs(float(rs) - float(rs_ops)) <= 0.05 * float(rs_ops)


#: the s5 pass's shapes [n, Ls, 12, *lat]: the Moebius cell's field
#: (16^3x32 x Ls 12 x 1: the 16-byte form), one whose sites a plane are no
#: multiple of 4 or 2, and one at Ls 1 whose planes start one element into
#: their buffers (both one element a step)
DW_S5_SHAPES = {"cell": ((1, 12, 12, 16, 16, 16, 32), 0), "ragged": ((3, 5, 12, 3, 3, 3, 5), 0),
                "offset": ((2, 1, 12, 4, 4, 4, 8), 1)}


def _dw_s5_field(shape, offset, gen, dtype=torch.float32):
    n = int(np.prod(shape))
    return CArray(*(torch.randn(n + offset, generator=gen, device=gen.device, dtype=dtype)[offset:]
                    .view(shape) for _ in range(2)))


def _dw_s5_args(kind, x, y, device, dtype=torch.float32):
    """A pass's arguments with the chiral weights and the walls of the
    Moebius (bulk 1, wall -m_f) and Shamir (-1, m_f) operators."""
    wp = torch.tensor((0.0,) * 6 + (1.0,) * 6, device=device, dtype=dtype)
    bulk, wall = (-1.0, 0.000678) if kind == "shamir" else (1.0, -0.000678)
    return (kind, x, None if kind == "right_pre" else y, wp, 1.0 - wp, bulk, wall, 1.5, 0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("case", list(DW_S5_SHAPES))
@pytest.mark.parametrize("kind", D5.PASSES)
def test_dw_s5_kernel_matches_plain_version(cuda_device, kind, case, dtype):
    """Each pass of the s5 kernel against its plain version, bit for bit
    (the same roundings), out of place, in the form its operands take;
    its bytes counted."""
    from superbblas_tpu_torch.utils import tracker

    shape, offset = DW_S5_SHAPES[case]
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(len(shape) + shape[1])
    x, y = (_dw_s5_field(shape, offset, gen, dtype) for _ in range(2))
    args = _dw_s5_args(kind, x, y, cuda_device, dtype)
    forms, passes = D5.dw_s5.by_form.copy(), D5.dw_s5.by_pass.copy()
    nbytes = tracker.counters().get("dw_s5.bytes", 0)
    got = D5.dw_s5(*args)
    want = D5.dw_s5_reference(*args)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == dtype and torch.equal(a, b)
    assert D5.dw_s5.by_form - forms == {("vec16" if case == "cell" else "elem"): 1}
    assert D5.dw_s5.by_pass - passes == {kind: 1}
    planes = 4 if kind == "right_pre" else 6
    assert tracker.counters()["dw_s5.bytes"] - nbytes == planes * x.re.numel() * x.re.element_size()


@pytest.mark.cuda
def test_dw_s5_kernel_takes_strided_fields_and_other_weights(cuda_device):
    """Transposed views and f32 weights beside f64 fields: the wrapper
    makes the planes contiguous and casts the weights, and the kernel
    equals the plain version on the same views."""
    gen = torch.Generator(device=cuda_device)
    gen.manual_seed(11)
    shape = (2, 4, 12, 4, 4, 4, 8)
    x, y = (CArray(*(t.transpose(3, 6) for t in _dw_s5_field(shape, 0, gen, torch.float64)))
            for _ in range(2))
    args = list(_dw_s5_args("left", x, y, cuda_device))
    assert not x.re.is_contiguous() and args[3].dtype == torch.float32
    got = D5.dw_s5(*args)
    want = D5.dw_s5_reference(*args)
    for a, b in zip(got, want):
        assert a.dtype == torch.float64 and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.complex64, torch.complex128], ids=["f32", "f64"])
def test_moebius_cgne_on_the_s5_kernel(cuda_device, monkeypatch, dtype):
    """A Moebius CGNE (A^H = (Gamma5 R5) D_left (Gamma5 R5)) at 8^3x16 x
    Ls 12 runs the s5 terms of every apply on the kernel: right_pre and
    right_post once an iteration, left once more for A^H b.  The plain
    version's solve takes the same iterations to the same solution within
    the fields' rounding."""
    from superbblas_tpu_torch.models import domain_wall as DW

    lat, Ls = (8, 8, 8, 16), 12
    real = torch.float32 if dtype == torch.complex64 else torch.float64
    links = W.random_su3_links(np.random.default_rng(2), lat)
    kw = dict(Ls=Ls, M5=1.8, m_f=0.05, b5=1.5, c5=0.5, links=links, dtype=dtype,
              layout="soa", device=cuda_device)
    Dr = DW.mobius_operator(lat, **kw)
    Dl = DW.mobius_operator(lat, projector_side="left", **kw)
    b = crand((1, Ls, 12) + lat, 6, cuda_device, real)
    signs = torch.tensor((1.0,) * 6 + (-1.0,) * 6, device=cuda_device, dtype=real).reshape(
        1, 1, 12, 1, 1, 1, 1)

    def r5g5(v):
        return CArray(*(a.flip(1) * signs for a in v))

    def solve():
        return solvers.cgne(lambda v: DW.apply_domain_wall(Dr, v),
                            lambda v: r5g5(DW.apply_domain_wall(Dl, r5g5(v))), b, tol=1e-5,
                            maxiter=1000)

    passes = D5.dw_s5.by_pass.copy()
    x, rs, k = solve()
    assert D5.dw_s5.by_pass - passes == {"right_pre": k, "right_post": k, "left": k + 1}
    kernel, launches = D5.dw_s5, D5.dw_s5.launches
    monkeypatch.setattr(D5, "dw_s5", D5.dw_s5_reference)
    x_ops, rs_ops, k_ops = solve()
    assert kernel.launches == launches
    assert k == k_ops > 10
    scale = float(x_ops.re.abs().max())
    for a, w in zip(x, x_ops):
        assert a.dtype == real and float((a - w).abs().max()) <= 1e-4 * scale
    assert abs(float(rs) - float(rs_ops)) <= 0.05 * float(rs_ops)
