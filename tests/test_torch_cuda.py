"""The CUDA kernels on the card: the cases each refuses; the stencil
kernel with packed parity, on both its routes at every new block shape,
and its X-inside and X-streaming schedules against the plain version (and
the schedules and the runtime-shape route against the templated kernel,
bit for bit); the bf16 roll-plus-add (E2) in both variants and the
transpose tile sweep (E3) at each tile; every operator family's apply on
the card, in both layouts, against the same apply on the CPU; the CG and even-odd solves through the stencil kernel against the
same solves on the CPU; the permute kernel against its plain version,
alone and inside ``local_copy``; the batched-GEMM kernels K3 and E1
against their plain version and a float64 product, and ``apply_coarse``
on the card against the CPU port.  The kernels at the main path's shapes
are checked by ``chip_smoke.py``.

Every test here needs an NVIDIA GPU (marker ``cuda``) and skips without
one.  The file imports no JAX, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from superbblas_tpu_torch import local_copy
from superbblas_tpu_torch.cplx import CArray
from superbblas_tpu_torch import models as M
from superbblas_tpu_torch.models import coarse as C
from superbblas_tpu_torch.models import eo_packed as E
from superbblas_tpu_torch.models import wilson as W
from superbblas_tpu_torch.ops import batched_gemm as G
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
    """K1 launches f64 operands on both its routes, while the schedules
    refuse them; the schedules take only their shapes (4x4 blocks here),
    K1 every shape up to KI*KD*BI*BD = 256 and raises above it; a parity
    other than 0 and 1 is refused."""
    lat = (2, 2, 4, 8)
    blocks = crand((9, 9) + lat, 0, cuda_device, torch.float32)
    x = crand((1, 3) + lat, 1, cuda_device, torch.float32)
    b16 = crand((9, 16) + lat, 2, cuda_device, torch.float32)
    x16 = crand((1, 4) + lat, 3, cuda_device, torch.float32)
    b64, x64 = blocks.to(torch.float64), x.to(torch.float64)
    for fn in (S.stencil_matvec_soa, S.stencil_matvec_soa_rt):
        before = fn.launches
        assert fn(b64, None, x64, OFFSETS, 3, 3).re.dtype == torch.float64
        assert fn.launches == before + 1
    for fn in (S.stencil_matvec_soa_xin, S.stencil_matvec_soa_stream):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn(b64, None, x64, OFFSETS, 3, 3)
    for fn in (S.stencil_matvec_soa_xin, S.stencil_matvec_soa_stream):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            fn(b16, None, x16, OFFSETS, 4, 4)
    before = S.stencil_matvec_soa_rt.launches
    S.stencil_matvec_soa(b16, None, x16, OFFSETS, 4, 4)
    assert S.stencil_matvec_soa_rt.launches == before + 1
    b289 = crand((9, 289) + lat, 4, cuda_device, torch.float32)
    x17 = crand((1, 17) + lat, 5, cuda_device, torch.float32)
    for fn in (S.stencil_matvec_soa, S.stencil_matvec_soa_rt):
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


@pytest.mark.cuda
@pytest.mark.parametrize("st,ft", DTYPES)
@pytest.mark.parametrize("schedule", ["xin", "stream"])
def test_schedules_match_plain_version_and_kernel(cuda_device, schedule, st, ft):
    """K4a and K4b against the plain version, and against K1 bit for bit
    (they share K1's per-site math and its order of sums), with X of 1, 2
    and 3 among the lattices."""
    wrapper = WRAPPERS[schedule]
    before = wrapper.launches
    cases = [((1, 3, 2, 5), 1), ((2, 4, 3, 8), 2), ((3, 2, 5, 7), 3), ((4, 4, 8, 32), 8)]
    for i, (lat, n) in enumerate(cases):
        for kron in (True, False):
            blocks, k, x = _operands(lat, n, kron, st, ft, 10 * i)
            args = (blocks, k, x, OFFSETS, 3, 3)
            got = wrapper(*args)
            _close(got, S.stencil_matvec_soa_reference(*args), f"{schedule} {lat} n={n}")
            k1 = S.stencil_matvec_soa(*args)
            assert all(torch.equal(g, w) for g, w in zip(got, k1)), (schedule, lat, n)
    assert wrapper.launches == before + 2 * len(cases)


#: (KI, KD, BI, BD) of K1 beyond the Wilson and staggered shapes: the
#: clover term (templated route), the JAX package's test shapes and an
#: asymmetric one (runtime-shape route)
NEW_SHAPES = [(1, 1, 12, 12), (2, 2, 3, 3), (1, 1, 2, 2), (2, 1, 4, 2)]


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
@pytest.mark.parametrize("shape", [(4, 4, 3, 3), (1, 1, 3, 3), (1, 1, 12, 12), (2, 1, 4, 2)])
def test_k1_f64_and_f32_bf16_pairs_match_plain_version(cuda_device, shape, st, ft):
    """K1 at f64 blocks with f64 fields (summed in f64, f64 kron factors)
    and at f32 blocks with bf16 fields (summed in f32, rounded on store)
    against the plain version on full lattices and with packed parity,
    on the templated shapes and one runtime shape; the runtime route
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
    """E3: every tile bit-exact on ragged tiles, a strided view and int32
    words; one launch a call."""
    x = torch.randn((45, 6, 7, 70), device=cuda_device)
    cases = (x, x[3:40, 1:5, 2:7, 5:66], x.view(torch.int32))
    before = P.permute_4d_tiled.launches
    for tile in P.TILES:
        for v in cases:
            got = P.permute_4d_tiled(v, perm, tile)
            torch.cuda.synchronize()
            assert got.is_contiguous() and torch.equal(got, P.permute_4d_reference(v, perm))
    assert P.permute_4d_tiled.launches == before + len(P.TILES) * len(cases)


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
#: end); the square tile split 4 ways at few blocks (V = 3, 7, 40)
GEMM_SHAPES = [(40, 12, 12, 32), (7, 24, 24, 16), (16, 12, 8, 5), (8, 32, 32, 128),
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
                       (7, 24, 24, 16), (8192, 32, 32, 128), (4096, 32, 288, 32)):
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
