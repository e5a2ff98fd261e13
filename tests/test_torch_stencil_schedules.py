"""The X-inside (K4a) and X-streaming (K4b) schedules of the SoA stencil,
``superbblas_tpu_torch.ops.stencil.stencil_matvec_soa_xin``/``_stream``,
against superbblas_tpu's Pallas kernels in interpret mode on the same
numpy inputs (their CUDA kernels' tests are in test_torch_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import WILSON_OFFSETS, assert_parity, both, crand_np
from superbblas_tpu.models import wilson as JW
from superbblas_tpu.ops import stencil_pallas as JS
from superbblas_tpu_torch import bsr as TB
from superbblas_tpu_torch.cplx import CArray
from superbblas_tpu_torch.ops import stencil as TS

LAT = (4, 4, 8, 128)
SCHEDULES = {"xin": (TS.stencil_matvec_soa_xin, JS.stencil_matvec_soa_xin),
             "stream": (TS.stencil_matvec_soa_stream, JS.stencil_matvec_soa_stream)}


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_schedule_matches_jax_pallas_kernel(schedule):
    """The Wilson operator, 2 columns, f32: the port (plain version on the
    CPU) against the TPU kernel of the same schedule in interpret mode."""
    jop = JW.wilson_operator(LAT, mass=0.1, key=0, layout="soa", dtype=jnp.complex64)
    a = np.asarray
    top = TB.operator_from_numpy(a(jop.blocks.re), a(jop.blocks.im), a(jop.kron.re),
                                 a(jop.kron.im), jop.offsets, jop.dim_i, jop.bi, jop.bd,
                                 jop.ki, jop.kd, device="cpu")
    jx, tx = both(crand_np((2, 12) + LAT, 0, np.float32))
    port, jax_kernel = SCHEDULES[schedule]
    got = port(top.blocks, top.kron, tx, top.offsets, 3, 3)
    want = jax_kernel(jop.blocks, jop.kron, jx, jop.offsets, 3, 3, interpret=True)
    assert got.re.dtype == torch.float32
    assert_parity(got, want, np.float32)


#: one bf16 ulp relative to the value: both sides round an f32 sum to bf16
#: once, and two sums in another order may fall on either side of a
#: rounding boundary
BF16_RTOL = 2.0 ** -7
#: (KI, KD, BI, BD), field dtype of the cases below
CASES = {"staggered": ((1, 1, 3, 3), np.float32), "runtime_2x2": ((2, 2, 3, 3), np.float32),
         "bf16_fields": ((4, 4, 3, 3), np.float32)}


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_schedule_shapes_and_types_match_jax_pallas_kernel(schedule, case):
    """The port's schedules (plain version on the CPU) against the TPU
    kernels of the same schedule in interpret mode on the same numpy
    inputs, 2 columns, beyond the Wilson f32 case: the staggered shape
    (1, 1, 3, 3) without a kron, the runtime shape (2, 2, 3, 3) with a
    random kron, and the Wilson operator on bf16 fields."""
    (ki, kd, bi, bd), dt = CASES[case]
    lat = (2, 2, 8, 128)
    blocks = crand_np((9, bi * bd) + lat, 1, dt)
    kron = None if ki == kd == 1 else crand_np((9, ki, kd), 2, dt)
    if case == "bf16_fields":
        jop = JW.wilson_operator(lat, mass=0.1, key=0, layout="soa", dtype=jnp.complex64)
        blocks = (np.asarray(jop.blocks.re), np.asarray(jop.blocks.im))
        kron = (np.asarray(jop.kron.re), np.asarray(jop.kron.im))
    jb, tb = both(blocks)
    jk, tk = both(kron) if kron is not None else (None, None)
    field = (jnp.bfloat16, torch.bfloat16) if case == "bf16_fields" else (None, None)
    jx, tx = both(crand_np((2, kd * bd) + lat, 3, dt), *field)
    port, jax_kernel = SCHEDULES[schedule]
    got = port(tb, tk, tx, WILSON_OFFSETS, bi, bd)
    want = jax_kernel(jb, jk, jx, WILSON_OFFSETS, bi, bd, interpret=True)
    assert got.re.dtype == tx.re.dtype and got.re.shape == tx.re.shape[:1] + (ki * bi,) + lat
    assert_parity(got, want, np.float32,
                  rtol=BF16_RTOL if case == "bf16_fields" else None)


@pytest.mark.parametrize("nc", [1, 2, 4, 3])
def test_stream_nc_divides_the_columns(nc):
    """``nc`` is the columns of a block: a divisor of n is taken (the plain
    version on the CPU), anything else raises ValueError on every device,
    as the TPU wrapper does."""
    args = [both(crand_np(s, i, np.float32)) for i, s in enumerate(
        ((9, 9, 2, 3, 2, 5), (9, 4, 4), (4, 12, 2, 3, 2, 5)))]
    if 4 % nc:
        with pytest.raises(ValueError, match="must divide"):
            TS.stencil_matvec_soa_stream(*(t for _, t in args), WILSON_OFFSETS, 3, 3, nc=nc)
        with pytest.raises(ValueError, match="must divide"):
            JS.stencil_matvec_soa_stream(*(j for j, _ in args), WILSON_OFFSETS, 3, 3,
                                         interpret=True, nc=nc)
        return
    got = TS.stencil_matvec_soa_stream(*(t for _, t in args), WILSON_OFFSETS, 3, 3, nc=nc)
    want = TS.stencil_matvec_soa_reference(*(t for _, t in args), WILSON_OFFSETS, 3, 3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("schedule", list(SCHEDULES))
def test_cpu_dispatch_takes_plain_path(schedule):
    blocks, kron, x = (both(crand_np(s, i, np.float32))[1] for i, s in enumerate(
        ((9, 9, 2, 3, 2, 5), (9, 4, 4), (3, 12, 2, 3, 2, 5))))
    wrapper = SCHEDULES[schedule][0]
    before = wrapper.launches
    got = wrapper(blocks, kron, x, WILSON_OFFSETS, 3, 3)
    want = TS.stencil_matvec_soa_reference(blocks, kron, x, WILSON_OFFSETS, 3, 3)
    assert wrapper.launches == before == 0
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("n,X,F,itemsize,tile", [
    (8, 32, 12, 4, (32, 1, 32)),   # 32x32x32x64 x 8: 32 sites of one column, 3 KB lines
    (8, 8, 12, 4, (32, 4, 32)),    # bench shape 8x8x16x128 x 8
    (8, 32, 12, 2, (32, 2, 32)),   # bf16 fields: half the bytes, twice the columns
    (2, 8, 12, 4, (32, 1, 32)),
    (1, 3, 3, 4, (32, 1, 32)),
])
def test_xin_tile_fits_shared_memory(n, X, F, itemsize, tile):
    """Two stages of a tile's X lines within a block's shared memory (one
    block of 512 threads an SM), no more sites x columns than threads,
    rows at least a tile's sites apart."""
    assert TS.xin_tile(n, X, F, itemsize) == tile
    S, C, rs = tile
    assert S * C <= 256 and rs >= S
    assert 2 * X * C * F * 2 * itemsize * rs <= TS.SMEM_BYTES


@pytest.mark.parametrize("n,rows,T,F,itemsize,nc,tile", [
    (8, 1024, 64, 12, 4, None, (32, 1, 4, 36)),   # 32x32x32x64 x 8, Wilson
    (8, 1024, 64, 3, 4, None, (32, 1, 4, 36)),    # the same, staggered
    (8, 1024, 64, 12, 2, None, (32, 1, 4, 40)),   # bf16 fields: rows S + 8 sites apart
    (8, 1024, 64, 12, 8, None, (16, 1, 4, 18)),   # f64: half the T tile
    (9, 6, 10, 12, 4, None, (16, 6, 1, 20)),      # n = 9: one column a group
    (9, 6, 10, 12, 4, 9, (8, 1, 9, 12)),          # nc = 9: the tile shrinks to fit
])
def test_stream_tile_fits_shared_memory(n, rows, T, F, itemsize, nc, tile):
    """The ring of four planes of a tile (rows of S sites and a one-site T
    halo a side, 16 bytes more than S apart) within a quarter of the SM's
    shared memory, C = nc where given."""
    assert TS.stream_tile(n, rows, T, F, itemsize, nc) == tile
    S, R, C, rs = tile
    vec = 16 // itemsize
    assert rs >= S + vec and rs % vec == 0 and (nc is None or C == nc)
    assert 4 * (2 * F * R * C * rs + vec) * itemsize <= TS.STREAM_RING_BYTES


def test_xin_raises_where_no_tile_fits():
    """One X line of 4000 sites x 12 features (384 KB in f32) exceeds a
    block's shared memory: a named ValueError on every device, as the TPU
    wrapper raises where no (nc, Yc) fits its VMEM."""
    lat = (4000, 1, 1, 1)
    blocks = CArray(torch.zeros((9, 9) + lat), torch.zeros((9, 9) + lat))
    kron = CArray(torch.zeros((9, 4, 4)), torch.zeros((9, 4, 4)))
    x = CArray(torch.zeros((1, 12) + lat), torch.zeros((1, 12) + lat))
    with pytest.raises(ValueError, match="no tile of the X-inside"):
        TS.stencil_matvec_soa_xin(blocks, kron, x, WILSON_OFFSETS, 3, 3)
