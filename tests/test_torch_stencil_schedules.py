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
    (8, 32, 12, 4, (32, 2, 4)),    # 32x32x32x64 x 8: 64 pairs of 3 KB lines
    (8, 8, 12, 4, (32, 8, 1)),     # bench shape 8x8x16x128 x 8
    (8, 32, 12, 2, (32, 4, 2)),    # bf16 fields: half the bytes, twice the pairs
    (2, 8, 12, 4, (128, 2, 1)),
    (1, 3, 3, 4, (256, 1, 1)),
])
def test_xin_tile_fits_shared_memory(n, X, F, itemsize, tile):
    assert TS.xin_tile(n, X, F, itemsize, 9 * 16) == tile
    S, C, XG = tile
    assert S * C * XG <= 256
    assert 4 * 288 + X * C * F * 2 * itemsize * S <= TS.SMEM_BYTES


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
