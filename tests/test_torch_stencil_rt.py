"""The host side of K1's runtime-shape route (``csrc/stencil_rt.cu``), on
the CPU: the tile ``rt_tile`` picks at every shape class up to
KI*KD*BI*BD = 256 and every type pair (it fits a block's shared memory,
each output of a (site, column) is owned by one thread, and the kernel's
walk over the rows of K_d reaches each of them once), and the wrapper's
refusals.  The kernel itself is checked on the card by
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

from superbblas_tpu_torch.cplx import CArray
from superbblas_tpu_torch.ops import stencil as S

#: shape classes: square and rectangular blocks, spin factors of every
#: width, the extremes of the rule (one feature, 256 outputs, 256 inputs)
SHAPES = [(1, 1, 1, 1), (1, 1, 2, 2), (2, 2, 3, 3), (2, 1, 4, 2), (1, 2, 2, 4),
          (2, 2, 8, 8), (1, 1, 16, 16), (4, 4, 4, 4), (3, 3, 5, 5), (1, 1, 12, 11),
          (4, 4, 1, 16), (16, 16, 1, 1), (16, 1, 16, 1), (1, 16, 1, 16), (256, 1, 1, 1),
          (1, 256, 1, 1), (1, 1, 256, 1), (1, 1, 1, 256), (8, 2, 16, 1), (2, 8, 1, 16)]
#: (storage, field) element sizes of KERNEL_DTYPES
SIZES = [(s.itemsize, f.itemsize) for s, f in S.KERNEL_DTYPES]
#: shared memory of one H100 SM (228 KB), of which each resident block
#: reserves 1 KB
SM_SMEM_BYTES, BLOCK_RESERVED_BYTES = 233472, 1024


def rows_walk(KO, BI, o0, nr):
    """The kernel's walk over the rows a of K_d that the outputs [o0, o0 +
    nr) of one thread touch: for each row, its first colour row i_lo and the
    thread's slots [r_lo, r_lo + cnt); returns {output: (a, i)}."""
    got = {}
    r_lo = 0
    while r_lo < nr:
        a = (o0 + r_lo) // BI
        i_lo = o0 + r_lo - a * BI
        cnt = min(nr - r_lo, BI - i_lo)
        assert cnt >= 1
        for r in range(r_lo, r_lo + cnt):
            assert o0 + r not in got
            got[o0 + r] = (a, i_lo + r - r_lo)
        r_lo += cnt
    return got


def blocks_per_sm(shape, n, ndir, sizes):
    """Resident blocks an SM of ``rt_tile``'s tile by shared memory and
    threads alone (the card's occupancy also counts registers)."""
    Sites, C, R, G, D, stages = S.rt_tile(*shape, n, ndir, *sizes)
    smem = S.rt_smem(*shape, ndir, Sites, C, D, stages, *sizes)
    return min(SM_SMEM_BYTES // (smem + BLOCK_RESERVED_BYTES),
               2048 // S.rt_threads(Sites, C, G), 32)


def shares(KI, BI, R, G):
    """(o0, nr) of each of the G threads of a (site, column), as the kernel
    assigns them: up to R outputs of one row of K_d each where R = 4 or 8
    and KI * ceil(BI / R) <= 32 threads, else R consecutive outputs across
    rows."""
    nchunk = -(-BI // R)
    if KI * nchunk <= S.RT_ROW_THREADS:
        assert G == KI * nchunk and R in (1, 2, 3, 4, 8) and (R == 8 or R == BI)
        out = []
        for g in range(G):
            a, ch = divmod(g, nchunk)
            o0 = a * BI + ch * R
            out.append((o0, min(R, (a + 1) * BI - o0)))
            # one row of K_d: the kernel forms one z[a][j] a thread
            assert (o0 + out[-1][1] - 1) // BI == a
        return out
    assert G == -(-KI * BI // R) <= 16 and R in (8, 16)
    return [(g * R, min(R, KI * BI - g * R)) for g in range(G)]


@pytest.mark.parametrize("sizes", SIZES)
@pytest.mark.parametrize("shape", SHAPES)
def test_rt_tile_fits_and_owns_every_output_once(shape, sizes):
    KI, KD, BI, BD = shape
    KO = KI * BI
    for n in (1, 3, 8, 65536):
        for ndir in (1, 9, 16):
            tile = S.rt_tile(*shape, n, ndir, *sizes)
            Sites, C, R, G, D, stages = tile
            label = (shape, sizes, n, ndir, tile)
            assert Sites & (Sites - 1) == 0 and 8 <= Sites <= 32, label
            assert 1 <= C <= min(n, 8) and (R, G) == S.rt_split(KI, BI), label
            assert S.rt_threads(Sites, C, G) <= S.RT_THREADS, label
            assert S.rt_smem(*shape, ndir, Sites, C, D, stages, *sizes) <= S.SMEM_BYTES, label
            # the ring: 2 to 8 stages of D directions, the unit's directions
            # spread over ceil(ndir / D) stages with none empty
            assert 2 <= stages <= S.RT_MAX_STAGES and 1 <= D <= ndir, label
            assert (-(-ndir // D) - 1) * D < ndir, label
            # 16-byte copies of a tile's row of sites, at every element size
            assert Sites * min(sizes) % 16 == 0, label
            # the G threads of a (site, column) split its outputs in shares of
            # at most R, each output owned once
            owned = {}
            for o0, nr in shares(KI, BI, R, G):
                assert 1 <= nr <= R, label
                walk = rows_walk(KO, BI, o0, nr)
                assert not set(walk) & set(owned), label
                owned.update(walk)
            assert owned == {a * BI + i: (a, i) for a in range(KI) for i in range(BI)}, label


@pytest.mark.parametrize("shape,n,want", [
    ((2, 2, 3, 3), 8, (16, 8, 3, 2, 2, 3)), ((1, 1, 2, 2), 8, (16, 8, 2, 1, 3, 3)),
    ((2, 1, 4, 2), 8, (16, 8, 4, 2, 5, 3)), ((2, 2, 8, 8), 8, (32, 8, 8, 2, 1, 2)),
    ((1, 1, 16, 16), 8, (32, 8, 8, 2, 1, 2)), ((2, 2, 3, 3), 1, (16, 1, 3, 2, 2, 3)),
])
def test_rt_tile_at_the_timed_shapes(shape, n, want):
    """The tiles of the K1-shape path (16^3x32 x 8 f32, 9 directions): one
    thread a row of K_d, 8 columns and as many sites as 256 threads hold,
    several directions a stage at the narrow shapes, one at the wide ones;
    all hold 16 warps an SM by shared memory (two blocks of 256 threads)."""
    assert S.rt_tile(*shape, n, 9, 4, 4) == want
    if n == 8:
        Sites, C, R, G, D, stages = want
        assert blocks_per_sm(shape, n, 9, (4, 4)) * S.rt_threads(Sites, C, G) \
            * S.RT_COLS >= 512


def test_rt_wrapper_takes_every_column_count_and_refuses_the_rest():
    """No 65535-column cap: the CPU path runs 65536 columns; above
    MAX_BLOCK the wrapper raises on every device; the kernel case check
    takes more than 8 x 65535 columns (no route caps them)."""
    rng = np.random.default_rng(0)
    lat = (2, 2, 2, 2)
    offsets = [(0, 0, 0, 0), (0, 0, 0, 1)]

    def c(shape):
        return CArray(*(torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                        for _ in range(2)))

    blocks, x = c((2, 4) + lat), c((65536, 2) + lat)
    y = S.stencil_matvec_soa_rt(blocks, None, x, offsets, 2, 2)
    want = S.stencil_matvec_soa_reference(blocks, None, x, offsets, 2, 2)
    assert tuple(y.re.shape) == (65536, 2) + lat
    assert torch.equal(y.re, want.re) and torch.equal(y.im, want.im)
    assert S.check_kernel_case(blocks, None, x, offsets, 2, 2) == (1, 1)
    wide = CArray(*(torch.empty((8 * 65535 + 1, 2) + lat) for _ in range(2)))
    assert S.check_kernel_case(blocks, None, wide, offsets, 2, 2) == (1, 1)
    with pytest.raises(ValueError, match="256"):
        S.stencil_matvec_soa_rt(c((1, 289) + lat), None, c((1, 17) + lat),
                                [(0, 0, 0, 0)], 17, 17)
