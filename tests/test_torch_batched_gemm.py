"""superbblas_tpu_torch.ops.batched_gemm against
superbblas_tpu.ops.batched_gemm_pallas on the same numpy inputs: the plain
version against the Pallas kernel in interpret mode (K3's shapes) and
against XLA's dot_general (E1's large-J shape, which the TPU kernel does
not take); the split-complex composition of the coarse apply; the route
between the two CUDA kernels, their tiles and their refusals."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import collect_garbage  # noqa: F401  (fixture)
from superbblas_tpu import cplx as JC
from superbblas_tpu.ops import batched_gemm_pallas as JG
from superbblas_tpu_torch import cplx as TC
from superbblas_tpu_torch.ops import batched_gemm as TG


pytestmark = pytest.mark.usefixtures("collect_garbage")


def operands(V, I, J, N, dtype=np.float32, seed=None):
    rng = np.random.default_rng(V + I + N if seed is None else seed)
    return (rng.standard_normal((V, I, J)).astype(dtype),
            rng.standard_normal((V, J, N)).astype(dtype))


@pytest.mark.parametrize("V,I,J,N", [
    (40, 12, 12, 32),     # multigrid coarse block (K=12 near-null basis)
    (7, 24, 24, 16),      # 24x24, ragged batch
    (16, 12, 8, 5),       # rectangular, ragged N
    (8, 32, 32, 128),     # nc=32 coarse regime
])
def test_plain_version_matches_pallas_kernel(V, I, J, N):
    """f32: both against each other and against a float64 product; each
    output sums J products, f32 rounding keeps them within 1e-5 of max |y|
    (the JAX test holds its kernel to atol 1e-4)."""
    b, x = operands(V, I, J, N)
    got = TG.batched_small_gemm(torch.from_numpy(b), torch.from_numpy(x))
    want = np.asarray(JG.batched_small_gemm(jnp.asarray(b), jnp.asarray(x), interpret=True))
    exact = np.einsum("vij,vjn->vin", b.astype(np.float64), x.astype(np.float64))
    assert got.dtype == torch.float32 and got.shape == (V, I, N)
    scale = np.abs(exact).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got.numpy(), exact, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("V,I,J,N", [(6, 32, 288, 32), (7, 4, 324, 3), (5, 4, 64, 8)])
def test_plain_version_matches_xla_at_large_j(V, I, J, N):
    """E1's probe shape (small V), the V-cycle's coarse levels, ragged N:
    f32 against JAX's batched_small_gemm (XLA's dot_general there, which
    returns f32) within 1e-5 of max |y|; f64 against a numpy product at
    1e-12."""
    b, x = operands(V, I, J, N)
    got = TG.batched_small_gemm(torch.from_numpy(b), torch.from_numpy(x))
    want = np.asarray(JG.batched_small_gemm(jnp.asarray(b), jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    b, x = operands(V, I, J, N, np.float64)
    got = TG.batched_small_gemm(torch.from_numpy(b), torch.from_numpy(x))
    want = np.einsum("vij,vjn->vin", b, x)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * np.abs(want).max())
    # batched_gemm_rowpack computes the same function at every shape
    np.testing.assert_array_equal(
        TG.batched_gemm_rowpack(torch.from_numpy(b), torch.from_numpy(x)).numpy(), got.numpy())


def test_complex_via_cbilinear():
    """The split-complex composition the coarse matvec uses (3 products),
    against JAX's (Pallas kernel in interpret mode) and numpy."""
    rng = np.random.default_rng(1)
    b = rng.standard_normal((6, 12, 12)) + 1j * rng.standard_normal((6, 12, 12))
    x = rng.standard_normal((6, 12, 9)) + 1j * rng.standard_normal((6, 12, 9))
    bc, xc = b.astype(np.complex64), x.astype(np.complex64)
    got = TC.cbilinear(TG.batched_small_gemm, TC.from_complex(bc), TC.from_complex(xc))
    want = JC.cbilinear(lambda bb, xx: JG.batched_small_gemm(bb, xx, interpret=True),
                        JC.from_complex(bc), JC.from_complex(xc))
    got_c = got.re.numpy() + 1j * got.im.numpy()
    want_c = np.asarray(want.re) + 1j * np.asarray(want.im)
    scale = np.abs(want_c).max()
    np.testing.assert_allclose(got_c, want_c, rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(got_c, np.einsum("vij,vjn->vin", b, x), rtol=0,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("I,J,route", [(12, 12, "small"), (64, 64, "small"),
                                       (4, 64, "small"), (65, 8, "rowpack"),
                                       (4, 324, "rowpack"), (32, 288, "rowpack")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_route_choices(I, J, route, dtype):
    assert TG.batched_gemm_route(I, J, dtype) == route


@pytest.mark.parametrize("case", ["bf16", "f16", "mixed", "shape", "empty_block"])
def test_refusals_on_every_device(case):
    """bf16, f16, mixed dtypes and mismatched shapes raise a named
    ValueError, on the CPU as on the card."""
    b, x = (torch.from_numpy(a) for a in operands(4, 8, 8, 3))
    match = {"bf16": "float32 and float64", "f16": "float32 and float64",
             "mixed": "one dtype", "shape": r"\[V, I, J\]", "empty_block": "empty"}[case]
    with pytest.raises(ValueError, match=match):
        if case in ("bf16", "f16"):
            dt = torch.bfloat16 if case == "bf16" else torch.float16
            TG.batched_small_gemm(b.to(dt), x.to(dt))
        elif case == "mixed":
            TG.batched_small_gemm(b, x.double())
        elif case == "shape":
            TG.batched_gemm_rowpack(b, x[:, :7])
        else:
            TG.batched_gemm_route(0, 8, torch.float32)


def test_cpu_tensors_launch_nothing():
    before = (TG.batched_small_gemm.launches, TG.batched_gemm_rowpack.launches)
    for V, I, J, N in ((3, 8, 8, 2), (3, 4, 100, 2)):
        TG.batched_small_gemm(*(torch.from_numpy(a) for a in operands(V, I, J, N)))
    assert (TG.batched_small_gemm.launches, TG.batched_gemm_rowpack.launches) == before


def _pow2(v):
    return v > 0 and v & (v - 1) == 0


@pytest.mark.parametrize("V,I,J,N", [(4096, 32, 288, 32), (256, 4, 324, 8), (16, 4, 64, 8),
                                     (8192, 32, 32, 128), (7, 4, 324, 3), (3, 200, 500, 70),
                                     (40, 64, 64, 300), (5, 1, 1, 1), (16384, 4, 324, 8),
                                     (16384, 4, 64, 8), (4096, 12, 324, 2), (1024, 3, 27, 2),
                                     (1179648, 3, 3, 32), (300, 3, 3, 32), (8, 3, 3, 32)])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_tiles_fit_the_card(V, I, J, N, itemsize):
    """Each kernel's tile, as read from the kernel's source, has at most
    1024 threads a block (its shared memory is held to 227 KB by the
    source's static_asserts); every extent the kernel shifts by is a power
    of two and a chunk of J is whole 16-byte loads; a launch keeps MIN_BLOCKS
    blocks or splits J among the warps of a block; a K3 block walks
    several sites only while WALK_BLOCKS blocks remain, an E1 block takes
    one; the main shapes take the wide (K3) and square (E1) tiles, the
    V-cycle's small levels the narrow one, split 8 ways, and the kron
    gather's colour stage (3x3 blocks, 32 columns) the short one, one warp
    a block, where it keeps MIN_BLOCKS blocks."""
    for tile_fn, walk in ((TG.rowpack_tile, False), (TG.small_tile, True)):
        if walk and max(I, J) > TG.SMALL_MAX:
            continue
        cfg, sites = tile_fn(V, I, J, N)
        IT, NT, RR, CC, JC, KS = TG.CONFIGS[cfg][:6]
        threads = (IT // RR) * (NT // CC) * KS
        assert cfg in TG.CONFIGS and len(TG.CONFIGS[cfg]) == 7 and threads <= 1024
        assert all(_pow2(v) for v in (IT // RR, NT // CC, JC * KS, NT, KS))
        assert IT % RR == 0 and NT % CC == 0 and JC % (16 // itemsize) == 0
        rest = -(-I // IT) * -(-N // NT)
        if V * rest < TG.MIN_BLOCKS:
            assert KS > 1
        assert 1 <= sites <= TG.MAX_WALK
        if sites > 1:
            assert walk and J <= JC * KS and -(-V // sites) * rest >= TG.WALK_BLOCKS
        else:
            assert not walk or J > JC * KS or V * rest < 2 * TG.WALK_BLOCKS
    if (V, I, J, N) in ((4096, 32, 288, 32), (256, 4, 324, 8), (16, 4, 64, 8)):
        assert TG.rowpack_tile(V, I, J, N) == {32: (1, 1), 4: (3, 1)}[I]
    if (V, I, J, N) == (8192, 32, 32, 128):
        assert TG.small_tile(V, I, J, N) == (0, 2)
    if (V, I, J, N) in ((1179648, 3, 3, 32), (300, 3, 3, 32)):
        assert TG.small_tile(V, I, J, N) == ((5, 2) if V > 300 else (5, 1))
        assert (TG.CONFIGS[5][:2], (TG.CONFIGS[5][2] * TG.CONFIGS[5][3])) == ((4, 32), 4)
    if (V, I, J, N) == (8, 3, 3, 32):
        assert TG.small_tile(V, I, J, N)[0] == 2


def test_tile_choice_is_cached():
    """The wrappers' tile choice is one dictionary hit after the first
    call at a shape."""
    before = TG._tile.cache_info().hits
    for _ in range(3):
        TG.rowpack_tile(333, 4, 324, 8)
    assert TG._tile.cache_info().hits >= before + 2
